"""CUDA kernels against their plain-torch versions, on the card.

Every value path is exact float32 arithmetic in the same order, so the
kernels must agree with the plain versions bit for bit: value rows,
normalizers, carries and paths.  Only the fused decode's score (a
tree-order sum against dp.viterbi's sequential one) gets a tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.utils.common import LOG_ZERO  # noqa: E402
from tehmm_tpu_torch.models import emission  # noqa: E402
from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp  # noqa: E402
from tehmm_tpu_torch.parallel import stitch  # noqa: E402

pytestmark = pytest.mark.cuda

# S = 3, 10 (one state per lane), 33 (2), 100 (4), 200 (8; needs the
# shared-memory opt-in above 48 KB)
STATES = [3, 10, 33, 100, 200]


def _model(rng, S, T, V, zero_frac=0.0):
    start = np.log(rng.dirichlet(np.ones(S)))
    trans = rng.dirichlet(np.ones(S), size=S)
    if zero_frac:
        mask = rng.rand(S, S) < zero_frac
        np.fill_diagonal(mask, False)
        trans = np.where(mask, 0.0, trans)
        trans /= trans.sum(axis=1, keepdims=True)
    log_trans = np.where(trans > 0, np.log(np.maximum(trans, 1e-300)),
                         LOG_ZERO)
    log_em = np.zeros((S, T, V))
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    return [np.asarray(x, np.float32) for x in (start, log_trans, log_em)]


def _inputs(rng, device, S, L, T=3, V=6, zero_frac=0.0):
    tables = _model(rng, S, T, V, zero_frac)
    lengths = np.asarray([L, max(L - 5, 0), 1, 0, min(2, L)], np.int32)
    sym = rng.randint(0, V, size=(len(lengths), L, T)).astype(np.int32)
    p = from_numpy(*tables, device)
    return (p.log_start, p.log_trans, p.log_em,
            torch.from_numpy(sym).to(device),
            torch.from_numpy(lengths).to(device))


@pytest.mark.parametrize("L", [1, 37])
@pytest.mark.parametrize("S", STATES)
def test_fwd_and_backtrace_bit_equal(device, rng, S, L):
    args = _inputs(rng, device, S, L, zero_frac=0.3)
    before = dict(ck.LAUNCHES)
    v, dm = ck.viterbi_fwd(*args)
    pv, pdm = ck.viterbi_fwd_plain(*args)
    assert torch.equal(v, pv) and torch.equal(dm, pdm)

    log_trans, lengths = args[1], args[4]
    end = torch.argmax(v[:, -1], dim=-1).to(torch.int32)
    body_lens = torch.clamp(lengths - 1, min=0)
    got = ck.viterbi_backtrace(log_trans, v[:, 1:], v[:, 0], end,
                               body_lens)
    want = ck.viterbi_backtrace_plain(
        log_trans, v[:, 1:].contiguous(), v[:, 0].contiguous(), end,
        body_lens,
    )
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    path, score = ck.viterbi_fused(*args)
    obs = emission.track_log_likelihoods(args[2], args[3])
    want_p, want_s = dp.viterbi(args[0], log_trans, obs, lengths)
    assert torch.equal(path, want_p)
    torch.testing.assert_close(score, want_s, rtol=1e-5, atol=1e-4)
    # the forward under its step's counter (values, then the fused
    # decode's pointer mode); the fused decode's backtrace is the chase
    fwd = _K2_COUNTER[ck.k2_step(S, 3, 6)]
    assert ck.LAUNCHES[fwd] == before[fwd] + 2
    assert ck.LAUNCHES["viterbi_backtrace"] == \
        before["viterbi_backtrace"] + 1
    assert ck.LAUNCHES["chunk_chase"] == before["chunk_chase"] + 1


_K2_COUNTER = {"lanes": "viterbi_fwd_lanes", "shared": "viterbi_fwd"}
# K2's lanes forward at every S to 32 (register arrays of 4 to 32), rows
# of 100 positions: three whole halves of the ring and a part one
K2_L = 100
# integer tables: every sum exact, so equal candidates tie
K2_TIE_STATES = [1, 2, 10, 17, 32]


def _tie_inputs(rng, device, S, L, T=3, V=6):
    *_, sym, lens = _inputs(rng, device, S, L, T, V)
    ints = [torch.from_numpy(rng.randint(lo, 1, size=shape).astype(
        np.float32)).to(device)
        for lo, shape in ((-2, (S,)), (-3, (S, S)), (-2, (S, T, V)))]
    return (*ints, sym, lens)


def _k2_both_modes(args):
    """(value rows, dm, pointers, last, dm of the pointer mode)."""
    return (*ck.viterbi_fwd(*args), *ck.viterbi_fwd_pointers(*args))


@pytest.mark.parametrize("S,ties", [(S, False) for S in range(1, 33)]
                         + [(S, True) for S in K2_TIE_STATES if S <= 32])
def test_k2_lanes_equal_shared_and_plain(device, monkeypatch, S, ties):
    """K2's lanes forward, both modes, with ragged lengths (the whole row,
    0, 1 and 2): value rows and dm bit-equal to the plain version and to
    the shared kernel forced; pointers, last row and dm equal to the
    plain pointer forward's and to the shared kernel's pointer mode.
    Each kernel launches under its own counter."""
    rng = np.random.RandomState(S)
    args = _tie_inputs(rng, device, S, K2_L) if ties else \
        _inputs(rng, device, S, K2_L, zero_frac=0.3)
    assert ck.k2_step(S, 3, 6) == "lanes"
    before = dict(ck.LAUNCHES)
    lanes = _k2_both_modes(args)
    assert ck.LAUNCHES["viterbi_fwd_lanes"] == \
        before["viterbi_fwd_lanes"] + 2
    plain = (*ck.viterbi_fwd_plain(*args),
             *ck.viterbi_fwd_pointers_plain(*args))
    monkeypatch.setattr(ck, "K2_LANES_MAX_STATES", 0)
    shared = _k2_both_modes(args)
    assert ck.LAUNCHES["viterbi_fwd"] == before["viterbi_fwd"] + 2
    names = ("value rows", "dm", "pointers", "last", "pointer mode dm")
    for name, a, b, c in zip(names, lanes, plain, shared):
        assert a.dtype == b.dtype and torch.equal(a, b), name
        assert torch.equal(a, c), name
    assert torch.equal(lanes[1], lanes[4])
    assert torch.equal(lanes[3], lanes[0][:, -1])


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("S", [33, 64, 229])
def test_k2_shared_pointers_equal_plain(device, rng, S, ties):
    """The shared kernel's pointer mode at 2, 2 and 8 states a lane (229:
    K2's envelope's edge at T=3, V=6): pointers, last row and dm equal
    to the plain pointer forward's, and its dm and last row to the value
    mode's."""
    args = _tie_inputs(rng, device, S, 37) if ties else \
        _inputs(rng, device, S, 37, zero_frac=0.3)
    assert ck.k2_step(S, 3, 6) == "shared"
    got = _k2_both_modes(args)
    want = ck.viterbi_fwd_pointers_plain(*args)
    for name, a, b in zip(("pointers", "last", "dm"), got[2:], want):
        assert torch.equal(a, b), name
    assert torch.equal(got[1], got[4]) and \
        torch.equal(got[3], got[0][:, -1])


@pytest.mark.parametrize("S", [3, 10, 32, 33, 100, 200])
def test_k2_chase_equals_the_value_row_backtrace(device, rng, S):
    """The fused decode's backtrace, the chase over K2's pointers from the
    last row's first-hit argmax, gives ``viterbi_backtrace_kernel``'s
    path over K2's value rows on every row (the end state held past each
    length, as the backtrace holds it), and ``viterbi_fused`` that path
    (0 for the zero-length row)."""
    args = _inputs(rng, device, S, K2_L, zero_frac=0.3)
    log_trans, lengths = args[1], args[4]
    v, _ = ck.viterbi_fwd(*args)
    ptrs, last, _ = ck.viterbi_fwd_pointers(*args)
    end = torch.argmax(last, dim=-1).to(torch.int32)
    chased = ck.chunk_chase(ptrs, end, lengths)
    body, first = ck.viterbi_backtrace(
        log_trans, v[:, 1:], v[:, 0], end,
        torch.clamp(lengths - 1, min=0).to(torch.int32))
    want = torch.cat([first[:, None], body], dim=1)
    assert torch.equal(chased, want)
    path, _ = ck.viterbi_fused(*args)
    assert torch.equal(path, torch.where((lengths > 0)[:, None], want, 0))


@pytest.mark.parametrize("S,T,V,G", [(1, 1, 2, 0), (10, 5, 9, 0),
                                     (10, 5, 9, 2), (32, 5, 9, 1),
                                     (20, 12, 17, 3)])
def test_k2_lanes_smem_sizes_are_the_library_s(device, S, T, V, G):
    lib = ck.load_library()
    assert ck._k2_lanes_smem_floats(S, T, V, G) == \
        lib.tehmm_k2_lanes_smem_floats(S, T, V, G)


@pytest.mark.parametrize("S", STATES)
def test_chunk_values_and_carry_bit_equal(device, rng, S):
    _, log_trans, log_em, sym, lengths = _inputs(rng, device, S, 29)
    obs = emission.track_log_likelihoods(log_em, sym)
    init = torch.from_numpy(
        rng.randn(len(lengths), S).astype(np.float32)
    ).to(device)
    before = ck.LAUNCHES["viterbi_chunk_values"]
    assert torch.equal(
        ck.viterbi_chunk_values(log_trans, obs, init, lengths),
        dp.viterbi_chunk_values(log_trans, obs, init, lengths),
    )
    assert torch.equal(
        ck.viterbi_carry(log_trans, obs, init, lengths),
        dp.viterbi_carry(log_trans, obs, init, lengths),
    )
    assert ck.LAUNCHES["viterbi_chunk_values"] == before + 2


# K3's step variants (ck.k3_step): lanes to 32 states (the register
# arrays of 8, 16 and 32), shared from 33 (1 to 8 states a lane) to 239;
# rows of one, a few and a recompute group's 245
K3_STATES = [1, 2, 10, 16, 17, 31, 32, 33, 64, 239]
K3_ROWS = [1, 3, 245]
K3_L, K3_CHUNK = 70, 16    # no multiple of the obs tiles (32 / SPL)


@pytest.mark.parametrize("B", K3_ROWS)
@pytest.mark.parametrize("S", K3_STATES)
def test_k3_modes_bit_equal(device, S, B):
    """K3's values, carry and checkpoint modes equal their plain versions
    bit for bit, with ragged lengths (0, 1, 2, the whole row), and each
    launches once under its counter."""
    rng = np.random.RandomState(S * 1000 + B)
    log_trans = torch.from_numpy(_model(rng, S, 2, 4, zero_frac=0.3)[1]) \
        .to(device)
    obs = torch.from_numpy(
        (rng.randn(B, K3_L, S) * 3.0).astype(np.float32)).to(device)
    lengths = rng.randint(0, K3_L + 1, size=B).astype(np.int32)
    lengths[:4] = [K3_L - 3, 0, 1, 2][:B] if B < 4 else [K3_L, 0, 1, 2]
    lens = torch.from_numpy(lengths).to(device)
    init = torch.from_numpy(rng.randn(B, S).astype(np.float32)).to(device)
    args = (log_trans, obs, init, lens)
    before = dict(ck.LAUNCHES)
    assert torch.equal(ck.viterbi_chunk_values(*args),
                       dp.viterbi_chunk_values(*args))
    assert torch.equal(ck.viterbi_carry(*args), dp.viterbi_carry(*args))
    for chunk in (K3_CHUNK, 1, K3_L):
        got = ck.viterbi_checkpoints(*args, chunk)
        assert got.shape == (B, -(-K3_L // chunk), S)
        assert torch.equal(got, dp.viterbi_checkpoints(*args, chunk))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["viterbi_chunk_values"] == \
        before["viterbi_chunk_values"] + 2
    assert ck.LAUNCHES["viterbi_checkpoints"] == \
        before["viterbi_checkpoints"] + 3
    assert ck.LAUNCHES["viterbi_chunk_tile"] == before["viterbi_chunk_tile"]


def test_k3_checkpoints_of_one_long_row(device, rng):
    """One row over many chunks, as the exact decoder's forward sweep
    runs it: the checkpoints equal the carry chained chunk by chunk on
    the card, and the last one the carry mode's."""
    S, L, chunk = 10, 5000, 512
    log_trans = torch.from_numpy(_model(rng, S, 2, 4)[1]).to(device)
    obs = torch.from_numpy(
        (rng.randn(1, L, S) * 3.0).astype(np.float32)).to(device)
    lens = torch.tensor([L - 7], dtype=torch.int32, device=device)
    init = torch.zeros((1, S), device=device)
    got = ck.viterbi_checkpoints(log_trans, obs, init, lens, chunk)
    carry = init
    for k in range(got.shape[1]):
        part = obs[:, k * chunk:(k + 1) * chunk].contiguous()
        pl = torch.clamp(lens - k * chunk, 0, chunk).to(torch.int32)
        carry = ck.viterbi_carry(log_trans, part, carry, pl)
        assert torch.equal(got[:, k], carry)
    assert torch.equal(got[:, -1],
                       ck.viterbi_carry(log_trans, obs, init, lens))


@pytest.mark.parametrize("per", [1, 3, None])
def test_grouped_exact_on_the_card(device, rng, monkeypatch, per):
    """The grouped exact decode (groups of 1 and 3 chunks, and the
    default budget's one group) on the card equals the CPU's and the
    stitched decode, and runs K3 twice a group (the checkpoint and the
    pointer modes) and X3's map, compose and chase once a group each,
    with no value-row backtrace."""
    tables = _model(rng, 10, 5, 9)
    trans = np.exp(tables[1]) * 0.2 + np.eye(10) * 0.8
    tables[1] = np.log(trans / trans.sum(1, keepdims=True)).astype(
        np.float32)
    syms = [rng.randint(1, 9, size=(n, 5)).astype(np.uint8)
            for n in (5000, 3001, 0, 1, 300)]
    Lc = 512
    n_chunks = -(-4999 // Lc)
    if per is not None:
        monkeypatch.setattr(stitch, "EXACT_GROUP_BYTES",
                            per * 2 * 4 * len(syms) * Lc * 10)
    groups = 1 if per is None else -(-n_chunks // per)
    on_gpu = from_numpy(*tables, device)
    before = dict(ck.LAUNCHES)
    card = stitch.viterbi_exact(on_gpu, syms, chunk_len=Lc)
    for name in ("viterbi_checkpoints", "viterbi_chunk_pointers",
                 "chunk_entry_map", "chunk_compose", "chunk_chase"):
        assert ck.LAUNCHES[name] == before[name] + groups, name
    for name in ("viterbi_chunk_values", "viterbi_backtrace"):
        assert ck.LAUNCHES[name] == before[name], name
    cpu = stitch.viterbi_exact(from_numpy(*tables, "cpu"), syms,
                               chunk_len=Lc)
    stitched, report = stitch.viterbi_chunked(on_gpu, syms, chunk_len=Lc,
                                              halo=64)
    assert report.boundaries_ok
    for c, x, s_ in zip(card, cpu, stitched):
        np.testing.assert_array_equal(c, x)
        np.testing.assert_array_equal(c, s_)


def test_decoders_on_the_card_equal_the_cpu(device, rng):
    """Stitched and exact decodes of a multi-chunk input give the same
    paths on the card (kernels) as on the CPU (plain versions)."""
    tables = _model(rng, 10, 5, 9)
    syms = [rng.randint(1, 9, size=(n, 5)).astype(np.uint8)
            for n in (5000, 3001)]
    on_gpu = from_numpy(*tables, device)
    on_cpu = from_numpy(*tables, "cpu")
    for decode in (
        lambda p: stitch.viterbi_chunked(p, syms, chunk_len=512,
                                         halo=32)[0],
        lambda p: stitch.viterbi_exact(p, syms, chunk_len=512),
    ):
        for g, c in zip(decode(on_gpu), decode(on_cpu)):
            np.testing.assert_array_equal(g, c)


def test_outside_the_envelope_raises(device, rng):
    args = _inputs(rng, device, 300, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ck.viterbi_fwd(*args)
    # S = 200 with a large emission table overflows shared memory
    args = _inputs(rng, device, 200, 4, T=20, V=16)
    with pytest.raises(NotImplementedError, match="shared memory"):
        ck.viterbi_fwd(*args)


def test_bad_symbols_and_states_raise(device, rng):
    ls, lt, lem, sym, lens = _inputs(rng, device, 10, 8)
    with pytest.raises(ValueError, match="symbols"):
        ck.viterbi_fwd(ls, lt, lem, sym + lem.shape[2], lens)
    v, _ = ck.viterbi_fwd(ls, lt, lem, sym, lens)
    bad_end = torch.full((len(lens),), 10, dtype=torch.int32,
                         device=device)
    with pytest.raises(ValueError, match="end_state"):
        ck.viterbi_backtrace(lt, v, v[:, 0], bad_end, lens)
