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
    assert ck.LAUNCHES["viterbi_fwd"] == before["viterbi_fwd"] + 2
    assert ck.LAUNCHES["viterbi_backtrace"] == \
        before["viterbi_backtrace"] + 2


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
