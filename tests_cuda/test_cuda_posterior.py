"""K4 (the max-posterior decode) and the chunk sweeps X1 and X2 against
their plain-torch versions, on the card; X1's and X2's lanes steps
against their shared steps bit for bit, and the grouped exact
posteriors.

The kernels compute the plain versions' algorithms in float32 but sum
their S-term products as FMA chains where the plain versions call a
matrix product, and the card's expf/logf may differ from torch's by an
ulp.  So X1 and X2 are held to the plain versions within stated
tolerances (hats 1e-5 absolute; carries, x_out and the summed
normalizers 1e-6 relative), and K4's paths must agree except at
near-ties: a position may differ only where the plain version's top two
alpha_p * b are within 1e-5 relative.  Two launches on the same input
give the same bits, and a sweep cut into chunks gives the bits of one
chunk over the whole row."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.models import emission  # noqa: E402
from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp  # noqa: E402
from tehmm_tpu_torch.parallel import stitch  # noqa: E402

from test_cuda_kernels import _inputs, _model  # noqa: E402

pytestmark = pytest.mark.cuda

# S = 3, 10 (one state per lane), 33 (2), 100 (4), 200 (8; above 48 KB of
# shared memory)
STATES = [3, 10, 33, 100, 200]
NEAR_TIE = 1e-5


def assert_paths_agree(got, want, margin):
    """Paths equal except at near-ties of the plain version."""
    differ = got != want
    assert not bool((differ & (margin > NEAR_TIE)).any()), (
        f"{int(differ.sum())} positions differ, "
        f"{int((differ & (margin > NEAR_TIE)).sum())} of them not "
        f"near-ties")


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 37])
@pytest.mark.parametrize("S", STATES)
def test_k4_matches_plain(device, rng, S, L, zero_frac):
    args = _inputs(rng, device, S, L, zero_frac=zero_frac)
    ls, lt, lem, sym, lens = args
    before = dict(ck.LAUNCHES)
    alpha = ck.em_fwd(*args)[0]
    got = ck.post_decode(lt, lem, sym, lens, alpha)
    want, margin = ck.post_decode_plain(lt, lem, sym, lens, alpha,
                                        with_margin=True)
    assert_paths_agree(got, want, margin)
    fused = ck.posterior_decode_fused(*args)
    assert torch.equal(fused, got)
    assert bool((fused[lens == 0] == 0).all())
    # the lanes kernel to 32 states, the shared one beyond
    name = "post_decode_lanes" if S <= 32 else "post_decode"
    assert ck.k4_step(S, lem.shape[1], lem.shape[2]) == \
        ("lanes" if S <= 32 else "shared")
    assert ck.LAUNCHES[name] == before[name] + 2
    # the log-space posteriors' argmax on the plain obs, as the CPU path
    obs = emission.track_log_likelihoods(lem, sym)
    ah, _, _ = dp.forward_scaled(ls, lt, obs, lens)
    bh, _ = dp.backward_scaled(lt, obs, lens)
    xla = torch.argmax(dp.posterior_scaled(ah, bh), dim=-1)
    valid = torch.arange(L, device=device)[None, :] < lens[:, None]
    assert_paths_agree(got, torch.where(valid, xla, 0), margin)


def test_k4_repeat_runs_bit_identical(device, rng):
    args = _inputs(rng, device, 10, 500, T=5, V=9)
    assert torch.equal(ck.posterior_decode_fused(*args),
                       ck.posterior_decode_fused(*args))


# K4's lanes decode: every register count (S rounded up to 4), the
# gather of the row max to 16 states and the butterfly beyond; ragged
# lengths on both sides of the ring's halves (32 positions); 1 row, 64
# (the pass before 512) and 512 (the pass); every stream variant
K4_LANES_STATES = [1, 2, 3, 10, 16, 17, 20, 31, 32]
K4_VARIANTS = ["", "+w", "+g", "+wg"]
K4_L, K4_T, K4_V, K4_G = 100, 5, 9, 2
K4_ROWS = [1, 64, 512]


def _k4_case(S, B, variant):
    from test_cuda_streams import _streams

    rng = np.random.RandomState(S * 1000 + B)
    edge = np.asarray([K4_L, 0, 1, 31, 32, 33], np.int32)
    lengths = rng.randint(0, K4_L + 1, size=B).astype(np.int32)
    lengths[:min(B, len(edge))] = edge[:B]
    p = from_numpy(*_model(rng, S, K4_T, K4_V, zero_frac=0.3), "cuda")
    sym = rng.randint(0, K4_V, size=(B, K4_L, K4_T)).astype(np.int32)
    args = (p.log_start, p.log_trans, p.log_em,
            torch.from_numpy(sym).cuda(), torch.from_numpy(lengths).cuda())
    return args, _streams(rng, "cuda", variant, B, K4_L, S, K4_G)


@pytest.mark.parametrize("B", K4_ROWS)
@pytest.mark.parametrize("variant", K4_VARIANTS)
@pytest.mark.parametrize("S", K4_LANES_STATES)
def test_k4_lanes_equal_shared_bit_for_bit(device, monkeypatch, S, variant,
                                           B):
    """The lanes decode gives the shared kernel's path (forced at S <=
    32, where it is K4's decode as it ran before the lanes kernel) bit
    for bit on K1's forward rows, agrees with the plain version but at
    near-ties, launches once a call under its variant's counter, and two
    launches give the same bits."""
    args, st = _k4_case(S, B, variant)
    G = K4_G if "g" in variant else 0
    assert ck.k4_step(S, K4_T, K4_V, G) == "lanes"
    alpha = ck.em_fwd(*args, **st)[0]
    dec = (*args[1:], alpha)
    before = dict(ck.LAUNCHES)
    lanes = ck.post_decode(*dec, **st)
    again = ck.post_decode(*dec, **st)
    assert ck.LAUNCHES["post_decode_lanes" + variant] == \
        before["post_decode_lanes" + variant] + 2
    assert ck.LAUNCHES["post_decode" + variant] == \
        before["post_decode" + variant]
    monkeypatch.setattr(ck, "K4_LANES_MAX_STATES", 0)
    assert ck.k4_step(S, K4_T, K4_V, G) == "shared"
    shared = ck.post_decode(*dec, **st)
    assert ck.LAUNCHES["post_decode" + variant] == \
        before["post_decode" + variant] + 1
    assert torch.equal(lanes, shared)
    assert torch.equal(lanes, again)
    lens = args[4]
    valid = torch.arange(K4_L, device=device)[None, :] < lens[:, None]
    assert not bool((lanes[~valid] != 0).any())
    want, margin = ck.post_decode_plain(*dec, with_margin=True, **st)
    assert_paths_agree(lanes, want, margin)


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("S", [2, 3, 10, 17, 32])
def test_k4_lanes_first_hit_on_ties(device, monkeypatch, S, B):
    """Uniform transitions and emissions keep b at exactly 1, so each
    position's choice is the argmax of the alpha_p row given: rows of
    small integers tie at most positions, and the lanes decode, the
    shared one and the plain version all take the lowest tied state."""
    rng = np.random.RandomState(S + B)
    L = 70
    lt = torch.full((S, S), float(np.log(np.float32(1.0 / S))),
                    device=device)
    lem = torch.zeros((S, K4_T, K4_V), device=device)
    sym = torch.from_numpy(rng.randint(0, K4_V, size=(B, L, K4_T)).astype(
        np.int32)).to(device)
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    lengths[0] = L
    lens = torch.from_numpy(lengths).to(device)
    alpha_np = rng.randint(0, 3, size=(B, L, S)).astype(np.float32)
    alpha = torch.from_numpy(alpha_np).to(device)
    lanes = ck.post_decode(lt, lem, sym, lens, alpha)
    monkeypatch.setattr(ck, "K4_LANES_MAX_STATES", 0)
    shared = ck.post_decode(lt, lem, sym, lens, alpha)
    assert torch.equal(lanes, shared)
    first = np.where(np.arange(L)[None, :] < lengths[:, None],
                     alpha_np.argmax(axis=-1), 0)
    np.testing.assert_array_equal(lanes.cpu().numpy(), first)
    plain = ck.post_decode_plain(lt, lem, sym, lens, alpha)
    assert torch.equal(lanes, plain)
    ties = (alpha_np == alpha_np.max(axis=-1, keepdims=True)).sum(-1) > 1
    assert ties.mean() > 0.3 or S < 3


@pytest.mark.parametrize("S, T, V, G", [
    (1, 5, 9, 0), (10, 5, 9, 2), (20, 5, 8, 0), (32, 5, 9, 2),
    (32, 1, 2, 0), (2, 5, 145, 0), (2, 120, 145, 0), (8, 40, 4, 3)])
def test_k4_lanes_smem_sizes_are_the_library_s(device, S, T, V, G):
    """``k4_step``'s fit test sizes the lanes decode's shared memory as
    the library's launches do."""
    lib = ck.load_library()
    assert ck._k4_lanes_smem_floats(S, T, V, G) == \
        lib.tehmm_k4_lanes_smem_floats(S, T, V, G)


def _sweep_inputs(rng, device, S, L, zero_frac=0.0):
    _, lt, lem, sym, lens = _inputs(rng, device, S, L, zero_frac=zero_frac)
    obs = emission.track_log_likelihoods(lem, sym)
    init = torch.from_numpy(rng.randn(len(lens), S).astype(np.float32)) \
        .to(device)
    init = init - init.amax(dim=-1, keepdim=True)
    cont = torch.zeros(len(lens), dtype=torch.bool, device=device)
    cont[0] = True
    return lt, obs, init, cont, lens


def _close(name, got, want, rtol, atol):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", STATES)
def test_chunk_sweeps_match_plain(device, rng, S, zero_frac):
    lt, obs, init, cont, lens = _sweep_inputs(rng, device, S, 41, zero_frac)
    before = dict(ck.LAUNCHES)
    hats, carry = ck.forward_chunk_values(lt, obs, init, lens)
    p_hats, p_carry = dp.forward_chunk_values(lt, obs, init, lens)
    _close("X1 hats", hats, p_hats, 0.0, 1e-5)
    _close("X1 carry", carry, p_carry, 1e-6, 1e-6)
    final, dm_sum = ck.forward_final(lt, obs, init, lens)
    p_final, p_dm = dp.forward_final(lt, obs, init, lens)
    assert torch.equal(final, carry)
    _close("X1 dm sum", dm_sum, p_dm, 1e-6, 1e-6)
    beta, x_out = ck.backward_chunk_values(lt, obs, init, cont, lens)
    p_beta, p_x = dp.backward_chunk_values(lt, obs, init, cont, lens)
    _close("X2 beta", beta, p_beta, 0.0, 1e-5)
    _close("X2 x_out", x_out, p_x, 1e-6, 1e-6)
    assert ck.LAUNCHES["fwd_chunk"] == before["fwd_chunk"] + 2
    assert ck.LAUNCHES["bwd_chunk"] == before["bwd_chunk"] + 1
    # repeat launches give the same bits
    assert torch.equal(ck.forward_chunk_values(lt, obs, init, lens)[0], hats)
    assert torch.equal(
        ck.backward_chunk_values(lt, obs, init, cont, lens)[0], beta)


def _gammas(params, syms, chunk_len):
    out = [np.zeros((len(s), params.num_states), np.float32) for s in syms]

    def consume(b, start, gamma):
        out[b][start : start + len(gamma)] = gamma

    paths = stitch.posterior_sweep(params, syms, chunk_len, consume)
    return out, paths


@pytest.mark.parametrize("S", [3, 10, 33])
def test_chunked_sweep_bit_equal_one_chunk(device, rng, S):
    """posterior_sweep in chunks of 128 gives the gamma bits of one chunk
    over each whole row: the boundary steps run in X1 and X2 as the
    in-chunk steps do."""
    params = from_numpy(*_model(rng, S, 5, 9), device)
    syms = [rng.randint(0, 9, size=(n, 5)).astype(np.uint8)
            for n in (1500, 1, 700, 129)]
    before = dict(ck.LAUNCHES)
    chunked, paths = _gammas(params, syms, 128)
    whole, whole_paths = _gammas(params, syms, 1 << 14)
    for c, w, p, wp in zip(chunked, whole, paths, whole_paths):
        np.testing.assert_array_equal(c, w)
        np.testing.assert_array_equal(p, wp)
        np.testing.assert_allclose(c.sum(axis=1), 1.0, atol=1e-5)
    assert ck.LAUNCHES["fwd_chunk"] > before["fwd_chunk"]
    assert ck.LAUNCHES["bwd_chunk"] > before["bwd_chunk"]


# X1's step variants (ck.x1_step): lanes to 32 states (the register
# arrays of 4 to 32), shared beyond; rows of one, a few and a recompute
# group's 245; a row length no multiple of the ring's halves (32) or the
# shared step's obs slots (4)
X1_LANES_STATES = [1, 2, 10, 16, 17, 31, 32]
X1_SHARED_STATES = [33, 64, 239]
X1_ROWS = [1, 3, 245]
X1_L, X1_CHUNK = 70, 16
EPS32 = float(np.finfo(np.float32).eps)


def _x1_inputs(S, B):
    rng = np.random.RandomState(S * 1000 + B)
    log_trans = torch.from_numpy(_model(rng, S, 2, 4, zero_frac=0.3)[1])
    obs = torch.from_numpy((rng.randn(B, X1_L, S) * 3.0).astype(np.float32))
    lengths = rng.randint(0, X1_L + 1, size=B).astype(np.int32)
    lengths[:4] = [X1_L - 3, 0, 1, 2][:B] if B < 4 else [X1_L, 0, 1, 2]
    init = torch.from_numpy(rng.randn(B, S).astype(np.float32))
    init = init - init.amax(dim=-1, keepdim=True)
    return log_trans, obs, init, torch.from_numpy(lengths)


def _x1_modes(args):
    """Every mode of X1 on ``args``: values (hats, carry), carry-only
    (carry, summed normalizers), checkpoints at three chunk sizes."""
    hats, carry = ck.forward_chunk_values(*args)
    final, dm = ck.forward_final(*args)
    ckpts = [ck.forward_checkpoints(*args, c) for c in (X1_CHUNK, 1, X1_L)]
    return [hats, carry, final, dm] + ckpts


@pytest.mark.parametrize("B", X1_ROWS)
@pytest.mark.parametrize("S", X1_LANES_STATES)
def test_x1_lanes_equal_shared_bit_for_bit(device, monkeypatch, S, B):
    """The lanes step gives the shared step's bits (forced at S <= 32,
    where the shared step at one state a lane is the step X1 ran before
    the lanes step) in all three modes, with ragged lengths; each mode
    launches once under its counter."""
    args = [t.to(device) for t in _x1_inputs(S, B)]
    assert ck.x1_step(S) == "lanes"
    before = dict(ck.LAUNCHES)
    lanes = _x1_modes(args)
    assert ck.LAUNCHES["fwd_chunk"] == before["fwd_chunk"] + 2
    assert ck.LAUNCHES["fwd_checkpoints"] == before["fwd_checkpoints"] + 3
    monkeypatch.setattr(ck, "x1_step", lambda S_: "shared")
    shared = _x1_modes(args)
    for got, want in zip(lanes, shared):
        assert got.shape == want.shape
        assert torch.equal(got, want)
    assert torch.equal(lanes[1], lanes[2])     # the two modes' carries
    assert torch.equal(lanes[6][:, -1], lanes[1])


@pytest.mark.parametrize("S", X1_SHARED_STATES + [10])
def test_x1_modes_within_f3_of_float64(device, S):
    """Every mode against the plain version carried in float64: rows and
    carries within F3 (1e-5 plus 4 float32 ulps of the largest |obs|),
    the summed normalizers within 1e-6 relative and absolute."""
    args = _x1_inputs(S, 245)
    lim = 1e-5 + 4 * EPS32 * float(args[1].abs().max())
    ref = [dp.forward_chunk_values(*args, dtype=torch.float64),
           dp.forward_final(*args, dtype=torch.float64)]
    got = _x1_modes([t.to(device) for t in args])
    for name, g, w in (("hats", got[0], ref[0][0]),
                       ("carry", got[1], ref[0][1]),
                       ("carry-only carry", got[2], ref[1][0])):
        _close(f"X1 {name}", g.cpu().double(), w, 0.0, lim)
    _close("X1 dm sum", got[3].cpu().double(), ref[1][1], 1e-6, 1e-6)
    for chunk, g in zip((X1_CHUNK, 1, X1_L), got[4:]):
        want = dp.forward_checkpoints(*[t.double() if t.is_floating_point()
                                        else t for t in args], chunk=chunk)
        _close(f"X1 checkpoints of {chunk}", g.cpu().double(), want, 0.0,
               lim)


@pytest.mark.parametrize("S", [10, 32, 64])
def test_x1_checkpoints_of_one_long_row(device, rng, S):
    """One row over many chunks, as the exact posteriors' forward sweep
    runs it: every checkpoint is the values mode's row at its chunk's
    last position and the carry-only mode chained chunk by chunk."""
    L, chunk = 5000, 512
    log_trans = torch.from_numpy(_model(rng, S, 2, 4)[1]).to(device)
    obs = torch.from_numpy(
        (rng.randn(1, L, S) * 3.0).astype(np.float32)).to(device)
    lens = torch.tensor([L - 7], dtype=torch.int32, device=device)
    init = torch.zeros((1, S), device=device)
    got = ck.forward_checkpoints(log_trans, obs, init, lens, chunk)
    hats, carry = ck.forward_chunk_values(log_trans, obs, init, lens)
    a = init
    for k in range(got.shape[1]):
        last = min((k + 1) * chunk, L) - 1
        assert torch.equal(got[:, k], hats[:, last])
        part = obs[:, k * chunk:(k + 1) * chunk].contiguous()
        pl = torch.clamp(lens - k * chunk, 0, chunk).to(torch.int32)
        a, _ = ck.forward_final(log_trans, part, a, pl)
        assert torch.equal(got[:, k], a)
    assert torch.equal(got[:, -1], carry)


# X2's step variants (ck.x2_step), on X1's inputs and states, each row
# continuing past the span or not
def _x2_inputs(S, B):
    log_trans, obs, init, lengths = _x1_inputs(S, B)
    cont = torch.from_numpy(np.random.RandomState(S + B).rand(B) < 0.5)
    return log_trans, obs, init, cont, lengths


def _x2_modes(args):
    """Every mode of X2 on ``args``: values (beta, x_out), checkpoints at
    three chunk sizes."""
    beta, x_out = ck.backward_chunk_values(*args)
    ckpts = [ck.backward_checkpoints(*args, c) for c in (X1_CHUNK, 1, X1_L)]
    return [beta, x_out] + ckpts


@pytest.mark.parametrize("B", X1_ROWS)
@pytest.mark.parametrize("S", X1_LANES_STATES)
def test_x2_lanes_equal_shared_bit_for_bit(device, monkeypatch, S, B):
    """The lanes step gives the shared step's bits (forced at S <= 32,
    where the shared step at one state a lane is the step X2 ran before
    the lanes step) in both modes, with ragged lengths and rows that
    continue or not; each mode launches once under its counter."""
    args = [t.to(device) for t in _x2_inputs(S, B)]
    assert ck.x2_step(S) == "lanes"
    before = dict(ck.LAUNCHES)
    lanes = _x2_modes(args)
    assert ck.LAUNCHES["bwd_chunk"] == before["bwd_chunk"] + 1
    assert ck.LAUNCHES["bwd_checkpoints"] == before["bwd_checkpoints"] + 3
    monkeypatch.setattr(ck, "x2_step", lambda S_: "shared")
    shared = _x2_modes(args)
    for got, want in zip(lanes, shared):
        assert got.shape == want.shape
        assert torch.equal(got, want)
    # a span of one chunk: its checkpoint is the values mode's x_out
    assert torch.equal(lanes[4][:, 0], lanes[1])


@pytest.mark.parametrize("S", X1_SHARED_STATES + [10])
def test_x2_modes_within_f3_of_float64(device, S):
    """Every mode against the plain version carried in float64: betas,
    x_out and checkpoints within F3 (1e-5 plus 4 float32 ulps of the
    largest |obs|)."""
    args = _x2_inputs(S, 245)
    lim = 1e-5 + 4 * EPS32 * float(args[1].abs().max())
    f64 = [t.double() if t.is_floating_point() else t for t in args]
    ref = dp.backward_chunk_values(*f64)
    got = _x2_modes([t.to(device) for t in args])
    _close("X2 beta", got[0].cpu().double(), ref[0], 0.0, lim)
    _close("X2 x_out", got[1].cpu().double(), ref[1], 0.0, lim)
    for chunk, g in zip((X1_CHUNK, 1, X1_L), got[2:]):
        want = dp.backward_checkpoints(*f64, chunk=chunk)
        _close(f"X2 checkpoints of {chunk}", g.cpu().double(), want, 0.0,
               lim)


@pytest.mark.parametrize("S", [10, 32, 64])
def test_x2_checkpoints_of_one_long_row(device, rng, S):
    """One row over many chunks, as the exact posteriors' backward sweep
    runs it from the row's end: every checkpoint is the values mode's
    chained chunk by chunk from the last, whose betas are those of the
    values mode over the whole row, and the first is its x_out."""
    L, chunk = 5000, 512
    log_trans = torch.from_numpy(_model(rng, S, 2, 4)[1]).to(device)
    obs = torch.from_numpy(
        (rng.randn(1, L, S) * 3.0).astype(np.float32)).to(device)
    lens = torch.tensor([L - 7], dtype=torch.int32, device=device)
    cont = torch.tensor([False], device=device)
    init = torch.zeros((1, S), device=device)
    got = ck.backward_checkpoints(log_trans, obs, init, cont, lens, chunk)
    beta, x_out = ck.backward_chunk_values(log_trans, obs, init, cont, lens)
    x = init
    for k in reversed(range(got.shape[1])):
        part = obs[:, k * chunk:(k + 1) * chunk].contiguous()
        pl = torch.clamp(lens - k * chunk, 0, chunk).to(torch.int32)
        c = cont if k == got.shape[1] - 1 else lens > (k + 1) * chunk
        b, x = ck.backward_chunk_values(log_trans, part, x, c, pl)
        assert torch.equal(got[:, k], x)
        assert torch.equal(b, beta[:, k * chunk:(k + 1) * chunk])
    assert torch.equal(got[:, 0], x_out)


@pytest.mark.parametrize("S", [10, 64])
def test_grouped_posterior_sweep_on_the_card(device, rng, monkeypatch, S):
    """``posterior_sweep`` in groups of 1 and 3 chunks and in the default
    budget's one group gives the same gamma bits; X1 runs twice a group
    (the checkpoint sweep and the recompute), X2 twice a group (the
    backward sweep and the beta recompute) and once for position 0."""
    params = from_numpy(*_model(rng, S, 5, 9), device)
    syms = [rng.randint(0, 9, size=(n, 5)).astype(np.uint8)
            for n in (1500, 1, 700, 129, 0)]
    Lc = 128
    n_chunks = -(-1499 // Lc)
    gammas = {}
    for per in (1, 3, None):
        tensors = stitch.POSTERIOR_GROUP_TENSORS
        budget = None if per is None \
            else per * tensors * 4 * len(syms) * Lc * S
        with monkeypatch.context() as m:
            if budget is not None:
                m.setattr(stitch, "EXACT_GROUP_BYTES", budget)
            groups = -(-n_chunks // stitch.exact_group_chunks(
                len(syms), Lc, S, tensors))
            before = dict(ck.LAUNCHES)
            gammas[per] = _gammas(params, syms, Lc)
        ran = {k: ck.LAUNCHES[k] - before[k] for k in before}
        assert ran["fwd_checkpoints"] == groups
        assert ran["fwd_chunk"] == groups
        assert ran["bwd_checkpoints"] == groups
        assert ran["bwd_chunk"] == groups + 1
    assert groups == 1
    for per in (1, 3):
        for (g, p), (w, wp) in zip(zip(*gammas[per]), zip(*gammas[None])):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(p, wp)


def test_decoders_and_score_on_the_card_equal_the_cpu(device, rng):
    """Stitched (K4) and exact (X1/X2) max-posterior paths and the
    streamed score on the card against the CPU's plain torch."""
    from tehmm_tpu_torch.io.trackdata import TrackTable
    from tehmm_tpu_torch.models.hmm import MultitrackHmm

    tables = _model(rng, 10, 5, 9)
    syms = [rng.randint(1, 9, size=(n, 5)).astype(np.uint8)
            for n in (5000, 3001)]
    on_gpu = from_numpy(*tables, device)
    on_cpu = from_numpy(*tables, "cpu")
    for decode in (
        lambda p: stitch.posterior_chunked(p, syms, chunk_len=512,
                                           halo=32)[0],
        lambda p: stitch.posterior_exact(p, syms, chunk_len=512),
    ):
        for g, c in zip(decode(on_gpu), decode(on_cpu)):
            assert (g == c).mean() >= 0.999
    tabs = [TrackTable("chr1", 0, len(s), s) for s in syms]
    scores = [MultitrackHmm(p, None, {}, None).score(tabs, chunk_len=512)
              for p in (on_gpu, on_cpu)]
    np.testing.assert_allclose(scores[0], scores[1], rtol=1e-5)


def test_zero_transitions_behave_as_plain(device, rng):
    """A model with zero transitions (LOG_ZERO in log_trans): K4 keeps
    the 1e-37 clamps, X1/X2 the LOG_ZERO branch, as the plain versions."""
    S = 10
    tables = _model(rng, S, 3, 6, zero_frac=0.6)
    p = from_numpy(*tables, device)
    lens = torch.tensor([300, 120, 1, 0], dtype=torch.int32, device=device)
    sym = torch.from_numpy(
        rng.randint(0, 6, size=(4, 300, 3)).astype(np.int32)).to(device)
    alpha = ck.em_fwd(p.log_start, p.log_trans, p.log_em, sym, lens)[0]
    want, margin = ck.post_decode_plain(p.log_trans, p.log_em, sym, lens,
                                        alpha, with_margin=True)
    assert_paths_agree(ck.post_decode(p.log_trans, p.log_em, sym, lens,
                                      alpha), want, margin)
    obs = emission.track_log_likelihoods(p.log_em, sym)
    init = torch.zeros((4, S), device=device)
    init[:, 1:] = -1e30                     # only state 0 reachable
    _close("X1 hats", ck.forward_chunk_values(p.log_trans, obs, init, lens)[0],
           dp.forward_chunk_values(p.log_trans, obs, init, lens)[0], 1e-6,
           1e-5)
    cont = torch.tensor([False, False, False, False], device=device)
    _close("X2 beta",
           ck.backward_chunk_values(p.log_trans, obs, init, cont, lens)[0],
           dp.backward_chunk_values(p.log_trans, obs, init, cont, lens)[0],
           1e-6, 1e-5)


def test_outside_the_envelope_raises(device, rng):
    ls, lt, lem, sym, lens = _inputs(rng, device, 300, 4, T=1, V=2)
    alpha = torch.ones((len(lens), 4, 300), device=device)
    with pytest.raises(NotImplementedError, match="K4, X1 and X2"):
        ck.post_decode(lt, lem, sym, lens, alpha)
    # X1 and X2 run past their one-warp kernels on the scan tile, to the
    # tile's 1024 states
    S = ck.STREAMING_MAX_STATES + 1
    lt = torch.zeros((S, S), device=device)
    obs = torch.zeros((len(lens), 4, S), device=device)
    carry = torch.zeros((len(lens), S), device=device)
    with pytest.raises(NotImplementedError, match="tile beyond 1024"):
        ck.forward_final(lt, obs, carry, lens)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ck.backward_chunk_values(
            lt, obs, carry, torch.zeros(len(lens), dtype=torch.bool,
                                        device=device), lens)
    # S = 200 with a large emission table overflows the decode's shared
    # memory
    ls, lt, lem, sym, lens = _inputs(rng, device, 200, 4, T=20, V=16)
    alpha = torch.ones((len(lens), 4, 200), device=device)
    with pytest.raises(NotImplementedError, match="shared memory"):
        ck.post_decode(lt, lem, sym, lens, alpha)
