"""K4 (the max-posterior decode) and the chunk sweeps X1 and X2 against
their plain-torch versions, on the card.

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
    assert ck.LAUNCHES["post_decode"] == before["post_decode"] + 2
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
