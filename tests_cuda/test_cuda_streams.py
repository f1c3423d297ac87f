"""The optional observation streams of K1, K2 and K4 — segment weights
and gaussian tracks — against the kernels' plain-torch versions, on the
card.

Every stream variant (weights, gaussian values, both) runs at every
states-per-lane width with G = 1 and 3 gaussian tracks (10% of the
values NaN).  K2's forward is bit-equal to its plain version (the obs
routine rounds every product and sum on its own, so nvcc contracts
nothing); K1 is held to its plain version at the engine tolerances of
``test_cuda_em.py``, its gaussian moments at 1e-4 relative, and two
launches give the same bits; K4's paths may differ only at near-ties of
the plain version.  Each launch counts under its variant's key."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.models.gauss import from_numpy as gauss_from_numpy  # noqa: E402,E501
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

from test_cuda_kernels import _inputs  # noqa: E402
from test_cuda_posterior import assert_paths_agree  # noqa: E402

pytestmark = pytest.mark.cuda

STATES = [3, 10, 33, 100, 200]
# K1's reverse kernel keeps each warp's statistics in shared memory, so
# its envelope ends below S = 200 (S = 140: 8 states per lane, 1 warp)
K1_STATES = [3, 10, 33, 100, 140]
VARIANTS = ["+w", "+g", "+wg"]


def _streams(rng, device, variant, B, L, S, G):
    w = vals = gauss = None
    if "w" in variant:
        w = torch.from_numpy(
            rng.uniform(1.0, 64.0, size=(B, L)).astype(np.float32)
        ).to(device)
    if "g" in variant:
        v = rng.randn(B, L, G).astype(np.float32) * 2.0
        v[rng.rand(B, L, G) < 0.1] = np.nan
        vals = torch.from_numpy(v).to(device)
        gauss = gauss_from_numpy(rng.randn(S, G) * 2.0,
                                 rng.randn(S, G) * 0.5, device)
    return dict(obs_weights=w, gauss_params=gauss, gauss_values=vals)


def _case(rng, device, S, L, variant, G):
    args = _inputs(rng, device, S, L)
    B = args[3].shape[0]
    return args, _streams(rng, device, variant, B, L, S, G)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", STATES)
def test_k2_streams_bit_equal(device, rng, S, variant, G):
    args, st = _case(rng, device, S, 37, variant, G)
    # the lanes forward to 32 states, the shared one beyond
    step = ck.k2_step(S, 3, 6, G if "g" in variant else 0)
    name = ("viterbi_fwd_lanes" if step == "lanes" else "viterbi_fwd") \
        + variant
    before = ck.LAUNCHES[name]
    v, dm = ck.viterbi_fwd(*args, **st)
    pv, pdm = ck.viterbi_fwd_plain(*args, **st)
    assert torch.equal(v, pv) and torch.equal(dm, pdm)
    path, score = ck.viterbi_fused(*args, **st)
    cpu = [a.cpu() for a in args]
    cpu_st = {k: None if x is None else
              (x.cpu() if torch.is_tensor(x) else
               gauss_from_numpy(x.mu.cpu(), x.log_var.cpu(), "cpu"))
              for k, x in st.items()}
    want_path, _ = ck.viterbi_fused(*cpu, **cpu_st)
    assert torch.equal(path.cpu(), want_path)
    assert ck.LAUNCHES[name] == before + 2


@pytest.mark.parametrize("variant", [""] + VARIANTS)
@pytest.mark.parametrize("B", [64, 512])
def test_k2_fused_equals_dp_viterbi(device, B, variant):
    """The stitched decode's passes (64 and 512 rows) at the decode
    configuration's width (S=10, T=5, V=9), ragged: ``viterbi_fused``
    (the lanes forward's pointers, then the chase) gives ``dp.viterbi``'s
    paths on the plain obs, and its score within float32 rounding of the
    normalizers' sum."""
    from tehmm_tpu_torch.models.emission import obs_log_likelihoods
    from tehmm_tpu_torch.ops import dp

    rng = np.random.RandomState(B)
    L = 1200
    S, T, V = 10, 5, 9
    ls, lt, lem, _sym, _lens = _inputs(rng, device, S, 2, T, V)
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    lengths[:4] = [L, 0, 1, 2]
    sym = torch.from_numpy(
        rng.randint(0, V, size=(B, L, T)).astype(np.int32)).to(device)
    lens = torch.from_numpy(lengths).to(device)
    st = _streams(rng, device, variant, B, L, S, 2)
    before = dict(ck.LAUNCHES)
    path, score = ck.viterbi_fused(ls, lt, lem, sym, lens, **st)
    assert ck.LAUNCHES["viterbi_fwd_lanes" + variant] == \
        before["viterbi_fwd_lanes" + variant] + 1
    assert ck.LAUNCHES["chunk_chase"] == before["chunk_chase"] + 1
    assert ck.LAUNCHES["viterbi_backtrace"] == before["viterbi_backtrace"]
    obs = obs_log_likelihoods(lem, sym, st["gauss_params"],
                              st["gauss_values"], st["obs_weights"])
    want_p, want_s = dp.viterbi(ls, lt, obs, lens)
    assert torch.equal(path, want_p)
    torch.testing.assert_close(score, want_s, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", K1_STATES)
def test_k1_streams_match_plain(device, rng, S, variant, G):
    args, st = _case(rng, device, S, 41, variant, G)
    before = (ck.LAUNCHES["em_fwd" + variant],
              ck.LAUNCHES["em_bwd_stats" + variant])
    got = ck.em_counts_fused(*args, **st)
    want = ck.em_counts_fused_plain(*args, **st)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-4)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    if "g" in variant:
        for g, w in zip(got[4], want[4]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    else:
        assert len(got) == 4
    again = ck.em_counts_fused(*args, **st)
    for g, a in zip(got[:4], again[:4]):
        assert torch.equal(g, a)
    if "g" in variant:
        for g, a in zip(got[4], again[4]):
            assert torch.equal(g, a)
    assert (ck.LAUNCHES["em_fwd" + variant],
            ck.LAUNCHES["em_bwd_stats" + variant]) == (before[0] + 2,
                                                       before[1] + 2)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", STATES)
def test_k4_streams_match_plain(device, rng, S, variant, G):
    args, st = _case(rng, device, S, 37, variant, G)
    ls, lt, lem, sym, lens = args
    # the lanes kernel to 32 states, the shared one beyond
    name = ("post_decode_lanes" if S <= 32 else "post_decode") + variant
    before = ck.LAUNCHES[name]
    alpha = ck.em_fwd(*args, **st)[0]
    got = ck.post_decode(lt, lem, sym, lens, alpha, **st)
    want, margin = ck.post_decode_plain(lt, lem, sym, lens, alpha,
                                        with_margin=True, **st)
    assert_paths_agree(got, want, margin)
    fused = ck.posterior_decode_fused(*args, **st)
    assert torch.equal(fused, got)
    assert ck.LAUNCHES[name] == before + 2


def test_streams_envelope_raises(device, rng):
    """Each kernel's shared memory grows by the coefficient table [S, 3G]
    (K1's reverse also by each warp's moments): a large G leaves the
    envelope, and the wrappers raise naming the ROADMAP item."""
    args, st = _case(rng, device, 200, 4, "+g", 64)
    with pytest.raises(NotImplementedError, match="K1 beyond"):
        ck.em_counts_fused(*args, **st)
    with pytest.raises(NotImplementedError, match="K2/K3 beyond"):
        ck.viterbi_fwd(*args, **st)
    alpha = torch.ones((args[3].shape[0], 4, 200), device=device)
    with pytest.raises(NotImplementedError, match="K4, X1 and X2"):
        ck.post_decode(*args[1:], alpha, **st)
