"""K1 (the fused E-step kernels) against its plain-torch version, on the
card.

The kernels and the plain versions compute the same algorithm in
float32 but sum in different orders (the kernel's S-term products are
FMA chains, the plain version's are matrix products; the kernel reduces
the statistics per warp, then per block), and the card's expf and torch's
exp may differ by an ulp.  So the kernels are held to the plain versions
within stated tolerances: alpha rows and scales to 1e-5, loglik to 1e-5
relative, the statistics to the JAX package's engine tolerances (1e-4
relative, 1e-5 to 1e-4 absolute; tests/test_pallas.py).  Two launches on
the same input must give the same bits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import em  # noqa: E402

from test_cuda_kernels import _model  # noqa: E402

pytestmark = pytest.mark.cuda

# S = 3, 10, 20 (one state per lane), 40 (2), 70 (4; above 48 KB of
# shared memory in the reverse kernel), 100 (4 per lane, 2 warps per
# reverse block at T=5, V=8), 140 (8 per lane, 1 warp per reverse block)
STATES = [3, 10, 20, 40, 70, 100, 140]


def _inputs(rng, device, S, L, T=5, V=8, zero_frac=0.0):
    tables = _model(rng, S, T, V, zero_frac)
    lengths = np.asarray([L, max(L - 5, 0), 1, 0, min(2, L), L // 2],
                         np.int32)
    sym = rng.randint(0, V, size=(len(lengths), L, T)).astype(np.int32)
    p = from_numpy(*tables, device)
    return (p.log_start, p.log_trans, p.log_em,
            torch.from_numpy(sym).to(device),
            torch.from_numpy(lengths).to(device))


def _close_stats(got, want):
    start, pair, em_c, ll = got
    w_start, w_pair, w_em, w_ll = want
    torch.testing.assert_close(ll, w_ll, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(start, w_start, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pair, w_pair, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(em_c, w_em, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", STATES)
def test_k1_matches_plain(device, rng, S, zero_frac):
    args = _inputs(rng, device, S, 41, zero_frac=zero_frac)
    before = dict(ck.LAUNCHES)
    alpha, dm, m_raw = ck.em_fwd(*args)
    p_alpha, p_dm, p_m = ck.em_fwd_plain(*args)
    torch.testing.assert_close(alpha, p_alpha, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m_raw, p_m, rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(dm, p_dm, rtol=1e-5, atol=1e-5)
    got = ck.em_bwd_stats(args[1], args[2], args[3], args[4], alpha, m_raw)
    want = ck.em_bwd_stats_plain(args[1], args[2], args[3], args[4],
                                 alpha, m_raw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    _close_stats(ck.em_counts_fused(*args), ck.em_counts_fused_plain(*args))
    assert ck.LAUNCHES["em_fwd"] == before["em_fwd"] + 2
    assert ck.LAUNCHES["em_bwd_stats"] == before["em_bwd_stats"] + 2


@pytest.mark.parametrize("S", [10, 20])
def test_k1_repeat_runs_bit_identical(device, rng, S):
    args = _inputs(rng, device, S, 300)
    first = ck.em_counts_fused(*args)
    second = ck.em_counts_fused(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [3, 10])
def test_engines_agree_on_the_card(device, rng, S):
    """em_sufficient_stats: K1 against the plain log-space engine."""
    ls, lt, lem, sym, lens = _inputs(rng, device, S, 57, zero_frac=0.3)
    params = from_numpy(ls.cpu(), lt.cpu(), lem.cpu(), device)
    got = em.em_sufficient_stats(params, sym, lens, engine="cuda")
    want = em.em_sufficient_stats(params, sym, lens, engine="plain")
    torch.testing.assert_close(got.loglik, want.loglik, rtol=1e-5,
                               atol=0.0)
    torch.testing.assert_close(got.start, want.start, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got.trans, want.trans, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got.em, want.em, rtol=1e-4, atol=1e-4)
    assert float(got.n_obs) == float(want.n_obs)
    # auto picks the kernel for a CUDA tensor
    before = ck.LAUNCHES["em_fwd"]
    em.em_sufficient_stats(params, sym, lens)
    assert ck.LAUNCHES["em_fwd"] == before + 1


@pytest.mark.parametrize("S,warps", [(86, 4), (87, 2), (118, 1), (148, 1)])
def test_k1_reverse_warps_per_block(device, rng, S, warps):
    """At T=5, V=9 the reverse kernel runs 4 warps per block up to
    S=86, then 2, then 1 up to S=148, the envelope's edge."""
    assert ck._k1_bwd_warps(S, 5, 9) == warps
    args = _inputs(rng, device, S, 9, T=5, V=9)
    _close_stats(ck.em_counts_fused(*args), ck.em_counts_fused_plain(*args))


def test_k1_outside_the_envelope_raises(device, rng):
    args = _inputs(rng, device, 149, 4, T=5, V=9)
    with pytest.raises(NotImplementedError, match="K1"):
        ck.em_counts_fused(*args)
    args = _inputs(rng, device, 300, 4, T=1, V=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ck.em_fwd(*args)


def test_k1_bad_symbols_raise(device, rng):
    ls, lt, lem, sym, lens = _inputs(rng, device, 10, 8)
    with pytest.raises(ValueError, match="symbols"):
        ck.em_fwd(ls, lt, lem, sym + lem.shape[2], lens)
