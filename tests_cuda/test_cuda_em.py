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
the same input must give the same bits.  To 32 states the lanes kernels
run (``ck.k1_step``); they are held to the shared kernels, forced with
``K1_LANES_MAX_STATES`` = 0, bit for bit on every output."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import em  # noqa: E402

from test_cuda_kernels import _model  # noqa: E402
from test_cuda_streams import _streams  # noqa: E402

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


# K1's step variants: every state count of the lanes kernels' registers
# (S rounded up to 4, the gather of the row max to 16 states and the
# butterfly beyond), every stream variant, ragged lengths on both sides
# of the ring's halves (32 positions), B no multiple of the warps a block
K1_LANES_STATES = [1, 2, 10, 16, 17, 20, 31, 32]
K1_VARIANTS = ["", "+w", "+g", "+wg"]
K1_LENGTHS = [0, 1, 31, 32, 33, 65]
K1_T, K1_V, K1_G = 5, 9, 2


def _k1_case(S, B, variant):
    rng = np.random.RandomState(S * 100 + B)
    L = max(K1_LENGTHS)
    lengths = np.resize(np.asarray(K1_LENGTHS, np.int32), B)
    lengths[len(K1_LENGTHS):] = rng.randint(0, L + 1,
                                            size=B - len(K1_LENGTHS))
    p = from_numpy(*_model(rng, S, K1_T, K1_V, zero_frac=0.3), "cuda")
    sym = rng.randint(0, K1_V, size=(B, L, K1_T)).astype(np.int32)
    args = (p.log_start, p.log_trans, p.log_em,
            torch.from_numpy(sym).cuda(), torch.from_numpy(lengths).cuda())
    return args, _streams(rng, "cuda", variant, B, L, S, K1_G)


def _k1_outputs(args, st):
    """Every output of both kernels: alpha_p, dm, m_raw, start, pair, em
    and, with gaussian tracks, the three moments."""
    alpha, dm, m_raw = ck.em_fwd(*args, **st)
    stats = ck.em_bwd_stats(*args[1:], alpha, m_raw, **st)
    moments = list(stats[3]) if len(stats) > 3 else []
    return [alpha, dm, m_raw, *stats[:3]] + moments


@pytest.mark.parametrize("B", [6, 13])
@pytest.mark.parametrize("variant", K1_VARIANTS)
@pytest.mark.parametrize("S", K1_LANES_STATES)
def test_k1_lanes_equal_shared_bit_for_bit(device, monkeypatch, S, variant,
                                           B):
    """The lanes kernels give the shared kernels' bits (forced at S <=
    32, where they are K1 as it ran before the lanes kernels) on every
    output, are within the existing tolerances of the plain versions, and
    launch once each under their variant's counter; two runs give the
    same bits."""
    args, st = _k1_case(S, B, variant)
    G = K1_G if "g" in variant else 0
    assert ck.k1_step(S, K1_T, K1_V, G) == "lanes"
    before = dict(ck.LAUNCHES)
    lanes = _k1_outputs(args, st)
    assert ck.LAUNCHES["em_fwd" + variant] == before["em_fwd" + variant] + 1
    assert ck.LAUNCHES["em_bwd_stats" + variant] == \
        before["em_bwd_stats" + variant] + 1
    again = _k1_outputs(args, st)
    monkeypatch.setattr(ck, "K1_LANES_MAX_STATES", 0)
    assert ck.k1_step(S, K1_T, K1_V, G) == "shared"
    shared = _k1_outputs(args, st)
    assert len(lanes) == (9 if G else 6)
    for got, rerun, want in zip(lanes, again, shared):
        assert got.shape == want.shape
        assert torch.equal(got, want)
        assert torch.equal(got, rerun)
    alpha, dm, m_raw = ck.em_fwd_plain(*args, **st)
    torch.testing.assert_close(lanes[0], alpha, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lanes[1], dm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lanes[2], m_raw, rtol=1e-5, atol=1e-30)
    want = ck.em_bwd_stats_plain(*args[1:], alpha, m_raw, **st)
    for g, w in zip(lanes[3:6], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    for g, w in zip(lanes[6:], want[3] if G else ()):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S, T, V, G", [
    (1, 5, 9, 0), (10, 5, 9, 2), (20, 5, 8, 0), (32, 5, 9, 2),
    (32, 1, 2, 0), (2, 5, 145, 0), (2, 100, 145, 0), (8, 40, 4, 3)])
def test_k1_lanes_smem_sizes_are_the_library_s(device, S, T, V, G):
    """``k1_step``'s fit test sizes the lanes kernels' shared memory as
    the library's launches do, in the forward and at the reverse's
    warps a block."""
    lib = ck.load_library()
    warps = ck._k1_bwd_warps(S, T, V, G)
    assert ck._k1_lanes_smem_floats(S, T, V, warps, G) == (
        lib.tehmm_k1_lanes_smem_floats(S, T, V, G, 0, 0),
        lib.tehmm_k1_lanes_smem_floats(S, T, V, G, 1, warps))


@pytest.mark.parametrize("variant", K1_VARIANTS)
@pytest.mark.parametrize("S", [1, 10, 32])
def test_k4_forward_lanes_equal_shared(device, monkeypatch, S, variant):
    """K4 runs K1's forward: its path with the lanes forward is the one
    with the shared forward forced."""
    args, st = _k1_case(S, 13, variant)
    lanes = ck.posterior_decode_fused(*args, **st)
    monkeypatch.setattr(ck, "K1_LANES_MAX_STATES", 0)
    assert torch.equal(lanes, ck.posterior_decode_fused(*args, **st))
