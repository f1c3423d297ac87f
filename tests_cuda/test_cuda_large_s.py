"""The scan tile past 256 states, on the card: K5 (``viterbi_values``),
K6a/K6b (``forward_prob``, ``backward_prob``), K7a/K7b
(``forward_scaled``, ``backward_scaled``), K8c (``viterbi_pointers``,
uint16 pointers) and the chase, and the carry modes that run K3, X1 and
X2 past their one-warp kernels' envelope (``ck.sweep_fits``: S <= 239).

Past 256 states a thread owns 2 (S <= 512) or 4 states of each of its
block's 2 or 4 rows and the matrix is staged through shared memory block
by block every step, each staged block serving all the rows, each output's
product four interleaved partial results as at S <= 256 (K8c's argmax one
chain in row order): K5, K8c, the chase and K3 are float32
add, subtract and max only and equal the plain versions bit for bit; the
sum-product scans are held to the plain versions carried in float64 (K6
within 2e-6, K7 and X1/X2 within 1e-5 plus 4 float32 ulps of the largest
|obs|, the limit chip_smoke.py states for them), and two launches give
the same bits.  S = 257, 300, 511 take two states a thread (the second
only for the first S - 256 threads), 512 two of every thread, 767, 1023
and 1024 four; S = 300 also runs with four rows a block (a batch past
one wave of blocks).

From 257 states K7a/K7b, X1's and X2's carry modes, K5, K3's carry mode,
K8c, K6a and K6b run the cluster tile (csrc/scan_cluster.cuh): each must
equal the staged tile (forced, ``ck.SCAN_CLUSTER_MAX_STATES`` = 0) bit for
bit, at every S, row count (one wave of clusters and past it) and length
(K5, K3 and K8c also plain's, K8c on ties too; K6 within 2e-6 of plain in
float64), and a launch the card refuses raises."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp  # noqa: E402
from tehmm_tpu_torch.ops import em  # noqa: E402
from tehmm_tpu_torch.parallel import stitch  # noqa: E402

from test_cuda_engines import _loglik, _obs_inputs  # noqa: E402
from test_cuda_kernels import _model  # noqa: E402

pytestmark = pytest.mark.cuda

STATES = [257, 300, 511, 512, 767, 1023, 1024]
F64 = torch.float64
F32_EPS = float(np.finfo(np.float32).eps)


def _log_limit(obs):
    """1e-5 plus 4 float32 ulps of the largest |obs|: a step rounds
    obs + log(sum) and its max, each to half an ulp of |obs|."""
    return 1e-5 + 4 * F32_EPS * float(obs.abs().max())


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 23])
@pytest.mark.parametrize("S", STATES)
def test_viterbi_values_and_pointers_bit_equal(device, rng, S, L,
                                               zero_frac):
    ls, lt, obs, _p, _m, lens = _obs_inputs(rng, device, S, L, zero_frac)
    before = dict(ck.LAUNCHES)
    v, dm = ck.viterbi_values(ls, lt, obs, lens)
    pv, pdm = ck.viterbi_values_plain(ls, lt, obs, lens)
    assert torch.equal(v, pv) and torch.equal(dm, pdm)
    ptrs, v_last, pdm2 = ck.viterbi_pointers(ls, lt, obs, lens)
    want = ck.viterbi_pointers_plain(ls, lt, obs, lens)
    assert ptrs.dtype == torch.uint16 == want[0].dtype
    assert torch.equal(ptrs, want[0]) and torch.equal(v_last, want[1]) \
        and torch.equal(pdm2, want[2])
    assert torch.equal(v_last, v[:, -1]) and torch.equal(pdm2, dm)
    path = ck.pointer_chase(ptrs, v_last, lens)
    assert torch.equal(path, ck.pointer_chase_plain(ptrs, v_last, lens))
    want_p, want_s = dp.viterbi(ls, lt, obs, lens)
    assert torch.equal(path, want_p)
    got_p, got_s = dp.viterbi_streaming(ls, lt, obs, lens)
    assert torch.equal(got_p, want_p)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-4)
    # K5 and K8c on the cluster tile past 256 states
    for name in ("viterbi_values_cluster", "viterbi_ptrs_cluster",
                 "pointer_chase"):
        assert ck.LAUNCHES[name] > before[name], name
    assert ck.LAUNCHES["viterbi_backtrace"] > before["viterbi_backtrace"]


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", STATES)
def test_sum_product_scans_match_plain(device, rng, S, zero_frac):
    ls, lt, obs, obs_p, o_m, lens = _obs_inputs(rng, device, S, 23,
                                                zero_frac)
    alpha, dm = ck.forward_prob(ls, lt, obs_p, lens)
    beta = ck.backward_prob(lt, obs_p, lens)
    r_alpha, r_dm = ck.forward_prob_plain(ls, lt, obs_p, lens, dtype=F64)
    torch.testing.assert_close(alpha, r_alpha.float(), rtol=0, atol=2e-6)
    torch.testing.assert_close(dm, r_dm.float(), rtol=0, atol=1e-5)
    torch.testing.assert_close(
        beta, ck.backward_prob_plain(lt, obs_p, lens, dtype=F64).float(),
        rtol=0, atol=2e-6)
    p_alpha, p_dm = ck.forward_prob_plain(ls, lt, obs_p, lens)
    torch.testing.assert_close(_loglik(alpha, dm, o_m, lens),
                               _loglik(p_alpha, p_dm, o_m, lens),
                               rtol=1e-5, atol=1e-5)
    assert bool((alpha[lens == 0] == 1).all())
    assert torch.equal(alpha, ck.forward_prob(ls, lt, obs_p, lens)[0])
    assert torch.equal(beta, ck.backward_prob(lt, obs_p, lens))

    lim = _log_limit(obs)
    fwd = ck.forward_scaled(ls, lt, obs, lens)
    ref = ck.forward_scaled_plain(ls, lt, obs, lens, dtype=F64)
    torch.testing.assert_close(fwd[0], ref[0].float(), rtol=0, atol=lim)
    torch.testing.assert_close(fwd[1], ref[1].float(), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(fwd[2], ref[2].float(), rtol=1e-6, atol=1e-6)
    bwd = ck.backward_scaled(lt, obs, lens)
    ref = ck.backward_scaled_plain(lt, obs, lens, dtype=F64)
    torch.testing.assert_close(bwd[0], ref[0].float(), rtol=0, atol=lim)
    torch.testing.assert_close(bwd[1], ref[1].float(), rtol=1e-5, atol=1e-4)
    assert bool((fwd[0][lens == 0] == 0).all())
    for b, n in enumerate(lens.tolist()):
        assert bool((bwd[0][b, max(n - 1, 0):] == 0).all())
    assert all(torch.equal(a, b) for a, b in
               zip(fwd, ck.forward_scaled(ls, lt, obs, lens)))
    assert all(torch.equal(a, b) for a, b in
               zip(bwd, ck.backward_scaled(lt, obs, lens)))


def test_four_rows_a_block_past_one_wave(device, rng):
    """At S = 300 a block holds two rows or four; a batch past one wave
    of blocks at two (at most 132 SMs x 2 blocks x 2 rows; here 1200
    rows) takes four, and the first rows keep the bits two rows a block
    give them."""
    S, L = 300, 9
    ls, lt, obs, obs_p, _m, lens = _obs_inputs(rng, device, S, L, 0.3,
                                               rows=240)
    few = slice(0, 5)
    obs5, obs_p5, lens5 = obs[few].contiguous(), obs_p[few].contiguous(), \
        lens[few]
    v = ck.viterbi_values(ls, lt, obs, lens)
    assert torch.equal(v[0], ck.viterbi_values_plain(ls, lt, obs, lens)[0])
    assert torch.equal(v[0][few], ck.viterbi_values(ls, lt, obs5, lens5)[0])
    ptrs = ck.viterbi_pointers(ls, lt, obs, lens)
    assert torch.equal(ptrs[0], ck.viterbi_pointers_plain(ls, lt, obs,
                                                          lens)[0])
    assert torch.equal(ptrs[0][few],
                       ck.viterbi_pointers(ls, lt, obs5, lens5)[0])
    for whole, part in (
            (ck.forward_prob(ls, lt, obs_p, lens)[0],
             ck.forward_prob(ls, lt, obs_p5, lens5)[0]),
            (ck.backward_prob(lt, obs_p, lens),
             ck.backward_prob(lt, obs_p5, lens5)),
            (ck.forward_scaled(ls, lt, obs, lens)[0],
             ck.forward_scaled(ls, lt, obs5, lens5)[0]),
            (ck.backward_scaled(lt, obs, lens)[0],
             ck.backward_scaled(lt, obs5, lens5)[0])):
        assert torch.equal(whole[few], part)


def test_pointers_take_the_lowest_state_on_ties(device):
    """Equal candidates past 256 states: every pointer is state 0."""
    S, L = 600, 5
    lt = torch.full((S, S), float(np.log(1.0 / S)), device=device)
    ls = torch.full((S,), float(np.log(1.0 / S)), device=device)
    obs = torch.zeros((2, L, S), device=device)
    lens = torch.tensor([L, 0], dtype=torch.int32, device=device)
    ptrs, v_last, _dm = ck.viterbi_pointers(ls, lt, obs, lens)
    want = ck.viterbi_pointers_plain(ls, lt, obs, lens)
    assert torch.equal(ptrs, want[0]) and torch.equal(v_last, want[1])
    assert bool((ptrs[0, 1:] == 0).all())
    ident = torch.arange(S, device=device).to(torch.uint16)
    assert bool((ptrs[1] == ident).all())


def _sweep_inputs(rng, device, S, L, zero_frac=0.0):
    ls, lt, obs, _p, _m, lens = _obs_inputs(rng, device, S, L, zero_frac)
    init = torch.from_numpy(rng.randn(len(lens), S).astype(np.float32)) \
        .to(device)
    init = init - init.amax(dim=-1, keepdim=True)
    cont = torch.zeros(len(lens), dtype=torch.bool, device=device)
    cont[0] = True
    return lt, obs, init, cont, lens


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", [239, 240, 512, 1024])
def test_carried_sweeps_match_plain(device, rng, S, zero_frac):
    """K3 bit-equal to plain; X1 and X2 within the log-space limit of the
    plain versions in float64; each launched under its own counter, the
    one-warp kernel at S = 239 and the tile's carry mode from 240."""
    lt, obs, init, cont, lens = _sweep_inputs(rng, device, S, 41, zero_frac)
    tile = not ck.sweep_fits(S)
    assert tile == (S >= 240)
    before = dict(ck.LAUNCHES)
    v = ck.viterbi_chunk_values(lt, obs, init, lens)
    assert torch.equal(v, dp.viterbi_chunk_values(lt, obs, init, lens))
    carry = ck.viterbi_carry(lt, obs, init, lens)
    assert torch.equal(carry, dp.viterbi_carry(lt, obs, init, lens))
    assert torch.equal(carry, v[:, -1])
    lim = _log_limit(obs)
    hats, a_carry = ck.forward_chunk_values(lt, obs, init, lens)
    r_hats, r_carry = dp.forward_chunk_values(lt, obs, init, lens,
                                              dtype=F64)
    torch.testing.assert_close(hats, r_hats.float(), rtol=0, atol=lim)
    torch.testing.assert_close(a_carry, r_carry.float(), rtol=0, atol=lim)
    final, dm_sum = ck.forward_final(lt, obs, init, lens)
    assert torch.equal(final, a_carry), "X1's two modes end apart"
    torch.testing.assert_close(
        dm_sum, dp.forward_final(lt, obs, init, lens, dtype=F64)[1].float(),
        rtol=1e-6, atol=1e-4)
    beta, x_out = ck.backward_chunk_values(lt, obs, init, cont, lens)
    r_beta, r_x = dp.backward_chunk_values(lt, obs, init, cont, lens,
                                           dtype=F64)
    torch.testing.assert_close(beta, r_beta.float(), rtol=0, atol=lim)
    torch.testing.assert_close(x_out, r_x.float(), rtol=0, atol=lim)
    # K3's, X1's and X2's carry modes past 256 states on the cluster tile,
    # to 256 on the rows kernels (``ck.scan_counter``)
    warp = {"viterbi_chunk_tile": "viterbi_chunk_values",
            "fwd_chunk_tile": "fwd_chunk", "bwd_chunk_tile": "bwd_chunk"}
    k3, x1, x2 = (ck.scan_counter(k, S) if tile else warp[k] for k in warp)
    assert ck.LAUNCHES[k3] == before[k3] + 2
    assert ck.LAUNCHES[x1] == before[x1] + 2
    assert ck.LAUNCHES[x2] == before[x2] + 1
    assert torch.equal(
        ck.backward_chunk_values(lt, obs, init, cont, lens)[0], beta)


@pytest.mark.parametrize("S", [239, 240, 512, 1024])
def test_chunked_sweeps_equal_one_chunk(device, rng, S):
    """A sweep cut into chunks gives the bits of one chunk over the whole
    row: K3's values and carries, X1's hats and carries, X2's betas."""
    lt, obs, init, cont, lens = _sweep_inputs(rng, device, S, 60)
    lens = torch.tensor([60, 60, 33, 0, 1], dtype=torch.int32,
                        device=device)
    cuts = (0, 17, 40, 60)

    def part_lens(lo, hi):
        return torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)

    whole_v = ck.viterbi_chunk_values(lt, obs, init, lens)
    whole_h, whole_c = ck.forward_chunk_values(lt, obs, init, lens)
    v_carry, a_carry = init, init
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        o = obs[:, lo:hi].contiguous()
        pl = part_lens(lo, hi)
        v = ck.viterbi_chunk_values(lt, o, v_carry, pl)
        assert torch.equal(v, whole_v[:, lo:hi])
        v_carry = ck.viterbi_carry(lt, o, v_carry, pl)
        final, _dm = ck.forward_final(lt, o, a_carry, pl)
        h, a_carry = ck.forward_chunk_values(lt, o, a_carry, pl)
        assert torch.equal(h, whole_h[:, lo:hi])
        assert torch.equal(final, a_carry)
    assert torch.equal(v_carry, whole_v[:, -1])
    assert torch.equal(a_carry, whole_c)
    # X2 from the end: the carry of the chunk after is its x_out
    whole_b, whole_x = ck.backward_chunk_values(lt, obs, init, cont, lens)
    x_carry, continuing = init, cont
    for lo, hi in reversed(list(zip(cuts[:-1], cuts[1:]))):
        o = obs[:, lo:hi].contiguous()
        b, x_carry = ck.backward_chunk_values(lt, o, x_carry, continuing,
                                              part_lens(lo, hi))
        assert torch.equal(b, whole_b[:, lo:hi])
        continuing = lens > lo
    assert torch.equal(x_carry, whole_x)


def test_posterior_sweep_chunked_equals_one_chunk(device, rng):
    """posterior_sweep (--pd's path) at S = 300 in chunks of 64 gives the
    gamma bits of one chunk over each row, and score runs on the card."""
    from tehmm_tpu_torch.io.trackdata import TrackTable
    from tehmm_tpu_torch.models.hmm import MultitrackHmm

    S = 300
    params = from_numpy(*_model(rng, S, 3, 6), device)
    syms = [rng.randint(0, 6, size=(n, 3)).astype(np.uint8)
            for n in (300, 1, 130)]

    def gammas(chunk_len):
        out = [np.zeros((len(s), S), np.float32) for s in syms]

        def consume(b, start, gamma):
            out[b][start : start + len(gamma)] = gamma

        stitch.posterior_sweep(params, syms, chunk_len, consume)
        return out

    before = dict(ck.LAUNCHES)
    for c, w in zip(gammas(64), gammas(1 << 14)):
        np.testing.assert_array_equal(c, w)
    # at S = 300 X1's and X2's carry modes run the cluster tile
    assert ck.LAUNCHES["fwd_chunk_cluster"] > before["fwd_chunk_cluster"]
    assert ck.LAUNCHES["bwd_chunk_cluster"] > before["bwd_chunk_cluster"]
    tabs = [TrackTable("chr1", 0, len(s), s) for s in syms]
    on_cpu = from_numpy(*_model(np.random.RandomState(0), S, 3, 6), "cpu")
    on_gpu = from_numpy(*_model(np.random.RandomState(0), S, 3, 6), device)
    scores = [MultitrackHmm(p, None, {}, None).score(tabs, chunk_len=64)
              for p in (on_gpu, on_cpu)]
    np.testing.assert_allclose(scores[0], scores[1], rtol=1e-5)


def test_decoders_past_256_states_equal_the_cpu(device, rng):
    """At S = 300 the stitched and exact Viterbi give the CPU's paths and
    the stitched and exact max-posterior agree with it on >= 99.9%."""
    S = 300
    tables = _model(rng, S, 3, 6)
    syms = [rng.randint(1, 6, size=(n, 3)).astype(np.uint8)
            for n in (1500, 601)]
    on_gpu = from_numpy(*tables, device)
    on_cpu = from_numpy(*tables, "cpu")
    before = dict(ck.LAUNCHES)
    for decode in (
        lambda p: stitch.viterbi_chunked(p, syms, chunk_len=512,
                                         halo=32)[0],
        lambda p: stitch.viterbi_exact(p, syms, chunk_len=256),
    ):
        for g, c in zip(decode(on_gpu), decode(on_cpu)):
            np.testing.assert_array_equal(g, c)
    # K5 and K3's carry mode on the cluster tile
    assert ck.LAUNCHES["viterbi_chunk_cluster"] \
        > before["viterbi_chunk_cluster"]
    assert ck.LAUNCHES["viterbi_values_cluster"] \
        > before["viterbi_values_cluster"]
    for decode in (
        lambda p: stitch.posterior_chunked(p, syms, chunk_len=512,
                                           halo=32)[0],
        lambda p: stitch.posterior_exact(p, syms, chunk_len=256),
    ):
        for g, c in zip(decode(on_gpu), decode(on_cpu)):
            assert (g == c).mean() >= 0.999


@pytest.mark.parametrize("S", [300, 1024])
def test_auto_takes_cuda_v3_to_1024_states(device, rng, S):
    ls, lt, lem, sym, lens = _model_inputs(rng, device, S)
    from tehmm_tpu_torch.models.params import HmmParams

    p = HmmParams(ls, lt, lem)
    assert em.resolve_engine("auto", S, 3, 6, 0, device) == "cuda_v3"
    before = dict(ck.LAUNCHES)
    got = em.em_sufficient_stats(p, sym, lens)
    # K6a and K6b on the cluster tile past 256 states
    for name in ("fwd_prob_cluster", "bwd_prob_cluster"):
        assert ck.LAUNCHES[name] == before[name] + 1, name
    assert ck.LAUNCHES["fwd_prob"] == before["fwd_prob"]
    assert ck.LAUNCHES["bwd_prob"] == before["bwd_prob"]
    want = em.em_sufficient_stats(p, sym, lens, engine="plain")
    torch.testing.assert_close(got.loglik, want.loglik, rtol=1e-5, atol=0)
    torch.testing.assert_close(got.trans, want.trans, rtol=1e-4, atol=1e-5)


def _model_inputs(rng, device, S):
    from test_cuda_kernels import _inputs

    return _inputs(rng, device, S, 19)


def test_envelope_raises_naming_its_item(device):
    """Past 1024 states every tile wrapper, the carried sweeps' wrappers
    past their one-warp kernels, the backtrace and ``"auto"`` raise
    naming the tile's item."""
    S = ck.STREAMING_MAX_STATES + 1
    obs = torch.zeros((2, 3, S), device=device)
    lt = torch.zeros((S, S), device=device)
    ls = torch.zeros((S,), device=device)
    carry = torch.zeros((2, S), device=device)
    lens = torch.full((2,), 3, dtype=torch.int32, device=device)
    cont = torch.zeros(2, dtype=torch.bool, device=device)
    end = torch.zeros(2, dtype=torch.int32, device=device)
    ptrs = torch.zeros((2, 3, S), dtype=torch.uint16, device=device)
    for call in (lambda: ck.viterbi_values(ls, lt, obs, lens),
                 lambda: ck.forward_prob(ls, lt, obs, lens),
                 lambda: ck.backward_prob(lt, obs, lens),
                 lambda: ck.forward_scaled(ls, lt, obs, lens),
                 lambda: ck.backward_scaled(lt, obs, lens),
                 lambda: ck.viterbi_pointers(ls, lt, obs, lens),
                 lambda: ck.pointer_chase(ptrs, carry, lens),
                 lambda: ck.viterbi_chunk_values(lt, obs, carry, lens),
                 lambda: ck.viterbi_carry(lt, obs, carry, lens),
                 lambda: ck.forward_chunk_values(lt, obs, carry, lens),
                 lambda: ck.forward_final(lt, obs, carry, lens),
                 lambda: ck.backward_chunk_values(lt, obs, carry, cont,
                                                  lens),
                 lambda: ck.viterbi_backtrace(lt, obs, carry, end, lens),
                 lambda: em.resolve_engine("auto", S, 3, 6, 0, device)):
        with pytest.raises(NotImplementedError, match="tile beyond 1024"):
            call()


# ---------------------------------------------------------------------
# the cluster tile against the staged tile, bit for bit
# ---------------------------------------------------------------------

CLUSTER_STATES = [257, 300, 511, 512, 640, 1000, 1023, 1024]
CLUSTER_ROWS = [1, 4, 64, 128]


def _cluster_inputs(rng, device, S, B, L, zero_frac):
    """A random model (``zero_frac`` of the transitions zero) and obs of
    B rows of L, ragged: L, 0, 1, then lengths drawn in [0, L]."""
    ls, lt, lem = (torch.from_numpy(x).to(device) for x in
                   _model(rng, S, 3, 6, zero_frac))
    sym = torch.from_numpy(
        rng.randint(0, 6, size=(B, L, 3)).astype(np.int32)).to(device)
    from tehmm_tpu_torch.models.emission import track_log_likelihoods

    obs = track_log_likelihoods(lem, sym)
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    lengths[:3] = [L, 0, 1][:B]
    init = torch.from_numpy(rng.randn(B, S).astype(np.float32)).to(device)
    init = init - init.amax(dim=-1, keepdim=True)
    # a row continues past the chunk only where it fills it
    cont = torch.from_numpy((rng.rand(B) < 0.5) & (lengths == L)).to(device)
    return ls, lt, obs, torch.from_numpy(lengths).to(device), init, cont


def _both_tiles(monkeypatch, fn):
    """fn() on the cluster tile, then on the staged tile forced; each
    tile's counters moved as they should."""
    before = dict(ck.LAUNCHES)
    got = fn()
    cluster = {k for k in ck.LAUNCHES if ck.LAUNCHES[k] != before[k]}
    with monkeypatch.context() as m:
        m.setattr(ck, "SCAN_CLUSTER_MAX_STATES", 0)
        before = dict(ck.LAUNCHES)
        want = fn()
        staged = {k for k in ck.LAUNCHES if ck.LAUNCHES[k] != before[k]}
    assert ck.SCAN_CLUSTER_MAX_STATES == 1024
    assert cluster and all(k.endswith("_cluster") for k in cluster)
    assert staged and not any(k.endswith("_cluster") for k in staged)
    return got, want


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("B", CLUSTER_ROWS)
@pytest.mark.parametrize("S", CLUSTER_STATES)
def test_cluster_scans_equal_the_staged_tile(device, rng, monkeypatch, S, B,
                                             zero_frac):
    """K7a/K8a (alpha_hat, log_c, loglik) and K7b/K8b (beta_hat, log_d):
    the cluster tile's bits are the staged tile's."""
    ls, lt, obs, lens, _i, _c = _cluster_inputs(rng, device, S, B, 13,
                                                zero_frac)
    got, want = _both_tiles(
        monkeypatch, lambda: ck.forward_scaled(ls, lt, obs, lens))
    assert _equal(got, want)
    got, want = _both_tiles(
        monkeypatch, lambda: ck.backward_scaled(lt, obs, lens))
    assert _equal(got, want)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("B", CLUSTER_ROWS)
@pytest.mark.parametrize("S", CLUSTER_STATES)
def test_cluster_carry_modes_equal_the_staged_tile(device, rng, monkeypatch,
                                                   S, B, zero_frac):
    """X1's carry mode (values and carry-only) and X2's (values and
    x_out, each row with its own ``continuing``): the cluster tile's bits
    are the staged tile's."""
    _ls, lt, obs, lens, init, cont = _cluster_inputs(rng, device, S, B, 13,
                                                     zero_frac)
    for fn in (lambda: ck.forward_chunk_values(lt, obs, init, lens),
               lambda: ck.forward_final(lt, obs, init, lens),
               lambda: ck.backward_chunk_values(lt, obs, init, cont, lens)):
        got, want = _both_tiles(monkeypatch, fn)
        assert _equal(got, want)


@pytest.mark.parametrize("S", [300, 1024])
def test_cluster_tile_past_one_wave(device, rng, monkeypatch, S):
    """More rows than the card holds clusters of the most rows at once:
    the plan keeps 12 rows a cluster and the grid runs in waves, with the
    staged tile's bits and each row's bits those of a launch of its
    own."""
    plan = ck.library_cluster_plan(S, 1, False)
    B = 12 * plan["active"][-1] + 5
    ls, lt, obs, lens, _i, _c = _cluster_inputs(rng, device, S, B, 7, 0.3)
    wide = ck.library_cluster_plan(S, B, False)
    assert wide["R"] == 12 and wide["clusters"] > wide["active"][-1]
    got, want = _both_tiles(
        monkeypatch, lambda: ck.forward_scaled(ls, lt, obs, lens))
    assert _equal(got, want)
    got_b, want_b = _both_tiles(
        monkeypatch, lambda: ck.backward_scaled(lt, obs, lens))
    assert _equal(got_b, want_b)
    few = slice(B - 3, B)
    alone = ck.forward_scaled(ls, lt, obs[few].contiguous(), lens[few])
    assert torch.equal(alone[0], got[0][few])
    alone = ck.backward_scaled(lt, obs[few].contiguous(), lens[few])
    assert torch.equal(alone[0], got_b[0][few])


@pytest.mark.parametrize("S", [257, 640, 1024])
def test_cluster_sweep_cut_into_chunks_equals_one_chunk(device, rng, S):
    """On the cluster tile a sweep cut into chunks gives one chunk's
    bits: X1's hats and carries, X2's betas and x_out."""
    _ls, lt, obs, _l, init, cont = _cluster_inputs(rng, device, S, 5, 60,
                                                   0.3)
    lens = torch.tensor([60, 60, 33, 0, 1], dtype=torch.int32,
                        device=device)
    cont = torch.tensor([True, False, False, False, False], device=device)
    cuts = (0, 17, 40, 60)
    whole_h, whole_c = ck.forward_chunk_values(lt, obs, init, lens)
    carry = init
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        pl = torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)
        h, carry = ck.forward_chunk_values(lt, obs[:, lo:hi].contiguous(),
                                           carry, pl)
        assert torch.equal(h, whole_h[:, lo:hi])
    assert torch.equal(carry, whole_c)
    whole_b, whole_x = ck.backward_chunk_values(lt, obs, init, cont, lens)
    x, continuing = init, cont
    for lo, hi in reversed(list(zip(cuts[:-1], cuts[1:]))):
        pl = torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)
        b, x = ck.backward_chunk_values(lt, obs[:, lo:hi].contiguous(), x,
                                        continuing, pl)
        assert torch.equal(b, whole_b[:, lo:hi])
        continuing = lens > lo
    assert torch.equal(x, whole_x)


@pytest.mark.parametrize("S", [640, 1000])
def test_cluster_scans_match_plain_in_float64(device, rng, S):
    """Where the existing float64 checks have no S of their own: K7a/K7b
    and X1/X2 on the cluster tile within the log-space limit (1e-5 plus 4
    float32 ulps of the largest |obs|) of the plain versions carried in
    float64."""
    ls, lt, obs, lens, init, cont = _cluster_inputs(rng, device, S, 5, 23,
                                                    0.3)
    lim = _log_limit(obs)
    fwd = ck.forward_scaled(ls, lt, obs, lens)
    ref = ck.forward_scaled_plain(ls, lt, obs, lens, dtype=F64)
    torch.testing.assert_close(fwd[0], ref[0].float(), rtol=0, atol=lim)
    bwd = ck.backward_scaled(lt, obs, lens)
    ref = ck.backward_scaled_plain(lt, obs, lens, dtype=F64)
    torch.testing.assert_close(bwd[0], ref[0].float(), rtol=0, atol=lim)
    hats, carry = ck.forward_chunk_values(lt, obs, init, lens)
    r_hats, r_carry = dp.forward_chunk_values(lt, obs, init, lens,
                                              dtype=F64)
    torch.testing.assert_close(hats, r_hats.float(), rtol=0, atol=lim)
    torch.testing.assert_close(carry, r_carry.float(), rtol=0, atol=lim)
    beta, x_out = ck.backward_chunk_values(lt, obs, init, cont, lens)
    r_beta, r_x = dp.backward_chunk_values(lt, obs, init, cont, lens,
                                           dtype=F64)
    torch.testing.assert_close(beta, r_beta.float(), rtol=0, atol=lim)
    torch.testing.assert_close(x_out, r_x.float(), rtol=0, atol=lim)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B", [1, 4, 64, 128, 4096])
@pytest.mark.parametrize("S", CLUSTER_STATES)
def test_cluster_plan_is_the_libraries(device, S, B, backward):
    """The Python plan, given the card's active clusters at each R, is the
    plan the launch takes; it fits the card's shared memory."""
    lib = ck.library_cluster_plan(S, B, backward)
    active = dict(zip(ck._CLUSTER_ROWS, lib.pop("active")))
    assert ck.cluster_plan(S, B, backward,
                           lambda R, smem: active[R]) == lib
    assert lib["smem"] <= 232448 and active[lib["R"]] >= 1


def test_a_refused_cluster_launch_raises(device):
    """The cluster entry at S <= 256 has no plan: the launch is refused
    and the wrapper's launch raises, with nothing counted and nothing run
    in its place."""
    S, B, L = 200, 2, 3
    obs = torch.zeros((B, L, S), device=device)
    lens = torch.full((B,), L, dtype=torch.int32, device=device)
    ls = torch.zeros(S, device=device)
    tp = torch.ones((S, S), device=device)
    alpha = torch.full((B, L, S), 7.0, device=device)
    dm = torch.empty((B, L), device=device)
    before = dict(ck.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        ck._launch_streaming(
            "fwd_scaled_cluster", "tehmm_fwd_scaled",
            (obs.data_ptr(), lens.data_ptr(), ls.data_ptr(), tp.data_ptr(),
             alpha.data_ptr(), dm.data_ptr(), B, L, S, 1), device)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before
    assert bool((alpha == 7.0).all())


# ---------------------------------------------------------------------
# K5, K3's carry mode and K8c on the cluster tile
# ---------------------------------------------------------------------

@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("B", CLUSTER_ROWS)
@pytest.mark.parametrize("S", CLUSTER_STATES)
def test_cluster_viterbi_equals_the_staged_tile(device, rng, monkeypatch, S,
                                                B, zero_frac):
    """K5 (value rows, dm) and K8c (uint16 pointers, v_last, dm): the
    cluster tile's bits are the staged tile's and plain's."""
    ls, lt, obs, lens, _i, _c = _cluster_inputs(rng, device, S, B, 13,
                                                zero_frac)
    got, want = _both_tiles(
        monkeypatch, lambda: ck.viterbi_values(ls, lt, obs, lens))
    assert _equal(got, want)
    assert _equal(got, ck.viterbi_values_plain(ls, lt, obs, lens))
    got_p, want_p = _both_tiles(
        monkeypatch, lambda: ck.viterbi_pointers(ls, lt, obs, lens))
    assert got_p[0].dtype == torch.uint16
    assert _equal(got_p, want_p)
    assert _equal(got_p, ck.viterbi_pointers_plain(ls, lt, obs, lens))
    assert torch.equal(got_p[1], got[0][:, -1])
    assert torch.equal(got_p[2], got[1])


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("B", CLUSTER_ROWS)
@pytest.mark.parametrize("S", CLUSTER_STATES)
def test_cluster_k3_carry_mode_equals_the_staged_tile(device, rng,
                                                      monkeypatch, S, B,
                                                      zero_frac):
    """K3's carry mode (value rows, and the carry alone): the cluster
    tile's bits are the staged tile's and plain's."""
    _ls, lt, obs, lens, init, _c = _cluster_inputs(rng, device, S, B, 13,
                                                   zero_frac)
    for fn, plain in (
            (lambda: ck.viterbi_chunk_values(lt, obs, init, lens),
             lambda: dp.viterbi_chunk_values(lt, obs, init, lens)),
            (lambda: ck.viterbi_carry(lt, obs, init, lens),
             lambda: dp.viterbi_carry(lt, obs, init, lens))):
        got, want = _both_tiles(monkeypatch, lambda: (fn(),))
        assert _equal(got, want) and torch.equal(got[0], plain())


@pytest.mark.parametrize("S", [300, 1024])
def test_cluster_viterbi_past_one_wave(device, rng, monkeypatch, S):
    """More rows than the card holds clusters of the most rows at once:
    K5, K8c and K3's carry mode keep the staged tile's bits, and each
    row's bits are those of a launch of its own."""
    plan = ck.library_cluster_plan(S, 1, "viterbi_ptrs")
    B = 12 * plan["active"][-1] + 5
    ls, lt, obs, lens, init, _c = _cluster_inputs(rng, device, S, B, 7, 0.3)
    for kernel in ("viterbi_values", "viterbi_ptrs"):
        wide = ck.library_cluster_plan(S, B, kernel)
        assert wide["R"] == 12 and wide["clusters"] > wide["active"][-1]
    few = slice(B - 3, B)
    for fn in (lambda o, n, c: ck.viterbi_values(ls, lt, o, n),
               lambda o, n, c: ck.viterbi_pointers(ls, lt, o, n),
               lambda o, n, c: (ck.viterbi_chunk_values(lt, o, c, n),)):
        got, want = _both_tiles(monkeypatch, lambda: fn(obs, lens, init))
        assert _equal(got, want)
        alone = fn(obs[few].contiguous(), lens[few], init[few].contiguous())
        assert _equal(alone, (g[few] for g in got))


@pytest.mark.parametrize("S", [257, 600, 1024])
def test_cluster_pointers_take_the_lowest_state_on_ties(device, rng,
                                                       monkeypatch, S):
    """Ties on the cluster tile: equal candidates (every pointer is state
    0, as on the staged tile), and integer tables whose ties fall on every
    chain and every block of the slice; first hit, bit for bit the staged
    tile's and plain's."""
    L = 5
    lt = torch.full((S, S), float(np.log(1.0 / S)), device=device)
    ls = torch.full((S,), float(np.log(1.0 / S)), device=device)
    obs = torch.zeros((2, L, S), device=device)
    lens = torch.tensor([L, 0], dtype=torch.int32, device=device)
    got, want = _both_tiles(
        monkeypatch, lambda: ck.viterbi_pointers(ls, lt, obs, lens))
    assert _equal(got, want)
    assert _equal(got, ck.viterbi_pointers_plain(ls, lt, obs, lens))
    assert bool((got[0][0, 1:] == 0).all())
    ident = torch.arange(S, device=device).to(torch.uint16)
    assert bool((got[0][1] == ident).all())
    # integer log values: many equal candidates at every position
    lt = torch.from_numpy(-rng.randint(0, 3, size=(S, S)).astype(
        np.float32)).to(device)
    obs = torch.from_numpy(-rng.randint(0, 2, size=(3, 9, S)).astype(
        np.float32)).to(device)
    lens = torch.tensor([9, 4, 1], dtype=torch.int32, device=device)
    got, want = _both_tiles(
        monkeypatch, lambda: ck.viterbi_pointers(ls, lt, obs, lens))
    assert _equal(got, want)
    assert _equal(got, ck.viterbi_pointers_plain(ls, lt, obs, lens))
    assert bool((got[0][0, 1:].to(torch.int32) < S).all())


@pytest.mark.parametrize("S", [257, 640, 1024])
def test_cluster_k3_cut_into_chunks_equals_one_chunk(device, rng, S):
    """K3's carry mode on the cluster tile: a sweep cut into chunks gives
    one chunk's value rows and carries."""
    _ls, lt, obs, _l, init, _c = _cluster_inputs(rng, device, S, 5, 60,
                                                 0.3)
    lens = torch.tensor([60, 60, 33, 0, 1], dtype=torch.int32,
                        device=device)
    before = dict(ck.LAUNCHES)
    whole = ck.viterbi_chunk_values(lt, obs, init, lens)
    carry = init
    for lo, hi in zip((0, 17, 40), (17, 40, 60)):
        pl = torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)
        o = obs[:, lo:hi].contiguous()
        assert torch.equal(ck.viterbi_chunk_values(lt, o, carry, pl),
                           whole[:, lo:hi])
        carry = ck.viterbi_carry(lt, o, carry, pl)
    assert torch.equal(carry, whole[:, -1])
    assert ck.LAUNCHES["viterbi_chunk_cluster"] \
        == before["viterbi_chunk_cluster"] + 7
    assert ck.LAUNCHES["viterbi_chunk_tile"] == before["viterbi_chunk_tile"]


@pytest.mark.parametrize("kernel", ["viterbi_values", "viterbi_ptrs"])
@pytest.mark.parametrize("B", [1, 4, 64, 128, 4096])
@pytest.mark.parametrize("S", CLUSTER_STATES)
def test_viterbi_cluster_plans_are_the_libraries(device, S, B, kernel):
    """K5's (K3's carry mode's) and K8c's plans: the Python plan, given
    the card's active clusters of that kernel at each R, is the plan its
    launch takes."""
    lib = ck.library_cluster_plan(S, B, kernel)
    active = dict(zip(ck._CLUSTER_ROWS, lib.pop("active")))
    assert ck.cluster_plan(S, B, kernel,
                           lambda R, smem: active[R]) == lib
    assert lib["smem"] <= 232448 and active[lib["R"]] >= 1


@pytest.mark.parametrize("entry,counter", [
    ("tehmm_viterbi_values", "viterbi_values_cluster"),
    ("tehmm_viterbi_ptrs", "viterbi_ptrs_cluster")])
def test_a_refused_viterbi_cluster_launch_raises(device, entry, counter):
    """K5's and K8c's cluster entries at S <= 256 have no plan: the launch
    is refused and raises, nothing counted, nothing run in its place."""
    S, B, L = 200, 2, 3
    obs = torch.zeros((B, L, S), device=device)
    lens = torch.full((B,), L, dtype=torch.int32, device=device)
    ls = torch.zeros(S, device=device)
    lt = torch.zeros((S, S), device=device)
    rows = torch.full((B, L, S), 7.0, device=device)
    last = torch.full((B, S), 7.0, device=device)
    dm = torch.empty((B, L), device=device)
    outs = (rows.data_ptr(), dm.data_ptr()) if entry.endswith("values") \
        else (rows.data_ptr(), last.data_ptr(), dm.data_ptr())
    before = dict(ck.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        ck._launch_streaming(
            counter, entry,
            (obs.data_ptr(), lens.data_ptr(), ls.data_ptr(), lt.data_ptr(),
             *outs, B, L, S, 1), device)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before
    assert bool((rows == 7.0).all()) and bool((last == 7.0).all())


# ---------------------------------------------------------------------
# K6a and K6b on the cluster tile
# ---------------------------------------------------------------------

def _prob_inputs(rng, device, S, B, L, zero_frac):
    """_cluster_inputs' model and ragged rows as obs_p, with blank rows
    (all-zero obs: every state equally likely) at row 1 (length 0) and,
    past four rows, row 3."""
    ls, lt, obs, lens, _i, _c = _cluster_inputs(rng, device, S, B, L,
                                                zero_frac)
    for b in (1, 3):
        if b < B and (b == 1 or B > 4):
            obs[b] = 0.0
    obs_p, o_m = dp.scaled_obs_prob(obs)
    return ls, lt, obs_p, o_m, lens


def _prob_calls(ls, lt, obs_p, lens):
    return (lambda: ck.forward_prob(ls, lt, obs_p, lens),
            lambda: (ck.backward_prob(lt, obs_p, lens),))


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("B", CLUSTER_ROWS)
@pytest.mark.parametrize("S", CLUSTER_STATES)
def test_cluster_prob_scans_equal_the_staged_tile(device, rng, monkeypatch,
                                                  S, B, zero_frac):
    """K6a (alpha_p, dm) and K6b (beta_p): the cluster tile's bits are the
    staged tile's and a second launch's, within 2e-6 (dm 1e-5) of plain
    carried in float64; a row of length 0 stays all ones with dm 0, and
    beta_p is all ones from each row's last valid position on."""
    ls, lt, obs_p, _o_m, lens = _prob_inputs(rng, device, S, B, 13,
                                             zero_frac)
    fwd, bwd = _prob_calls(ls, lt, obs_p, lens)
    got, want = _both_tiles(monkeypatch, fwd)
    assert _equal(got, want) and _equal(got, fwd())
    alpha, dm = got
    r_alpha, r_dm = ck.forward_prob_plain(ls, lt, obs_p, lens, dtype=F64)
    torch.testing.assert_close(alpha, r_alpha.float(), rtol=0, atol=2e-6)
    torch.testing.assert_close(dm, r_dm.float(), rtol=0, atol=1e-5)
    assert bool((alpha[lens == 0] == 1).all()) \
        and bool((dm[lens == 0] == 0).all())
    got, want = _both_tiles(monkeypatch, bwd)
    assert _equal(got, want) and _equal(got, bwd())
    (beta,) = got
    torch.testing.assert_close(
        beta, ck.backward_prob_plain(lt, obs_p, lens, dtype=F64).float(),
        rtol=0, atol=2e-6)
    for b, n in enumerate(lens.tolist()):
        assert bool((beta[b, max(n - 1, 0):] == 1).all())


@pytest.mark.parametrize("S", [300, 1024])
def test_cluster_prob_scans_past_one_wave(device, rng, monkeypatch, S):
    """More rows than the card holds clusters of the most rows at once:
    K6a and K6b keep the staged tile's bits, and each row's bits are those
    of a launch of its own."""
    for kind in ("fwd_prob", "bwd_prob"):
        plan = ck.library_cluster_plan(S, 1, kind)
        B = 12 * plan["active"][-1] + 5
        wide = ck.library_cluster_plan(S, B, kind)
        assert wide["R"] == 12 and wide["clusters"] > wide["active"][-1]
    ls, lt, obs_p, _o_m, lens = _prob_inputs(rng, device, S, B, 7, 0.3)
    few = slice(B - 3, B)
    alone = _prob_calls(ls, lt, obs_p[few].contiguous(), lens[few])
    for fn, fn_alone in zip(_prob_calls(ls, lt, obs_p, lens), alone):
        got, want = _both_tiles(monkeypatch, fn)
        assert _equal(got, want)
        assert _equal(fn_alone(), (g[few] for g in got))


@pytest.mark.parametrize("S", [257, 1024])
def test_cluster_prob_scans_on_one_long_row(device, rng, monkeypatch, S):
    """One row a cluster over many positions, as ``"auto"`` runs K6 on a
    training region: the staged tile's bits, and within 2e-6 of plain in
    float64."""
    ls, lt, obs_p, _o_m, lens = _prob_inputs(rng, device, S, 1, 700, 0.0)
    assert lens.tolist() == [700]
    fwd, bwd = _prob_calls(ls, lt, obs_p, lens)
    got, want = _both_tiles(monkeypatch, fwd)
    assert _equal(got, want)
    r_alpha, _r_dm = ck.forward_prob_plain(ls, lt, obs_p, lens, dtype=F64)
    torch.testing.assert_close(got[0], r_alpha.float(), rtol=0, atol=2e-6)
    got, want = _both_tiles(monkeypatch, bwd)
    assert _equal(got, want)
    torch.testing.assert_close(
        got[0], ck.backward_prob_plain(lt, obs_p, lens, dtype=F64).float(),
        rtol=0, atol=2e-6)


@pytest.mark.parametrize("kernel", ["fwd_prob", "bwd_prob"])
@pytest.mark.parametrize("B", [1, 4, 64, 128, 4096])
@pytest.mark.parametrize("S", CLUSTER_STATES)
def test_prob_cluster_plans_are_the_libraries(device, S, B, kernel):
    """K6a's and K6b's plans (K6b with two max buffers): the Python plan,
    given the card's active clusters of that kernel at each R, is the
    plan its launch takes."""
    lib = ck.library_cluster_plan(S, B, kernel)
    active = dict(zip(ck._CLUSTER_ROWS, lib.pop("active")))
    assert ck.cluster_plan(S, B, kernel,
                           lambda R, smem: active[R]) == lib
    assert lib["smem"] <= 232448 and active[lib["R"]] >= 1


@pytest.mark.parametrize("entry,counter", [
    ("tehmm_fwd_prob", "fwd_prob_cluster"),
    ("tehmm_bwd_prob", "bwd_prob_cluster")])
def test_a_refused_prob_cluster_launch_raises(device, entry, counter):
    """K6a's and K6b's cluster entries at S <= 256 have no plan: the
    launch is refused and raises, nothing counted, nothing run in its
    place."""
    S, B, L = 200, 2, 3
    obs_p = torch.ones((B, L, S), device=device)
    lens = torch.full((B,), L, dtype=torch.int32, device=device)
    sp = torch.ones(S, device=device)
    tp = torch.ones((S, S), device=device)
    rows = torch.full((B, L, S), 7.0, device=device)
    dm = torch.full((B, L), 7.0, device=device)
    args = (obs_p.data_ptr(), lens.data_ptr(), sp.data_ptr(),
            tp.data_ptr(), rows.data_ptr(), dm.data_ptr()) \
        if entry == "tehmm_fwd_prob" \
        else (obs_p.data_ptr(), lens.data_ptr(), tp.data_ptr(),
              rows.data_ptr())
    before = dict(ck.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        ck._launch_streaming(counter, entry, (*args, B, L, S, 1), device)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before
    assert bool((rows == 7.0).all()) and bool((dm == 7.0).all())
