"""The port's forward/backward scans, E-step, M-step masks and EM loops
against the JAX package (and the NumPy oracle), on the same numpy-made
inputs, on the CPU.

Tolerances: the scans, posteriors and log-likelihoods agree with
``tehmm_tpu.ops.dp`` to 1e-5 (float32 in both, summed in different
orders); E-step statistics to the JAX package's own engine tolerances
(loglik 1e-5 relative, counts 1e-4 relative with 1e-5 to 1e-4 absolute,
tests/test_pallas.py); the float64 oracle to 1e-4; the M-step, whose
arithmetic is the same elementwise float32 in both, to 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tehmm_tpu import oracle  # noqa: E402
from tehmm_tpu.io.trackdata import TrackTable  # noqa: E402
from tehmm_tpu.models import hmm as jhmm  # noqa: E402
from tehmm_tpu.models import params as jparams  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.ops import em as jem  # noqa: E402
from tehmm_tpu.utils.common import LOG_ZERO  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.models import hmm as thmm  # noqa: E402
from tehmm_tpu_torch.models import params as tparams  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402
from tehmm_tpu_torch.ops import em as tem  # noqa: E402

CPU = torch.device("cpu")
LENGTHS = [23, 16, 1, 0]


def _tables(make_hmm, S, T, V, zero_frac=0.0):
    return [np.asarray(x, np.float32)
            for x in make_hmm(S, T, V, zero_trans_frac=zero_frac)]


def _jp(tables):
    return jparams.HmmParams(*(jnp.asarray(t) for t in tables))


def _tp(tables):
    return tparams.from_numpy(*tables, CPU)


def _np(p):
    return [np.asarray(x) for x in (p.log_start, p.log_trans, p.log_em)]


def _batch(rng, V, T, L=23, lengths=LENGTHS):
    sym = rng.randint(0, V, size=(len(lengths), L, T)).astype(np.int32)
    return sym, np.asarray(lengths, np.int32)


def _assert_stats(got, want):
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.start),
                               np.asarray(want.start), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.trans),
                               np.asarray(want.trans), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.em), np.asarray(want.em),
                               rtol=1e-4, atol=1e-4)
    assert float(got.n_obs) == float(want.n_obs)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("matmul", [True, False])
@pytest.mark.parametrize("S", [3, 10])
def test_scans_match_jax(rng, make_hmm, S, matmul, zero_frac):
    ls, lt, lem = _tables(make_hmm, S, 3, 5, zero_frac)
    sym, lens = _batch(rng, 5, 3)
    obs = oracle.obs_log_likelihoods(lem, sym.reshape(-1, 3)) \
        .reshape(len(lens), -1, S).astype(np.float32)
    j_ah, j_lc, j_ll = jdp.forward_scaled(
        jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(obs),
        jnp.asarray(lens), matmul=matmul)
    j_bh, j_ld = jdp.backward_scaled(jnp.asarray(lt), jnp.asarray(obs),
                                     jnp.asarray(lens), matmul=matmul)
    j_g = jdp.posterior_scaled(j_ah, j_bh)
    t = torch.from_numpy
    ah, lc, ll = tdp.forward_scaled(t(ls), t(lt), t(obs), t(lens),
                                    matmul=matmul)
    bh, ld = tdp.backward_scaled(t(lt), t(obs), t(lens), matmul=matmul)
    g = tdp.posterior_scaled(ah, bh)
    for got, want in ((ah, j_ah), (bh, j_bh), (g, j_g)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    for got, want in ((lc, j_lc), (ll, j_ll), (ld, j_ld)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert ll.numpy()[3] == 0.0                 # zero-length row


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", [3, 10])
def test_estep_matches_oracle(rng, make_hmm, S, zero_frac):
    """Posteriors, logliks and the plain E-step's statistics against the
    float64 NumPy oracle, row by row."""
    ls, lt, lem = _tables(make_hmm, S, 2, 4, zero_frac)
    sym, lens = _batch(rng, 4, 2, L=19, lengths=[19, 7, 1, 0])
    obs = tem.track_log_likelihoods(torch.from_numpy(lem),
                                    torch.from_numpy(sym))
    t = torch.from_numpy
    ah, _, ll = tdp.forward_scaled(t(ls), t(lt), obs, t(lens))
    bh, _ = tdp.backward_scaled(t(lt), obs, t(lens))
    gamma = tdp.posterior_scaled(ah, bh).numpy()
    want = [np.zeros(S), np.zeros((S, S)), np.zeros((S, 2, 4)), 0.0]
    l64 = [x.astype(np.float64) for x in (ls, lt, lem)]
    for b, n in enumerate(lens):
        if n == 0:
            continue
        o = oracle.obs_log_likelihoods(l64[2], sym[b, :n])
        alpha, ll_o = oracle.forward(l64[0], l64[1], o)
        beta = oracle.backward(l64[1], o)
        np.testing.assert_allclose(gamma[b, :n],
                                   oracle.posterior(alpha, beta, ll_o),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(ll[b]), ll_o, rtol=1e-4)
        counts = oracle.baum_welch_counts(l64[0], l64[1], o, sym[b, :n], 4)
        want = [w + c for w, c in zip(want, counts)]
    stats = tem.em_sufficient_stats(_tp((ls, lt, lem)), t(sym), t(lens),
                                    engine="plain")
    for got, w in zip((stats.start, stats.trans, stats.em, stats.loglik),
                      want):
        np.testing.assert_allclose(np.asarray(got, np.float64), w,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("matmul", [True, False])
@pytest.mark.parametrize("S", [3, 10])
def test_plain_estep_matches_jax_xla(rng, make_hmm, S, matmul, zero_frac):
    tables = _tables(make_hmm, S, 3, 6, zero_frac)
    sym, lens = _batch(rng, 6, 3, L=31, lengths=[31, 20, 1, 0, 2])
    want = jem.em_sufficient_stats(_jp(tables), jnp.asarray(sym),
                                   jnp.asarray(lens), matmul=matmul,
                                   engine="xla")
    got = tem.em_sufficient_stats(_tp(tables), torch.from_numpy(sym),
                                  torch.from_numpy(lens), matmul=matmul,
                                  engine="plain")
    _assert_stats(got, want)


@pytest.mark.parametrize("S", [3, 10])
def test_k1_engine_on_cpu_matches_plain_engine(rng, make_hmm, S):
    """engine="cuda" on CPU tensors runs K1's plain version (launching
    nothing) and agrees with the log-space engine."""
    ck.reset_launch_counts()
    tables = _tables(make_hmm, S, 3, 6, 0.3)
    sym, lens = _batch(rng, 6, 3, L=29, lengths=[29, 11, 1, 0])
    args = (_tp(tables), torch.from_numpy(sym), torch.from_numpy(lens))
    _assert_stats(tem.em_sufficient_stats(*args, engine="cuda"),
                  tem.em_sufficient_stats(*args, engine="plain"))
    _assert_stats(tem.em_sufficient_stats(*args),    # auto on CPU: plain
                  tem.em_sufficient_stats(*args, engine="plain"))
    assert all(n == 0 for n in ck.LAUNCHES.values())


def test_unported_engine_and_streams_raise(rng, make_hmm):
    """The JAX package's engine names are unknown here, and the error
    names the port's counterpart of "pallas_v3"; that engine, "cuda_v3"
    (K6), runs; segment weights run and match the JAX package's
    E-step."""
    tables = _tables(make_hmm, 3, 2, 4)
    sym, lens = _batch(rng, 4, 2)
    args = (_tp(tables), torch.from_numpy(sym), torch.from_numpy(lens))
    with pytest.raises(ValueError, match="cuda_v3"):
        tem.em_sufficient_stats(*args, engine="pallas_v3")
    _assert_stats(tem.em_sufficient_stats(*args, engine="cuda_v3"),
                  tem.em_sufficient_stats(*args, engine="plain"))
    w = rng.uniform(1.0, 9.0, size=(4, 23)).astype(np.float32)
    got = tem.em_sufficient_stats(*args, obs_weights=torch.from_numpy(w))
    want = jem.em_sufficient_stats(
        _jp(tables), jnp.asarray(sym), jnp.asarray(lens),
        obs_weights=jnp.asarray(w), engine="xla",
    )
    _assert_stats(got, want)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", [3, 10])
def test_cuda_v3_engine_on_cpu_matches_jax_pallas_v3(rng, make_hmm, S,
                                                     zero_frac):
    """engine="cuda_v3" on CPU tensors runs K6's plain versions
    (launching nothing) and agrees with the JAX package's
    engine="pallas_v3" (Pallas in interpret mode), ragged lengths with
    an empty row."""
    ck.reset_launch_counts()
    tables = _tables(make_hmm, S, 3, 6, zero_frac)
    sym, lens = _batch(rng, 6, 3, L=31, lengths=[31, 20, 1, 0, 2])
    want = jem.em_sufficient_stats(_jp(tables), jnp.asarray(sym),
                                   jnp.asarray(lens), engine="pallas_v3")
    got = tem.em_sufficient_stats(_tp(tables), torch.from_numpy(sym),
                                  torch.from_numpy(lens), engine="cuda_v3")
    _assert_stats(got, want)
    assert all(n == 0 for n in ck.LAUNCHES.values())


SIZES = [4, 3, 6, 1]                 # V = 6: tracks padded to it


def _m_step_inputs(rng, S=5):
    T, V = len(SIZES), max(SIZES)
    start = rng.rand(S).astype(np.float32) * 3
    trans = rng.rand(S, S).astype(np.float32) * 100
    em = rng.rand(S, T, V).astype(np.float32) * 40
    em[rng.rand(S, T, V) < 0.3] = 0.0
    old = jparams.init_random(S, SIZES, seed=9)
    fix_t = np.asarray([True, False, False, True, False])
    fix_e = np.asarray([False, True, False, False, True])
    force_t = np.full((S, S), -1.0, np.float32)
    force_t[0, 1], force_t[2, 2], force_t[4, :2] = 0.3, 0.9, [0.1, 0.2]
    force_e = np.full((S, T, V), -1.0, np.float32)
    force_e[1, 0, 1] = 0.5
    force_e[3, 2, 2:4] = [0.2, 0.3]
    force_e[0, 1, 4] = 0.7           # a pad symbol of track 1: ignored
    force_e[2, 3, 0] = 0.4           # the missing column: ignored
    return (start, trans, em), old, (fix_t, fix_e, force_t, force_e)


@pytest.mark.parametrize("which", [
    (), (0,), (1,), (2,), (3,), (0, 1, 2, 3),
])
def test_m_step_masks_match_jax(rng, which):
    """Each mask, and all four together (fix before force)."""
    counts, old, masks = _m_step_inputs(rng)
    picked = [m if i in which else None for i, m in enumerate(masks)]
    jstats = jem.EmStats(*(jnp.asarray(c) for c in counts),
                         loglik=jnp.zeros(()), n_obs=jnp.ones(()))
    jmasks = jem.ParamMasks(*(None if m is None else jnp.asarray(m)
                              for m in picked)) if which else None
    want = jem.em_m_step(jstats, old, jnp.asarray(SIZES), jmasks)
    tstats = tem.EmStats(*(torch.from_numpy(c) for c in counts),
                         loglik=torch.zeros(()), n_obs=torch.ones(()))
    tmasks = tem.ParamMasks(*(None if m is None else torch.from_numpy(m)
                              for m in picked)) if which else None
    got = tem.em_m_step(tstats, _tp(_np(old)), SIZES, tmasks)
    for g, w in zip(_np(got), _np(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_apply_force_em_over_a_grown_alphabet(rng):
    """An emission table padded with LOG_ZERO for a symbol a prior file
    added (as --initEmProbs does on resume), then forced."""
    sizes = [5, 3]
    old = np.asarray(jparams.init_random(3, [4, 3], seed=2).log_em)
    grown = np.pad(old, ((0, 0), (0, 0), (0, 1)),
                   constant_values=LOG_ZERO)
    grown = jparams.apply_emission_conventions(grown, sizes)
    force = np.full(grown.shape, -1.0, np.float32)
    force[0, 0, 4], force[1, 0, 1], force[2, 1, 2] = 0.25, 0.6, 0.5
    want = jem._apply_force_em(jnp.asarray(grown), jnp.asarray(force),
                               jnp.asarray(sizes))
    got = tem._apply_force_em(torch.from_numpy(grown),
                              torch.from_numpy(force), sizes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_em_run_matches_stepwise_and_jax(rng, make_hmm):
    S, T, V, L, n = 3, 1, 4, 100, 6
    tables = _tables(make_hmm, S, T, V)
    sym = rng.randint(1, V, size=(2, L, T)).astype(np.int32)
    p_dev, hist, n_it = tem.em_run(_tp(tables), torch.from_numpy(sym), [V],
                                   max_iterations=n, convergence_tol=0.0)
    p_host, lls = _tp(tables), []
    for _ in range(n):
        p_host, ll = tem.em_step(p_host, torch.from_numpy(sym), [V])
        lls.append(float(ll))
    assert n_it == n
    np.testing.assert_allclose(hist.numpy()[:n], lls, rtol=1e-5)
    np.testing.assert_allclose(p_dev.log_trans.numpy(),
                               p_host.log_trans.numpy(), rtol=1e-4,
                               atol=1e-5)
    j_p, j_hist, j_n = jem.em_run(_jp(tables), jnp.asarray(sym),
                                  jnp.asarray([V]), max_iterations=n,
                                  convergence_tol=0.0)
    assert int(j_n) == n_it
    np.testing.assert_allclose(hist.numpy(), np.asarray(j_hist), rtol=1e-5)
    for g, w in zip(_np(p_dev), _np(j_p)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_em_run_converges_early_like_jax(rng, make_hmm):
    S, T, V, L = 2, 1, 3, 60
    tables = _tables(make_hmm, S, T, V)
    sym = rng.randint(1, V, size=(1, L, T)).astype(np.int32)
    _p, hist, n = tem.em_run(_tp(tables), torch.from_numpy(sym), [V],
                             max_iterations=100, convergence_tol=1.0)
    _jp_, j_hist, j_n = jem.em_run(_jp(tables), jnp.asarray(sym),
                                   jnp.asarray([V]), max_iterations=100,
                                   convergence_tol=1.0)
    assert n == int(j_n) < 100
    assert np.isfinite(hist.numpy()[:n]).all()
    assert np.isnan(hist.numpy()[n:]).all()
    np.testing.assert_allclose(hist.numpy()[:n], np.asarray(j_hist)[:n],
                               rtol=1e-5)


def _models(pkg, seeds, S, T, V):
    """Models of either package over one symbol table (alphabet sizes
    given directly, no track list)."""
    from tests.conftest import random_hmm

    base = jhmm.MultitrackHmm if pkg == "jax" else thmm.MultitrackHmm

    class _Hmm(base):
        @property
        def alphabet_sizes(self):
            return [V] * T

    out = []
    for seed in seeds:
        tables = [np.asarray(x, np.float32) for x in
                  random_hmm(np.random.RandomState(seed), S, T, V)]
        p = _jp(tables) if pkg == "jax" else _tp(tables)
        out.append(_Hmm(p, None, None, [str(i) for i in range(S)]))
    return out


def _table(rng, L, T, V):
    sym = rng.randint(1, V, size=(L, T)).astype(np.uint8)
    return TrackTable(chrom="chr1", start=0, end=L, symbols=sym)


@pytest.mark.parametrize("mode", ["resident", "passes", "host",
                                  "device_loop"])
def test_fit_matches_jax(rng, make_hmm, monkeypatch, mode):
    """fit on the same chunked table in both packages: the same E/M
    sequence (lagged convergence), logliks, flag and parameters, however
    the batch is staged."""
    S, T, V = 3, 2, 5
    tab = _table(rng, 430, T, V)
    kw = dict(max_iterations=12, convergence_tol=0.55, chunk_len=100)
    if mode == "passes":                 # 2 rows per pass: 3 passes
        monkeypatch.setattr(jhmm, "_MAX_PASS_POSITIONS", 200)
        monkeypatch.setattr(thmm, "_MAX_PASS_POSITIONS", 200)
    elif mode == "host":                 # 1-row host blocks
        kw["max_device_bytes"] = 1
    elif mode == "device_loop":
        kw["device_loop"] = True
    (jm,) = _models("jax", [4], S, T, V)
    (tm,) = _models("torch", [4], S, T, V)
    want = jm.fit([tab], **kw)
    got = tm.fit([tab], **kw)
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    assert got.converged or mode == "device_loop"
    np.testing.assert_allclose(got.logliks, want.logliks, rtol=1e-5)
    for g, w in zip(_np(tm.params), _np(jm.params)):
        np.testing.assert_allclose(np.exp(g), np.exp(w), atol=1e-4)


def test_fit_restarts_matches_sequential_and_jax(rng):
    S, T, V, L = 3, 2, 5, 400
    tab = _table(rng, L, T, V)
    seq_lls = []
    for m in _models("torch", (0, 1), S, T, V):
        seq_lls.append(m.fit([tab], max_iterations=4,
                             convergence_tol=0.0).logliks)
    models = _models("torch", (0, 1), S, T, V)
    best, results = thmm.fit_restarts(models, [tab], max_iterations=4,
                                      convergence_tol=0.0)
    for r in range(2):
        np.testing.assert_allclose(results[r].logliks, seq_lls[r],
                                   rtol=1e-5, err_msg=f"rep {r}")
    finals = [res.logliks[-1] for res in results]
    assert best == int(np.argmax(finals))
    j_best, j_results = jhmm.fit_restarts(
        _models("jax", (0, 1), S, T, V), [tab], max_iterations=4,
        convergence_tol=0.0)
    assert j_best == best
    for got, want in zip(results, j_results):
        np.testing.assert_allclose(got.logliks, want.logliks, rtol=1e-5)
        assert got.iterations == want.iterations


@pytest.mark.parametrize("S,T,V,G,dev,fused", [
    (20, 5, 9, 0, "cuda", True), (10, 5, 9, 2, "cuda", True),
    (160, 5, 9, 0, "cuda", False), (128, 15, 16, 0, "cuda", False),
    (20, 5, 9, 0, "cpu", False)])
def test_pass_budget_follows_the_engine(S, T, V, G, dev, fused):
    """E-step passes take K1's budget only where ``"auto"`` takes K1
    (a CUDA-typed device, nothing run on it); past K1's envelope, and off
    the card, the [B, L, S] engines' smaller one, as the JAX package sizes
    them by engine."""
    params = tparams.from_numpy(np.zeros(S, np.float32),
                                np.zeros((S, S), np.float32),
                                np.zeros((S, T, V), np.float32), "cpu")
    gauss = (tgauss.from_numpy(np.zeros((S, G), np.float32),
                               np.zeros((S, G), np.float32), "cpu")
             if G else None)
    assert (tem.resolve_engine("auto", S, T, V, G, torch.device(dev))
            == "cuda") == fused
    assert thmm._pass_positions(params, gauss, torch.device(dev)) == (
        thmm._MAX_PASS_POSITIONS_FUSED if fused
        else thmm._MAX_PASS_POSITIONS)


@pytest.mark.parametrize("entry", ["fit", "fit_restarts"])
def test_fit_passes_take_the_pass_budget(rng, monkeypatch, entry):
    """``fit`` and ``fit_restarts`` cut their E-step passes by
    ``_pass_positions`` for the model they train (per restart for
    ``fit_restarts``): 200 positions of 100-position chunks are 2 rows
    a pass, so 5 chunks take passes of 2, 2 and 1 (padded) rows."""
    S, T, V = 3, 2, 5
    tab = _table(rng, 500, T, V)
    asked, rows = [], []

    def budget(params, gauss, device):
        asked.append((params.num_states, gauss, device.type))
        return 200 * (2 if entry == "fit_restarts" else 1)

    real = tem.em_sufficient_stats

    def spy(params, symbols, *a, **k):
        rows.append(symbols.shape[0])
        return real(params, symbols, *a, **k)

    monkeypatch.setattr(thmm, "_pass_positions", budget)
    monkeypatch.setattr(tem, "em_sufficient_stats", spy)
    kw = dict(max_iterations=1, convergence_tol=0.0, chunk_len=100)
    if entry == "fit":
        (m,) = _models("torch", [0], S, T, V)
        m.fit([tab], **kw)
    else:
        thmm.fit_restarts(_models("torch", [0, 1], S, T, V), [tab], **kw)
    assert asked == [(S, None, "cpu")]
    per_pass = 2 if entry == "fit_restarts" else 1
    assert rows == [r for r in (2, 2, 2) for _ in range(per_pass)]


@pytest.mark.parametrize("masked", [False, True])
def test_reps_entry_points_match_jax(rng, make_hmm, masked):
    """em_stats_reps / em_m_step_reps: R stacked parameter sets, the JAX
    signature, one E-step and M-step per restart."""
    S, T, V, R = 4, 2, 5, 3
    reps = [_tables(make_hmm, S, T, V, 0.2 * r) for r in range(R)]
    stacked = [np.stack(x) for x in zip(*reps)]
    sym, lens = _batch(rng, V, T, L=27, lengths=[27, 9, 1, 0])
    masks = None
    if masked:
        force_t = np.full((S, S), -1.0, np.float32)
        force_t[1, :2] = [0.4, 0.5]
        masks = (np.asarray([True, False, False, True]), None, force_t, None)
    j_stats = jem.em_stats_reps(_jp(stacked), jnp.asarray(sym),
                                jnp.asarray(lens))
    t_stats = tem.em_stats_reps(_tp(stacked), torch.from_numpy(sym),
                                torch.from_numpy(lens))
    for r in range(R):
        _assert_stats(tem.unstack_rep(t_stats, tem.EmStats, r),
                      jax.tree.map(lambda x: x[r], j_stats))
    j_masks = t_masks = None
    if masked:
        j_masks = jem.ParamMasks(*(None if m is None else jnp.asarray(m)
                                   for m in masks))
        t_masks = tem.ParamMasks(*(None if m is None else torch.from_numpy(m)
                                   for m in masks))
    want = jem.em_m_step_reps(j_stats, _jp(stacked), jnp.asarray([V] * T),
                              j_masks)
    got = tem.em_m_step_reps(t_stats, _tp(stacked), [V] * T, t_masks)
    for g, w in zip(_np(got), _np(want)):
        np.testing.assert_allclose(np.exp(g), np.exp(w), atol=1e-4)
