"""Gaussian tracks and segment weights in the port against the JAX
package, on the CPU.

- ``models/gauss.py`` against ``tehmm_tpu.models.gauss``: the same init
  draws (equal arrays), coefficients and log-densities within float32
  ulps (the port sums explicit products in track order, the JAX package
  calls three HIGHEST matmuls), moments and the M-step within 1e-5.
- K1, K2 and K4's plain versions with each stream combination against
  the JAX Pallas kernels in interpret mode (B = 4, L <= 64), as
  tests/test_pallas.py runs them: statistics at the engine tolerances
  (loglik 1e-5 relative, counts and moments 1e-4), Viterbi and
  max-posterior paths identical.
- ``fit`` (resident and host-streamed), ``fit_restarts`` and the device
  loop with gaussian tracks and segment weights: logliks within 1e-5
  relative, learned means within 1e-4.
- The CLIs on tests/test_gauss.py's fixture: a model written by the JAX
  CLI decodes in the port to the JAX CLI's BED byte for byte in every
  mode (printed scores 1e-5 relative, ``--pd`` 1e-5), and port train ->
  port eval gives the JAX train -> JAX eval BED."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu import io as jio  # noqa: E402
from tehmm_tpu.cli import eval as jax_eval  # noqa: E402
from tehmm_tpu.cli import train as jax_train  # noqa: E402
from tehmm_tpu.models import gauss as jgauss  # noqa: E402
from tehmm_tpu.models.hmm import MultitrackHmm as JHmm  # noqa: E402
from tehmm_tpu.models.hmm import fit_restarts as jfit_restarts  # noqa: E402
from tehmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from tehmm_tpu_torch import io as tio  # noqa: E402
from tehmm_tpu_torch.cli import eval as port_eval  # noqa: E402
from tehmm_tpu_torch.cli import train as port_train  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.models.hmm import MultitrackHmm as THmm  # noqa: E402
from tehmm_tpu_torch.models.hmm import fit_restarts as tfit_restarts  # noqa: E402,E501
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _values(rng, shape, nan_frac=0.1):
    v = (rng.randn(*shape) * 2.0 + 1.0).astype(np.float32)
    v[rng.rand(*shape) < nan_frac] = np.nan
    return v


def _gp(rng, S, G):
    mu = (rng.randn(S, G) * 2.0).astype(np.float32)
    lv = (rng.randn(S, G) * 0.5).astype(np.float32)
    return (jgauss.GaussParams(jnp.asarray(mu), jnp.asarray(lv)),
            tgauss.from_numpy(mu, lv, CPU))


# ---------------------------------------------------------------------
# models/gauss.py
# ---------------------------------------------------------------------

@pytest.mark.parametrize("spread", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_init_gauss_draws_as_jax(rng, seed, spread):
    vals = [_values(rng, (300, 3)), _values(rng, (57, 3))]
    vals[1][:, 2] = np.nan                 # a track with few values
    want = jgauss.init_gauss(5, vals, seed=seed, spread=spread)
    got = tgauss.init_gauss(5, vals, CPU, seed=seed, spread=spread)
    np.testing.assert_array_equal(got.mu.numpy(), np.asarray(want.mu))
    np.testing.assert_array_equal(got.log_var.numpy(),
                                  np.asarray(want.log_var))


@pytest.mark.parametrize("G", [1, 4])
def test_log_likelihoods_and_coeffs_match_jax(rng, G):
    jg, tg = _gp(rng, 6, G)
    v = _values(rng, (3, 40, G))
    for got, want in zip(tgauss._coeffs(tg), jgauss._coeffs(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tgauss.gauss_log_likelihoods(tg, _t(v)).numpy(),
        np.asarray(jgauss.gauss_log_likelihoods(jg, jnp.asarray(v))),
        rtol=1e-6, atol=1e-5)
    # missing everywhere: nothing contributes
    empty = np.full((2, 5, G), np.nan, np.float32)
    assert not tgauss.gauss_log_likelihoods(tg, _t(empty)).any()


def test_stats_and_m_step_match_jax(rng):
    S, G = 4, 3
    jg, tg = _gp(rng, S, G)
    v = _values(rng, (2, 50, G))
    gamma = rng.dirichlet(np.ones(S), size=(2, 50)).astype(np.float32)
    gamma[1, 30:] = 0.0
    got = tgauss.gauss_stats(_t(gamma), _t(v))
    want = jgauss.gauss_stats(jnp.asarray(gamma), jnp.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    got[0][2] = 0.0                       # a state with no mass keeps its
    want = (jnp.asarray(got[0].numpy()),) + tuple(want[1:])    # params
    fix = np.array([False, True, False, False])
    for fs in (None, fix):
        g = tgauss.gauss_m_step(*got, tg, fix_states=None if fs is None
                                else torch.from_numpy(fs))
        w = jgauss.gauss_m_step(*want, jg, fix_states=None if fs is None
                                else jnp.asarray(fs))
        np.testing.assert_allclose(g.mu.numpy(), np.asarray(w.mu),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.log_var.numpy(), np.asarray(w.log_var),
                                   rtol=1e-5, atol=1e-5)


def test_supervised_gauss_matches_jax(rng):
    vals = [_values(rng, (200, 2)), _values(rng, (80, 2))]
    states = [rng.randint(-1, 3, 200), rng.randint(-1, 3, 80)]
    states[1][:] = np.where(states[1] == 2, 0, states[1])
    want = jgauss.supervised_gauss(4, vals, states)   # state 3: unseen
    got = tgauss.supervised_gauss(4, vals, states, CPU)
    np.testing.assert_array_equal(got.mu.numpy(), np.asarray(want.mu))
    np.testing.assert_array_equal(got.log_var.numpy(),
                                  np.asarray(want.log_var))


# ---------------------------------------------------------------------
# K1, K2, K4 plain versions with the streams vs the Pallas kernels
# ---------------------------------------------------------------------

LENGTHS = np.array([53, 40, 1, 0], np.int32)


def _kernel_case(rng, make_hmm, variant, S=6, T=3, V=5, L=53, G=2):
    ls, lt, lem = (np.asarray(x, np.float32) for x in make_hmm(S, T, V))
    sym = rng.randint(0, V, size=(4, L, T)).astype(np.int32)
    w = rng.uniform(1.0, 30.0, (4, L)).astype(np.float32) \
        if "w" in variant else None
    v = _values(rng, (4, L, G)) if "g" in variant else None
    jg, tg = _gp(rng, S, G) if "g" in variant else (None, None)
    j_args = [jnp.asarray(x) for x in (ls, lt, lem, sym, LENGTHS)] + [
        None if w is None else jnp.asarray(w), jg,
        None if v is None else jnp.asarray(v)]
    t_args = [_t(x) for x in (ls, lt, lem, sym, LENGTHS)] + [
        None if w is None else _t(w), tg, None if v is None else _t(v)]
    return j_args, t_args


@pytest.fixture
def no_launches():
    ck.reset_launch_counts()
    yield
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


@pytest.mark.parametrize("variant", ["w", "g", "wg"])
def test_k1_plain_streams_match_pallas(rng, make_hmm, variant, no_launches):
    j_args, t_args = _kernel_case(rng, make_hmm, variant)
    want = pk.em_counts_fused_pallas_v4(*j_args)
    got = ck.em_counts_fused(*t_args)
    assert len(got) == len(want) == (5 if "g" in variant else 4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=1e-4)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    if "g" in variant:
        # gx sums weighted values of both signs: its rounding error scales
        # with the largest moment, not with the (possibly cancelled) entry
        for g, w in zip(got[4], want[4]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("variant", ["w", "g", "wg"])
def test_k2_plain_streams_match_pallas(rng, make_hmm, variant, no_launches):
    j_args, t_args = _kernel_case(rng, make_hmm, variant)
    want_p, want_s = pk.viterbi_fused_pallas_v4(*j_args)
    got_p, got_s = ck.viterbi_fused(*t_args)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("variant", ["w", "g", "wg"])
def test_k4_plain_streams_match_pallas(rng, make_hmm, variant, no_launches):
    j_args, t_args = _kernel_case(rng, make_hmm, variant)
    want = pk.posterior_decode_fused_pallas_v4(*j_args)
    got = ck.posterior_decode_fused(*t_args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------
# fit, fit_restarts and the device loop
# ---------------------------------------------------------------------

def _genome(tmp_path, L=2000, seed=5, second_gauss=False):
    """tests/test_gauss.py's fixture: 2 states separated only by a
    numeric score track (distribution="gaussian", valCol=4); optionally
    a categorical track and a second, sparser gaussian track."""
    rng = np.random.RandomState(seed)
    truth = np.zeros(L, int)
    for s in range(200, L - 200, 500):
        truth[s : s + 200] = 1
    rows = []
    for i in range(0, L, 10):
        v = rng.normal(4.0 if truth[i] else 0.0, 1.0)
        rows.append(("chr1", i, min(i + 10, L), "x", f"{v:.4f}"))
    bed = tmp_path / "g.bed"
    bed.write_text("".join("\t".join(map(str, r)) + "\n" for r in rows))
    tracks = f'<track name="g" path="{bed}" distribution="gaussian" ' \
        'valCol="4"/>'
    if second_gauss:
        rows, cat = [], []
        for i in range(0, L, 40):
            if rng.rand() < 0.7:
                v = rng.normal(-2.0 if truth[i] else 1.0, 0.7)
                rows.append(("chr1", i, min(i + 40, L), "y", f"{v:.4f}"))
            cat.append(("chr1", i, min(i + 40, L),
                        "AB"[int(rng.rand() < (0.8 if truth[i] else 0.3))]))
        (tmp_path / "h.bed").write_text(
            "".join("\t".join(map(str, r)) + "\n" for r in rows))
        jio.write_bed_intervals(cat, str(tmp_path / "c.bed"))
        tracks += (f'<track name="c" path="{tmp_path / "c.bed"}"/>'
                   f'<track name="h" path="{tmp_path / "h.bed"}" '
                   'distribution="gaussian" valCol="4"/>')
    xml = tmp_path / "t.xml"
    xml.write_text(f"<teModelConfig>{tracks}</teModelConfig>")
    truth_rows, start = [], 0
    for i in range(1, L + 1):
        if i == L or truth[i] != truth[i - 1]:
            truth_rows.append(("chr1", start, i,
                               "TE" if truth[start] else "BG"))
            start = i
    jio.write_bed_intervals(truth_rows, str(tmp_path / "truth.bed"))
    jio.write_bed_intervals([("chr1", 0, L)], str(tmp_path / "r.bed"))
    return dict(dir=tmp_path, xml=str(xml), truth_bed=str(
        tmp_path / "truth.bed"), regions=str(tmp_path / "r.bed"), L=L)


@pytest.fixture
def genome2(tmp_path):
    return _genome(tmp_path, second_gauss=True)


def _pair_models(f, S=3, seed=3, regions=None):
    regions = regions or [("chr1", 0, f["L"])]
    jtd = jio.load_track_data(jio.TrackList(f["xml"]), regions)
    ttd = tio.load_track_data(tio.TrackList(f["xml"]), regions)
    jm = JHmm.initialized(S, jtd, init="random", seed=seed)
    jm.gauss = jgauss.init_gauss(S, [t.values for t in jtd.tables],
                                 seed=seed)
    tm = THmm.initialized(S, ttd, CPU, init="random", seed=seed)
    tm.gauss = tgauss.init_gauss(S, [t.values for t in ttd.tables], CPU,
                                 seed=seed)
    return jm, jtd, tm, ttd


def _assert_fit_alike(tres, jres, tm, jm):
    assert tres.iterations == jres.iterations
    np.testing.assert_allclose(tres.logliks, jres.logliks, rtol=1e-5)
    np.testing.assert_allclose(tm.gauss.mu.numpy(), np.asarray(jm.gauss.mu),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["resident", "host_streamed", "weighted",
                                  "device_loop"])
def test_fit_with_gauss_matches_jax(genome2, mode):
    jm, jtd, tm, ttd = _pair_models(genome2)
    kw = dict(max_iterations=6, convergence_tol=0.0, chunk_len=300)
    tkw = dict(kw)
    if mode == "weighted":
        w = [np.random.RandomState(1).uniform(1, 4, len(t))
             .astype(np.float32) for t in jtd.tables]
        kw["obs_weight_arrays"] = tkw["obs_weight_arrays"] = w
    if mode == "host_streamed":
        tkw["max_device_bytes"] = 4000      # a few rows per pass block
    if mode == "device_loop":
        kw["device_loop"] = tkw["device_loop"] = True
    jres = jm.fit(jtd.tables, **kw)
    tres = tm.fit(ttd.tables, **tkw)
    _assert_fit_alike(tres, jres, tm, jm)


def test_fit_restarts_with_gauss_match_jax(genome2):
    pairs = [_pair_models(genome2, seed=s) for s in (3, 4)]
    w = [np.full(genome2["L"], 2.0, np.float32)]
    kw = dict(max_iterations=5, convergence_tol=0.0, chunk_len=500,
              obs_weight_arrays=w)
    jbest, jres = jfit_restarts([p[0] for p in pairs], pairs[0][1].tables,
                                **kw)
    tbest, tres = tfit_restarts([p[2] for p in pairs], pairs[0][3].tables,
                                **kw)
    assert tbest == jbest
    for t, j, (jm, _, tm, _) in zip(tres, jres, pairs):
        _assert_fit_alike(t, j, tm, jm)


def test_save_load_round_trips_gauss(genome2, tmp_path):
    _, _, tm, _ = _pair_models(genome2)
    tm.save(str(tmp_path / "m.npz"))
    jm = JHmm.load(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(np.asarray(jm.gauss.mu), tm.gauss.mu)
    back = THmm.load(str(tmp_path / "m.npz"), CPU)
    np.testing.assert_array_equal(back.gauss.log_var, tm.gauss.log_var)


def test_path_log_score_matches_jax(genome2):
    jm, jtd, tm, ttd = _pair_models(genome2)
    from tehmm_tpu.models.hmm import path_log_score as jscore
    from tehmm_tpu_torch.models.hmm import path_log_score as tscore

    tab = ttd.tables[0]
    path = np.random.RandomState(2).randint(0, 3, len(tab))
    w = np.random.RandomState(3).uniform(1, 9, len(tab)).astype(np.float32)
    for ww in (None, w):
        got = tscore(tm.params, tab.symbols, path, gauss=tm.gauss,
                     values=tab.values, obs_weights=ww)
        want = jscore(jm.params, tab.symbols, path, gauss=jm.gauss,
                      values=tab.values, obs_weights=ww)
        np.testing.assert_allclose(got, want, rtol=1e-12)


# ---------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------

@pytest.fixture
def genome(tmp_path):
    return _genome(tmp_path)


def _eval(cli, f, model, name, flags, capsys, device=True):
    out = str(f["dir"] / name)
    argv = [f["xml"], model, f["regions"], "--bed", out, *flags]
    if device:
        argv += ["--device", "cpu"]
    capsys.readouterr()
    assert cli.main(argv) == 0
    score = float(capsys.readouterr().out.strip())
    return open(out).read(), score


EVAL_MODES = {
    "viterbi_stitched": ["--no-exact", "--chunk", "300", "--halo", "32"],
    "viterbi_exact": ["--exact", "--chunk", "300"],
    "maxpost_stitched": ["--maxPost", "--no-exact", "--chunk", "300",
                         "--halo", "32"],
    "maxpost_exact": ["--maxPost", "--exact", "--chunk", "300"],
}


@pytest.mark.parametrize("mode", sorted(EVAL_MODES))
def test_jax_written_gauss_model_decodes_alike(genome, capsys, mode):
    f = genome
    model = str(f["dir"] / "sup.npz")
    assert jax_train.main([f["xml"], f["truth_bed"], model,
                           "--supervised"]) == 0
    flags = EVAL_MODES[mode]
    want, want_score = _eval(jax_eval, f, model, "j.bed", flags, capsys,
                             device=False)
    got, got_score = _eval(port_eval, f, model, "p.bed", flags, capsys)
    assert got == want
    np.testing.assert_allclose(got_score, want_score, rtol=1e-5)


def test_pd_with_gauss_matches_jax(genome, capsys):
    f = genome
    model = str(f["dir"] / "sup.npz")
    assert jax_train.main([f["xml"], f["truth_bed"], model,
                           "--supervised"]) == 0
    outs = []
    for cli, extra in ((jax_eval, []), (port_eval, ["--device", "cpu"])):
        pd = str(f["dir"] / f"pd{len(outs)}.bed")
        capsys.readouterr()
        assert cli.main([f["xml"], model, f["regions"], "--pd", pd,
                         "--chunk", "256", *extra]) == 0
        outs.append((float(capsys.readouterr().out.strip()),
                     [line.split("\t") for line in open(pd)]))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    assert len(outs[1][1]) == len(outs[0][1]) == f["L"]
    for a, b in zip(outs[1][1], outs[0][1]):
        assert a[:3] == b[:3]
        np.testing.assert_allclose(np.array(a[3].split(","), float),
                                   np.array(b[3].split(","), float),
                                   atol=1e-5)


def _train_em(cli, f, name, flags, device=True):
    model = str(f["dir"] / f"{name}.npz")
    log = f["dir"] / f"{name}.jsonl"
    argv = [f["xml"], f["regions"], model, "--logJson", str(log), *flags]
    if device:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    rows = [json.loads(line) for line in open(log)]
    key = "logliks" if "logliks" in rows[0] else "loglik"   # --reps
    return model, [r[key] for r in rows]


def test_cli_train_eval_with_gauss_matches_jax(genome, capsys):
    """port train -> port eval against JAX train -> JAX eval on the
    gaussian fixture: the same logliks, means and BED."""
    f = genome
    flags = ["--numStates", "2", "--iter", "20", "--seed", "1"]
    jmodel, jll = _train_em(jax_train, f, "j", flags, device=False)
    tmodel, tll = _train_em(port_train, f, "t", flags)
    np.testing.assert_allclose(tll, jll, rtol=1e-5)
    jm, tm = JHmm.load(jmodel), THmm.load(tmodel, CPU)
    np.testing.assert_allclose(tm.gauss.mu.numpy(), np.asarray(jm.gauss.mu),
                               rtol=1e-4, atol=1e-4)
    flags = ["--chunk", "512", "--halo", "64"]
    want, _ = _eval(jax_eval, f, jmodel, "j.bed", flags, capsys,
                    device=False)
    got, _ = _eval(port_eval, f, tmodel, "t.bed", flags, capsys)
    assert got == want


@pytest.mark.parametrize("flags", [["--reps", "2"], ["--deviceLoop"]])
def test_cli_em_modes_with_gauss_match_jax(genome, flags):
    f = genome
    base = ["--numStates", "2", "--iter", "8", "--seed", "2", *flags]
    _jm, jll = _train_em(jax_train, f, "j", base, device=False)
    _tm, tll = _train_em(port_train, f, "t", base)
    np.testing.assert_allclose(tll, jll, rtol=1e-5)
