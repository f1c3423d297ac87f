"""The engine-comparison path of the port on the CPU: the streaming
scans' plain versions (K5, K6a, K6b) against the Pallas kernels they
replace (run in interpret mode, as tests/test_pallas.py runs them), the
E-step engine "cuda_v3" against the JAX package's "pallas_v3" and the
port's "plain", ``dp.viterbi_streaming`` against every Viterbi of the JAX
package, and the two tools and ``marginal_time``.

Tolerances are the JAX tests' own (tests/test_pallas.py): alpha_p and
beta_p 2e-6 absolute (values in [0, 1]), normalizers 1e-5 absolute,
reassembled logliks and scores 1e-5 relative, Viterbi value rows 1e-6
(adds and maxes only: the difference is the obs tensor's, none here),
E-step statistics as ``tests/test_torch_em.py`` states them."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu import oracle  # noqa: E402
from tehmm_tpu.models import gauss as jgauss  # noqa: E402
from tehmm_tpu.models import params as jparams  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.ops import em as jem  # noqa: E402
from tehmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.models import params as tparams  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402
from tehmm_tpu_torch.ops import em as tem  # noqa: E402
from tehmm_tpu_torch.tools import (  # noqa: E402
    bench_engines, profile_estep, time_scans)
from tehmm_tpu_torch.utils.profiling import marginal_time  # noqa: E402

CPU = torch.device("cpu")
TINY = (4, 2, 4, 3, 16)              # S, T, V, B, L of the tools' test


@pytest.fixture(autouse=True)
def _zero_counts():
    ck.reset_launch_counts()
    yield
    # nothing on the CPU may launch (or build) a kernel
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES
    assert ck._lib is None


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_stats(got, want):
    """The E-step tolerances of tests/test_torch_em.py."""
    np.testing.assert_allclose(float(got.loglik), float(want.loglik),
                               rtol=1e-5)
    for name, atol in (("start", 1e-5), ("trans", 1e-5), ("em", 1e-4)):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=atol, err_msg=name)
    assert float(got.n_obs) == float(want.n_obs)


def _obs_case(rng, make_hmm, S, L, lengths, T=2, V=4, zero_frac=0.0,
              blank_rows=(), ties=False):
    """(log_start, log_trans, obs f32[B, L, S], int32 lengths) as
    tests/test_pallas.py makes them; ``blank_rows`` get an all-zero obs
    (its zero-length row); ``ties``: uniform transitions and a constant
    obs, so that past position 0 every argmax is a tie of all S states."""
    ls, lt, lem = make_hmm(S, T, V, zero_trans_frac=zero_frac)
    obs = np.stack([
        oracle.obs_log_likelihoods(lem, rng.randint(1, V, size=(L, T)))
        for _ in lengths
    ]).astype(np.float32)
    for b in blank_rows:
        obs[b] = 0.0
    if ties:
        lt = np.full((S, S), -np.log(S))
        obs[:] = -1.5
    return (np.asarray(ls, np.float32), np.asarray(lt, np.float32), obs,
            np.asarray(lengths, np.int32))


# the shapes of tests/test_pallas.py:118-184
PROB_CASES = {
    "ragged": dict(S=5, L=37, lengths=[37, 20, 7]),
    "multigroup": dict(S=9, L=12, lengths=[12, 1, 7, 12, 3]),
    "zero_trans_and_empty_row": dict(S=5, L=40, lengths=[40, 0],
                                     zero_frac=0.3, blank_rows=(1,)),
    # the edges of K6's lanes step (to 32 states) and rows kernels (from
    # 33), ragged with rows of length 0 and 1
    "lanes_edge": dict(S=32, L=11, lengths=[11, 0, 1, 6], zero_frac=0.3),
    "rows_edge": dict(S=33, L=11, lengths=[1, 11, 0, 7], zero_frac=0.3),
}


@pytest.mark.parametrize("case", sorted(PROB_CASES))
def test_forward_prob_plain_matches_pallas_v3(rng, make_hmm, case):
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **PROB_CASES[case])
    obs_p, o_m = tdp.scaled_obs_prob(_t(obs))
    want_a, want_dm = pk.forward_prob_pallas_v3(
        jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(obs_p.numpy()),
        jnp.asarray(lens))
    alpha, dm = ck.forward_prob(_t(ls), _t(lt), obs_p, _t(lens))
    plain = ck.forward_prob_plain(_t(ls), _t(lt), obs_p, _t(lens))
    assert torch.equal(alpha, plain[0]) and torch.equal(dm, plain[1])
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_a), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(dm.numpy(), np.asarray(want_dm), rtol=0,
                               atol=1e-5)
    # the reassembled loglik against the log-space scan
    _, _, ll_ref = jdp.forward_scaled(jnp.asarray(ls), jnp.asarray(lt),
                                      jnp.asarray(obs), jnp.asarray(lens))
    valid = np.arange(obs.shape[1])[None, :] < lens[:, None]
    ll = (np.log(alpha.numpy()[:, -1].sum(-1)) + dm.numpy().sum(1)
          + (o_m.numpy() * valid).sum(1))
    ll = np.where(lens > 0, ll, 0.0)
    np.testing.assert_allclose(ll, np.asarray(ll_ref), rtol=1e-5)
    for b in np.flatnonzero(lens == 0):          # exactly ones and zeros
        np.testing.assert_array_equal(alpha.numpy()[b], 1.0)
        np.testing.assert_array_equal(dm.numpy()[b], 0.0)


@pytest.mark.parametrize("case", sorted(PROB_CASES))
def test_backward_prob_plain_matches_pallas_v3(rng, make_hmm, case):
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **PROB_CASES[case])
    obs_p, _ = tdp.scaled_obs_prob(_t(obs))
    want = pk.backward_prob_pallas_v3(
        jnp.asarray(lt), jnp.asarray(obs_p.numpy()), jnp.asarray(lens))
    beta = ck.backward_prob(_t(lt), obs_p, _t(lens))
    assert torch.equal(beta, ck.backward_prob_plain(_t(lt), obs_p,
                                                    _t(lens)))
    np.testing.assert_allclose(beta.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
    bh_ref, _ = jdp.backward_scaled(jnp.asarray(lt), jnp.asarray(obs),
                                    jnp.asarray(lens))
    np.testing.assert_allclose(beta.numpy(), np.exp(np.asarray(bh_ref)),
                               rtol=0, atol=2e-6)
    for b, n in enumerate(lens):                 # ones from the end on
        np.testing.assert_array_equal(beta.numpy()[b, max(n - 1, 0):], 1.0)


@pytest.mark.parametrize("case", sorted(PROB_CASES))
def test_prob_plain_versions_in_float64(rng, make_hmm, case):
    """Carried in float64 the plain versions return float64, stay within
    float32 rounding of the float32 scans, and keep the exact carries."""
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **PROB_CASES[case])
    obs_p, _ = tdp.scaled_obs_prob(_t(obs))
    args = (_t(ls), _t(lt), obs_p, _t(lens))
    alpha, dm = ck.forward_prob_plain(*args)
    alpha64, dm64 = ck.forward_prob_plain(*args, dtype=torch.float64)
    beta = ck.backward_prob_plain(*args[1:])
    beta64 = ck.backward_prob_plain(*args[1:], dtype=torch.float64)
    assert {t.dtype for t in (alpha64, dm64, beta64)} == {torch.float64}
    for got, want, atol in ((alpha, alpha64, 1e-6), (dm, dm64, 1e-5),
                            (beta, beta64, 1e-6)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=atol)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(beta64.numpy()[b, max(n - 1, 0):], 1.0)
        if n == 0:
            np.testing.assert_array_equal(alpha64.numpy()[b], 1.0)
            np.testing.assert_array_equal(dm64.numpy()[b], 0.0)


VITERBI_CASES = {
    "ragged": dict(S=6, L=41, lengths=[41, 17, 1, 0], V=5),
    "past_64_states": dict(S=72, L=9, lengths=[9, 9], T=1),
    "zero_trans": dict(S=5, L=40, lengths=[40, 13], zero_frac=0.3),
    # past 256 states: the cluster tile's S on the card
    "S260": dict(S=260, L=6, lengths=[6, 3, 1, 0], T=1),
    # every argmax a tie: the lowest state wins in each Viterbi
    "ties": dict(S=70, L=9, lengths=[9, 4, 1], T=1, ties=True),
    # the edges of K5's and K8c's lanes step (to 32 states) and rows
    # kernels (from 33), ragged with rows of length 0 and 1
    "S32": dict(S=32, L=11, lengths=[11, 0, 1, 6], zero_frac=0.3),
    "S33": dict(S=33, L=11, lengths=[1, 11, 0, 7], zero_frac=0.3),
}


@pytest.mark.parametrize("case", sorted(VITERBI_CASES))
def test_viterbi_values_plain_matches_pallas_v3(rng, make_hmm, case):
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **VITERBI_CASES[case])
    init = jnp.broadcast_to(jnp.asarray(ls)[None], (len(lens), len(ls)))
    want_v, want_dm = pk._viterbi_values_v3(
        init, jnp.asarray(lt), jnp.asarray(obs), jnp.asarray(lens),
        carry_mode=False)
    v, dm = ck.viterbi_values(_t(ls), _t(lt), _t(obs), _t(lens))
    plain = ck.viterbi_values_plain(_t(ls), _t(lt), _t(obs), _t(lens))
    assert torch.equal(v, plain[0]) and torch.equal(dm, plain[1])
    np.testing.assert_allclose(v.numpy(),
                               np.moveaxis(np.asarray(want_v), 0, 1),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dm.numpy(), np.asarray(want_dm).T,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(VITERBI_CASES))
def test_viterbi_values_plain_matches_pallas_v2(rng, make_hmm, case,
                                                monkeypatch):
    """K7c's value rows and normalizers (``viterbi_pallas_v2``'s kernel,
    whose function K5's kernel computes) against ``viterbi_values``' plain
    version on valid positions.  The JAX function returns only the path
    and the score, so its kernel's outputs are read off its pallas_call
    by a host callback (in a fresh trace of the function)."""
    import jax

    ls, lt, obs, lens = _obs_case(rng, make_hmm, **VITERBI_CASES[case])
    seen = {}
    real = pk.pl.pallas_call

    def spy(kernel, **kw):
        call = real(kernel, **kw)

        def run(*args):
            out = call(*args)
            if kernel is pk._viterbi_kernel_v2:
                jax.debug.callback(
                    lambda *o: seen.update(out=[np.asarray(x) for x in o]),
                    *out)
            return out
        return run

    monkeypatch.setattr(pk.pl, "pallas_call", spy)
    path, _ = jax.jit(pk.viterbi_pallas_v2.__wrapped__)(
        jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(obs),
        jnp.asarray(lens))
    jax.block_until_ready(path)
    v_pad, dm_pad = seen["out"]
    B, L, S = obs.shape
    # [NB, K, Sp, Bp] and [NB, K, 8, Bp] -> [B, L, S] and [B, L]
    want_v = v_pad.reshape(-1, v_pad.shape[2], v_pad.shape[3])[:L, :S, :B]
    want_v = np.transpose(want_v, (2, 0, 1))
    want_dm = dm_pad.reshape(-1, 8, dm_pad.shape[3])[:L, 0, :B].T
    v, dm = ck.viterbi_values(_t(ls), _t(lt), _t(obs), _t(lens))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(v.numpy()[b, :n], want_v[b, :n],
                                   rtol=1e-6, atol=1e-6, err_msg=f"row {b}")
        np.testing.assert_allclose(dm.numpy()[b, :n], want_dm[b, :n],
                                   rtol=1e-6, atol=1e-6, err_msg=f"row {b}")


@pytest.mark.parametrize("jax_viterbi", ["viterbi_pallas_v3",
                                         "viterbi_pallas_v2",
                                         "viterbi_pallas", "dp.viterbi"])
@pytest.mark.parametrize("case", sorted(VITERBI_CASES))
def test_viterbi_streaming_paths(rng, make_hmm, case, jax_viterbi):
    """``dp.viterbi_streaming`` gives the paths of every Viterbi of the
    JAX package on valid positions (K5's kernel computes what K7c and
    K8c compute), and its score."""
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **VITERBI_CASES[case])
    fn = jdp.viterbi if jax_viterbi == "dp.viterbi" \
        else getattr(pk, jax_viterbi)
    want_p, want_s = fn(jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(obs),
                        jnp.asarray(lens))
    path, score = tdp.viterbi_streaming(_t(ls), _t(lt), _t(obs), _t(lens))
    assert path.dtype == torch.int32
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(path.numpy()[b, :n],
                                      np.asarray(want_p)[b, :n],
                                      err_msg=f"row {b}")
    nonempty = lens > 0
    np.testing.assert_allclose(score.numpy()[nonempty],
                               np.asarray(want_s)[nonempty], rtol=1e-5,
                               atol=1e-4)
    # the port's own Viterbi, padding included
    own_p, own_s = tdp.viterbi(_t(ls), _t(lt), _t(obs), _t(lens))
    assert torch.equal(path, own_p)
    np.testing.assert_allclose(score.numpy(), own_s.numpy(), rtol=1e-5,
                               atol=1e-4)
    assert score.numpy()[~nonempty].tolist() == [0.0] * int((~nonempty).sum())


def test_viterbi_streaming_single_position(rng, make_hmm):
    ls, lt, obs, lens = _obs_case(rng, make_hmm, S=4, L=1, lengths=[1, 0])
    path, score = tdp.viterbi_streaming(_t(ls), _t(lt), _t(obs), _t(lens))
    own_p, own_s = tdp.viterbi(_t(ls), _t(lt), _t(obs), _t(lens))
    assert torch.equal(path, own_p)
    np.testing.assert_allclose(score.numpy(), own_s.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------
# the E-step engine
# ---------------------------------------------------------------------

def _estep_case(rng, make_hmm, variant, S=5, T=3, V=6, L=29):
    tables = [np.asarray(x, np.float32)
              for x in make_hmm(S, T, V, zero_trans_frac=0.3)]
    lengths = [L, 11, 1, 0] if variant == "ragged" else [L, L - 4, L]
    sym = rng.randint(0, V, size=(len(lengths), L, T)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    jkw, tkw = {}, {}
    if variant == "weights":
        w = rng.uniform(1.0, 9.0, size=sym.shape[:2]).astype(np.float32)
        jkw["obs_weights"], tkw["obs_weights"] = jnp.asarray(w), _t(w)
    if variant == "gauss":
        G = 2
        vals = (rng.randn(len(lengths), L, G) * 2.0).astype(np.float32)
        vals[rng.rand(*vals.shape) < 0.1] = np.nan
        mu = rng.randn(S, G).astype(np.float32)
        log_var = (rng.randn(S, G) * 0.3).astype(np.float32)
        jkw.update(gauss_params=jgauss.GaussParams(jnp.asarray(mu),
                                                   jnp.asarray(log_var)),
                   gauss_values=jnp.asarray(vals))
        tkw.update(gauss_params=tgauss.from_numpy(mu, log_var, CPU),
                   gauss_values=_t(vals))
    jargs = (jparams.HmmParams(*(jnp.asarray(t) for t in tables)),
             jnp.asarray(sym), jnp.asarray(lens))
    targs = (tparams.from_numpy(*tables, CPU), _t(sym), _t(lens))
    return jargs, jkw, targs, tkw


@pytest.mark.parametrize("variant", ["plain", "weights", "gauss", "ragged"])
def test_cuda_v3_engine_matches_pallas_v3_and_plain(rng, make_hmm,
                                                    variant):
    jargs, jkw, targs, tkw = _estep_case(rng, make_hmm, variant)
    got = tem.em_sufficient_stats(*targs, engine="cuda_v3", **tkw)
    _assert_stats(got, jem.em_sufficient_stats(*jargs, engine="pallas_v3",
                                               **jkw))
    plain = tem.em_sufficient_stats(*targs, engine="plain", **tkw)
    _assert_stats(got, plain)
    if variant == "gauss":
        for name in ("gauss_n", "gauss_x", "gauss_x2"):
            want = getattr(plain, name).numpy()
            np.testing.assert_allclose(
                getattr(got, name).numpy(), want, rtol=1e-4,
                atol=1e-4 * float(np.abs(want).max()))
    else:
        assert got.gauss_n is None


def test_unknown_engines_raise_naming_cuda_v3(rng, make_hmm):
    _, _, targs, _ = _estep_case(rng, make_hmm, "plain")
    for engine in ("pallas_v3", "pallas", "xla"):
        with pytest.raises(ValueError, match="cuda_v3"):
            tem.em_sufficient_stats(*targs, engine=engine)


def test_streaming_wrappers_check_their_arguments(rng, make_hmm):
    ls, lt, obs, lens = _obs_case(rng, make_hmm, S=5, L=8, lengths=[8, 3])
    ls, lt, obs, lens = _t(ls), _t(lt), _t(obs), _t(lens)
    with pytest.raises(TypeError, match="lengths"):
        ck.forward_prob(ls, lt, obs, lens.to(torch.int64))
    with pytest.raises(TypeError, match="obs_p"):
        ck.backward_prob(lt, obs.to(torch.float64), lens)
    with pytest.raises(ValueError, match="log_trans"):
        ck.viterbi_values(ls, lt[:-1], obs, lens)
    with pytest.raises(ValueError, match="log_start"):
        ck.forward_prob(ls[:-1], lt, obs, lens)
    with pytest.raises(ValueError, match="contiguous"):
        ck.viterbi_values(ls, lt, obs.transpose(0, 1).contiguous()
                          .transpose(0, 1), lens)
    with pytest.raises(ValueError, match="at least one position"):
        ck.backward_prob(lt, obs[:, :0], lens)


# ---------------------------------------------------------------------
# the tools and the timing helper
# ---------------------------------------------------------------------

def _rows(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.fixture
def tiny_config(monkeypatch):
    monkeypatch.setitem(bench_engines.CONFIGS, "tiny", TINY)
    return "tiny"


def test_bench_engines_estep_rows(tiny_config, capsys):
    assert bench_engines.main(["--configs", tiny_config, "--device", "cpu",
                               "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "# device: cpu"
    rows = _rows(out)
    assert [r["engine"] for r in rows] == ["plain", "cuda", "cuda_v3",
                                           "cuda_log"]
    for r in rows:
        assert r["estep_ms"] > 0 and r["positions_per_s"] > 0
        assert r["cellupdates_per_s"] > 0
        assert abs(r["loglik"] - rows[0]["loglik"]) \
            <= 1e-5 * abs(rows[0]["loglik"])
    delta = [ln for ln in out.splitlines() if "loglik rel-delta" in ln]
    assert len(delta) == 1 and float(delta[0].split()[-1]) <= 1e-5


@pytest.mark.parametrize("mode,engines", [
    ("--decode", ["plain", "streaming", "fused", "pointers"]),
    ("--maxpost", ["plain", "fused", "scans"]),
])
def test_bench_engines_decode_rows(tiny_config, capsys, mode, engines):
    assert bench_engines.main(["--configs", tiny_config, "--device", "cpu",
                               "--iters", "1", mode]) == 0
    rows = _rows(capsys.readouterr().out)
    assert [r["engine"] for r in rows] == engines
    assert all(r["decode_ms"] > 0 and r["path_agreement"] == 1.0
               and r["loglik"] == rows[0]["loglik"] for r in rows)


def test_bench_engines_reports_an_envelope_error(tiny_config, capsys,
                                                 monkeypatch):
    """An engine whose wrapper refuses the configuration gives an
    ``error`` row of its own; the others still run."""
    def refuse(*_a, **_k):
        raise NotImplementedError("em_fwd: S=4 needs too much (ROADMAP "
                                  "Queue 2: K1 beyond the shared-memory "
                                  "envelope)")

    monkeypatch.setattr(ck, "em_counts_fused", refuse)
    assert bench_engines.main(["--configs", tiny_config, "--device", "cpu",
                               "--iters", "1"]) == 0
    rows = {r["engine"]: r for r in _rows(capsys.readouterr().out)}
    assert "K1 beyond" in rows["cuda"]["error"]
    assert "estep_ms" not in rows["cuda"] and "loglik" not in rows["cuda"]
    for engine in ("plain", "cuda_v3", "cuda_log"):
        assert "error" not in rows[engine]
        assert abs(rows["plain"]["loglik"] - rows[engine]["loglik"]) \
            <= 1e-5 * abs(rows["plain"]["loglik"])


def test_bench_engines_other_failures_propagate(tiny_config, monkeypatch):
    def broken(*_a, **_k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ck, "forward_prob", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        bench_engines.main(["--configs", tiny_config, "--device", "cpu",
                            "--iters", "1", "--engines", "cuda_v3"])


def test_bench_engines_inputs_are_the_jax_tool_s_draws():
    """``make_inputs`` draws what tools/bench_engines.py draws."""
    S, T, V, B, L = TINY
    params, symbols = bench_engines.make_inputs(S, T, V, B, L, CPU, seed=3)
    rng = np.random.RandomState(3)
    start = rng.dirichlet(np.ones(S))
    trans = rng.dirichlet(np.ones(S), size=S)
    log_em = np.zeros((S, T, V), np.float32)
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    want_sym = rng.randint(1, V, size=(B, L, T))
    np.testing.assert_array_equal(symbols.numpy(), want_sym)
    np.testing.assert_allclose(params.log_start.numpy(), np.log(start),
                               rtol=1e-6)
    np.testing.assert_allclose(params.log_trans.numpy(), np.log(trans),
                               rtol=1e-6)
    np.testing.assert_array_equal(params.log_em.numpy(), log_em)


@pytest.mark.parametrize("n_configs", [1, 2])
def test_profile_estep_rows(tiny_config, capsys, n_configs):
    argv = [",".join([tiny_config] * n_configs), "--device", "cpu",
            "--iters", "1"]
    assert profile_estep.main(argv) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "# device: cpu"
    rows = _rows(out)
    assert len(rows) == n_configs
    stages = ("obs_ms", "obs_p_ms", "fwd_ms", "bwd_ms", "epilogue_ms")
    for row in rows:
        assert row["config"] == tiny_config
        assert row["engine"] == "cuda_v3"
        assert all(row[k] > 0 for k in stages)
        assert row["sum_ms"] == pytest.approx(
            sum(row[k] for k in stages[1:]), abs=2e-3)


def test_profile_estep_cuda_log_rows(tiny_config, capsys):
    """``--engine cuda_log``: obs, the two log-space kernels and the
    plain engine's epilogue, which sum to one E-step."""
    assert profile_estep.main([tiny_config, "--device", "cpu", "--iters",
                               "1", "--engine", "cuda_log"]) == 0
    (row,) = _rows(capsys.readouterr().out)
    stages = ("obs_ms", "fwd_ms", "bwd_ms", "epilogue_ms")
    assert row["engine"] == "cuda_log" and "obs_p_ms" not in row
    assert all(row[k] > 0 for k in stages)
    assert row["sum_ms"] == pytest.approx(sum(row[k] for k in stages),
                                          abs=2e-3)


@pytest.mark.parametrize("batch", [0, 3])
def test_time_scans_rows(tiny_config, capsys, batch):
    """``tools.time_scans``: the device line, then one row a shape with
    every tile kernel's time and the value-row backtrace's (the plain
    versions here), and every tile kernel's again with the block tile
    forced (``_tile``), each with its us a step; no ``rows_R`` off the
    card; the constant is restored."""
    assert time_scans.main(["--configs", tiny_config, "--device", "cpu",
                            "--reps", "1", "--batch", str(batch)]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "# device: cpu"
    (row,) = _rows(out)
    S, _T, _V, B, L = TINY
    assert (row["config"], row["S"], row["B"], row["L"]) == (
        tiny_config, S, batch or B, L)
    own = ("K5", "K6a", "K6b", "K7a", "K7b", "K8c")
    assert all(row[k] > 0 for k in ("bt",) + own)
    assert row["bt_us"] == pytest.approx(row["bt"] * 1e3 / (L - 1))
    for k in own + tuple(k + "_tile" for k in own):
        assert row[k] > 0
        assert row[k + "_us"] == pytest.approx(row[k] * 1e3 / L)
    assert "rows_R" not in row
    assert ck.LOG_SCAN_MAX_STATES == 256


TILE_NAMES = ("K5", "K6a", "K6b", "K7a", "K7b", "K8c")
TILE_KINDS = {"K5": 4, "K6a": 2, "K6b": 3, "K7a": 0, "K7b": 1, "K8c": 5}


@pytest.mark.parametrize("S,force,names,want", [
    (64, False, TILE_NAMES, TILE_KINDS),
    (256, False, TILE_NAMES, TILE_KINDS),
    (240, False, ("X1", "X2", "K3"), {"X1": 0, "X2": 1, "K3": 4}),
    (20, False, TILE_NAMES, {}), (64, True, TILE_NAMES, {}),
    (256, True, ("X1", "X2", "K3"), {})])
def test_time_scans_rows_R_asks_each_kernels_kind(monkeypatch, S, force,
                                                  names, want):
    """``rows_R``: the rows a block of each kernel timed (K5, K6a, K6b,
    K7a, K7b and K8c, or the carry modes K3, X1 and X2) that ran the rows
    kernels, read from the plan of its own kind (the card's plan faked;
    K3's that of K5); none on the lanes step or the forced block tile."""
    asked = {}

    def plan(S_, B, kind):
        asked[kind] = (S_, B)
        return {"R": 10 + kind}

    monkeypatch.setattr(ck, "library_rows_plan", plan)
    if force:
        monkeypatch.setattr(ck, "LOG_SCAN_MAX_STATES", 0)
    got = time_scans._rows_R(S, 7, names)
    assert got == {name: 10 + kind for name, kind in want.items()}
    assert asked == {kind: (S, 7) for kind in want.values()}


def test_time_scans_backtrace_rows(capsys):
    """``tools.time_scans --backtraces``: one row a B x L x S point with
    the value-row backtrace's time and its us a step (the plain version
    here)."""
    assert time_scans.main(["--configs", "", "--backtraces", "3x6x5,1x2x7",
                            "--device", "cpu", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    rows = _rows(out)
    assert [(r["backtrace"], r["B"], r["L"]) for r in rows] == [
        (5, 3, 6), (7, 1, 2)]
    for r in rows:
        assert r["bt"] > 0
        assert r["bt_us"] == pytest.approx(r["bt"] * 1e3 / (r["L"] - 1))


def test_tools_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench_engines.main(["--configs", "S20"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        profile_estep.main(["S20"])


@pytest.mark.parametrize("robust", [False, True])
def test_marginal_time_counts_and_syncs(robust):
    calls = {"run": 0, "sync": 0}

    def run():
        calls["run"] += 1
        return sum(range(2000))

    def sync(out):
        assert out == sum(range(2000))
        calls["sync"] += 1

    dt = marginal_time(run, sync, 2, robust=robust)
    assert dt > 0
    # one warm call, then chains of 2 and 12 (robust: a warm chain and
    # two chains per point), each ended by one sync
    assert calls == ({"run": 1 + 2 + 4 + 24, "sync": 6} if robust
                     else {"run": 1 + 2 + 12, "sync": 3})
