"""The log-space scans and the pointer-writing Viterbi of the port on the
CPU: ``cuda_kernels.forward_scaled`` (K7a/K8a), ``backward_scaled``
(K7b/K8b) and ``viterbi_pointers`` with ``pointer_chase`` (K8c) through
their plain versions against the Pallas kernels they replace (interpret
mode, as tests/test_pallas.py runs them) and the JAX package's scans;
the float64 plain versions; the unscaled wrappers ``dp.forward``,
``dp.backward``, ``dp.posterior``; the E-step engine ``"cuda_log"``
against the JAX package's ``engine="xla"``; and the routes past the fused
kernels' envelopes: ``"auto"`` past K1 (``ops/em.resolve_engine``) and the
stitched decoders past K2 and K4 (``parallel/stitch.viterbi_route``,
``maxpost_route``).

Tolerances are tests/test_pallas.py's own: alpha_hat and beta_hat 1e-5
absolute, log_c and log_d 1e-4 absolute, logliks 1e-6 relative, Viterbi
scores 1e-5 relative, paths equal on valid positions; the unscaled
posterior, which passes through the cumulative normalizers, 1e-4
absolute; E-step statistics as tests/test_torch_em.py states them."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.cli import eval as jax_eval  # noqa: E402
from tehmm_tpu.models import gauss as jgauss  # noqa: E402
from tehmm_tpu.models import params as jparams  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.ops import em as jem  # noqa: E402
from tehmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from tehmm_tpu.parallel import stitch as jstitch  # noqa: E402
from tehmm_tpu_torch.cli import eval as port_eval  # noqa: E402
from tehmm_tpu_torch.cli import train as port_train  # noqa: E402
from tehmm_tpu_torch.io.trackdata import TrackTable  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.models import params as tparams  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402
from tehmm_tpu_torch.ops import em as tem  # noqa: E402
from tehmm_tpu_torch.parallel import stitch as tstitch  # noqa: E402

from test_torch_engines import (  # noqa: E402
    _assert_stats, _estep_case, _obs_case, _t,
)

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = torch.device("cpu")
CUDA = torch.device("cuda")       # a device type only: nothing runs on it
F64 = torch.float64


@pytest.fixture(autouse=True)
def _zero_counts():
    ck.reset_launch_counts()
    yield
    # nothing on the CPU may launch (or build) a kernel
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES
    assert ck._lib is None


def _j(a):
    return jnp.asarray(np.asarray(a))


# ragged rows incl. 0 and 1, zero transitions, either side of 32 states,
# past 64 states
CASES = {
    "ragged": dict(S=5, L=37, lengths=[37, 20, 7, 1, 0]),
    "zero_trans": dict(S=5, L=40, lengths=[40, 13, 1, 0], zero_frac=0.3),
    # the card's lanes step to 32 states, its rows kernels from 33
    "S32": dict(S=32, L=11, lengths=[11, 6, 1, 0], zero_frac=0.3),
    "S33": dict(S=33, L=11, lengths=[11, 6, 1, 0], zero_frac=0.3),
    "S72": dict(S=72, L=9, lengths=[9, 5, 1, 0], T=1),
    # past 256 states: the cluster tile's S on the card
    "S260": dict(S=260, L=6, lengths=[6, 3, 1, 0], T=1),
}


# ---------------------------------------------------------------------
# the scans' plain versions against the Pallas kernels
# ---------------------------------------------------------------------

@pytest.mark.parametrize("jax_fn", ["forward_scaled_pallas",
                                    "forward_scaled_pallas_v2",
                                    "dp.forward_scaled"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_scaled_matches_jax(rng, make_hmm, case, jax_fn):
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **CASES[case])
    fn = jdp.forward_scaled if jax_fn == "dp.forward_scaled" \
        else getattr(pk, jax_fn)
    want_a, want_c, want_ll = fn(_j(ls), _j(lt), _j(obs), _j(lens))
    alpha, log_c, loglik = ck.forward_scaled(_t(ls), _t(lt), _t(obs),
                                             _t(lens))
    plain = ck.forward_scaled_plain(_t(ls), _t(lt), _t(obs), _t(lens))
    assert all(torch.equal(a, b) for a, b in zip((alpha, log_c, loglik),
                                                  plain))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_a), atol=1e-5)
    np.testing.assert_allclose(loglik.numpy(), np.asarray(want_ll),
                               rtol=1e-6)
    # the v2 kernel never renormalizes a zero-length row's position 0, so
    # its log_c there is 0 where the others' is LOG_ZERO
    rows = lens > 0 if jax_fn.endswith("_v2") else slice(None)
    np.testing.assert_allclose(log_c.numpy()[rows], np.asarray(want_c)[rows],
                               atol=1e-4)
    assert loglik.numpy()[lens == 0].tolist() == [0.0] * int((lens == 0).sum())


@pytest.mark.parametrize("jax_fn", ["backward_scaled_pallas",
                                    "backward_hat_pallas_v2",
                                    "dp.backward_scaled"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_scaled_matches_jax(rng, make_hmm, case, jax_fn):
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **CASES[case])
    fn = jdp.backward_scaled if jax_fn == "dp.backward_scaled" \
        else getattr(pk, jax_fn)
    want = fn(_j(lt), _j(obs), _j(lens))
    beta, log_d = ck.backward_scaled(_t(lt), _t(obs), _t(lens))
    plain = ck.backward_scaled_plain(_t(lt), _t(obs), _t(lens))
    assert torch.equal(beta, plain[0]) and torch.equal(log_d, plain[1])
    if jax_fn == "backward_hat_pallas_v2":    # beta_hat only
        want = (want,)
    np.testing.assert_allclose(beta.numpy(), np.asarray(want[0]), atol=1e-5)
    if len(want) == 2:
        np.testing.assert_allclose(log_d.numpy(), np.asarray(want[1]),
                                   atol=1e-4)
    for b, n in enumerate(lens):              # 0 from the last valid on
        assert not beta.numpy()[b, max(n - 1, 0):].any()
        assert not log_d.numpy()[b, max(n - 1, 0):].any()


@pytest.mark.parametrize("jax_fn", ["viterbi_pallas", "dp.viterbi"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_viterbi_pointers_match_jax(rng, make_hmm, case, jax_fn):
    """The pointers and their chase give the paths of ``viterbi_pallas``
    (K8c) and ``dp.viterbi`` on valid positions and their scores; the
    last row and the normalizers are K5's."""
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **CASES[case])
    fn = jdp.viterbi if jax_fn == "dp.viterbi" else pk.viterbi_pallas
    want_p, want_s = fn(_j(ls), _j(lt), _j(obs), _j(lens))
    args = (_t(ls), _t(lt), _t(obs), _t(lens))
    ptrs, v_last, dm = ck.viterbi_pointers(*args)
    assert ptrs.dtype == ck.pointer_dtype(CASES[case]["S"])   # uint8 to 256
    v, vdm = ck.viterbi_values_plain(*args)
    assert torch.equal(v_last, v[:, -1]) and torch.equal(dm, vdm)
    path, score = tdp.viterbi_backpointers(*args)
    assert path.dtype == torch.int32
    assert torch.equal(path, ck.pointer_chase(ptrs, v_last, _t(lens)))
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(path.numpy()[b, :n],
                                      np.asarray(want_p)[b, :n],
                                      err_msg=f"row {b}")
    nonempty = lens > 0
    np.testing.assert_allclose(score.numpy()[nonempty],
                               np.asarray(want_s)[nonempty], rtol=1e-5)
    # the port's own Viterbi, padding and zero-length rows included
    own_p, own_s = tdp.viterbi(*args)
    assert torch.equal(path, own_p)
    np.testing.assert_allclose(score.numpy(), own_s.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_pointers_take_the_lowest_state_on_ties():
    """Equal candidates: every pointer is the lowest state; padding and
    position 0 hold the identity."""
    S, L = 6, 5
    lt = torch.full((S, S), float(np.log(1.0 / S)))
    ls = torch.full((S,), float(np.log(1.0 / S)))
    lens = torch.tensor([L, 2, 0], dtype=torch.int32)
    ptrs, _v, _dm = ck.viterbi_pointers(ls, lt, torch.zeros((3, L, S)),
                                        lens)
    ident = torch.arange(S, dtype=torch.uint8)
    assert bool((ptrs[0, 1:] == 0).all())
    assert bool((ptrs[:, 0] == ident).all())
    assert bool((ptrs[1, 2:] == ident).all())
    assert bool((ptrs[2] == ident).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_scans_plain_in_float64(rng, make_hmm, case):
    """Carried in float64 the plain versions return float64, stay within
    float32 rounding of the float32 scans, and keep the exact carries."""
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **CASES[case])
    args = (_t(ls), _t(lt), _t(obs), _t(lens))
    fwd = ck.forward_scaled_plain(*args)
    fwd64 = ck.forward_scaled_plain(*args, dtype=F64)
    bwd = ck.backward_scaled_plain(*args[1:])
    bwd64 = ck.backward_scaled_plain(*args[1:], dtype=F64)
    assert {t.dtype for t in fwd64 + bwd64} == {F64}
    for got, want, atol in ((fwd[0], fwd64[0], 1e-5), (fwd[1], fwd64[1],
                                                       1e-4),
                            (bwd[0], bwd64[0], 1e-5), (bwd[1], bwd64[1],
                                                       1e-4)):
        np.testing.assert_allclose(got.numpy(), want.float().numpy(),
                                   rtol=0, atol=atol)
    np.testing.assert_allclose(fwd[2].numpy(), fwd64[2].numpy(), rtol=1e-6)
    for b, n in enumerate(lens):
        assert not bwd64[0].numpy()[b, max(n - 1, 0):].any()
        if n == 0:
            assert not fwd64[0].numpy()[b].any() and fwd64[2][b] == 0


@pytest.mark.parametrize("S,L,lengths", [(5, 23, [23, 11, 1, 0]),
                                         (10, 1, [1, 0])])
def test_chunk_sweeps_plain_in_float64(rng, make_hmm, S, L, lengths):
    """The carried chunk sweeps (X1, X2's plain versions) in float64:
    float64 out, within float32 rounding of float32, and chunked sweeps
    still bit-identical to one chunk."""
    ls, lt, obs, lens = _obs_case(rng, make_hmm, S, L, lengths)
    lt, obs, lens = _t(lt), _t(obs), _t(lens)
    init = torch.from_numpy(rng.randn(len(lengths), S).astype(np.float32))
    init = init - init.amax(dim=-1, keepdim=True)
    cont = torch.tensor([True] + [False] * (len(lengths) - 1))
    for fn, extra in ((tdp.forward_final, ()),
                      (tdp.forward_chunk_values, ()),
                      (tdp.backward_chunk_values, (cont,))):
        args = (lt, obs, init, *extra, lens)
        got, got64 = fn(*args), fn(*args, dtype=F64)
        for g, w in zip(got, got64):
            assert w.dtype == F64
            np.testing.assert_allclose(g.numpy(), w.float().numpy(), rtol=1e-6,
                                       atol=1e-5)
    # forward_final over two chunks == over one, in float64
    one = tdp.forward_final(lt, obs, init, lens, dtype=F64)
    k = L // 2
    mid, dm1 = tdp.forward_final(lt, obs[:, :k], init,
                                 torch.clamp(lens, max=k), dtype=F64)
    end, dm2 = tdp.forward_final(lt, obs[:, k:], mid,
                                 torch.clamp(lens - k, min=0), dtype=F64)
    assert torch.equal(end, one[0])
    np.testing.assert_allclose((dm1 + dm2).numpy(), one[1].numpy(),
                               rtol=1e-12)


# ---------------------------------------------------------------------
# the unscaled wrappers
# ---------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["forward", "backward", "posterior"])
@pytest.mark.parametrize("case", ["ragged", "zero_trans"])
def test_unscaled_wrappers_match_jax(rng, make_hmm, case, fn):
    ls, lt, obs, lens = _obs_case(rng, make_hmm, **CASES[case])
    jargs, targs = (_j(ls), _j(lt), _j(obs), _j(lens)), \
        (_t(ls), _t(lt), _t(obs), _t(lens))
    if fn == "forward":
        (la, ll), (jla, jll) = tdp.forward(*targs), jdp.forward(*jargs)
        np.testing.assert_allclose(la.numpy(), np.asarray(jla), rtol=1e-6,
                                   atol=1e-4)
        np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-6)
    elif fn == "backward":
        np.testing.assert_allclose(tdp.backward(*targs[1:]).numpy(),
                                   np.asarray(jdp.backward(*jargs[1:])),
                                   rtol=1e-6, atol=1e-4)
    else:
        la, ll = tdp.forward(*targs)
        gamma = tdp.posterior(la, tdp.backward(*targs[1:]), ll)
        jla, jll = jdp.forward(*jargs)
        want = jdp.posterior(jla, jdp.backward(*jargs[1:]), jll)
        # through the cumulative normalizers, so at their limit
        np.testing.assert_allclose(gamma.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
        valid = np.arange(obs.shape[1])[None, :] < lens[:, None]
        np.testing.assert_allclose(gamma.numpy().sum(-1)[valid], 1.0,
                                   atol=1e-4)


# ---------------------------------------------------------------------
# the E-step engine "cuda_log" and "auto"
# ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "weights", "gauss", "ragged"])
def test_cuda_log_engine_matches_xla(rng, make_hmm, variant):
    """``"cuda_log"`` against the JAX package's ``engine="xla"``; on the
    CPU it is the plain engine, bit for bit."""
    jargs, jkw, targs, tkw = _estep_case(rng, make_hmm, variant)
    got = tem.em_sufficient_stats(*targs, engine="cuda_log", **tkw)
    _assert_stats(got, jem.em_sufficient_stats(*jargs, engine="xla", **jkw))
    plain = tem.em_sufficient_stats(*targs, engine="plain", **tkw)
    for name in ("start", "trans", "em", "loglik", "gauss_n", "gauss_x",
                 "gauss_x2"):
        a, b = getattr(got, name), getattr(plain, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_auto_routes_past_k1(monkeypatch):
    """``"auto"``: the plain engine off the card; on the card K1 where its
    predicate says it fits, else ``"cuda_v3"``, never ``"plain"``."""
    assert tem.resolve_engine("auto", 10, 5, 9, 0, CPU) == "plain"
    assert tem.resolve_engine("auto", 10, 5, 9, 0, CUDA) == "cuda"
    assert tem.resolve_engine("auto", 160, 5, 9, 0, CUDA) == "cuda_v3"
    assert tem.resolve_engine("cuda_log", 10, 5, 9, 0, CUDA) == "cuda_log"
    asked = []

    def no(*a):
        asked.append(a)
        return False

    monkeypatch.setattr(ck, "k1_fits", no)
    assert tem.resolve_engine("auto", 10, 5, 9, 2, CUDA) == "cuda_v3"
    assert asked == [(10, 5, 9, 2)]
    assert tem.resolve_engine("auto", 10, 5, 9, 2, CPU) == "plain"


@pytest.mark.parametrize("S,T,V,G,fits", [
    (148, 5, 9, 0, True), (149, 5, 9, 0, False),   # ROADMAP's edge
    (64, 10, 12, 0, True), (128, 15, 16, 0, False),
    (200, 1, 2, 64, False), (257, 1, 2, 0, False)])
def test_k1_envelope_predicate(S, T, V, G, fits):
    """``k1_fits`` is the arithmetic of K1's wrappers' checks: both
    kernels fit, the reverse at the warps per block it would run."""
    assert ck.k1_fits(S, T, V, G) == fits
    warps = ck._k1_bwd_warps(S, T, V, G)
    fwd, bwd = ck._k1_smem_floats(S, T, V, warps, G)
    assert fits == (S <= ck.MAX_STATES
                    and 4 * max(fwd, bwd) <= ck._SMEM_LIMIT)


@pytest.mark.parametrize("S,T,V,G,k2,k4", [
    (217, 5, 9, 0, True, True), (218, 5, 9, 0, False, False),
    (147, 15, 16, 0, True, True), (256, 20, 16, 0, False, False),
    (200, 1, 2, 64, False, False), (10, 5, 9, 2, True, True)])
def test_decode_routes(S, T, V, G, k2, k4):
    """K2's and K4's predicates (at T=5, V=9 both end at S=217; K4 is
    K1's forward, whose tables are K2's, then its decode), and the
    stitched decoders' routes."""
    assert ck.k2_fits(S, T, V, G) == k2 and ck.k4_fits(S, T, V, G) == k4
    assert tstitch.viterbi_route(S, T, V, G, CUDA) == ("fused" if k2
                                                       else "streaming")
    assert tstitch.viterbi_route(S, T, V, G, CPU) == "fused"
    assert tstitch.maxpost_route(S, T, V, G, CUDA) == ("fused" if k4
                                                       else "scans")
    assert tstitch.maxpost_route(S, T, V, G, CPU) == "scans"


# ---------------------------------------------------------------------
# the stitched decoders past K2's and K4's envelopes
# ---------------------------------------------------------------------

@pytest.fixture
def no_fused(monkeypatch):
    """K2 and K4 say no (as past their envelopes), and the Viterbi route
    is chosen as for a card (off it the route is always K2's plain
    version); the obs-space routes' entry points count their calls."""
    monkeypatch.setattr(ck, "k2_fits", lambda *a: False)
    monkeypatch.setattr(ck, "k4_fits", lambda *a: False)
    route = tstitch.viterbi_route
    monkeypatch.setattr(tstitch, "viterbi_route",
                        lambda S, T, V, G, device: route(S, T, V, G, CUDA))
    calls = {"viterbi_streaming": 0, "forward_scaled": 0,
             "backward_scaled": 0, "viterbi_fused": 0,
             "posterior_decode_fused": 0}
    for owner, name in ((tdp, "viterbi_streaming"),
                        (ck, "forward_scaled"), (ck, "backward_scaled"),
                        (ck, "viterbi_fused"),
                        (ck, "posterior_decode_fused")):
        fn = getattr(owner, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(owner, name, counted)
    return calls


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """A copy of tests/data with a supervised model trained by the port."""
    work = tmp_path_factory.mktemp("scans_cli")
    for f in os.listdir(DATA):
        src = os.path.join(DATA, f)
        if os.path.isfile(src):
            shutil.copy(src, work / f)
    assert port_train.main([str(work / "tracks.xml"), str(work / "truth.bed"),
                            str(work / "m.npz"), "--supervised",
                            "--device", "cpu"]) == 0
    return work


@pytest.mark.parametrize("mode", [[], ["--maxPost"]])
def test_stitched_cli_routes_match_the_jax_cli(cli_dir, capsys, no_fused,
                                               mode):
    """Stitched ``eval --bed`` through the streaming route and
    ``--maxPost`` through the scans route write the JAX CLI's BED byte
    for byte (so no position differs, near-tie or not) and its score."""
    out, scores = {}, {}
    flags = ["--no-exact", "--chunk", "300", "--halo", "32", *mode]
    for name, cli in (("jax", jax_eval), ("port", port_eval)):
        path = str(cli_dir / f"route_{name}.bed")
        argv = [str(cli_dir / "tracks.xml"), str(cli_dir / "m.npz"),
                str(cli_dir / "regions.bed"), "--bed", path, *flags]
        capsys.readouterr()
        assert cli.main(argv + (["--device", "cpu"] if name == "port"
                                else [])) == 0
        scores[name] = float(capsys.readouterr().out.strip())
        out[name] = open(path, "rb").read()
    assert out["port"] == out["jax"] and out["port"]
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=1e-5)
    if mode:
        assert no_fused["forward_scaled"] and no_fused["backward_scaled"]
    else:
        assert no_fused["viterbi_streaming"]
        assert not no_fused["viterbi_fused"]
    assert not no_fused["posterior_decode_fused"]


@pytest.mark.parametrize("decoder", ["viterbi_chunked", "posterior_chunked"])
def test_stitched_routes_with_streams_match_jax(rng, make_hmm, no_fused,
                                                decoder):
    """The obs-space routes take the segment weights and the gaussian
    values into obs as the fused kernels do: the paths of the JAX
    package's stitched decoder with both streams."""
    S, T, V, G = 4, 2, 5, 2
    tables = [np.asarray(x, np.float32) for x in make_hmm(S, T, V)]
    tables[1] = np.log(np.exp(tables[1]) * 0.2 + np.eye(S) * 0.8) \
        .astype(np.float32)
    mu = (rng.randn(S, G) * 2.0).astype(np.float32)
    log_var = (rng.randn(S, G) * 0.3).astype(np.float32)
    tabs, weights = [], []
    for n in (700, 333):
        sym = rng.randint(1, V, size=(n, T)).astype(np.uint8)
        vals = (rng.randn(n, G) * 2.0).astype(np.float32)
        vals[rng.rand(n, G) < 0.1] = np.nan
        tabs.append(TrackTable("chr1", 0, n, sym, vals))
        weights.append(rng.uniform(1.0, 4.0, n).astype(np.float32))
    jp = jparams.HmmParams(*(_j(t) for t in tables))
    tp = tparams.from_numpy(*tables, CPU)
    jg = jgauss.GaussParams(_j(mu), _j(log_var))
    tg = tgauss.from_numpy(mu, log_var, CPU)
    kw = dict(chunk_len=128, halo=16)
    want, _ = getattr(jstitch, decoder)(jp, tabs, weight_arrays=weights,
                                        gauss_params=jg, **kw)
    got, report = getattr(tstitch, decoder)(tp, tabs, weight_arrays=weights,
                                            gauss_params=tg, **kw)
    assert report.n_chunks == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    route = ("viterbi_streaming" if decoder == "viterbi_chunked"
             else "forward_scaled")
    assert no_fused[route] >= 1
