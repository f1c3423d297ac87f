"""Port parameters, model files, emissions and the M-step against the
JAX package, on the same seeded inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.models import emission as jem  # noqa: E402
from tehmm_tpu.models import params as jparams  # noqa: E402
from tehmm_tpu.ops import em as jem_ops  # noqa: E402
from tehmm_tpu_torch.models import emission as tem  # noqa: E402
from tehmm_tpu_torch.models import params as tparams  # noqa: E402
from tehmm_tpu_torch.ops import em as tem_ops  # noqa: E402

CPU = torch.device("cpu")
SIZES = [4, 3, 9, 1, 6]          # incl. a track with no real symbols


def _np(p):
    return [np.asarray(x) for x in (p.log_start, p.log_trans, p.log_em)]


def test_from_numpy_roundtrip(make_hmm):
    tables = [np.asarray(x, np.float32) for x in make_hmm(5, 3, 6)]
    p = tparams.from_numpy(*tables, CPU)
    assert p.num_states == 5 and p.num_tracks == 3 and p.max_symbols == 6
    for got, want in zip((p.log_start, p.log_trans, p.log_em), tables):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    # the JAX package's arrays carry straight across
    jp = jparams.HmmParams(*(jnp.asarray(t) for t in tables))
    q = tparams.from_numpy(jp.log_start, jp.log_trans, jp.log_em, CPU)
    np.testing.assert_array_equal(q.log_em.numpy(), tables[2])


@pytest.mark.parametrize("init", ["flat", "random"])
def test_init_matches_reference(init):
    if init == "flat":
        want = jparams.init_flat(4, SIZES)
        got = tparams.init_flat(4, SIZES, CPU)
    else:
        want = jparams.init_random(4, SIZES, seed=7)
        got = tparams.init_random(4, SIZES, 7, CPU)
    for g, w in zip(_np(got), _np(want)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tparams.apply_emission_conventions(_np(got)[2] + 1.0, SIZES),
        jparams.apply_emission_conventions(_np(want)[2] + 1.0, SIZES),
    )


def test_model_files_cross_load(tmp_path):
    """JAX save_model -> port load_model -> port save_model -> JAX
    load_model: tables, meta and extra arrays survive both ways."""
    jp = jparams.init_random(3, SIZES, seed=11)
    meta = {"state_names": ["a", "b", "c"], "tracks": [], "n": 1}
    extra = {"gauss_mu": np.arange(6, dtype=np.float32).reshape(3, 2)}
    p1 = str(tmp_path / "jax_written.npz")
    jparams.save_model(p1, jp, meta, extra_arrays=extra)

    tp, tmeta, textra = tparams.load_model(p1, CPU)
    assert tmeta == meta
    np.testing.assert_array_equal(textra["gauss_mu"], extra["gauss_mu"])
    for g, w in zip(_np(tp), _np(jp)):
        np.testing.assert_array_equal(g, w)

    p2 = str(tmp_path / "port_written")       # .npz suffix added
    tparams.save_model(p2, tp, tmeta, extra_arrays=textra)
    jp2, jmeta, jextra = jparams.load_model(p2)
    assert jmeta == meta
    np.testing.assert_array_equal(jextra["gauss_mu"], extra["gauss_mu"])
    for g, w in zip(_np(jp2), _np(jp)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("S,T,V,shape", [
    (3, 2, 5, (40,)),
    (10, 5, 9, (3, 64)),
    (7, 1, 4, (2, 1)),
])
def test_track_log_likelihoods_matches_reference(rng, make_hmm, S, T, V,
                                                 shape):
    _, _, log_em = make_hmm(S, T, V)
    log_em = log_em.astype(np.float32)
    sym = rng.randint(0, V, size=shape + (T,)).astype(np.uint8)
    sym.reshape(-1, T)[::5] = 0               # missing-data rows
    want = np.asarray(
        jem.track_log_likelihoods(jnp.asarray(log_em), jnp.asarray(sym))
    )
    got = tem.track_log_likelihoods(
        torch.from_numpy(log_em), torch.from_numpy(sym.astype(np.int32))
    ).numpy()
    assert got.shape == shape + (S,) and got.dtype == np.float32
    # obs is a T-term float32 sum; the reference's one-hot einsum
    # associates it differently, which moves |obs| ~ 25 by up to 2 ulps
    # (3.8e-6 absolute, 2.3e-7 relative, measured): hold it to 1e-6
    # relative on top of 1e-6 absolute
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _counts(rng, S, T, V):
    em = rng.randint(0, 50, size=(S, T, V)).astype(np.float32)
    em[rng.rand(S, T, V) < 0.3] = 0.0
    trans = rng.randint(0, 1000, size=(S, S)).astype(np.float32)
    trans[0] = 0.0                            # an unvisited state
    start = rng.randint(0, 3, size=(S,)).astype(np.float32)
    return start, trans, em


def test_normalize_log_em_matches_reference(rng):
    _, _, counts = _counts(rng, 6, len(SIZES), max(SIZES))
    want = np.asarray(jem.normalize_log_em(
        jnp.asarray(counts), jnp.asarray(SIZES)
    ))
    got = tem.normalize_log_em(torch.from_numpy(counts), SIZES).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_em_m_step_matches_reference(rng):
    S = 6
    start, trans, em = _counts(rng, S, len(SIZES), max(SIZES))
    jstats = jem_ops.EmStats(
        start=jnp.asarray(start), trans=jnp.asarray(trans),
        em=jnp.asarray(em), loglik=jnp.zeros(()),
        n_obs=jnp.asarray(100.0),
    )
    want = jem_ops.em_m_step(
        jstats, jparams.init_flat(S, SIZES), jnp.asarray(SIZES)
    )
    tstats = tem_ops.EmStats(
        start=torch.from_numpy(start), trans=torch.from_numpy(trans),
        em=torch.from_numpy(em), loglik=torch.zeros(()),
        n_obs=torch.tensor(100.0),
    )
    got = tem_ops.em_m_step(tstats, tparams.init_flat(S, SIZES, CPU),
                            SIZES)
    for g, w in zip(_np(got), _np(want)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
