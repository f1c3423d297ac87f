"""K4's decode on the CPU: the choice of step (``ck.k4_step``: the lanes
kernel to 32 states where its ring fits, the shared kernel to K4's
envelope, which it names past its edge) and the lanes kernel's shared
memory, with the card's launches faked; the stitched max-posterior
decode's pass by route (``stitch.MAXPOST_ROWS_PER_PASS``), and the port's
``posterior_chunked`` at 64 and 512 rows a pass against the JAX
package's, with ragged chunks, segment weights and gaussian tracks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.io.trackdata import TrackTable  # noqa: E402
from tehmm_tpu.models import gauss as jgauss  # noqa: E402
from tehmm_tpu.models.params import HmmParams  # noqa: E402
from tehmm_tpu.parallel import stitch as jstitch  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.parallel import stitch as tstitch  # noqa: E402

T, V = 5, 9                       # the decode model's tracks and symbols
EDGE = 217                        # K4's envelope's edge at T=5, V=9, G=0
VARIANTS = ["", "+w", "+g", "+wg"]
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------
# the step, by states; launches faked
# ---------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 10, 16, 17, 32, 33, EDGE, EDGE + 1])
def test_k4_step_by_states(S):
    if S > EDGE:
        assert not ck.k4_fits(S, T, V)
        with pytest.raises(NotImplementedError,
                           match="K4, X1 and X2 beyond the shared-memory "
                                 "envelope"):
            ck.k4_step(S, T, V)
        return
    assert ck.k4_fits(S, T, V)
    assert ck.k4_step(S, T, V) == \
        ("lanes" if S <= ck.K4_LANES_MAX_STATES else "shared")


def test_k4_step_where_the_ring_does_not_fit(monkeypatch):
    """Inside K4's envelope at 2 states but with 120 tracks of 145
    symbols, the lanes kernel's ring (a half of 32 positions' symbols
    and alpha_p rows a slot, two slots a warp) would not fit beside the
    tables: the shared step.  With the constant at 0 every model takes
    the shared step."""
    assert ck.k4_fits(2, 120, 145)
    assert ck.k4_step(2, 120, 145) == "shared"
    assert ck.k4_step(2, 5, 145) == "lanes"
    monkeypatch.setattr(ck, "K4_LANES_MAX_STATES", 0)
    assert ck.k4_step(10, T, V) == "shared"


@pytest.mark.parametrize("S,T_,V_,G,floats", [
    # log_em + 3SG, then 4 warps x (2 slots x 32 x (T + 1 + G + S) +
    # 32 S)
    (10, 5, 9, 0, 450 + 4 * (2 * 32 * 16 + 320)),
    (10, 5, 9, 2, 510 + 4 * (2 * 32 * 18 + 320)),
    (1, 1, 2, 0, 2 + 4 * (2 * 32 * 3 + 32)),
    (32, 5, 9, 1, 32 * 45 + 96 + 4 * (2 * 32 * 39 + 1024)),
])
def test_k4_lanes_smem_floats(S, T_, V_, G, floats):
    """The lanes decode's shared memory: the tables, then per warp the
    ring's two slots (symbols, a weight, the gaussian values and an
    alpha_p row a position) and a half's obs_p (the card's tests hold it
    to the library's own)."""
    assert ck._k4_lanes_smem_floats(S, T_, V_, G) == floats


def _fake_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    # each launch's counter, entry and (B, L, S, T, V)
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev: launched.append(
                            (name, entry, args[6:11])))
    return launched


def _case(rng, S, variant, lengths, G=1):
    L = max(lengths)
    trans = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    log_em = np.log(rng.dirichlet(np.ones(V), size=(S, T))).astype(
        np.float32)
    B = len(lengths)
    sym = rng.randint(0, V, size=(B, L, T)).astype(np.int32)
    alpha = rng.rand(B, L, S).astype(np.float32)
    st = {}
    if "w" in variant:
        st["obs_weights"] = _t(rng.uniform(1.0, 8.0, size=(B, L)).astype(
            np.float32))
    if "g" in variant:
        st["gauss_params"] = tgauss.from_numpy(
            rng.randn(S, G).astype(np.float32),
            rng.randn(S, G).astype(np.float32) * 0.3, "cpu")
        st["gauss_values"] = _t(rng.randn(B, L, G).astype(np.float32))
    return (_t(trans), _t(log_em), _t(sym), _t(np.asarray(lengths,
                                                        np.int32)),
            _t(alpha)), st


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", [1, 10, 32, 33, 100])
def test_k4_route_launches(rng, monkeypatch, S, variant):
    """On the card ``post_decode`` launches the kernel of ``k4_step``
    once, under the counter of its step and stream variant
    (``post_decode_lanes`` to 32 states, ``post_decode`` beyond); with
    the constant at 0, the shared kernel."""
    launched = _fake_card(monkeypatch)
    args, st = _case(rng, S, variant, [3, 0, 2])
    step = ck.k4_step(S, T, V, 1 if "g" in variant else 0)
    assert step == ("lanes" if S <= 32 else "shared")
    ck.post_decode(*args, **st)
    want = {"lanes": ("post_decode_lanes", "tehmm_post_decode_lanes"),
            "shared": ("post_decode", "tehmm_post_decode")}
    name, entry = want[step]
    assert launched == [(name + variant, entry, (3, 3, S, T, V))]
    launched.clear()
    monkeypatch.setattr(ck, "K4_LANES_MAX_STATES", 0)
    ck.post_decode(*args, **st)
    assert launched == [("post_decode" + variant, "tehmm_post_decode",
                         (3, 3, S, T, V))]
    assert all(k + v in ck.LAUNCHES for k in ("post_decode",
                                               "post_decode_lanes")
               for v in VARIANTS)


# ---------------------------------------------------------------------
# the pass by route
# ---------------------------------------------------------------------

def _params(rng, S, T_, V_):
    start = np.log(np.full(S, 1.0 / S)).astype(np.float32)
    trans = rng.dirichlet(np.ones(S), size=S) * 0.1 + np.eye(S) * 0.9
    log_em = np.zeros((S, T_, V_), np.float32)
    for t in range(T_):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V_ - 1), size=S))
    return start, np.log(trans).astype(np.float32), log_em


def _passes(monkeypatch, route):
    """Route the stitched max-posterior decode by ``route`` and record
    each pass's rows (the CPU's plain versions compute them)."""
    rows = []
    monkeypatch.setattr(tstitch, "maxpost_route", lambda *a: route)
    if route == "fused":
        real = ck.posterior_decode_fused

        def fused(*args, **kw):
            rows.append(args[3].shape[0])
            return real(*args, **kw)

        monkeypatch.setattr(ck, "posterior_decode_fused", fused)
    else:
        real = ck.forward_scaled

        def scans(log_start, log_trans, obs, lengths):
            rows.append(obs.shape[0])
            return real(log_start, log_trans, obs, lengths)

        monkeypatch.setattr(ck, "forward_scaled", scans)
    return rows


@pytest.mark.parametrize("S,route,want", [
    (10, "fused", [512, 88]),         # K4: the Viterbi decoder's pass
    (10, "scans", [64] * 9 + [24]),   # the scans route: the JAX default
    (300, "scans", [54] * 11 + [6]),  # past 256 states: 64 x 256 / S
])
def test_posterior_pass_by_route(rng, monkeypatch, S, route, want):
    """Where the caller names no pass, K4's route takes 512 rows and the
    scans route 64 (scaled by 256 / S past 256 states, as before); a
    pass the caller names is kept; the paths are the same."""
    n, L = sum(want), 3
    p = from_numpy(*_params(rng, S, 1, 3), CPU)
    sym = rng.randint(0, 3, size=(n, L, 1)).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=n).astype(np.int32)
    rows = _passes(monkeypatch, route)
    got = tstitch._posterior_batch(p, sym, lengths, None)
    assert rows == want
    rows.clear()
    again = tstitch._posterior_batch(p, sym, lengths, 100)
    r = tstitch.scaled_rows(100, S)
    assert rows == [r] * (n // r) + ([n % r] if n % r else [])
    np.testing.assert_array_equal(got, again)
    assert tstitch.MAXPOST_ROWS_PER_PASS == {"fused": 512, "scans": 64}


# ---------------------------------------------------------------------
# posterior_chunked at both passes against the JAX package
# ---------------------------------------------------------------------

def _tables(rng, lengths, G=0):
    tabs, weights = [], []
    for n in lengths:
        sym = rng.randint(1, V, size=(n, T)).astype(np.uint8)
        vals = None
        if G:
            vals = (rng.randn(n, G) * 2.0).astype(np.float32)
            vals[rng.rand(n, G) < 0.1] = np.nan
        tabs.append(TrackTable("chr1", 0, n, sym, vals))
        weights.append(rng.uniform(1.0, 8.0, n).astype(np.float32))
    return tabs, weights


@pytest.mark.parametrize("streams", ["", "+w", "+g", "+wg"])
def test_posterior_chunked_any_pass_matches_jax(rng, monkeypatch, streams):
    """Ragged tables of many chunks (more than 64 in all): the port's
    ``posterior_chunked`` on the CPU gives the same paths and report at
    64 and at 512 rows a pass and through K4's route's default pass (its
    plain version), and both equal the JAX package's, with segment
    weights and gaussian tracks."""
    S, G = 10, (2 if "g" in streams else 0)
    tables = _params(rng, S, T, V)
    tabs, weights = _tables(rng, (3100, 1777, 40, 1), G)
    w = weights if "w" in streams else None
    jg = tg = None
    if G:
        mu = (rng.randn(S, G) * 2.0).astype(np.float32)
        log_var = (rng.randn(S, G) * 0.3).astype(np.float32)
        jg = jgauss.GaussParams(jnp.asarray(mu), jnp.asarray(log_var))
        tg = tgauss.from_numpy(mu, log_var, CPU)
    jp = HmmParams(*(jnp.asarray(x) for x in tables))
    tp = from_numpy(*tables, CPU)
    kw = dict(chunk_len=64, halo=16, weight_arrays=w)
    want, jrep = jstitch.posterior_chunked(jp, tabs, gauss_params=jg, **kw)
    assert jrep.n_chunks > 64 and jrep.boundaries_ok
    runs = [tstitch.posterior_chunked(tp, tabs, gauss_params=tg,
                                      rows_per_pass=rows, **kw)
            for rows in (64, 512)]
    rows = _passes(monkeypatch, "fused")
    runs.append(tstitch.posterior_chunked(tp, tabs, gauss_params=tg, **kw))
    assert rows[0] == jrep.n_chunks          # every chunk in one pass
    for got, rep in runs:
        assert rep == runs[0][1] and rep.n_chunks == jrep.n_chunks
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w_))
