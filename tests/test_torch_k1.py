"""K1, the fused E-step's two kernels, on the CPU: the choice of step
(``ck.k1_step``: the lanes kernels to 32 states, the shared kernels to
K1's envelope, which it names past its edge) with the card's launches
faked, ``em_counts_fused`` on CPU tensors (its plain version) against
the JAX package's ``em_counts_fused_pallas_v4`` in interpret mode for
every stream variant at lengths on both sides of the lanes kernels'
ring halves, and the rows of ``tools.time_k1``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.models import gauss as jgauss  # noqa: E402
from tehmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

T, V = 5, 9                       # the decode model's tracks and symbols
EDGE = 148                        # K1's envelope's edge at T=5, V=9, G=0
VARIANTS = ["", "+w", "+g", "+wg"]
LENGTHS = [0, 1, 31, 32, 33, 65]  # the lanes kernels stage 32 at a time


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------
# the step, by states; launches faked
# ---------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 10, 32, 33, EDGE, EDGE + 1])
def test_k1_step_by_states(S):
    if S > EDGE:
        assert not ck.k1_fits(S, T, V)
        with pytest.raises(NotImplementedError,
                           match="K1 beyond the shared-memory envelope"):
            ck.k1_step(S, T, V)
        return
    assert ck.k1_fits(S, T, V)
    assert ck.k1_step(S, T, V) == \
        ("lanes" if S <= ck.K1_LANES_MAX_STATES else "shared")


def test_k1_step_where_the_ring_does_not_fit(monkeypatch):
    """Inside K1's envelope at 2 states but with 100 tracks of 145
    symbols, the lanes kernels' ring (a half of 32 positions' symbols a
    slot) would not fit beside the tables: the shared step.  With the
    constant at 0 every model takes the shared step."""
    assert ck.k1_fits(2, 100, 145)
    assert ck.k1_step(2, 100, 145) == "shared"
    assert ck.k1_step(2, 5, 145) == "lanes"
    monkeypatch.setattr(ck, "K1_LANES_MAX_STATES", 0)
    assert ck.k1_step(10, T, V) == "shared"


def _fake_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    # each launch's (B, L, S, T, V), and the reverse's warps a block
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev: launched.append(
                            (name, entry, args[8:13] if "fwd" in entry
                             else args[10:16])))
    return launched


def _case(rng, S, variant, lengths=LENGTHS, G=2, w_hi=64.0):
    """(log_start, log_trans, log_em, symbols, lengths) and the streams
    of ``variant`` (weights, gaussian values and their means and log
    variances), as numpy arrays; weights in [1, w_hi]."""
    L = max(lengths)
    start = np.log(rng.dirichlet(np.ones(S))).astype(np.float32)
    trans = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    log_em = np.zeros((S, T, V), np.float32)
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    B = len(lengths)
    sym = rng.randint(0, V, size=(B, L, T)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    w = vals = mu = log_var = None
    if "w" in variant:
        w = rng.uniform(1.0, w_hi, size=(B, L)).astype(np.float32)
    if "g" in variant:
        vals = (rng.randn(B, L, G) * 2.0).astype(np.float32)
        vals[rng.rand(B, L, G) < 0.1] = np.nan
        mu = (rng.randn(S, G) * 2.0).astype(np.float32)
        log_var = (rng.randn(S, G) * 0.5).astype(np.float32)
    return (start, trans, log_em, sym, lens), (w, vals, mu, log_var)


def _torch_streams(streams):
    w, vals, mu, log_var = streams
    gauss = None if mu is None else tgauss.from_numpy(mu, log_var, "cpu")
    return dict(obs_weights=None if w is None else _t(w), gauss_params=gauss,
                gauss_values=None if vals is None else _t(vals))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", [1, 10, 32, 33, 100])
def test_k1_route_launches(rng, monkeypatch, S, variant):
    """On the card ``em_counts_fused`` launches the forward and the
    reverse of ``k1_step`` once each, under the counters of its stream
    variant, at every variant; with the constant at 0, the shared
    kernels."""
    launched = _fake_card(monkeypatch)
    tables, streams = _case(rng, S, variant, lengths=[3, 0, 2], G=1)
    args = [_t(x) for x in tables]
    st = _torch_streams(streams)
    entries = {"lanes": ("tehmm_em_fwd_lanes", "tehmm_em_bwd_stats_lanes"),
               "shared": ("tehmm_em_fwd", "tehmm_em_bwd_stats")}
    step = ck.k1_step(S, T, V, 1 if "g" in variant else 0)
    assert step == ("lanes" if S <= 32 else "shared")
    ck.em_counts_fused(*args, **st)
    warps = ck._k1_bwd_warps(S, T, V, 1 if "g" in variant else 0)
    assert launched == [
        ("em_fwd" + variant, entries[step][0], (3, 3, S, T, V)),
        ("em_bwd_stats" + variant, entries[step][1], (3, 3, S, T, V, warps))]
    launched.clear()
    monkeypatch.setattr(ck, "K1_LANES_MAX_STATES", 0)
    ck.em_counts_fused(*args, **st)
    assert [x[1] for x in launched] == list(entries["shared"])


def test_k4_forward_past_k1_takes_the_shared_kernel(rng, monkeypatch):
    """K4 runs K1's forward where K1's reverse does not fit (S=149 at
    T=5, V=9): there, past ``k1_step``'s envelope, the shared forward."""
    launched = _fake_card(monkeypatch)
    tables, _ = _case(rng, EDGE + 1, "", lengths=[3, 2])
    assert not ck.k1_fits(EDGE + 1, T, V)
    ck.em_fwd(*[_t(x) for x in tables])
    assert launched == [("em_fwd", "tehmm_em_fwd", (2, 3, EDGE + 1, T, V))]


# ---------------------------------------------------------------------
# the plain version against the JAX package's Pallas K1 (interpret mode)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", [3, 10])
def test_em_counts_fused_matches_jax(rng, S, variant):
    """Against the Pallas kernel (interpret mode) at the tolerances of
    the JAX package's own checks of it (tests/test_pallas.py): logliks
    within 1e-5 relative and 1e-4 absolute, the statistics within 1e-4
    relative and absolute, the gaussian moments within 1e-4 relative and
    1e-5 of each moment's largest entry (gx sums values of both signs, so
    its rounding scales with the largest, not with a cancelled entry);
    zero-length rows a loglik of 0.  Weights in [1, 8], as those checks
    draw them: the Pallas kernel's three-pass bf16 products lose accuracy
    as larger weights sharpen the obs, and ``test_plain_matches_float64``
    holds the plain version at weights to 64."""
    tables, streams = _case(rng, S, variant, w_hi=8.0)
    w, vals, mu, log_var = streams
    jg = None if mu is None else jgauss.GaussParams(jnp.asarray(mu),
                                                    jnp.asarray(log_var))
    want = pk.em_counts_fused_pallas_v4(
        *[jnp.asarray(x) for x in tables],
        None if w is None else jnp.asarray(w), jg,
        None if vals is None else jnp.asarray(vals))
    got = ck.em_counts_fused(*[_t(x) for x in tables],
                             **_torch_streams(streams))
    assert len(got) == len(want) == (5 if "g" in variant else 4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=1e-4)
    assert got[3].numpy()[0] == 0.0
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)
    for g, w_ in zip(got[4] if "g" in variant else (),
                     want[4] if "g" in variant else ()):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4,
                                   atol=1e-5 * np.abs(w_).max())


def _float64_stats(tables, streams, obs):
    """The E-step in float64 with a scaled forward-backward: (start, pair
    without the transition factor, em, logliks[, (gn, gx, gx2)])."""
    ls, lt, lem, sym, lens = tables
    w, vals = streams[:2]
    S = len(ls)
    trans, start_p = np.exp(lt.astype(np.float64)), np.exp(ls.astype(
        np.float64))
    start, pair = np.zeros(S), np.zeros((S, S))
    em, ll = np.zeros(lem.shape), np.zeros(len(lens))
    G = 0 if vals is None else vals.shape[-1]
    mom = np.zeros((3, S, G))
    for b, n in enumerate(lens):
        if n == 0:
            continue
        o = obs[b, :n]
        o_m = o.max(axis=1, keepdims=True)
        op = np.exp(o - o_m)
        alpha, c = np.zeros((n, S)), np.zeros(n)
        for t in range(n):
            a = (start_p if t == 0 else alpha[t - 1] @ trans) * op[t]
            c[t] = a.sum()
            alpha[t] = a / c[t]
        ll[b] = np.log(c).sum() + o_m.sum()
        beta = np.ones((n, S))
        for t in range(n - 1, 0, -1):
            pair += np.outer(alpha[t - 1], op[t] * beta[t]) / c[t]
            beta[t - 1] = trans @ (op[t] * beta[t]) / c[t]
        gamma = alpha * beta
        start += gamma[0]
        gw = gamma if w is None else gamma * w[b, :n, None]
        for t in range(lem.shape[1]):
            np.add.at(em[:, t], (slice(None), sym[b, :n, t]), gw.T)
        if G:
            v = vals[b, :n].astype(np.float64)
            fin = np.isfinite(v)
            x = np.where(fin, v, 0.0)
            for k, f in enumerate((fin * 1.0, x, x * x)):
                mom[k] += gw.T @ f
    out = (start, pair, em, ll)
    return out + ((tuple(mom),) if G else ())


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_float64(rng, variant):
    """Where the Pallas kernel drifts (weights to 64), the plain version,
    which the card's kernels equal within their tolerances
    (tests_cuda/test_cuda_em.py), against the same E-step in float64 on
    the same obs: every statistic within 1e-5 relative (and 1e-5 of its
    array's largest entry), logliks within 1e-6 relative."""
    from tehmm_tpu_torch.models.emission import obs_log_likelihoods

    tables, streams = _case(rng, 10, variant)
    st = _torch_streams(streams)
    got = ck.em_counts_fused(*[_t(x) for x in tables], **st)
    obs = obs_log_likelihoods(_t(tables[2]), _t(tables[3]),
                              st["gauss_params"], st["gauss_values"],
                              st["obs_weights"]).double().numpy()
    want = _float64_stats(tables, streams, obs)
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-6, atol=0)
    pairs = list(zip(got[:3], want[:3]))
    pairs += list(zip(got[4], want[4])) if "g" in variant else []
    for g, w_ in pairs:
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-5,
                                   atol=1e-5 * np.abs(w_).max())


# ---------------------------------------------------------------------
# tools.time_k1
# ---------------------------------------------------------------------

def test_time_k1_rows(capsys, monkeypatch):
    """``tools.time_k1`` (shapes cut to size): the device line, then a
    reading of each kernel at each shape (K1's two, or at the decode
    shapes K4's forward and decode, then K2's forward in both modes, the
    chase, the value-row backtrace and the fused decode), the lanes step
    and, at S <= 32, the shared steps forced (the plain versions
    here)."""
    from tehmm_tpu_torch.tools import time_k1

    monkeypatch.setattr(time_k1, "SHAPES", {
        "em": (4, 40, 33), "bench": (3, 9, 9), "segments": (2, 40, 31),
        "decode64": (2, 37, 37), "decode512": (5, 37, 37)})
    assert time_k1.main(["--states", "10,20,40", "--reps", "1",
                         "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# device: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    want = []
    for S in (10, 20, 40):
        shapes = ["em"] + {10: ["segments"], 20: ["bench"]}.get(S, []) \
            + ["decode64", "decode512"]
        steps = ["lanes", "shared (forced)"] if S <= 32 else ["shared"]
        want += [(shape, S, step, kernel) for step in steps
                 for shape in shapes
                 for kernel in (("em_fwd", "post_decode") + K2_TIMED
                                if shape.startswith("decode")
                                else ("em_fwd", "em_bwd_stats"))]
    assert [(r["shape"], r["S"], r["step"], r["kernel"]) for r in rows] \
        == want
    for r in rows:
        assert r["ms"] > 0 and r["us_per_step"] == r["ms"] * 1e3 / r["L"]
        assert r["stream"] == ("+w" if r["shape"] == "segments" else "")
    # restored after forcing
    assert ck.K1_LANES_MAX_STATES == 32 and ck.K4_LANES_MAX_STATES == 32
    assert ck.K2_LANES_MAX_STATES == 32


K2_TIMED = ("viterbi_fwd", "viterbi_fwd_pointers", "chunk_chase",
            "viterbi_backtrace", "viterbi_fused")
