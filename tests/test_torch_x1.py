"""The exact posteriors' grouped sweeps against the JAX package: X1's
checkpoint mode (its plain version, which the CPU takes) against the JAX
``dp.forward_chunk_values`` carry chained chunk by chunk, the grouped
``posterior_sweep`` against the JAX ``posterior_sweep`` under budgets
that force every group size, X1 twice a group and X2 once a chunk, and
X1's route by S with launches faked."""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.models import gauss as jgauss  # noqa: E402
from tehmm_tpu.models.emission import track_log_likelihoods  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.parallel import stitch as jstitch  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402
from tehmm_tpu_torch.parallel import stitch as tstitch  # noqa: E402

from test_torch_exact import CHUNK, CPU, GROUPS, LENGTHS, _both, _sticky  # noqa: E402,E501


@pytest.fixture(autouse=True)
def _no_launches():
    ck.reset_launch_counts()
    yield
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


# ---------------------------------------------------------------------
# X1's checkpoint mode
# ---------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk", [(40, 8), (41, 8), (40, 64), (7, 1),
                                     (0, 5)])
def test_checkpoints_equal_jax_carry_chained(rng, L, chunk):
    """``ck.forward_checkpoints`` on CPU tensors (``dp.forward_checkpoints``)
    is the JAX ``dp.forward_chunk_values`` carry chained over the chunks
    (the reference's forward sweep) within 1e-5, and ``forward_final``
    chained bit for bit, with ragged lengths (0, 1, inside a chunk, the
    whole row)."""
    S, T, V = 5, 3, 6
    _, lt, lem = _sticky(rng, S, T, V)
    lengths = np.asarray([L, 0, min(1, L), L // 2, max(L - 3, 0)],
                         np.int32)
    sym = rng.randint(0, V, size=(len(lengths), L, T)).astype(np.int32)
    obs = np.array(track_log_likelihoods(jnp.asarray(lem),
                                         jnp.asarray(sym)))
    init = rng.randn(len(lengths), S).astype(np.float32)
    init -= init.max(axis=1, keepdims=True)
    args = (torch.from_numpy(lt), torch.from_numpy(obs),
            torch.from_numpy(init), torch.from_numpy(lengths))
    got = ck.forward_checkpoints(*args, chunk)
    n_ck = -(-L // chunk)
    assert tuple(got.shape) == (len(lengths), n_ck, S)
    carry, chained = jnp.asarray(init), args[2]
    for c in range(n_ck):
        lens = np.clip(lengths - c * chunk, 0, chunk)
        part = obs[:, c * chunk:(c + 1) * chunk]
        _, carry = jdp.forward_chunk_values(
            jnp.asarray(lt), jnp.asarray(part), carry, jnp.asarray(lens))
        np.testing.assert_allclose(got[:, c].numpy(), np.asarray(carry),
                                   rtol=0, atol=1e-5)
        chained, _ = tdp.forward_final(args[0], torch.from_numpy(part),
                                       chained, torch.from_numpy(lens))
        assert torch.equal(got[:, c], chained)
    if n_ck:   # the last checkpoint is the values mode's final carry
        assert torch.equal(ck.forward_chunk_values(*args)[1], got[:, -1])


def test_checkpoints_check_the_chunk():
    S, B, L = 3, 2, 6
    with pytest.raises(ValueError, match="chunk"):
        ck.forward_checkpoints(torch.zeros((S, S)), torch.zeros((B, L, S)),
                               torch.zeros((B, S)),
                               torch.full((B,), L, dtype=torch.int32), 0)
    with pytest.raises(TypeError, match="lengths"):
        ck.forward_checkpoints(torch.zeros((S, S)), torch.zeros((B, L, S)),
                               torch.zeros((B, S)),
                               torch.full((B,), L, dtype=torch.int64), 2)


# ---------------------------------------------------------------------
# the grouped posterior sweep
# ---------------------------------------------------------------------

def _budget(monkeypatch, n_chunks_a_group, B, S, Lc=CHUNK):
    """Set the groups' byte budget to hold that many chunks of the
    exact posteriors' tensors."""
    monkeypatch.setattr(tstitch, "EXACT_GROUP_BYTES",
                        n_chunks_a_group * tstitch.POSTERIOR_GROUP_TENSORS
                        * 4 * B * Lc * S)


def _sweep(stitch, params, tables, **kw):
    """(gamma per table f32[L, S] from ``posterior_sweep``'s consumer, the
    argmax paths of ``posterior_exact``, its default consumer's)."""
    S = params.log_trans.shape[0]
    out = [np.zeros((len(getattr(t, "symbols", t)), S), np.float32)
           for t in tables]

    def consume(b, start, gamma):
        out[b][start:start + len(gamma)] = np.asarray(gamma)

    stitch.posterior_sweep(params, tables, CHUNK, consume, **kw)
    return out, stitch.posterior_exact(params, tables, CHUNK, **kw)


@pytest.mark.parametrize("per", GROUPS)
def test_grouped_posterior_sweep_equals_jax(rng, monkeypatch, per):
    """Groups of 1, 2, 3 and all 11 chunks: the JAX ``posterior_sweep``'s
    gamma within 1e-5 (``--pd``'s tolerance), and the paths of the JAX
    ``posterior_exact`` (the argmax of its gamma); every grouping gives
    the bits of one chunk a group."""
    S, T, V = 6, 3, 7
    tables = _sticky(rng, S, T, V)
    jp, tp = _both(tables)
    syms = [rng.randint(0, V, size=(n, T)).astype(np.uint8)
            for n in LENGTHS]
    Lc = min(CHUNK, max(LENGTHS) - 1)
    want_g, want_p = _sweep(jstitch, jp, syms)
    _budget(monkeypatch, 1, len(syms), S)
    one_g, one_p = _sweep(tstitch, tp, syms)
    _budget(monkeypatch, per, len(syms), S)
    assert tstitch.exact_group_chunks(
        len(syms), Lc, S, tstitch.POSTERIOR_GROUP_TENSORS) == per
    got_g, got_p = _sweep(tstitch, tp, syms)
    for g, p, w, wp, og, op in zip(got_g, got_p, want_g, want_p, one_g,
                                   one_p):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        assert p.dtype == np.int32
        np.testing.assert_array_equal(p, np.asarray(wp))
        np.testing.assert_array_equal(p, g.argmax(axis=1))
        assert og.tobytes() == g.tobytes() and op.tobytes() == p.tobytes()


@pytest.mark.parametrize("per", GROUPS)
@pytest.mark.parametrize("streams", ["weights", "gauss", "both"])
def test_grouped_posterior_sweep_with_streams_equals_jax(rng, monkeypatch,
                                                         per, streams):
    """The segment-weight and gaussian streams through the grouped
    sweeps: the JAX ``posterior_sweep``'s gamma within 1e-5 and its
    paths."""
    S, T, V, G = 4, 2, 5, 2
    tables = _sticky(rng, S, T, V)
    jp, tp = _both(tables)
    tabs = []
    for n in LENGTHS:
        v = (rng.randn(n, G) * 2.0).astype(np.float32)
        v[rng.rand(n, G) < 0.1] = np.nan
        tabs.append(types.SimpleNamespace(
            symbols=rng.randint(0, V, size=(n, T)).astype(np.uint8),
            values=v))
    kw_j, kw_t = {}, {}
    if streams in ("weights", "both"):
        w = [rng.randint(1, 9, size=n).astype(np.float32) for n in LENGTHS]
        kw_j["weight_arrays"] = kw_t["weight_arrays"] = w
    if streams in ("gauss", "both"):
        mu = (rng.randn(S, G) * 2.0).astype(np.float32)
        lv = (rng.randn(S, G) * 0.5).astype(np.float32)
        kw_j["gauss_params"] = jgauss.GaussParams(jnp.asarray(mu),
                                                  jnp.asarray(lv))
        kw_t["gauss_params"] = tgauss.from_numpy(mu, lv, CPU)
    want_g, want_p = _sweep(jstitch, jp, tabs, **kw_j)
    _budget(monkeypatch, per, len(tabs), S)
    got_g, got_p = _sweep(tstitch, tp, tabs, **kw_t)
    for g, p, w, wp in zip(got_g, got_p, want_g, want_p):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(p, np.asarray(wp))


def test_posterior_sweep_runs_x1_twice_a_group(rng, monkeypatch):
    """The forward sweep calls X1's checkpoint mode once a group and the
    recompute its values mode once a group (rows: every (table, chunk) of
    the group); X2 runs twice a group, its checkpoint mode (the backward
    sweep) and its values mode (the beta recompute), and once for
    position 0; X1's carry-only mode not at all."""
    S, T, V = 3, 2, 4
    tables = _sticky(rng, S, T, V)
    _, tp = _both(tables)
    syms = [rng.randint(0, V, size=(n, T)).astype(np.uint8)
            for n in (301, 120)]
    calls = []

    def counted(name):
        fn = getattr(ck, name)

        def call(*args):
            calls.append((name, args[1].shape[0], args[1].shape[1]))
            return fn(*args)
        return call

    for name in ("forward_checkpoints", "forward_chunk_values",
                 "forward_final", "backward_checkpoints",
                 "backward_chunk_values"):
        monkeypatch.setattr(ck, name, counted(name))
    # 300 body positions in chunks of 25: 12 chunks, groups of 5, 5, 2
    _budget(monkeypatch, 5, 2, S, 25)
    got = tstitch.posterior_sweep(tp, syms, 25)
    names = [n for n, _, _ in calls]
    assert names.count("forward_checkpoints") == 3
    assert names.count("forward_chunk_values") == 3
    assert names.count("forward_final") == 0
    assert names.count("backward_checkpoints") == 3
    assert names.count("backward_chunk_values") == 3 + 1
    assert [(rows, L) for n, rows, L in calls
            if n == "forward_chunk_values"] == [(2 * 2, 25), (2 * 5, 25),
                                                (2 * 5, 25)]
    assert [(rows, L) for n, rows, L in calls
            if n == "forward_checkpoints"] == [(2, 125), (2, 125), (2, 50)]
    _budget(monkeypatch, 12, 2, S, 25)
    want = tstitch.posterior_sweep(tp, syms, 25)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------
# X1's route by S, launches faked
# ---------------------------------------------------------------------

def _fake_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev:
                        launched.append((name, entry, args[7:])))
    return launched


@pytest.mark.parametrize("S", [1, 10, 32, 33, 239, 240, 1024])
def test_x1_step_by_states(monkeypatch, S):
    """The step is chosen by S alone: registers and shuffles to 32
    states, shared memory to ``sweep_fits``' 239, the tile beyond; the
    values and carry-only modes launch once under ``fwd_chunk`` (the
    final carry their one checkpoint), the checkpoint mode once under
    ``fwd_checkpoints`` (the tile's carry mode once a chunk)."""
    launched = _fake_card(monkeypatch)
    B, L, chunk = 3, 10, 4
    step = ck.x1_step(S)
    assert step == ("lanes" if S <= 32 else
                    "shared" if S <= 239 else "tile")
    assert (step == "tile") == (not ck.sweep_fits(S))
    args = (torch.zeros((S, S)), torch.zeros((B, L, S)),
            torch.zeros((B, S)), torch.full((B,), L, dtype=torch.int32))
    ck.forward_chunk_values(*args)
    ck.forward_final(*args)
    ck.forward_checkpoints(*args, chunk)
    if step == "tile":
        # past 256 states the cluster tile, to 256 the rows kernel, each
        # under its own counter
        cluster = int(ck.scan_route(S) == "cluster")
        assert cluster == (S > 256)
        # the entry's tile flag: the cluster tile's 1, to 256 states the
        # rows kernel's 3 (``log_scan_route``)
        flag = 1 if cluster else 3
        tile = ("fwd_chunk_cluster" if cluster else "fwd_chunk_rows",
                "tehmm_fwd_chunk_tile")
        assert [x[:2] for x in launched] == [tile] * (2 + 3)
        assert [x[2] for x in launched] == [(B, L, S, flag)] * 2 + \
            [(B, 4, S, flag), (B, 4, S, flag), (B, 2, S, flag)]
    else:
        entry = {"lanes": "tehmm_x1_sweep_lanes",
                 "shared": "tehmm_x1_sweep_smem"}[step]
        assert launched == [
            ("fwd_chunk", entry, (B, L, S, L, 1)),
            ("fwd_chunk", entry, (B, L, S, L, 1)),
            ("fwd_checkpoints", entry, (B, L, S, chunk, 3))]


def test_time_x1_rows(capsys, monkeypatch):
    """``tools.time_x1`` (shapes cut to size): the device line, then a
    reading of each mode and shape, the shared step forced at S <= 32,
    and the exact decode with its split (the plain versions here)."""
    from tehmm_tpu_torch.tools import time_x1

    for name, value in (("CHUNK", 8), ("N_CHUNKS", 3), ("RAGGED_ROWS", 5),
                        ("RAGGED_L", 9), ("DECODE_REGION", 50)):
        monkeypatch.setattr(time_x1, name, value)
    assert time_x1.main(["--states", "3", "--reps", "1",
                         "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# device: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    shapes = [("values", 1, 8), ("values", 3, 8), ("values", 5, 9),
              ("sweep", 1, 24)]
    assert [(r["mode"], r["B"], r["L"], r["step"]) for r in rows] == [
        s + ("lanes",) for s in shapes] + [
        s + ("shared (forced)",) for s in shapes] + [
        ("decode", 1, 50, "lanes")]
    for r in rows:
        assert r["ms"] > 0 and r["us_per_step"] == r["ms"] * 1e3 / r["L"]
    split = rows[-1]["split_ms"]
    assert set(split) == {"obs", "forward sweep", "recompute", "X2", "rest"}
    # 49 body positions in chunks of 8: 7 chunks, one group; X2's sweep
    # and its recompute once each, and position 0
    assert rows[-1]["calls"] == {"obs": 1, "forward sweep": 1,
                                 "recompute": 1, "X2": 1 + 1 + 1}
    assert ck.x1_step(3) == "lanes"
