"""The exact posteriors' backward kernel X2 against the JAX package: its
checkpoint mode (its plain version, which the CPU takes) against the JAX
``dp.backward_chunk_values`` chained from the last chunk, its argument
checks, its route by S with launches faked, the grouped
``posterior_sweep`` against the JAX ``posterior_sweep`` on tables that
end at, just past and inside chunk boundaries, and the eval CLI's
``--pd`` file and ``--maxPost --exact`` BED from every grouping."""

import json
import os
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.models import gauss as jgauss  # noqa: E402
from tehmm_tpu.models.emission import track_log_likelihoods  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.parallel import stitch as jstitch  # noqa: E402
from tehmm_tpu_torch.cli import eval as port_eval  # noqa: E402
from tehmm_tpu_torch.cli import train as port_train  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402
from tehmm_tpu_torch.parallel import stitch as tstitch  # noqa: E402

from test_torch_exact import CHUNK, CPU, DATA, GROUPS, _both, _sticky  # noqa: E402,E501

# Table lengths around CHUNK's boundaries (body positions 1..L-1): one and
# two chunks exactly, one position past a chunk, 1, 2 and 0 positions,
# and the longest, 503 (11 chunks, as GROUPS' largest group)
X2_LENGTHS = [503, 47, 93, 48, 1, 2, 139, 0]


@pytest.fixture(autouse=True)
def _no_launches():
    ck.reset_launch_counts()
    yield
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


# ---------------------------------------------------------------------
# X2's checkpoint mode
# ---------------------------------------------------------------------

@pytest.mark.parametrize("continuing", [True, False])
@pytest.mark.parametrize("L,chunk", [(40, 8), (41, 8), (40, 64), (7, 1),
                                     (0, 5)])
def test_checkpoints_equal_jax_chunks_chained(rng, L, chunk, continuing):
    """``ck.backward_checkpoints`` on CPU tensors
    (``dp.backward_checkpoints``) is the JAX ``dp.backward_chunk_values``
    chained from the last chunk (the reference's backward sweep; chunk c
    continues where the row's length passes its end, the last where the
    row runs past the span) within 1e-5, and the port's
    ``backward_chunk_values`` chained bit for bit, with ragged lengths (0,
    1, inside a chunk, the whole row), rows that continue past the span
    or not, continuing rows shorter than the span among them."""
    S, T, V = 5, 3, 6
    _, lt, lem = _sticky(rng, S, T, V)
    lengths = np.asarray([L, 0, min(1, L), L // 2, max(L - 3, 0)],
                         np.int32)
    B = len(lengths)
    sym = rng.randint(0, V, size=(B, L, T)).astype(np.int32)
    obs = np.array(track_log_likelihoods(jnp.asarray(lem),
                                         jnp.asarray(sym)))
    init = rng.randn(B, S).astype(np.float32)
    init -= init.max(axis=1, keepdims=True)
    cont = np.full(B, continuing)
    args = (torch.from_numpy(lt), torch.from_numpy(obs),
            torch.from_numpy(init), torch.from_numpy(cont),
            torch.from_numpy(lengths))
    got = ck.backward_checkpoints(*args, chunk)
    n_ck = -(-L // chunk)
    assert tuple(got.shape) == (B, n_ck, S)
    x, chained = jnp.asarray(init), args[2]
    for c in reversed(range(n_ck)):
        lens = np.clip(lengths - c * chunk, 0, chunk)
        part = obs[:, c * chunk:(c + 1) * chunk]
        c_cont = cont if c == n_ck - 1 else lengths > (c + 1) * chunk
        _, x = jdp.backward_chunk_values(
            jnp.asarray(lt), jnp.asarray(part), x, jnp.asarray(c_cont),
            jnp.asarray(lens))
        np.testing.assert_allclose(got[:, c].numpy(), np.asarray(x),
                                   rtol=0, atol=1e-5)
        _, chained = tdp.backward_chunk_values(
            args[0], torch.from_numpy(part), chained,
            torch.from_numpy(c_cont), torch.from_numpy(lens))
        assert torch.equal(got[:, c], chained)
    if n_ck:   # where no chunk boundary resets beta, the first checkpoint
        # is the values mode's x_out over the whole span
        same = ~cont | (lengths >= L)
        x_out = ck.backward_chunk_values(*args)[1]
        assert torch.equal(x_out[same], got[same, 0])


def test_checkpoints_check_their_arguments():
    S, B, L = 3, 2, 6
    lt, obs, carry = (torch.zeros((S, S)), torch.zeros((B, L, S)),
                      torch.zeros((B, S)))
    cont = torch.zeros(B, dtype=torch.bool)
    lens = torch.full((B,), L, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk"):
        ck.backward_checkpoints(lt, obs, carry, cont, lens, 0)
    with pytest.raises(TypeError, match="lengths"):
        ck.backward_checkpoints(lt, obs, carry, cont, lens.to(torch.int64),
                                2)
    with pytest.raises(TypeError, match="continuing"):
        ck.backward_checkpoints(lt, obs, carry, lens, lens, 2)
    with pytest.raises(ValueError, match="x_carry"):
        ck.backward_checkpoints(lt, obs, carry[:1], cont, lens, 2)
    assert ck.backward_checkpoints(lt, obs[:, :0], carry, cont,
                                   lens * 0, 4).shape == (B, 0, S)


# ---------------------------------------------------------------------
# X2's route by S, launches faked
# ---------------------------------------------------------------------

def _fake_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev:
                        launched.append((name, entry, args[7:])))
    return launched


@pytest.mark.parametrize("S", [1, 10, 32, 33, 239, 240, 1024])
def test_x2_step_by_states(monkeypatch, S):
    """The step is chosen by S alone, at X1's thresholds: registers and
    shuffles to 32 states, shared memory to ``sweep_fits``' 239, the tile
    beyond; the values mode launches once under ``bwd_chunk`` (x_out its
    one checkpoint), the checkpoint mode once under ``bwd_checkpoints``
    (the tile's carry mode once a chunk, from the last)."""
    launched = _fake_card(monkeypatch)
    B, L, chunk = 3, 10, 4
    step = ck.x2_step(S)
    assert step == ck.x1_step(S)
    assert step == ("lanes" if S <= ck.X2_LANES_MAX_STATES else
                    "shared" if S <= 239 else "tile")
    args = (torch.zeros((S, S)), torch.zeros((B, L, S)),
            torch.zeros((B, S)), torch.ones(B, dtype=torch.bool),
            torch.full((B,), L, dtype=torch.int32))
    ck.backward_chunk_values(*args)
    ck.backward_checkpoints(*args, chunk)
    if step == "tile":
        # past 256 states the cluster tile, to 256 the rows kernel, each
        # under its own counter
        cluster = int(ck.scan_route(S) == "cluster")
        assert cluster == (S > 256)
        # the entry's tile flag: the cluster tile's 1, to 256 states the
        # rows kernel's 3 (``log_scan_route``)
        flag = 1 if cluster else 3
        tile = ("bwd_chunk_cluster" if cluster else "bwd_chunk_rows",
                "tehmm_bwd_chunk_tile")
        assert [x[:2] for x in launched] == [tile] * (1 + 3)
        assert [x[2] for x in launched] == [
            (B, L, S, flag), (B, 2, S, flag), (B, 4, S, flag),
            (B, 4, S, flag)]
    else:
        entry = {"lanes": "tehmm_x2_sweep_lanes",
                 "shared": "tehmm_x2_sweep_smem"}[step]
        assert launched == [
            ("bwd_chunk", entry, (B, L, S, L, 1)),
            ("bwd_checkpoints", entry, (B, L, S, chunk, 3))]


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
    """(gamma per table f32[L, S] from ``posterior_sweep``'s consumer,
    the consumer's calls (table, start) in order, the argmax paths of
    ``posterior_exact``)."""
    S = params.log_trans.shape[0]
    out = [np.zeros((len(getattr(t, "symbols", t)), S), np.float32)
           for t in tables]
    calls = []

    def consume(b, start, gamma):
        calls.append((b, start))
        out[b][start:start + len(gamma)] = np.asarray(gamma)

    stitch.posterior_sweep(params, tables, CHUNK, consume, **kw)
    return out, calls, stitch.posterior_exact(params, tables, CHUNK, **kw)


def _tables(rng, S, T, V, streams):
    tabs, kw_j, kw_t = [], {}, {}
    G = 2
    for n in X2_LENGTHS:
        v = (rng.randn(n, G) * 2.0).astype(np.float32)
        v[rng.rand(n, G) < 0.1] = np.nan
        tabs.append(types.SimpleNamespace(
            symbols=rng.randint(0, V, size=(n, T)).astype(np.uint8),
            values=v))
    if streams in ("weights", "both"):
        w = [rng.randint(1, 9, size=n).astype(np.float32)
             for n in X2_LENGTHS]
        kw_j["weight_arrays"] = kw_t["weight_arrays"] = w
    if streams in ("gauss", "both"):
        mu = (rng.randn(S, G) * 2.0).astype(np.float32)
        lv = (rng.randn(S, G) * 0.5).astype(np.float32)
        kw_j["gauss_params"] = jgauss.GaussParams(jnp.asarray(mu),
                                                  jnp.asarray(lv))
        kw_t["gauss_params"] = tgauss.from_numpy(mu, lv, CPU)
    return tabs, kw_j, kw_t


@pytest.mark.parametrize("streams", [None, "weights", "gauss", "both"])
@pytest.mark.parametrize("per", GROUPS)
def test_grouped_posterior_sweep_equals_jax(rng, monkeypatch, per,
                                            streams):
    """Groups of 1, 2, 3 and all 11 chunks, on tables that end at, one
    past and inside chunk boundaries (so a (table, chunk) of the beta
    recompute continues or not on its own), with and without the weight
    and gaussian streams: the JAX ``posterior_sweep``'s gamma within 1e-5
    and the JAX ``posterior_exact``'s paths; every grouping gives the
    bits of one chunk a group, and the consumer sees the chunks in the
    same reverse time order."""
    S, T, V = 4, 2, 5
    tables = _sticky(rng, S, T, V)
    jp, tp = _both(tables)
    tabs, kw_j, kw_t = _tables(rng, S, T, V, streams)
    want_g, _, want_p = _sweep(jstitch, jp, tabs, **kw_j)
    _budget(monkeypatch, 1, len(tabs), S)
    one_g, one_calls, one_p = _sweep(tstitch, tp, tabs, **kw_t)
    _budget(monkeypatch, per, len(tabs), S)
    assert tstitch.exact_group_chunks(
        len(tabs), CHUNK, S, tstitch.POSTERIOR_GROUP_TENSORS) == per
    got_g, got_calls, got_p = _sweep(tstitch, tp, tabs, **kw_t)
    assert got_calls == one_calls
    starts = [s for _, s in got_calls]
    assert starts == sorted(starts, reverse=True)
    for g, p, w, wp, og, op in zip(got_g, got_p, want_g, want_p, one_g,
                                   one_p):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(p, np.asarray(wp))
        assert og.tobytes() == g.tobytes() and op.tobytes() == p.tobytes()


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """A copy of tests/data with a supervised model trained by the port."""
    work = tmp_path_factory.mktemp("x2_cli")
    for f in os.listdir(DATA):
        src = os.path.join(DATA, f)
        if os.path.isfile(src):
            shutil.copy(src, work / f)
    assert port_train.main([str(work / "tracks.xml"), str(work / "truth.bed"),
                            str(work / "m.npz"), "--supervised",
                            "--device", "cpu"]) == 0
    return work


def _eval_files(work, tag):
    """The eval CLI's ``--pd`` file and ``--maxPost --exact`` BED, in
    chunks of 300 (2,399 body positions: 8 chunks), as bytes."""
    out = []
    for flags, name in ((["--pd"], "pd.bed"),
                        (["--maxPost", "--exact", "--bed"], "bed.bed")):
        path = str(work / f"{tag}_{name}")
        assert port_eval.main([str(work / "tracks.xml"), str(work / "m.npz"),
                               str(work / "regions.bed"), *flags, path,
                               "--chunk", "300", "--device", "cpu"]) == 0
        out.append(open(path, "rb").read())
    return out


@pytest.mark.parametrize("per", [1, 2, 3])
def test_pd_and_bed_the_same_from_every_grouping(cli_dir, monkeypatch,
                                                 per):
    """``--pd``'s file and the ``--maxPost --exact`` BED, byte for byte,
    with the exact posteriors' groups cut to 1, 2 or 3 chunks and in the
    default budget's one group."""
    whole = _eval_files(cli_dir, "whole")
    monkeypatch.setattr(tstitch, "exact_group_chunks",
                        lambda B, Lc, S, tensors=2: per)
    cut = _eval_files(cli_dir, f"per{per}")
    assert cut == whole and all(whole)


def test_time_x2_rows(capsys, monkeypatch):
    """``tools.time_x2`` (shapes cut to size): the device line, then a
    reading of each mode and shape, the shared step forced at S <= 32,
    and the exact decode with its split (the plain versions here)."""
    from tehmm_tpu_torch.tools import time_x2

    for name, value in (("CHUNK", 8), ("N_CHUNKS", 3), ("RAGGED_ROWS", 5),
                        ("RAGGED_L", 9), ("DECODE_REGION", 50)):
        monkeypatch.setattr(time_x2, name, value)
    assert time_x2.main(["--states", "3", "--reps", "1",
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
    assert set(split) == {"obs", "forward sweep", "recompute",
                          "backward sweep", "beta recompute", "rest"}
    # 49 body positions in chunks of 8: 7 chunks, one group; the beta
    # recompute once and position 0 once
    assert rows[-1]["calls"] == {"obs": 1, "forward sweep": 1,
                                 "recompute": 1, "backward sweep": 1,
                                 "beta recompute": 1 + 1}
    assert ck.x2_step(3) == "lanes"
