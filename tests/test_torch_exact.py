"""The exact Viterbi decoder's grouped sweeps against the JAX package:
K3's checkpoint mode (its plain version, which the CPU takes) against
the JAX ``dp.viterbi_carry`` chained chunk by chunk, the grouped
``viterbi_exact`` against the JAX ``viterbi_exact`` under budgets that
force every group size, the CLI's ``--exact`` BED against the JAX CLI's,
and K3's route by S with launches faked."""

import json
import os
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.cli import eval as jax_eval  # noqa: E402
from tehmm_tpu.cli import train as jax_train  # noqa: E402
from tehmm_tpu.models import gauss as jgauss  # noqa: E402
from tehmm_tpu.models.emission import track_log_likelihoods  # noqa: E402
from tehmm_tpu.models.params import HmmParams  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.parallel import stitch as jstitch  # noqa: E402
from tehmm_tpu_torch.cli import eval as port_eval  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.parallel import stitch as tstitch  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = torch.device("cpu")


def _sticky(rng, S, T, V):
    start = np.log(rng.dirichlet(np.ones(S)))
    trans = rng.dirichlet(np.ones(S), size=S) * 0.1 + np.eye(S) * 0.9
    log_em = np.zeros((S, T, V))
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    return [np.asarray(x, np.float32) for x in (start, np.log(trans),
                                                log_em)]


def _both(tables):
    return (HmmParams(*(jnp.asarray(x) for x in tables)),
            from_numpy(*tables, CPU))


@pytest.fixture(autouse=True)
def _no_launches():
    ck.reset_launch_counts()
    yield
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


# ---------------------------------------------------------------------
# K3's checkpoint mode
# ---------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk", [(40, 8), (41, 8), (40, 64), (7, 1),
                                     (0, 5)])
def test_checkpoints_equal_jax_carry_chained(rng, L, chunk):
    """``ck.viterbi_checkpoints`` on CPU tensors (``dp.viterbi_checkpoints``)
    is the JAX ``dp.viterbi_carry`` chained over the chunks, bit for bit,
    with ragged lengths (0, 1, inside a chunk, the whole row)."""
    S, T, V = 5, 3, 6
    _, lt, lem = _sticky(rng, S, T, V)
    lengths = np.asarray([L, 0, min(1, L), L // 2, max(L - 3, 0)],
                         np.int32)
    sym = rng.randint(0, V, size=(len(lengths), L, T)).astype(np.int32)
    obs = np.array(track_log_likelihoods(jnp.asarray(lem),
                                         jnp.asarray(sym)))
    init = rng.randn(len(lengths), S).astype(np.float32)
    got = ck.viterbi_checkpoints(torch.from_numpy(lt), torch.from_numpy(obs),
                                 torch.from_numpy(init),
                                 torch.from_numpy(lengths), chunk)
    n_ck = -(-L // chunk)
    assert tuple(got.shape) == (len(lengths), n_ck, S)
    carry = jnp.asarray(init)
    for c in range(n_ck):
        lens = np.clip(lengths - c * chunk, 0, chunk)
        carry = jdp.viterbi_carry(
            jnp.asarray(lt), jnp.asarray(obs[:, c * chunk:(c + 1) * chunk]),
            carry, jnp.asarray(lens))
        np.testing.assert_array_equal(got[:, c].numpy(), np.asarray(carry))
    if n_ck:   # the last checkpoint is the carry mode's one carry
        whole = ck.viterbi_carry(torch.from_numpy(lt), torch.from_numpy(obs),
                                 torch.from_numpy(init),
                                 torch.from_numpy(lengths))
        assert torch.equal(whole, got[:, -1])


def test_checkpoints_check_the_chunk():
    S, B, L = 3, 2, 6
    with pytest.raises(ValueError, match="chunk"):
        ck.viterbi_checkpoints(torch.zeros((S, S)), torch.zeros((B, L, S)),
                               torch.zeros((B, S)),
                               torch.full((B,), L, dtype=torch.int32), 0)
    with pytest.raises(TypeError, match="lengths"):
        ck.viterbi_checkpoints(torch.zeros((S, S)), torch.zeros((B, L, S)),
                               torch.zeros((B, S)),
                               torch.full((B,), L, dtype=torch.int64), 2)


# ---------------------------------------------------------------------
# the grouped exact decoder
# ---------------------------------------------------------------------

# table lengths: ragged, an empty table, a table of one position, tables
# shorter than one chunk; 503 positions make 11 chunks of 46
LENGTHS = [503, 0, 1, 40, 260, 47]
CHUNK = 46
GROUPS = [1, 2, 3, 11]


def _budget(monkeypatch, n_chunks_a_group, B, S, Lc=CHUNK):
    """Set the exact decoder's byte budget to hold that many chunks."""
    monkeypatch.setattr(tstitch, "EXACT_GROUP_BYTES",
                        n_chunks_a_group * 2 * 4 * B * Lc * S)


@pytest.mark.parametrize("per", GROUPS)
def test_grouped_exact_equals_jax(rng, monkeypatch, per):
    """Groups of 1, 2, 3 and all 11 chunks (11 is no multiple of 2 or 3)
    give the JAX ``viterbi_exact``'s paths byte for byte."""
    S, T, V = 6, 3, 7
    tables = _sticky(rng, S, T, V)
    jp, tp = _both(tables)
    syms = [rng.randint(0, V, size=(n, T)).astype(np.uint8)
            for n in LENGTHS]
    Lc = min(CHUNK, max(LENGTHS) - 1)
    _budget(monkeypatch, per, len(syms), S)
    assert tstitch.exact_group_chunks(len(syms), Lc, S) == per
    want = jstitch.viterbi_exact(jp, syms, chunk_len=CHUNK)
    got = tstitch.viterbi_exact(tp, syms, chunk_len=CHUNK)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        assert np.asarray(w).tobytes() == g.tobytes()


@pytest.mark.parametrize("per", GROUPS)
@pytest.mark.parametrize("streams", ["weights", "gauss", "both"])
def test_grouped_exact_with_streams_equals_jax(rng, monkeypatch, per,
                                              streams):
    """The segment-weight and gaussian streams through the grouped sweeps:
    the JAX ``viterbi_exact``'s paths."""
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
    want = jstitch.viterbi_exact(jp, tabs, chunk_len=CHUNK, **kw_j)
    _budget(monkeypatch, per, len(tabs), S)
    got = tstitch.viterbi_exact(tp, tabs, chunk_len=CHUNK, **kw_t)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.tobytes()


def _count_calls(monkeypatch, names):
    """Record (wrapper, rows of its second argument) of each call."""
    calls = []

    def counted(name):
        fn = getattr(ck, name)

        def call(*args):
            calls.append((name, args[1].shape[0]))
            return fn(*args)
        return call

    for name in names:
        monkeypatch.setattr(ck, name, counted(name))
    return calls


EXACT_WRAPPERS = ("viterbi_checkpoints", "viterbi_chunk_values",
                  "viterbi_chunk_pointers", "chunk_entry_map",
                  "chunk_compose", "chunk_chase", "viterbi_carry",
                  "viterbi_backtrace")


def test_exact_launches_two_k3_calls_a_group(rng, monkeypatch):
    """The forward sweep calls the checkpoint mode once a group and the
    recompute the pointer mode once a group (rows: every (table, chunk)
    of the group); the map, the compose and the chase run once a group
    each, and below 240 states no value rows and no backtrace a chunk."""
    S, T, V = 3, 2, 4
    tables = _sticky(rng, S, T, V)
    _, tp = _both(tables)
    syms = [rng.randint(0, V, size=(n, T)).astype(np.uint8)
            for n in (301, 120)]
    calls = _count_calls(monkeypatch, EXACT_WRAPPERS)
    # 300 body positions in chunks of 25: 12 chunks, groups of 5, 5, 2
    _budget(monkeypatch, 5, 2, S, 25)
    got = tstitch.viterbi_exact(tp, syms, chunk_len=25)
    names = [n for n, _ in calls]
    for name in ("viterbi_checkpoints", "viterbi_chunk_pointers",
                 "chunk_entry_map", "chunk_compose", "chunk_chase"):
        assert names.count(name) == 3, name
    for name in ("viterbi_chunk_values", "viterbi_carry",
                 "viterbi_backtrace"):
        assert names.count(name) == 0, name
    for name in ("viterbi_chunk_pointers", "chunk_entry_map",
                 "chunk_chase"):          # the groups in reverse
        assert [rows for n, rows in calls if n == name] == [
            2 * 2, 2 * 5, 2 * 5], name
    assert [rows for n, rows in calls if n == "chunk_compose"] == [2] * 3
    _budget(monkeypatch, 12, 2, S, 25)
    want = tstitch.viterbi_exact(tp, syms, chunk_len=25)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_exact_past_239_states_keeps_the_value_rows(rng, monkeypatch):
    """Past 239 states K3 is the tile's carry mode, which has no pointer
    mode: the backtrace recomputes value rows once a group and walks them
    a chunk a launch, as before, and the paths are the JAX
    ``viterbi_exact``'s."""
    S, T, V = 240, 1, 3
    tables = _sticky(rng, S, T, V)
    jp, tp = _both(tables)
    syms = [rng.randint(0, V, size=(n, T)).astype(np.uint8)
            for n in (25, 12)]
    calls = _count_calls(monkeypatch, EXACT_WRAPPERS)
    # 24 body positions in chunks of 6: 4 chunks, groups of 3 and 1
    _budget(monkeypatch, 3, 2, S, 6)
    got = tstitch.viterbi_exact(tp, syms, chunk_len=6)
    names = [n for n, _ in calls]
    assert names.count("viterbi_checkpoints") == 2
    assert names.count("viterbi_chunk_values") == 2
    assert names.count("viterbi_backtrace") == 4
    for name in ("viterbi_chunk_pointers", "chunk_entry_map",
                 "chunk_compose", "chunk_chase"):
        assert names.count(name) == 0, name
    want = jstitch.viterbi_exact(jp, syms, chunk_len=6)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.tobytes()


def test_default_budget_holds_the_region_in_one_group():
    """At the decode configuration's width (S=10) one table of 1,000,000
    positions in chunks of 4096 is one group: two K3 launches."""
    n_chunks = -(-(1_000_000 - 1) // 4096)
    assert n_chunks == 245
    assert tstitch.exact_group_chunks(1, 4096, 10) >= n_chunks
    # a group's obs and value rows stay under the budget
    per = tstitch.exact_group_chunks(16, 4096, 256)
    assert per == 2
    assert 2 * 4 * 16 * 4096 * 256 * per <= tstitch.EXACT_GROUP_BYTES
    assert tstitch.exact_group_chunks(64, 15_625, 1024) == 1


# ---------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------

@pytest.fixture
def workdir(tmp_path):
    for f in os.listdir(DATA):
        src = os.path.join(DATA, f)
        if os.path.isfile(src):
            shutil.copy(src, tmp_path / f)
    return tmp_path


@pytest.mark.parametrize("per", [1, 4, None])
def test_cli_exact_bed_equals_jax(workdir, monkeypatch, capsys, per):
    """``eval --bed --exact`` writes the JAX CLI's BED, with the default
    budget (one group) and with budgets that cut 24 chunks into groups of
    1 and of 4."""
    model = str(workdir / "m.npz")
    assert jax_train.main([str(workdir / "tracks.xml"),
                           str(workdir / "truth.bed"), model,
                           "--supervised"]) == 0
    S = np.load(model)["log_trans"].shape[0]
    if per is not None:
        _budget(monkeypatch, per, 1, S, 100)
    beds = {}
    for name, cli, extra in (("jax", jax_eval, []),
                             ("port", port_eval, ["--device", "cpu"])):
        out = str(workdir / f"{name}.bed")
        assert cli.main([str(workdir / "tracks.xml"), model,
                         str(workdir / "regions.bed"), "--bed", out,
                         "--exact", "--chunk", "100", *extra]) == 0
        beds[name] = open(out).read()
    capsys.readouterr()
    assert beds["port"] == beds["jax"]


# ---------------------------------------------------------------------
# K3's route by S, launches faked
# ---------------------------------------------------------------------

def _fake_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev:
                        launched.append((name, entry, args[6:])))
    return launched


@pytest.mark.parametrize("S", [1, 10, 32, 33, 239, 240, 1024])
def test_k3_step_by_states(monkeypatch, S):
    """The step is chosen by S alone: registers and shuffles to 32
    states, shared memory to ``sweep_fits``' 239, the tile beyond; each
    mode launches once, the checkpoint mode counted under its own name
    (K5's carry mode once a chunk: to 256 states on its rows kernel, with
    the rows flag, on the cluster tile from 257, with the cluster
    flag)."""
    launched = _fake_card(monkeypatch)
    B, L, chunk = 3, 10, 4
    step = ck.k3_step(S)
    assert step == ("lanes" if S <= 32 else
                    "shared" if S <= 239 else "tile")
    assert (step == "tile") == (not ck.sweep_fits(S))
    args = (torch.zeros((S, S)), torch.zeros((B, L, S)),
            torch.zeros((B, S)), torch.full((B,), L, dtype=torch.int32))
    ck.viterbi_chunk_values(*args)
    ck.viterbi_carry(*args)
    ck.viterbi_checkpoints(*args, chunk)
    if step == "tile":
        flag = 1 if S > 256 else 3
        tile = ("viterbi_chunk_" + ("cluster" if S > 256 else "rows"),
                "tehmm_viterbi_carry_tile")
        assert [x[:2] for x in launched] == [tile] * (2 + 3)
        assert [x[2] for x in launched] == [(B, L, S, flag)] * 2 + \
            [(B, 4, S, flag), (B, 4, S, flag), (B, 2, S, flag)]
    else:
        entry = {"lanes": "tehmm_viterbi_sweep_lanes",
                 "shared": "tehmm_viterbi_sweep_smem"}[step]
        assert launched == [
            ("viterbi_chunk_values", entry, (B, L, S, 0, 0)),
            ("viterbi_chunk_values", entry, (B, L, S, L, 1)),
            ("viterbi_checkpoints", entry, (B, L, S, chunk, 3))]


def test_time_k3_rows(capsys, monkeypatch):
    """``tools.time_k3`` (shapes cut to size): the device line, then a
    reading of each mode and shape, naming the step, and the backtrace
    by both routes (the plain versions here)."""
    from tehmm_tpu_torch.tools import time_k3

    for name, value in (("CHUNK", 8), ("N_CHUNKS", 3), ("RAGGED_ROWS", 5),
                        ("RAGGED_L", 9)):
        monkeypatch.setattr(time_k3, name, value)
    assert time_k3.main(["--states", "3", "--reps", "1",
                         "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# device: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    modes = ("recompute", "pointers", "map", "compose", "chase")
    assert [(r["mode"], r["B"], r["L"], r["step"]) for r in rows] == [
        (mode, B, L, "lanes") for B, L in ((1, 8), (3, 8), (5, 9))
        for mode in modes] + [("sweep", 1, 24, "lanes")] + \
        [("backtrace", 1, 24, "lanes")] * 2
    assert [r.get("route") for r in rows[-2:]] == ["values", "pointers"]
    for r in rows:
        assert r["ms"] > 0 and r["us_per_step"] == r["ms"] * 1e3 / r["L"]
    assert ck.k3_step(3) == "lanes"
