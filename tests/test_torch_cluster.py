"""The cluster tile of the scans past 256 states on the CPU: its plan
(``cuda_kernels.cluster_plan``, the mirror of csrc/scan_cluster.cuh
``make_cluster_plan``), the route by S (``scan_route``,
``SCAN_CLUSTER_MAX_STATES``) and the launches of ``forward_scaled``,
``backward_scaled``, X1's and X2's carry modes, ``viterbi_values`` (K5),
K3's carry mode, ``viterbi_pointers`` (K8c), ``forward_prob`` (K6a) and
``backward_prob`` (K6b), and ``cuda_v3``'s E-step, faked (no card here).
The kernels themselves are held to the staged
tile bit for bit on the card (tests_cuda/test_cuda_large_s.py,
test_cuda_scans.py); the plain versions past 256 states to the JAX
package in tests/test_torch_scans.py and tests/test_torch_envelopes.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

SMEM_LIMIT = 232448     # bytes a block may opt in to on an H100
R_BYTES = 4             # a state value of one row
H100_SMS = 132


def _active(C):
    """Clusters of C blocks an H100 could hold at one block an SM: a
    stand-in for cudaOccupancyMaxActiveClusters."""
    return lambda R, smem: H100_SMS // C


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B", [1, 4, 64, 128, 1000])
def test_plan_fits_every_state_count(B, backward):
    """From 257 to 1024 states: C = ceil(S / 64) blocks of Sc <= 64
    states (a multiple of 4: a block's part of the state vector is whole
    16-byte pieces) cover S, the last block at least one; the slice's rows
    split into shared memory (a multiple of 4) and registers (at most 64
    a thread, 80 at 12 rows) to S & ~3; the shared memory fits a block's
    227 KB; R is the fewest rows whose clusters fit in one wave, else the
    most."""
    for S in range(257, 1025):
        C = -(-S // 64)
        active = H100_SMS // C
        plan = ck.cluster_plan(S, B, backward, _active(C))
        assert plan["C"] == C <= 16
        assert plan["Sc"] == (-(-S // C) + 3) // 4 * 4 <= 64
        assert plan["Sc"] * R_BYTES % 16 == 0
        assert C * plan["Sc"] >= S > (C - 1) * plan["Sc"]
        assert plan["n_res"] % 4 == 0
        assert plan["n_res"] + plan["n_reg"] == S & ~3
        assert 0 <= plan["n_reg"] <= (320 if plan["R"] == 12 else 256)
        assert plan["smem"] <= SMEM_LIMIT
        R = plan["R"]
        assert plan["clusters"] == -(-B // R)
        fits = [r for r in (1, 2, 4, 8, 12) if -(-B // r) <= active]
        assert R == (fits[0] if fits else 12), (S, B)
        # the state vectors, the slice and the maxima in the bytes
        n_max = 2 if backward else 1
        floats = 8 + C * plan["Sc"] * R + plan["n_res"] * plan["Sc"] \
            + (S & 3) * plan["Sc"] + 8 * R + n_max * C * R + R + 1
        assert plan["smem"] == 4 * floats


@pytest.mark.parametrize("S,n_reg", [(768, 0), (800, 0), (1000, 224),
                                     (1024, 248)])
def test_plan_holds_the_slice_past_shared_memory_in_registers(S, n_reg):
    """Eight rows a cluster: to about 800 states every block's slice sits
    in shared memory beside the state vectors; at 1000 to 1024 the rows
    that do not fit (a quarter) are held in registers."""
    plan = ck.cluster_plan(S, 64, False, _active(-(-S // 64)))
    assert plan["R"] == 8 and plan["n_reg"] == n_reg


def test_plan_takes_the_most_rows_past_one_wave_and_raises_without_one():
    plan = ck.cluster_plan(1024, 10_000, True, lambda R, smem: 8)
    assert plan["R"] == 12 and plan["clusters"] == 834
    # the S1024 bench shape, 64 rows, in the 7 clusters of 16 an H100
    # holds: 12 rows a cluster, one wave
    plan = ck.cluster_plan(1024, 64, False, lambda R, smem: 7)
    assert plan["R"] == 12 and plan["clusters"] == 6 and plan["n_reg"] == 316
    # an R the card cannot hold at all is never chosen
    plan = ck.cluster_plan(600, 3, False,
                           lambda R, smem: 0 if R < 4 else 2)
    assert plan["R"] == 4 and plan["clusters"] == 1
    with pytest.raises(RuntimeError, match="no plan"):
        ck.cluster_plan(600, 3, False, lambda R, smem: 0)
    for S in (256, 1025):
        with pytest.raises(ValueError, match="257 to 1024"):
            ck.cluster_plan(S, 3, False, lambda R, smem: 1)


@pytest.mark.parametrize("S,route", [(1, "narrow"), (256, "narrow"),
                                     (257, "cluster"), (1024, "cluster")])
def test_scan_route_by_states(monkeypatch, S, route):
    """The block tile to 256 states, the cluster tile beyond; 0 in
    ``SCAN_CLUSTER_MAX_STATES`` forces the staged tile past 256."""
    assert ck.SCAN_CLUSTER_MAX_STATES == 1024
    assert ck.scan_route(S) == route
    monkeypatch.setattr(ck, "SCAN_CLUSTER_MAX_STATES", 0)
    assert ck.scan_route(S) == ("narrow" if S <= 256 else "staged")


@pytest.mark.parametrize("S,route", [
    (1, "lanes"), (32, "lanes"), (33, "rows"), (239, "rows"), (240, "rows"),
    (256, "rows"), (257, "cluster"), (1024, "cluster")])
def test_log_scan_route_by_states(monkeypatch, S, route):
    """All nine scans over obs: the lanes step to 32 states, the rows
    kernels to 256, the cluster tile beyond (``scan_route``); 0 in
    ``LOG_SCAN_MAX_STATES`` forces the block tile to 256 and leaves the
    cluster tile past it.  K5, K8c and K3's carry mode (past its one-warp
    kernels' 239 states) count under their route's counters, the block
    tile's names where it is forced."""
    assert ck.LOG_SCAN_MAX_STATES == 256
    assert ck.log_scan_route(S) == route
    assert set(ck._LOG_SCAN_COUNTERS) == set(ck._CLUSTER_COUNTERS)
    viterbi = ["viterbi_values", "viterbi_ptrs"] + (
        [] if ck.sweep_fits(S) else ["viterbi_chunk_tile"])
    own = {"lanes": "_lanes", "rows": "_rows", "cluster": "_cluster"}[route]
    for name in viterbi:
        want = name.replace("_tile", "") + own
        assert ck.scan_counter(name, S) == want
        assert want in ck.LAUNCHES
    monkeypatch.setattr(ck, "LOG_SCAN_MAX_STATES", 0)
    assert ck.log_scan_route(S) == ("narrow" if S <= 256 else "cluster")
    for name in viterbi:
        assert ck.scan_counter(name, S) == (
            name if S <= 256 else ck._CLUSTER_COUNTERS[name])
    monkeypatch.setattr(ck, "SCAN_CLUSTER_MAX_STATES", 0)
    assert ck.log_scan_route(S) == ("narrow" if S <= 256 else "staged")
    assert all(ck.scan_counter(name, S) == name for name in viterbi)


@pytest.mark.parametrize("S,forced,name,want", [
    (20, False, "fwd_scaled", "fwd_scaled_lanes"),
    (32, False, "bwd_scaled", "bwd_scaled_lanes"),
    (33, False, "fwd_scaled", "fwd_scaled_rows"),
    (256, False, "bwd_scaled", "bwd_scaled_rows"),
    (240, False, "fwd_chunk_tile", "fwd_chunk_rows"),
    (256, False, "bwd_chunk_tile", "bwd_chunk_rows"),
    (64, True, "fwd_scaled", "fwd_scaled"),
    (20, True, "bwd_scaled", "bwd_scaled"),
    (256, True, "fwd_chunk_tile", "fwd_chunk_tile"),
    (257, False, "fwd_scaled", "fwd_scaled_cluster"),
    (257, True, "bwd_chunk_tile", "bwd_chunk_cluster"),
    (256, False, "fwd_prob", "fwd_prob_rows"),
    (20, False, "fwd_prob", "fwd_prob_lanes"),
    (32, False, "bwd_prob", "bwd_prob_lanes"),
    (33, False, "bwd_prob", "bwd_prob_rows"),
    (64, True, "fwd_prob", "fwd_prob"),
    (256, True, "bwd_prob", "bwd_prob"),
    (257, False, "bwd_prob", "bwd_prob_cluster"),
    (240, False, "viterbi_chunk_tile", "viterbi_chunk_rows"),
    (256, False, "viterbi_chunk_tile", "viterbi_chunk_rows"),
    (240, True, "viterbi_chunk_tile", "viterbi_chunk_tile"),
    (20, False, "viterbi_values", "viterbi_values_lanes"),
    (32, False, "viterbi_ptrs", "viterbi_ptrs_lanes"),
    (33, False, "viterbi_values", "viterbi_values_rows"),
    (256, False, "viterbi_ptrs", "viterbi_ptrs_rows"),
    (20, True, "viterbi_values", "viterbi_values"),
    (128, True, "viterbi_ptrs", "viterbi_ptrs"),
    (257, False, "viterbi_values", "viterbi_values_cluster"),
    (512, False, "viterbi_ptrs", "viterbi_ptrs_cluster")])
def test_scan_counter_by_route(monkeypatch, S, forced, name, want):
    """Each route counts under a name of its own: the lanes step and rows
    kernels of the log-space scans, of K6a/K6b and of K5, K8c and K3's
    carry mode, the block tile (forced) under the scan's own name, the
    cluster tile under its counter; every name is one of ``LAUNCHES``."""
    if forced:
        monkeypatch.setattr(ck, "LOG_SCAN_MAX_STATES", 0)
    assert ck.scan_counter(name, S) == want
    assert want in ck.LAUNCHES


def test_tile_flags_are_the_c_enum():
    """``_TILE_FLAGS`` holds csrc/scan_tile.cuh's ``ScanTile`` numbers: the
    block tile (and its staged form), the cluster tile, the lanes step,
    the rows kernels."""
    import os
    import re

    with open(os.path.join(os.path.dirname(ck.__file__), os.pardir, "csrc",
                           "scan_tile.cuh")) as fh:
        text = fh.read()
    body = re.search(r"enum ScanTile : int \{(.*?)\};", text, re.S).group(1)
    enum = {k: int(v) for k, v in re.findall(r"kTile(\w+) = (\d+)", body)}
    assert enum == {"Block": 0, "Cluster": 1, "Lanes": 2, "Rows": 3}
    assert ck._TILE_FLAGS == {
        "narrow": enum["Block"], "staged": enum["Block"],
        "cluster": enum["Cluster"], "lanes": enum["Lanes"],
        "rows": enum["Rows"]}


def test_rows_plan_kinds_are_the_c_entries():
    """``ROWS_PLAN_KINDS`` is the order of ``tehmm_rows_plan``'s kinds:
    scans.cu's two log-space rows kernels, streaming.cu's K6a and K6b,
    streaming.cu's K5 (and K3's carry mode), scans.cu's K8c, each the rows
    kernel of its block tile's counter."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(ck.__file__), os.pardir, "csrc")
    kinds = {}
    for name in ("scans.cu", "streaming.cu"):
        with open(os.path.join(csrc, name)) as fh:
            text = fh.read()
        kinds.update((int(k), v) for k, v in re.findall(
            r"if \(kind == (\d)\) \{\s*ROWS_KERNELS\(ks, (\w+)_rows_kernel\)",
            text))
    assert kinds == {0: "fwd_scaled", 1: "bwd_scaled", 2: "fwd_prob",
                     3: "bwd_prob", 4: "viterbi_values", 5: "viterbi_ptrs"}
    assert ck.ROWS_PLAN_KINDS == tuple(kinds[k] for k in range(6))
    assert all(ck._LOG_SCAN_COUNTERS[k]["rows"] == k + "_rows"
               for k in ck.ROWS_PLAN_KINDS)


@pytest.mark.parametrize("kernel,kind", [
    ("fwd_scaled", 0), ("bwd_scaled", 1), ("fwd_prob", 2), ("bwd_prob", 3),
    ("viterbi_values", 4), ("viterbi_ptrs", 5), (False, 0), (True, 1),
    (3, 3)])
def test_library_rows_plan_asks_for_its_kind(monkeypatch, kernel, kind):
    """``library_rows_plan`` hands the C entry the kind of the kernel it
    is named (or its index; a bool the log-space backward or forward) and
    reads the plan back (the library faked)."""
    asked = []

    class FakeLib:
        def tehmm_rows_plan(self, S, B, k, out):
            asked.append((S, B, k))
            for i, v in enumerate((2, 16, 128, 132, 8, 6, 3, 65536)):
                out[i] = v
            return 0

    monkeypatch.setattr(ck, "load_library", FakeLib)
    assert ck.library_rows_plan(100, 700, kernel) == dict(
        R=2, KR=16, threads=128, sms=132, per_sm={1: 8, 2: 6, 4: 3},
        smem=65536)
    assert asked == [(100, 700, kind)]


def _fake_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev:
                        launched.append((name, entry, args[-1])))
    return launched


@pytest.mark.parametrize("force_staged", [False, True])
@pytest.mark.parametrize("S", [10, 256, 257, 640, 1024])
def test_launches_are_counted_by_tile(monkeypatch, S, force_staged):
    """Each of the six entries launches once a call (X1's and X2's
    checkpoint modes past 239 states once a chunk), with the cluster flag
    and under the cluster tile's own counter from 257 states, under the
    block tile's counter below and where the staged tile is forced; to 256
    states the four log-space scans and K6a/K6b with the flag of their own
    kernels (2 the lanes step to 32 states, 3 the rows kernels beyond),
    each under a counter of its own."""
    launched = _fake_card(monkeypatch)
    if force_staged:
        monkeypatch.setattr(ck, "SCAN_CLUSTER_MAX_STATES", 0)
    B, L, chunk = 3, 10, 4
    lt, ls = torch.zeros((S, S)), torch.zeros(S)
    obs, carry = torch.zeros((B, L, S)), torch.zeros((B, S))
    lens = torch.full((B,), L, dtype=torch.int32)
    cont = torch.ones(B, dtype=torch.bool)
    ck.forward_scaled(ls, lt, obs, lens)
    ck.backward_scaled(lt, obs, lens)
    ck.forward_prob(ls, lt, obs, lens)
    ck.backward_prob(lt, obs, lens)
    cluster = int(S > 256 and not force_staged)
    suffix = ("_cluster", "_cluster") if cluster else ("", "_tile")
    log = cluster if S > 256 else (2 if S <= 32 else 3)
    own = "_lanes" if S <= 32 else "_rows"
    scaled, carried = suffix if S > 256 else (own, own)
    want = [("fwd_scaled" + scaled, "tehmm_fwd_scaled", log),
            ("bwd_scaled" + scaled, "tehmm_bwd_scaled", log),
            ("fwd_prob" + scaled, "tehmm_fwd_prob", log),
            ("bwd_prob" + scaled, "tehmm_bwd_prob", log)]
    if not ck.sweep_fits(S):
        ck.forward_chunk_values(lt, obs, carry, lens)
        ck.forward_checkpoints(lt, obs, carry, lens, chunk)
        ck.backward_chunk_values(lt, obs, carry, cont, lens)
        ck.backward_checkpoints(lt, obs, carry, cont, lens, chunk)
        fwd = ("fwd_chunk" + carried, "tehmm_fwd_chunk_tile", log)
        bwd = ("bwd_chunk" + carried, "tehmm_bwd_chunk_tile", log)
        want += [fwd] * (1 + 3) + [bwd] * (1 + 3)
    assert launched == want


@pytest.mark.parametrize("force", [None, "tile"])
@pytest.mark.parametrize("S", [10, 32, 33, 240, 256])
def test_log_scans_take_their_own_kernels_to_256_states(monkeypatch, S,
                                                         force):
    """To 256 states the four log-space scans and K6a/K6b launch with the
    tile flag of their route (2 the lanes step, 3 the rows kernels, 0 the
    block tile where ``LOG_SCAN_MAX_STATES`` forces it), each under the
    route's own counter (the block tile's where forced)."""
    launched = _fake_card(monkeypatch)
    if force:
        monkeypatch.setattr(ck, "LOG_SCAN_MAX_STATES", 0)
    B, L = 3, 10
    lt, ls = torch.zeros((S, S)), torch.zeros(S)
    obs, carry = torch.zeros((B, L, S)), torch.zeros((B, S))
    lens = torch.full((B,), L, dtype=torch.int32)
    cont = torch.ones(B, dtype=torch.bool)
    ck.forward_scaled(ls, lt, obs, lens)
    ck.backward_scaled(lt, obs, lens)
    ck.forward_prob(ls, lt, obs, lens)
    ck.backward_prob(lt, obs, lens)
    if S >= 240:
        ck.forward_chunk_values(lt, obs, carry, lens)
        ck.backward_chunk_values(lt, obs, carry, cont, lens)
    if force:
        flag, own, chunk = 0, "", "_tile"
    else:
        flag, own = (2, "_lanes") if S <= 32 else (3, "_rows")
        chunk = own
    want = [("fwd_scaled" + own, "tehmm_fwd_scaled", flag),
            ("bwd_scaled" + own, "tehmm_bwd_scaled", flag),
            ("fwd_prob" + own, "tehmm_fwd_prob", flag),
            ("bwd_prob" + own, "tehmm_bwd_prob", flag)]
    if S >= 240:
        want += [("fwd_chunk" + chunk, "tehmm_fwd_chunk_tile", flag),
                 ("bwd_chunk" + chunk, "tehmm_bwd_chunk_tile", flag)]
    assert launched == want


def test_the_log_scan_constants_are_restored():
    """Tests and tools set ``LOG_SCAN_MAX_STATES`` and restore it, after a
    failure too."""
    from tehmm_tpu_torch.tools import time_scans

    with time_scans.block_tile():
        assert ck.LOG_SCAN_MAX_STATES == 0
        assert ck.log_scan_route(64) == "narrow"
    assert ck.LOG_SCAN_MAX_STATES == 256
    with pytest.raises(KeyError):
        with time_scans.block_tile():
            raise KeyError("a failed run")
    assert ck.LOG_SCAN_MAX_STATES == 256


def test_the_forcing_constant_is_restored(monkeypatch):
    """Tests and tools set ``SCAN_CLUSTER_MAX_STATES`` and restore it."""
    from tehmm_tpu_torch.tools import time_scans

    with time_scans.staged_tile():
        assert ck.SCAN_CLUSTER_MAX_STATES == 0
        assert ck.scan_route(1024) == "staged"
    assert ck.SCAN_CLUSTER_MAX_STATES == 1024
    with pytest.raises(KeyError):
        with time_scans.staged_tile():
            raise KeyError("a failed run")
    assert ck.SCAN_CLUSTER_MAX_STATES == 1024


def test_time_scans_sweep_rows(capsys):
    """``tools.time_scans --sweeps``: one row an S with K3's, X1's and
    X2's carry modes, each with its us a step and again with the staged
    tile forced (the plain versions here); the constant is restored."""
    import json

    from tehmm_tpu_torch.tools import time_scans

    assert time_scans.main(["--configs", "", "--sweeps", "260", "--device",
                            "cpu", "--reps", "1", "--sweep-rows", "2",
                            "--sweep-length", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# device: cpu"
    (row,) = [json.loads(line) for line in out[1:]]
    assert (row["sweep"], row["B"], row["L"]) == (260, 2, 5)
    for k in ("X1", "X2", "K3"):
        assert row[k] > 0 and row[k + "_staged"] > 0
        assert row[k + "_us"] == pytest.approx(row[k] * 1e3 / 5)
        assert row[k + "_staged_us"] == pytest.approx(
            row[k + "_staged"] * 1e3 / 5)
    assert ck.SCAN_CLUSTER_MAX_STATES == 1024


VITERBI_COUNTERS = {"viterbi_values": "viterbi_values_cluster",
                    "viterbi_chunk_tile": "viterbi_chunk_cluster",
                    "viterbi_ptrs": "viterbi_ptrs_cluster"}


@pytest.mark.parametrize("force", [None, "staged", "block"])
@pytest.mark.parametrize("S", [10, 240, 256, 257, 640, 1024])
def test_viterbi_launches_are_counted_by_tile(monkeypatch, S, force):
    """K5, K3's carry mode (values, carry and checkpoints: once a chunk)
    and K8c launch with the ``tile`` flag of their route and under its
    counters: to 32 states the lanes step (2, ``*_lanes``), to 256 the
    rows kernels (3, ``*_rows``; K3's carry mode only from 240 states,
    ``viterbi_chunk_rows``: below, K3 takes its one-warp kernels), from
    257 the cluster tile (1, ``*_cluster``); the block tile (0, the
    scans' own names) to 256 states where ``LOG_SCAN_MAX_STATES`` is 0,
    and the staged tile (0) past 256 where ``SCAN_CLUSTER_MAX_STATES``
    is."""
    launched = _fake_card(monkeypatch)
    if force == "staged":
        monkeypatch.setattr(ck, "SCAN_CLUSTER_MAX_STATES", 0)
    if force == "block":
        monkeypatch.setattr(ck, "LOG_SCAN_MAX_STATES", 0)
    B, L, chunk = 3, 10, 4
    lt, ls = torch.zeros((S, S)), torch.zeros(S)
    obs, carry = torch.zeros((B, L, S)), torch.zeros((B, S))
    lens = torch.full((B,), L, dtype=torch.int32)
    ck.viterbi_values(ls, lt, obs, lens)
    ck.viterbi_pointers(ls, lt, obs, lens)
    if S > 256:
        flag, own = (0, "") if force == "staged" else (1, "_cluster")
    elif force == "block":
        flag, own = 0, ""
    else:
        flag, own = (2, "_lanes") if S <= 32 else (3, "_rows")

    def name(k):
        return k if not own else k.replace("_tile", "") + own

    want = [(name("viterbi_values"), "tehmm_viterbi_values", flag),
            (name("viterbi_ptrs"), "tehmm_viterbi_ptrs", flag)]
    if not ck.sweep_fits(S):
        ck.viterbi_chunk_values(lt, obs, carry, lens)
        ck.viterbi_carry(lt, obs, carry, lens)
        ck.viterbi_checkpoints(lt, obs, carry, lens, chunk)
        want += [(name("viterbi_chunk_tile"), "tehmm_viterbi_carry_tile",
                  flag)] * (2 + 3)
    assert launched == want
    assert set(VITERBI_COUNTERS.values()) <= set(ck.LAUNCHES)
    assert {k: ck._CLUSTER_COUNTERS[k] for k in VITERBI_COUNTERS} \
        == VITERBI_COUNTERS


@pytest.mark.parametrize("B", [1, 4, 64, 128, 1000])
def test_viterbi_plans_are_the_forwards(B):
    """K5 (with K3's carry mode) and K8c keep one max buffer and the
    forward's register rows: from 257 to 1024 states their plans are
    K7a's, given the same active clusters; a bool still names the
    forward or the backward."""
    assert ck.CLUSTER_PLAN_KINDS == ("fwd_scaled", "bwd_scaled",
                                     "viterbi_values", "viterbi_ptrs",
                                     "fwd_prob", "bwd_prob")
    assert [ck._plan_kind(k) for k in (False, True) + ck.CLUSTER_PLAN_KINDS] \
        == [0, 1, 0, 1, 2, 3, 4, 5]
    for S in range(257, 1025):
        active = _active(-(-S // 64))
        want = ck.cluster_plan(S, B, False, active)
        assert ck.cluster_plan(S, B, "fwd_scaled", active) == want
        for kernel in ("viterbi_values", "viterbi_ptrs"):
            assert ck.cluster_plan(S, B, kernel, active) == want, (S, kernel)
    assert ck.cluster_plan(1024, B, "bwd_scaled", _active(16)) \
        == ck.cluster_plan(1024, B, True, _active(16))


def test_time_scans_times_the_viterbi_kernels_both_ways(monkeypatch,
                                                         capsys):
    """``tools.time_scans`` past 256 states: K5 and K8c beside K7a and
    K7b, each timed again with the staged tile forced (the plain versions
    here); the constant is restored."""
    import json

    from tehmm_tpu_torch.tools import bench_engines, time_scans

    monkeypatch.setitem(bench_engines.CONFIGS, "tiny260", (260, 1, 3, 2, 4))
    assert time_scans.main(["--configs", "tiny260", "--device", "cpu",
                            "--reps", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    (row,) = [json.loads(line) for line in out[1:]]
    assert (row["S"], row["B"], row["L"]) == (260, 2, 4)
    for k in ("K5", "K6a", "K6b", "K7a", "K7b", "K8c"):
        assert row[k] > 0 and row[k + "_staged"] > 0
        assert row[k + "_us"] == pytest.approx(row[k] * 1e3 / 4)
    assert "plans" not in row            # the card's plans: none here
    assert ck.SCAN_CLUSTER_MAX_STATES == 1024


PROB_COUNTERS = {"fwd_prob": "fwd_prob_cluster",
                 "bwd_prob": "bwd_prob_cluster"}


@pytest.mark.parametrize("B", [1, 4, 64, 128, 1000])
def test_prob_plans_are_the_log_space_scans(B):
    """K6a keeps one max buffer, K6b two (its step's two row maxima, each
    with its own buffer and mbarrier): from 257 to 1024 states their plans
    are K7a's and K7b's, given the same active clusters, and K6b's shared
    memory is K6a's plus one more buffer of the cluster's C x R partial
    maxima wherever both take the same rows."""
    assert {k: ck._CLUSTER_COUNTERS[k] for k in PROB_COUNTERS} \
        == PROB_COUNTERS
    assert set(PROB_COUNTERS.values()) <= set(ck.LAUNCHES)
    for S in range(257, 1025):
        active = _active(-(-S // 64))
        fwd = ck.cluster_plan(S, B, "fwd_prob", active)
        bwd = ck.cluster_plan(S, B, "bwd_prob", active)
        assert fwd == ck.cluster_plan(S, B, "fwd_scaled", active), S
        assert bwd == ck.cluster_plan(S, B, "bwd_scaled", active), S
        if fwd["R"] == bwd["R"] and fwd["n_res"] == bwd["n_res"]:
            assert bwd["smem"] - fwd["smem"] == 4 * fwd["C"] * fwd["R"]


@pytest.mark.parametrize("force_staged", [False, True])
@pytest.mark.parametrize("S", [10, 256, 257, 1024])
def test_cuda_v3_estep_launches_k6_by_tile(monkeypatch, S, force_staged):
    """The E-step engine ``cuda_v3`` (what ``"auto"`` takes past K1's
    envelope) launches K6a and K6b once each a pass: on the cluster tile
    from 257 states, the staged tile where it is forced past 256, the
    lanes step to 32 states and the rows kernels to 256 (launches faked,
    the plain version's results in their place)."""
    from tehmm_tpu_torch.models.params import HmmParams
    from tehmm_tpu_torch.ops import em

    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")

    def fake(name, entry, args, dev):
        launched.append((name, entry, args[-1]))
    monkeypatch.setattr(ck, "_launch_streaming", fake)
    if force_staged:
        monkeypatch.setattr(ck, "SCAN_CLUSTER_MAX_STATES", 0)
    B, L = 2, 5
    p = HmmParams(torch.full((S,), -float(np.log(S))),
                  torch.full((S, S), -float(np.log(S))),
                  torch.full((S, 2, 3), -float(np.log(3))))
    sym = torch.ones((B, L, 2), dtype=torch.int32)
    lens = torch.full((B,), L, dtype=torch.int32)
    em.em_sufficient_stats(p, sym, lens, engine="cuda_v3")
    cluster = int(S > 256 and not force_staged)
    suffix, flag = ("_cluster" if cluster else "", cluster)
    if S <= 256:
        suffix, flag = ("_lanes", 2) if S <= 32 else ("_rows", 3)
    assert launched == [("fwd_prob" + suffix, "tehmm_fwd_prob", flag),
                        ("bwd_prob" + suffix, "tehmm_bwd_prob", flag)]


@pytest.mark.parametrize("S", [10, 256])
def test_cuda_v3_estep_block_tile_forced(monkeypatch, S):
    """With ``LOG_SCAN_MAX_STATES`` = 0 the ``cuda_v3`` E-step launches
    the block tile's K6a and K6b to 256 states, under their own names
    and with flag 0 (launches faked)."""
    from tehmm_tpu_torch.models.params import HmmParams
    from tehmm_tpu_torch.ops import em

    launched = _fake_card(monkeypatch)
    monkeypatch.setattr(ck, "LOG_SCAN_MAX_STATES", 0)
    B, L = 2, 5
    p = HmmParams(torch.full((S,), -float(np.log(S))),
                  torch.full((S, S), -float(np.log(S))),
                  torch.full((S, 2, 3), -float(np.log(3))))
    sym = torch.ones((B, L, 2), dtype=torch.int32)
    lens = torch.full((B,), L, dtype=torch.int32)
    em.em_sufficient_stats(p, sym, lens, engine="cuda_v3")
    assert launched == [("fwd_prob", "tehmm_fwd_prob", 0),
                        ("bwd_prob", "tehmm_bwd_prob", 0)]
