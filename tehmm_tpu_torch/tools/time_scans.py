"""Times the scan tile's kernels alone, on ``bench_engines``' shapes.

    python -m tehmm_tpu_torch.tools.time_scans [--configs S20,S64]
        [--batch B] [--sweeps 512,1024] [--sweep-rows 4]
        [--sweep-length 4096] [--backtraces 128x4608x1024]
        [--reps 5] [--device cuda|cpu]

K5 (``viterbi_values``), K6a/K6b (``forward_prob``, ``backward_prob``),
K7a/K7b (``forward_scaled``, ``backward_scaled``) and K8c
(``viterbi_pointers``) on the obs tensor of each ``bench_engines.CONFIGS``
shape (every row full length; ``--batch`` replaces the shape's rows, to
reach the tile's other row choice), and ``bt``, the value-row backtrace
(``viterbi_backtrace``) on K5's rows as ``dp.viterbi_streaming`` passes
them, with ``bt_us`` its microseconds a step; ``--backtraces`` times it
alone at B x L x S points on K5's rows of a sticky random model.  Past
256 states all six run the cluster tile, and are timed again with the staged wide tile forced
(``K5_staged``, ``K6a_staged``, ``K6b_staged``, ``K7a_staged``,
``K7b_staged``, ``K8c_staged``: ``cuda_kernels.SCAN_CLUSTER_MAX_STATES``
set to 0, then restored).  To 256 states all six run their own kernels
(``cuda_kernels.log_scan_route``: the lanes step, the rows kernels) and
are timed again with the block tile forced (``K5_tile``, ``K6a_tile``,
``K6b_tile``, ``K7a_tile``, ``K7b_tile``, ``K8c_tile``:
``cuda_kernels.LOG_SCAN_MAX_STATES`` set to 0, then restored).
``--sweeps`` times K3's, X1's and X2's carry modes
(``viterbi_chunk_values``, ``forward_chunk_values``,
``backward_chunk_values``) at each S on ``--sweep-rows`` full rows of
``--sweep-length`` (3f's ``--exact``, ``--pd`` and score shapes), the
same two ways past 256 states, and from 240 to 256 (past K3's, X1's and
X2's one-warp kernels) with the block tile forced too (``K3_tile``,
``X1_tile``, ``X2_tile``).  On the card a row past 256 states has each
timed kernel's cluster plan (``plans``, where the checkout's
``cuda_kernels.CLUSTER_PLAN_KINDS`` has its kind), and one from 33 to
256 the rows a block each kernel took where it ran the rows kernels
(``rows_R``, ``cuda_kernels.library_rows_plan``).  Each kernel's
``*_us`` is its microseconds a step (a position).  The first line names the device;
then one JSON object a shape: the shape and each kernel's median ms of
``reps`` synchronised calls.  It uses nothing but the wrappers and
``bench_engines``' inputs, so the same file times an older checkout of
the port for a comparison in one process each (where the checkout has no
cluster tile, no ``_staged`` keys are written, and without the log-space
scans' own kernels no ``_tile`` keys; where it runs a scan on the block
tile, its ``_tile`` key times that tile twice).  On the CPU
each wrapper runs its plain version: the lines then time nothing of the
card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from tehmm_tpu_torch.models.emission import track_log_likelihoods
from tehmm_tpu_torch.models.params import from_numpy
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.ops import dp
from tehmm_tpu_torch.tools import bench_engines
from tehmm_tpu_torch.utils.device import resolve_device


def median_ms(fn, device, reps):
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


@contextlib.contextmanager
def staged_tile():
    """The staged wide tile forced for the cluster scans past 256
    states (``SCAN_CLUSTER_MAX_STATES`` = 0), restored after; nothing in a
    checkout without the cluster tile."""
    old = getattr(ck, "SCAN_CLUSTER_MAX_STATES", None)
    if old is not None:
        ck.SCAN_CLUSTER_MAX_STATES = 0
    try:
        yield
    finally:
        if old is not None:
            ck.SCAN_CLUSTER_MAX_STATES = old


@contextlib.contextmanager
def block_tile():
    """The block tile forced for the scans with their own kernels to 256
    states (``LOG_SCAN_MAX_STATES`` = 0), restored after; nothing in a
    checkout without them."""
    old = getattr(ck, "LOG_SCAN_MAX_STATES", None)
    if old is not None:
        ck.LOG_SCAN_MAX_STATES = 0
    try:
        yield
    finally:
        if old is not None:
            ck.LOG_SCAN_MAX_STATES = old


# the cluster plan kind of each kernel the tool times (the carry modes
# run their scan's kernel), which is also the rows plan kind of those with
# rows kernels, and the block tile's counter of each of those
PLAN_KINDS = {"K5": "viterbi_values", "K6a": "fwd_prob", "K6b": "bwd_prob",
              "K7a": "fwd_scaled", "K7b": "bwd_scaled", "K8c": "viterbi_ptrs",
              "X1": "fwd_scaled", "X2": "bwd_scaled", "K3": "viterbi_values"}
COUNTERS = {"K5": "viterbi_values", "K6a": "fwd_prob", "K6b": "bwd_prob",
            "K7a": "fwd_scaled", "K7b": "bwd_scaled", "K8c": "viterbi_ptrs",
            "X1": "fwd_chunk_tile", "X2": "bwd_chunk_tile",
            "K3": "viterbi_chunk_tile"}
# the rows plan kinds of a checkout whose ``library_rows_plan`` takes a
# bool (the log-space backward or forward)
_LOG_ROWS_KINDS = ("fwd_scaled", "bwd_scaled")


def _rows_R(S, B, names):
    """The rows a block each of ``names`` took at S states and B rows,
    for those whose launch ran the rows kernels (``scan_counter``), by
    the index of its kind in the checkout's ``ROWS_PLAN_KINDS``."""
    kinds = getattr(ck, "ROWS_PLAN_KINDS", _LOG_ROWS_KINDS)
    return {name: ck.library_rows_plan(
                S, B, kinds.index(PLAN_KINDS[name]))["R"]
            for name in names
            if ck.scan_counter(COUNTERS[name], S).endswith("_rows")}


def _time(row, calls, device, reps, L, staged, tile=()):
    """Each call's median ms into ``row`` (and its us a step for those
    named in ``staged`` or ``tile``), then again with the staged tile
    forced for those in ``staged``, under ``name_staged``, where the
    checkout has the cluster tile, and with the block tile forced for those
    in ``tile``, under ``name_tile``, where it has the log-space scans' own
    kernels; on the card then also each of the ``staged`` kernels'
    cluster plan (rows and clusters, and the clusters the card holds at
    each R) where the checkout has its kind, and the rows a block each of
    the ``tile`` kernels took where it ran the rows kernels (``rows_R``)."""
    for name, fn in calls.items():
        fn()  # the first call builds and opts in to shared memory
        row[name] = median_ms(fn, device, reps)
    S = row.get("S", row.get("sweep"))
    if tile and device.type == "cuda" and hasattr(ck, "library_rows_plan"):
        row["rows_R"] = _rows_R(S, row["B"], tile)
    if hasattr(ck, "LOG_SCAN_MAX_STATES"):
        for name in tile:
            row[name + "_us"] = row[name] * 1e3 / L
            with block_tile():
                calls[name]()
                row[name + "_tile"] = median_ms(calls[name], device, reps)
            row[name + "_tile_us"] = row[name + "_tile"] * 1e3 / L
    has_cluster = hasattr(ck, "SCAN_CLUSTER_MAX_STATES")
    if staged and has_cluster and device.type == "cuda":
        kinds = getattr(ck, "CLUSTER_PLAN_KINDS", ())
        row["plans"] = {
            name: ck.library_cluster_plan(S, row["B"], PLAN_KINDS[name])
            for name in staged if PLAN_KINDS.get(name) in kinds}
    for name in staged:
        row[name + "_us"] = row[name] * 1e3 / L
        if has_cluster:
            with staged_tile():
                calls[name]()
                row[name + "_staged"] = median_ms(calls[name], device, reps)
            row[name + "_staged_us"] = row[name + "_staged"] * 1e3 / L
    return row


def time_config(config, batch, device, reps):
    S, T, V, B, L = bench_engines.CONFIGS[config]
    B = batch or B
    p, sym = bench_engines.make_inputs(S, T, V, B, L, device)
    obs = track_log_likelihoods(p.log_em, sym)
    del sym
    obs_p, _ = dp.scaled_obs_prob(obs)
    lens = torch.full((B,), L, dtype=torch.int32, device=device)
    ls, lt = p.log_start, p.log_trans
    calls = {
        "K5": lambda: ck.viterbi_values(ls, lt, obs, lens),
        "K6a": lambda: ck.forward_prob(ls, lt, obs_p, lens),
        "K6b": lambda: ck.backward_prob(lt, obs_p, lens),
        "K7a": lambda: ck.forward_scaled(ls, lt, obs, lens),
        "K7b": lambda: ck.backward_scaled(lt, obs, lens),
        "K8c": lambda: ck.viterbi_pointers(ls, lt, obs, lens),
    }
    staged = tuple(calls) if S > 256 else ()
    tile = ("K5", "K6a", "K6b", "K7a", "K7b", "K8c") if S <= 256 else ()
    calls["bt"] = _backtrace_call(ls, lt, obs, lens)
    row = {"config": config, "S": S, "B": B, "L": L}
    _time(row, calls, device, reps, L, staged, tile)
    row["bt_us"] = row["bt"] * 1e3 / max(L - 1, 1)
    return row


def _backtrace_call(ls, lt, obs, lens):
    """A call of the value-row backtrace as ``dp.viterbi_streaming`` makes
    it, on K5's rows of ``obs`` from the last row's argmax."""
    v, _dm = ck.viterbi_values(ls, lt, obs, lens)
    end = torch.argmax(v[:, -1], dim=-1).to(torch.int32)
    args = (lt, v[:, 1:], v[:, 0], end, lens - 1)
    return lambda: ck.viterbi_backtrace(*args)


def _sticky_inputs(S, B, L, device, T=5, V=9):
    """(params, obs f32[B, L, S], rng) of a sticky random model of T
    tracks of V symbols at S states, its obs from random symbols."""
    rng = np.random.RandomState(S)
    trans = rng.dirichlet(np.ones(S), size=S) * 0.05 + np.eye(S) * 0.95
    log_em = np.zeros((S, T, V))
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    p = from_numpy(np.log(np.full(S, 1.0 / S)), np.log(trans), log_em,
                   device)
    sym = torch.from_numpy(
        rng.randint(0, V, size=(B, L, T)).astype(np.int32)).to(device)
    return p, track_log_likelihoods(p.log_em, sym), rng


def time_sweeps(S, B, L, device, reps):
    """K3's, X1's and X2's carry modes (values) at S states on B full rows
    of L, from a carry (a random row less its max) on the sticky random
    model of ``_sticky_inputs``."""
    p, obs, rng = _sticky_inputs(S, B, L, device)
    init = torch.from_numpy(rng.randn(B, S).astype(np.float32)).to(device)
    init = init - init.amax(dim=-1, keepdim=True)
    lens = torch.full((B,), L, dtype=torch.int32, device=device)
    cont = torch.zeros(B, dtype=torch.bool, device=device)
    lt = p.log_trans
    calls = {
        "X1": lambda: ck.forward_chunk_values(lt, obs, init, lens),
        "X2": lambda: ck.backward_chunk_values(lt, obs, init, cont, lens),
        "K3": lambda: ck.viterbi_chunk_values(lt, obs, init, lens),
    }
    row = {"sweep": S, "B": B, "L": L}
    if S > 256:
        return _time(row, calls, device, reps, L, ("X1", "X2", "K3"))
    # to 256 states the carry modes past their one-warp kernels on the
    # rows kernels
    row = _time(row, calls, device, reps, L, (),
                () if ck.sweep_fits(S) else ("X1", "X2", "K3"))
    for name in calls:
        row[name + "_us"] = row[name] * 1e3 / L
    return row


def time_backtrace(S, B, L, device, reps):
    """The value-row backtrace as ``dp.viterbi_streaming`` calls it, on
    K5's rows of B full rows of L at S states of the sticky random model
    (3f's passes: 128 x 4,608 stitched, 64 x 15,625 exact, at S=1024)."""
    p, obs, _rng = _sticky_inputs(S, B, L, device)
    lens = torch.full((B,), L, dtype=torch.int32, device=device)
    call = _backtrace_call(p.log_start, p.log_trans, obs, lens)
    del obs
    row = {"backtrace": S, "B": B, "L": L}
    _time(row, {"bt": call}, device, reps, L, ())
    row["bt_us"] = row["bt"] * 1e3 / max(L - 1, 1)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="S20,S64,S128,S256")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--sweeps", default="",
                    help="comma-separated S for K3's, X1's and X2's carry "
                         "modes")
    ap.add_argument("--sweep-rows", type=int, default=4)
    ap.add_argument("--sweep-length", type=int, default=4096)
    ap.add_argument("--backtraces", default="",
                    help="comma-separated BxLxS points of the value-row "
                         "backtrace, e.g. 128x4608x1024")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(bench_engines.device_line(device), flush=True)
    for config in filter(None, args.configs.split(",")):
        print(json.dumps(time_config(config, args.batch, device, args.reps)),
              flush=True)
    for S in filter(None, args.sweeps.split(",")):
        print(json.dumps(time_sweeps(int(S), args.sweep_rows,
                                     args.sweep_length, device, args.reps)),
              flush=True)
    for point in filter(None, args.backtraces.split(",")):
        B, L, S = (int(x) for x in point.split("x"))
        print(json.dumps(time_backtrace(S, B, L, device, args.reps)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
