"""The port's CUDA kernels: build, ctypes binding, wrappers.

``csrc/`` holds the hand-written Hopper kernels that replace the TPU
kernels the port's paths reach (see each source's header for what
bounds each on an H100 and how its design answers it):

  ===================== ==============================================
  wrapper               replaces (tehmm_tpu/ops/pallas_kernels.py)
  ===================== ==============================================
  viterbi_fwd           K2 forward, ``_make_viterbi_fwd_kernel_v4``
  (viterbi_fwd_         (``viterbi_fwd_lanes`` counts its lanes kernel;
  pointers)             the pointer mode: first-hit pointers in place
                        of value rows, which ``chunk_chase`` walks as
                        K2's backtrace, ``_viterbi_backtrace_kernel_v4``)
  viterbi_backtrace     a backtrace over value rows: under K5 and the
                        exact decoder past 239 states
  viterbi_chunk_values  K3, ``viterbi_chunk_values_pallas``
  (viterbi_carry,       (the carry mode, and the carries of many chunks
  viterbi_checkpoints,  in one launch: the exact decoder's forward sweep;
  viterbi_chunk_        the pointer mode, first-hit pointers in place of
  pointers)             value rows: the exact decoder's recompute)
  chunk_entry_map       X3: no Pallas kernel; ``dp.viterbi_backtrace_
  chunk_compose         chunk``'s XLA scan a chunk, as the exact
  chunk_chase           decoder's backtrace from K3's pointers: every
                        chunk's map of end states, the maps composed,
                        every chunk chased in parallel
  em_fwd                K1 forward, ``_make_forward_kernel_v4``
  em_bwd_stats          K1 reverse, ``_make_bwd_stats_kernel_v4``
  post_decode           K4 decode, ``_make_post_decode_kernel_v4``
                        (``post_decode_lanes`` counts its lanes kernel)
  forward_chunk_values  X1: no Pallas kernel; the XLA scans of
  (forward_final,       ``dp.forward_chunk_values`` (``dp.forward_final``;
  forward_checkpoints)  the carries of many chunks in one launch: the
                        exact posteriors' forward sweep)
  backward_chunk_values X2: no Pallas kernel; ``dp.backward_chunk_values``
                        (``backward_checkpoints``: the x_carry entering
                        every chunk of a span in one launch, the exact
                        posteriors' backward sweep)
  forward_loglik        X1's carry-only function (``dp.forward_final``)
                        as a piece-operator scan: ``fwd_piece_ops`` then
                        ``fwd_piece_compose``; the score's route
  viterbi_values        K5, ``_viterbi_values_v3(carry_mode=False)`` under
                        ``viterbi_pallas_v3``
  forward_prob          K6a, ``forward_prob_pallas_v3``
  backward_prob         K6b, ``backward_prob_pallas_v3``
  forward_scaled        K7a ``forward_scaled_pallas_v2`` and K8a
                        ``forward_scaled_pallas``
  backward_scaled       K7b ``backward_hat_pallas_v2`` and K8b
                        ``backward_scaled_pallas``
  viterbi_pointers      K8c, ``viterbi_pallas``'s kernel
  pointer_chase         no Pallas kernel: ``viterbi_pallas``'s XLA
                        backtrace over the pointers
  maxplus_sweeps        K9, ``tools/exp_maxplus_s256.py``'s
                        ``_kernel_unrolled`` and ``_kernel_scratch_blocks``
  ===================== ==============================================

``viterbi_fused`` composes K2's forward in pointer mode and
``chunk_chase`` into the symbols-in/path-out decode of
``viterbi_fused_pallas_v4``; ``em_counts_fused`` composes
K1's two into the symbols-in/statistics-out E-step of
``em_counts_fused_pallas_v4``; ``posterior_decode_fused`` composes K1's
forward with the K4 decode into the symbols-in/path-out max-posterior
decode of ``posterior_decode_fused_pallas_v4``.  The seven from
``viterbi_values`` on (``csrc/streaming.cu``, ``csrc/scans.cu``, on the
block tile of ``csrc/scan_tile.cuh``) work on a precomputed observation
tensor and take any S up to 1024 (``STREAMING_MAX_STATES``) whatever T
and V are: they keep the rows' state vectors and the transition matrix,
as far as it fits (past 256 states a block of it at a time), in shared
memory.  ``dp.viterbi_streaming``, ``dp.viterbi_backpointers``, the
E-step engines ``"cuda_v3"`` and ``"cuda_log"`` of ``ops/em.py`` and the
stitched decoders past the fused kernels' envelopes
(``parallel/stitch.py``) are built on them.  ``k1_fits``, ``k2_fits``
and ``k4_fits`` state the fused kernels' envelopes; their wrappers'
checks and the routes ask them.  Inside its envelope K1 runs its lanes
kernels to 32 states and its shared ones beyond (``k1_step``), K2's
forward (``k2_step``) and K4's decode (``k4_step``) their lanes kernel
to 32 states and their shared one beyond, with the same bits either
way.  K3, X1 and X2 launch their one-warp
kernels where ``sweep_fits`` (S <= 239) and the tile's carry modes
beyond, each counted under its own name (``viterbi_chunk_rows``,
``fwd_chunk_rows``, ``bwd_chunk_rows`` to 256 states), so the exact
decoders, ``--pd`` and every printed loglik run to S = 1024 too.  From 257
states the log-space scans (``forward_scaled``, ``backward_scaled`` and X1's
and X2's carry modes), K5, K3's carry mode, K8c and the probability-space scans
K6a and K6b (``forward_prob``, ``backward_prob``) run the cluster
tile of ``csrc/scan_cluster.cuh`` (``scan_route``;
``SCAN_CLUSTER_MAX_STATES`` = 0 forces the staged tile), counted under
``*_cluster`` names, with the same bits.  The printed loglik
(``MultitrackHmm.score``) takes ``forward_loglik``, which splits each
row into pieces where ``piece_scan_route`` says (to
``PIECE_SCAN_MAX_STATES``, and to a number of rows that falls with S)
and takes ``forward_final``'s kernels beyond.  To 256 states all nine
scans over obs (the four log-space scans, ``forward_scaled``,
``backward_scaled`` and X1's and X2's carry modes; the probability-space
scans K6a and K6b, ``forward_prob``, ``backward_prob``; the max-plus
``viterbi_values``, K3's carry mode and ``viterbi_pointers``) take their
own kernels instead of the block tile (``log_scan_route``: the lanes step to 32
states, the rows kernels of ``csrc/scan_rows.cuh`` beyond;
``LOG_SCAN_MAX_STATES`` = 0 forces the block tile), each counted under a name
of its own (``scan_counter``: ``fwd_scaled_lanes``, ``fwd_prob_rows``, ...),
with the same bits.

Each wrapper checks device, dtype, shape and contiguity, and sits beside
its plain-torch version.  A tensor on the CPU takes the plain version; a
CUDA tensor launches the kernel or raises — there is no fallback.  Each
launch adds one to ``LAUNCHES[name]``, so a run can show that its path
went through the kernels.

The fused kernels (``em_fwd``, ``em_bwd_stats``, ``viterbi_fwd``,
``post_decode`` and their compositions) take the JAX signatures' two
optional observation streams, ``obs_weights`` f32[B, L] (segment
weights) and ``gauss_params`` with ``gauss_values`` f32[B, L, G]
(gaussian tracks, NaN missing).  The kernels read them straight from
global memory, the coefficients [c0 | c1 | c2] (``models.gauss.
coeff_table``) from shared memory, and count a launch with streams under
``name+w``, ``name+g`` or ``name+wg``.

The library is built with ``nvcc`` for ``sm_90a`` at first use, into
``build/tehmm_tpu_torch/`` beside the package (keyed by a hash over
every ``csrc/*.cu`` and the ``csrc/*.cuh`` they include): one
``nvcc -c`` per source, all started together, then one link.  It is
loaded with ctypes.  Nothing is built or imported from a CUDA toolchain
when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from tehmm_tpu_torch.models.emission import (
    expected_emission_counts,
    obs_log_likelihoods,
)
from tehmm_tpu_torch.models.gauss import coeff_table, gauss_stats
from tehmm_tpu_torch.ops import dp

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
HEADERS = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tehmm_tpu_torch")

# Launch counts per kernel (plain integers; reset_launch_counts zeroes).
# The kernels with the optional streams count each variant apart.
STREAM_KERNELS = ("viterbi_fwd", "viterbi_fwd_lanes", "em_fwd",
                  "em_bwd_stats", "post_decode", "post_decode_lanes")
STREAM_VARIANTS = ("", "+w", "+g", "+wg")
LAUNCHES = {
    name: 0 for name in (
        [k + v for k in STREAM_KERNELS for v in STREAM_VARIANTS]
        + ["viterbi_backtrace", "viterbi_chunk_values",
           "viterbi_checkpoints", "viterbi_chunk_pointers",
           "chunk_entry_map", "chunk_compose", "chunk_chase",
           "fwd_chunk", "fwd_checkpoints",
           "bwd_chunk", "bwd_checkpoints", "viterbi_values", "fwd_prob",
           "bwd_prob", "fwd_scaled", "bwd_scaled", "viterbi_ptrs",
           "pointer_chase", "viterbi_chunk_tile", "fwd_chunk_tile",
           "bwd_chunk_tile", "fwd_scaled_cluster", "fwd_chunk_cluster",
           "bwd_scaled_cluster", "bwd_chunk_cluster",
           "viterbi_values_cluster", "viterbi_chunk_cluster",
           "viterbi_ptrs_cluster", "fwd_prob_cluster", "bwd_prob_cluster",
           "fwd_scaled_lanes", "fwd_scaled_rows", "bwd_scaled_lanes",
           "bwd_scaled_rows", "fwd_chunk_rows", "bwd_chunk_rows",
           "fwd_prob_lanes", "fwd_prob_rows", "bwd_prob_lanes",
           "bwd_prob_rows", "viterbi_values_lanes", "viterbi_values_rows",
           "viterbi_ptrs_lanes", "viterbi_ptrs_rows", "viterbi_chunk_rows",
           "maxplus_resident", "maxplus_blocks",
           "fwd_piece_ops", "fwd_piece_compose"]
    )
}

# The kernels' envelope: one warp holds a row with up to 8 states per
# lane, and every table lives in one block's shared memory (227 KB
# opt-in on an H100).  Outside it the wrappers raise.
MAX_STATES = 256
_SMEM_LIMIT = 232448
_WARPS_PER_BLOCK = 4            # kWarpsPerBlock in viterbi.cu
_ENVELOPE_ITEM = (
    "ROADMAP Queue 2: K2/K3 beyond the shared-memory envelope"
)
_K1_ENVELOPE_ITEM = (
    "ROADMAP Queue 2: K1 beyond the shared-memory envelope"
)
_POST_ENVELOPE_ITEM = (
    "ROADMAP Queue 2: K4, X1 and X2 beyond the shared-memory envelope"
)
# The block tile of the scans over obs (K5-K8c, and the carry modes of
# K3, X1 and X2): up to 4 states a thread in a block of 256.
STREAMING_MAX_STATES = 1024
_STREAMING_ENVELOPE_ITEM = (
    "ROADMAP Queue 2: the scan tile beyond 1024 states"
)
_TILE_POINTERS_ITEM = "ROADMAP speed item 19: K3's pointer mode on the tile"

# The nine scans over obs past 256 states (K7a/K8a, K7b/K8b and X1's and
# X2's carry modes and K8c, csrc/scans.cu; K5 and K3's carry mode, K6a and
# K6b, csrc/streaming.cu) run the cluster tile (csrc/scan_cluster.cuh)
# from 257 states to this many, and the staged wide tile of
# csrc/scan_tile.cuh beyond it, to 1024.  Both give the same bits, so the
# choice moves only time; 0 forces the staged tile for all nine (tests and
# tools set it and restore it).
SCAN_CLUSTER_MAX_STATES = 1024
# The cluster tile's plan (csrc/scan_cluster.cuh ``make_cluster_plan``):
# a block of 256 threads owns up to 64 states of the cluster's R rows
# (R from _CLUSTER_ROWS), each thread up to _CLUSTER_REG_ROWS[R] slice
# rows in registers.
_CLUSTER_COLS, _CLUSTER_WARPS = 64, 8
_CLUSTER_ROWS = (1, 2, 4, 8, 12)
_CLUSTER_REG_ROWS = {1: 64, 2: 64, 4: 64, 8: 64, 12: 80}
# each cluster scan's counter on the block tile -> on the cluster tile
_CLUSTER_COUNTERS = {"fwd_scaled": "fwd_scaled_cluster",
                     "fwd_chunk_tile": "fwd_chunk_cluster",
                     "bwd_scaled": "bwd_scaled_cluster",
                     "bwd_chunk_tile": "bwd_chunk_cluster",
                     "viterbi_values": "viterbi_values_cluster",
                     "viterbi_chunk_tile": "viterbi_chunk_cluster",
                     "viterbi_ptrs": "viterbi_ptrs_cluster",
                     "fwd_prob": "fwd_prob_cluster",
                     "bwd_prob": "bwd_prob_cluster"}
# the cluster kernels whose plans the card's plan entry gives
# (``tehmm_scan_cluster_plan``'s ``kind``): K7a/K8a (and X1's carry mode),
# K7b/K8b (and X2's), K5 (and K3's carry mode), K8c, K6a, K6b
CLUSTER_PLAN_KINDS = ("fwd_scaled", "bwd_scaled", "viterbi_values",
                      "viterbi_ptrs", "fwd_prob", "bwd_prob")
# the kinds whose step takes two row maxima, each with a buffer of its own
_CLUSTER_TWO_MAXIMA = ("bwd_scaled", "bwd_prob")
# All nine scans over obs (the log-space scans K7a/K8a and K7b/K8b, X1's
# and X2's carry modes, the probability-space scans K6a and K6b, the
# max-plus K5, K3's carry mode and K8c) run their own kernels to this many
# states (csrc/scan_rows.cuh, ``log_scan_route``, a name from the first
# four): the lanes step, a warp a row, to 32 states, the rows kernels
# beyond; past it, to 256 states, the block tile.  All give the same bits,
# so the choice moves only time; 0 forces the block tile for the nine at
# S <= 256 (tests and tools set it and restore it).
LOG_SCAN_MAX_STATES = 256
# each of those scans' counter on the block tile -> on the lanes step and
# on the rows kernels (the carry modes take the tile only past
# ``sweep_fits``' 239 states, so only the rows kernels)
_LOG_SCAN_COUNTERS = {
    "fwd_scaled": {"lanes": "fwd_scaled_lanes", "rows": "fwd_scaled_rows"},
    "bwd_scaled": {"lanes": "bwd_scaled_lanes", "rows": "bwd_scaled_rows"},
    "fwd_chunk_tile": {"rows": "fwd_chunk_rows"},
    "bwd_chunk_tile": {"rows": "bwd_chunk_rows"},
    "fwd_prob": {"lanes": "fwd_prob_lanes", "rows": "fwd_prob_rows"},
    "bwd_prob": {"lanes": "bwd_prob_lanes", "rows": "bwd_prob_rows"},
    "viterbi_values": {"lanes": "viterbi_values_lanes",
                       "rows": "viterbi_values_rows"},
    "viterbi_ptrs": {"lanes": "viterbi_ptrs_lanes",
                     "rows": "viterbi_ptrs_rows"},
    "viterbi_chunk_tile": {"rows": "viterbi_chunk_rows"}}
# the rows kernels whose plans the card's plan entry gives
# (``tehmm_rows_plan``'s ``kind``): K7a/K8a (and X1's carry mode), K7b/K8b
# (and X2's), K6a, K6b, K5 (and K3's carry mode), K8c
ROWS_PLAN_KINDS = ("fwd_scaled", "bwd_scaled", "fwd_prob", "bwd_prob",
                   "viterbi_values", "viterbi_ptrs")
# the nine scans' entries' ``tile`` flag of each route (csrc/scan_tile.cuh
# ``ScanTile``)
_TILE_FLAGS = {"narrow": 0, "staged": 0, "cluster": 1, "lanes": 2,
               "rows": 3}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME; the CUDA kernels "
            "cannot be built"
        )
    return path


def library_path() -> str:
    """Where the build for the current sources goes."""
    digest = hashlib.sha256()
    for src in SOURCES + HEADERS:
        digest.update(os.path.basename(src).encode() + b"\0")
        with open(src, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"tehmm_cuda-{digest.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    """One ``nvcc -c`` per source, run in parallel, then one link; the
    compilers' output (``-Xptxas -v``: registers, shared memory, spills)
    goes to ``<library>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = so_path + f".tmp{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in SOURCES:
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", obj, src,
        ]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    log, failed = [], []
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate(timeout=900)
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{out}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp] + [obj for _c, obj, _p in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n"
                          f"{proc.stderr}")
    for _c, obj, _p in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(so_path + ".log", "w") as fh:
        fh.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so_path)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.tehmm_cuda_error_string.restype = ctypes.c_char_p
        lib.tehmm_cuda_error_string.argtypes = [i32]
        streams = [ptr, ptr, ptr, i32]        # w, values, coef, G
        for fn in (lib.tehmm_viterbi_fwd, lib.tehmm_viterbi_fwd_lanes):
            fn.restype = i32
            fn.argtypes = (
                [ptr] * 7 + [i64, i64, i32, i32, i32] + streams + [ptr])
        for fn in (lib.tehmm_viterbi_fwd_ptrs,
                   lib.tehmm_viterbi_fwd_ptrs_lanes):
            fn.restype = i32
            fn.argtypes = (
                [ptr] * 8 + [i64, i64, i32, i32, i32] + streams + [ptr])
        lib.tehmm_k2_lanes_smem_floats.restype = i64
        lib.tehmm_k2_lanes_smem_floats.argtypes = [i32] * 4
        for fn in (lib.tehmm_viterbi_sweep_lanes,
                   lib.tehmm_viterbi_sweep_smem):
            fn.restype = i32
            fn.argtypes = [ptr] * 6 + [i64, i64, i32, i64, i64, ptr]
        for fn in (lib.tehmm_viterbi_pointers_lanes,
                   lib.tehmm_viterbi_pointers_smem):
            fn.restype = i32
            fn.argtypes = [ptr] * 5 + [i64, i64, i32, ptr]
        lib.tehmm_chunk_entry_map.restype = i32
        lib.tehmm_chunk_entry_map.argtypes = [ptr] * 3 + [i64, i64, i32,
                                                          ptr]
        lib.tehmm_chunk_compose.restype = i32
        lib.tehmm_chunk_compose.argtypes = [ptr] * 4 + [i64, i64, i32, ptr]
        lib.tehmm_chunk_chase.restype = i32
        lib.tehmm_chunk_chase.argtypes = [ptr] * 4 + [i64, i64, i32, ptr]
        lib.tehmm_viterbi_backtrace.restype = i32
        lib.tehmm_viterbi_backtrace.argtypes = [
            ptr, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, i64, i64, i32, ptr,
        ]
        for fn in (lib.tehmm_em_fwd, lib.tehmm_em_fwd_lanes):
            fn.restype = i32
            fn.argtypes = (
                [ptr] * 8 + [i64, i64, i32, i32, i32] + streams + [ptr])
        for fn in (lib.tehmm_em_bwd_stats, lib.tehmm_em_bwd_stats_lanes):
            fn.restype = i32
            fn.argtypes = (
                [ptr] * 10 + [i64, i64, i32, i32, i32, i32] + streams
                + [ptr])
        lib.tehmm_k1_lanes_smem_floats.restype = i64
        lib.tehmm_k1_lanes_smem_floats.argtypes = [i32] * 6
        for fn in (lib.tehmm_post_decode, lib.tehmm_post_decode_lanes):
            fn.restype = i32
            fn.argtypes = (
                [ptr] * 6 + [i64, i64, i32, i32, i32] + streams + [ptr])
        lib.tehmm_k4_lanes_smem_floats.restype = i64
        lib.tehmm_k4_lanes_smem_floats.argtypes = [i32] * 4
        for fn in (lib.tehmm_x1_sweep_lanes, lib.tehmm_x1_sweep_smem):
            fn.restype = i32
            fn.argtypes = [ptr] * 7 + [i64, i64, i32, i64, i64, ptr]
        for fn in (lib.tehmm_x2_sweep_lanes, lib.tehmm_x2_sweep_smem):
            fn.restype = i32
            fn.argtypes = [ptr] * 7 + [i64, i64, i32, i64, i64, ptr]
        lib.tehmm_fwd_piece_ops.restype = i32
        lib.tehmm_fwd_piece_ops.argtypes = [ptr] * 5 + [i64, i64, i32, i32,
                                                        ptr]
        lib.tehmm_fwd_piece_compose.restype = i32
        lib.tehmm_fwd_piece_compose.argtypes = (
            [ptr] * 6 + [i64, i64, i32, i32, ptr])
        lib.tehmm_fwd_prob.restype = i32
        lib.tehmm_fwd_prob.argtypes = [ptr] * 6 + [i64, i64, i32, i32, ptr]
        lib.tehmm_viterbi_values.restype = i32
        lib.tehmm_viterbi_values.argtypes = [ptr] * 6 + [i64, i64, i32, i32,
                                                         ptr]
        lib.tehmm_bwd_prob.restype = i32
        lib.tehmm_bwd_prob.argtypes = [ptr] * 4 + [i64, i64, i32, i32, ptr]
        lib.tehmm_fwd_scaled.restype = i32
        lib.tehmm_fwd_scaled.argtypes = [ptr] * 6 + [i64, i64, i32, i32,
                                                     ptr]
        lib.tehmm_bwd_scaled.restype = i32
        lib.tehmm_bwd_scaled.argtypes = [ptr] * 5 + [i64, i64, i32, i32,
                                                     ptr]
        lib.tehmm_scan_cluster_plan.restype = i32
        lib.tehmm_scan_cluster_plan.argtypes = [i32, i64, i32, ptr]
        lib.tehmm_rows_plan.restype = i32
        lib.tehmm_rows_plan.argtypes = [i32, i64, i32, ptr]
        lib.tehmm_viterbi_ptrs.restype = i32
        lib.tehmm_viterbi_ptrs.argtypes = [ptr] * 7 + [i64, i64, i32, i32,
                                                       ptr]
        lib.tehmm_pointer_chase.restype = i32
        lib.tehmm_pointer_chase.argtypes = [ptr] * 4 + [i64, i64, i32, ptr]
        lib.tehmm_viterbi_carry_tile.restype = i32
        lib.tehmm_viterbi_carry_tile.argtypes = (
            [ptr] * 6 + [i64, i64, i32, i32, ptr])
        lib.tehmm_fwd_chunk_tile.restype = i32
        lib.tehmm_fwd_chunk_tile.argtypes = [ptr] * 7 + [i64, i64, i32,
                                                         i32, ptr]
        lib.tehmm_bwd_chunk_tile.restype = i32
        lib.tehmm_bwd_chunk_tile.argtypes = [ptr] * 7 + [i64, i64, i32,
                                                         i32, ptr]
        lib.tehmm_maxplus_sweeps.restype = i32
        lib.tehmm_maxplus_sweeps.argtypes = (
            [ptr] * 3 + [i32, i64, i32, ptr])
        _lib = lib
        return lib


# ---------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_contiguous(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _row_stride(t: torch.Tensor, name: str) -> int:
    """Batch stride of a [B, ..., S] tensor whose rows are dense (the
    leading dimension may be a slice of a larger tensor)."""
    dense = t[0] if t.shape[0] else t
    if dense.numel() and not dense.is_contiguous():
        raise ValueError(f"{name}: each batch row must be contiguous")
    return t.stride(0)


def _fits(S: int, smem_floats: int) -> bool:
    """Whether a fused kernel (one warp per row, every table in one
    block's shared memory) takes S states with ``smem_floats`` floats of
    shared memory per block."""
    return S <= MAX_STATES and 4 * smem_floats <= _SMEM_LIMIT


def _check_envelope(S: int, smem_floats: int, what: str,
                    item: str = _ENVELOPE_ITEM) -> None:
    if not _fits(S, smem_floats):
        raise NotImplementedError(
            f"{what}: S={S} needs {4 * smem_floats} bytes of shared "
            f"memory per block (limit {_SMEM_LIMIT}, and S <= "
            f"{MAX_STATES}); not ported yet ({item})"
        )


def _check_tile(S: int, what: str) -> None:
    """The scan tile's envelope (``STREAMING_MAX_STATES``): beyond it the
    card's wrappers raise naming its item."""
    if S > STREAMING_MAX_STATES:
        raise NotImplementedError(
            f"{what}: S={S} is over the {STREAMING_MAX_STATES} states the "
            f"scan tile takes (4 a thread in a block of 256); not ported "
            f"yet ({_STREAMING_ENVELOPE_ITEM})"
        )


def sweep_fits(S: int) -> bool:
    """Whether the one-warp kernels of the carried sweeps (K3
    ``viterbi_sweep_*_kernel``, X1 ``fwd_sweep_*_kernel``, X2
    ``bwd_sweep_*_kernel``) take S states: all of the transition matrix and
    one S-float row per warp of a 4-warp block in shared memory,
    4 (S^2 + 4 S) bytes <= 232,448, so S <= 239.  Beyond it their
    wrappers launch the scan tile's carry modes (``csrc/streaming.cu``,
    ``csrc/scans.cu``), to S = 1024; the choice is by S alone, never
    taken on a failure."""
    return _fits(S, S * S + _WARPS_PER_BLOCK * S)


def _check_index_range(t: torch.Tensor, hi: int, name: str) -> None:
    """Values of an int tensor the kernel indexes with must be in
    [0, hi): an out-of-range value would read past a shared table."""
    if t.numel() == 0:
        return
    lo_v, hi_v = torch.aminmax(t)
    if int(lo_v) < 0 or int(hi_v) >= hi:
        raise ValueError(
            f"{name}: values must lie in [0, {hi}), got "
            f"[{int(lo_v)}, {int(hi_v)}]"
        )


def _device_kind(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        msg = lib.tehmm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


@dataclasses.dataclass(frozen=True)
class _Streams:
    """The optional observation streams of one fused-kernel call."""

    w: torch.Tensor | None = None        # f32[B, L] segment weights
    values: torch.Tensor | None = None   # f32[B, L, G], NaN missing
    gauss: object = None                 # models.gauss.GaussParams

    @property
    def G(self) -> int:
        return 0 if self.values is None else self.values.shape[-1]

    @property
    def suffix(self) -> str:
        """The launch-count key's variant: "", "+w", "+g" or "+wg"."""
        tag = ("w" if self.w is not None else "") + \
            ("g" if self.values is not None else "")
        return "+" + tag if tag else ""

    def obs(self, log_em, symbols):
        """The plain versions' observation log-likelihoods."""
        return obs_log_likelihoods(log_em, symbols, self.gauss, self.values,
                                   self.w)

    def args(self):
        """(w, values, coef, G) as the C entry points take them; the
        coefficient tensor is returned too, to live until the launch."""
        if self.values is None:
            coef = None
        else:
            coef = coeff_table(self.gauss)
        ptr = (lambda t: None if t is None else t.data_ptr())
        return coef, [ptr(self.w), ptr(self.values), ptr(coef), self.G]


def _streams(symbols, S, obs_weights=None, gauss_params=None,
             gauss_values=None) -> _Streams:
    """Check the optional streams against symbols [B, L, T] (gaussian
    tracks need both ``gauss_params`` and ``gauss_values``, as in the
    JAX package)."""
    B, L, _T = symbols.shape
    dev = symbols.device
    if obs_weights is not None:
        _check(obs_weights, "obs_weights", torch.float32, (B, L), dev)
        _check_contiguous(obs_weights, "obs_weights")
    if gauss_params is None or gauss_values is None:
        return _Streams(w=obs_weights)
    G = gauss_values.shape[-1]
    _check(gauss_values, "gauss_values", torch.float32, (B, L, G), dev)
    _check_contiguous(gauss_values, "gauss_values")
    _check(gauss_params.mu, "gauss_params.mu", torch.float32, (S, G), dev)
    _check(gauss_params.log_var, "gauss_params.log_var", torch.float32,
           (S, G), dev)
    return _Streams(w=obs_weights, values=gauss_values, gauss=gauss_params)


# ---------------------------------------------------------------------
# K2 forward
# ---------------------------------------------------------------------

def _k2_smem_floats(S: int, T: int, V: int, G: int = 0) -> int:
    """Shared-memory floats per block of K2's forward: the tables (with
    the gaussian coefficients [S, 3G]), the start row and one value row
    per warp."""
    return S * S + S * T * V + S + 3 * S * G + _WARPS_PER_BLOCK * S


def k2_fits(S: int, T: int, V: int, G: int = 0) -> bool:
    """K2's envelope: whether ``viterbi_fwd`` (and so ``viterbi_fused``)
    takes a model of S states, T tracks of V symbols and G gaussian
    tracks.  ``viterbi_fwd``'s own check and the stitched decoder's route
    (``parallel/stitch.viterbi_route``) both ask this."""
    return _fits(S, _k2_smem_floats(S, T, V, G))


# K2's forward step, as K4's decode (``k4_step``): "lanes" to this many
# states (csrc/viterbi.cu ``viterbi_fwd_lanes_kernel``: K3's lanes step,
# trans column j and the whole row in lane j's registers, the row round by
# shuffles; the symbols and streams staged a half of ``_K1_HALF``
# positions ahead through K1's ring and a half's obs formed before its
# steps), "shared" from 33 states to K2's envelope (``viterbi_fwd_kernel``:
# the row and every table in shared memory, obs in the step).  Either
# gives the other's bits, in both modes; each counts its launches under
# its own name: counter by step, then the entry by (step, mode).
K2_LANES_MAX_STATES = 32
_K2_COUNTERS = {"lanes": "viterbi_fwd_lanes", "shared": "viterbi_fwd"}
_K2_ENTRIES = {("lanes", "values"): "tehmm_viterbi_fwd_lanes",
               ("shared", "values"): "tehmm_viterbi_fwd",
               ("lanes", "pointers"): "tehmm_viterbi_fwd_ptrs_lanes",
               ("shared", "pointers"): "tehmm_viterbi_fwd_ptrs"}


def _k2_lanes_smem_floats(S: int, T: int, V: int, G: int = 0) -> int:
    """Shared-memory floats per block of K2's lanes forward (csrc/
    viterbi.cu ``k2_lanes_smem_floats``): log_em and the coefficients,
    and per warp a ring of two slots of ``_K1_HALF`` positions (symbols,
    a weight and the gaussian values) and a half's obs.  The card's tests
    hold it to the library's own (``tehmm_k2_lanes_smem_floats``, which
    the launches use)."""
    slot = _K1_HALF * (T + 1 + G)
    return (S * T * V + 3 * S * G
            + _WARPS_PER_BLOCK * (2 * slot + _K1_HALF * S))


def k2_step(S: int, T: int, V: int, G: int = 0) -> str:
    """K2's forward step for a model of S states, T tracks of V symbols
    and G gaussian tracks: ``"lanes"`` to ``K2_LANES_MAX_STATES`` where
    the lanes kernel's ring fits beside the tables (always but for
    hundreds of tracks), else ``"shared"``; past K2's envelope it raises
    naming its item."""
    _check_envelope(S, _k2_smem_floats(S, T, V, G), "viterbi_fwd")
    if S <= K2_LANES_MAX_STATES and _fits(
            S, _k2_lanes_smem_floats(S, T, V, G)):
        return "lanes"
    return "shared"


def viterbi_fwd_plain(log_start, log_trans, log_em, symbols, lengths,
                      obs_weights=None, gauss_params=None,
                      gauss_values=None):
    """Plain version of ``viterbi_fwd``: obs by the track-order
    gather-sum (plus the gaussian term, times the weights), then
    ``viterbi_values_plain``."""
    obs = _streams(symbols, log_em.shape[0], obs_weights, gauss_params,
                   gauss_values).obs(log_em, symbols)
    return viterbi_values_plain(log_start, log_trans, obs, lengths)


def viterbi_fwd_pointers_plain(log_start, log_trans, log_em, symbols,
                               lengths, obs_weights=None, gauss_params=None,
                               gauss_values=None):
    """Plain version of ``viterbi_fwd_pointers``: the same obs, then
    ``viterbi_pointers_plain`` (``viterbi_values_plain``'s loop with the
    first-hit argmax of every step's candidates kept)."""
    obs = _streams(symbols, log_em.shape[0], obs_weights, gauss_params,
                   gauss_values).obs(log_em, symbols)
    return viterbi_pointers_plain(log_start, log_trans, obs, lengths)


def _k2_forward(mode, log_start, log_trans, log_em, symbols, lengths,
                obs_weights, gauss_params, gauss_values):
    """Either mode of K2's forward (``"values"`` or ``"pointers"``): the
    checks, then on the CPU the plain version, on the card the kernel of
    ``k2_step`` into new outputs, in the entry's order."""
    B, L, T = symbols.shape
    S, _, V = log_em.shape
    dev = symbols.device
    _check(symbols, "symbols", torch.int32, (B, L, T), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    _check(log_start, "log_start", torch.float32, (S,), dev)
    _check(log_trans, "log_trans", torch.float32, (S, S), dev)
    _check(log_em, "log_em", torch.float32, (S, T, V), dev)
    for t, name in ((symbols, "symbols"), (lengths, "lengths"),
                    (log_start, "log_start"), (log_trans, "log_trans"),
                    (log_em, "log_em")):
        _check_contiguous(t, name)
    st = _streams(symbols, S, obs_weights, gauss_params, gauss_values)
    if _device_kind(dev) == "cpu":
        plain = viterbi_fwd_plain if mode == "values" \
            else viterbi_fwd_pointers_plain
        return plain(log_start, log_trans, log_em, symbols, lengths, st.w,
                     st.gauss, st.values)
    step = k2_step(S, T, V, st.G)
    _check_index_range(symbols, V, "symbols")
    f32 = dict(dtype=torch.float32, device=dev)
    if mode == "values":
        outs = (torch.empty((B, L, S), **f32), torch.empty((B, L), **f32))
    else:
        outs = (torch.empty((B, L, S), dtype=pointer_dtype(S), device=dev),
                torch.empty((B, S), **f32), torch.empty((B, L), **f32))
    if B:
        _coef, stream_args = st.args()
        _launch_streaming(
            _K2_COUNTERS[step] + st.suffix, _K2_ENTRIES[step, mode],
            (symbols.data_ptr(), lengths.data_ptr(), log_start.data_ptr(),
             log_trans.data_ptr(), log_em.data_ptr(),
             *(t.data_ptr() for t in outs), B, L, S, T, V, *stream_args),
            dev)
    return outs


def viterbi_fwd(log_start, log_trans, log_em, symbols, lengths,
                obs_weights=None, gauss_params=None, gauss_values=None):
    """K2 forward: (v_hats f32[B, L, S], dm f32[B, L]) from int32
    symbols [B, L, T] and int32 lengths [B], with the optional segment
    weights and gaussian tracks.  Row t is the max-normalized value row
    at position t; dm[b, t] is its normalizer (0 at padding).

    Replaces ``_make_viterbi_fwd_kernel_v4`` (pallas_kernels.py:2386).
    Bound on an H100: the latency of one dependent max-plus step per
    position (an S x S max-reduction, then the row's max), not bytes or
    flops.  Design: one warp per row, lane <-> state, log_em and the
    gaussian coefficients in shared memory, obs formed on the card and
    never written out, in the step of ``k2_step``: to 32 states column j
    of trans in lane j's registers, the row round by shuffles, the
    symbols and streams staged with cp.async a half of 32 positions ahead
    and a half's obs formed before its steps, the row stopped at its
    length; beyond, trans, start and the row in shared memory, obs in the
    step.  Either gives the other's bits."""
    return _k2_forward("values", log_start, log_trans, log_em, symbols,
                       lengths, obs_weights, gauss_params, gauss_values)


def viterbi_fwd_pointers(log_start, log_trans, log_em, symbols, lengths,
                         obs_weights=None, gauss_params=None,
                         gauss_values=None):
    """K2 forward in pointer mode: (ptrs uint8 [B, L, S], last f32[B, S],
    dm f32[B, L]) from ``viterbi_fwd``'s inputs.  At every position t >= 1
    below a row's length and for every state j, ptrs[b, t, j] is the
    first-hit argmax predecessor argmax_i(v_hats[b, t-1, i] + trans[i, j])
    over ``viterbi_fwd``'s value rows (the float32 candidates of the
    value-row backtrace, ties to the lowest index), the identity at
    position 0 and at or past the length; ``last`` is ``v_hats[:, L-1]``
    (the last valid row, carried; a zero row for a zero-length row) and
    dm ``viterbi_fwd``'s.  No value row is written: 1 byte a state a
    position in place of 4.  Walking the pointers back from a state
    (``chunk_chase``) is the value-row backtrace.

    The kernels of ``viterbi_fwd`` (``k2_step``), counted under the same
    names, with the argmax kept beside the max off the chain (the lanes
    step's pairwise tree, the shared step's scan), so the value chain's
    bits are the values mode's.  uint8 holds every state of K2's
    envelope (S <= 256)."""
    return _k2_forward("pointers", log_start, log_trans, log_em, symbols,
                       lengths, obs_weights, gauss_params, gauss_values)


# ---------------------------------------------------------------------
# the value-row backtrace (K2's before its pointer mode; under K5, and the
# exact decoder's per-chunk backtrace past 239 states)
# ---------------------------------------------------------------------

viterbi_backtrace_plain = dp.viterbi_backtrace_chunk


def viterbi_backtrace(log_trans, rows, entry, end_state, lengths):
    """Walk one block of value rows back from ``end_state``.

    Args:
      rows: f32[B, L, S] value rows at positions 0..L-1 (each batch row
        dense; the batch stride may be larger, e.g. a slice).
      entry: f32[B, S] value row at position -1 (batch row dense).
      end_state: int32[B] state at position L-1.
      lengths: int32[B] valid positions.

    Returns (path int32[B, L], entry_state int32[B]) — the state at
    position -1 — with the semantics of ``dp.viterbi_backtrace_chunk``.

    The XLA backtrace of ``viterbi_pallas_v3`` (pallas_kernels.py:1475)
    over K5's value rows (``dp.viterbi_streaming``, past K2's envelope),
    and past 239 states the exact decoder's a chunk
    (``dp.viterbi_backtrace_chunk``); ``viterbi_fused`` chases pointers
    instead.  Bound: a chain of L dependent S-wide argmaxes a row, each
    step's column of trans chosen by the step before (the bytes, the
    value rows once, take far less).  Design (``csrc/viterbi.cu``): a
    warp a row; each lane forms the plain version's float sums over its
    states of trans^T's row (``log_trans.t()`` with rows padded to a
    multiple of 4 floats, made here: one contiguous row a step), a
    pairwise first-hit tree, then two ``redux.sync`` (the greatest value,
    the lowest index holding it), so ties go to the lowest state as
    ``torch.argmax``'s; the value rows read ahead through a cp.async
    ring; trans^T staged in shared memory to 236 states (a lane's states
    l + 32 k) and read from L2 beyond (its quads 4 l + 128 k + e, 16
    bytes a load), so every S to 1024, the scan tile's limit.  Strided
    batch rows, so callers pass slices without copying.
    """
    B, L, S = rows.shape
    dev = rows.device
    _check(log_trans, "log_trans", torch.float32, (S, S), dev)
    _check(rows, "rows", torch.float32, (B, L, S), dev)
    _check(entry, "entry", torch.float32, (B, S), dev)
    _check(end_state, "end_state", torch.int32, (B,), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    for t, name in ((log_trans, "log_trans"), (end_state, "end_state"),
                    (lengths, "lengths")):
        _check_contiguous(t, name)
    row_stride = _row_stride(rows, "rows")
    entry_stride = _row_stride(entry, "entry")
    if _device_kind(dev) == "cpu":
        return viterbi_backtrace_plain(log_trans, rows, entry, end_state,
                                       lengths)
    _check_tile(S, "viterbi_backtrace")
    _check_index_range(end_state, S, "end_state")
    path = torch.empty((B, L), dtype=torch.int32, device=dev)
    entry_state = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return path, entry_state
    lib = load_library()
    # trans^T, each row padded to a multiple of 4 floats (16-byte rows)
    trans_t = torch.nn.functional.pad(log_trans.t(), (0, -S % 4),
                                      value=float("-inf")).contiguous()
    rc = lib.tehmm_viterbi_backtrace(
        trans_t.data_ptr(), rows.data_ptr(), row_stride,
        entry.data_ptr(), entry_stride, end_state.data_ptr(),
        lengths.data_ptr(), path.data_ptr(), entry_state.data_ptr(),
        B, L, S, _stream(dev),
    )
    _raise_on(rc, lib, "viterbi_backtrace")
    LAUNCHES["viterbi_backtrace"] += 1
    return path, entry_state


# ---------------------------------------------------------------------
# K3: value rows, the final carry, or the carry leaving every chunk
# ---------------------------------------------------------------------

# K3's step, by S alone (csrc/viterbi.cu): "lanes" to this many states
# (lane j holds trans column j and the whole row in registers, the new row
# goes round by shuffles: nothing on the chain but registers and
# shuffles), "shared" to ``sweep_fits``' 239 (the row and trans in shared
# memory), "tile" beyond (the scan tile's carry mode, csrc/streaming.cu).
# Each gives the plain version's bits, so the choice moves only time.
K3_LANES_MAX_STATES = 32
_K3_ENTRIES = {"lanes": "tehmm_viterbi_sweep_lanes",
               "shared": "tehmm_viterbi_sweep_smem"}
_K3_POINTER_ENTRIES = {"lanes": "tehmm_viterbi_pointers_lanes",
                       "shared": "tehmm_viterbi_pointers_smem"}


def k3_step(S: int) -> str:
    """K3's step variant at S states: ``"lanes"``, ``"shared"`` or
    ``"tile"`` (see ``K3_LANES_MAX_STATES``)."""
    if S <= K3_LANES_MAX_STATES:
        return "lanes"
    return "shared" if sweep_fits(S) else "tile"


def _k3_launch(name, log_trans, obs, v_hat_init, lengths, out, mode,
               chunk=0, n_ck=0):
    """Launch K3 into ``out`` in ``mode``: ``"values"`` (the value
    rows), ``"carry"`` (the carry leaving every chunk of ``chunk``
    positions, ``n_ck`` of them; the tile takes only this one, with
    ``chunk`` = L) or ``"pointers"`` (the first-hit pointers; not on the
    tile)."""
    B, L, S = obs.shape
    step = k3_step(S)
    head = (obs.data_ptr(), v_hat_init.data_ptr(), lengths.data_ptr(),
            log_trans.data_ptr())
    if mode == "pointers":
        _launch_streaming(name, _K3_POINTER_ENTRIES[step],
                          head + (out.data_ptr(), B, L, S), obs.device)
        return
    values = mode == "values"
    ptrs = head + (out.data_ptr() if values else None,
                   None if values else out.data_ptr(), B, L, S)
    if step == "tile":
        _launch_scan("viterbi_chunk_tile", "tehmm_viterbi_carry_tile", S,
                     ptrs, obs.device)
    else:
        _launch_streaming(name, _K3_ENTRIES[step], ptrs + (chunk, n_ck),
                          obs.device)


def viterbi_chunk_values(log_trans, obs, v_hat_init, lengths):
    """K3: every value row f32[B, Lc, S] of one chunk from its incoming
    carry (``dp.viterbi_chunk_values`` semantics; int32 lengths).  The
    exact decoder's recompute: it gives every (chunk, table) of a group a
    row, each from that chunk's stored carry.

    Replaces ``viterbi_chunk_values_pallas`` (pallas_kernels.py:1492,
    kernel ``_make_viterbi_kernel_v3`` :1284).  Bound on an H100: the
    latency of one dependent max-plus step a position, one warp a row.
    Design: the step of ``k3_step(S)`` (registers and shuffles to 32
    states, shared memory to 239), obs read ahead of the chain (a
    cp.async ring in shared memory, or registers a few positions ahead),
    the row stopped at its length; past 239 states K5's rows kernel in
    carry mode (``csrc/streaming.cu``: the carry is the row before
    position 0, every position applies the max-plus step), counted as
    ``viterbi_chunk_rows`` (the block tile, forced with
    ``LOG_SCAN_MAX_STATES`` = 0, as ``viterbi_chunk_tile``), and from 257
    states K5's cluster tile in carry mode (``scan_route``), counted as
    ``viterbi_chunk_cluster``.
    Bit-equal to the plain version either way, so chunked sweeps equal one
    chunk."""
    B, L, S = obs.shape
    dev = _check_sweep(log_trans, obs, v_hat_init, lengths, "v_hat_init")
    if _device_kind(dev) == "cpu":
        return dp.viterbi_chunk_values(log_trans, obs, v_hat_init, lengths)
    _check_tile(S, "viterbi_chunk_values")
    out = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    if B:
        _k3_launch("viterbi_chunk_values", log_trans, obs, v_hat_init,
                   lengths, out, "values")
    return out


def viterbi_carry(log_trans, obs, v_hat_init, lengths):
    """K3 in carry mode: the final carry f32[B, S] (``dp.viterbi_carry``
    semantics; int32 lengths), counted as ``viterbi_chunk_values``."""
    B, L, S = obs.shape
    dev = _check_sweep(log_trans, obs, v_hat_init, lengths, "v_hat_init")
    if _device_kind(dev) == "cpu":
        return dp.viterbi_carry(log_trans, obs, v_hat_init, lengths)
    _check_tile(S, "viterbi_carry")
    out = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B:
        _k3_launch("viterbi_chunk_values", log_trans, obs, v_hat_init,
                   lengths, out, "carry", L, 1)
    return out


def viterbi_checkpoints(log_trans, obs, v_hat_init, lengths, chunk):
    """K3 in checkpoint mode: the carry leaving every chunk of ``chunk``
    positions, f32[B, ceil(L / chunk), S] (``dp.viterbi_checkpoints``:
    ``dp.viterbi_carry`` chained chunk by chunk; int32 lengths over all
    L positions).  The exact decoder's forward sweep: one launch walks
    each row over a whole group of chunks, where ``viterbi_carry`` took a
    launch a chunk.  Counted as ``viterbi_checkpoints``; past 239 states
    one launch of K5's carry mode a chunk (``viterbi_chunk_rows``; from
    257 states ``viterbi_chunk_cluster``).  Bound and design as
    ``viterbi_chunk_values``."""
    B, L, S = obs.shape
    dev = _check_sweep(log_trans, obs, v_hat_init, lengths, "v_hat_init")
    if chunk < 1:
        raise ValueError(f"chunk: must be at least 1, got {chunk}")
    if _device_kind(dev) == "cpu":
        return dp.viterbi_checkpoints(log_trans, obs, v_hat_init, lengths,
                                      chunk)
    _check_tile(S, "viterbi_checkpoints")
    n_ck = -(-L // chunk)
    out = torch.empty((B, n_ck, S), dtype=torch.float32, device=dev)
    if B == 0 or n_ck == 0:
        return out
    if k3_step(S) != "tile":
        _k3_launch("viterbi_checkpoints", log_trans, obs, v_hat_init,
                   lengths, out, "carry", chunk, n_ck)
        return out
    carry = v_hat_init
    for k in range(n_ck):
        part = obs[:, k * chunk:(k + 1) * chunk].contiguous()
        lens = torch.clamp(lengths - k * chunk, 0, chunk).to(torch.int32)
        carry = viterbi_carry(log_trans, part, carry, lens)
        out[:, k] = carry
    return out


def viterbi_chunk_pointers_plain(log_trans, obs, v_hat_init, lengths):
    """Plain version of ``viterbi_chunk_pointers``:
    ``dp.viterbi_chunk_values``' loop with the first-hit argmax of every
    step's candidates kept (``torch.max``: the first maximal index)."""
    B, L, S = obs.shape
    lens = lengths.to(torch.int64)
    ident = torch.arange(S, device=obs.device).expand(B, S)
    ptrs = torch.empty((B, L, S), dtype=pointer_dtype(S), device=obs.device)
    v_hat = v_hat_init
    for t in range(L):
        best, arg = (v_hat[:, :, None] + log_trans[None, :, :]).max(dim=1)
        new_hat, _ = dp._renorm(best + obs[:, t])
        valid_t = t < lens
        v_hat = dp._mask_carry(new_hat, v_hat, valid_t)
        ptrs[:, t] = torch.where(valid_t[:, None], arg, ident)
    return ptrs


def viterbi_chunk_pointers(log_trans, obs, v_hat_init, lengths):
    """K3 in pointer mode: at every position of every row and for every
    state j, the first-hit argmax predecessor argmax_i(v[t-1, i] +
    trans[i, j]) over ``dp.viterbi_chunk_values``' value rows (row -1 the
    carry ``v_hat_init``), ``pointer_dtype(S)`` [B, L, S]; the identity at
    and past a row's length (int32 lengths).  Walking them back from a
    state is ``dp.viterbi_backtrace_chunk`` on the value rows (the same
    float32 candidates, ties to the lowest index).  The exact decoder's
    recompute: one launch over every (table, chunk) of a group, 1 byte a
    state a position in place of 4.

    K3's kernels (``k3_step``) with the argmax kept beside the max, off the
    chain (the lanes step's pairwise tree, the shared step's scan), so the
    value chain's bits are the other modes'.  Bound and design as
    ``viterbi_chunk_values``; counted as ``viterbi_chunk_pointers``.  The
    tile (S > 239) has no pointer mode: it raises there."""
    B, L, S = obs.shape
    dev = _check_sweep(log_trans, obs, v_hat_init, lengths, "v_hat_init")
    if _device_kind(dev) == "cpu":
        return viterbi_chunk_pointers_plain(log_trans, obs, v_hat_init,
                                            lengths)
    if k3_step(S) == "tile":
        raise NotImplementedError(
            f"viterbi_chunk_pointers: S={S} takes K3's tile, which has no "
            f"pointer mode; not ported yet ({_TILE_POINTERS_ITEM})")
    out = torch.empty((B, L, S), dtype=pointer_dtype(S), device=dev)
    if B:
        _k3_launch("viterbi_chunk_pointers", log_trans, obs, v_hat_init,
                   lengths, out, "pointers")
    return out


# ---------------------------------------------------------------------
# X3: the exact decoder's backtrace from K3's pointers
# ---------------------------------------------------------------------

def _check_pointer_rows(ptrs, lengths, what):
    """Checks shared by the map and the chase; returns the device.  On the
    card the pointers are uint8 (S <= 256) and 16-byte aligned (the
    kernels stage them in 16-byte pieces)."""
    R, L, S = ptrs.shape
    dev = ptrs.device
    _check(ptrs, "ptrs", pointer_dtype(S), (R, L, S), dev)
    _check(lengths, "lengths", torch.int32, (R,), dev)
    for t, name in ((ptrs, "ptrs"), (lengths, "lengths")):
        _check_contiguous(t, name)
    if _device_kind(dev) == "cuda":
        if S > MAX_STATES:
            raise NotImplementedError(
                f"{what}: S={S} has uint16 pointers, which only K3's tile "
                f"would write; not ported yet ({_TILE_POINTERS_ITEM})")
        if ptrs.data_ptr() % 16:
            raise ValueError(f"{what}: ptrs must be 16-byte aligned")
    return dev


def chunk_entry_map_plain(ptrs, lengths):
    """Plain version of ``chunk_entry_map``: a loop over positions from the
    end, batched over rows and end states."""
    R, L, S = ptrs.shape
    lens = lengths.to(torch.int64)
    state = torch.arange(S, device=ptrs.device).repeat(R, 1)
    for t in range(L - 1, -1, -1):
        prev = ptrs[:, t].to(torch.int64).gather(1, state)
        state = torch.where((t < lens)[:, None], prev, state)
    return state.to(torch.int32)


def chunk_entry_map(ptrs, lengths):
    """X3's map: int32 [R, S], for every row of pointers [R, L, S]
    (``viterbi_chunk_pointers``; int32 lengths [R]) and every end state s,
    the state at position -1 that the walk back from s at position L-1
    reaches (state = ptrs[t, state] from t = L-1 down to 0, held at and
    past the row's length).

    No Pallas counterpart: the reference walks each chunk once, from its
    one end state (``dp.viterbi_backtrace_chunk``, an XLA scan a chunk).
    Bound on an H100: each walk is a chain of dependent loads, one a
    position.  Design (``csrc/viterbi.cu``): a block a row, a thread an
    end state, the row's pointers staged from its end in 16 KB windows
    through a two-slot cp.async ring, so a step is a byte load from shared
    memory; all rows at once."""
    R, L, S = ptrs.shape
    dev = _check_pointer_rows(ptrs, lengths, "chunk_entry_map")
    if _device_kind(dev) == "cpu":
        return chunk_entry_map_plain(ptrs, lengths)
    out = torch.empty((R, S), dtype=torch.int32, device=dev)
    if R:
        _launch_streaming("chunk_entry_map", "tehmm_chunk_entry_map",
                          (ptrs.data_ptr(), lengths.data_ptr(),
                           out.data_ptr(), R, L, S), dev)
    return out


def chunk_compose_plain(maps, end_state):
    """Plain version of ``chunk_compose``: a loop over chunks from the
    last, batched over tables."""
    B, n, _S = maps.shape
    e = end_state.to(torch.int64)
    ends = torch.empty((B, n), dtype=torch.int32, device=maps.device)
    for c in range(n - 1, -1, -1):
        ends[:, c] = e
        e = maps[:, c].to(torch.int64).gather(1, e[:, None])[:, 0]
    return ends, e.to(torch.int32)


def chunk_compose(maps, end_state):
    """X3's compose: (ends int32 [B, n], entry int32 [B]) from the maps
    int32 [B, n, S] of a table's n consecutive chunks (``chunk_entry_map``)
    and the state at the last chunk's end, int32 [B]: ends[:, n-1] is
    that state, ends[:, c-1] = maps[:, c, ends[:, c]], and entry the state
    before the first chunk (maps[:, 0, ends[:, 0]]).

    The backtrace's one chain that cannot be split: n lookups a table.
    Design: a thread a table, the maps read from L2 where the map kernel
    left them; on the card, so the end states pass from the map to the
    chase, and from group to group, with no copy to the host."""
    B, n, S = maps.shape
    dev = maps.device
    _check(maps, "maps", torch.int32, (B, n, S), dev)
    _check(end_state, "end_state", torch.int32, (B,), dev)
    for t, name in ((maps, "maps"), (end_state, "end_state")):
        _check_contiguous(t, name)
    if _device_kind(dev) == "cpu":
        return chunk_compose_plain(maps, end_state)
    _check_index_range(end_state, S, "end_state")
    ends = torch.empty((B, n), dtype=torch.int32, device=dev)
    entry = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        _launch_streaming("chunk_compose", "tehmm_chunk_compose",
                          (maps.data_ptr(), end_state.data_ptr(),
                           ends.data_ptr(), entry.data_ptr(), B, n, S), dev)
    return ends, entry


def chunk_chase_plain(ptrs, end_state, lengths):
    """Plain version of ``chunk_chase``: a loop over positions from the
    end, batched over rows."""
    R, L, _S = ptrs.shape
    lens = lengths.to(torch.int64)
    state = end_state.to(torch.int64)
    path = torch.empty((R, L), dtype=torch.int32, device=ptrs.device)
    for t in range(L - 1, -1, -1):
        path[:, t] = state
        prev = ptrs[:, t].to(torch.int64).gather(1, state[:, None])[:, 0]
        state = torch.where(t < lens, prev, state)
    return path


def chunk_chase(ptrs, end_state, lengths):
    """X3's chase: the path int32 [R, L] of every row of pointers [R, L, S]
    from its end state int32 [R] (``chunk_compose``'s ends): path[t] is
    the state at t, path[t-1] = ptrs[t, path[t]] below the row's length
    (int32 lengths [R]), the end state held at and past it.  With the
    pointers of ``viterbi_chunk_pointers`` this is the path of
    ``dp.viterbi_backtrace_chunk`` on the value rows.

    No Pallas counterpart (``dp.viterbi_backtrace_chunk``, an XLA scan a
    chunk).  Bound on an H100: one dependent load a position.  Design:
    ``chunk_entry_map``'s block a row and staged windows, one thread
    walking; every row at once."""
    R, L, S = ptrs.shape
    dev = _check_pointer_rows(ptrs, lengths, "chunk_chase")
    _check(end_state, "end_state", torch.int32, (R,), dev)
    _check_contiguous(end_state, "end_state")
    if _device_kind(dev) == "cpu":
        return chunk_chase_plain(ptrs, end_state, lengths)
    _check_index_range(end_state, S, "end_state")
    path = torch.empty((R, L), dtype=torch.int32, device=dev)
    if R and L:
        _launch_streaming("chunk_chase", "tehmm_chunk_chase",
                          (ptrs.data_ptr(), end_state.data_ptr(),
                           lengths.data_ptr(), path.data_ptr(), R, L, S),
                          dev)
    return path


# ---------------------------------------------------------------------
# K2 as a whole
# ---------------------------------------------------------------------

def viterbi_fused(log_start, log_trans, log_em, symbols, lengths,
                  obs_weights=None, gauss_params=None, gauss_values=None):
    """Symbols-in/path-out Viterbi with the JAX signature of
    ``viterbi_fused_pallas_v4``: (path int32[B, L], score f32[B]).  The
    optional streams reach the forward; the backtrace reads no obs.

    The forward writes first-hit pointers (``viterbi_fwd_pointers``);
    the backtrace is X3's chase (``chunk_chase``: a block a row, the
    pointers staged from the row's end) from the first-hit argmax of the
    last value row, over the rows' own lengths.  Position 0's pointers
    are the identity, so the chase's last read there keeps its state, the
    one position 1's pointer gave it.  This replaces
    ``_viterbi_backtrace_kernel_v4`` (pallas_kernels.py:2517), which walks
    value rows.  Paths equal ``dp.viterbi``'s; the score is max(last row)
    + sum(dm) (a tree-order sum, so it matches ``dp.viterbi``'s
    sequential one to float32 rounding).  Zero-length rows get path 0 and
    score 0."""
    ptrs, last, dm = viterbi_fwd_pointers(
        log_start, log_trans, log_em, symbols, lengths, obs_weights,
        gauss_params, gauss_values)
    end_state = torch.argmax(last, dim=-1).to(torch.int32)
    path = chunk_chase(ptrs, end_state, lengths)
    nonempty = lengths > 0
    score = torch.where(nonempty, last.amax(dim=-1) + dm.sum(dim=1), 0.0)
    path = torch.where(nonempty[:, None], path, 0)
    return path, score


# ---------------------------------------------------------------------
# K1: the fused E-step (forward, then reverse sweep with statistics)
# ---------------------------------------------------------------------

def _k1_smem_floats(S: int, T: int, V: int, bwd_warps: int = 1,
                    G: int = 0) -> tuple[int, int]:
    """Shared-memory floats per block of (em_fwd, em_bwd_stats): the
    tables (with G gaussian tracks, their coefficients [S, 3G]), plus per
    warp a probability row (forward) or the statistics accumulators
    (with the gaussian moments [S, 3G]) and three state rows (reverse,
    ``bwd_warps`` warps)."""
    tables = S * S + S * T * V + 3 * S * G
    return (tables + S + _WARPS_PER_BLOCK * S,
            tables + bwd_warps * (S * S + S * T * V + 3 * S * G + 3 * S))


def _k1_bwd_warps(S: int, T: int, V: int, G: int = 0) -> int:
    """Warps per block of em_bwd_stats: 4, 2 or 1, the most whose
    private statistics fit in shared memory (1 when none fits, and the
    envelope check then raises)."""
    for warps in (_WARPS_PER_BLOCK, 2):
        if 4 * _k1_smem_floats(S, T, V, warps, G)[1] <= _SMEM_LIMIT:
            return warps
    return 1


def k1_fits(S: int, T: int, V: int, G: int = 0) -> bool:
    """K1's envelope: whether both kernels of the fused E-step
    (``em_fwd``, and ``em_bwd_stats`` at the warps per block it would
    run) take a model of S states, T tracks of V symbols and G gaussian
    tracks.  The kernels' own checks and the E-step's ``"auto"`` engine
    (``ops/em.resolve_engine``) both ask this."""
    fwd, bwd = _k1_smem_floats(S, T, V, _k1_bwd_warps(S, T, V, G), G)
    return _fits(S, fwd) and _fits(S, bwd)


# K1's step, as K3's, X1's and X2's (``k3_step``): "lanes" to this many
# states (csrc/em_estep.cu ``em_fwd_lanes_kernel`` and
# ``em_bwd_stats_lanes_kernel``: exp(trans) in registers, the row round
# by shuffles, the streams staged a half of ``_K1_HALF`` positions ahead
# with cp.async), "shared" from 33 states to K1's envelope (the kernels
# with the tables and the row in shared memory).  The lanes kernels give
# the shared kernels' bits (the reverse at the same warps a block, so
# every block's partial is the same), so the choice moves only time.
K1_LANES_MAX_STATES = 32
_K1_HALF = 32                   # kHalf in csrc/common.cuh
_K1_ENTRIES = {"lanes": ("tehmm_em_fwd_lanes", "tehmm_em_bwd_stats_lanes"),
               "shared": ("tehmm_em_fwd", "tehmm_em_bwd_stats")}


def _k1_lanes_smem_floats(S: int, T: int, V: int, bwd_warps: int,
                          G: int = 0) -> tuple[int, int]:
    """Shared-memory floats per block of the lanes kernels (csrc/
    em_estep.cu ``fwd_lanes_warp_floats``, ``bwd_lanes_warp_floats``):
    log_em and the coefficients, and per warp a ring of two slots of
    ``_K1_HALF`` positions (symbols, a weight and the gaussian values; in
    the reverse alpha_p and m_raw too) and a half's obs_p, beside the
    reverse's statistics (its pair [S, S] written over the ring at the
    end).  The route is decided here, where no library need be built; the
    card's tests hold these sizes to the library's own
    (``tehmm_k1_lanes_smem_floats``, which the launches use)."""
    tables = S * T * V + 3 * S * G
    slot = _K1_HALF * (T + 1 + G)
    fwd = tables + _WARPS_PER_BLOCK * (2 * slot + _K1_HALF * S)
    scratch = max(2 * (slot + _K1_HALF * (S + 1)) + _K1_HALF * S, S * S)
    return fwd, tables + bwd_warps * (S * T * V + S + 3 * S * G + scratch)


def k1_step(S: int, T: int, V: int, G: int = 0) -> str:
    """K1's step for a model of S states, T tracks of V symbols and G
    gaussian tracks: ``"lanes"`` to ``K1_LANES_MAX_STATES`` where both
    lanes kernels' rings fit beside the tables (always but for hundreds
    of tracks), else ``"shared"``; past K1's envelope (``k1_fits``) it
    raises naming its item."""
    warps = _k1_bwd_warps(S, T, V, G)
    _check_envelope(S, max(_k1_smem_floats(S, T, V, warps, G)), "K1",
                    _K1_ENVELOPE_ITEM)
    if S <= K1_LANES_MAX_STATES and _fits(
            S, max(_k1_lanes_smem_floats(S, T, V, warps, G))):
        return "lanes"
    return "shared"


def _k4_smem_floats(S: int, T: int, V: int, G: int = 0) -> int:
    """Shared-memory floats per block of K4's decode: the tables (with
    the gaussian coefficients) and one state row per warp."""
    return S * S + S * T * V + 3 * S * G + _WARPS_PER_BLOCK * S


def k4_fits(S: int, T: int, V: int, G: int = 0) -> bool:
    """K4's envelope: whether ``posterior_decode_fused`` (K1's forward,
    then the decode) takes the model.  The decode's own check and the
    stitched max-posterior decoder's route (``parallel/stitch.
    maxpost_route``) both ask this."""
    fwd = _k1_smem_floats(S, T, V, G=G)[0]
    return _fits(S, fwd) and _fits(S, _k4_smem_floats(S, T, V, G))


# K4's decode step, as K1's (``k1_step``): "lanes" to this many states
# (csrc/posterior.cu ``post_decode_lanes_kernel``: exp(trans) in
# registers, the row round by shuffles, the symbols, streams and alpha_p
# staged a half of ``_K1_HALF`` positions ahead through K1's ring, the
# argmax at the half's end), "shared" from 33 states to K4's envelope
# (``post_decode_kernel``).  Either gives the other's bits; each counts
# its launches under its own name: (counter, entry) by step.
K4_LANES_MAX_STATES = 32
_K4_ENTRIES = {"lanes": ("post_decode_lanes", "tehmm_post_decode_lanes"),
               "shared": ("post_decode", "tehmm_post_decode")}


def _k4_lanes_smem_floats(S: int, T: int, V: int, G: int = 0) -> int:
    """Shared-memory floats per block of the lanes decode (csrc/
    posterior.cu ``decode_lanes_smem_floats``): log_em and the
    coefficients, and per warp a ring of two slots of ``_K1_HALF``
    positions (symbols, a weight, the gaussian values and an alpha_p
    row) and a half's obs_p.  The card's tests hold it to the library's
    own (``tehmm_k4_lanes_smem_floats``, which the launches use)."""
    slot = _K1_HALF * (T + 1 + G + S)
    return (S * T * V + 3 * S * G
            + _WARPS_PER_BLOCK * (2 * slot + _K1_HALF * S))


def k4_step(S: int, T: int, V: int, G: int = 0) -> str:
    """K4's decode step for a model of S states, T tracks of V symbols
    and G gaussian tracks: ``"lanes"`` to ``K4_LANES_MAX_STATES`` where
    the lanes kernel's ring fits beside the tables (always but for
    hundreds of tracks), else ``"shared"``; past the decode's envelope it
    raises naming its item."""
    _check_envelope(S, _k4_smem_floats(S, T, V, G), "post_decode",
                    _POST_ENVELOPE_ITEM)
    if S <= K4_LANES_MAX_STATES and _fits(
            S, _k4_lanes_smem_floats(S, T, V, G)):
        return "lanes"
    return "shared"


def _check_k1_inputs(log_em, symbols, lengths, **tables) -> torch.device:
    B, L, T = symbols.shape
    S, _, V = log_em.shape
    dev = symbols.device
    _check(symbols, "symbols", torch.int32, (B, L, T), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    _check(log_em, "log_em", torch.float32, (S, T, V), dev)
    shapes = {"log_start": (S,), "log_trans": (S, S), "alpha": (B, L, S),
              "m_raw": (B, L)}
    for name, t in tables.items():
        _check(t, name, torch.float32, shapes[name], dev)
    for name, t in (("symbols", symbols), ("lengths", lengths),
                    ("log_em", log_em), *tables.items()):
        _check_contiguous(t, name)
    return dev


def em_fwd_plain(log_start, log_trans, log_em, symbols, lengths,
                 obs_weights=None, gauss_params=None, gauss_values=None):
    """Plain version of ``em_fwd``: K1's probability-space forward as a
    loop over positions, batched over rows."""
    obs = _streams(symbols, log_em.shape[0], obs_weights, gauss_params,
                   gauss_values).obs(log_em, symbols)         # [B, L, S]
    B, L, S = obs.shape
    o_m = obs.amax(dim=-1)
    obs_p = torch.exp(obs - o_m[..., None])
    start_p, trans_p = torch.exp(log_start), torch.exp(log_trans)
    lens = lengths.to(torch.int64)
    p = torch.ones((B, S), dtype=torch.float32, device=obs.device)
    alpha = torch.empty((B, L, S), dtype=torch.float32, device=obs.device)
    dm = torch.empty((B, L), dtype=torch.float32, device=obs.device)
    m_raw = torch.empty_like(dm)
    for t in range(L):
        base = start_p[None, :] if t == 0 else p @ trans_p
        u = base * obs_p[:, t]
        m = torch.clamp(u.amax(dim=-1), min=1e-37)
        valid = t < lens
        p = torch.where(valid[:, None], u / m[:, None], p)
        alpha[:, t] = p
        dm[:, t] = torch.where(valid, torch.log(m) + o_m[:, t], 0.0)
        m_raw[:, t] = torch.where(valid, m, 1.0)
    return alpha, dm, m_raw


def em_fwd(log_start, log_trans, log_em, symbols, lengths,
           obs_weights=None, gauss_params=None, gauss_values=None):
    """K1 forward: (alpha_p f32[B, L, S], dm f32[B, L], m_raw f32[B, L])
    from int32 symbols [B, L, T] and int32 lengths [B], with the optional
    segment weights and gaussian tracks.  Row t of alpha_p is the forward
    probability row scaled to max 1 (a row of ones for zero-length rows;
    carried at padding); dm[b, t] is its loglik increment log m + max
    obs_log (0 at padding) and m_raw[b, t] the scale m itself (1 at
    padding), which the reverse sweep uses.

    Replaces ``_make_forward_kernel_v4`` (pallas_kernels.py:1777).
    Bound on an H100: the latency of one dependent step per position (an
    S x S matrix-vector product, a row max and a divide), not bytes or
    flops.  Design: one warp per row, lane <-> state, log_em and the
    gaussian coefficients in shared memory, obs formed on the card and
    never written out, in the step of ``k1_step``: to 32 states column j
    of exp(trans) in lane j's registers, the row round by shuffles, the
    symbols and streams staged with cp.async a half of 32 positions ahead
    and a half's obs formed before its steps, the row stopped at its
    length; beyond, exp(trans), exp(start) and the row in shared memory,
    obs in the step.  Either gives the other's bits."""
    S, T, V = log_em.shape
    B, L, _T = symbols.shape
    dev = _check_k1_inputs(log_em, symbols, lengths, log_start=log_start,
                           log_trans=log_trans)
    st = _streams(symbols, S, obs_weights, gauss_params, gauss_values)
    if _device_kind(dev) == "cpu":
        return em_fwd_plain(log_start, log_trans, log_em, symbols, lengths,
                            st.w, st.gauss, st.values)
    _check_envelope(S, _k1_smem_floats(S, T, V, G=st.G)[0], "em_fwd",
                    _K1_ENVELOPE_ITEM)
    _check_index_range(symbols, V, "symbols")
    alpha = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    dm = torch.empty((B, L), dtype=torch.float32, device=dev)
    m_raw = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B == 0 or L == 0:
        return alpha, dm, m_raw
    # past K1's envelope only K4 runs the forward: the shared kernel
    step = k1_step(S, T, V, st.G) if k1_fits(S, T, V, st.G) else "shared"
    start_p, trans_p = torch.exp(log_start), torch.exp(log_trans)
    _coef, stream_args = st.args()
    _launch_streaming("em_fwd" + st.suffix, _K1_ENTRIES[step][0], (
        symbols.data_ptr(), lengths.data_ptr(), start_p.data_ptr(),
        trans_p.data_ptr(), log_em.data_ptr(), alpha.data_ptr(),
        dm.data_ptr(), m_raw.data_ptr(), B, L, S, T, V, *stream_args), dev)
    return alpha, dm, m_raw


def _split_moments(gmom: torch.Tensor, G: int):
    """[S, 3G] -> (gn, gx, gx2), each [S, G]."""
    return gmom[:, :G], gmom[:, G:2 * G], gmom[:, 2 * G:]


def em_bwd_stats_plain(log_trans, log_em, symbols, lengths, alpha, m_raw,
                       obs_weights=None, gauss_params=None,
                       gauss_values=None):
    """Plain version of ``em_bwd_stats``: K1's reverse sweep as a loop
    over positions, batched over rows, then the contractions."""
    st = _streams(symbols, log_em.shape[0], obs_weights, gauss_params,
                  gauss_values)
    obs = st.obs(log_em, symbols)
    B, L, S = obs.shape
    dev = obs.device
    obs_p = torch.exp(obs - obs.amax(dim=-1, keepdim=True))
    trans_p = torch.exp(log_trans)
    lens = lengths.to(torch.int64)
    b = torch.ones((B, S), dtype=torch.float32, device=dev)
    gamma = torch.zeros((B, L, S), dtype=torch.float32, device=dev)
    xn_all = torch.zeros_like(gamma)
    w_all = torch.zeros((B, L), dtype=torch.float32, device=dev)
    for p in range(L - 1, -1, -1):
        valid = p < lens
        x = obs_p[:, p] * b
        xm = torch.clamp(x.amax(dim=-1), min=1e-37)
        xn = x / xm[:, None]
        ab = alpha[:, p] * b
        gden = torch.clamp(ab.sum(dim=-1), min=1e-30)
        gamma[:, p] = torch.where(valid[:, None], ab / gden[:, None], 0.0)
        z = m_raw[:, p] * gden / xm
        w_all[:, p] = torch.where(valid, 1.0 / torch.clamp(z, min=1e-30),
                                  0.0)
        xn_all[:, p] = xn
        sb = xn @ trans_p.T
        nm = torch.clamp(sb.amax(dim=-1), min=1e-37)
        b = torch.where(valid[:, None], sb / nm[:, None], b)
    start = gamma[:, 0].sum(dim=0) if L else torch.zeros(S, device=dev)
    gamma_w = gamma if st.w is None else gamma * st.w[..., None]
    em = expected_emission_counts(tuple(log_em.shape), symbols, gamma_w)
    # pair[i, j] = sum over transitions into p >= 1 of
    # alpha_{p-1}[i] * w_p * xn_p[j]
    pair = torch.einsum(
        "bli,blj->ij", alpha[:, :-1] * w_all[:, 1:, None], xn_all[:, 1:]
    )
    if st.values is None:
        return start, pair, em
    return start, pair, em, gauss_stats(gamma_w, st.values)


def em_bwd_stats(log_trans, log_em, symbols, lengths, alpha, m_raw,
                 obs_weights=None, gauss_params=None, gauss_values=None):
    """K1 reverse: (start f32[S], pair f32[S, S], em f32[S, T, V]) from
    the forward's alpha_p and m_raw, and with gaussian tracks a fourth
    element, the moments (gn, gx, gx2) each f32[S, G].  ``pair``
    excludes the transition factor: expected transition counts are
    pair * exp(log_trans).  Segment weights scale the emission counts and
    the moments; start counts and pairs are unweighted.

    Replaces ``_make_bwd_stats_kernel_v4`` (pallas_kernels.py:1931).
    Bound: as ``em_fwd``, with a second divide and row max on the chain
    and, off it, the pair update (a second S x S product), T scattered
    shared-memory adds and 3G moment adds.  Design: one warp per row
    walking from its last valid position down, obs recomputed from the
    symbols (and the streams), each warp's statistics in its own
    shared-memory accumulators (4, 2 or 1 warps per block, the most that
    fit; lane j owns row j of the emission counts and the moments); each
    block writes one partial, summed here over blocks in a fixed order
    (no atomics: two runs give the same bits).  In the step of
    ``k1_step`` (``em_fwd``'s; to 32 states lane j also keeps column j of
    pair in registers and alpha_p and m_raw come through the ring, at the
    same warps a block), so either gives the other's bits."""
    S, T, V = log_em.shape
    B, L, _T = symbols.shape
    dev = _check_k1_inputs(log_em, symbols, lengths, log_trans=log_trans,
                           alpha=alpha, m_raw=m_raw)
    st = _streams(symbols, S, obs_weights, gauss_params, gauss_values)
    if _device_kind(dev) == "cpu":
        return em_bwd_stats_plain(log_trans, log_em, symbols, lengths,
                                  alpha, m_raw, st.w, st.gauss, st.values)
    G = st.G
    warps = _k1_bwd_warps(S, T, V, G)
    _check_envelope(S, _k1_smem_floats(S, T, V, warps, G)[1], "em_bwd_stats",
                    _K1_ENVELOPE_ITEM)
    _check_index_range(symbols, V, "symbols")
    n_blocks = -(-B // warps)
    pair = torch.empty((n_blocks, S, S), dtype=torch.float32, device=dev)
    em = torch.empty((n_blocks, S, T, V), dtype=torch.float32, device=dev)
    start = torch.empty((n_blocks, S), dtype=torch.float32, device=dev)
    gmom = torch.empty((n_blocks, S, 3 * G), dtype=torch.float32,
                       device=dev)
    if B and L:
        trans_p = torch.exp(log_trans)
        _coef, stream_args = st.args()
        _launch_streaming("em_bwd_stats" + st.suffix,
                          _K1_ENTRIES[k1_step(S, T, V, G)][1], (
            symbols.data_ptr(), lengths.data_ptr(), trans_p.data_ptr(),
            log_em.data_ptr(), alpha.data_ptr(), m_raw.data_ptr(),
            pair.data_ptr(), em.data_ptr(), start.data_ptr(),
            gmom.data_ptr() if G else None, B, L, S, T, V, warps,
            *stream_args), dev)
    elif B:
        pair, em, start, gmom = (torch.zeros_like(x)
                                 for x in (pair, em, start, gmom))
    out = (start.sum(0), pair.sum(0), em.sum(0))
    if st.values is None:
        return out
    return out + (_split_moments(gmom.sum(0), G),)


def _loglik_rows(alpha, dm, lengths):
    """Per-row loglik: log sum of the last alpha_p row plus the summed
    increments (one reduction), 0 for zero-length rows."""
    ll = torch.log(alpha[:, -1].sum(dim=-1)) + dm.sum(dim=1)
    return torch.where(lengths > 0, ll, 0.0)


def em_counts_fused_plain(log_start, log_trans, log_em, symbols, lengths,
                          obs_weights=None, gauss_params=None,
                          gauss_values=None):
    """Plain version of ``em_counts_fused``."""
    alpha, dm, m_raw = em_fwd_plain(log_start, log_trans, log_em, symbols,
                                    lengths, obs_weights, gauss_params,
                                    gauss_values)
    stats = em_bwd_stats_plain(log_trans, log_em, symbols, lengths, alpha,
                               m_raw, obs_weights, gauss_params,
                               gauss_values)
    return stats[:3] + (_loglik_rows(alpha, dm, lengths),) + stats[3:]


def em_counts_fused(log_start, log_trans, log_em, symbols, lengths,
                    obs_weights=None, gauss_params=None, gauss_values=None):
    """Symbols-in/statistics-out E-step with the JAX signature of
    ``em_counts_fused_pallas_v4``: (start f32[S], pair f32[S, S],
    em f32[S, T, V], loglik f32[B]) and, with gaussian tracks, a fifth
    element (gn, gx, gx2).  The card holds the batch's alpha_p between
    the two kernels; the finish (sums over blocks, per-row loglik) is a
    few small torch reductions, as on the TPU."""
    alpha, dm, m_raw = em_fwd(log_start, log_trans, log_em, symbols,
                              lengths, obs_weights, gauss_params,
                              gauss_values)
    stats = em_bwd_stats(log_trans, log_em, symbols, lengths, alpha, m_raw,
                         obs_weights, gauss_params, gauss_values)
    return stats[:3] + (_loglik_rows(alpha, dm, lengths),) + stats[3:]


# ---------------------------------------------------------------------
# K4: the fused max-posterior decode (K1's forward, then the decode)
# ---------------------------------------------------------------------

def post_decode_plain(log_trans, log_em, symbols, lengths, alpha,
                      with_margin=False, obs_weights=None,
                      gauss_params=None, gauss_values=None):
    """Plain version of ``post_decode``: the reverse walk as a loop over
    positions, batched over rows.  ``with_margin`` also returns, per
    position, how close the decision was: (top1 - top2) / top1 of
    alpha_p * b (1 at padding and for S = 1)."""
    obs = _streams(symbols, log_em.shape[0], obs_weights, gauss_params,
                   gauss_values).obs(log_em, symbols)
    B, L, S = obs.shape
    dev = obs.device
    obs_p = torch.exp(obs - obs.amax(dim=-1, keepdim=True))
    trans_p = torch.exp(log_trans)
    lens = lengths.to(torch.int64)
    b = torch.ones((B, S), dtype=torch.float32, device=dev)
    path = torch.zeros((B, L), dtype=torch.int32, device=dev)
    margin = torch.ones((B, L), dtype=torch.float32, device=dev)
    for p in range(L - 1, -1, -1):
        valid = p < lens
        ab = alpha[:, p] * b
        path[:, p] = torch.where(valid, torch.argmax(ab, dim=-1), 0)
        if with_margin and S > 1:
            top = torch.topk(ab, 2, dim=-1).values
            gap = (top[:, 0] - top[:, 1]) / torch.clamp(top[:, 0],
                                                         min=1e-37)
            margin[:, p] = torch.where(valid, gap, 1.0)
        x = obs_p[:, p] * b
        xm = torch.clamp(x.amax(dim=-1), min=1e-37)
        sb = (x / xm[:, None]) @ trans_p.T
        nm = torch.clamp(sb.amax(dim=-1), min=1e-37)
        b = torch.where(valid[:, None], sb / nm[:, None], b)
    return (path, margin) if with_margin else path


def post_decode(log_trans, log_em, symbols, lengths, alpha,
                obs_weights=None, gauss_params=None, gauss_values=None):
    """K4 decode: int32 path [B, L] from K1's forward rows alpha_p
    f32[B, L, S] (``em_fwd``, given the same streams).  Each row walks
    from its last valid position down with b = 1; position p takes the
    first-hit argmax (lowest state on ties) of alpha_p[p] * b, then b
    steps back through obs_p and the transitions, rescaled to max 1.
    Positions at or past a row's length get 0.

    Replaces ``_make_post_decode_kernel_v4`` (pallas_kernels.py:2765).
    Bound on an H100: the latency of one dependent step per position (an
    S x S product, two max reductions across the warp and two divides),
    not bytes or flops.  Design: K1's reverse kernel without the
    statistics: one warp per row, lane <-> state, log_em and the gaussian
    coefficients in shared memory, obs formed on the card from the
    symbols and streams, alpha_p read once, in the step of ``k4_step``:
    to 32 states row i of exp(trans) in lane i's registers, the row round
    by shuffles, the symbols, streams and alpha_p staged with cp.async a
    half of 32 positions ahead in reverse, a half's obs formed before its
    steps and its argmaxes after them (counted as ``post_decode_lanes``);
    beyond, exp(trans) and the row in shared memory, obs and the argmax
    in the step.  Either gives the other's bits; true float32 where the
    TPU kernel split its dots into bf16 passes."""
    S, T, V = log_em.shape
    B, L, _T = symbols.shape
    dev = _check_k1_inputs(log_em, symbols, lengths, log_trans=log_trans,
                           alpha=alpha)
    st = _streams(symbols, S, obs_weights, gauss_params, gauss_values)
    if _device_kind(dev) == "cpu":
        return post_decode_plain(log_trans, log_em, symbols, lengths, alpha,
                                 obs_weights=st.w, gauss_params=st.gauss,
                                 gauss_values=st.values)
    step = k4_step(S, T, V, st.G)
    _check_index_range(symbols, V, "symbols")
    path = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return path
    trans_p = torch.exp(log_trans)
    _coef, stream_args = st.args()
    counter, entry = _K4_ENTRIES[step]
    _launch_streaming(counter + st.suffix, entry, (
        symbols.data_ptr(), lengths.data_ptr(), trans_p.data_ptr(),
        log_em.data_ptr(), alpha.data_ptr(), path.data_ptr(), B, L, S, T,
        V, *stream_args), dev)
    return path


def posterior_decode_fused(log_start, log_trans, log_em, symbols, lengths,
                           obs_weights=None, gauss_params=None,
                           gauss_values=None):
    """Symbols-in/path-out max-posterior decode with the JAX signature of
    ``posterior_decode_fused_pallas_v4``: int32 argmax-gamma path [B, L],
    0 at padding and for zero-length rows.  ``em_fwd`` writes alpha_p,
    and also its dm and m_raw rows, which the decode does not read (kept:
    8 bytes a position beside alpha_p's 4*S, and K1's forward stays one
    kernel).  Normalizers cancel in the per-position argmax, so no loglik
    is formed.  Both kernels take the optional streams."""
    alpha, _dm, _m_raw = em_fwd(log_start, log_trans, log_em, symbols,
                                lengths, obs_weights, gauss_params,
                                gauss_values)
    return post_decode(log_trans, log_em, symbols, lengths, alpha,
                       obs_weights, gauss_params, gauss_values)


# ---------------------------------------------------------------------
# X1, X2: the carried forward/backward chunk sweeps
# ---------------------------------------------------------------------

def _check_sweep(log_trans, obs, carry, lengths, carry_name):
    B, L, S = obs.shape
    dev = obs.device
    _check(log_trans, "log_trans", torch.float32, (S, S), dev)
    _check(obs, "obs", torch.float32, (B, L, S), dev)
    _check(carry, carry_name, torch.float32, (B, S), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    for t, name in ((log_trans, "log_trans"), (obs, "obs"),
                    (carry, carry_name), (lengths, "lengths")):
        _check_contiguous(t, name)
    return dev


# X1's step, by S alone (csrc/posterior.cu), as K3's (``k3_step``):
# "lanes" to this many states (lane j holds exp(trans) column j in
# registers and forms expf of its own state; the expf row and the new row
# go round by shuffles), "shared" to ``sweep_fits``' 239
# (``logdot_renorm``: the row and exp(trans) in shared memory), "tile"
# beyond (K7a in carry mode, csrc/scans.cu, on the kernel of
# ``log_scan_route``: the rows kernel to 256 states).  The lanes and shared
# steps give the same bits, so the choice moves only time.
X1_LANES_MAX_STATES = 32
_X1_ENTRIES = {"lanes": "tehmm_x1_sweep_lanes",
               "shared": "tehmm_x1_sweep_smem"}


def x1_step(S: int) -> str:
    """X1's step variant at S states: ``"lanes"``, ``"shared"`` or
    ``"tile"`` (see ``X1_LANES_MAX_STATES``)."""
    if S <= X1_LANES_MAX_STATES:
        return "lanes"
    return "shared" if sweep_fits(S) else "tile"


def _x1_launch(name, log_trans, obs, a_hat_init, lengths, hats, dm, ckpt,
               chunk, n_ck):
    """Launch X1's one-warp step of ``x1_step(S)`` (not the tile): hats
    (values mode) and dm (carry-only mode) may be None; ckpt takes the
    carry leaving every chunk of ``chunk`` positions, n_ck of them."""
    B, L, S = obs.shape
    trans_p = torch.exp(log_trans)
    _launch_streaming(name, _X1_ENTRIES[x1_step(S)], (
        obs.data_ptr(), a_hat_init.data_ptr(), lengths.data_ptr(),
        trans_p.data_ptr(), None if hats is None else hats.data_ptr(),
        None if dm is None else dm.data_ptr(), ckpt.data_ptr(), B, L, S,
        chunk, n_ck), obs.device)


def _fwd_chunk(log_trans, obs, a_hat_init, lengths, values):
    B, L, S = obs.shape
    dev = _check_sweep(log_trans, obs, a_hat_init, lengths, "a_hat_init")
    if _device_kind(dev) == "cpu":
        plain = dp.forward_chunk_values if values else dp.forward_final
        return plain(log_trans, obs, a_hat_init, lengths)
    _check_tile(S, "forward chunk sweep")
    carry = torch.empty((B, S), dtype=torch.float32, device=dev)
    hats = torch.empty((B, L, S), dtype=torch.float32, device=dev) \
        if values else None
    dm = None if values else torch.empty((B, L), dtype=torch.float32,
                                         device=dev)
    if B and x1_step(S) == "tile":
        trans_p = torch.exp(log_trans)
        _launch_scan("fwd_chunk_tile", "tehmm_fwd_chunk_tile", S, (
            obs.data_ptr(), a_hat_init.data_ptr(), lengths.data_ptr(),
            trans_p.data_ptr(), None if hats is None else hats.data_ptr(),
            carry.data_ptr(), None if dm is None else dm.data_ptr(), B, L,
            S), dev)
    elif B:   # the final carry is the checkpoint of one chunk of the row
        _x1_launch("fwd_chunk", log_trans, obs, a_hat_init, lengths, hats,
                   dm, carry, max(L, 1), 1)
    if values:
        return hats, carry
    return carry, dm.sum(dim=1)


def forward_chunk_values(log_trans, obs, a_hat_init, lengths):
    """X1: every scaled alpha row f32[B, Lc, S] of one chunk and the
    final carry f32[B, S], from the incoming carry
    (``dp.forward_chunk_values`` semantics; int32 lengths).  The exact
    posteriors' recompute: it gives every (table, chunk) of a group a
    row, each from that chunk's stored carry.

    No Pallas counterpart: on the TPU this is the XLA scan of
    ``tehmm_tpu/ops/dp.py:480``.  Bound on an H100: the latency of one
    dependent log-space step per position (S expf, an S x S product, S
    logf, a max), one warp a row.  Design: the step of ``x1_step(S)``
    (registers and shuffles to 32 states, ``logdot_renorm`` in shared
    memory to 239), obs read ahead of the chain (a cp.async ring in
    shared memory, or registers a few positions ahead), the row stopped
    at its length; beyond, to 256 states, K7a's rows kernel in carry mode
    (``csrc/scans.cu`` ``fwd_scaled_rows_kernel``, ``log_scan_route``),
    counted as ``fwd_chunk_rows`` (the block tile's, forced, as
    ``fwd_chunk_tile``), and from 257 states the cluster tile's (counted
    as ``fwd_chunk_cluster``).  Each
    kernel sums every product in an order that depends on S alone, so a
    sweep cut into chunks gives the bits of one chunk, and every mode ends
    in the same carry."""
    return _fwd_chunk(log_trans, obs, a_hat_init, lengths, True)


def forward_final(log_trans, obs, a_hat_init, lengths):
    """X1 in carry-only mode: (final carry f32[B, S], the chunk's summed
    normalizer increments f32[B]) (``dp.forward_final`` semantics, JAX
    ``ops/dp.py:378``; int32 lengths).  The kernel writes each position's
    increment; they are summed here in one reduction, not as a running
    sum in the warp, which keeps the loglik's accuracy on long inputs."""
    return _fwd_chunk(log_trans, obs, a_hat_init, lengths, False)


def forward_checkpoints(log_trans, obs, a_hat_init, lengths, chunk):
    """X1 in checkpoint mode: the carry leaving every chunk of ``chunk``
    positions, f32[B, ceil(L / chunk), S] (``dp.forward_checkpoints``:
    ``dp.forward_final``'s carry chained chunk by chunk; int32 lengths
    over all L positions).  The exact posteriors' forward sweep: one
    launch walks each row over a whole group of chunks, where
    ``forward_final`` took a launch a chunk.  Counted as
    ``fwd_checkpoints``; past 239 states one launch of the carry mode a
    chunk (``scan_counter``: ``fwd_chunk_rows`` to 256 states).  Bound and design as
    ``forward_chunk_values``; the same step, so the same carries."""
    B, L, S = obs.shape
    dev = _check_sweep(log_trans, obs, a_hat_init, lengths, "a_hat_init")
    if chunk < 1:
        raise ValueError(f"chunk: must be at least 1, got {chunk}")
    if _device_kind(dev) == "cpu":
        return dp.forward_checkpoints(log_trans, obs, a_hat_init, lengths,
                                      chunk)
    _check_tile(S, "forward_checkpoints")
    n_ck = -(-L // chunk)
    out = torch.empty((B, n_ck, S), dtype=torch.float32, device=dev)
    if B == 0 or n_ck == 0:
        return out
    if x1_step(S) != "tile":
        _x1_launch("fwd_checkpoints", log_trans, obs, a_hat_init, lengths,
                   None, None, out, chunk, n_ck)
        return out
    carry = a_hat_init
    for k in range(n_ck):
        part = obs[:, k * chunk:(k + 1) * chunk].contiguous()
        lens = torch.clamp(lengths - k * chunk, 0, chunk).to(torch.int32)
        carry, _ = forward_final(log_trans, part, carry, lens)
        out[:, k] = carry
    return out


# The piece-operator scan's operators of one launch stay under this
# many bytes: rows go in groups (each row's bits are its own), so many
# tables at large S do not take [B, n_pieces, S, S] at once.
_PIECE_OPS_BYTES = 1 << 28
# Which chunks ``forward_loglik`` gives the pieces.  Phase A's warps
# each take X1's S^2 step, S of them a piece, so the pieces do S times
# the chain's arithmetic and win only while the card hides it.  The
# chain's time is one row's, whatever the rows, until they fill the
# card; phase A's grows with the rows once its warps pass a wave.  So
# (S at most, rows at most): the most rows of 4096 at which the pieces
# still beat the chain at that S, with every row full (a chunk's most
# work for the pieces), read by ``tools/time_score`` on an H100 (PERF.md);
# an S between two entries takes the next entry's rows, since the
# crossover falls as S grows.  The entries to 32 states were read against
# X1's lanes step (``x1_step``), which took the chain from ~2.8 to ~1.15
# ms a chunk at S=10.  Past 168 states phase A's block (T and 4
# warps) fits an SM once: four rows of 4096 took the pieces 52.0 ms
# against the chain's 39.0 at 169.  By the chunk's shape alone, never by
# the card or a failure.
PIECE_SCAN_MAX_ROWS = ((10, 96), (32, 32), (64, 32), (96, 16), (128, 8),
                       (168, 4))
PIECE_SCAN_MAX_STATES = PIECE_SCAN_MAX_ROWS[-1][0]


def piece_scan_route(B: int, S: int) -> bool:
    """Whether ``forward_loglik`` gives a chunk of ``B`` rows at ``S``
    states to the pieces (else ``forward_final``'s kernels)."""
    for max_s, max_rows in PIECE_SCAN_MAX_ROWS:
        if S <= max_s:
            return B <= max_rows
    return False


def _check_pieces(S, what):
    if not sweep_fits(S):
        raise NotImplementedError(
            f"{what}: S={S} is past sweep_fits (S <= 239: the transition "
            f"matrix and the exchange rows in one block's shared memory); "
            f"forward_loglik takes the tile's carry mode there")


def piece_operators(log_trans, obs, lengths):
    """``fwd_piece_ops``: phase A of the piece-operator scan,
    ``dp.piece_operators`` (its plain version, which the CPU takes), for
    the pieces that start before a row's length; on the card the others
    are left unwritten, since phase B skips them.  Returns (probs
    f32[B, n_pieces, S, S], log_scale f64[B, n_pieces, S])."""
    B, L, S = obs.shape
    dev = obs.device
    _check(log_trans, "log_trans", torch.float32, (S, S), dev)
    _check(obs, "obs", torch.float32, (B, L, S), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    for t, name in ((log_trans, "log_trans"), (obs, "obs"),
                    (lengths, "lengths")):
        _check_contiguous(t, name)
    if _device_kind(dev) == "cpu":
        return dp.piece_operators(log_trans, obs, lengths)
    _check_pieces(S, "piece operators")
    n_p = -(-L // dp.PIECE)
    probs = torch.empty((B, n_p, S, S), dtype=torch.float32, device=dev)
    log_scale = torch.empty((B, n_p, S), dtype=torch.float64, device=dev)
    trans_p = torch.exp(log_trans)
    _launch_streaming("fwd_piece_ops", "tehmm_fwd_piece_ops", (
        obs.data_ptr(), lengths.data_ptr(), trans_p.data_ptr(),
        probs.data_ptr(), log_scale.data_ptr(), B, L, S, dp.PIECE), dev)
    return probs, log_scale


def compose_pieces(probs, log_scale, a_hat_init, lengths):
    """``fwd_piece_compose``: phase B of the piece-operator scan,
    ``dp.compose_pieces`` (its plain version, which the CPU takes).
    Returns (final carry f32[B, S], increments f64[B, n_pieces])."""
    B, n_p, S, _ = probs.shape
    dev = probs.device
    _check(probs, "probs", torch.float32, (B, n_p, S, S), dev)
    _check(log_scale, "log_scale", torch.float64, (B, n_p, S), dev)
    _check(a_hat_init, "a_hat_init", torch.float32, (B, S), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    for t, name in ((probs, "probs"), (log_scale, "log_scale"),
                    (a_hat_init, "a_hat_init"), (lengths, "lengths")):
        _check_contiguous(t, name)
    if _device_kind(dev) == "cpu":
        return dp.compose_pieces(probs, log_scale, a_hat_init, lengths)
    _check_pieces(S, "piece composition")
    carry = torch.empty((B, S), dtype=torch.float32, device=dev)
    incs = torch.empty((B, n_p), dtype=torch.float64, device=dev)
    _launch_streaming("fwd_piece_compose", "tehmm_fwd_piece_compose", (
        probs.data_ptr(), log_scale.data_ptr(), a_hat_init.data_ptr(),
        lengths.data_ptr(), carry.data_ptr(), incs.data_ptr(), B,
        n_p * dp.PIECE, S, dp.PIECE), dev)
    return carry, incs


def forward_loglik(log_trans, obs, a_hat_init, lengths):
    """X1's carry-only function, ``forward_final``'s signature, checks
    and return values (final carry f32[B, S], the chunk's summed
    normalizer increments f32[B]), as a sequence-parallel piece-operator
    scan: the route of ``MultitrackHmm.score``.

    Bound on an H100: ``forward_final``'s chain of Lc dependent steps on
    one warp a row.  Design: ``fwd_piece_ops`` gives every (row, piece of
    ``dp.PIECE`` positions, state) a warp that runs X1's step over the
    piece from that state alone, which makes the piece's S x S operator;
    ``fwd_piece_compose`` composes a row's pieces in order behind the
    carry, one warp a row; the increments are summed in one reduction.
    So the longest chain is 2 x 128 steps for a chunk of 16384, for S
    times the chain's arithmetic.  Where ``piece_scan_route(B, S)``;
    elsewhere ``forward_final``'s kernels (the chain, and past
    ``sweep_fits`` the tile's carry mode).  On the CPU ``dp.forward_final``, the chain
    (its plain version, the pieces by ``dp.forward_loglik_pieces``, is
    what the kernels are held to)."""
    B, L, S = obs.shape
    dev = _check_sweep(log_trans, obs, a_hat_init, lengths, "a_hat_init")
    if _device_kind(dev) == "cpu":
        return dp.forward_final(log_trans, obs, a_hat_init, lengths)
    if not piece_scan_route(B, S):
        return _fwd_chunk(log_trans, obs, a_hat_init, lengths, False)
    if B == 0 or L == 0:
        return (a_hat_init.clone(),
                torch.zeros((B,), dtype=torch.float32, device=dev))
    n_p = -(-L // dp.PIECE)
    rows = max(1, _PIECE_OPS_BYTES // (n_p * S * (4 * S + 8)))
    carry, incs = [], []
    for lo in range(0, B, rows):
        part = slice(lo, lo + rows)
        c, i = compose_pieces(*piece_operators(log_trans, obs[part],
                                               lengths[part]),
                              a_hat_init[part], lengths[part])
        carry.append(c)
        incs.append(i)
    return (torch.cat(carry), torch.cat(incs).sum(dim=1).to(torch.float32))


# X2's step, by S alone (csrc/posterior.cu), as X1's (``x1_step``):
# "lanes" to this many states (lane i holds exp(trans) row i in registers
# and forms expf of its own state; the expf row, beta and x go round by
# shuffles), "shared" to ``sweep_fits``' 239 (``logdot_renorm``), "tile"
# beyond (K7b in carry mode, csrc/scans.cu, on the kernel of
# ``log_scan_route``).  The lanes and shared
# steps give the same bits, so the choice moves only time.
X2_LANES_MAX_STATES = 32
_X2_ENTRIES = {"lanes": "tehmm_x2_sweep_lanes",
               "shared": "tehmm_x2_sweep_smem"}


def x2_step(S: int) -> str:
    """X2's step variant at S states: ``"lanes"``, ``"shared"`` or
    ``"tile"`` (see ``X2_LANES_MAX_STATES``)."""
    if S <= X2_LANES_MAX_STATES:
        return "lanes"
    return "shared" if sweep_fits(S) else "tile"


def _check_backward(log_trans, obs, x_carry, continuing, lengths):
    dev = _check_sweep(log_trans, obs, x_carry, lengths, "x_carry")
    _check(continuing, "continuing", torch.bool, (obs.shape[0],), dev)
    return dev


def _x2_launch(name, log_trans, obs, x_carry, continuing, lengths, beta,
               ckpt, chunk, n_ck):
    """Launch X2's one-warp step of ``x2_step(S)`` (not the tile): beta
    (values mode) may be None; ckpt takes x at the first position of every
    chunk of ``chunk`` positions, n_ck of them."""
    B, L, S = obs.shape
    trans_p = torch.exp(log_trans)
    cont = continuing.to(torch.int32)
    _launch_streaming(name, _X2_ENTRIES[x2_step(S)], (
        obs.data_ptr(), x_carry.data_ptr(), cont.data_ptr(),
        lengths.data_ptr(), trans_p.data_ptr(),
        None if beta is None else beta.data_ptr(), ckpt.data_ptr(), B, L, S,
        chunk, n_ck), obs.device)


def backward_chunk_values(log_trans, obs, x_carry, continuing, lengths):
    """X2: every scaled beta row f32[B, Lc, S] of one chunk and x_out
    f32[B, S] (``dp.backward_chunk_values`` semantics; bool continuing,
    int32 lengths).  The exact posteriors' beta recompute: it gives every
    (table, chunk) of a group a row, each from that chunk's stored
    x_carry and with its own ``continuing``.

    No Pallas counterpart: on the TPU this is the XLA scan of
    ``tehmm_tpu/ops/dp.py:507``.  Bound and design as
    ``forward_chunk_values``, walking the chunk from its end (the step of
    ``x2_step(S)``, obs read ahead in reverse, the chain stopped at the
    row's length; the boundary step from ``x_carry`` and ``x_out`` by the
    same step, so a sweep cut into chunks gives the bits of one chunk over
    the whole row); beyond ``sweep_fits(S)`` K7b's tile in carry mode
    (``csrc/scans.cu`` ``bwd_scaled_kernel``: the boundary step and x_out
    inside the same kernel; to 256 states ``bwd_scaled_rows_kernel``,
    ``log_scan_route``), counted as ``bwd_chunk_rows`` (the block tile's,
    forced, as ``bwd_chunk_tile``); from 257 states the cluster tile's
    (``bwd_chunk_cluster``)."""
    B, L, S = obs.shape
    dev = _check_backward(log_trans, obs, x_carry, continuing, lengths)
    if L == 0:
        raise ValueError("obs: a chunk needs at least one position")
    if _device_kind(dev) == "cpu":
        return dp.backward_chunk_values(log_trans, obs, x_carry, continuing,
                                        lengths)
    _check_tile(S, "backward chunk sweep")
    beta = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    x_out = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0:
        return beta, x_out
    if x2_step(S) != "tile":   # x_out is the checkpoint of one chunk
        _x2_launch("bwd_chunk", log_trans, obs, x_carry, continuing,
                   lengths, beta, x_out, L, 1)
        return beta, x_out
    cont = continuing.to(torch.int32)
    trans_t = torch.exp(log_trans).T.contiguous()
    _launch_scan("bwd_chunk_tile", "tehmm_bwd_chunk_tile", S, (
        obs.data_ptr(), x_carry.data_ptr(), cont.data_ptr(),
        lengths.data_ptr(), trans_t.data_ptr(), beta.data_ptr(),
        x_out.data_ptr(), B, L, S), dev)
    return beta, x_out


def backward_checkpoints(log_trans, obs, x_carry, continuing, lengths,
                         chunk):
    """X2 in checkpoint mode: the x_out of every chunk of ``chunk``
    positions, f32[B, ceil(L / chunk), S], row c the x_carry that chunk
    c - 1 takes (``dp.backward_checkpoints``: ``dp.backward_chunk_values``
    chained from the last chunk; int32 lengths over all L positions, bool
    ``continuing``: the row runs past the span; inside it a chunk
    continues where the row's length passes its end).  The exact
    posteriors' backward sweep: one launch walks each row over a whole
    group of chunks from its end, where ``backward_chunk_values`` took a
    launch a chunk.  Counted as ``bwd_checkpoints``; past 239 states one
    launch of the carry mode a chunk (``scan_counter``: ``bwd_chunk_rows``
    to 256 states).  Bound
    and design as ``backward_chunk_values``; the same step, so the same
    carries."""
    B, L, S = obs.shape
    dev = _check_backward(log_trans, obs, x_carry, continuing, lengths)
    if chunk < 1:
        raise ValueError(f"chunk: must be at least 1, got {chunk}")
    if _device_kind(dev) == "cpu":
        return dp.backward_checkpoints(log_trans, obs, x_carry, continuing,
                                       lengths, chunk)
    _check_tile(S, "backward_checkpoints")
    n_ck = -(-L // chunk)
    out = torch.empty((B, n_ck, S), dtype=torch.float32, device=dev)
    if B == 0 or n_ck == 0:
        return out
    if x2_step(S) != "tile":
        _x2_launch("bwd_checkpoints", log_trans, obs, x_carry, continuing,
                   lengths, None, out, chunk, n_ck)
        return out
    x = x_carry
    for k in reversed(range(n_ck)):
        part = obs[:, k * chunk:(k + 1) * chunk].contiguous()
        lens = torch.clamp(lengths - k * chunk, 0, chunk).to(torch.int32)
        cont = continuing if k == n_ck - 1 else lengths > (k + 1) * chunk
        _, x = backward_chunk_values(log_trans, part, x, cont, lens)
        out[:, k] = x
    return out


# ---------------------------------------------------------------------
# K5, K6: the streaming scans over a precomputed observation tensor
# ---------------------------------------------------------------------

_PROB_FLOOR = 1e-37   # floor of every max the prob-space scans divide by


def _check_streaming(log_trans, obs, lengths, obs_name, what,
                     log_start=None):
    """Argument checks shared by the three streaming wrappers; returns
    the device."""
    B, L, S = obs.shape
    dev = obs.device
    tables = [(log_trans, "log_trans", (S, S))]
    if log_start is not None:
        tables.append((log_start, "log_start", (S,)))
    for t, name, shape in tables + [(obs, obs_name, (B, L, S))]:
        _check(t, name, torch.float32, shape, dev)
        _check_contiguous(t, name)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    _check_contiguous(lengths, "lengths")
    if L == 0:
        raise ValueError(f"{obs_name}: a scan needs at least one position")
    if _device_kind(dev) == "cuda":
        _check_tile(S, what)
    return dev


def _launch_streaming(name, entry, args, dev):
    lib = load_library()
    rc = getattr(lib, entry)(*args, _stream(dev))
    _raise_on(rc, lib, name)
    LAUNCHES[name] += 1


def viterbi_values_plain(log_start, log_trans, obs, lengths):
    """Plain version of ``viterbi_values``: the max-plus forward of
    ``dp.viterbi`` from ``log_start`` as a loop over positions, batched
    over rows, with the kernels' masking (positions at or past a row's
    length carry the row and add a zero normalizer, so zero-length rows
    carry a zero row)."""
    B, L, S = obs.shape
    lens = lengths.to(torch.int64)
    v_hat = torch.zeros((B, S), dtype=torch.float32, device=obs.device)
    rows, dms = [], []
    for t in range(L):
        if t == 0:
            base = log_start[None, :]
        else:
            base = (v_hat[:, :, None] + log_trans[None, :, :]).amax(dim=1)
        new_hat, m = dp._renorm(base + obs[:, t])
        valid_t = t < lens
        v_hat = dp._mask_carry(new_hat, v_hat, valid_t)
        rows.append(v_hat)
        dms.append(torch.where(valid_t, m, 0.0))
    return torch.stack(rows, dim=1), torch.stack(dms, dim=1)


def viterbi_values(log_start, log_trans, obs, lengths):
    """K5: (v_hats f32[B, L, S], dm f32[B, L]) from obs f32[B, L, S] and
    int32 lengths [B].  Row t is the max-normalized Viterbi value row at
    position t (position 0 takes ``log_start``), dm[b, t] its normalizer;
    positions at or past a row's length carry the row with dm 0, so
    zero-length rows are all zero.  ``dp.viterbi_streaming`` adds the
    score and the backtrace.

    Replaces ``_viterbi_values_v3(carry_mode=False)``
    (pallas_kernels.py:1374, kernel ``_make_viterbi_kernel_v3`` :1284)
    under ``viterbi_pallas_v3`` (:1453); the JAX function returns the
    rows time-major, [L, B, S] and [L, B].  Bound on an H100: the bytes of
    obs and the rows at S = 20, the 2 S^2 add-and-max operations per
    position at S = 256; in practice the chain of L dependent steps.
    Design (``csrc/streaming.cu``, route ``log_scan_route``): to 32 states
    the lanes step (``viterbi_values_lanes_kernel``, counted as
    ``viterbi_values_lanes``: K3's max-plus step, a warp a row, column j
    of log_trans in lane j's registers, the whole row in every lane, no
    shared memory or barrier in the chain); from 33 to 256 the rows kernel
    (``viterbi_values_rows_kernel``, ``csrc/scan_rows.cuh``, counted as
    ``viterbi_values_rows``: a block of R rows, each thread one chain of
    partial maxima of four columns of all R rows, the matrix's first rows
    in registers and the rest in shared memory, its pads -inf, two
    barriers a step).  The max is exact and each add rounds once, so every
    route gives the bits of the block tile (``viterbi_values_kernel``, a
    thread a state, forced with ``LOG_SCAN_MAX_STATES`` = 0, counted as
    ``viterbi_values``).  From 257 states (``scan_route``) the cluster
    tile (``csrc/scan_cluster.cuh``, counted as
    ``viterbi_values_cluster``): a cluster of up to 16 blocks owns up to
    12 rows, each block a column slice of log_trans kept resident and the
    whole state vector, two exchanges across the cluster a step.  Takes S
    <= 1024.  Bit-equal to the plain version."""
    dev = _check_streaming(log_trans, obs, lengths, "obs", "viterbi_values",
                           log_start)
    if _device_kind(dev) == "cpu":
        return viterbi_values_plain(log_start, log_trans, obs, lengths)
    B, L, S = obs.shape
    v_hats = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    dm = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B:
        _launch_scan(
            "viterbi_values", "tehmm_viterbi_values", S,
            (obs.data_ptr(), lengths.data_ptr(), log_start.data_ptr(),
             log_trans.data_ptr(), v_hats.data_ptr(), dm.data_ptr(), B, L,
             S), dev)
    return v_hats, dm


def forward_prob_plain(log_start, log_trans, obs_p, lengths,
                       dtype=torch.float32):
    """Plain version of ``forward_prob``: a loop over positions, batched
    over rows; the step's product is a matrix product.  ``dtype`` is the
    type the scan is carried and returned in: float64 takes the kernel's
    float32 inputs (exp of the tables included) and gives a reference
    whose own rounding is negligible."""
    B, L, S = obs_p.shape
    dev = obs_p.device
    start_p = torch.exp(log_start).to(dtype)
    trans_p = torch.exp(log_trans).to(dtype)
    lens = lengths.to(torch.int64)
    p = torch.ones((B, S), dtype=dtype, device=dev)
    alpha = torch.empty((B, L, S), dtype=dtype, device=dev)
    dm = torch.empty((B, L), dtype=dtype, device=dev)
    for t in range(L):
        base = start_p[None, :] if t == 0 else p @ trans_p
        u = base * obs_p[:, t].to(dtype)
        m = torch.clamp(u.amax(dim=-1), min=_PROB_FLOOR)
        valid = t < lens
        p = torch.where(valid[:, None], u * (1.0 / m)[:, None], p)
        alpha[:, t] = p
        dm[:, t] = torch.where(valid, torch.log(m), 0.0)
    return alpha, dm


def forward_prob(log_start, log_trans, obs_p, lengths):
    """K6a: (alpha_p f32[B, L, S], dm f32[B, L]) from obs_p f32[B, L, S]
    in [0, 1] (``dp.scaled_obs_prob``) and int32 lengths [B].  Row t is
    the forward probability row scaled to max 1: u = (trans^T p) * obs_p[t]
    (position 0: start * obs_p[0]), m = max(max u, 1e-37), p' = u * (1/m),
    dm[b, t] = log m, which excludes the observations' own max.  Positions
    at or past a row's length carry the row with dm 0, so zero-length rows
    are all ones.  Scaled probabilities that underflow float32 flush to
    zero, as in the TPU kernel.

    Replaces ``forward_prob_pallas_v3`` (pallas_kernels.py:815, kernel
    ``_forward_kernel_v3`` :627).  Bound as ``viterbi_values``, with each
    output's S-term float32 sum as four interleaved FMA chains added
    pairwise, in an order that depends on S alone (no tensor cores, no
    TF32, no atomics: repeats give the same bits; within float32 rounding
    of the plain version's matrix product).  Design (``csrc/streaming.cu``,
    route ``log_scan_route``): to 32 states the lanes step
    (``fwd_prob_lanes_kernel``: a warp a row, column j of exp(log_trans)
    in lane j's registers, p round the warp by shuffles, no shared memory
    or barrier in the chain; counted as ``fwd_prob_lanes``); from 33 to
    256 the rows kernel (``fwd_prob_rows_kernel``, ``csrc/scan_rows.cuh``,
    counted as ``fwd_prob_rows``: a block of R rows, a float4 of the
    matrix for 4 R FMAs, two barriers a step; R by the card's occupancy,
    ``library_rows_plan``), each with the bits of the block tile
    (``fwd_prob_kernel``, forced with ``LOG_SCAN_MAX_STATES`` = 0, counted
    as ``fwd_prob``).  From 257 states (``scan_route``) the cluster tile
    (counted as ``fwd_prob_cluster``): each block's slice of
    exp(log_trans) resident, p itself the state vector, two exchanges
    across the cluster a step, with the staged tile's bits.  Takes S <=
    1024."""
    dev = _check_streaming(log_trans, obs_p, lengths, "obs_p",
                           "forward_prob", log_start)
    if _device_kind(dev) == "cpu":
        return forward_prob_plain(log_start, log_trans, obs_p, lengths)
    B, L, S = obs_p.shape
    alpha = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    dm = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B:
        start_p, trans_p = torch.exp(log_start), torch.exp(log_trans)
        _launch_scan(
            "fwd_prob", "tehmm_fwd_prob", S,
            (obs_p.data_ptr(), lengths.data_ptr(), start_p.data_ptr(),
             trans_p.data_ptr(), alpha.data_ptr(), dm.data_ptr(), B, L, S),
            dev)
    return alpha, dm


def backward_prob_plain(log_trans, obs_p, lengths, dtype=torch.float32):
    """Plain version of ``backward_prob``: a loop over positions from the
    end, batched over rows; ``dtype`` as in ``forward_prob_plain``."""
    B, L, S = obs_p.shape
    dev = obs_p.device
    trans_pt = torch.exp(log_trans).T.to(dtype)
    lens = lengths.to(torch.int64)
    b = torch.ones((B, S), dtype=dtype, device=dev)
    beta = torch.empty((B, L, S), dtype=dtype, device=dev)
    beta[:, L - 1] = b
    for t in range(L - 2, -1, -1):
        x = obs_p[:, t + 1].to(dtype) * b
        xm = torch.clamp(x.amax(dim=-1), min=_PROB_FLOOR)
        s = (x * (1.0 / xm)[:, None]) @ trans_pt
        nm = torch.clamp(s.amax(dim=-1), min=_PROB_FLOOR)
        b = torch.where((t + 1 < lens)[:, None], s * (1.0 / nm)[:, None], b)
        beta[:, t] = b
    return beta


def backward_prob(log_trans, obs_p, lengths):
    """K6b: beta_p f32[B, L, S] from obs_p f32[B, L, S] and int32 lengths
    [B].  beta_p[L - 1] is all ones; beta_p[t] steps back from t + 1
    where t + 1 < length (x = obs_p[t + 1] * b scaled by 1 / max(max x,
    1e-37), s = trans x scaled by 1 / max(max s, 1e-37)) and carries
    beta_p[t + 1] elsewhere, so a row is all ones from its last valid
    position on.

    Replaces ``backward_prob_pallas_v3`` (pallas_kernels.py:885, kernel
    ``_backward_kernel_v3`` :712), which streams a reversed, relaid copy
    of obs_p; this kernel reads obs_p as it is, from the end.  Bound and
    design as ``forward_prob``, with two max reductions per position: to
    32 states ``bwd_prob_lanes_kernel`` (counted as ``bwd_prob_lanes``),
    from 33 to 256 ``bwd_prob_rows_kernel`` (``bwd_prob_rows``, three
    barriers a step), the block tile's ``bwd_prob_kernel`` forced with
    ``LOG_SCAN_MAX_STATES`` = 0 (``bwd_prob``); on the cluster tile from
    257 states, counted as ``bwd_prob_cluster``, three exchanges a step.
    Takes S <= 1024."""
    dev = _check_streaming(log_trans, obs_p, lengths, "obs_p",
                           "backward_prob")
    if _device_kind(dev) == "cpu":
        return backward_prob_plain(log_trans, obs_p, lengths)
    B, L, S = obs_p.shape
    beta = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    if B:
        trans_pt = torch.exp(log_trans).T.contiguous()
        _launch_scan(
            "bwd_prob", "tehmm_bwd_prob", S,
            (obs_p.data_ptr(), lengths.data_ptr(), trans_pt.data_ptr(),
             beta.data_ptr(), B, L, S), dev)
    return beta


# ---------------------------------------------------------------------
# K7/K8: the log-space scaled scans and the pointer-writing Viterbi
# ---------------------------------------------------------------------

def scan_route(S: int) -> str:
    """The tile of the nine cluster scans at S states
    (``forward_scaled``, ``backward_scaled``, X1's and X2's carry modes,
    ``viterbi_values``, K3's carry mode, ``viterbi_pointers``,
    ``forward_prob`` and ``backward_prob``):
    ``"narrow"`` (the block tile, to 256 states, where all nine take
    their own kernels instead: ``log_scan_route``),
    ``"cluster"`` (the cluster tile, from 257 to
    ``SCAN_CLUSTER_MAX_STATES``), else ``"staged"`` (the block tile's wide
    form, to 1024)."""
    if S <= 256:
        return "narrow"
    return "cluster" if S <= SCAN_CLUSTER_MAX_STATES else "staged"


def _plan_kind(kernel) -> int:
    """``kernel``'s index in ``CLUSTER_PLAN_KINDS``; a bool names the
    backward (True) or the forward (False)."""
    if isinstance(kernel, str):
        return CLUSTER_PLAN_KINDS.index(kernel)
    return int(bool(kernel))


def cluster_plan(S: int, B: int, kernel, active) -> dict:
    """The plan of cluster kernel ``kernel`` (one of
    ``CLUSTER_PLAN_KINDS``, or a bool: the backward's or the forward's) at
    S states and B rows, as csrc/scan_cluster.cuh ``make_cluster_plan``
    makes it: C = ceil(S / 64)
    blocks a cluster, each owning Sc = ceil(S / C) states rounded up to 4;
    R rows a cluster; the block's column slice of the matrix, its rows
    below n_res in shared memory and the n_reg after them (to S & ~3) in
    registers, the last S % 4 in shared memory; smem bytes a block (the
    mbarriers, the state vectors [C Sc][R], the slice, the maxima of 8
    warps and of the cluster's C blocks, two buffers of those in the
    backwards K7b and K6b, and the lengths; K5's, K8c's and K6a's plans
    are the forward's);
    clusters of the grid.  ``active(R, smem)`` is the card's active
    clusters of the kernel at R (the launch asks
    ``cudaOccupancyMaxActiveClusters``).  R is the fewest rows whose
    clusters the card holds in one wave, else the most that fit; an R fits
    where n_reg <= 4 * ``_CLUSTER_REG_ROWS[R]`` (256, 320 at R = 12) and a
    cluster is active.  Raises where none fits."""
    if not 256 < S <= STREAMING_MAX_STATES:
        raise ValueError(f"the cluster tile takes 257 to "
                         f"{STREAMING_MAX_STATES} states, got {S}")
    C = -(-S // _CLUSTER_COLS)
    Sc = (-(-S // C) + 3) & ~3
    S4 = S & ~3
    n_max = 2 if CLUSTER_PLAN_KINDS[_plan_kind(kernel)] \
        in _CLUSTER_TWO_MAXIMA else 1
    plan, chosen_active = None, 0
    for R in _CLUSTER_ROWS:
        fixed = (8 + C * Sc * R + (S & 3) * Sc + _CLUSTER_WARPS * R
                 + n_max * C * R + R + 1)
        room = _SMEM_LIMIT // 4 - fixed
        if room < 0:
            continue
        n_res = min(S4, (room // Sc) & ~3)
        if S4 - n_res > 4 * _CLUSTER_REG_ROWS[R]:
            continue
        smem = 4 * (fixed + n_res * Sc)
        n = active(R, smem)
        if n < 1:
            continue
        # the first R that fits, replaced while it spills past one wave
        if plan is None or plan["clusters"] > chosen_active:
            plan = dict(C=C, Sc=Sc, R=R, n_res=n_res, n_reg=S4 - n_res,
                        smem=smem, clusters=-(-B // R))
            chosen_active = n
    if plan is None:
        raise RuntimeError(f"the cluster tile has no plan at S={S}")
    return plan


def library_cluster_plan(S: int, B: int, kernel) -> dict:
    """The plan the card's launch of ``kernel`` (as in ``cluster_plan``)
    takes (``tehmm_scan_cluster_plan``): ``cluster_plan``'s keys and
    ``active``, the card's active clusters of that kernel at each R of
    ``_CLUSTER_ROWS``.  Needs the card."""
    lib = load_library()
    out = (ctypes.c_int64 * (7 + len(_CLUSTER_ROWS)))()
    _raise_on(lib.tehmm_scan_cluster_plan(S, B, _plan_kind(kernel), out),
              lib, "the cluster tile's plan")
    keys = ("C", "Sc", "R", "n_res", "n_reg", "smem", "clusters")
    plan = dict(zip(keys, (int(v) for v in out[:7])))
    plan["active"] = [int(v) for v in out[7:]]
    return plan


def library_rows_plan(S: int, B: int, kernel="fwd_scaled") -> dict:
    """The plan the card's launch of rows kernel ``kernel`` (one of
    ``ROWS_PLAN_KINDS``, K3's carry mode's that of ``viterbi_values``, or
    its index there: a bool names the log-space backward or forward)
    takes at S states and B rows
    (``tehmm_rows_plan``): R, KR, threads, the card's SMs, ``per_sm`` (the
    blocks an SM holds at R = 1, 2 and 4) and the shared bytes at R.
    Needs the card."""
    kind = ROWS_PLAN_KINDS.index(kernel) if isinstance(kernel, str) \
        else int(kernel)
    lib = load_library()
    out = (ctypes.c_int64 * 8)()
    _raise_on(lib.tehmm_rows_plan(S, B, kind, out), lib,
              "the rows kernels' plan")
    R, KR, threads, sms, p1, p2, p4, smem = (int(v) for v in out)
    return dict(R=R, KR=KR, threads=threads, sms=sms,
                per_sm={1: p1, 2: p2, 4: p4}, smem=smem)


def log_scan_route(S: int) -> str:
    """The kernel of the nine scans over obs at S states (the log-space
    scans, X1's and X2's carry modes, K6a and K6b, K5, K3's carry mode and
    K8c: the keys of ``_LOG_SCAN_COUNTERS``, each with its own kernels to
    256 states): ``"lanes"`` to 32 states and
    ``"rows"`` to 256 (the edges of the two kernels), each to
    ``LOG_SCAN_MAX_STATES``; ``"narrow"`` (the block tile, forced) to 256
    beyond it; past 256 states ``scan_route(S)``."""
    if S > 256:
        return scan_route(S)
    if S > LOG_SCAN_MAX_STATES:
        return "narrow"
    return "lanes" if S <= 32 else "rows"


def scan_counter(name: str, S: int) -> str:
    """The counter a launch of scan ``name`` (its block tile's counter, a
    key of ``_CLUSTER_COUNTERS`` and of ``_LOG_SCAN_COUNTERS``) at S
    states adds to: the route's own (``log_scan_route``), ``name`` itself
    on the block tile."""
    route = log_scan_route(S)
    if route in ("lanes", "rows"):
        return _LOG_SCAN_COUNTERS[name][route]
    return _CLUSTER_COUNTERS[name] if route == "cluster" else name


def _launch_scan(name, entry, S, args, dev):
    """Launch one of the nine scans over obs (``_CLUSTER_COUNTERS``)
    through its entry, with the ``tile`` flag of its route
    (``log_scan_route(S)``), counted under ``scan_counter(name, S)``."""
    _launch_streaming(scan_counter(name, S), entry,
                      (*args, _TILE_FLAGS[log_scan_route(S)]), dev)


def forward_scaled_plain(log_start, log_trans, obs, lengths,
                         dtype=torch.float32):
    """Plain version of ``forward_scaled``: ``dp.forward_scaled`` (the
    matmul form), carried and returned in ``dtype`` (float64 gives a
    reference whose own rounding is negligible)."""
    return dp.forward_scaled(log_start, log_trans, obs, lengths,
                             dtype=dtype)


def forward_scaled(log_start, log_trans, obs, lengths):
    """K7a/K8a: (alpha_hat f32[B, L, S], log_c f32[B, L], loglik f32[B])
    from obs f32[B, L, S] and int32 lengths [B], with the semantics of
    ``dp.forward_scaled``: position 0 is log_start + obs[0] (LOG_ZERO for
    a zero-length row), position t >= 1 log(exp(alpha_hat[t-1]) .
    exp(log_trans)) + obs[t] (LOG_ZERO where the sum is 0), each row less
    its max (floored at LOG_ZERO), which is the normalizer dm[t];
    positions at or past a row's length carry the row with dm 0.  The
    kernel writes alpha_hat and dm; log_c = cumsum(dm) and loglik = log
    sum exp(last row) + sum(dm) (0 for zero-length rows) are formed here
    as ``dp.forward_scaled`` forms them.

    Replaces ``forward_scaled_pallas_v2`` (pallas_kernels.py:493, kernel
    ``_forward_kernel_v2`` :402) and ``forward_scaled_pallas`` (:131,
    kernel ``_forward_kernel`` :75), one function in two TPU layouts.
    Bound on an H100: L dependent steps, each R x S^2 FMAs over the rows
    R a step holds plus one expf and one logf per cell; the bytes of obs
    in and alpha_hat and dm out.  Design (``csrc/scans.cu``, route
    ``log_scan_route``): to 32 states the lanes step
    (``fwd_scaled_lanes_kernel``: a warp a row, column j of exp(log_trans)
    in lane j's registers, exp(a) round the warp by shuffles, no shared
    memory or barrier in the chain; counted as ``fwd_scaled_lanes``); from
    33 to 256 the rows kernel (``fwd_scaled_rows_kernel``,
    ``csrc/scan_rows.cuh``, counted as ``fwd_scaled_rows``: a block of R
    rows, each thread one FMA chain of four columns of all R rows, so a
    float4 of the matrix serves 4 R FMAs, the matrix's first rows in
    registers and the rest in shared memory, two barriers a step; R by
    the card's occupancy, ``library_rows_plan``).  Each
    output's sum is four interleaved FMA chains in an order that depends
    on S alone, the block tile's (``fwd_scaled_kernel``, forced with
    ``LOG_SCAN_MAX_STATES`` = 0, counted as ``fwd_scaled``), so every
    route gives the same bits.  From 257 states (``scan_route``) the cluster tile
    (``csrc/scan_cluster.cuh``, counted as ``fwd_scaled_cluster``): a
    cluster of up to 16 blocks shares a row group's states, each block's
    slice of exp(log_trans) resident for the whole scan and the state
    vector exchanged through distributed shared memory, with the same
    bits.  Takes S <= 1024."""
    dev = _check_streaming(log_trans, obs, lengths, "obs", "forward_scaled",
                           log_start)
    if _device_kind(dev) == "cpu":
        return forward_scaled_plain(log_start, log_trans, obs, lengths)
    B, L, S = obs.shape
    alpha = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    dm = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B:
        trans_p = torch.exp(log_trans)
        _launch_scan(
            "fwd_scaled", "tehmm_fwd_scaled", S,
            (obs.data_ptr(), lengths.data_ptr(), log_start.data_ptr(),
             trans_p.data_ptr(), alpha.data_ptr(), dm.data_ptr(), B, L, S),
            dev)
    loglik = torch.log(torch.exp(alpha[:, -1]).sum(dim=-1)) + dm.sum(dim=1)
    loglik = torch.where(lengths > 0, loglik, 0.0)
    return alpha, torch.cumsum(dm, dim=1), loglik


def backward_scaled_plain(log_trans, obs, lengths, dtype=torch.float32):
    """Plain version of ``backward_scaled``: ``dp.backward_scaled`` (the
    matmul form) in ``dtype``."""
    return dp.backward_scaled(log_trans, obs, lengths, dtype=dtype)


def backward_scaled(log_trans, obs, lengths):
    """K7b/K8b: (beta_hat f32[B, L, S], log_d f32[B, L]) from obs
    f32[B, L, S] and int32 lengths [B], with the semantics of
    ``dp.backward_scaled``: beta_hat[L-1] = 0; beta_hat[t] steps back from
    t + 1 where t + 1 < length (x = obs[t+1] + beta_hat[t+1] less its max
    xm, log(exp(x) . exp(log_trans)^T) less its max nm, normalizer
    xm + nm) and carries beta_hat[t+1] with normalizer 0 elsewhere.  The
    kernel writes beta_hat and the normalizers; log_d, their reversed
    cumulative sum, is formed here.

    Replaces ``backward_scaled_pallas`` (pallas_kernels.py:222, kernel
    ``_backward_kernel`` :187) and ``backward_hat_pallas_v2`` (:1012,
    kernel ``_backward_kernel_v2`` :934), which returns beta_hat only.
    Bound and design as ``forward_scaled`` (``bwd_scaled_lanes_kernel``,
    ``bwd_scaled_rows_kernel``, counted as ``bwd_scaled_lanes`` and
    ``bwd_scaled_rows``, the block tile as ``bwd_scaled``), with two max
    reductions a step (the rows kernel: three barriers); the kernel is
    handed exp(log_trans) transposed, so lane j of the lanes step holds
    row j of exp(log_trans), and reads obs as it is, from the end; from
    257 states on the cluster tile (counted as ``bwd_scaled_cluster``).
    Takes S <= 1024."""
    dev = _check_streaming(log_trans, obs, lengths, "obs", "backward_scaled")
    if _device_kind(dev) == "cpu":
        return backward_scaled_plain(log_trans, obs, lengths)
    B, L, S = obs.shape
    beta = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    dm = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B:
        trans_pt = torch.exp(log_trans).T.contiguous()
        _launch_scan(
            "bwd_scaled", "tehmm_bwd_scaled", S,
            (obs.data_ptr(), lengths.data_ptr(), trans_pt.data_ptr(),
             beta.data_ptr(), dm.data_ptr(), B, L, S), dev)
    log_d = torch.flip(torch.cumsum(torch.flip(dm, [1]), dim=1), [1])
    return beta, log_d


def pointer_dtype(S: int) -> torch.dtype:
    """The pointers' type: uint8 holds every state of S <= 256, uint16
    every state of the scan tile's S <= 1024."""
    return torch.uint8 if S <= 256 else torch.uint16


def viterbi_pointers_plain(log_start, log_trans, obs, lengths):
    """Plain version of ``viterbi_pointers``: ``viterbi_values_plain``'s
    loop with the first-hit argmax of every step kept."""
    B, L, S = obs.shape
    dev = obs.device
    lens = lengths.to(torch.int64)
    ident = torch.arange(S, device=dev).expand(B, S)
    v_hat = torch.zeros((B, S), dtype=torch.float32, device=dev)
    ptrs = torch.empty((B, L, S), dtype=pointer_dtype(S), device=dev)
    dms = []
    for t in range(L):
        if t == 0:
            best, arg = log_start[None, :], ident
        else:
            cand = v_hat[:, :, None] + log_trans[None, :, :]
            best, arg = cand.amax(dim=1), cand.argmax(dim=1)
        new_hat, m = dp._renorm(best + obs[:, t])
        valid_t = t < lens
        v_hat = dp._mask_carry(new_hat, v_hat, valid_t)
        ptrs[:, t] = torch.where(valid_t[:, None], arg, ident)
        dms.append(torch.where(valid_t, m, 0.0))
    return ptrs, v_hat, torch.stack(dms, dim=1)


def viterbi_pointers(log_start, log_trans, obs, lengths):
    """K8c: (ptrs [B, L, S], v_last f32[B, S], dm f32[B, L]) from obs
    f32[B, L, S] and int32 lengths [B].  ``viterbi_values``' max-plus
    forward (K5), writing at every position the argmax predecessor of
    every state, first hit (the lowest index) on ties, and at position 0
    and at or past a row's length the identity; v_last is the last value
    row (K5's row L-1), dm the normalizers (0 at padding, so zero-length
    rows have a zero row).  ``dp.viterbi_backpointers`` chases the
    pointers (``pointer_chase``) and forms the score.

    Replaces ``viterbi_pallas``'s kernel (pallas_kernels.py:333, kernel
    ``_viterbi_kernel`` :277), which writes int32 pointers; these are
    ``pointer_dtype(S)``: uint8 to S = 256, uint16 beyond.  Bound on an
    H100: the chain of L dependent max-plus steps (the bytes of obs and
    of the pointers at S = 20).
    Design (``csrc/scans.cu``, route ``log_scan_route``): to 32 states K3's
    lanes step in its pointer mode (``viterbi_ptrs_lanes_kernel``, counted
    as ``viterbi_ptrs_lanes``: the first-hit argmax of a step's candidates
    off the chain); from 33 to 256 K5's rows kernel with the argmax
    (``viterbi_ptrs_rows_kernel``, counted as ``viterbi_ptrs_rows``: each
    chain's partial maxima kept with the row that set each, strict > in
    increasing row, the chains combined by value, then by the lower row);
    the block tile (``viterbi_ptrs_kernel``, forced with
    ``LOG_SCAN_MAX_STATES`` = 0, counted as ``viterbi_ptrs``) does the same
    with its four partial maxima, so the bits are one; from 257 states
    (``scan_route``) K5's cluster tile, whose four chains a column do the same
    (counted as ``viterbi_ptrs_cluster``); on the staged tile one chain in row
    order with a strict compare.  Bit-equal to the plain version.  Takes S <=
    1024."""
    dev = _check_streaming(log_trans, obs, lengths, "obs",
                           "viterbi_pointers", log_start)
    if _device_kind(dev) == "cpu":
        return viterbi_pointers_plain(log_start, log_trans, obs, lengths)
    B, L, S = obs.shape
    ptrs = torch.empty((B, L, S), dtype=pointer_dtype(S), device=dev)
    v_last = torch.empty((B, S), dtype=torch.float32, device=dev)
    dm = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B:
        _launch_scan(
            "viterbi_ptrs", "tehmm_viterbi_ptrs", S,
            (obs.data_ptr(), lengths.data_ptr(), log_start.data_ptr(),
             log_trans.data_ptr(), ptrs.data_ptr(), v_last.data_ptr(),
             dm.data_ptr(), B, L, S), dev)
    return ptrs, v_last, dm


def pointer_chase_plain(ptrs, v_last, lengths):
    """Plain version of ``pointer_chase``: a loop over positions from the
    end, batched over rows."""
    B, L, _S = ptrs.shape
    state = torch.argmax(v_last, dim=-1)
    path = torch.empty((B, L), dtype=torch.int32, device=ptrs.device)
    path[:, L - 1] = state
    for t in range(L - 1, 0, -1):
        state = ptrs[:, t].to(torch.int64).gather(1, state[:, None])[:, 0]
        path[:, t - 1] = state
    return torch.where((lengths > 0)[:, None], path, 0)


def pointer_chase(ptrs, v_last, lengths):
    """The backtrace of ``viterbi_pointers``: int32 path [B, L] from
    pointers [B, L, S] (``pointer_dtype(S)``), the last value rows
    f32[B, S] and int32
    lengths [B].  path[L-1] is the first-hit argmax of v_last, path[t-1]
    = ptrs[t, path[t]]; zero-length rows get path 0.  Padding pointers
    are the identity, so a path replicates its last valid state.

    No Pallas counterpart: ``viterbi_pallas`` (pallas_kernels.py:381-388)
    chases its pointers with an XLA scan.  Bound on an H100: one
    dependent byte load a position.  Design: one thread per batch row,
    the argmax and the whole walk in registers."""
    B, L, S = ptrs.shape
    dev = ptrs.device
    _check(ptrs, "ptrs", pointer_dtype(S), (B, L, S), dev)
    _check(v_last, "v_last", torch.float32, (B, S), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    for t, name in ((ptrs, "ptrs"), (v_last, "v_last"),
                    (lengths, "lengths")):
        _check_contiguous(t, name)
    if L == 0:
        raise ValueError("ptrs: a chase needs at least one position")
    if _device_kind(dev) == "cpu":
        return pointer_chase_plain(ptrs, v_last, lengths)
    _check_tile(S, "pointer_chase")
    path = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B:
        _launch_streaming(
            "pointer_chase", "tehmm_pointer_chase",
            (ptrs.data_ptr(), v_last.data_ptr(), lengths.data_ptr(),
             path.data_ptr(), B, L, S), dev)
    return path


# ---------------------------------------------------------------------
# K9: the max-plus sweep experiment (tools/exp_maxplus_s256)
# ---------------------------------------------------------------------

MAXPLUS_SWEEPS = 64          # STEPS of the JAX tool
MAXPLUS_MAX_STATES = 1024
MAXPLUS_LAYOUTS = ("resident", "blocks")


def maxplus_sweeps_plain(v, T):
    """Plain version of ``maxplus_sweeps``: the JAX tool's ``_ref_sweep``
    as a loop over sweeps (a [Sp, Sp, Bg] temporary a sweep)."""
    for _ in range(MAXPLUS_SWEEPS):
        best = (v[:, None, :] + T[:, :, None]).amax(dim=0)
        v = best - best.amax(dim=0, keepdim=True)
    return v


def maxplus_sweeps(v, T, layout, blk=None):
    """K9: 64 sweeps of best[j, b] = max_i(v[i, b] + T[i, j]), each less
    its column max, on v f32[Sp, Bg] (state-major) and T f32[Sp, Sp];
    returns the last v f32[Sp, Bg].  ``layout`` "resident" reads every
    row of T in place (the first rows from shared memory, the rest
    through the read-only path); "blocks" stages T through shared memory
    in blocks of ``blk`` rows (8, 16 or 32).  Any Sp <= 1024, any Bg.

    Replaces ``_kernel_unrolled`` (tools/exp_maxplus_s256.py:41,
    pallas_call :115) and ``_kernel_scratch_blocks`` (:54, pallas_call
    :120).  Bound on an H100: 2 Sp^2 Bg float32 instructions a sweep
    against 4 Sp^2 bytes of T a sweep per block once T leaves shared
    memory (Sp > 232).  Design (``csrc/maxplus.cu``): a block of 256
    threads owns 8 columns for every sweep, a thread ceil(Sp / 256)
    states of all 8, so every element of T it reads serves 8
    accumulators.  Bit-equal to the plain version."""
    if layout not in MAXPLUS_LAYOUTS:
        raise ValueError(f"layout must be one of {MAXPLUS_LAYOUTS}, got "
                         f"{layout!r}")
    if layout == "blocks" and blk not in (8, 16, 32):
        raise ValueError(f"blocks: blk must be 8, 16 or 32, got {blk!r}")
    if layout == "resident" and blk is not None:
        raise ValueError("resident: takes no blk")
    Sp, Bg = v.shape
    dev = v.device
    _check(v, "v", torch.float32, (Sp, Bg), dev)
    _check(T, "T", torch.float32, (Sp, Sp), dev)
    _check_contiguous(v, "v")
    _check_contiguous(T, "T")
    if Sp == 0:
        raise ValueError("v: needs at least one state")
    if _device_kind(dev) == "cpu":
        return maxplus_sweeps_plain(v, T)
    if Sp > MAXPLUS_MAX_STATES:
        raise NotImplementedError(
            f"maxplus_sweeps: Sp={Sp} is over the {MAXPLUS_MAX_STATES} "
            f"states a block of 256 threads takes (4 a thread)")
    out = torch.empty_like(v)
    if Bg:
        name = "maxplus_" + layout
        lib = load_library()
        rc = lib.tehmm_maxplus_sweeps(v.data_ptr(), T.data_ptr(),
                                      out.data_ptr(), Sp, Bg, blk or 0,
                                      _stream(dev))
        _raise_on(rc, lib, name)
        LAUNCHES[name] += 1
    return out
