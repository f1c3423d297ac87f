"""The port's CUDA kernels: build, ctypes binding, wrappers.

``csrc/`` holds the hand-written Hopper kernels that replace the TPU
kernels the port's paths reach (see each source's header for what
bounds each on an H100 and how its design answers it):

  ===================== ==============================================
  wrapper               replaces (tehmm_tpu/ops/pallas_kernels.py)
  ===================== ==============================================
  viterbi_fwd           K2 forward, ``_make_viterbi_fwd_kernel_v4``
  viterbi_backtrace     K2 backtrace, ``_viterbi_backtrace_kernel_v4``
  viterbi_chunk_values  K3, ``viterbi_chunk_values_pallas``
  (and viterbi_carry)   (its ``carry_only`` mode)
  em_fwd                K1 forward, ``_make_forward_kernel_v4``
  em_bwd_stats          K1 reverse, ``_make_bwd_stats_kernel_v4``
  post_decode           K4 decode, ``_make_post_decode_kernel_v4``
  forward_chunk_values  X1: no Pallas kernel; the XLA scans of
  (and forward_final)   ``dp.forward_chunk_values`` (``dp.forward_final``)
  backward_chunk_values X2: no Pallas kernel; ``dp.backward_chunk_values``
  viterbi_values        K5, ``_viterbi_values_v3(carry_mode=False)`` under
                        ``viterbi_pallas_v3``
  forward_prob          K6a, ``forward_prob_pallas_v3``
  backward_prob         K6b, ``backward_prob_pallas_v3``
  ===================== ==============================================

``viterbi_fused`` composes the first two into the symbols-in/path-out
decode of ``viterbi_fused_pallas_v4``; ``em_counts_fused`` composes
K1's two into the symbols-in/statistics-out E-step of
``em_counts_fused_pallas_v4``; ``posterior_decode_fused`` composes K1's
forward with the K4 decode into the symbols-in/path-out max-posterior
decode of ``posterior_decode_fused_pallas_v4``.  The last three
(``csrc/streaming.cu``) work on a precomputed observation tensor and
take any S up to 256 (``STREAMING_MAX_STATES``) whatever T and V are:
they keep only the transition matrix, as far as it fits, and the rows'
state vectors in shared memory.  ``dp.viterbi_streaming`` and the
E-step engine ``"cuda_v3"`` of ``ops/em.py`` are built on them.

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
STREAM_KERNELS = ("viterbi_fwd", "em_fwd", "em_bwd_stats", "post_decode")
STREAM_VARIANTS = ("", "+w", "+g", "+wg")
LAUNCHES = {
    name: 0 for name in (
        [k + v for k in STREAM_KERNELS for v in STREAM_VARIANTS]
        + ["viterbi_backtrace", "viterbi_chunk_values", "fwd_chunk",
           "bwd_chunk", "viterbi_values", "fwd_prob", "bwd_prob"]
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
# The streaming kernels (K5, K6): one thread per state in a block of 256.
STREAMING_MAX_STATES = 256
_STREAMING_ENVELOPE_ITEM = (
    "ROADMAP Queue 2: K5 and K6 beyond 256 states"
)

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
        lib.tehmm_viterbi_fwd.restype = i32
        lib.tehmm_viterbi_fwd.argtypes = (
            [ptr] * 7 + [i64, i64, i32, i32, i32] + streams + [ptr]
        )
        lib.tehmm_viterbi_chunk_values.restype = i32
        lib.tehmm_viterbi_chunk_values.argtypes = (
            [ptr] * 6 + [i64, i64, i32, ptr]
        )
        lib.tehmm_viterbi_backtrace.restype = i32
        lib.tehmm_viterbi_backtrace.argtypes = [
            ptr, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr, i64, i64, i32, ptr,
        ]
        lib.tehmm_em_fwd.restype = i32
        lib.tehmm_em_fwd.argtypes = (
            [ptr] * 8 + [i64, i64, i32, i32, i32] + streams + [ptr]
        )
        lib.tehmm_em_bwd_stats.restype = i32
        lib.tehmm_em_bwd_stats.argtypes = (
            [ptr] * 10 + [i64, i64, i32, i32, i32, i32] + streams + [ptr]
        )
        lib.tehmm_post_decode.restype = i32
        lib.tehmm_post_decode.argtypes = (
            [ptr] * 6 + [i64, i64, i32, i32, i32] + streams + [ptr]
        )
        lib.tehmm_fwd_chunk.restype = i32
        lib.tehmm_fwd_chunk.argtypes = [ptr] * 7 + [i64, i64, i32, ptr]
        lib.tehmm_bwd_chunk.restype = i32
        lib.tehmm_bwd_chunk.argtypes = [ptr] * 7 + [i64, i64, i32, ptr]
        for fn in (lib.tehmm_viterbi_values, lib.tehmm_fwd_prob):
            fn.restype = i32
            fn.argtypes = [ptr] * 6 + [i64, i64, i32, ptr]
        lib.tehmm_bwd_prob.restype = i32
        lib.tehmm_bwd_prob.argtypes = [ptr] * 4 + [i64, i64, i32, ptr]
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


def _check_envelope(S: int, smem_floats: int, what: str,
                    item: str = _ENVELOPE_ITEM) -> None:
    if S > MAX_STATES or 4 * smem_floats > _SMEM_LIMIT:
        raise NotImplementedError(
            f"{what}: S={S} needs {4 * smem_floats} bytes of shared "
            f"memory per block (limit {_SMEM_LIMIT}, and S <= "
            f"{MAX_STATES}); not ported yet ({item})"
        )


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

    def coef_floats(self, S: int) -> int:
        """Shared-memory floats of the coefficient table [S, 3G]."""
        return 3 * S * self.G

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

def viterbi_fwd_plain(log_start, log_trans, log_em, symbols, lengths,
                      obs_weights=None, gauss_params=None,
                      gauss_values=None):
    """Plain version of ``viterbi_fwd``: obs by the track-order
    gather-sum (plus the gaussian term, times the weights), then
    ``viterbi_values_plain``."""
    obs = _streams(symbols, log_em.shape[0], obs_weights, gauss_params,
                   gauss_values).obs(log_em, symbols)
    return viterbi_values_plain(log_start, log_trans, obs, lengths)


def viterbi_fwd(log_start, log_trans, log_em, symbols, lengths,
                obs_weights=None, gauss_params=None, gauss_values=None):
    """K2 forward: (v_hats f32[B, L, S], dm f32[B, L]) from int32
    symbols [B, L, T] and int32 lengths [B], with the optional segment
    weights and gaussian tracks.  Row t is the max-normalized value row
    at position t; dm[b, t] is its normalizer (0 at padding).

    Replaces ``_make_viterbi_fwd_kernel_v4`` (pallas_kernels.py:2386).
    Bound on an H100: the latency of one dependent max-plus step per
    position (S x S shared-memory max-reduction, T symbol loads, a warp
    shuffle), not bytes or flops.  Design: one warp per row, lane <->
    state, tables in shared memory, obs formed in registers and never
    written out."""
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
        return viterbi_fwd_plain(log_start, log_trans, log_em, symbols,
                                 lengths, st.w, st.gauss, st.values)
    _check_envelope(
        S, S * S + S * T * V + S + st.coef_floats(S) + _WARPS_PER_BLOCK * S,
        "viterbi_fwd"
    )
    _check_index_range(symbols, V, "symbols")
    v_hats = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    dm = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B == 0 or L == 0:
        return v_hats, dm
    lib = load_library()
    _coef, stream_args = st.args()
    rc = lib.tehmm_viterbi_fwd(
        symbols.data_ptr(), lengths.data_ptr(), log_start.data_ptr(),
        log_trans.data_ptr(), log_em.data_ptr(), v_hats.data_ptr(),
        dm.data_ptr(), B, L, S, T, V, *stream_args, _stream(dev),
    )
    _raise_on(rc, lib, "viterbi_fwd")
    LAUNCHES["viterbi_fwd" + st.suffix] += 1
    return v_hats, dm


# ---------------------------------------------------------------------
# K2 backtrace (also the exact decoder's per-chunk backtrace)
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

    Replaces ``_viterbi_backtrace_kernel_v4`` (pallas_kernels.py:2517)
    and the exact decoder's per-position backtrace loop.  Bound: the
    latency of a dependent chain of S-wide argmaxes over value rows read
    from HBM/L2.  Design: one thread per row, trans in shared memory
    (what fits of it: beyond S = 241 the last rows are read through the
    read-only path, so the kernel takes every S <= 256), strided batch
    rows so the fused caller passes slices without copying.
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
    _check_envelope(S, min(S, _SMEM_LIMIT // (4 * S)) * S,
                    "viterbi_backtrace")
    _check_index_range(end_state, S, "end_state")
    path = torch.empty((B, L), dtype=torch.int32, device=dev)
    entry_state = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return path, entry_state
    lib = load_library()
    rc = lib.tehmm_viterbi_backtrace(
        log_trans.data_ptr(), rows.data_ptr(), row_stride,
        entry.data_ptr(), entry_stride, end_state.data_ptr(),
        lengths.data_ptr(), path.data_ptr(), entry_state.data_ptr(),
        B, L, S, _stream(dev),
    )
    _raise_on(rc, lib, "viterbi_backtrace")
    LAUNCHES["viterbi_backtrace"] += 1
    return path, entry_state


# ---------------------------------------------------------------------
# K3 (values, or only the final carry)
# ---------------------------------------------------------------------

def _chunk_values(log_trans, obs, v_hat_init, lengths, carry_only):
    B, L, S = obs.shape
    dev = obs.device
    _check(log_trans, "log_trans", torch.float32, (S, S), dev)
    _check(obs, "obs", torch.float32, (B, L, S), dev)
    _check(v_hat_init, "v_hat_init", torch.float32, (B, S), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    for t, name in ((log_trans, "log_trans"), (obs, "obs"),
                    (v_hat_init, "v_hat_init"), (lengths, "lengths")):
        _check_contiguous(t, name)
    if _device_kind(dev) == "cpu":
        plain = dp.viterbi_carry if carry_only else dp.viterbi_chunk_values
        return plain(log_trans, obs, v_hat_init, lengths)
    _check_envelope(S, S * S + _WARPS_PER_BLOCK * S,
                    "viterbi_chunk_values")
    if carry_only:
        out = torch.empty((B, S), dtype=torch.float32, device=dev)
        v_ptr, carry_ptr = None, out.data_ptr()
    else:
        out = torch.empty((B, L, S), dtype=torch.float32, device=dev)
        v_ptr, carry_ptr = out.data_ptr(), None
    if B == 0:
        return out
    lib = load_library()
    rc = lib.tehmm_viterbi_chunk_values(
        obs.data_ptr(), v_hat_init.data_ptr(), lengths.data_ptr(),
        log_trans.data_ptr(), v_ptr, carry_ptr, B, L, S, _stream(dev),
    )
    _raise_on(rc, lib, "viterbi_chunk_values")
    LAUNCHES["viterbi_chunk_values"] += 1
    return out


def viterbi_chunk_values(log_trans, obs, v_hat_init, lengths):
    """K3: every value row f32[B, Lc, S] of one chunk from its incoming
    carry (``dp.viterbi_chunk_values`` semantics; int32 lengths).

    Replaces ``viterbi_chunk_values_pallas`` (pallas_kernels.py:1492,
    kernel ``_make_viterbi_kernel_v3`` :1284).  Bound and design as
    ``viterbi_fwd``, over precomputed obs."""
    return _chunk_values(log_trans, obs, v_hat_init, lengths, False)


def viterbi_carry(log_trans, obs, v_hat_init, lengths):
    """K3 in carry-only mode: the final carry f32[B, S]
    (``dp.viterbi_carry`` semantics; int32 lengths)."""
    return _chunk_values(log_trans, obs, v_hat_init, lengths, True)


# ---------------------------------------------------------------------
# K2 as a whole
# ---------------------------------------------------------------------

def viterbi_fused(log_start, log_trans, log_em, symbols, lengths,
                  obs_weights=None, gauss_params=None, gauss_values=None):
    """Symbols-in/path-out Viterbi with the JAX signature of
    ``viterbi_fused_pallas_v4``: (path int32[B, L], score f32[B]).  The
    optional streams reach the forward; the backtrace reads no obs.

    The forward writes value rows; the backtrace starts from the
    first-hit argmax of the last row and walks positions L-1..1 against
    rows 0..L-2, so position 0's state comes back as the entry state.
    Paths equal ``dp.viterbi``'s; the score is max(last row) + sum(dm)
    (a tree-order sum, so it matches ``dp.viterbi``'s sequential one to
    float32 rounding).  Zero-length rows get path 0 and score 0."""
    B, L, _T = symbols.shape
    v_hats, dm = viterbi_fwd(log_start, log_trans, log_em, symbols,
                             lengths, obs_weights, gauss_params,
                             gauss_values)
    last = v_hats[:, L - 1]
    end_state = torch.argmax(last, dim=-1).to(torch.int32)
    body_lens = torch.clamp(lengths - 1, min=0).to(torch.int32)
    body, first = viterbi_backtrace(
        log_trans, v_hats[:, 1:], v_hats[:, 0], end_state, body_lens
    )
    path = torch.cat([first[:, None], body], dim=1)
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
    S x S matrix-vector product from shared memory, two warp max
    reductions, T table lookups and 3G gaussian products), not bytes or
    flops.  Design: one warp per row, lane <-> state, exp(trans), log_em,
    exp(start) and the gaussian coefficients in shared memory, obs formed
    in registers (weights and values read from global memory) and never
    written out."""
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
    start_p, trans_p = torch.exp(log_start), torch.exp(log_trans)
    lib = load_library()
    _coef, stream_args = st.args()
    rc = lib.tehmm_em_fwd(
        symbols.data_ptr(), lengths.data_ptr(), start_p.data_ptr(),
        trans_p.data_ptr(), log_em.data_ptr(), alpha.data_ptr(),
        dm.data_ptr(), m_raw.data_ptr(), B, L, S, T, V, *stream_args,
        _stream(dev),
    )
    _raise_on(rc, lib, "em_fwd")
    LAUNCHES["em_fwd" + st.suffix] += 1
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
    Bound: as ``em_fwd``, with a second S x S product per position (the
    pair update), T scattered shared-memory adds and 3G moment adds.
    Design: one warp per row walking from its last valid position down,
    obs recomputed from the symbols (and the streams), each warp's
    statistics in its own shared-memory accumulators (4, 2 or 1 warps per
    block, the most that fit; lane j owns row j of the emission counts
    and the moments); each block writes one partial, summed here over
    blocks in a fixed order (no atomics: two runs give the same bits)."""
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
        lib = load_library()
        _coef, stream_args = st.args()
        rc = lib.tehmm_em_bwd_stats(
            symbols.data_ptr(), lengths.data_ptr(), trans_p.data_ptr(),
            log_em.data_ptr(), alpha.data_ptr(), m_raw.data_ptr(),
            pair.data_ptr(), em.data_ptr(), start.data_ptr(),
            gmom.data_ptr() if G else None, B, L, S, T, V, warps,
            *stream_args, _stream(dev),
        )
        _raise_on(rc, lib, "em_bwd_stats")
        LAUNCHES["em_bwd_stats" + st.suffix] += 1
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
    S x S product from shared memory, an argmax and two max reductions
    across the warp, T table lookups and 3G gaussian products), not bytes
    or flops.  Design: K1's reverse kernel without the statistics: one
    warp per row, lane <-> state, exp(trans), log_em and the gaussian
    coefficients in shared memory, obs recomputed from the symbols and
    streams, alpha_p read once; true float32 where the TPU kernel split
    its dots into bf16 passes."""
    S, T, V = log_em.shape
    B, L, _T = symbols.shape
    dev = _check_k1_inputs(log_em, symbols, lengths, log_trans=log_trans,
                           alpha=alpha)
    st = _streams(symbols, S, obs_weights, gauss_params, gauss_values)
    if _device_kind(dev) == "cpu":
        return post_decode_plain(log_trans, log_em, symbols, lengths, alpha,
                                 obs_weights=st.w, gauss_params=st.gauss,
                                 gauss_values=st.values)
    _check_envelope(
        S, S * S + S * T * V + st.coef_floats(S) + _WARPS_PER_BLOCK * S,
        "post_decode", _POST_ENVELOPE_ITEM,
    )
    _check_index_range(symbols, V, "symbols")
    path = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return path
    trans_p = torch.exp(log_trans)
    lib = load_library()
    _coef, stream_args = st.args()
    rc = lib.tehmm_post_decode(
        symbols.data_ptr(), lengths.data_ptr(), trans_p.data_ptr(),
        log_em.data_ptr(), alpha.data_ptr(), path.data_ptr(), B, L, S, T,
        V, *stream_args, _stream(dev),
    )
    _raise_on(rc, lib, "post_decode")
    LAUNCHES["post_decode" + st.suffix] += 1
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


def _fwd_chunk(log_trans, obs, a_hat_init, lengths, values):
    B, L, S = obs.shape
    dev = _check_sweep(log_trans, obs, a_hat_init, lengths, "a_hat_init")
    if _device_kind(dev) == "cpu":
        plain = dp.forward_chunk_values if values else dp.forward_final
        return plain(log_trans, obs, a_hat_init, lengths)
    _check_envelope(S, S * S + _WARPS_PER_BLOCK * S, "forward chunk sweep",
                    _POST_ENVELOPE_ITEM)
    carry = torch.empty((B, S), dtype=torch.float32, device=dev)
    hats = torch.empty((B, L, S), dtype=torch.float32, device=dev) \
        if values else None
    dm = None if values else torch.empty((B, L), dtype=torch.float32,
                                         device=dev)
    if B:
        trans_p = torch.exp(log_trans)
        lib = load_library()
        rc = lib.tehmm_fwd_chunk(
            obs.data_ptr(), a_hat_init.data_ptr(), lengths.data_ptr(),
            trans_p.data_ptr(), None if hats is None else hats.data_ptr(),
            carry.data_ptr(), None if dm is None else dm.data_ptr(), B, L,
            S, _stream(dev),
        )
        _raise_on(rc, lib, "fwd_chunk")
        LAUNCHES["fwd_chunk"] += 1
    if values:
        return hats, carry
    return carry, dm.sum(dim=1)


def forward_chunk_values(log_trans, obs, a_hat_init, lengths):
    """X1: every scaled alpha row f32[B, Lc, S] of one chunk and the
    final carry f32[B, S], from the incoming carry
    (``dp.forward_chunk_values`` semantics; int32 lengths).

    No Pallas counterpart: on the TPU this is the XLA scan of
    ``tehmm_tpu/ops/dp.py:480``.  Bound on an H100: the latency of one
    dependent log-space step per position (S expf, an S x S product from
    shared memory, S logf, a warp max).  Design: one warp per row, lane
    <-> state, exp(trans) in shared memory, the carry in registers."""
    return _fwd_chunk(log_trans, obs, a_hat_init, lengths, True)


def forward_final(log_trans, obs, a_hat_init, lengths):
    """X1 in carry-only mode: (final carry f32[B, S], the chunk's summed
    normalizer increments f32[B]) (``dp.forward_final`` semantics, JAX
    ``ops/dp.py:378``; int32 lengths).  The kernel writes each position's
    increment; they are summed here in one reduction, not as a running
    sum in the warp, which keeps the loglik's accuracy on long inputs."""
    return _fwd_chunk(log_trans, obs, a_hat_init, lengths, False)


def backward_chunk_values(log_trans, obs, x_carry, continuing, lengths):
    """X2: every scaled beta row f32[B, Lc, S] of one chunk and x_out
    f32[B, S] (``dp.backward_chunk_values`` semantics; bool continuing,
    int32 lengths).  The boundary step from ``x_carry`` and ``x_out`` run
    inside the kernel, in the same loop as the in-chunk steps, so a sweep
    cut into chunks gives the bits of one chunk over the whole row.

    No Pallas counterpart: on the TPU this is the XLA scan of
    ``tehmm_tpu/ops/dp.py:507``.  Bound and design as
    ``forward_chunk_values``, walking the chunk from its end."""
    B, L, S = obs.shape
    dev = _check_sweep(log_trans, obs, x_carry, lengths, "x_carry")
    _check(continuing, "continuing", torch.bool, (B,), dev)
    if L == 0:
        raise ValueError("obs: a chunk needs at least one position")
    if _device_kind(dev) == "cpu":
        return dp.backward_chunk_values(log_trans, obs, x_carry, continuing,
                                        lengths)
    _check_envelope(S, S * S + _WARPS_PER_BLOCK * S, "backward chunk sweep",
                    _POST_ENVELOPE_ITEM)
    beta = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    x_out = torch.empty((B, S), dtype=torch.float32, device=dev)
    if B == 0:
        return beta, x_out
    trans_p = torch.exp(log_trans)
    cont = continuing.to(torch.int32)
    lib = load_library()
    rc = lib.tehmm_bwd_chunk(
        obs.data_ptr(), x_carry.data_ptr(), cont.data_ptr(),
        lengths.data_ptr(), trans_p.data_ptr(), beta.data_ptr(),
        x_out.data_ptr(), B, L, S, _stream(dev),
    )
    _raise_on(rc, lib, "bwd_chunk")
    LAUNCHES["bwd_chunk"] += 1
    return beta, x_out


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
    if _device_kind(dev) == "cuda" and S > STREAMING_MAX_STATES:
        raise NotImplementedError(
            f"{what}: S={S} is over the {STREAMING_MAX_STATES} states one "
            f"block of the streaming kernels takes; not ported yet "
            f"({_STREAMING_ENVELOPE_ITEM})"
        )
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
    Design (``csrc/streaming.cu``): a block of 256 threads owns a tile of
    rows for the whole scan, one thread per state and one row per thread
    (two where the card cannot hold the batch in one wave), the rows'
    vectors and as much of log_trans as fits in shared memory, the rest
    of it read through the read-only path.  Takes S <= 256.  Bit-equal to
    the plain version."""
    dev = _check_streaming(log_trans, obs, lengths, "obs", "viterbi_values",
                           log_start)
    if dev.type == "cpu":
        return viterbi_values_plain(log_start, log_trans, obs, lengths)
    B, L, S = obs.shape
    v_hats = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    dm = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B:
        _launch_streaming(
            "viterbi_values", "tehmm_viterbi_values",
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
    ``_forward_kernel_v3`` :627).  Bound and design as ``viterbi_values``,
    with each output's S-term float32 sum as four interleaved FMA chains
    added pairwise, in an order that depends on S alone (no tensor cores,
    no TF32, no atomics: repeats give the same bits; within float32
    rounding of the plain version's matrix product).  Takes S <= 256."""
    dev = _check_streaming(log_trans, obs_p, lengths, "obs_p",
                           "forward_prob", log_start)
    if dev.type == "cpu":
        return forward_prob_plain(log_start, log_trans, obs_p, lengths)
    B, L, S = obs_p.shape
    alpha = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    dm = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B:
        start_p, trans_p = torch.exp(log_start), torch.exp(log_trans)
        _launch_streaming(
            "fwd_prob", "tehmm_fwd_prob",
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
    design as ``forward_prob``, with two max reductions per position.
    Takes S <= 256."""
    dev = _check_streaming(log_trans, obs_p, lengths, "obs_p",
                           "backward_prob")
    if dev.type == "cpu":
        return backward_prob_plain(log_trans, obs_p, lengths)
    B, L, S = obs_p.shape
    beta = torch.empty((B, L, S), dtype=torch.float32, device=dev)
    if B:
        trans_pt = torch.exp(log_trans).T.contiguous()
        _launch_streaming(
            "bwd_prob", "tehmm_bwd_prob",
            (obs_p.data_ptr(), lengths.data_ptr(), trans_pt.data_ptr(),
             beta.data_ptr(), B, L, S), dev)
    return beta
