"""ctypes bindings for the native C++ host-side kernels.

The port's own copy of ``tehmm_tpu/native.py`` (the port imports nothing
of the JAX package).  Builds ``tehmm_tpu_torch/tehmm_native.cpp`` on
first use with g++ into ``build/tehmm_tpu_torch/`` beside the package
(the directory the CUDA kernels build into), keyed by the source hash,
and exposes typed wrappers.  Everything degrades gracefully: if no
compiler is available, or the build directory cannot be written, the
callers fall back to their NumPy implementations (``native.available()``
tells them).  See tehmm_native.cpp for what lives here and why (SURVEY.md
§2a — the reference's equivalents are bedtools/bx-python C extensions).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "tehmm_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tehmm_tpu_torch")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> ctypes.CDLL | None:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError:
        return None
    so_path = os.path.join(BUILD_DIR, f"tehmm_native-{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
            _SRC, "-o", tmp, "-lz", "-pthread",
        ]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, timeout=120
            )
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, OSError, FileNotFoundError):
            try:                 # failed compile: drop the partial .so
                os.unlink(tmp)
            except OSError:
                pass
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None

    lib.bed_parse.restype = ctypes.c_void_p
    lib.bed_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bed_num_records.restype = ctypes.c_int64
    lib.bed_num_records.argtypes = [ctypes.c_void_p]
    lib.bed_chrom_names_len.restype = ctypes.c_int64
    lib.bed_chrom_names_len.argtypes = [ctypes.c_void_p]
    lib.bed_value_names_len.restype = ctypes.c_int64
    lib.bed_value_names_len.argtypes = [ctypes.c_void_p]
    lib.bed_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.bed_free.argtypes = [ctypes.c_void_p]
    lib.fill_intervals_u16.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.count_transitions.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    ]
    lib.count_emissions.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.runs_encode.restype = ctypes.c_int64
    lib.runs_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.fasta_index.restype = ctypes.c_void_p
    lib.fasta_index.argtypes = [ctypes.c_char_p]
    lib.fasta_index_num.restype = ctypes.c_int64
    lib.fasta_index_num.argtypes = [ctypes.c_void_p]
    lib.fasta_index_names_len.restype = ctypes.c_int64
    lib.fasta_index_names_len.argtypes = [ctypes.c_void_p]
    lib.fasta_index_error.restype = ctypes.c_int64
    lib.fasta_index_error.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fasta_index_copy.argtypes = [ctypes.c_void_p] + \
        [ctypes.c_void_p] * 5
    lib.fasta_index_free.argtypes = [ctypes.c_void_p]
    lib.bigwig_paint_blocks.restype = ctypes.c_int32
    lib.bigwig_paint_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int32,
    ]
    for fn in (lib.pack_columns_u16, lib.pack_columns_f32):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32,
        ]
    lib.bin_scale_f64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32,
    ]
    lib.nanminmax_f64.restype = ctypes.c_int32
    lib.nanminmax_f64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32,
    ]
    return lib


def _get() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            if os.environ.get("TEHMM_NO_NATIVE"):
                _lib = None
            else:
                _lib = _build()
    return _lib


def available() -> bool:
    return _get() is not None


# ----------------------------------------------------------------------
# typed wrappers
# ----------------------------------------------------------------------

def parse_bed_columnar(path: str, value_col: int = 3):
    """Fast columnar BED parse.

    Returns (starts i64[n], ends i64[n], chrom_ids i32[n],
    value_ids i32[n], chrom_names list[str], value_names list[str]),
    or None when the native library is unavailable.
    """
    lib = _get()
    if lib is None:
        return None
    h = lib.bed_parse(path.encode(), value_col)
    if not h:
        raise FileNotFoundError(path)
    try:
        n = lib.bed_num_records(h)
        starts = np.empty(n, np.int64)
        ends = np.empty(n, np.int64)
        chrom_ids = np.empty(n, np.int32)
        value_ids = np.empty(n, np.int32)
        cbuf = ctypes.create_string_buffer(
            max(1, lib.bed_chrom_names_len(h))
        )
        vbuf = ctypes.create_string_buffer(
            max(1, lib.bed_value_names_len(h))
        )
        lib.bed_copy(
            h,
            starts.ctypes.data, ends.ctypes.data,
            chrom_ids.ctypes.data, value_ids.ctypes.data,
            cbuf, vbuf,
        )
        chroms = cbuf.raw.decode() if n else ""
        vals = vbuf.raw.decode() if n else ""
        chrom_names = chroms.split("\n") if chroms else []
        value_names = vals.split("\n") if vals else []
        return starts, ends, chrom_ids, value_ids, chrom_names, value_names
    finally:
        lib.bed_free(h)


def fill_intervals(
    col: np.ndarray, origin: int,
    starts: np.ndarray, ends: np.ndarray, syms: np.ndarray,
) -> bool:
    """Paint runs into uint16 col in place; False -> caller must fall
    back to NumPy."""
    lib = _get()
    if lib is None:
        return False
    if not (col.flags.c_contiguous and col.dtype == np.uint16):
        # ascontiguousarray would COPY (non-contiguous view or other
        # dtype): the kernel would paint a discarded temporary while
        # this function reports success — make the caller fall back
        return False
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    syms = np.ascontiguousarray(syms, np.uint16)
    lib.fill_intervals_u16(
        col.ctypes.data, len(col), origin,
        starts.ctypes.data, ends.ctypes.data, syms.ctypes.data,
        len(starts),
    )
    return True


def count_transitions(states: np.ndarray, num_states: int):
    lib = _get()
    if lib is None:
        return None
    states = np.ascontiguousarray(states, np.int32)
    out = np.zeros((num_states, num_states), np.float64)
    lib.count_transitions(
        states.ctypes.data, len(states), num_states, out.ctypes.data
    )
    return out


def count_emissions(
    states: np.ndarray, symbols: np.ndarray,
    num_states: int, num_symbols: int,
):
    lib = _get()
    if lib is None:
        return None
    states = np.ascontiguousarray(states, np.int32)
    symbols = np.ascontiguousarray(symbols, np.uint16)
    n, T = symbols.shape
    out = np.zeros((num_states, T, num_symbols), np.float64)
    lib.count_emissions(
        states.ctypes.data, symbols.ctypes.data, n, T,
        num_states, num_symbols, out.ctypes.data,
    )
    return out


def runs_encode(path: np.ndarray):
    """int path -> (starts, ends, states) maximal runs (or None)."""
    lib = _get()
    if lib is None:
        return None
    path = np.ascontiguousarray(path, np.int32)
    n = len(path)
    starts = np.empty(n, np.int64)
    ends = np.empty(n, np.int64)
    states = np.empty(n, np.int32)
    m = lib.runs_encode(
        path.ctypes.data, n,
        starts.ctypes.data, ends.ctypes.data, states.ctypes.data,
    )
    return starts[:m], ends[:m], states[:m]


def pack_columns(cols, out: np.ndarray, n_threads: int = 0) -> bool:
    """Interleave per-track column arrays into the row-major [L, T]
    ``out`` matrix (cache-blocked + threaded in C++; the NumPy
    ``mat[:, t] = col`` strided writes cost a cache line per element at
    genome scale).  uint16 or float32; False -> caller falls back."""
    lib = _get()
    if lib is None:
        return False
    if out.dtype == np.uint16:
        fn = lib.pack_columns_u16
    elif out.dtype == np.float32:
        fn = lib.pack_columns_f32
    else:
        return False
    L, T = out.shape
    if not out.flags.c_contiguous or len(cols) != T:
        return False
    cols = [np.ascontiguousarray(c, out.dtype) for c in cols]
    if any(len(c) != L for c in cols):
        return False
    ptrs = (ctypes.c_void_p * T)(*[c.ctypes.data for c in cols])
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    fn(ptrs, T, L, out.ctypes.data, n_threads)
    return True


def bigwig_paint_blocks(
    blob: bytes,
    offsets: np.ndarray,
    compressed: bool,
    uncompress_buf_size: int,
    chrom_id: int,
    q_start: int,
    q_end: int,
    out: np.ndarray,
    n_threads: int | None = None,
) -> bool:
    """Inflate + paint BigWig data sections into ``out`` (f64, NaN
    pre-filled, c-contiguous, len q_end - q_start) in place.  ``blob``
    holds the raw section bytes back to back; ``offsets`` (i64,
    n_blocks + 1) delimits them.  False -> caller must fall back to the
    NumPy per-block path (library unavailable, bad layout, or a zlib
    error)."""
    lib = _get()
    if lib is None:
        return False
    if not (out.flags.c_contiguous and out.dtype == np.float64):
        return False  # a copy would discard the paint (see fill_intervals)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_blocks = len(offsets) - 1
    if n_blocks <= 0:
        return True
    if n_threads is None:
        # inflate scales ~linearly to the core count (measured 116 ->
        # 34 ms at 4 cores for 12.5 MB of sections)
        n_threads = max(1, min(8, os.cpu_count() or 1))
    rc = lib.bigwig_paint_blocks(
        blob, offsets.ctypes.data, n_blocks,
        1 if compressed else 0, uncompress_buf_size, chrom_id,
        q_start, q_end, out.ctypes.data, n_threads,
    )
    return rc == 0


def fasta_index(path: str):
    """Scan a FASTA and return its faidx-style index:
    (names list[str], data_start i64[n], seq_len i64[n],
    line_base i64[n], line_full i64[n]).  None when the native library
    is unavailable.  Raises ValueError on ragged sequence lines with
    the same semantics as io/fasta.py's Python scanner (kind 1 =
    interior line shorter than the record's first line, kind 2 =
    longer)."""
    lib = _get()
    if lib is None:
        return None
    h = lib.fasta_index(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        kind = np.zeros(1, np.int32)
        err_line = lib.fasta_index_error(h, kind.ctypes.data)
        if err_line:
            if kind[0] == 3:
                raise ValueError(
                    f"{path}:{err_line}: FASTA header with empty "
                    f"record name"
                )
            what = ("has an interior line shorter than its first line"
                    if kind[0] == 1 else
                    "line is longer than the record's first line")
            raise ValueError(
                f"{path}:{err_line}: ragged FASTA — sequence {what}; "
                f"re-wrap the file to fixed-width lines"
            )
        n = lib.fasta_index_num(h)
        data_start = np.empty(n, np.int64)
        seq_len = np.empty(n, np.int64)
        line_base = np.empty(n, np.int64)
        line_full = np.empty(n, np.int64)
        nbuf = ctypes.create_string_buffer(
            max(1, lib.fasta_index_names_len(h))
        )
        lib.fasta_index_copy(
            h, data_start.ctypes.data, seq_len.ctypes.data,
            line_base.ctypes.data, line_full.ctypes.data, nbuf,
        )
        joined = nbuf.raw.decode() if n else ""
        names = joined.split("\n") if joined else []
        return names, data_start, seq_len, line_base, line_full
    finally:
        lib.fasta_index_free(h)


def bin_scale(vals: np.ndarray, shift: float, scale, log_scale,
              bmin: int, span: int, n_threads: int = 0):
    """Scale-bin a numeric track column in one fused multithreaded
    pass (identical f64 math to category.bin_value; NaN or any
    transform landing outside [0, span) -> sentinel bin ``span``).
    Precedence matches io/trackdata's fb_of: ``scale`` wins when both
    scale and log_scale are set.  Returns (bins int32[L], present
    bool[span]) or None when the native library is unavailable."""
    lib = _get()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, np.float64)
    n = len(vals)
    bins = np.empty(n, np.int32)
    present = np.zeros(span + 1, np.uint8)
    if n_threads <= 0:
        n_threads = max(1, min(8, os.cpu_count() or 1))
    lib.bin_scale_f64(
        vals.ctypes.data, n, float(shift),
        float(scale) if scale is not None else 0.0,
        # fb_of precedence: log only when scale is absent
        0.0 if scale is not None
        else float(log_scale) if log_scale is not None else 0.0,
        int(bmin), int(span),
        bins.ctypes.data, present.ctypes.data, n_threads,
    )
    return bins, present[:span].astype(bool)


def nanminmax(vals: np.ndarray, n_threads: int = 0):
    """(nanmin, nanmax) of a float64 column in one threaded pass, or
    None when the native library is unavailable or all values are
    NaN (callers fall back to numpy, whose all-NaN warning semantics
    they may rely on)."""
    lib = _get()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, np.float64)
    if n_threads <= 0:
        n_threads = max(1, min(8, os.cpu_count() or 1))
    mn = ctypes.c_double()
    mx = ctypes.c_double()
    rc = lib.nanminmax_f64(
        vals.ctypes.data, len(vals),
        ctypes.byref(mn), ctypes.byref(mx), n_threads,
    )
    if rc != 0:
        return None
    return mn.value, mx.value
