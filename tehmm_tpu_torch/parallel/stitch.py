"""Chunked Viterbi and max-posterior decoding: halo stitching and the
exact decoders.

Counterpart of ``tehmm_tpu/parallel/stitch.py``.  A chromosome is
decoded as fixed-size chunks, each extended by a halo on both sides;
only each chunk's core is kept.  Neighbouring decodes are compared on a
window around every boundary, and a disagreeing boundary doubles only
its adjacent chunks' halos and re-decodes them, up to ``max_halo``;
persistent disagreement falls back to the checkpointed EXACT decoder
(``viterbi_exact``, ``posterior_exact``), which equals the monolithic
decode unconditionally and is also available directly (eval
``--exact``).  ``posterior_sweep`` is the exact posterior machinery
itself: it also streams per-chunk gamma to a consumer (eval ``--pd``).

On CUDA tensors the decoders run the hand-written kernels
(``ops/cuda_kernels``): stitched Viterbi the fused K2
(``viterbi_fused``) where K2 takes the model and, beyond its envelope,
obs and ``dp.viterbi_streaming`` (K5 and the backtrace kernel;
``viterbi_route``); exact Viterbi K3 (``viterbi_checkpoints``,
``viterbi_chunk_pointers``) and X3's backtrace from its pointers
(``chunk_entry_map``, ``chunk_compose``, ``chunk_chase``; past 239
states ``viterbi_chunk_values`` and the backtrace kernel); stitched
max-posterior K4 (``posterior_decode_fused``) where K4 takes the model
and, beyond, obs and the log-space scans K7a/K7b (``forward_scaled``,
``backward_scaled``) with ``dp.posterior_scaled`` (``maxpost_route``);
and the exact posteriors the chunk sweeps X1 (``forward_checkpoints``,
``forward_chunk_values``) and X2 (``backward_checkpoints``,
``backward_chunk_values``).  On the CPU
the same calls take the plain-torch versions: the stitched Viterbi
decode always K2's, the stitched max-posterior decode the log-space
scans, as the JAX package does off the TPU.  The streaming routes and
the exact decoders take up to 1024 states (K3, X1 and X2 through the
scan tile's carry modes past 239) and raise beyond, naming the tile's
envelope item; past 256 states the rows a pass holds scale by 256 / S
(``scaled_rows``).

Every decoder takes the gaussian tracks (``gauss_params``; the values
come from each table's ``.values`` and chunk with the symbols) and the
segment weights (``weight_arrays``, per-table f32[L]).  The fused
kernels K2 and K4 take them as their optional streams; K3, X1 and X2
take obs, computed here as the JAX package's XLA paths compute it
(``models.emission.obs_log_likelihoods``: track log-likelihoods plus the
gaussian term, times the weights).

Left out of the port, because they served a TPU runtime whose
device-to-host link ran at tens of MB/s and results are identical
without them: the device-resident decoder, run-length path transport
and pipelined row groups.  Row groups are decoded in turn, int32 paths
are downloaded as they are, and no group is padded to a fixed shape
(PyTorch runs eagerly; there is no compiled shape to keep).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tehmm_tpu_torch.utils.common import logger
from tehmm_tpu_torch.models.emission import obs_log_likelihoods
from tehmm_tpu_torch.models.params import HmmParams
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.ops import dp
from tehmm_tpu_torch.parallel.chunking import batch_chunks, plan_chunks


@dataclasses.dataclass
class StitchReport:
    """Diagnostics from a chunked decode."""

    n_chunks: int
    final_halo: int
    retries: int
    boundaries_checked: int
    boundaries_ok: bool


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host int array -> int32 tensor on ``device``."""
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.int32)
    ).to(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A pass's paths back on the host."""
    return t.cpu().numpy()


def _f32_to_device(a: np.ndarray | None, device: torch.device):
    """Host float array (or None) -> float32 tensor on ``device``."""
    if a is None:
        return None
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32)
    ).to(device)


def _weight_batch(weight_arrays, chunks):
    """Per-table f32[L] weights -> the chunk batch's [n, Lc] rows
    (same planning as the symbols; zero-padded, which the lengths mask)."""
    return batch_chunks(
        [np.asarray(w, np.float32)[:, None] for w in weight_arrays], chunks,
    ).symbols[..., 0]


def _block(arrays, lo, Lc, fill=0.0):
    """[B, Lc, ...] f32 slice of each array from position ``lo``, padded
    with ``fill`` (padded positions are length-masked)."""
    out = np.full((len(arrays), Lc) + arrays[0].shape[1:], fill, np.float32)
    for b, a in enumerate(arrays):
        piece = a[lo : lo + Lc]
        out[b, : len(piece)] = piece
    return out


def _streams_of(tables, gauss_params, weight_arrays):
    """(per-table values or None, per-table weights or None)."""
    vmats = None if gauss_params is None else [
        np.asarray(t.values, np.float32) for t in tables
    ]
    wmats = None if weight_arrays is None else [
        np.asarray(w, np.float32) for w in weight_arrays
    ]
    return vmats, wmats


def _first_obs(params, mats, vmats, wmats, gauss_params, dev):
    """obs f32[B, S] at position 0 of every table (inert zero symbols,
    values and unit weights for empty tables)."""
    T = mats[0].shape[1]
    sym0 = _first_rows(mats, T, mats[0].dtype)[:, None, :]
    v0 = None if vmats is None else _first_rows(
        vmats, vmats[0].shape[1], np.float32)[:, None, :]
    w0 = None if wmats is None else np.stack([
        w[0] if len(w) else np.float32(1.0) for w in wmats
    ])[:, None]
    return obs_log_likelihoods(
        params.log_em, _to_device(sym0, dev), gauss_params,
        _f32_to_device(v0, dev), _f32_to_device(w0, dev),
    )[:, 0, :]


def scaled_rows(n: int, S: int) -> int:
    """A budget of ``n`` rows (or positions) per pass for [rows, L, S]
    tensors, scaled by 256 / S past 256 states (at least 1), so that
    each tensor of a pass holds no more than it does at S = 256.  Rows
    are independent, so the passes' results do not depend on it."""
    return n if S <= 256 else max(1, n * 256 // S)


def viterbi_route(S: int, T: int, V: int, G: int,
                  device: torch.device) -> str:
    """The stitched Viterbi decode's path for a model of S states, T
    tracks of V symbols and G gaussian tracks: ``"fused"`` (K2, symbols
    in: ``cuda_kernels.viterbi_fused``) off the card and on it where K2
    takes the model (``cuda_kernels.k2_fits``), else ``"streaming"``
    (obs, then ``dp.viterbi_streaming``: K5 and K2's backtrace).  The JAX
    package's ``_use_fused_viterbi`` / ``_viterbi_engine`` split."""
    if device.type == "cuda" and not ck.k2_fits(S, T, V, G):
        return "streaming"
    return "fused"


def maxpost_route(S: int, T: int, V: int, G: int,
                  device: torch.device) -> str:
    """The stitched max-posterior decode's path: ``"fused"`` (K4:
    ``cuda_kernels.posterior_decode_fused``) on the card where K4 takes
    the model (``cuda_kernels.k4_fits``), else ``"scans"`` (obs, the
    log-space scans ``cuda_kernels.forward_scaled`` and
    ``backward_scaled``, ``dp.posterior_scaled`` and a first-hit argmax),
    which is also the CPU's path, as the JAX package's off the TPU.  The
    JAX package's ``_use_fused_maxpost`` split."""
    if device.type == "cuda" and ck.k4_fits(S, T, V, G):
        return "fused"
    return "scans"


def _decode_batch(
    params: HmmParams,
    symbols: np.ndarray,
    lengths: np.ndarray,
    rows_per_pass: int,
    weights: np.ndarray | None = None,
    gauss_params=None,
    values: np.ndarray | None = None,
) -> np.ndarray:
    """Viterbi over a chunk batch [n, L, T] (with its weight rows [n, L]
    and value rows [n, L, G] when given), ``rows_per_pass`` rows per
    pass, along ``viterbi_route``.  Returns int32 paths [n, L], 0 beyond
    each length."""
    n, L, T = symbols.shape
    out = np.zeros((n, L), dtype=np.int32)
    dev = params.device
    G = 0 if values is None else values.shape[-1]
    route = viterbi_route(params.num_states, T, params.log_em.shape[2], G,
                          dev)
    rows_per_pass = scaled_rows(rows_per_pass, params.num_states)
    for lo in range(0, n, rows_per_pass):
        hi = min(lo + rows_per_pass, n)
        lens = _to_device(lengths[lo:hi], dev)
        sym = _to_device(symbols[lo:hi], dev)
        w = _f32_to_device(None if weights is None else weights[lo:hi], dev)
        v = _f32_to_device(None if values is None else values[lo:hi], dev)
        g = gauss_params if v is not None else None
        if route == "fused":
            paths, _ = ck.viterbi_fused(
                params.log_start, params.log_trans, params.log_em, sym,
                lens, w, g, v)
        else:
            obs = obs_log_likelihoods(params.log_em, sym, g, v, w)
            paths, _ = dp.viterbi_streaming(params.log_start,
                                            params.log_trans, obs, lens)
        rows = _to_host(paths)
        valid = np.arange(L)[None, :] < lengths[lo:hi, None]
        out[lo:hi] = np.where(valid, rows, 0)
    return out


def _stitched_decode(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int,
    halo: int,
    max_halo: int,
    agree_frac: float,
    decode_rows,          # (symbols, lengths, weights, values) -> rows
    exact_fn,             # exact whole-input fallback
    name: str,
    weight_arrays=None,
    gauss_params=None,
) -> tuple[list[np.ndarray], StitchReport]:
    """Halo-stitching driver.

    Chunk CORES are fixed by ``chunk_len`` (plan_chunks: halo only widens
    the loads), so widening is TARGETED: after the initial decode, every
    internal boundary is checked, and each retry re-decodes ONLY the
    chunks adjacent to still-disagreeing boundaries at their doubled
    halo.  Boundaries touching a re-decoded chunk are re-checked.

    Boundary agreement is a strong heuristic for monolithic equality,
    not a proof; persistent disagreement falls back to ``exact_fn``, and
    callers needing the unconditional guarantee use ``viterbi_exact``.
    """
    mats = [getattr(t, "symbols", t) for t in tables]
    value_arrays, _ = _streams_of(tables, gauss_params, None)
    lengths = [len(m) for m in mats]

    def decode_at(chunk_list):
        batch = batch_chunks(mats, chunk_list)
        wb = (None if weight_arrays is None
              else _weight_batch(weight_arrays, chunk_list))
        vb = (None if value_arrays is None
              else batch_chunks(value_arrays, chunk_list).symbols)
        return decode_rows(batch.symbols, batch.lengths, wb, vb)

    base = plan_chunks(lengths, chunk_len, 0)     # halo-free cores
    h0 = min(halo, max_halo)

    def with_halo(c, h):
        L = lengths[c.table_idx]
        return dataclasses.replace(
            c,
            load_start=max(0, c.core_start - h),
            load_end=min(L, c.core_end + h),
        )

    chunk_halo = [h0] * len(base)
    chunks = [with_halo(c, h0) for c in base]
    rows = list(decode_at(chunks))                # per-chunk decoded row

    # internal boundaries: (left chunk idx, right chunk idx)
    bounds = [
        (i, i + 1)
        for i in range(len(base) - 1)
        if base[i].table_idx == base[i + 1].table_idx
    ]

    def agree(i, j):
        a, b = chunks[i], chunks[j]
        x = a.core_end                 # == b.core_start
        w = max(1, int(min(chunk_halo[i], chunk_halo[j]) * agree_frac))
        lo = max(x - w, a.load_start, b.load_start)
        hi = min(x + w, a.load_end, b.load_end)
        if lo >= hi:
            return True
        seg_a = rows[i][lo - a.load_start : hi - a.load_start]
        seg_b = rows[j][lo - b.load_start : hi - b.load_start]
        return np.array_equal(seg_a, seg_b)

    failing = {bd for bd in bounds if not agree(*bd)}
    retries = 0
    while failing and any(
        min(chunk_halo[i], chunk_halo[j]) < max_halo for i, j in failing
    ):
        retries += 1
        affected = sorted({
            i for bd in failing for i in bd
            if chunk_halo[i] < max_halo      # capped: same decode again
        })
        for i in affected:
            chunk_halo[i] = min(chunk_halo[i] * 2, max_halo)
            chunks[i] = with_halo(base[i], chunk_halo[i])
        logger.info(
            "%s: re-decoding %d chunk(s) around %d disagreeing "
            "boundary(ies) at halo<=%d (retry %d)",
            name, len(affected), len(failing),
            max(chunk_halo[i] for i in affected), retries,
        )
        fresh = decode_at([chunks[i] for i in affected])
        for k, i in enumerate(affected):
            rows[i] = fresh[k]
        # update membership ONLY for boundaries whose rows changed;
        # untouched failing boundaries (e.g. both chunks capped) must
        # STAY failing, or the exact fallback would be skipped
        touched = set(affected)
        recheck = {
            bd for bd in bounds if bd[0] in touched or bd[1] in touched
        }
        for bd in recheck:
            if agree(*bd):
                failing.discard(bd)
            else:
                failing.add(bd)

    ok = not failing
    if ok:
        paths = [np.zeros(L, dtype=np.int32) for L in lengths]
        for c, row in zip(chunks, rows):
            paths[c.table_idx][c.core_start : c.core_end] = \
                row[c.core_offset : c.core_offset + c.core_len]
    else:
        logger.warning(
            "%s: boundary disagreement persists at max_halo=%d; "
            "falling back to the exact decoder", name, max_halo,
        )
        paths = exact_fn(params, tables, chunk_len,
                         gauss_params=gauss_params,
                         weight_arrays=weight_arrays)
        # boundaries_ok reports whether the FINAL paths carry the
        # guarantee; the exact decoder's output is unconditional
        ok = True
    return paths, StitchReport(
        n_chunks=len(chunks),
        final_halo=max(chunk_halo, default=h0),
        retries=retries,
        boundaries_checked=len(bounds),
        boundaries_ok=ok,
    )


def viterbi_chunked(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 4096,
    halo: int = 256,
    max_halo: int = 1 << 14,
    agree_frac: float = 0.5,
    rows_per_pass: int = 512,
    weight_arrays: Sequence[np.ndarray] | None = None,
    gauss_params=None,
) -> tuple[list[np.ndarray], StitchReport]:
    """Decode each table's full span via halo chunks (see
    _stitched_decode for the stitching/widening/guarantee contract).

    Args:
      tables: TrackTables (or raw [L, T] symbol arrays).
      chunk_len: core window size per chunk.
      halo: initial halo width; doubled per disagreeing boundary up to
        max_halo (targeted: only adjacent chunks re-decode).
      agree_frac: fraction of the halo used as the agreement window.
      rows_per_pass: chunks decoded per kernel launch (scaled by 256 / S
        past 256 states, ``scaled_rows``).
      weight_arrays: optional per-table f32[L] segment weights.
      gauss_params: gaussian-track emissions; values come from each
        table's ``.values`` and chunk with the symbols.

    Returns:
      (paths, report): one int32[L] state path per input table.
    """
    def decode_rows(symbols, lens, wbatch, vbatch):
        return _decode_batch(params, symbols, lens, rows_per_pass, wbatch,
                             gauss_params, vbatch)

    return _stitched_decode(
        params, tables, chunk_len, halo, max_halo, agree_frac,
        decode_rows, viterbi_exact, "viterbi_chunked", weight_arrays,
        gauss_params,
    )


def _first_rows(arrays, width, dtype):
    """Row 0 of every array, with an all-zero stand-in for EMPTY tables
    (every consumer masks them via true_lens > 0)."""
    return np.stack([
        a[0] if len(a) else np.zeros(width, dtype) for a in arrays
    ])


def _span_obs(params, mats, vmats, wmats, true_lens, gauss_params, Lc,
              c0, c1):
    """obs f32[B, (c1 - c0) Lc, S] of body positions [1 + c0 Lc,
    1 + c1 Lc) of every table: one symbol block, one H2D copy (with the
    value and weight blocks), one ``obs_log_likelihoods``; with int32
    valid positions [B] on the device and on the host.  Symbols and
    values are zero-padded, weights one-padded (padding is
    length-masked), as in the JAX package.  Obs is formed position by
    position, so a span's rows are those of its chunks formed apart."""
    dev = params.device
    lo, width = 1 + c0 * Lc, (c1 - c0) * Lc
    block = np.zeros((len(mats), width, mats[0].shape[1]),
                     dtype=mats[0].dtype)
    for b, m in enumerate(mats):
        piece = m[lo : lo + width]
        block[b, : len(piece)] = piece
    obs = obs_log_likelihoods(
        params.log_em, _to_device(block, dev), gauss_params,
        None if vmats is None else _f32_to_device(
            _block(vmats, lo, width), dev),
        None if wmats is None else _f32_to_device(
            _block(wmats, lo, width, 1.0), dev),
    )
    lens = np.clip(true_lens - lo, 0, width)
    return obs, _to_device(lens, dev), lens


def _exact_obs(params, mats, tables, gauss_params, weight_arrays, Lc):
    """The exact decoders' obs: (obs_span(c0, c1) -> ``_span_obs`` of
    chunks [c0, c1), obs f32[B, S] of position 0)."""
    true_lens = np.asarray([len(m) for m in mats], np.int64)
    vmats, wmats = _streams_of(tables, gauss_params, weight_arrays)

    def obs_span(c0, c1):
        return _span_obs(params, mats, vmats, wmats, true_lens,
                         gauss_params, Lc, c0, c1)

    return obs_span, _first_obs(params, mats, vmats, wmats, gauss_params,
                                params.device)


# The exact decoders' groups of chunks: the f32[B, chunks x Lc, S]
# tensors a group holds stay under this many bytes together: the exact
# Viterbi's obs and value rows (below 240 states uint8 pointers in their
# place, a quarter of the bytes; the groups are the same), the exact
# posteriors' obs, alpha rows, beta rows and gamma
# (POSTERIOR_GROUP_TENSORS).
EXACT_GROUP_BYTES = 1 << 28
POSTERIOR_GROUP_TENSORS = 4


def exact_group_chunks(B: int, Lc: int, S: int, tensors: int = 2) -> int:
    """Chunks of ``Lc`` positions that a group over B tables holds at S
    states (at least one) with ``tensors`` f32[B, chunks x Lc, S] tensors
    (``viterbi_exact``'s two by default).  The budget is in bytes, so
    groups shrink as S grows, as ``scaled_rows``'s passes do."""
    return max(1, EXACT_GROUP_BYTES // (tensors * 4 * max(B, 1) * Lc * S))


def _chase_group(log_trans, obs, entries, chunk_lens, end_state, device):
    """The backtrace of one group from first-hit pointers (K3 to 239
    states): rows are the group's (table, chunk) pairs, obs f32[B n, Lc,
    S], ``entries`` the carry entering each row f32[B n, S], ``chunk_lens``
    each row's valid positions [B, n].  One launch each: K3's pointer
    mode, the map of every row's end states, the maps composed from the
    group's end state int32[B] back, every row chased from its own end
    state.  Returns (path int32[B, n Lc], the state before the group)."""
    B, n = chunk_lens.shape
    lens = _to_device(chunk_lens.reshape(-1), device)
    ptrs = ck.viterbi_chunk_pointers(log_trans, obs, entries, lens)
    maps = ck.chunk_entry_map(ptrs, lens)
    ends, entry_state = ck.chunk_compose(maps.view(B, n, -1), end_state)
    path = ck.chunk_chase(ptrs, ends.view(-1), lens)
    return path.view(B, -1), entry_state


def _backtrace_group(log_trans, obs, entries, chunk_lens, end_state,
                     device):
    """``_chase_group``'s function past 239 states, where K3 runs the tile
    and has no pointer mode: one recompute launch of value rows for the
    group, then ``ck.viterbi_backtrace`` a chunk, the chunks in
    reverse."""
    B, n = chunk_lens.shape
    Lc, S = obs.shape[1:]
    rows = ck.viterbi_chunk_values(
        log_trans, obs, entries, _to_device(chunk_lens.reshape(-1), device),
    ).view(B, n, Lc, S)
    entries = entries.view(B, n, S)
    lens_by_chunk = _to_device(chunk_lens.T, device)          # [n, B]
    pieces = []
    for k in reversed(range(n)):
        path, end_state = ck.viterbi_backtrace(
            log_trans, rows[:, k], entries[:, k], end_state,
            lens_by_chunk[k])
        pieces.append(path)
    return torch.stack(pieces[::-1], dim=1).view(B, n * Lc), end_state


def viterbi_exact(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 1 << 14,
    gauss_params=None,
    weight_arrays: Sequence[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """EXACT chunked Viterbi via checkpointed carries: a forward sweep
    stores only the O(S) carry entering every chunk; the backtrace sweep
    recomputes each chunk from its stored carry and walks the optimal
    path backwards.  Bit-identical to the monolithic decode for ANY
    model.

    Chunks go in groups of ``exact_group_chunks`` (``EXACT_GROUP_BYTES``
    bounds a group's obs and value rows, and so the device memory): each
    group's obs is formed in one call, the forward sweep is one K3
    checkpoint launch a group (``ck.viterbi_checkpoints``, the carry
    handed from group to group).  The backtrace takes the groups in
    reverse, each in a fixed number of launches whose rows are every
    (table, chunk) of it (``_chase_group``: K3's first-hit pointers, each
    chunk's map of end states, the maps composed, every chunk chased),
    and a group's path comes to the host in one copy.  Past 239 states,
    where K3 is the tile's carry mode, the group's value rows and a
    backtrace launch a chunk (``_backtrace_group``).  Batched across
    tables."""
    mats = [np.ascontiguousarray(getattr(t, "symbols", t)) for t in tables]
    B = len(mats)
    S = params.num_states
    true_lens = np.asarray([len(m) for m in mats], np.int64)
    Lb = int(true_lens.max()) - 1          # body = positions 1..L-1
    Lc = min(chunk_len, max(Lb, 1))
    n_chunks = max(0, -(-Lb // Lc))
    per = exact_group_chunks(B, Lc, S)
    groups = [(c0, min(c0 + per, n_chunks))
              for c0 in range(0, n_chunks, per)]
    obs_span, obs0 = _exact_obs(params, mats, tables, gauss_params,
                                weight_arrays, Lc)
    log_trans = params.log_trans.contiguous()

    # position 0 values (empty tables get inert zero rows — masked by
    # true_lens > 0 in the assembly below)
    v0 = params.log_start[None, :] + obs0
    m0 = torch.clamp(v0.amax(dim=-1, keepdim=True), min=-1e30)
    carry = v0 - m0

    # ---- forward sweep: the carry entering every chunk, a group a launch
    entries = []                           # per group f32[B, n, S]
    for c0, c1 in groups:
        obs, lens, _ = obs_span(c0, c1)
        ckpts = ck.viterbi_checkpoints(log_trans, obs, carry, lens, Lc)
        entries.append(torch.cat([carry[:, None], ckpts[:, :-1]], dim=1))
        carry = ckpts[:, -1].contiguous()

    # ---- backtrace sweep: a group at a time, the last first ----
    end_state = torch.argmax(carry, dim=-1).to(torch.int32)
    max_len = int(true_lens.max())
    if max_len == 0:                  # every table empty
        return [np.zeros(0, np.int32) for _ in range(B)]
    back = _backtrace_group if ck.k3_step(S) == "tile" else _chase_group
    paths = np.zeros((B, max_len), np.int32)
    for g in reversed(range(len(groups))):
        c0, c1 = groups[g]
        n = c1 - c0
        if g != len(groups) - 1:      # the last group's obs is still held
            obs, _, _ = obs_span(c0, c1)
        lo = 1 + c0 * Lc
        starts = lo + Lc * np.arange(n)
        chunk_lens = np.clip(true_lens[:, None] - starts[None, :], 0, Lc)
        group_path, end_state = back(
            log_trans, obs.view(B * n, Lc, S), entries[g].view(B * n, S),
            chunk_lens, end_state, params.device)
        group_path = group_path.cpu().numpy()
        for b in range(B):
            hi = min(lo + n * Lc, int(true_lens[b]))
            if hi > lo:
                paths[b, lo:hi] = group_path[b, : hi - lo]
    paths[:, 0] = end_state.cpu().numpy()
    return [paths[b, : int(true_lens[b])].copy() for b in range(B)]


# ---------------------------------------------------------------------
# max-posterior decoding
# ---------------------------------------------------------------------

# The stitched max-posterior decode's rows a pass by route, where the
# caller gives none: K4 ("fused") takes the Viterbi decoder's 512, one
# wave of its warp-a-row kernels on an H100 (128 blocks of 4 warps on
# 132 SMs; 64, the JAX default, filled 16); "scans" keeps that 64, whose
# [rows, L, S] obs, alpha and beta tensors grow with S.  Both are scaled
# by ``scaled_rows`` past 256 states.  Rows are independent, so the
# paths do not depend on the pass.
MAXPOST_ROWS_PER_PASS = {"fused": 512, "scans": 64}


def _posterior_batch(
    params: HmmParams,
    symbols: np.ndarray,
    lengths: np.ndarray,
    rows_per_pass: int | None,
    gauss_params=None,
    values: np.ndarray | None = None,
    weights: np.ndarray | None = None,
) -> np.ndarray:
    """argmax-gamma over a chunk batch [n, L, T], ``rows_per_pass`` rows
    per pass (None: the route's ``MAXPOST_ROWS_PER_PASS``), along
    ``maxpost_route``: K4 (``posterior_decode_fused``: symbols in, path
    out, no gamma in memory), or the log-space scans and
    ``posterior_scaled`` (kernels on the card, plain on the CPU).
    Returns int32 paths [n, L], 0 beyond each length."""
    n, L, T = symbols.shape
    out = np.zeros((n, L), dtype=np.int32)
    dev = params.device
    G = 0 if values is None else values.shape[-1]
    route = maxpost_route(params.num_states, T, params.log_em.shape[2], G,
                          dev)
    if rows_per_pass is None:
        rows_per_pass = MAXPOST_ROWS_PER_PASS[route]
    rows_per_pass = scaled_rows(rows_per_pass, params.num_states)
    for lo in range(0, n, rows_per_pass):
        hi = min(lo + rows_per_pass, n)
        lens = _to_device(lengths[lo:hi], dev)
        sym = _to_device(symbols[lo:hi], dev)
        w = _f32_to_device(None if weights is None else weights[lo:hi], dev)
        v = _f32_to_device(None if values is None else values[lo:hi], dev)
        g = gauss_params if v is not None else None
        if route == "fused":
            paths = ck.posterior_decode_fused(
                params.log_start, params.log_trans, params.log_em, sym, lens,
                w, g, v,
            )
        else:
            obs = obs_log_likelihoods(params.log_em, sym, g, v, w)
            log_trans = params.log_trans.contiguous()
            ah, _, _ = ck.forward_scaled(params.log_start.contiguous(),
                                         log_trans, obs, lens)
            bh, _ = ck.backward_scaled(log_trans, obs, lens)
            paths = torch.argmax(dp.posterior_scaled(ah, bh), dim=-1)
            del obs, ah, bh
        rows = _to_host(paths)
        valid = np.arange(L)[None, :] < lengths[lo:hi, None]
        out[lo:hi] = np.where(valid, rows, 0)
    return out


def posterior_chunked(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 1 << 14,
    halo: int = 256,
    max_halo: int = 1 << 14,
    agree_frac: float = 0.5,
    rows_per_pass: int | None = None,
    gauss_params=None,
    weight_arrays: Sequence[np.ndarray] | None = None,
) -> tuple[list[np.ndarray], StitchReport]:
    """Max-posterior decoding with the stitching contract of
    ``viterbi_chunked`` (see _stitched_decode): halo chunks, the
    all-boundary agreement check, targeted widening, and the exact
    carried-alpha/beta decoder (``posterior_exact``) as the fallback.
    ``rows_per_pass``: chunks decoded a pass (None: the route's,
    ``MAXPOST_ROWS_PER_PASS``).  Returns one int32[L] argmax-gamma path
    per table."""
    def decode_rows(symbols, lens, wbatch, vbatch):
        return _posterior_batch(params, symbols, lens, rows_per_pass,
                                gauss_params, vbatch, wbatch)

    return _stitched_decode(
        params, tables, chunk_len, halo, max_halo, agree_frac,
        decode_rows, posterior_exact, "posterior_chunked", weight_arrays,
        gauss_params,
    )


def posterior_sweep(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 1 << 14,
    consume=None,
    gauss_params=None,
    weight_arrays: Sequence[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """EXACT chunked posteriors: a forward sweep stores the O(S) alpha
    carry entering every chunk; the backward sweep carries beta from
    chunk to chunk and recomputes each chunk's alphas from its stored
    carry.  The steps are those of the monolithic scans, so gamma (and
    its argmax) is bit-identical to a whole-table pass, with device
    memory bounded by one group of chunks.  Batched across tables.

    Chunks go in groups of ``exact_group_chunks`` (a group's obs, alpha
    rows, beta rows and gamma under ``EXACT_GROUP_BYTES``): each group's
    obs is formed in one call, the forward sweep is one X1 checkpoint
    launch a group (``ck.forward_checkpoints``, the carry handed from
    group to group), and the backward pass takes the groups in reverse:
    one X2 checkpoint launch (``ck.backward_checkpoints``) gives the
    x_carry entering every chunk of the group and the one handed to the
    group before it; one X1 launch recomputes the alphas
    (``ck.forward_chunk_values``) and one X2 launch the betas
    (``ck.backward_chunk_values``) of every (table, chunk) of the group,
    each from its chunk's stored carry (X2 with the chunk's own
    ``continuing``); then gamma for the whole group, one copy to the
    host.  On the CPU the plain versions' matrix product of one row may
    round apart from that of many at S >= 16 (torch's matrix-vector
    against matrix-matrix kernels), so there a grouped recompute can
    differ from a whole-table pass in the last bit; the card's kernels
    sum every row alike.

    ``consume(table_idx, start, gamma_chunk)`` is called for every chunk
    in REVERSE time order with gamma f32[valid, S] (NumPy); the default
    consumer collects argmax paths.  Returns the argmax paths."""
    mats = [np.ascontiguousarray(getattr(t, "symbols", t)) for t in tables]
    dev = params.device
    B = len(mats)
    S = params.num_states
    true_lens = np.asarray([len(m) for m in mats], np.int64)
    Lb = int(true_lens.max()) - 1          # body = positions 1..L-1
    Lc = min(chunk_len, max(Lb, 1))
    n_chunks = max(0, -(-Lb // Lc))
    per = exact_group_chunks(B, Lc, S, POSTERIOR_GROUP_TENSORS)
    groups = [(c0, min(c0 + per, n_chunks))
              for c0 in range(0, n_chunks, per)]
    obs_span, obs0 = _exact_obs(params, mats, tables, gauss_params,
                                weight_arrays, Lc)
    log_trans = params.log_trans.contiguous()

    # position 0 values (empty tables get inert zero rows — masked by
    # true_lens > 0 below)
    a0 = params.log_start[None, :] + obs0
    m0 = torch.clamp(a0.amax(dim=-1, keepdim=True), min=-1e30)
    a0_hat = a0 - m0

    # ---- forward sweep: the carry entering every chunk, a group a launch
    entries = []                           # per group f32[B, n, S]
    carry = a0_hat
    for c0, c1 in groups:
        obs, lens, _ = obs_span(c0, c1)
        ckpts = ck.forward_checkpoints(log_trans, obs, carry, lens, Lc)
        entries.append(torch.cat([carry[:, None], ckpts[:, :-1]], dim=1))
        carry = ckpts[:, -1].contiguous()

    paths = [np.zeros(L, np.int32) for L in map(int, true_lens)]

    def default_consume(b, start, gamma):
        paths[b][start : start + len(gamma)] = np.argmax(gamma, axis=-1)

    consume = consume or default_consume

    # ---- backward pass, a group at a time in reverse: X2's sweep, then
    # the alphas and betas of every (table, chunk) in one launch each
    x_carry = torch.zeros((B, S), dtype=torch.float32, device=dev)
    for g in reversed(range(len(groups))):
        c0, c1 = groups[g]
        n = c1 - c0
        if g != len(groups) - 1:      # the last group's obs is still held
            obs, lens, _ = obs_span(c0, c1)
        starts = 1 + Lc * np.arange(c0, c1)
        ends = starts + Lc
        ckpts = ck.backward_checkpoints(
            log_trans, obs, x_carry,
            torch.from_numpy(true_lens > ends[-1]).to(dev), lens, Lc)
        exits = torch.cat([ckpts[:, 1:], x_carry[:, None]], dim=1)
        x_carry = ckpts[:, 0].contiguous()
        chunk_lens = np.clip(true_lens[:, None] - starts[None, :], 0, Lc)
        rows = obs.view(B * n, Lc, S)
        row_lens = _to_device(chunk_lens.reshape(-1), dev)
        a_hats, _ = ck.forward_chunk_values(
            log_trans, rows, entries[g].view(B * n, S), row_lens)
        b_hats, _ = ck.backward_chunk_values(
            log_trans, rows, exits.view(B * n, S),
            torch.from_numpy(
                (true_lens[:, None] > ends[None, :]).reshape(-1)).to(dev),
            row_lens)
        gamma = dp.posterior_scaled(a_hats, b_hats).view(B, n, Lc, S)
        del a_hats, b_hats
        gamma = gamma.cpu().numpy()
        for k in reversed(range(n)):
            for b in range(B):
                if chunk_lens[b, k] > 0:
                    consume(b, int(starts[k]), gamma[b, k, : chunk_lens[b, k]])

    # ---- position 0: gamma from a0 and the final x_carry ----
    # beta at position 0 = the step from x_carry, for rows longer than 1
    beta0 = ck.backward_chunk_values(
        log_trans,
        torch.zeros((B, 1, S), dtype=torch.float32, device=dev), x_carry,
        torch.from_numpy(true_lens > 1).to(dev),
        torch.ones((B,), dtype=torch.int32, device=dev),
    )[0][:, 0, :]
    gamma0 = dp.posterior_scaled(a0_hat, beta0).cpu().numpy()
    for b in range(B):
        if true_lens[b] > 0:
            consume(b, 0, gamma0[b : b + 1])
    return paths


def posterior_exact(
    params: HmmParams,
    tables: Sequence,
    chunk_len: int = 1 << 14,
    gauss_params=None,
    weight_arrays: Sequence[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """Exact max-posterior paths (argmax of the bit-exact chunked
    gamma)."""
    return posterior_sweep(params, tables, chunk_len,
                           gauss_params=gauss_params,
                           weight_arrays=weight_arrays)
