"""Genome chunk planning and batching (the sequence/context-parallel layer).

A copy of ``tehmm_tpu/parallel/chunking.py`` (NumPy only): the original
cannot be imported without JAX, because ``tehmm_tpu/parallel/__init__.py``
pulls in the JAX stitcher and meshes.  The tests hold the two equal.

The reference has no equivalent — it bounds DP length host-side by cutting
query regions into separate BED intervals (each then treated as an
independent sequence; chunk boundaries ARE interval boundaries, SURVEY.md
§5 "Long-context").  This layer is the rebuild's replacement (SURVEY.md §2c
"SP/CP" row, §7 layer 5): a chromosome-length interval is cut into
fixed-size windows with halo overlap, batched into a dense ``[N, Lc, T]``
tensor (uniform shapes => one XLA compilation), decoded in parallel, and
re-assembled boundary-exactly by ``parallel.stitch``.

Padding uses symbol 0 (missing) which emits log-prob 0 for every state,
plus explicit per-chunk lengths consumed by the masked DP kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from tehmm_tpu_torch.io.trackdata import TrackTable


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One decode window.  Coordinates are offsets into the source table
    (not genomic coordinates).  core = the span this chunk is responsible
    for in the final output; load = core extended by halos actually fed
    to the DP."""

    table_idx: int
    core_start: int
    core_end: int
    load_start: int
    load_end: int

    @property
    def core_len(self) -> int:
        return self.core_end - self.core_start

    @property
    def load_len(self) -> int:
        return self.load_end - self.load_start

    @property
    def core_offset(self) -> int:
        return self.core_start - self.load_start


@dataclasses.dataclass
class ChunkBatch:
    """Dense batch of chunks ready for the device."""

    symbols: np.ndarray        # [N, Lmax, T] uint
    lengths: np.ndarray        # [N] int32 (valid = load length)
    chunks: list[Chunk]

    def __len__(self) -> int:
        return len(self.chunks)


def plan_chunks(
    lengths: Sequence[int],
    chunk_len: int,
    halo: int = 0,
) -> list[Chunk]:
    """Cut each table's [0, len) span into core windows of ``chunk_len``
    extended by ``halo`` on both sides (clipped at table edges)."""
    if chunk_len <= 0:
        raise ValueError("chunk_len must be positive")
    out: list[Chunk] = []
    for idx, L in enumerate(lengths):
        pos = 0
        while pos < L:
            core_end = min(pos + chunk_len, L)
            out.append(
                Chunk(
                    table_idx=idx,
                    core_start=pos,
                    core_end=core_end,
                    load_start=max(0, pos - halo),
                    load_end=min(L, core_end + halo),
                )
            )
            pos = core_end
    return out


def batch_chunks(
    tables: Sequence[TrackTable] | Sequence[np.ndarray],
    chunks: Sequence[Chunk],
    pad_to_multiple: int = 1,
) -> ChunkBatch:
    """Gather chunk symbol windows into one padded dense array."""
    mats = [
        t.symbols if isinstance(t, TrackTable) else t for t in tables
    ]
    T = mats[0].shape[1]
    lmax = max((c.load_len for c in chunks), default=1)
    if pad_to_multiple > 1:
        lmax = -(-lmax // pad_to_multiple) * pad_to_multiple
    n = len(chunks)
    dtype = mats[0].dtype
    symbols = np.zeros((n, lmax, T), dtype=dtype)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, c in enumerate(chunks):
        w = mats[c.table_idx][c.load_start : c.load_end]
        symbols[i, : len(w)] = w
        lengths[i] = len(w)
    return ChunkBatch(symbols=symbols, lengths=lengths, chunks=list(chunks))
