"""Segment-resolution observation sequences (--segment mode).

Reference flow (SURVEY.md §3.4): ``segmentTracks.py`` collapses runs of
identical multi-track columns into segment intervals; ``teHmmTrain.py
--segment`` / ``teHmmEval.py --segment`` then treat ONE segment as ONE
observation (orders-of-magnitude shorter sequences), optionally scaling
each segment's emission log-probability by its length
(``effectiveSegmentLength`` [R?] — here: emission log-prob × length,
i.e. P^len, enabled with --segLen).

A SegmentTable looks like a TrackTable whose row i is the symbol vector
of segment i; consecutive segments (book-ended, same chrom) chain into
one observation sequence.  ``expand_path`` maps a per-segment state path
back to base-space intervals for BED output.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from tehmm_tpu_torch.io.trackdata import TrackData, TrackTable, load_track_data
from tehmm_tpu_torch.io.trackxml import TrackList
from tehmm_tpu_torch.utils.common import logger
from tehmm_tpu_torch.io.category import CategoryMap


@dataclasses.dataclass
class SegmentTable:
    """One chained sequence of segments (duck-types TrackTable for the
    model layer: has .symbols and len())."""

    chrom: str
    start: int                  # genomic start of the first segment
    end: int                    # genomic end of the last segment
    symbols: np.ndarray         # [n_segments, T]
    seg_bounds: np.ndarray      # [n_segments + 1] genomic boundaries
    lengths: np.ndarray         # [n_segments] segment lengths
    # gaussian-track columns: per-segment mean of the finite base values
    # (NaN when a segment has none) — one continuous observation per
    # segment, scaled like the categorical emissions under --segLen
    values: np.ndarray | None = None   # [n_segments, G] f32

    def __len__(self) -> int:
        return len(self.symbols)


def load_segment_data(
    track_list: TrackList,
    segment_intervals: Sequence[Sequence],
    category_maps: dict[str, CategoryMap] | None = None,
    update_maps: bool | None = None,
) -> tuple[TrackData, list[SegmentTable]]:
    """Load tracks at segment resolution.

    Each segment contributes one row (the track values sampled at the
    segment's first base — segments produced by segment-tracks are
    constant by construction).  Consecutive (book-ended) segments chain
    into one SegmentTable.

    Returns (TrackData with per-base tables for map bookkeeping,
    segment tables list).
    """
    ivs = sorted(
        (iv[0], int(iv[1]), int(iv[2])) for iv in segment_intervals
    )
    # zero-length records (start == end) contribute no observation and
    # would corrupt the per-chain offset math: one ending a chain makes
    # symbols[offs] index past the region, one mid-chain makes
    # np.add.reduceat return an element instead of an empty sum
    n_zero = sum(1 for iv in ivs if iv[2] <= iv[1])
    if n_zero:
        logger.warning(
            "dropping %d zero-length segment record(s)", n_zero
        )
        ivs = [iv for iv in ivs if iv[2] > iv[1]]
    if not ivs:
        return load_track_data(
            track_list, [], category_maps=category_maps,
            update_maps=update_maps,
        ), []
    # chain book-ended segments
    chains: list[list[tuple[str, int, int]]] = []
    for iv in ivs:
        if chains and chains[-1][-1][0] == iv[0] \
                and chains[-1][-1][2] == iv[1]:
            chains[-1].append(iv)
        else:
            chains.append([iv])

    # load one-base windows at each segment start, one region per chain
    # (loading the full chain span once, then sampling, keeps I/O linear)
    chain_regions = [
        (c[0][0], c[0][1], c[-1][2]) for c in chains
    ]
    td = load_track_data(
        track_list, chain_regions,
        category_maps=category_maps, update_maps=update_maps,
    )
    seg_tables = []
    for chain, region_tab in zip(chains, td.tables):
        bounds = np.asarray(
            [c[1] for c in chain] + [chain[-1][2]], np.int64
        )
        offs = bounds[:-1] - region_tab.start
        symbols = region_tab.symbols[offs]           # [n_segments, T]
        values = None
        if region_tab.values is not None:
            # gaussian tracks vary within a segment (only the symbol
            # columns are constant by construction): summarize each
            # segment by the mean of its finite base values
            v = region_tab.values                    # [L, G]
            fin = np.isfinite(v)
            sums = np.add.reduceat(
                np.where(fin, v, 0.0), offs, axis=0
            )
            cnts = np.add.reduceat(
                fin.astype(np.float32), offs, axis=0
            )
            values = np.where(
                cnts > 0, sums / np.maximum(cnts, 1e-9), np.nan
            ).astype(np.float32)
        seg_tables.append(SegmentTable(
            chrom=chain[0][0],
            start=int(bounds[0]),
            end=int(bounds[-1]),
            symbols=symbols,
            seg_bounds=bounds,
            lengths=(bounds[1:] - bounds[:-1]).astype(np.int64),
            values=values,
        ))
    return td, seg_tables


def expand_path(
    table: SegmentTable, path: np.ndarray, state_names: list[str]
) -> list[tuple]:
    """Per-segment state path -> merged base-space BED intervals."""
    out: list[list] = []
    for i, s in enumerate(np.asarray(path)):
        name = state_names[int(s)]
        lo = int(table.seg_bounds[i])
        hi = int(table.seg_bounds[i + 1])
        if out and out[-1][2] == lo and out[-1][3] == name:
            out[-1][2] = hi
        else:
            out.append([table.chrom, lo, hi, name])
    return [tuple(x) for x in out]
