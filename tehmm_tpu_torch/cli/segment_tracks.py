"""segment-tracks on the port: collapse identical multi-track columns into
segments.

Counterpart of ``tehmm_tpu/cli/segment_tracks.py`` (reference:
segmentTracks.py; SURVEY.md §3.4): runs of positions whose symbol vector
is identical (or differs in at most ``--thresh`` tracks), and whose
gaussian-track values do not change, become single segments — the
intervals that ``train --segment`` and ``eval --segment`` take as one
observation each.  A host tool: it reads the tracks and writes BED, and
runs no device code.

Usage:
  python -m tehmm_tpu_torch.cli.segment_tracks tracks.xml regions.bed \\
      out.bed [--thresh N] [--maxLen N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tehmm_tpu_torch.io import (
    TrackList,
    load_track_data,
    read_bed_intervals,
    write_bed_intervals,
)
from tehmm_tpu_torch.utils.common import (
    add_logging_options,
    set_logging_from_options,
)


def segment_table(
    symbols: np.ndarray, thresh: int = 0,
    values: np.ndarray | None = None,
) -> list[tuple[int, int]]:
    """[L, T] -> [(start, end)] maximal runs where consecutive columns
    differ in at most ``thresh`` tracks.

    ``values`` ([L, G], NaN = missing): gaussian tracks carry their
    observations here and their symbols column is all-missing, so a
    changed continuous value creates a boundary too (two NaNs count as
    equal)."""
    L = len(symbols)
    if L == 0:
        return []
    diff_counts = (symbols[1:] != symbols[:-1]).sum(axis=1)
    if values is not None and values.size:
        va, vb = values[1:], values[:-1]
        vdiff = (va != vb) & ~(np.isnan(va) & np.isnan(vb))
        diff_counts = diff_counts + vdiff.sum(axis=1)
    boundaries = np.flatnonzero(diff_counts > thresh) + 1
    edges = np.concatenate([[0], boundaries, [L]])
    return [(int(s), int(e)) for s, e in zip(edges[:-1], edges[1:])]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="segment-tracks (torch)",
        description="Collapse runs of identical track columns into "
                    "segment intervals",
    )
    p.add_argument("tracksInfo")
    p.add_argument("allBed", help="regions to segment")
    p.add_argument("outBed")
    p.add_argument("--thresh", type=int, default=0,
                   help="max tracks allowed to change without a boundary")
    p.add_argument("--maxLen", type=int, default=0,
                   help="split segments longer than this (0 = no limit)")
    add_logging_options(p)
    return p


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    set_logging_from_options(opts)
    track_list = TrackList(opts.tracksInfo)
    regions = read_bed_intervals(opts.allBed, ncol=3)
    td = load_track_data(track_list, regions)
    out = []
    seg_i = 0
    for tab in td.tables:
        for s, e in segment_table(tab.symbols, opts.thresh, tab.values):
            spans = [(s, e)]
            if opts.maxLen > 0:
                spans = [(x, min(x + opts.maxLen, e))
                         for x in range(s, e, opts.maxLen)]
            for x, y in spans:
                out.append((tab.chrom, tab.start + x, tab.start + y,
                            f"seg{seg_i}"))
                seg_i += 1
    write_bed_intervals(out, opts.outBed)
    n_pos = sum(len(t) for t in td.tables)
    print(
        f"{len(out)} segments from {n_pos} positions "
        f"({n_pos / max(len(out), 1):.1f}x compression)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
