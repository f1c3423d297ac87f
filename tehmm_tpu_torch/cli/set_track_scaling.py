"""set-track-scaling: choose per-track numeric binning and rewrite the XML
(reference: setTrackScaling.py; SURVEY.md §2b — scan numeric tracks, pick
scale/logScale so values bin into <= N integer symbols, rewrite the
tracks XML).

The port's copy of ``tehmm_tpu/cli/set_track_scaling.py``: host code
that runs no device code, so it takes no ``--device``.

Usage:
  python -m tehmm_tpu_torch.cli.set_track_scaling tracks.xml regions.bed \\
      out.xml [--numBins N] [--tracks a,b]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from tehmm_tpu_torch.io import TrackList, read_bed_intervals
from tehmm_tpu_torch.io.trackdata import _BedSource
from tehmm_tpu_torch.utils.common import add_logging_options, logger, \
    set_logging_from_options


def collect_numeric_values(track, regions) -> np.ndarray:
    """All raw numeric values of a BED/BigWig track over the regions."""
    p = track.path.lower()
    vals: list[float] = []
    if p.endswith((".fa", ".fasta", ".fna")):
        # sequence tracks are categorical, never numeric — feeding a
        # FASTA to the BED parser crashes (or silently yields nothing,
        # depending on the parser backend)
        return np.array([])
    if p.endswith((".bw", ".bigwig")):
        from tehmm_tpu_torch.io.bigwig import BigWigFile

        with BigWigFile(track.path) as bw:
            for chrom, s, e, *_ in regions:
                v = bw.values(chrom, s, e)
                vals.extend(v[~np.isnan(v)].tolist())
    else:
        src = _BedSource(track.path, track.val_col)
        for chrom, s, e, *_ in regions:
            for rec in src.overlapping(chrom, s, e):
                if rec.value is None:
                    continue
                try:
                    vals.append(float(rec.value))
                except ValueError:
                    return np.array([])  # non-numeric track
    return np.asarray(vals, dtype=np.float64)


def choose_scaling(
    vals: np.ndarray, num_bins: int
) -> dict[str, float] | None:
    """Pick scale/logScale/shift so distinct bins <= num_bins.

    Linear when the dynamic range is small, logarithmic otherwise
    (reference heuristic [R?]; documented contract of this rebuild).
    Returns attribute dict or None for non-numeric/empty tracks.
    """
    if num_bins < 2:
        raise ValueError(
            f"--numBins must be >= 2, got {num_bins} (one bin cannot "
            f"distinguish any values)"
        )
    if len(vals) == 0:
        return None
    vmin, vmax = float(vals.min()), float(vals.max())
    if vmax == vmin:
        return {"scale": 1.0}
    # "already binned" only when the values really are a small set of
    # non-negative INTEGERS — flooring continuous values first made any
    # track with range < num_bins (e.g. p-values in [0, 1)) pass
    # unscaled and collapse to one or two symbols
    distinct = np.unique(vals)
    if (
        len(distinct) <= num_bins and vmin >= 0
        and np.all(distinct == np.floor(distinct))
    ):
        return {"scale": 1.0}
    # shift so min is 1 (log-safe), then decide linear vs log by range
    shift = 1.0 - vmin
    span = vmax + shift
    if span / 1.0 <= num_bins * 10:  # modest range -> linear
        return {"scale": (num_bins - 1) / span, "shift": shift}
    base = math.exp(math.log(span) / (num_bins - 1))
    return {"logScale": base, "shift": shift}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="set-track-scaling",
        description="Auto-select numeric binning for each track",
    )
    p.add_argument("tracksInfo")
    p.add_argument("allBed")
    p.add_argument("outputTracksInfo")
    p.add_argument("--numBins", type=int, default=10,
                   help="max integer symbols per numeric track")
    p.add_argument("--tracks", default=None,
                   help="comma-separated subset of track names")
    add_logging_options(p)
    return p


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    set_logging_from_options(opts)
    track_list = TrackList(opts.tracksInfo)
    regions = read_bed_intervals(opts.allBed, ncol=3)
    only = set(opts.tracks.split(",")) if opts.tracks else None
    for track in track_list:
        if only and track.name not in only:
            continue
        vals = collect_numeric_values(track, regions)
        attrs = choose_scaling(vals, opts.numBins)
        if attrs is None:
            logger.info("track %s: not numeric, skipping", track.name)
            continue
        track.scale = attrs.get("scale")
        track.log_scale = attrs.get("logScale")
        track.shift = attrs.get("shift")
        logger.info("track %s: %s", track.name, attrs)
    track_list.save_xml(opts.outputTracksInfo)
    return 0


if __name__ == "__main__":
    sys.exit(main())
