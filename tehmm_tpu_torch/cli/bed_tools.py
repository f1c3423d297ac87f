"""BED wrangling utilities (reference: addBedGaps.py, removeBedOverlaps.py,
chunkBedRegions.py, addBedColors.py, bedStats.py; SURVEY.md §2b).

The port's copy of ``tehmm_tpu/cli/bed_tools.py``: host code
that runs no device code, so it takes no ``--device``.

Each tool is exposed both as a library function and as a CLI submodule:

  python -m tehmm_tpu_torch.cli.bed_tools add-gaps  in.bed out.bed --state 0
  python -m tehmm_tpu_torch.cli.bed_tools remove-overlaps in.bed out.bed
  python -m tehmm_tpu_torch.cli.bed_tools chunk  in.bed out.bed --maxLen N
  python -m tehmm_tpu_torch.cli.bed_tools add-colors  in.bed out.bed
  python -m tehmm_tpu_torch.cli.bed_tools stats  in.bed
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from collections import defaultdict

from tehmm_tpu_torch.io import read_bed_intervals, write_bed_intervals


# ----------------------------------------------------------------------
def add_bed_gaps(
    intervals: list[tuple], default_state: str = "0",
    regions: list[tuple] | None = None,
) -> list[tuple]:
    """Fill gaps between intervals with a default/background state so
    supervised training covers every base (reference: addBedGaps.py).
    With ``regions``, also fill out to each region's bounds."""
    by_chrom: dict[str, list] = defaultdict(list)
    for iv in intervals:
        by_chrom[iv[0]].append(iv)
    bounds: dict[str, tuple[int, int]] = {}
    if regions:
        for c, s, e, *_ in regions:
            lo, hi = bounds.get(c, (s, e))
            bounds[c] = (min(lo, s), max(hi, e))
    out = []
    # iterate region chromosomes too: a --regions chromosome with zero
    # annotation intervals must still fill with the background state
    # (previously it silently got no coverage at all)
    for chrom in sorted(set(by_chrom) | set(bounds)):
        ivs = sorted(by_chrom.get(chrom, ()), key=lambda x: x[1])
        if not ivs:
            lo, hi = bounds[chrom]
            if hi > lo:
                out.append((chrom, lo, hi, default_state))
            continue
        lo, hi = bounds.get(chrom, (ivs[0][1], max(x[2] for x in ivs)))
        pos = lo
        for iv in ivs:
            if iv[1] > pos:
                out.append((chrom, pos, iv[1], default_state))
            out.append(iv)
            pos = max(pos, iv[2])
        if hi > pos:
            out.append((chrom, pos, hi, default_state))
    return out


# ----------------------------------------------------------------------
def remove_bed_overlaps(
    intervals: list[tuple], mode: str = "first"
) -> list[tuple]:
    """Resolve overlaps so each base has exactly one label (reference:
    removeBedOverlaps.py).  mode='first': earlier file order wins;
    'last': later wins."""
    by_chrom: dict[str, list] = defaultdict(list)
    for order, iv in enumerate(intervals):
        prio = -order if mode == "first" else order
        by_chrom[iv[0]].append((prio, order, iv))
    out = []
    for chrom in sorted(by_chrom):
        recs = by_chrom[chrom]
        # sweep: at each boundary keep the highest-priority active record
        events = []
        for prio, order, iv in recs:
            events.append((iv[1], 0, prio, order, iv))   # open
            events.append((iv[2], 1, prio, order, iv))   # close
        events.sort(key=lambda e: (e[0], e[1]))
        active: dict[int, tuple] = {}
        prev_pos = None
        chrom_out = []
        for pos, kind, prio, order, iv in events:
            if prev_pos is not None and pos > prev_pos and active:
                best = max(active.values(), key=lambda v: v[0])
                chrom_out.append(
                    (chrom, prev_pos, pos) + tuple(best[1][3:])
                )
            if kind == 0:
                active[order] = (prio, iv)
            else:
                active.pop(order, None)
            prev_pos = pos
        # merge equal-name book-ended pieces
        merged = []
        for iv in chrom_out:
            if (
                merged and merged[-1][2] == iv[1]
                and merged[-1][3:] == iv[3:]
            ):
                merged[-1] = (
                    merged[-1][0], merged[-1][1], iv[2], *iv[3:]
                )
            else:
                merged.append(iv)
        out.extend(merged)
    return out


# ----------------------------------------------------------------------
def chunk_bed_regions(
    intervals: list[tuple], max_len: int
) -> list[tuple]:
    """Split regions into <= max_len chunks for tractable DP (reference:
    chunkBedRegions.py [R?])."""
    if max_len <= 0:
        raise ValueError(f"--maxLen must be positive, got {max_len}")
    out = []
    for iv in intervals:
        chrom, s, e = iv[0], iv[1], iv[2]
        pos = s
        while pos < e:
            end = min(pos + max_len, e)
            out.append((chrom, pos, end) + tuple(iv[3:]))
            pos = end
    return out


# ----------------------------------------------------------------------
_PALETTE = [
    (228, 26, 28), (55, 126, 184), (77, 175, 74), (152, 78, 163),
    (255, 127, 0), (255, 255, 51), (166, 86, 40), (247, 129, 191),
    (153, 153, 153), (0, 139, 139), (139, 0, 139), (85, 107, 47),
]


def state_color(name: str) -> tuple[int, int, int]:
    h = int(hashlib.md5(name.encode()).hexdigest(), 16)
    return _PALETTE[h % len(_PALETTE)]


def add_bed_colors(intervals: list[tuple]) -> list[tuple]:
    """Assign a stable itemRgb per state name for browser display
    (reference: addBedColors.py).  Output is BED9."""
    out = []
    for iv in intervals:
        chrom, s, e = iv[0], iv[1], iv[2]
        name = str(iv[3]) if len(iv) > 3 else "."
        r, g, b = state_color(name)
        out.append(
            (chrom, s, e, name, 0, "+", s, e, f"{r},{g},{b}")
        )
    return out


# ----------------------------------------------------------------------
def bed_stats(intervals: list[tuple]) -> dict:
    """Per-state counts and length stats (reference: bedStats.py [R?])."""
    by_name: dict[str, list[int]] = defaultdict(list)
    for iv in intervals:
        name = str(iv[3]) if len(iv) > 3 else "."
        by_name[name].append(iv[2] - iv[1])
    stats = {}
    for name, lens in sorted(by_name.items()):
        total = sum(lens)
        stats[name] = {
            "count": len(lens),
            "total_bases": total,
            "min_len": min(lens),
            "max_len": max(lens),
            "mean_len": total / len(lens),
        }
    return stats


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="bed-tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("add-gaps")
    sp.add_argument("inBed"); sp.add_argument("outBed")
    sp.add_argument("--state", default="0")
    sp.add_argument("--regions", default=None)

    sp = sub.add_parser("remove-overlaps")
    sp.add_argument("inBed"); sp.add_argument("outBed")
    sp.add_argument("--mode", choices=("first", "last"), default="first")

    sp = sub.add_parser("chunk")
    sp.add_argument("inBed"); sp.add_argument("outBed")
    sp.add_argument("--maxLen", type=int, required=True)

    sp = sub.add_parser("add-colors")
    sp.add_argument("inBed"); sp.add_argument("outBed")

    sp = sub.add_parser("stats")
    sp.add_argument("inBed")

    opts = p.parse_args(argv)

    def read4(path):
        # BED3 input has no name column; use the BED "." placeholder
        # instead of the literal string "None" everywhere downstream
        return [
            (c, s, e, "." if n is None else n)
            for c, s, e, n in read_bed_intervals(path, ncol=4)
        ]

    if opts.cmd == "add-gaps":
        ivs = read4(opts.inBed)
        regions = (
            read_bed_intervals(opts.regions, ncol=3)
            if opts.regions else None
        )
        write_bed_intervals(
            add_bed_gaps(ivs, opts.state, regions), opts.outBed
        )
    elif opts.cmd == "remove-overlaps":
        ivs = read4(opts.inBed)
        write_bed_intervals(
            remove_bed_overlaps(ivs, opts.mode), opts.outBed
        )
    elif opts.cmd == "chunk":
        ivs = read4(opts.inBed)
        write_bed_intervals(
            chunk_bed_regions(ivs, opts.maxLen), opts.outBed
        )
    elif opts.cmd == "add-colors":
        ivs = read4(opts.inBed)
        write_bed_intervals(add_bed_colors(ivs), opts.outBed)
    elif opts.cmd == "stats":
        import json

        ivs = read4(opts.inBed)
        print(json.dumps(bed_stats(ivs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
