"""Adapters normalizing external TE-caller outputs into usable tracks
(reference: cleanRM.py, cleanLtrFinderID.py [R?]; SURVEY.md §2b).

The port's copy of ``tehmm_tpu/cli/clean_external.py``: host code
that runs no device code, so it takes no ``--device``.

  clean-rm:  RepeatMasker .out/.bed name cleanup — strips family suffixes
             (e.g. "L1MA4#LINE/L1" -> "LINE" at --level class, "LINE/L1"
             at --level family) so the alphabet stays small.
  clean-ltr: LTR_FINDER-style BED de-duplication — numeric ID suffixes
             ("LTR|left|42") are stripped so repeated element parts share
             one category.

Usage:
  python -m tehmm_tpu_torch.cli.clean_external clean-rm  in.bed out.bed \\
      [--level class]
  python -m tehmm_tpu_torch.cli.clean_external clean-ltr in.bed out.bed
"""

from __future__ import annotations

import argparse
import sys

from tehmm_tpu_torch.io import read_bed_intervals, write_bed_intervals


def clean_rm_name(name: str, level: str = "class") -> str:
    """'L1MA4#LINE/L1' -> class 'LINE' or family 'LINE/L1';
    plain names pass through."""
    if "#" in name:
        _elem, _, taxo = name.partition("#")
    else:
        taxo = name
    if level == "family":
        return taxo
    return taxo.split("/")[0]


def clean_ltr_name(name: str) -> str:
    """'LTR|left|42' -> 'LTR|left'; trailing pure-numeric ID fields are
    dropped."""
    parts = name.split("|")
    while parts and parts[-1].isdigit():
        parts.pop()
    return "|".join(parts) if parts else name


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="clean-external")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("clean-rm")
    sp.add_argument("inBed"); sp.add_argument("outBed")
    sp.add_argument("--level", choices=("class", "family"),
                    default="class")

    sp = sub.add_parser("clean-ltr")
    sp.add_argument("inBed"); sp.add_argument("outBed")

    opts = p.parse_args(argv)
    ivs = read_bed_intervals(opts.inBed, ncol=4)
    # BED3 records have no name to clean: keep the BED "." placeholder
    # instead of emitting the literal string "None"
    if opts.cmd == "clean-rm":
        out = [
            (c, s, e,
             "." if n is None else clean_rm_name(str(n), opts.level))
            for c, s, e, n in ivs
        ]
    else:
        out = [
            (c, s, e, "." if n is None else clean_ltr_name(str(n)))
            for c, s, e, n in ivs
        ]
    write_bed_intervals(out, opts.outBed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
