"""track-dump: print the loaded integer symbol matrix for inspection
(reference: trackDump.py; SURVEY.md §2b).

The port's copy of ``tehmm_tpu/cli/track_dump.py``: host code
that runs no device code, so it takes no ``--device``.

Usage:
  python -m tehmm_tpu_torch.cli.track_dump tracks.xml regions.bed [--values]
"""

from __future__ import annotations

import argparse
import sys

from tehmm_tpu_torch.io import TrackList, load_track_data, read_bed_intervals


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="track-dump",
        description="Dump the discretized track matrix over regions",
    )
    p.add_argument("tracksInfo")
    p.add_argument("regionsBed")
    p.add_argument("--values", action="store_true",
                   help="print original values instead of symbol ints")
    return p


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    track_list = TrackList(opts.tracksInfo)
    regions = read_bed_intervals(opts.regionsBed, ncol=3)
    td = load_track_data(track_list, regions)
    names = [t.name for t in track_list]
    # gaussian tracks keep their continuous values on tab.values (their
    # symbols column is all-missing by design) — map track index to its
    # values column so --values shows the real data
    import numpy as np

    gcol = {t: g for g, t in enumerate(td.gauss_track_indices)}
    print("#chrom\tpos\t" + "\t".join(names))
    for tab in td.tables:
        for i in range(len(tab)):
            row = []
            for t_idx, t in enumerate(track_list):
                if opts.values and t_idx in gcol \
                        and tab.values is not None:
                    v = float(tab.values[i, gcol[t_idx]])
                    row.append("." if np.isnan(v) else f"{v:g}")
                    continue
                sym = int(tab.symbols[i, t_idx])
                if opts.values:
                    cm = td.category_maps[t.name]
                    val = cm.get_back_map(sym)
                    row.append("." if val is None else str(val))
                else:
                    row.append(str(sym))
            print(f"{tab.chrom}\t{tab.start + i}\t" + "\t".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
