"""fit-state-names: rename anonymous learned states to truth names
(reference: fitStateNames.py; SURVEY.md §2b — greedy overlap/F1
assignment of unsupervised state numbers to truth labels, then a renamed
BED is written so compare-bed-states can score it).

The port's copy of ``tehmm_tpu/cli/fit_state_names.py``: host code
that runs no device code, so it takes no ``--device``.

Usage:
  python -m tehmm_tpu_torch.cli.fit_state_names truth.bed pred.bed out.bed
"""

from __future__ import annotations

import argparse
import sys

from tehmm_tpu_torch.io import read_bed_intervals, write_bed_intervals
from tehmm_tpu_torch.cli.compare_bed_states import base_level_confusion


def fit_names(
    truth: list[tuple], pred: list[tuple]
) -> dict[str, str]:
    """Greedy 1:1 assignment pred-name -> truth-name by descending base
    overlap.  Unassigned prediction names keep themselves UNLESS that
    would collide with a name already assigned to a different
    prediction state (two distinct predicted states would silently
    merge under one label and be scored as one); colliding leftovers
    get a distinguishing suffix instead."""
    conf = base_level_confusion(truth, pred)
    pairs = sorted(
        (kv for kv in conf.items()
         if kv[0][0] is not None and kv[0][1] is not None),
        key=lambda kv: -kv[1],
    )
    mapping: dict[str, str] = {}
    used: set[str] = set()
    for (t_name, p_name), _overlap in pairs:
        if p_name in mapping or t_name in used:
            continue
        mapping[p_name] = t_name
        used.add(t_name)
    for p_name in sorted({str(n) for _, _, _, n in pred} - set(mapping)):
        if p_name not in used:
            continue          # keeps itself implicitly (no map entry)
        k = 2
        name = f"{p_name}_unmapped"
        while name in used:
            name = f"{p_name}_unmapped{k}"
            k += 1
        mapping[p_name] = name
        used.add(name)
    return mapping


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fit-state-names",
        description="Greedily map predicted state names onto truth names",
    )
    p.add_argument("truthBed")
    p.add_argument("predBed")
    p.add_argument("outBed")
    p.add_argument("--printMap", action="store_true")
    return p


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    truth = read_bed_intervals(opts.truthBed, ncol=4)
    pred = read_bed_intervals(opts.predBed, ncol=4)
    mapping = fit_names(truth, pred)
    if opts.printMap:
        for p_name, t_name in sorted(mapping.items()):
            print(f"{p_name}\t{t_name}")
    renamed = [
        (c, s, e, mapping.get(str(n), str(n))) for c, s, e, n in pred
    ]
    write_bed_intervals(renamed, opts.outBed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
