"""compare-bed-states: accuracy between two BED annotations
(reference: compareBedStates.py; SURVEY.md §2b, §5 "Evaluation").

The port's copy of ``tehmm_tpu/cli/compare_bed_states.py``: host code
that runs no device code, so it takes no ``--device``.

Computes base-level and interval-level precision/recall/F1 per state
between a prediction BED and a truth BED, plus a confusion summary.
Interval matching tolerates boundary slack (--slack).

Usage:
  python -m tehmm_tpu_torch.cli.compare_bed_states truth.bed pred.bed \\
      [--slack N] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from tehmm_tpu_torch.io import read_bed_intervals


def _paint(intervals) -> dict[str, list[tuple[int, int, str]]]:
    """Per-chromosome DISJOINT sorted (start, end, name) runs, later
    records overwriting earlier ones — the same painting semantics the
    training loader applies (io/trackdata fill_intervals).  A raw
    two-pointer sweep over self-overlapping input silently misses
    overlap pairs, so every consumer flattens first."""
    by_chrom: dict[str, list] = defaultdict(list)
    for c, s, e, n in intervals:
        if e > s:
            by_chrom[c].append((int(s), int(e), str(n)))
    out: dict[str, list[tuple[int, int, str]]] = {}
    for c, recs in by_chrom.items():
        bounds = sorted({x for s, e, _ in recs for x in (s, e)})
        idx = {b: i for i, b in enumerate(bounds)}
        owner = [-1] * max(len(bounds) - 1, 0)
        for k, (s, e, _) in enumerate(recs):
            for j in range(idx[s], idx[e]):
                owner[j] = k
        runs: list[tuple[int, int, str]] = []
        for j, own in enumerate(owner):
            if own < 0:
                continue
            name = recs[own][2]
            if runs and runs[-1][1] == bounds[j] \
                    and runs[-1][2] == name:
                runs[-1] = (runs[-1][0], bounds[j + 1], name)
            else:
                runs.append((bounds[j], bounds[j + 1], name))
        out[c] = runs
    return out


def base_level_confusion(
    truth: list[tuple], pred: list[tuple]
) -> dict[tuple[str | None, str | None], int]:
    """Overlap length for every (truthName, predName) pair via a sorted
    boundary sweep (no per-base arrays — genome-safe).  Bases covered
    by only ONE side appear under a ``None`` partner — a truth base
    with no prediction is a real miss and must count against recall
    (previously such bases silently vanished from every denominator,
    so predicting 1% of the truth could score recall 1.0).  Inputs are
    painted to disjoint runs first (see _paint)."""
    conf: dict[tuple[str | None, str | None], int] = defaultdict(int)
    tmap, pmap = _paint(truth), _paint(pred)
    for chrom in set(tmap) | set(pmap):
        t = tmap.get(chrom, [])
        p = pmap.get(chrom, [])
        bounds = sorted(
            {x for s, e, _ in t for x in (s, e)}
            | {x for s, e, _ in p for x in (s, e)}
        )
        ti = pi = 0
        for j in range(len(bounds) - 1):
            lo, hi = bounds[j], bounds[j + 1]
            while ti < len(t) and t[ti][1] <= lo:
                ti += 1
            while pi < len(p) and p[pi][1] <= lo:
                pi += 1
            tn = (t[ti][2] if ti < len(t) and t[ti][0] <= lo else None)
            pn = (p[pi][2] if pi < len(p) and p[pi][0] <= lo else None)
            if tn is None and pn is None:
                continue
            conf[(tn, pn)] += hi - lo
    return dict(conf)


def base_level_prf(
    conf: dict[tuple[str, str], int]
) -> dict[str, dict[str, float]]:
    """Per-state precision/recall/F1 from the confusion overlap matrix.
    ``None`` partners (bases covered by only one file) contribute to
    fn/fp but are not themselves states."""
    states = sorted(
        {t for t, _ in conf if t is not None}
        | {p for _, p in conf if p is not None}
    )
    out = {}
    for s in states:
        tp = conf.get((s, s), 0)
        fn = sum(v for (t, p), v in conf.items() if t == s and p != s)
        fp = sum(v for (t, p), v in conf.items() if p == s and t != s)
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        out[s] = {
            "precision": prec, "recall": rec, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn,
        }
    return out


def interval_level_prf(
    truth: list[tuple], pred: list[tuple], slack: int = 0
) -> dict[str, dict[str, float]]:
    """An interval matches if an interval of the same name on the other
    side overlaps it with boundaries within ``slack`` bases (reference:
    compareBedStates boundary-slack tolerance [R?])."""

    def matches(a, b) -> bool:
        # overlap AND both boundaries within slack — uniformly for any
        # slack, so the metric is monotone in the tolerance.  (The old
        # split semantics counted ANY overlap at slack=0 and dropped
        # the overlap requirement at slack>0, so slack=1 was stricter
        # than slack=0 and two barely-touching intervals could "match"
        # exactly.)
        if a[0] != b[0] or str(a[3]) != str(b[3]):
            return False
        if max(a[1], b[1]) >= min(a[2], b[2]):
            return False
        return abs(a[1] - b[1]) <= slack and abs(a[2] - b[2]) <= slack

    def match_count(src, dst):
        by_chrom: dict[str, list] = defaultdict(list)
        for iv in dst:
            by_chrom[iv[0]].append(iv)
        for c in by_chrom:
            by_chrom[c].sort(key=lambda x: x[1])
        counts: dict[str, int] = defaultdict(int)
        totals: dict[str, int] = defaultdict(int)
        for iv in src:
            name = str(iv[3])
            totals[name] += 1
            lo = iv[1] - max(slack, 1) - 1
            hi = iv[2] + max(slack, 1) + 1
            for other in by_chrom.get(iv[0], []):
                if other[2] < lo:
                    continue
                if other[1] > hi:
                    break
                if matches(iv, other):
                    counts[name] += 1
                    break
        return counts, totals

    t_matched, t_total = match_count(truth, pred)
    p_matched, p_total = match_count(pred, truth)
    states = sorted(set(t_total) | set(p_total))
    out = {}
    for s in states:
        rec = t_matched.get(s, 0) / t_total[s] if t_total.get(s) else 0.0
        prec = (
            p_matched.get(s, 0) / p_total[s] if p_total.get(s) else 0.0
        )
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        out[s] = {"precision": prec, "recall": rec, "f1": f1,
                  "n_truth": t_total.get(s, 0), "n_pred": p_total.get(s, 0)}
    return out


def compare_bed_files(
    truth_path: str, pred_path: str, slack: int = 0
) -> dict:
    truth = read_bed_intervals(truth_path, ncol=4)
    pred = read_bed_intervals(pred_path, ncol=4)
    conf = base_level_confusion(truth, pred)
    # accuracy over TRUTH-covered bases: unpredicted truth bases count
    # as wrong; prediction outside the truth's coverage hits precision
    # (fp) but not accuracy (the truth simply has no opinion there)
    total = sum(v for (t, _), v in conf.items() if t is not None)
    correct = sum(v for (t, p), v in conf.items() if t == p)
    none_key = "(uncovered)"
    return {
        "base_accuracy": correct / total if total else 0.0,
        "base": base_level_prf(conf),
        "interval": interval_level_prf(truth, pred, slack),
        "confusion": {
            f"{none_key if t is None else t}|"
            f"{none_key if p is None else p}": v
            for (t, p), v in sorted(
                conf.items(), key=lambda kv: (
                    kv[0][0] or "", kv[0][1] or ""
                )
            )
        },
    }


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="compare-bed-states",
        description="Base- and interval-level accuracy between two BEDs",
    )
    p.add_argument("truthBed")
    p.add_argument("predBed")
    p.add_argument("--slack", type=int, default=0,
                   help="interval boundary slack in bases")
    p.add_argument("--json", action="store_true",
                   help="machine-readable JSON output")
    return p


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    res = compare_bed_files(opts.truthBed, opts.predBed, opts.slack)
    if opts.json:
        print(json.dumps(res, indent=1))
        return 0
    print(f"base accuracy: {res['base_accuracy']:.4f}")
    print(f"{'state':12s} {'prec':>7s} {'rec':>7s} {'f1':>7s}   "
          f"{'i-prec':>7s} {'i-rec':>7s} {'i-f1':>7s}")
    states = sorted(set(res["base"]) | set(res["interval"]))
    for s in states:
        b = res["base"].get(s, {})
        i = res["interval"].get(s, {})
        print(
            f"{s:12s} {b.get('precision', 0):7.4f} "
            f"{b.get('recall', 0):7.4f} {b.get('f1', 0):7.4f}   "
            f"{i.get('precision', 0):7.4f} {i.get('recall', 0):7.4f} "
            f"{i.get('f1', 0):7.4f}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
