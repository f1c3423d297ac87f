"""track-ranking on the port: greedy forward selection of tracks by
benchmark accuracy (reference: trackRanking.py [R?]; SURVEY.md §2b, §5
"Evaluation & model selection").

Counterpart of ``tehmm_tpu/cli/track_ranking.py``: each candidate is a
``benchmark.run_config`` on ``--device`` (``cuda`` unless ``--device
cpu`` is given), in this process or in ``--numProcesses`` workers.

Starting from an empty track set, repeatedly add the track whose addition
maximizes base-level accuracy of a train->eval->compare cycle, until all
tracks are ranked.

Usage:
  python -m tehmm_tpu_torch.cli.track_ranking tracks.xml truth.bed \\
      regions.bed out/ --trainFlags "--supervised" [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shlex
import sys

from tehmm_tpu_torch.cli.benchmark import run_config
from tehmm_tpu_torch.io.trackxml import TrackList
from tehmm_tpu_torch.utils.common import add_logging_options, logger, \
    set_logging_from_options
from tehmm_tpu_torch.utils.device import resolve_device


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="track-ranking (torch)",
        description="Greedy forward selection of tracks by accuracy",
    )
    p.add_argument("tracksInfo")
    p.add_argument("truthBed")
    p.add_argument("regionsBed")
    p.add_argument("outDir")
    p.add_argument("--trainFlags", default="--supervised")
    p.add_argument("--maxTracks", type=int, default=0,
                   help="stop after ranking this many (0 = all)")
    p.add_argument("--numProcesses", type=int, default=1,
                   help="evaluate a step's candidate tracks "
                        "concurrently in worker processes (candidates "
                        "within a step are independent, like benchmark "
                        "configs).  Same single-accelerator caveat as "
                        "tehmm-benchmark --numProcesses: workers "
                        "contend for one card; use --device cpu for "
                        "truly parallel CPU sweeps")
    p.add_argument("--device", default="cuda",
                   help="torch device of every train and eval: cuda "
                        "(default) or cpu")
    add_logging_options(p)
    return p


def _cand_accuracy(cand: str, res: dict) -> float:
    """Accuracy of one candidate's run_config result.  run_config can
    fail two ways: raising (handled by the callers) or RETURNING an
    {'error': ...} dict (train/eval rc != 0) — surface the latter as a
    warning too, so the all-candidates-failed error's 'see warnings
    above' always has something to point at."""
    if "error" in res:
        logger.warning("candidate %s failed: %s", cand, res["error"])
        return -1.0
    return res.get("base_accuracy", -1.0)


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    set_logging_from_options(opts)
    resolve_device(opts.device)
    os.makedirs(opts.outDir, exist_ok=True)
    full = TrackList(opts.tracksInfo)
    remaining = [t.name for t in full]
    chosen: list[str] = []
    flags = shlex.split(opts.trainFlags)
    history = []

    limit = opts.maxTracks or len(remaining)
    step = 0
    while remaining and len(chosen) < limit:
        jobs = []
        for cand in remaining:
            subset = chosen + [cand]
            sub_xml = os.path.join(
                opts.outDir, f"rank{step}_{cand}.xml"
            )
            tl = TrackList()
            for t in full:
                if t.name in subset:
                    tl.add(dataclasses.replace(t, number=-1))
            tl.save_xml(sub_xml)
            jobs.append((cand, (
                f"rank{step}_{cand}", flags, sub_xml, opts.truthBed,
                opts.regionsBed, opts.outDir, 0, opts.device,
            )))

        accs: dict[str, float] = {}
        if opts.numProcesses > 1:
            import concurrent.futures as cf
            import multiprocessing as mp

            ctx = mp.get_context("spawn")   # fresh torch/CUDA per worker
            with cf.ProcessPoolExecutor(
                max_workers=opts.numProcesses, mp_context=ctx
            ) as ex:
                futs = {
                    ex.submit(run_config, *args): cand
                    for cand, args in jobs
                }
                for fut in cf.as_completed(futs):
                    cand = futs[fut]
                    try:
                        accs[cand] = _cand_accuracy(cand, fut.result())
                    except Exception as e:  # noqa: BLE001 — per-cand
                        logger.warning("candidate %s failed: %s", cand, e)
                        accs[cand] = -1.0
        else:
            for cand, args in jobs:
                # same per-candidate failure handling as the
                # --numProcesses>1 branch so both modes behave alike
                try:
                    accs[cand] = _cand_accuracy(cand, run_config(*args))
                except Exception as e:  # noqa: BLE001 — per-cand
                    logger.warning("candidate %s failed: %s", cand, e)
                    accs[cand] = -1.0

        # a failed candidate is recorded as -1.0 (< any real accuracy)
        # so it can never beat a successful one; if EVERY candidate in
        # the step failed there is no meaningful winner — error out
        # instead of silently ranking a failure
        if accs and max(accs.values()) < 0.0:
            raise RuntimeError(
                f"track ranking step {step}: all {len(accs)} candidates "
                "failed (see warnings above)"
            )

        best = None
        for cand in remaining:   # deterministic tie-break: track order
            acc = accs[cand]
            logger.info("step %d candidate %s: acc %.4f", step, cand, acc)
            if best is None or acc > best[0]:
                best = (acc, cand)
        acc, winner = best
        chosen.append(winner)
        remaining.remove(winner)
        history.append({"rank": len(chosen), "track": winner,
                        "base_accuracy": acc})
        print(f"rank {len(chosen)}: {winner} (accuracy {acc:.4f})")
        step += 1

    with open(os.path.join(opts.outDir, "ranking.json"), "w") as fh:
        json.dump(history, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
