"""tehmm-benchmark on the port: end-to-end experiment harness
(reference: teHmmBenchmark.py; SURVEY.md §2b, §3.3 — for each
configuration: train -> eval -> (fit state names) -> compare vs truth,
aggregated into an accuracy table).

Counterpart of ``tehmm_tpu/cli/benchmark.py``.  Every train and eval
runs on ``--device`` (``cuda`` unless ``--device cpu`` is given), and
so does every ``--numProcesses`` worker: the device is an argument of
``run_config``, not an environment the workers inherit.

Configs are supplied as repeated --config "name:FLAGS" entries, e.g.

  python -m tehmm_tpu_torch.cli.benchmark tracks.xml truth.bed \\
      regions.bed out/ [--device cuda|cpu] \\
      --config "sup:--supervised" \\
      --config "em2:--numStates 2 --iter 30" \\
      --config "em4:--numStates 4 --iter 30 --reps 2"

Each config's model, prediction BED, renamed BED, and accuracy JSON land
in out/<name>.*; a summary table is printed and saved to out/summary.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time

from tehmm_tpu_torch.cli import compare_bed_states as cbs
from tehmm_tpu_torch.cli import eval as cli_eval
from tehmm_tpu_torch.cli import fit_state_names as fsn
from tehmm_tpu_torch.cli import train as cli_train
from tehmm_tpu_torch.utils.common import add_logging_options, logger, \
    set_logging_from_options
from tehmm_tpu_torch.utils.device import resolve_device


def run_config(
    name: str,
    flags: list[str],
    tracks_xml: str,
    truth_bed: str,
    regions_bed: str,
    out_dir: str,
    slack: int = 0,
    device: str = "cuda",
) -> dict:
    model_path = os.path.join(out_dir, f"{name}.mod.npz")
    pred_bed = os.path.join(out_dir, f"{name}.pred.bed")
    fit_bed = os.path.join(out_dir, f"{name}.fit.bed")

    t0 = time.time()
    rc = cli_train.main(
        [tracks_xml, truth_bed, model_path] + flags
        + ["--device", device]
    )
    train_s = time.time() - t0
    if rc:
        return {"name": name, "error": f"train rc={rc}"}

    t0 = time.time()
    rc = cli_eval.main(
        [tracks_xml, model_path, regions_bed, "--bed", pred_bed,
         "--device", device]
    )
    eval_s = time.time() - t0
    if rc:
        return {"name": name, "error": f"eval rc={rc}"}

    supervised = "--supervised" in flags
    scored_bed = pred_bed
    if not supervised:
        # anonymous states: greedily rename against truth first
        fsn.main([truth_bed, pred_bed, fit_bed])
        scored_bed = fit_bed

    res = cbs.compare_bed_files(truth_bed, scored_bed, slack=slack)
    return {
        "name": name,
        "flags": " ".join(flags),
        "train_seconds": round(train_s, 2),
        "eval_seconds": round(eval_s, 2),
        "base_accuracy": res["base_accuracy"],
        "base": res["base"],
        "interval": res["interval"],
    }


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tehmm-benchmark (torch)",
        description="train -> eval -> compare sweep over configurations",
    )
    p.add_argument("tracksInfo")
    p.add_argument("truthBed", help="labeled truth BED (training + scoring)")
    p.add_argument("regionsBed", help="regions to decode")
    p.add_argument("outDir")
    p.add_argument("--config", action="append", required=True,
                   help='"name:train flags", repeatable')
    p.add_argument("--slack", type=int, default=0)
    p.add_argument("--numProcesses", type=int, default=1,
                   help="run configs concurrently in worker processes "
                        "(reference: teHmmBenchmark parallel configs "
                        "[R?]).  On a one-GPU host the workers CONTEND "
                        "for the card — use --device cpu for truly "
                        "parallel CPU sweeps, or 1 (default) to keep "
                        "each config's device timings clean")
    p.add_argument("--device", default="cuda",
                   help="torch device of every train and eval: cuda "
                        "(default) or cpu")
    add_logging_options(p)
    return p


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    set_logging_from_options(opts)
    resolve_device(opts.device)
    os.makedirs(opts.outDir, exist_ok=True)
    jobs = []
    seen = set()
    for spec in opts.config:
        name, _, flag_str = spec.partition(":")
        if name in seen:
            # duplicates silently collide: both write out/<name>.* and
            # the results table reports one config's numbers twice
            raise SystemExit(f"duplicate --config name {name!r}")
        seen.add(name)
        jobs.append((name, shlex.split(flag_str)))

    if opts.numProcesses > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        ctx = mp.get_context("spawn")   # fresh torch/CUDA per worker
        by_name = {}
        with cf.ProcessPoolExecutor(
            max_workers=opts.numProcesses, mp_context=ctx
        ) as ex:
            futs = {
                ex.submit(
                    run_config, name, flags, opts.tracksInfo,
                    opts.truthBed, opts.regionsBed, opts.outDir,
                    opts.slack, opts.device,
                ): name
                for name, flags in jobs
            }
            for fut in cf.as_completed(futs):
                name = futs[fut]
                try:
                    by_name[name] = fut.result()
                except Exception as e:  # noqa: BLE001 — per-config
                    by_name[name] = {"name": name, "error": str(e)}
                logger.info("benchmark config %s done", name)
        results = [by_name[name] for name, _ in jobs]
    else:
        results = []
        for name, flags in jobs:
            logger.info("benchmark config %s: %s", name, flags)
            try:
                results.append(run_config(
                    name, flags, opts.tracksInfo, opts.truthBed,
                    opts.regionsBed, opts.outDir, opts.slack, opts.device,
                ))
            except Exception as e:  # noqa: BLE001 — per-config, like
                # the parallel path: one failing config must not
                # discard every completed result
                results.append({"name": name, "error": str(e)})

    with open(os.path.join(opts.outDir, "summary.json"), "w") as fh:
        json.dump(results, fh, indent=1)

    print(f"{'config':12s} {'base-acc':>9s} {'train-s':>8s} {'eval-s':>7s}")
    for r in results:
        if "error" in r:
            print(f"{r['name']:12s} ERROR: {r['error']}")
        else:
            print(
                f"{r['name']:12s} {r['base_accuracy']:9.4f} "
                f"{r['train_seconds']:8.2f} {r['eval_seconds']:7.2f}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
