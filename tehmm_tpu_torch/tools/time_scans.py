"""Times the scan tile's kernels alone, on ``bench_engines``' shapes.

    python -m tehmm_tpu_torch.tools.time_scans [--configs S20,S64]
        [--batch B] [--reps 5] [--device cuda|cpu]

K5 (``viterbi_values``), K6a/K6b (``forward_prob``, ``backward_prob``),
K7a/K7b (``forward_scaled``, ``backward_scaled``) and K8c
(``viterbi_pointers``) on the obs tensor of each ``bench_engines.CONFIGS``
shape (every row full length; ``--batch`` replaces the shape's rows, to
reach the tile's other row choice).  The first line names the device;
then one JSON object a shape: the shape and each kernel's median ms of
``reps`` synchronised calls.  It uses nothing but the wrappers and
``bench_engines``' inputs, so the same file times an older checkout of
the port for a comparison in one process each.  On the CPU each wrapper
runs its plain version: the lines then time nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tehmm_tpu_torch.models.emission import track_log_likelihoods
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.ops import dp
from tehmm_tpu_torch.tools import bench_engines
from tehmm_tpu_torch.utils.device import resolve_device


def median_ms(fn, device, reps):
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_config(config, batch, device, reps):
    S, T, V, B, L = bench_engines.CONFIGS[config]
    B = batch or B
    p, sym = bench_engines.make_inputs(S, T, V, B, L, device)
    obs = track_log_likelihoods(p.log_em, sym)
    del sym
    obs_p, _ = dp.scaled_obs_prob(obs)
    lens = torch.full((B,), L, dtype=torch.int32, device=device)
    ls, lt = p.log_start, p.log_trans
    calls = {
        "K5": lambda: ck.viterbi_values(ls, lt, obs, lens),
        "K6a": lambda: ck.forward_prob(ls, lt, obs_p, lens),
        "K6b": lambda: ck.backward_prob(lt, obs_p, lens),
        "K7a": lambda: ck.forward_scaled(ls, lt, obs, lens),
        "K7b": lambda: ck.backward_scaled(lt, obs, lens),
        "K8c": lambda: ck.viterbi_pointers(ls, lt, obs, lens),
    }
    row = {"config": config, "S": S, "B": B, "L": L}
    for name, fn in calls.items():
        fn()  # the first call builds and opts in to shared memory
        row[name] = median_ms(fn, device, reps)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="S20,S64,S128,S256")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(bench_engines.device_line(device), flush=True)
    for config in args.configs.split(","):
        print(json.dumps(time_config(config, args.batch, device, args.reps)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
