"""The max-plus sweep experiment (K9): two layouts of a max-plus step
whose transition matrix does not fit in a block's fast memory.

    python -m tehmm_tpu_torch.tools.exp_maxplus_s256 [--device cuda|cpu]
        [--sp 256] [--bg 128] [--reps 20]

Counterpart of ``tools/exp_maxplus_s256.py``: 64 sweeps of
``best[j, b] = max_i(v[i, b] + T[i, j])``, each less its column max, on
v f32[Sp, Bg] and T f32[Sp, Sp] drawn from ``np.random.RandomState(0)``
as the JAX tool draws them (v, then T, standard normal), at its Sp=256,
Bg=128 by default.  Formulations, in the JAX tool's order: A
(``layout="resident"``: every row of T read in place; the TPU's
"unrolled"), then B (``layout="blocks"``: T staged through shared memory
in row blocks) at blk = 8, 16, 32.  One line per formulation: ok or the
error, ms per 64-sweep call (median of ``reps`` synchronised calls) and
max|delta| against the plain sweep (``cuda_kernels.
maxplus_sweeps_plain``), which is 0 when the kernel is right: every
operation is an exact max or one rounded add or subtract.  The first
line names the device.  On the CPU each formulation runs the plain
version: the lines then check the plumbing and time nothing of the card.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.tools.bench_engines import device_line
from tehmm_tpu_torch.utils.device import resolve_device

FORMULATIONS = (("A resident", "resident", None),
                ("B blocks blk=8", "blocks", 8),
                ("B blocks blk=16", "blocks", 16),
                ("B blocks blk=32", "blocks", 32))


def make_inputs(Sp, Bg, device):
    """(v, T) as the JAX tool draws them, from seed 0."""
    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.randn(Sp, Bg).astype(np.float32)).to(device)
    t = torch.from_numpy(rng.randn(Sp, Sp).astype(np.float32)).to(device)
    return v, t


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


def run(name, layout, blk, v, t, ref, device, reps):
    """One formulation's line: (line, ms or None, max|delta| or None)."""
    try:
        out = ck.maxplus_sweeps(v, t, layout, blk)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except (RuntimeError, NotImplementedError, ValueError) as e:
        msg = str(e).split("\n")[0][:160]
        return f"{name:20s} FAIL: {msg}", None, None
    err = float((out - ref).abs().max())
    ms = median_ms(lambda: ck.maxplus_sweeps(v, t, layout, blk), device,
                   reps)
    return (f"{name:20s} ok   {ms:9.3f} ms/{ck.MAXPLUS_SWEEPS}-sweep   "
            f"max|delta| {err:.2e}"), ms, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sp", type=int, default=256)
    ap.add_argument("--bg", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    v, t = make_inputs(args.sp, args.bg, device)
    ref = ck.maxplus_sweeps_plain(v, t)
    print(f"# Sp={args.sp} Bg={args.bg} seed=0: "
          f"{ck.MAXPLUS_SWEEPS} sweeps a call", flush=True)
    for name, layout, blk in FORMULATIONS:
        line, _ms, _err = run(name, layout, blk, v, t, ref, device,
                              args.reps)
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
