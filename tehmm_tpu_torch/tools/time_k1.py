"""Times K1, the fused E-step's two kernels, and K4's decode (whose
forward is K1's) at the shapes their main paths give them.

    python -m tehmm_tpu_torch.tools.time_k1 [--states 10,20,32] [--reps 5]
        [--device cuda|cpu]

At S states (T=5 tracks; ``bench_engines.make_inputs``' draw), one JSON
line a kernel (``em_fwd``, then ``em_bwd_stats`` on that forward's
alpha_p and m_raw, or ``post_decode`` on its alpha_p) and shape, after a
line naming the device:

- ``em``: ``chip_smoke.py`` 3b's EM, the 20,000,000-position chromosome
  in chunks of 16384 (V=9): 1221 rows, the last 11,520 long, at every S;
- ``bench``: ``bench.py``'s E-step (V=8, 2048 full rows of 1024), at
  S=20;
- ``segments``: 3e's segment-mode EM (V=9, the 355,789 segments in 22
  rows of 16384, the last 11,725 long) with its weights (in [1, 64]), at
  S=10;
- ``decode64`` and ``decode512``: the stitched max-posterior decode's
  passes (V=9, chunks of 4096 with two halos of 256: full rows of 4608),
  64 rows (the pass before 512) and 512, at every S: ``em_fwd`` and
  ``post_decode`` (``"step"`` names the decode's, ``ck.k4_step``);
- at S <= 32, where the checkout has ``ck.k1_step``, the same with the
  shared kernels forced (``"step": "shared (forced)"``: K1's and K4's).

Each reading is the median ms of ``reps`` synchronised calls, with us a
step (ms over the longest row's steps).  The file imports only the
wrappers and the tools, so a copy of it times an older checkout for a
comparison in one process each (``"step": "parent"``).  On the CPU each
wrapper runs its plain version: the lines then time nothing of the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.tools import bench_engines
from tehmm_tpu_torch.tools.time_scans import median_ms
from tehmm_tpu_torch.utils.device import resolve_device

T = 5
# name: (rows, row length, the last row's length); V and S by shape
SHAPES = {"em": (1221, 16384, 20_000_000 - 1220 * 16384),
          "bench": (2048, 1024, 1024),
          "segments": (22, 16384, 355_789 - 21 * 16384),
          "decode64": (64, 4608, 4608),
          "decode512": (512, 4608, 4608)}
SHAPE_V = {"em": 9, "bench": 8, "segments": 9, "decode64": 9,
           "decode512": 9}
SHAPE_S = {"bench": 20, "segments": 10}      # only at these S
# the kernels timed at a shape: K1's two, or K4's forward and decode
DECODE_SHAPES = ("decode64", "decode512")


def _inputs(shape, S, device):
    B, L, last = SHAPES[shape]
    V = SHAPE_V[shape]
    p, sym = bench_engines.make_inputs(S, T, V, B, L, device)
    lengths = np.full(B, L, np.int32)
    lengths[-1] = last
    lens = torch.from_numpy(lengths).to(device)
    w = None
    if shape == "segments":
        w = torch.from_numpy(np.random.RandomState(1).uniform(
            1.0, 64.0, size=(B, L)).astype(np.float32)).to(device)
    return (p.log_start, p.log_trans, p.log_em, sym, lens), w


@contextlib.contextmanager
def shared_k1():
    """K1's shared kernels forced inside (``K1_LANES_MAX_STATES`` = 0),
    as the card's tests force them."""
    real, ck.K1_LANES_MAX_STATES = ck.K1_LANES_MAX_STATES, 0
    try:
        yield
    finally:
        ck.K1_LANES_MAX_STATES = real


@contextlib.contextmanager
def shared_k4():
    """K4's shared decode forced inside (``K4_LANES_MAX_STATES`` = 0;
    nothing to force in a checkout without it)."""
    if not hasattr(ck, "K4_LANES_MAX_STATES"):
        yield
        return
    real, ck.K4_LANES_MAX_STATES = ck.K4_LANES_MAX_STATES, 0
    try:
        yield
    finally:
        ck.K4_LANES_MAX_STATES = real


def _step(S, shape):
    """The step K1 (K4's decode at the decode shapes) takes at S states
    and the shape's V ("parent" in a checkout without ``ck.k1_step`` or
    ``ck.k4_step``)."""
    name = "k4_step" if shape in DECODE_SHAPES else "k1_step"
    step = getattr(ck, name, None)
    return step(S, T, SHAPE_V[shape]) if step else "parent"


def readings(S, device, reps, forced=False):
    with (shared_k1() if forced else contextlib.nullcontext()), \
            (shared_k4() if forced else contextlib.nullcontext()):
        for shape in SHAPES:
            if SHAPE_S.get(shape, S) != S:
                continue
            step = "shared (forced)" if forced else _step(S, shape)
            args, w = _inputs(shape, S, device)
            B, L, _ = SHAPES[shape]

            def fwd():
                return ck.em_fwd(*args, obs_weights=w)

            alpha, _dm, m_raw = fwd()      # the first call builds
            if shape in DECODE_SHAPES:
                dec_args = (*args[1:], alpha)

                def second():
                    return ck.post_decode(*dec_args)

                kernels = (("em_fwd", fwd), ("post_decode", second))
            else:
                bwd_args = (*args[1:], alpha, m_raw)

                def second():
                    return ck.em_bwd_stats(*bwd_args, obs_weights=w)

                kernels = (("em_fwd", fwd), ("em_bwd_stats", second))
            second()
            for kernel, fn in kernels:
                ms = median_ms(fn, device, reps)
                yield {"kernel": kernel, "shape": shape, "S": S, "B": B,
                       "L": L, "T": T, "V": SHAPE_V[shape],
                       "stream": "" if w is None else "+w", "step": step,
                       "ms": ms, "us_per_step": ms * 1e3 / L}
            del args, w, alpha, m_raw, kernels, second
            if device.type == "cuda":
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--states", default="10,20,32")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(bench_engines.device_line(device), flush=True)
    for S in (int(s) for s in args.states.split(",")):
        forced = any(_step(S, shape) == "lanes"
                     for shape in SHAPES if SHAPE_S.get(shape, S) == S)
        for row in readings(S, device, args.reps):
            print(json.dumps(row), flush=True)
        for row in (readings(S, device, args.reps, forced=True)
                    if forced else ()):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
