"""Times K1, the fused E-step's two kernels, K4's decode (whose
forward is K1's) and K2, the stitched Viterbi decode, at the shapes their
main paths give them.

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
- ``decode64`` and ``decode512``: the stitched decodes' passes (V=9,
  chunks of 4096 with two halos of 256: full rows of 4608), 64 rows (the
  max-posterior pass before 512) and 512, at every S: ``em_fwd`` and
  ``post_decode`` (``"step"`` names the decode's, ``ck.k4_step``), then
  K2 (``"step"``: ``ck.k2_step``): ``viterbi_fwd`` (value rows),
  ``viterbi_fwd_pointers`` (its pointer mode) and ``chunk_chase`` over
  those pointers from the last row's argmax, ``viterbi_backtrace`` over
  the value rows from the same end states, and ``viterbi_fused`` whole
  (the pointer mode and the chase; in a checkout without the pointer
  mode, the value rows and the backtrace, and no pointer rows);
- at S <= 32, where the checkout has ``ck.k1_step``, the same with the
  shared kernels forced (``"step": "shared (forced)"``: K1's, K4's and
  K2's).

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
# the kernels timed at a shape: K1's two, or K4's forward and decode and
# K2's
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
def _forced(name):
    """``ck.<name>`` set to 0 inside, which forces that kernel's shared
    step (nothing to force in a checkout without it)."""
    if not hasattr(ck, name):
        yield
        return
    real = getattr(ck, name)
    setattr(ck, name, 0)
    try:
        yield
    finally:
        setattr(ck, name, real)


def shared_k1():
    """K1's shared kernels forced inside (``K1_LANES_MAX_STATES`` = 0),
    as the card's tests force them."""
    return _forced("K1_LANES_MAX_STATES")


def shared_k4():
    """K4's shared decode forced inside (``K4_LANES_MAX_STATES`` = 0)."""
    return _forced("K4_LANES_MAX_STATES")


def shared_k2():
    """K2's shared forward forced inside (``K2_LANES_MAX_STATES`` = 0)."""
    return _forced("K2_LANES_MAX_STATES")


def _step(S, shape, name=None):
    """The step K1 (K4's decode at the decode shapes; ``name`` another
    ``ck`` step function) takes at S states and the shape's V ("parent"
    in a checkout without it)."""
    name = name or ("k4_step" if shape in DECODE_SHAPES else "k1_step")
    step = getattr(ck, name, None)
    return step(S, T, SHAPE_V[shape]) if step else "parent"


def _k2_kernels(args):
    """K2's (name, call) at one pass's inputs: the forward in both modes,
    the chase and the value-row backtrace from the same end states, and
    the fused decode (without the pointer mode, the checkout's older
    route: no pointer rows)."""
    v, _dm = ck.viterbi_fwd(*args)
    end = torch.argmax(v[:, -1], dim=-1).to(torch.int32)
    lens = args[4]
    body = (args[1], v[:, 1:], v[:, 0], end,
            torch.clamp(lens - 1, min=0).to(torch.int32))
    kernels = [("viterbi_fwd", lambda: ck.viterbi_fwd(*args))]
    if hasattr(ck, "viterbi_fwd_pointers"):
        ptrs = ck.viterbi_fwd_pointers(*args)[0]
        kernels += [
            ("viterbi_fwd_pointers", lambda: ck.viterbi_fwd_pointers(*args)),
            ("chunk_chase", lambda: ck.chunk_chase(ptrs, end, lens))]
    kernels += [("viterbi_backtrace", lambda: ck.viterbi_backtrace(*body)),
                ("viterbi_fused", lambda: ck.viterbi_fused(*args))]
    return kernels


def readings(S, device, reps, forced=False):
    with (shared_k1() if forced else contextlib.nullcontext()), \
            (shared_k4() if forced else contextlib.nullcontext()), \
            (shared_k2() if forced else contextlib.nullcontext()):
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

                kernels = [("em_fwd", fwd), ("post_decode", second)]
                k2_step = "shared (forced)" if forced else \
                    _step(S, shape, "k2_step")
                kernels += [(name, fn, k2_step)
                            for name, fn in _k2_kernels(args)]
            else:
                bwd_args = (*args[1:], alpha, m_raw)

                def second():
                    return ck.em_bwd_stats(*bwd_args, obs_weights=w)

                kernels = (("em_fwd", fwd), ("em_bwd_stats", second))
            second()
            for kernel, fn, *its_step in kernels:
                ms = median_ms(fn, device, reps)
                yield {"kernel": kernel, "shape": shape, "S": S, "B": B,
                       "L": L, "T": T, "V": SHAPE_V[shape],
                       "stream": "" if w is None else "+w",
                       "step": its_step[0] if its_step else step,
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
                     for shape in SHAPES if SHAPE_S.get(shape, S) == S) \
            or _step(S, DECODE_SHAPES[0], "k2_step") == "lanes"
        for row in readings(S, device, args.reps):
            print(json.dumps(row), flush=True)
        for row in (readings(S, device, args.reps, forced=True)
                    if forced else ()):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
