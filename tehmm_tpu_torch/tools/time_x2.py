"""Times X2, the exact posteriors' backward kernel, at the shapes its main
path gives it, and the exact max-posterior decode it serves.

    python -m tehmm_tpu_torch.tools.time_x2 [--states 10] [--reps 5]
        [--device cuda|cpu]

At S states (``time_k3``'s inputs: T=5, V=9, ``bench_engines.make_inputs``'
draw, obs by ``track_log_likelihoods``, a zero x_carry; a row continues
past its chunk where it is full), one JSON line a reading after a line
naming the device:

- ``values``: ``ck.backward_chunk_values`` on 1 row and on 245 rows of
  4096 (``eval --maxPost --exact`` and ``--pd`` over 1,000,000 positions
  in chunks of 4096: one group, every chunk a row of the beta recompute)
  and on 512 rows of 4608 with ragged lengths (``chip_smoke.py``'s
  B_ROWS x L_ROWS);
- ``sweep``: the backward sweep of those 245 chunks on one row, which
  ends with them: ``ck.backward_checkpoints`` once where the checkout has
  it, else ``ck.backward_chunk_values`` chained over the chunks from the
  last, a launch each (the route before the checkpoint mode);
- at S <= 32, where the checkout has ``ck.x2_step``, the same four with
  the shared step forced (``"step": "shared (forced)"``);
- ``decode``: ``stitch.posterior_exact`` on one table of 1,000,000
  positions in chunks of 4096, with its split: obs formation
  (``stitch._span_obs``), X1's forward sweep (``ck.forward_checkpoints``)
  and recompute (``ck.forward_chunk_values``), X2's backward sweep
  (``ck.backward_checkpoints``) and beta recompute
  (``ck.backward_chunk_values``, with position 0's call) where the
  checkout has the sweep, else X2 (``ck.backward_chunk_values``, a call a
  chunk), and the rest (gamma, its copy to the host and the consumer),
  each span ended by a synchronise, with the calls of each.

Each reading is the median ms of ``reps`` synchronised calls (the decode
of min(reps, 3)), with us a step (ms over the longest row's steps).  The
file imports only the wrappers, ``stitch`` and the tools, so a copy of
it times an older checkout for a comparison in one process each (one
that has ``time_x1``).  On the CPU each wrapper runs its plain version
(minutes at these shapes): the lines then time nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.parallel import stitch
from tehmm_tpu_torch.tools import bench_engines
from tehmm_tpu_torch.tools.time_k3 import T, V, _inputs
from tehmm_tpu_torch.tools.time_scans import median_ms
from tehmm_tpu_torch.tools.time_x1 import _Split
from tehmm_tpu_torch.utils.device import resolve_device

CHUNK, N_CHUNKS = 4096, 245      # eval's --chunk; 999,999 / 4096 chunks
RAGGED_ROWS, RAGGED_L = 512, 4096 + 2 * 256
DECODE_REGION = 1_000_000


def _values(lt, obs, x_carry, lens):
    cont = lens == obs.shape[1]
    return ck.backward_chunk_values(lt, obs, x_carry, cont, lens)


def _sweep(lt, obs, x_carry, lens):
    """The x_carry entering every chunk of one long row, from its end."""
    cont = torch.zeros_like(lens, dtype=torch.bool)
    if hasattr(ck, "backward_checkpoints"):
        return ck.backward_checkpoints(lt, obs, x_carry, cont, lens, CHUNK)
    n = obs.shape[1] // CHUNK
    x, out = x_carry, [None] * n
    for c in reversed(range(n)):
        part = obs[:, c * CHUNK:(c + 1) * CHUNK]
        pl = torch.clamp(lens - c * CHUNK, 0, CHUNK).to(torch.int32)
        c_cont = cont if c == n - 1 else lens > (c + 1) * CHUNK
        _, x = ck.backward_chunk_values(lt, part, x, c_cont, pl)
        out[c] = x
    return torch.stack(out, dim=1)


def _step_name(S):
    return ck.x2_step(S) if hasattr(ck, "x2_step") else "parent"


def kernel_readings(S, device, reps, forced=False):
    shapes = [("values", 1, CHUNK, False),
              ("values", N_CHUNKS, CHUNK, False),
              ("values", RAGGED_ROWS, RAGGED_L, True),
              ("sweep", 1, N_CHUNKS * CHUNK, False)]
    step = _step_name(S)
    if forced:
        real, step = ck.x2_step, "shared (forced)"
        ck.x2_step = lambda S_: "shared"
    try:
        for mode, B, L, ragged in shapes:
            args = _inputs(S, B, L, device, ragged)
            fn = _values if mode == "values" else _sweep
            fn(*args)                 # the first call builds the kernels
            ms = median_ms(lambda: fn(*args), device, reps)
            yield {"mode": mode, "S": S, "B": B, "L": L, "ragged": ragged,
                   "step": step, "ms": ms, "us_per_step": ms * 1e3 / L}
            del args
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if forced:
            ck.x2_step = real


def decode_reading(S, device, reps):
    p, _ = bench_engines.make_inputs(S, T, V, 1, 1, device)
    rng = np.random.RandomState(2)
    table = rng.randint(1, V, size=(DECODE_REGION, T)).astype(np.uint8)
    spans = [(stitch, "_span_obs", "obs"),
             (ck, "forward_checkpoints", "forward sweep"),
             (ck, "forward_chunk_values", "recompute")]
    if hasattr(ck, "backward_checkpoints"):
        spans += [(ck, "backward_checkpoints", "backward sweep"),
                  (ck, "backward_chunk_values", "beta recompute")]
    else:
        spans += [(ck, "backward_chunk_values", "X2")]

    def decode():
        return stitch.posterior_exact(p, [table], chunk_len=CHUNK)

    decode()                          # the first call builds the kernels
    runs = []
    for _ in range(min(reps, 3)):
        split = _Split(device, spans)
        try:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            decode()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            total = time.perf_counter() - t0
        finally:
            split.restore()
        runs.append((total, split))
    total, split = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    parts = {k: v * 1e3 for k, v in split.seconds.items()}
    parts["rest"] = total * 1e3 - sum(parts.values())
    ms = total * 1e3
    return {"mode": "decode", "S": S, "B": 1, "L": DECODE_REGION,
            "step": _step_name(S), "ms": ms,
            "us_per_step": ms * 1e3 / DECODE_REGION,
            "split_ms": parts, "calls": dict(split.calls)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--states", default="10")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(bench_engines.device_line(device), flush=True)
    for S in (int(s) for s in args.states.split(",")):
        forced = hasattr(ck, "x2_step") and ck.x2_step(S) == "lanes"
        for row in kernel_readings(S, device, args.reps):
            print(json.dumps(row), flush=True)
        for row in (kernel_readings(S, device, args.reps, forced=True)
                    if forced else ()):
            print(json.dumps(row), flush=True)
        print(json.dumps(decode_reading(S, device, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
