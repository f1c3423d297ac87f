"""Times K3, the exact Viterbi's kernel, at the shapes its main path gives
it.

    python -m tehmm_tpu_torch.tools.time_k3 [--states 10] [--reps 5]
        [--device cuda|cpu]

At S states (T=5, V=9; ``bench_engines.make_inputs``' draw, obs by
``track_log_likelihoods``, a zero carry), one JSON line a reading after
a line naming the device:

- ``recompute``: ``ck.viterbi_chunk_values`` on 1 row and on 245 rows of
  4096 (eval's ``--exact`` over 1,000,000 positions in chunks of 4096:
  one group, every chunk a row) and on 512 rows of 4608 with ragged
  lengths (``chip_smoke.py``'s B_ROWS x L_ROWS);
- ``sweep``: the forward sweep of those 245 chunks on one row:
  ``ck.viterbi_checkpoints`` once where the checkout has it, else
  ``ck.viterbi_carry`` chained over the chunks, a launch each (the
  route before the checkpoint mode).

Each reading is the median ms of ``reps`` synchronised calls, with us a
step (ms over the longest row's steps).  The file imports only the
wrappers and ``bench_engines``, so a copy of it times an older checkout
for a comparison in one process each.  On the CPU each wrapper runs its
plain version (minutes at these shapes): the lines then time nothing of
the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tehmm_tpu_torch.models.emission import track_log_likelihoods
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.tools import bench_engines
from tehmm_tpu_torch.tools.time_scans import median_ms
from tehmm_tpu_torch.utils.device import resolve_device

T, V = 5, 9                      # tracks, symbols (the decode model's)
CHUNK, N_CHUNKS = 4096, 245      # eval's --chunk; 999,999 / 4096 chunks
RAGGED_ROWS, RAGGED_L = 512, 4096 + 2 * 256


def _inputs(S, B, L, device, ragged=False):
    p, sym = bench_engines.make_inputs(S, T, V, B, L, device)
    obs = track_log_likelihoods(p.log_em, sym)
    del sym
    lengths = np.full(B, L, np.int32)
    if ragged:
        lengths = np.random.RandomState(1).randint(0, L + 1, size=B)
        lengths[:4] = [L, 0, 1, 2]
    lens = torch.from_numpy(lengths.astype(np.int32)).to(device)
    init = torch.zeros((B, S), dtype=torch.float32, device=device)
    return p.log_trans, obs, init, lens


def _sweep(lt, obs, init, lens):
    """The carry leaving every chunk of one long row."""
    if hasattr(ck, "viterbi_checkpoints"):
        return ck.viterbi_checkpoints(lt, obs, init, lens, CHUNK)
    carry, out = init, []
    for c in range(obs.shape[1] // CHUNK):
        part = obs[:, c * CHUNK:(c + 1) * CHUNK]
        pl = torch.clamp(lens - c * CHUNK, 0, CHUNK).to(torch.int32)
        carry = ck.viterbi_carry(lt, part, carry, pl)
        out.append(carry)
    return torch.stack(out, dim=1)


def readings(S, device, reps):
    shapes = [("recompute", 1, CHUNK, False),
              ("recompute", N_CHUNKS, CHUNK, False),
              ("recompute", RAGGED_ROWS, RAGGED_L, True),
              ("sweep", 1, N_CHUNKS * CHUNK, False)]
    for mode, B, L, ragged in shapes:
        args = _inputs(S, B, L, device, ragged)
        fn = ck.viterbi_chunk_values if mode == "recompute" else _sweep
        fn(*args)                     # the first call builds the kernels
        ms = median_ms(lambda: fn(*args), device, reps)
        yield {"mode": mode, "S": S, "B": B, "L": L, "ragged": ragged,
               "step": ck.k3_step(S) if hasattr(ck, "k3_step") else "parent",
               "ms": ms, "us_per_step": ms * 1e3 / L}
        del args
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--states", default="10")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(bench_engines.device_line(device), flush=True)
    for S in (int(s) for s in args.states.split(",")):
        for row in readings(S, device, args.reps):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
