"""Times K3, the exact Viterbi's kernel, and X3, its backtrace, at the
shapes their main path gives them.

    python -m tehmm_tpu_torch.tools.time_k3 [--states 10] [--reps 5]
        [--device cuda|cpu]

At S states (T=5, V=9; ``bench_engines.make_inputs``' draw, obs by
``track_log_likelihoods``, a zero carry), one JSON line a reading after
a line naming the device:

- on 1 row and on 245 rows of 4096 (eval's ``--exact`` over 1,000,000
  positions in chunks of 4096: one group, every chunk a row) and on 512
  rows of 4608 with ragged lengths (``chip_smoke.py``'s B_ROWS x
  L_ROWS): ``recompute``, ``ck.viterbi_chunk_values``; where the
  checkout has them, ``pointers`` (``ck.viterbi_chunk_pointers``),
  ``map`` (``ck.chunk_entry_map`` of those pointers), ``compose``
  (``ck.chunk_compose`` of the maps as one table's chunks) and ``chase``
  (``ck.chunk_chase``);
- ``sweep``: the forward sweep of those 245 chunks on one row (999,999
  positions valid):
  ``ck.viterbi_checkpoints`` once where the checkout has it, else
  ``ck.viterbi_carry`` chained over the chunks, a launch each (the
  route before the checkpoint mode);
- ``backtrace``: the exact decode's backtrace of that row's 245 chunks
  (999,999 positions, the last chunk 583 long) from the sweep's carries,
  both routes in this process: ``route`` ``values``
  (``stitch._backtrace_group``: the value rows, then
  ``ck.viterbi_backtrace`` a chunk) and ``pointers``
  (``stitch._chase_group``: pointers, map, compose, chase), their paths
  held equal.

Each reading is the median ms of ``reps`` synchronised calls, with us a
step (ms over the longest row's steps).  The file imports only the
wrappers, ``stitch`` and ``bench_engines``, so a copy of it times an
older checkout for a comparison in one process each.  On the CPU each
wrapper runs its plain version (minutes at these shapes): the lines then
time nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tehmm_tpu_torch.models.emission import track_log_likelihoods
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.parallel import stitch
from tehmm_tpu_torch.tools import bench_engines
from tehmm_tpu_torch.tools.time_scans import median_ms
from tehmm_tpu_torch.utils.device import resolve_device

T, V = 5, 9                      # tracks, symbols (the decode model's)
CHUNK, N_CHUNKS = 4096, 245      # eval's --chunk; 999,999 / 4096 chunks
BODY = 999_999                   # the --exact region's body positions
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


def _calls(args):
    """The readings of one shape: K3's values mode, and where the checkout
    has them its pointer mode and X3's three launches."""
    calls = {"recompute": lambda: ck.viterbi_chunk_values(*args)}
    if not hasattr(ck, "viterbi_chunk_pointers"):
        return calls
    lt, obs, init, lens = args
    B, S = init.shape
    ptrs = ck.viterbi_chunk_pointers(*args)
    maps = ck.chunk_entry_map(ptrs, lens).view(1, B, S)
    ends = (torch.arange(B, device=lens.device) % S).to(torch.int32)
    calls.update(
        pointers=lambda: ck.viterbi_chunk_pointers(*args),
        map=lambda: ck.chunk_entry_map(ptrs, lens),
        compose=lambda: ck.chunk_compose(maps, ends[:1]),
        chase=lambda: ck.chunk_chase(ptrs, ends, lens))
    return calls


def _backtraces(S, device, reps, lt, obs, init, ckpts):
    """The exact decode's backtrace of one row's chunks by both routes."""
    n = obs.shape[1] // CHUNK
    last = min(CHUNK, max(1, BODY - (n - 1) * CHUNK))
    chunk_lens = np.full((1, n), CHUNK, np.int64)
    chunk_lens[0, -1] = last
    entries = torch.cat([init, ckpts[0, :-1]]).contiguous()
    rows = obs.view(n, CHUNK, S)
    end = torch.argmax(ckpts[:, -1], dim=-1).to(torch.int32)
    paths = {}
    for route, fn in (("values", stitch._backtrace_group),
                      ("pointers", stitch._chase_group)):
        def call():
            return fn(lt, rows, entries, chunk_lens, end, device)
        paths[route] = call()[0]
        ms = median_ms(call, device, reps)
        yield {"mode": "backtrace", "route": route, "S": S, "B": 1,
               "n": n, "L": n * CHUNK, "ragged": True,
               "step": ck.k3_step(S), "ms": ms,
               "us_per_step": ms * 1e3 / (n * CHUNK)}
    assert torch.equal(paths["values"], paths["pointers"]), \
        "the two backtrace routes give different paths"


def readings(S, device, reps):
    step = ck.k3_step(S) if hasattr(ck, "k3_step") else "parent"
    for B, L, ragged in ((1, CHUNK, False), (N_CHUNKS, CHUNK, False),
                         (RAGGED_ROWS, RAGGED_L, True)):
        args = _inputs(S, B, L, device, ragged)
        for mode, fn in _calls(args).items():
            fn()                      # the first call builds the kernels
            ms = median_ms(fn, device, reps)
            yield {"mode": mode, "S": S, "B": B, "L": L, "ragged": ragged,
                   "step": step, "ms": ms, "us_per_step": ms * 1e3 / L}
        del args
        if device.type == "cuda":
            torch.cuda.empty_cache()
    L = N_CHUNKS * CHUNK
    args = _inputs(S, 1, L, device)
    args[3].fill_(min(BODY, L))
    ckpts = _sweep(*args)
    ms = median_ms(lambda: _sweep(*args), device, reps)
    yield {"mode": "sweep", "S": S, "B": 1, "L": L, "ragged": False,
           "step": step, "ms": ms, "us_per_step": ms * 1e3 / L}
    if hasattr(stitch, "_chase_group"):
        lt, obs, init, _ = args
        yield from _backtraces(S, device, reps, lt, obs, init, ckpts)


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
