"""Times the score's forward continuation a chunk: X1's chain against the
piece-operator scan, over a grid of states and rows.

    python -m tehmm_tpu_torch.tools.time_score [--states 10,64,128,168]
        [--rows 1,4,16,24,64,128] [--length 4096] [--reps 5]
        [--device cuda|cpu]

Each (S, rows) point draws ``bench_engines.make_inputs(S, 5, 9, rows,
length)`` with every row full length (for a chunk's shape, the most work
the pieces can have, while the chain's time is the longest row's) and a
carry normalised to max 0.  In one process it times ``ck.forward_final``
(X1 carry-only: one warp a row), the two piece kernels
(``ck.piece_operators`` then ``ck.compose_pieces``, whatever the route),
the pieces again and the chain again, each the median of ``reps``
synchronised calls.  The first line names the device; then one JSON
object a point: both times of each, the speedup (best chain over best
pieces) and the route ``ck.forward_loglik`` takes at that shape.  Once
the pieces take more than twice the chain's time at some rows, larger
row counts at that S are skipped.  On the CPU each wrapper runs its
plain version: the lines then time nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tehmm_tpu_torch.models.emission import track_log_likelihoods
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.tools import bench_engines
from tehmm_tpu_torch.tools.time_scans import median_ms
from tehmm_tpu_torch.utils.device import resolve_device

T, V = 5, 9                      # tracks, symbols (the decode model's)


def pieces(lt, obs, init, lens):
    """The piece-operator scan's two kernels on every row at once."""
    carry, incs = ck.compose_pieces(*ck.piece_operators(lt, obs, lens),
                                    init, lens)
    return carry, incs.sum(dim=1).to(torch.float32)


def time_point(S, rows, length, device, reps):
    p, sym = bench_engines.make_inputs(S, T, V, rows, length, device)
    obs = track_log_likelihoods(p.log_em, sym)
    del sym
    init = torch.log_softmax(p.log_start, dim=0).expand(rows, S)
    init = (init - init.amax(dim=-1, keepdim=True)).contiguous()
    lens = torch.full((rows,), length, dtype=torch.int32, device=device)
    lt = p.log_trans
    calls = {"chain": ck.forward_final, "pieces": pieces}
    times = {"chain": [], "pieces": []}
    for fn in calls.values():
        fn(lt, obs, init, lens)  # the first call builds the kernels
    for name in ("chain", "pieces", "pieces", "chain"):
        times[name].append(median_ms(
            lambda: calls[name](lt, obs, init, lens), device, reps))
    return {"S": S, "rows": rows, "L": length,
            "chain_ms": times["chain"], "pieces_ms": times["pieces"],
            "speedup": min(times["chain"]) / min(times["pieces"]),
            "route": "pieces" if ck.piece_scan_route(rows, S) else "chain"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--states", default="10,64,128,168")
    ap.add_argument("--rows", default="1,4,16,24,64,128")
    ap.add_argument("--length", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(bench_engines.device_line(device), flush=True)
    for S in (int(s) for s in args.states.split(",")):
        for rows in (int(b) for b in args.rows.split(",")):
            row = time_point(S, rows, args.length, device, args.reps)
            print(json.dumps(row), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
            if row["speedup"] < 0.5:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
