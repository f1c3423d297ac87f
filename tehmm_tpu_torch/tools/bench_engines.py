"""E-step and decode engines side by side, with a parity check.

    python -m tehmm_tpu_torch.tools.bench_engines [--configs S20,S64,...]
        [--engines plain,cuda,cuda_v3,cuda_log] [--iters N]
        [--decode | --maxpost]
        [--device cuda|cpu] [--seed N]

Counterpart of ``tools/bench_engines.py``: the same configurations and the
same inputs (``make_inputs`` draws the tables and the symbols from
``np.random.RandomState(seed)`` in the same order, so a row of either
package is computed on the same data), timed with
``utils.profiling.marginal_time``.  Engines:

* E-step (default): ``plain`` (log-space torch scans), ``cuda`` (K1, the
  fused E-step), ``cuda_v3`` (K6, the probability-space scans over a
  precomputed obs tensor), ``cuda_log`` (K7a/K7b, the log-space scans
  over obs);
* ``--decode``: ``plain`` (``dp.viterbi`` on the obs tensor),
  ``streaming`` (K5, ``dp.viterbi_streaming``), ``fused`` (K2, symbols
  in), ``pointers`` (K8c and the pointer chase,
  ``dp.viterbi_backpointers``);
* ``--maxpost``: ``plain`` (the log-space posteriors' argmax), ``fused``
  (K4), ``scans`` (the same posteriors through K7a/K7b: the stitched
  decoder's route past K4's envelope).

The first line names the device (on a card: its name and power limit as
``nvidia-smi`` gives them).  Then one JSON line per (configuration,
engine) with ``estep_ms`` (``decode_ms`` for the decoders),
``positions_per_s``, ``cellupdates_per_s`` (positions x S^2) and
``loglik`` (for the decoders the path sum, with ``path_agreement``: the
share of positions equal to the first engine's path), and per
configuration the largest relative loglik difference between two
engines.  An engine whose kernel does not take a configuration (its
wrapper raises ``NotImplementedError`` naming what it is missing) gives
a row with ``"error"`` instead of numbers, and the run goes on.  On the
CPU every engine runs its plain version: the rows then check the
plumbing and time nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from tehmm_tpu_torch.models.emission import track_log_likelihoods
from tehmm_tpu_torch.models.params import from_numpy
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.ops import dp
from tehmm_tpu_torch.ops import em as em_ops
from tehmm_tpu_torch.utils.device import resolve_device
from tehmm_tpu_torch.utils.profiling import marginal_time

CONFIGS = {
    # name: (S, T, V, B, L)
    "S20": (20, 5, 8, 2048, 1024),
    "S64": (64, 10, 12, 1024, 1024),
    "S128": (128, 15, 16, 512, 1024),
    "S256": (256, 20, 16, 256, 1024),
    # past the JAX tool's set, not run by default: the scan tile past 256
    # states, half the rows at each doubling of S beyond S256
    "S512": (512, 20, 16, 128, 1024),
    "S1024": (1024, 20, 16, 64, 1024),
}
ESTEP_ENGINES = ("plain", "cuda", "cuda_v3", "cuda_log")
DECODE_ENGINES = ("plain", "streaming", "fused", "pointers")
MAXPOST_ENGINES = ("plain", "fused", "scans")


def make_inputs(S, T, V, B, L, device, seed=0):
    """(params, int32 symbols [B, L, T]) on ``device``: dirichlet start,
    transition and emission rows and uniform symbols in [1, V)."""
    rng = np.random.RandomState(seed)
    start = rng.dirichlet(np.ones(S))
    trans = rng.dirichlet(np.ones(S), size=S)
    log_em = np.zeros((S, T, V), np.float32)
    for t in range(T):
        p = rng.dirichlet(np.ones(V - 1), size=S)
        log_em[:, t, 1:] = np.log(p)
    params = from_numpy(np.log(start), np.log(trans), log_em, device)
    symbols = torch.from_numpy(
        rng.randint(1, V, size=(B, L, T)).astype(np.int32)).to(device)
    return params, symbols


def device_line(device: torch.device) -> str:
    """What the first line says of the device."""
    if device.type != "cuda":
        return f"# device: {device}"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return f"# device: {smi[device.index or 0]}"


def _drain(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_estep(params, symbols, engine, iters):
    """(seconds per E-step, loglik) of one engine."""
    def run():
        return em_ops.em_sufficient_stats(params, symbols, engine=engine)

    def sync(stats):
        _drain(symbols.device)
        return float(stats.loglik)

    loglik = sync(run())
    return marginal_time(run, sync, iters), loglik


def time_decode(params, symbols, engine, iters):
    """(seconds per Viterbi decode, path) of one engine; the obs tensor
    is part of the timed work of the engines that need one."""
    if engine == "fused":
        lengths = torch.full((symbols.shape[0],), symbols.shape[1],
                             dtype=torch.int32, device=symbols.device)

        def run():
            return ck.viterbi_fused(params.log_start, params.log_trans,
                                    params.log_em, symbols, lengths)
    elif engine in ("plain", "streaming", "pointers"):
        fn = {"plain": dp.viterbi, "streaming": dp.viterbi_streaming,
              "pointers": dp.viterbi_backpointers}[engine]

        def run():
            obs = track_log_likelihoods(params.log_em, symbols)
            return fn(params.log_start, params.log_trans, obs)
    else:
        raise ValueError(f"unknown decode engine {engine!r}: choose one "
                         f"of {DECODE_ENGINES}")

    def sync(out):
        _drain(symbols.device)
        return float(out[1].sum())

    path, _score = run()
    return marginal_time(run, sync, iters), path


def time_maxpost(params, symbols, engine, iters):
    """(seconds per max-posterior decode, path) of one engine."""
    if engine == "fused":
        lengths = torch.full((symbols.shape[0],), symbols.shape[1],
                             dtype=torch.int32, device=symbols.device)

        def run():
            return ck.posterior_decode_fused(
                params.log_start, params.log_trans, params.log_em, symbols,
                lengths)
    elif engine in ("plain", "scans"):
        lengths = torch.full((symbols.shape[0],), symbols.shape[1],
                             dtype=torch.int32, device=symbols.device)
        fwd, bwd = ((dp.forward_scaled, dp.backward_scaled)
                    if engine == "plain"
                    else (ck.forward_scaled, ck.backward_scaled))

        def run():
            obs = track_log_likelihoods(params.log_em, symbols)
            ah, _, _ = fwd(params.log_start, params.log_trans, obs, lengths)
            bh, _ = bwd(params.log_trans, obs, lengths)
            return torch.argmax(dp.posterior_scaled(ah, bh), dim=-1) \
                .to(torch.int32)
    else:
        raise ValueError(f"unknown max-posterior engine {engine!r}: choose "
                         f"one of {MAXPOST_ENGINES}")

    def sync(path):
        _drain(symbols.device)
        return int(path[0, 0])

    path = run()
    return marginal_time(run, sync, iters), path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="S20,S64,S128,S256")
    ap.add_argument("--engines", default=None,
                    help="comma-separated; default: every engine of the "
                         "mode")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--decode", action="store_true",
                    help="time the Viterbi decode (obs, values, backtrace) "
                         "instead of the E-step")
    ap.add_argument("--maxpost", action="store_true",
                    help="time the max-posterior decode instead of the "
                         "E-step")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.decode and args.maxpost:
        ap.error("--decode and --maxpost exclude each other")
    device = resolve_device(args.device)
    default = (DECODE_ENGINES if args.decode else
               MAXPOST_ENGINES if args.maxpost else ESTEP_ENGINES)
    engines = args.engines.split(",") if args.engines else list(default)
    timer = (time_decode if args.decode else
             time_maxpost if args.maxpost else time_estep)

    print(device_line(device), flush=True)
    for name in args.configs.split(","):
        S, T, V, B, L = CONFIGS[name]
        params, symbols = make_inputs(S, T, V, B, L, device, args.seed)
        results = {}                  # engine -> loglik, or its path
        for engine in engines:
            row = dict(config=name, S=S, T=T, V=V, B=B, L=L, engine=engine)
            try:
                dt, result = timer(params, symbols, engine, args.iters)
            except NotImplementedError as exc:
                # the kernel does not take this configuration: a result
                # of its own, reported and not replaced
                row["error"] = str(exc)
                print(json.dumps(row), flush=True)
                continue
            pos_s = B * L / dt
            row["estep_ms" if timer is time_estep else "decode_ms"] = \
                round(dt * 1e3, 3)
            row.update(positions_per_s=round(pos_s),
                       cellupdates_per_s=round(pos_s * S * S))
            if timer is time_estep:
                row["loglik"] = result
            else:
                first = next(iter(results.values()), result)
                row["loglik"] = int(result.sum())
                row["path_agreement"] = float(
                    (result == first).to(torch.float64).mean())
            results[engine] = result
            print(json.dumps(row), flush=True)
        if timer is time_estep and len(results) >= 2:
            lls = list(results.values())
            rel = max(abs(a - b) / max(abs(a), 1e-9)
                      for i, a in enumerate(lls) for b in lls[i + 1:])
            print(f"# {name} engine loglik rel-delta: {rel:.3e}",
                  flush=True)
    print("# done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
