"""An obs-space E-step (``cuda_v3`` or ``cuda_log``) stage by stage.

    python -m tehmm_tpu_torch.tools.profile_estep [S20,S64,...] [--iters N]
        [--engine cuda_v3|cuda_log] [--device cuda|cpu] [--seed N]

Counterpart of ``tools/profile_estep.py``, on ``bench_engines``'s
configurations and inputs.  Per configuration one JSON line with the
milliseconds of each stage, timed alone with
``utils.profiling.marginal_time``: ``obs_ms`` (the observation tensor),
for ``cuda_v3`` ``obs_p_ms`` (the same plus its split into obs_p and
o_m), ``fwd_ms`` and ``bwd_ms`` (the engine's two kernels: K6, or the
log-space K7a/K7b), ``epilogue_ms`` (posteriors, factors and the
contractions), ``sum_ms`` of the stages that make up one E-step (the
obs stage, the kernels and the epilogue), and the positions per second
that sum would give.  The first line names the device.  On the CPU the
kernels' plain versions run.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from tehmm_tpu_torch.models.emission import track_log_likelihoods
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.ops import dp
from tehmm_tpu_torch.ops import em as em_ops
from tehmm_tpu_torch.tools import bench_engines
from tehmm_tpu_torch.utils.device import resolve_device
from tehmm_tpu_torch.utils.profiling import marginal_time


def _timeit(fn, device, iters):
    def sync(out):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        first = out[0] if isinstance(out, tuple) else out
        return float(first.reshape(-1)[0])

    return marginal_time(fn, sync, iters)


def _stages_v3(params, symbols, lengths):
    """The cuda_v3 E-step's stages, and those summed into one E-step."""
    obs_p, _o_m = dp.scaled_obs_prob(
        track_log_likelihoods(params.log_em, symbols))
    alpha_p, _dm = ck.forward_prob(params.log_start, params.log_trans,
                                   obs_p, lengths)
    beta_p = ck.backward_prob(params.log_trans, obs_p, lengths)

    def epilogue():
        gamma, a_fac, b_fac = em_ops.prob_space_factors(alpha_p, beta_p,
                                                        obs_p)
        start, trans, em, _ = em_ops.contract_stats(
            params, symbols, lengths, gamma, a_fac, b_fac)
        return trans, em, start

    return dict(
        obs_ms=lambda: track_log_likelihoods(params.log_em, symbols),
        obs_p_ms=lambda: dp.scaled_obs_prob(
            track_log_likelihoods(params.log_em, symbols)),
        fwd_ms=lambda: ck.forward_prob(params.log_start, params.log_trans,
                                       obs_p, lengths),
        bwd_ms=lambda: ck.backward_prob(params.log_trans, obs_p, lengths),
        epilogue_ms=epilogue,
    ), ("obs_p_ms", "fwd_ms", "bwd_ms", "epilogue_ms")


def _stages_log(params, symbols, lengths):
    """The cuda_log E-step's stages (the plain engine's epilogue after the
    log-space kernels), and those summed into one E-step."""
    obs = track_log_likelihoods(params.log_em, symbols)
    alpha_hat, _lc, _ll = ck.forward_scaled(params.log_start,
                                            params.log_trans, obs, lengths)
    beta_hat, _ld = ck.backward_scaled(params.log_trans, obs, lengths)

    def epilogue():
        gamma = dp.posterior_scaled(alpha_hat, beta_hat)
        a_fac, b_fac = em_ops.log_space_factors(alpha_hat, beta_hat, obs)
        start, trans, em, _ = em_ops.contract_stats(
            params, symbols, lengths, gamma, a_fac, b_fac)
        return trans, em, start

    return dict(
        obs_ms=lambda: track_log_likelihoods(params.log_em, symbols),
        fwd_ms=lambda: ck.forward_scaled(params.log_start, params.log_trans,
                                         obs, lengths),
        bwd_ms=lambda: ck.backward_scaled(params.log_trans, obs, lengths),
        epilogue_ms=epilogue,
    ), ("obs_ms", "fwd_ms", "bwd_ms", "epilogue_ms")


ENGINES = {"cuda_v3": _stages_v3, "cuda_log": _stages_log}


def profile(name, device, iters, seed=0, engine="cuda_v3") -> dict:
    """Stage times of the ``engine`` E-step at configuration ``name``."""
    S, T, V, B, L = bench_engines.CONFIGS[name]
    params, symbols = bench_engines.make_inputs(S, T, V, B, L, device, seed)
    lengths = torch.full((B,), L, dtype=torch.int32, device=device)
    stages, summed = ENGINES[engine](params, symbols, lengths)
    row = dict(config=name, engine=engine, S=S, T=T, V=V, B=B, L=L)
    for stage, fn in stages.items():
        row[stage] = round(_timeit(fn, device, iters) * 1e3, 3)
    # the sum of the printed stage times, so the row adds up as printed
    row["sum_ms"] = round(sum(row[k] for k in summed), 3)
    row["positions_per_s_if_summed"] = round(B * L / (row["sum_ms"] * 1e-3))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="?", default="S20,S64,S128,S256")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--engine", choices=sorted(ENGINES), default="cuda_v3")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(bench_engines.device_line(device), flush=True)
    for name in args.configs.split(","):
        print(json.dumps(profile(name, device, args.iters, args.seed,
                                 args.engine)),
              flush=True)
    print("# done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
