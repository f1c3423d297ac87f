"""Independent categorical emissions — tensor ops.

Counterpart of ``tehmm_tpu/models/emission.py``.  The per-position
observation log-likelihood

    obs[l, s] = sum_t log_em[s, t, x[l, t]]

is a gather-sum over tracks here.  The JAX package computes it as a
one-hot x table matmul because the TPU's matrix unit beats its gathers;
on a GPU the gather is the plain form.  The T terms are summed in track
order t = 0..T-1 in float32, the same order the CUDA decode kernel uses
in-kernel (``csrc/viterbi.cu``), so the two agree bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tehmm_tpu_torch.models.gauss import gauss_log_likelihoods
from tehmm_tpu_torch.utils.common import EPSILON

_COUNT_BLOCK = 1 << 16     # positions per one-hot block of the counts


def track_log_likelihoods(log_em: torch.Tensor,
                          symbols: torch.Tensor) -> torch.Tensor:
    """f32[S, T, V] table, int[..., L, T] symbols -> f32[..., L, S]."""
    S, T, V = log_em.shape
    sym = symbols.long()
    obs = log_em[:, 0, :].T[sym[..., 0]]
    for t in range(1, T):
        obs = obs + log_em[:, t, :].T[sym[..., t]]
    return obs


def obs_log_likelihoods(log_em: torch.Tensor, symbols: torch.Tensor,
                        gauss_params=None,
                        values: torch.Tensor | None = None,
                        weights: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """The full observation log-likelihood f32[..., L, S]: categorical
    tracks, plus the gaussian tracks' log-densities when ``gauss_params``
    and ``values`` f32[..., L, G] are given, times the segment weights
    ``weights`` f32[..., L] when given (a segment standing for w
    positions emits P(obs | state)^w).  The order of the JAX package's
    XLA paths, and of the kernels' in-register obs."""
    obs = track_log_likelihoods(log_em, symbols)
    if gauss_params is not None and values is not None:
        obs = obs + gauss_log_likelihoods(gauss_params, values)
    if weights is not None:
        obs = obs * weights[..., None]
    return obs


def expected_emission_counts(
    log_em_shape: tuple[int, int, int],
    symbols: torch.Tensor,
    gamma: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Posterior-weighted symbol counts for the M-step:
    counts[s, t, v] = sum_l gamma[l, s] * [x[l, t] == v], summed over
    every leading batch dim.

    As in the JAX package, a gamma^T @ one-hot product, taken over
    blocks of ``_COUNT_BLOCK`` positions so the one-hot stays small: the
    matrix product sums in blocks, where a scatter-add would pile
    millions of adds into one float32 accumulator per cell.

    symbols int[..., L, T]; gamma f32[..., L, S]; valid optional
    bool/f32[..., L] mask.  Returns f32[S, T, V]."""
    S, T, V = log_em_shape
    if valid is not None:
        gamma = gamma * valid[..., None].to(gamma.dtype)
    g = gamma.reshape(-1, S)
    sym = symbols.reshape(-1, T).long()
    counts = torch.zeros((S, T * V), dtype=torch.float32,
                         device=gamma.device)
    for lo in range(0, g.shape[0], _COUNT_BLOCK):
        oh = torch.nn.functional.one_hot(sym[lo:lo + _COUNT_BLOCK], V)
        counts += g[lo:lo + _COUNT_BLOCK].T \
            @ oh.reshape(-1, T * V).to(torch.float32)
    return counts.reshape(S, T, V)


def supervised_emission_counts(
    log_em_shape: tuple[int, int, int],
    symbols: torch.Tensor,
    states: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Hard-label symbol counts: EM counts with a one-hot gamma of the
    int[..., L] ``states``."""
    gamma = torch.nn.functional.one_hot(
        states.long(), log_em_shape[0]
    ).to(torch.float32)
    return expected_emission_counts(log_em_shape, symbols, gamma, valid)


def normalize_log_em(
    counts: torch.Tensor,
    alphabet_sizes: Sequence[int],
    epsilon: float = EPSILON,
) -> torch.Tensor:
    """Counts f32[S, T, V] -> normalized log emission table, with EPSILON
    pseudo-counts over each track's real (non-missing, non-pad) symbols;
    the missing column and pads come out 0.0.  ``1e-300`` underflows to 0
    in float32, exactly as in the reference (which runs with x64 off)."""
    S, T, V = counts.shape
    v_idx = torch.arange(V, device=counts.device)[None, :]
    sizes = torch.as_tensor(
        list(alphabet_sizes), device=counts.device
    )[:, None]
    real = (v_idx >= 1) & (v_idx < sizes)                     # [T, V]
    realf = real.to(torch.float32)[None]                      # [1, T, V]
    smoothed = (counts + epsilon) * realf
    denom = smoothed.sum(dim=2, keepdim=True)
    probs = smoothed / torch.clamp(denom, min=1e-300)
    return torch.where(
        realf > 0, torch.log(torch.clamp(probs, min=1e-300)),
        torch.zeros((), device=counts.device),
    )
