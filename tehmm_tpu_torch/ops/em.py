"""EM sufficient statistics and the M-step.

Counterpart of the M-step half of ``tehmm_tpu/ops/em.py``: counts ->
renormalized log tables with EPSILON pseudo-counts, in float32 like the
reference.  Supervised training needs nothing more; the E-step
(``em_sufficient_stats`` and its fused kernel) and the fix/force masks
come with the unsupervised-EM slice (ROADMAP, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from tehmm_tpu.utils.common import EPSILON
from tehmm_tpu_torch.models.emission import normalize_log_em
from tehmm_tpu_torch.models.params import HmmParams


@dataclasses.dataclass(frozen=True)
class EmStats:
    """EM sufficient statistics.

    start:  f32[S]      expected initial-state counts
    trans:  f32[S, S]   expected transition counts
    em:     f32[S,T,V]  expected symbol counts
    loglik: f32[]       total data log-likelihood
    n_obs:  f32[]       number of (valid) observed positions
    """

    start: torch.Tensor
    trans: torch.Tensor
    em: torch.Tensor
    loglik: torch.Tensor
    n_obs: torch.Tensor


def _normalize_rows(counts: torch.Tensor, epsilon: float) -> torch.Tensor:
    smoothed = counts + epsilon
    probs = smoothed / smoothed.sum(dim=-1, keepdim=True)
    return torch.log(torch.clamp(probs, min=1e-300)).to(torch.float32)


def em_m_step(
    stats: EmStats,
    alphabet_sizes: Sequence[int],
    epsilon: float = EPSILON,
) -> HmmParams:
    """Counts -> new parameters (reference: basehmm M-step)."""
    return HmmParams(
        log_start=_normalize_rows(stats.start, epsilon),
        log_trans=_normalize_rows(stats.trans, epsilon),
        log_em=normalize_log_em(stats.em, alphabet_sizes, epsilon),
    )
