"""Gaussian (continuous-valued) track emissions.

Counterpart of ``tehmm_tpu/models/gauss.py``.  A track declared with
``distribution="gaussian"`` contributes

    log N(x[l, g] | mu[s, g], var[s, g])

to the observation log-likelihood of every state, with per-state means
and variances learned by EM (posterior-weighted moments) or by
supervised counting.  Missing positions (NaN values) contribute nothing,
as the categorical missing symbol 0 does.  Gaussian tracks keep an
all-missing symbols column, so every categorical path is untouched; the
values ride a parallel float matrix on the TrackTable.

The per-state log-density is a quadratic form in x with coefficients
c0 + c1 x + c2 x^2 (``_coeffs``).  Its order of arithmetic is the
numerics contract the CUDA kernels follow (``csrc/common.cuh``
``obs_log``): three block sums over the tracks, each summed in track
order g = 0..G-1 from explicit products,

    (sum_g mask c0) + (sum_g x mask c1) + (sum_g x^2 mask c2),

added left to right, so the plain version and the kernels agree bit for
bit.  The JAX package forms the same sums as three matmuls, which agree
with these within float32 ulps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LOG_2PI = float(np.log(2.0 * np.pi))
MIN_VAR = 1e-4


@dataclasses.dataclass(frozen=True)
class GaussParams:
    """Per-state normal emission parameters for the gaussian tracks.

    mu:      f32[S, G] means.
    log_var: f32[S, G] log variances (floored at MIN_VAR).
    """

    mu: torch.Tensor
    log_var: torch.Tensor

    @property
    def num_tracks(self) -> int:
        return self.mu.shape[1]

    @property
    def device(self) -> torch.device:
        return self.mu.device


def from_numpy(mu, log_var, device: str | torch.device) -> GaussParams:
    """Array-likes (NumPy, or the JAX package's arrays via np.asarray) ->
    float32 GaussParams on ``device``."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return GaussParams(mu=t(mu), log_var=t(log_var))


def init_gauss(
    num_states: int,
    values_list,
    device: str | torch.device,
    seed: int = 0,
    spread: bool = True,
) -> GaussParams:
    """Initialize from data moments: state means spread across the
    empirical quantiles (with a small jitter from
    ``numpy.random.RandomState(seed)``, drawn as the JAX package draws
    it), variance = the global variance."""
    allv = np.concatenate(
        [np.asarray(v, np.float32).reshape(-1, v.shape[-1])
         for v in values_list]
    )
    G = allv.shape[1]
    S = num_states
    mu = np.zeros((S, G), np.float32)
    var = np.ones((S, G), np.float32)
    rng = np.random.RandomState(seed)
    for g in range(G):
        col = allv[:, g]
        col = col[np.isfinite(col)]
        if len(col) == 0:
            continue
        v = max(float(col.var()), MIN_VAR)
        var[:, g] = v
        if spread and S > 1:
            qs = (np.arange(S) + 0.5) / S
            mu[:, g] = np.quantile(col, qs) + \
                rng.normal(0, np.sqrt(v) * 0.01, S)
        else:
            mu[:, g] = float(col.mean())
    return from_numpy(mu, np.log(var), device)


def _coeffs(params: GaussParams):
    """Quadratic-form coefficients (c0, c1, c2), each f32[S, G]:
    log N = c0 + c1*x + c2*x^2."""
    var = torch.exp(params.log_var)
    inv = 1.0 / var
    c2 = -0.5 * inv
    c1 = params.mu * inv
    c0 = -0.5 * (params.mu * params.mu * inv + params.log_var + LOG_2PI)
    return c0, c1, c2


def coeff_table(params: GaussParams) -> torch.Tensor:
    """The kernels' coefficient table f32[S, 3G]: [c0 | c1 | c2]."""
    return torch.cat(_coeffs(params), dim=1).contiguous()


def features(values: torch.Tensor):
    """(mask, x*mask, x^2*mask) of values f32[..., G] (NaN missing)."""
    mask = torch.isfinite(values).to(torch.float32)
    x = torch.where(mask > 0, values, 0.0)
    return mask, x * mask, x * x * mask


def gauss_log_likelihoods(params: GaussParams,
                          values: torch.Tensor) -> torch.Tensor:
    """Summed per-state log-density of the gaussian tracks.

    values f32[..., L, G] (NaN = missing, contributes 0) -> f32[..., L, S],
    in the order of arithmetic of the module docstring: elementwise
    products and adds only (a matmul's summation order on the card is
    not fixed)."""
    G = values.shape[-1]
    out = None
    for f, c in zip(features(values), _coeffs(params)):
        block = f[..., 0:1] * c[:, 0]
        for g in range(1, G):
            block = block + f[..., g:g + 1] * c[:, g]
        out = block if out is None else out + block
    return out


def gauss_stats(gamma: torch.Tensor, values: torch.Tensor):
    """Posterior-weighted moments for the M-step.

    gamma f32[..., L, S] (already padding-masked, and weighted in segment
    mode); values f32[..., L, G].  Returns (gn, gx, gx2), each f32[S, G]."""
    S = gamma.shape[-1]
    G = values.shape[-1]
    g2 = gamma.reshape(-1, S).T
    return tuple(g2 @ f.reshape(-1, G) for f in features(values))


def gauss_m_step(
    gn: torch.Tensor, gx: torch.Tensor, gx2: torch.Tensor,
    old: GaussParams, min_var: float = MIN_VAR,
    fix_states: torch.Tensor | None = None,
) -> GaussParams:
    """Moments -> new means/variances; states with (numerically) no
    posterior mass keep their previous parameters.  ``fix_states``
    (bool[S], from --fixEm) freezes those states' means and variances:
    they are emission parameters, as the categorical log_em rows are."""
    ok = gn > 1e-6
    denom = torch.clamp(gn, min=1e-6)
    mu = torch.where(ok, gx / denom, old.mu)
    var = torch.where(ok, gx2 / denom - mu * mu, torch.exp(old.log_var))
    var = torch.clamp(var, min=min_var)
    if fix_states is not None:
        keep = fix_states[:, None]
        mu = torch.where(keep, old.mu, mu)
        var = torch.where(keep, torch.exp(old.log_var), var)
    return GaussParams(mu=mu, log_var=torch.log(var))


def supervised_gauss(
    num_states: int,
    values_list,
    states_list,
    device: str | torch.device,
    min_var: float = MIN_VAR,
) -> GaussParams:
    """Hard-label moment estimation on the host.  Unlabeled (-1) and NaN
    positions are excluded; states never seen with a finite value get
    the global moments."""
    allv = np.concatenate(
        [np.asarray(v, np.float32) for v in values_list]
    )
    alls = np.concatenate(
        [np.asarray(s, np.int64) for s in states_list]
    )
    G = allv.shape[1]
    S = num_states
    mu = np.zeros((S, G), np.float32)
    var = np.ones((S, G), np.float32)
    for g in range(G):
        col = allv[:, g]
        fin = np.isfinite(col)
        gcol = col[fin]
        gmu = float(gcol.mean()) if len(gcol) else 0.0
        gva = max(float(gcol.var()), min_var) if len(gcol) else 1.0
        for s in range(S):
            sel = fin & (alls == s)
            n = int(sel.sum())
            if n > 0:
                mu[s, g] = float(col[sel].mean())
                var[s, g] = max(float(col[sel].var()), min_var)
            else:
                mu[s, g] = gmu
                var[s, g] = gva
    return from_numpy(mu, np.log(var), device)
