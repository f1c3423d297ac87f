"""Baum-Welch EM: E-step sufficient statistics, the M-step with the
semi-supervised fix/force masks, and the loops over them.

Counterpart of ``tehmm_tpu/ops/em.py``.  ``em_sufficient_stats`` has
four engines:

* ``"plain"`` ports the JAX package's XLA branch: log-space scaled
  forward/backward (``ops/dp.py``), posteriors, and the factored,
  per-step-normalized transition counts (xi at every position sums to 1,
  so each step is normalized by its own partition value z and no
  cumulative normalizer enters; ``trans = pair * exp(log_trans)``).  It is
  the CPU path.
* ``"cuda"`` runs K1, the fused E-step (``ops/cuda_kernels.
  em_counts_fused``: symbols in, statistics out), and finishes as the
  JAX package's ``pallas`` branch does.  On a CPU tensor K1's wrapper
  takes its plain version.  K1 keeps its statistics in one block's
  shared memory, so it takes S up to about 150 at T=5, V=9 and raises
  beyond that (``cuda_kernels.k1_fits`` states the envelope).
* ``"cuda_v3"`` replaces the JAX package's ``engine="pallas_v3"``, the
  probability-space streaming engine kept for engine comparisons
  (``tools/bench_engines.py``): the observation tensor is formed first
  and split into ``obs_p``/``o_m`` (``dp.scaled_obs_prob``), K6
  (``ops/cuda_kernels.forward_prob`` and ``backward_prob``) returns
  alpha_p and beta_p, exactly the factors the contractions consume, and
  the statistics are the same torch products as the plain engine's.  It
  takes any S up to 1024 at any T and V, and needs several [B, L, S]
  tensors of device memory where K1 needs one.  ``"auto"`` takes it past
  K1's envelope.
* ``"cuda_log"`` is the JAX package's ``engine="xla"`` run on a card: the
  plain engine's log-space scans as kernels (``ops/cuda_kernels.
  forward_scaled`` and ``backward_scaled``, K7a/K8a and K7b/K8b), then
  the plain engine's epilogue.  On the CPU it is ``"plain"`` (the matmul
  form).  It takes any S up to 1024 at any T and V; nothing selects it but
  its name.

``"auto"`` (``resolve_engine``) is ``"plain"`` on the CPU; on the card it
is ``"cuda"`` where K1's kernels take the model and ``"cuda_v3"`` beyond,
to 1024 states, as the JAX package takes its fused kernel where it fits
and another engine beyond: on the card training never runs a plain
E-step.

Segment weights (``obs_weights``, ``--segment --segLen``) scale each
position's observation log-likelihood and its emission counts and
gaussian moments; start counts and transition pairs stay unweighted.
Gaussian tracks (``gauss_params``, ``gauss_values``) add their normal
log-densities to the observations and return posterior moment sums in
``EmStats.gauss_*`` for ``models.gauss.gauss_m_step``.

The M-step renormalizes with EPSILON pseudo-counts in float32, then
applies fix masks before force masks, as the reference does.  Restarts
(``em_stats_reps``) are a leading R axis written out as a loop; the
device loop ``em_run`` is a Python loop with the same stopping rule and
NaN-padded history as the JAX ``lax.while_loop``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from tehmm_tpu_torch.utils.common import EPSILON
from tehmm_tpu_torch.models.emission import (
    expected_emission_counts,
    normalize_log_em,
    obs_log_likelihoods,
    supervised_emission_counts,
    track_log_likelihoods,  # noqa: F401  (part of this module's API)
)
from tehmm_tpu_torch.models.gauss import GaussParams, gauss_m_step, gauss_stats
from tehmm_tpu_torch.models.params import HmmParams
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.ops import dp

_CLIP = 60.0  # exp-range guard of the factored transition counts
ENGINES = ("auto", "plain", "cuda", "cuda_v3", "cuda_log")


@dataclasses.dataclass(frozen=True)
class EmStats:
    """EM sufficient statistics.

    start:  f32[S]      expected initial-state counts
    trans:  f32[S, S]   expected transition counts
    em:     f32[S,T,V]  expected symbol counts
    loglik: f32[]       total data log-likelihood
    n_obs:  f32[]       number of (valid) observed positions
    gauss_n, gauss_x, gauss_x2: f32[S, G] gaussian-track moment sums
                        (models/gauss.py); None without gaussian tracks
    """

    start: torch.Tensor
    trans: torch.Tensor
    em: torch.Tensor
    loglik: torch.Tensor
    n_obs: torch.Tensor
    gauss_n: torch.Tensor | None = None
    gauss_x: torch.Tensor | None = None
    gauss_x2: torch.Tensor | None = None

    def __add__(self, other: "EmStats") -> "EmStats":
        return EmStats(*(
            None if getattr(self, f.name) is None
            else getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(self)
        ))


def stack_reps(items: Sequence, cls):
    """Stack the tensor fields of dataclass instances (HmmParams,
    EmStats, GaussParams) on a new leading R axis (None stays None)."""
    return cls(*(
        None if getattr(items[0], f.name) is None
        else torch.stack([getattr(x, f.name) for x in items])
        for f in dataclasses.fields(cls)
    ))


def unstack_rep(stacked, cls, r: int):
    """Restart r of a ``stack_reps`` result."""
    return cls(*(None if getattr(stacked, f.name) is None
                 else getattr(stacked, f.name)[r]
                 for f in dataclasses.fields(cls)))


def em_sufficient_stats(
    params: HmmParams,
    symbols: torch.Tensor,
    lengths: torch.Tensor | None = None,
    matmul: bool = True,
    obs_weights: torch.Tensor | None = None,
    engine: str = "auto",
    gauss_params=None,
    gauss_values: torch.Tensor | None = None,
) -> EmStats:
    """One E-step over a batch of chunks.

    Args:
      symbols: int[B, L, T] discretized observations.
      lengths: optional int[B]; positions >= length are padding.
      matmul: the plain engine's log-sum-exp form (``dp._logdot``).
      obs_weights: optional f32[B, L] segment weights.
      engine: "auto" (``resolve_engine``), "plain" (log-space scans in
        torch; the CPU path), "cuda" (K1, the fused E-step from symbols),
        "cuda_v3" (K6, the probability-space scans over a precomputed obs
        tensor; the counterpart of ``tehmm_tpu/ops/em.py``
        ``engine="pallas_v3"``) or "cuda_log" (K7/K8, the log-space scans
        over obs; the JAX package's ``engine="xla"``).  See the module
        docstring.
      gauss_params / gauss_values: gaussian-track emissions, values
        f32[B, L, G] with NaN missing.

    Returns EmStats summed over the batch."""
    has_gauss = gauss_params is not None and gauss_values is not None
    if not has_gauss:
        gauss_params = gauss_values = None
    B, L, T = symbols.shape
    dev = symbols.device
    lengths = dp._lengths(lengths, B, L, dev)
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    n_obs = valid.sum().to(torch.float32)
    engine = resolve_engine(engine, *params.log_em.shape,
                            gauss_values.shape[-1] if has_gauss else 0, dev)
    if engine == "cuda":
        out = ck.em_counts_fused(
            params.log_start.contiguous(), params.log_trans.contiguous(),
            params.log_em.contiguous(),
            symbols.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous(),
            obs_weights=None if obs_weights is None
            else obs_weights.to(torch.float32).contiguous(),
            gauss_params=gauss_params,
            gauss_values=None if gauss_values is None
            else gauss_values.to(torch.float32).contiguous(),
        )
        start, pair, em, loglik_b = out[:4]
        moments = out[4] if has_gauss else (None, None, None)
        return EmStats(start, pair * torch.exp(params.log_trans), em,
                       loglik_b.sum(), n_obs, *moments)
    if engine not in ("plain", "cuda_v3", "cuda_log"):
        raise ValueError(
            f"unknown engine {engine!r}: choose one of {ENGINES} (the JAX "
            "package's 'pallas_v3' is \"cuda_v3\" here, its 'xla' on a "
            "card \"cuda_log\")"
        )

    obs = obs_log_likelihoods(params.log_em, symbols, gauss_params,
                              gauss_values, obs_weights)      # [B,L,S]
    if engine == "cuda_v3":
        obs_p, o_m = dp.scaled_obs_prob(obs)
        del obs
        lens32 = lengths.to(torch.int32)
        log_trans = params.log_trans.contiguous()
        alpha_p, dms = ck.forward_prob(params.log_start.contiguous(),
                                       log_trans, obs_p, lens32)
        beta_p = ck.backward_prob(log_trans, obs_p, lens32)
        loglik = (torch.log(alpha_p[:, -1].sum(dim=-1)) + dms.sum(dim=1)
                  + torch.where(valid, o_m, 0.0).sum(dim=1))
        loglik = torch.where(lengths > 0, loglik, 0.0)
        gamma, a_fac, b_fac = prob_space_factors(alpha_p, beta_p, obs_p)
    else:
        if engine == "cuda_log":
            lens32 = lengths.to(torch.int32)
            log_trans = params.log_trans.contiguous()
            alpha_hat, _, loglik = ck.forward_scaled(
                params.log_start.contiguous(), log_trans, obs, lens32)
            beta_hat, _ = ck.backward_scaled(log_trans, obs, lens32)
        else:
            alpha_hat, _, loglik = dp.forward_scaled(
                params.log_start, params.log_trans, obs, lengths,
                matmul=matmul)
            beta_hat, _ = dp.backward_scaled(params.log_trans, obs, lengths,
                                             matmul=matmul)
        gamma = dp.posterior_scaled(alpha_hat, beta_hat)
        a_fac, b_fac = log_space_factors(alpha_hat, beta_hat, obs)
    start, trans, em, moments = contract_stats(
        params, symbols, lengths, gamma, a_fac, b_fac, obs_weights,
        gauss_values if has_gauss else None)
    return EmStats(start, trans, em, loglik.sum(), n_obs, *moments)


def resolve_engine(engine: str, S: int, T: int, V: int, G: int,
                   device: torch.device) -> str:
    """The engine ``"auto"`` stands for: ``"plain"`` off the card; on the
    card ``"cuda"`` where K1's kernels take S states, T tracks of V
    symbols and G gaussian tracks (``cuda_kernels.k1_fits``), else
    ``"cuda_v3"`` up to the scan tile's 1024 states, and past them it
    raises NotImplementedError naming the tile's envelope item (never
    ``"plain"`` on the card).  Any other engine is returned as it is."""
    if engine != "auto":
        return engine
    if device.type != "cuda":
        return "plain"
    if ck.k1_fits(S, T, V, G):
        return "cuda"
    ck._check_tile(S, 'engine "auto"')
    return "cuda_v3"


def log_space_factors(alpha_hat, beta_hat, obs):
    """(a_fac, b_fac) of the log-space scans: xi[t,i,j] = a[i] T[i,j]
    b[j] / z[t] with a = exp(alpha_hat[t]), b = exp(obs[t+1] +
    beta_hat[t+1] - max), z = (a @ T) . b: exact per step, every factor
    in [0, 1]; trans = T * sum_t (a / z) outer b (``contract_stats``)."""
    bb = obs[:, 1:] + beta_hat[:, 1:]
    bb = bb - bb.amax(dim=-1, keepdim=True)
    return (torch.exp(alpha_hat[:, :-1]),
            torch.exp(torch.clamp(bb, -_CLIP, _CLIP)))


def prob_space_factors(alpha_p, beta_p, obs_p):
    """(gamma, a_fac, b_fac) from the prob-space scans' rows: gamma =
    alpha_p beta_p / max(sum, 1e-30), a_fac = alpha_p at positions
    0..L-2, b_fac = obs_p beta_p at positions 1..L-1 scaled to max 1.
    Every factor lies in [0, 1]."""
    ab = alpha_p * beta_p
    gamma = ab / torch.clamp(ab.sum(dim=-1, keepdim=True), min=1e-30)
    xb = obs_p[:, 1:] * beta_p[:, 1:]
    b_fac = xb / torch.clamp(xb.amax(dim=-1, keepdim=True), min=1e-30)
    return gamma, alpha_p[:, :-1], b_fac


def contract_stats(params, symbols, lengths, gamma, a_fac, b_fac,
                   obs_weights=None, gauss_values=None):
    """The contractions every obs-space engine ends in: (start f32[S],
    trans f32[S, S], em f32[S, T, V], moments) from unmasked gamma
    f32[B, L, S] and the transition factors a_fac, b_fac f32[B, L-1, S]
    in [0, 1].  Each step's pair is normalized by its own partition
    value z = (a @ T) . b; ``moments`` is (gn, gx, gx2) with
    ``gauss_values``, else three Nones."""
    B, L, _T = symbols.shape
    dev = symbols.device
    steps = torch.arange(L, device=dev)[None, :]
    gamma = gamma * (steps < lengths[:, None])[..., None]
    trans_exp = torch.exp(params.log_trans)
    z = ((a_fac @ trans_exp) * b_fac).sum(dim=-1)             # [B,L-1]
    # transitions OUT of the last valid position don't exist
    valid_from = steps[:, :L - 1] < (lengths[:, None] - 1)
    w = torch.where(valid_from, 1.0 / torch.clamp(z, min=1e-30), 0.0)
    pair = torch.einsum("bli,blj->ij", a_fac * w[..., None], b_fac)
    # a segment standing for w positions contributes w expected emission
    # counts, and (the density being raised to the power w) w times its
    # gaussian moments
    gamma_w = gamma if obs_weights is None else gamma * obs_weights[..., None]
    moments = (gauss_stats(gamma_w, gauss_values)
               if gauss_values is not None else (None, None, None))
    em = expected_emission_counts(tuple(params.log_em.shape), symbols,
                                  gamma_w)
    return gamma[:, 0].sum(dim=0), pair * trans_exp, em, moments


def _normalize_rows(counts: torch.Tensor, epsilon: float) -> torch.Tensor:
    smoothed = counts + epsilon
    probs = smoothed / smoothed.sum(dim=-1, keepdim=True)
    return torch.log(torch.clamp(probs, min=1e-300)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class ParamMasks:
    """Semi-supervised parameter pinning (``--fixTrans``, ``--fixEm``,
    ``--forceTransProbs``, ``--forceEmProbs``).  None == no constraint.

    fix_trans_rows: bool[S]   rows of log_trans frozen at their old values
    fix_em_states:  bool[S]   states whose emission tables are frozen
    force_trans:    f32[S,S]  entries >= 0 overwrite the trained matrix
                              (the free entries of the row renormalize);
                              negative entries mean "free"
    force_em:       f32[S,T,V] the same for emissions
    """

    fix_trans_rows: torch.Tensor | None = None
    fix_em_states: torch.Tensor | None = None
    force_trans: torch.Tensor | None = None
    force_em: torch.Tensor | None = None


def _force(p, forced, force):
    """Overwrite forced entries; scale the free ones to the leftover
    mass of their row."""
    forced_mass = torch.where(forced, force, 0.0).sum(dim=-1, keepdim=True)
    free_mass = torch.where(forced, 0.0, p).sum(dim=-1, keepdim=True)
    scale = torch.where(
        free_mass > 0,
        (1.0 - forced_mass) / torch.clamp(free_mass, min=1e-300), 0.0,
    )
    new_p = torch.where(forced, force, p * scale)
    return torch.log(torch.clamp(new_p, min=1e-300)).to(torch.float32)


def _apply_force(log_p: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
    """Overwrite entries where force >= 0 and renormalize the remaining
    (free) entries of each row to the leftover probability mass."""
    return _force(torch.exp(log_p), force >= 0.0, force)


def _real_symbols(alphabet_sizes, V: int, device) -> torch.Tensor:
    """bool[T, V]: real (non-missing, non-pad) symbols of each track."""
    v_idx = torch.arange(V, device=device)[None, :]
    sizes = torch.as_tensor(list(alphabet_sizes), device=device)[:, None]
    return (v_idx >= 1) & (v_idx < sizes)


def _apply_force_em(log_em: torch.Tensor, force: torch.Tensor,
                    alphabet_sizes) -> torch.Tensor:
    """Emission variant of _apply_force: only REAL symbols take part
    (the missing column carries probability 1 by convention and pads are
    inert); the output re-obeys the params conventions (missing column
    and pads 0.0)."""
    real = _real_symbols(alphabet_sizes, log_em.shape[2],
                         log_em.device)[None]
    p = torch.where(real, torch.exp(log_em), 0.0)
    log_out = _force(p, (force >= 0.0) & real, force)
    return torch.where(real, log_out, 0.0)


def em_m_step(
    stats: EmStats,
    old_params: HmmParams,
    alphabet_sizes: Sequence[int],
    masks: ParamMasks | None = None,
    epsilon: float = EPSILON,
) -> HmmParams:
    """Counts -> new parameters.  ``old_params`` supplies the frozen
    rows of the fix masks; fix is applied before force."""
    log_start = _normalize_rows(stats.start, epsilon)
    log_trans = _normalize_rows(stats.trans, epsilon)
    log_em = normalize_log_em(stats.em, alphabet_sizes, epsilon)
    if masks is not None:
        if masks.fix_trans_rows is not None:
            log_trans = torch.where(masks.fix_trans_rows[:, None],
                                    old_params.log_trans, log_trans)
        if masks.fix_em_states is not None:
            log_em = torch.where(masks.fix_em_states[:, None, None],
                                 old_params.log_em, log_em)
        if masks.force_trans is not None:
            log_trans = _apply_force(log_trans, masks.force_trans)
        if masks.force_em is not None:
            log_em = _apply_force_em(log_em, masks.force_em,
                                     alphabet_sizes)
    return HmmParams(log_start=log_start, log_trans=log_trans,
                     log_em=log_em)


def em_step(
    params: HmmParams,
    symbols: torch.Tensor,
    alphabet_sizes: Sequence[int],
    lengths: torch.Tensor | None = None,
    masks: ParamMasks | None = None,
    epsilon: float = EPSILON,
    matmul: bool = True,
    obs_weights: torch.Tensor | None = None,
) -> tuple[HmmParams, torch.Tensor]:
    """One full EM iteration. Returns (params, loglik)."""
    stats = em_sufficient_stats(params, symbols, lengths, matmul=matmul,
                                obs_weights=obs_weights)
    return (em_m_step(stats, params, alphabet_sizes, masks, epsilon),
            stats.loglik)


# ---------------------------------------------------------------------------
# Supervised training from a dense batch of labels
# ---------------------------------------------------------------------------

def supervised_counts(
    num_states: int,
    symbols: torch.Tensor,
    states: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> EmStats:
    """Hard-count start and transition statistics from labels
    (symbols int[B, L, T], states int[B, L]); ``em`` is left empty."""
    B, L, T = symbols.shape
    dev = symbols.device
    lengths = dp._lengths(lengths, B, L, dev)
    valid = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    oh = (torch.nn.functional.one_hot(states.long(), num_states)
          .to(torch.float32) * valid[..., None])
    trans = torch.einsum("bli,blj->ij",
                         oh[:, :-1] * valid[:, 1:, None], oh[:, 1:])
    return EmStats(
        start=oh[:, 0].sum(dim=0), trans=trans,
        em=torch.zeros((), device=dev), loglik=torch.zeros((), device=dev),
        n_obs=valid.sum().to(torch.float32),
    )


def supervised_train(
    num_states: int,
    alphabet_sizes: Sequence[int],
    symbols: torch.Tensor,
    states: torch.Tensor,
    lengths: torch.Tensor | None = None,
    epsilon: float = EPSILON,
) -> HmmParams:
    """Full supervised training on a dense batch: count + normalize."""
    B, L, T = symbols.shape
    V = int(max(alphabet_sizes))
    lengths = dp._lengths(lengths, B, L, symbols.device)
    valid = torch.arange(L, device=symbols.device)[None, :] \
        < lengths[:, None]
    stats = supervised_counts(num_states, symbols, states, lengths)
    em = supervised_emission_counts((num_states, T, V), symbols, states,
                                    valid=valid)
    return HmmParams(
        log_start=_normalize_rows(stats.start, epsilon),
        log_trans=_normalize_rows(stats.trans, epsilon),
        log_em=normalize_log_em(em, alphabet_sizes, epsilon),
    )


# ---------------------------------------------------------------------------
# Restarts: R stacked parameter sets over one shared batch
# ---------------------------------------------------------------------------

def em_stats_reps(
    params_stack: HmmParams,
    symbols: torch.Tensor,
    lengths: torch.Tensor | None = None,
    obs_weights: torch.Tensor | None = None,
    gauss_params_stack: GaussParams | None = None,
    gauss_values: torch.Tensor | None = None,
    engine: str = "auto",
) -> EmStats:
    """E-step for R stacked parameter sets (leading R axis on every
    table, and on ``gauss_params_stack`` when the model has gaussian
    tracks) over ONE batch; EmStats with a leading R axis.  One E-step
    per restart: on the card each is a K1 launch pair."""
    return stack_reps([
        em_sufficient_stats(
            unstack_rep(params_stack, HmmParams, r), symbols, lengths,
            obs_weights=obs_weights, engine=engine,
            gauss_params=None if gauss_params_stack is None
            else unstack_rep(gauss_params_stack, GaussParams, r),
            gauss_values=gauss_values,
        )
        for r in range(params_stack.log_start.shape[0])
    ], EmStats)


def em_m_step_reps(
    stats_stack: EmStats,
    params_stack: HmmParams,
    alphabet_sizes: Sequence[int],
    masks: ParamMasks | None = None,
    epsilon: float = EPSILON,
) -> HmmParams:
    """M-step for R stacked stat/parameter sets (masks shared)."""
    return stack_reps([
        em_m_step(unstack_rep(stats_stack, EmStats, r),
                  unstack_rep(params_stack, HmmParams, r), alphabet_sizes,
                  masks, epsilon)
        for r in range(params_stack.log_start.shape[0])
    ], HmmParams)


def em_run(
    params: HmmParams,
    symbols: torch.Tensor,
    alphabet_sizes: Sequence[int],
    lengths: torch.Tensor | None = None,
    max_iterations: int = 100,
    convergence_tol: float = 1e-3,
    masks: ParamMasks | None = None,
    epsilon: float = EPSILON,
    matmul: bool = True,
    obs_weights: torch.Tensor | None = None,
    gauss_params=None,
    gauss_values: torch.Tensor | None = None,
):
    """The whole EM loop without per-iteration logging: stops after
    ``max_iterations`` or once |loglik - previous| < tol, checked on the
    iteration just run (no lag, unlike ``MultitrackHmm.fit``), in
    float32 as the JAX ``lax.while_loop`` does.

    Returns (params, logliks f32[max_iterations] with NaN beyond the
    last executed iteration, n_iterations), plus the final GaussParams
    when ``gauss_params`` is given."""
    has_gauss = gauss_params is not None and gauss_values is not None
    fix = masks.fix_em_states if masks is not None else None
    dev = params.device
    prev_ll = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    ll = prev_ll / 2
    tol = torch.tensor(convergence_tol, dtype=torch.float32, device=dev)
    hist = torch.full((max_iterations,), float("nan"), dtype=torch.float32,
                      device=dev)
    it = 0
    while it < max_iterations and bool(torch.abs(ll - prev_ll) >= tol):
        stats = em_sufficient_stats(
            params, symbols, lengths, matmul=matmul, obs_weights=obs_weights,
            gauss_params=gauss_params if has_gauss else None,
            gauss_values=gauss_values if has_gauss else None,
        )
        params = em_m_step(stats, params, alphabet_sizes, masks, epsilon)
        if has_gauss:
            gauss_params = gauss_m_step(stats.gauss_n, stats.gauss_x,
                                        stats.gauss_x2, gauss_params,
                                        fix_states=fix)
        hist[it] = stats.loglik
        prev_ll, ll = ll, stats.loglik.to(torch.float32)
        it += 1
    if has_gauss:
        return params, hist, it, gauss_params
    return params, hist, it
