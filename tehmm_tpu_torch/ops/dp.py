"""HMM dynamic programming in plain torch: the scaled forward/backward
scans and posteriors of the E-step, their carried chunk continuations
(whole-chromosome scoring and the exact chunked posteriors), and
max-plus Viterbi.

Counterpart of ``tehmm_tpu/ops/dp.py``, step for step: the same
max-rescaled carries, the same masking (positions ``t >= length`` carry
the state through and add a zero normalizer), the same two forms of the
log-sum-exp step (``matmul=True``: exp, matrix product, log;
``matmul=False``: a broadcast logsumexp) and the same first-hit argmax
(ties go to the lowest state index).  The Viterbi operations are exact
float32 max, add or subtract, so fed the same obs they give the JAX
package's value rows and paths bit for bit; the forward/backward scans
agree with it to float32 rounding.

This is the CPU path and the reference every CUDA kernel is checked
against (``ops/cuda_kernels.py``).  The time loops are Python loops over
positions: on the GPU the E-step, the decoders and the chunk sweeps
call the kernels instead.  ``viterbi_streaming`` and ``scaled_obs_prob``
at the end are the obs-space engines' entry points: the first decodes
through the streaming value kernel, the second makes the
probability-space observations the E-step engine ``"cuda_v3"`` scans;
``viterbi_backpointers`` decodes through the pointer-writing kernel.
``forward_scaled`` and ``backward_scaled`` stay plain torch on every
device: they are the plain versions the log-space kernels
(``cuda_kernels.forward_scaled``, ``backward_scaled``) are held against.

All functions take batch-major ``obs[B, L, S]``.
"""

from __future__ import annotations

import torch

from tehmm_tpu_torch.utils.common import LOG_ZERO


def _lengths(lengths, B: int, L: int, device) -> torch.Tensor:
    if lengths is None:
        return torch.full((B,), L, dtype=torch.int64, device=device)
    return lengths.to(device=device, dtype=torch.int64)


def _cast(dtype, *tensors):
    """The tensors in ``dtype`` (None: as they are).  The scans' ``dtype``
    argument: float64 carries a scan of float32 inputs with rounding of
    its own negligible, the reference the kernels are held against."""
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) for t in tensors)


def _renorm(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split x[B,S] into (x - max, max); max clamped to stay finite."""
    m = torch.clamp(x.amax(dim=-1), min=LOG_ZERO)              # [B]
    return x - m[:, None], m


def _mask_carry(new: torch.Tensor, old: torch.Tensor,
                valid_t: torch.Tensor) -> torch.Tensor:
    """Carry ``old`` through for batch rows whose position t is padding."""
    return torch.where(valid_t[:, None], new, old)


def _logdot(x: torch.Tensor, log_mat: torch.Tensor, mat_exp: torch.Tensor,
            matmul: bool) -> torch.Tensor:
    """LSE_i(x[b,i] + log_mat[i,j]) for x [B,S] -> [B,S].

    ``mat_exp`` must equal exp(log_mat); ``x`` is pre-normalized to max
    0 (scaled scan), so exp is safe."""
    if matmul:
        s = torch.exp(x) @ mat_exp
        return torch.where(s > 0, torch.log(s), LOG_ZERO)
    y = x[:, :, None] + log_mat[None, :, :]                   # [B,S,S]
    m_safe = torch.clamp(y.amax(dim=1, keepdim=True), min=LOG_ZERO)
    s = torch.exp(y - m_safe).sum(dim=1)
    return torch.where(s > 0, torch.log(s), LOG_ZERO) + m_safe[:, 0, :]


def _fwd_step(log_trans, trans_exp, a_hat, obs_row, valid_t, matmul):
    """The forward step: (new_hat, dm), masked at padding."""
    new = _logdot(a_hat, log_trans, trans_exp, matmul) + obs_row
    new_hat, dm = _renorm(new)
    return (_mask_carry(new_hat, a_hat, valid_t),
            torch.where(valid_t, dm, 0.0))


def _bwd_step(log_trans_T, trans_exp_T, b_hat, obs_next, valid_next,
              matmul):
    """The backward step from position t+1 to t: (new_hat, dm)."""
    x_hat, xm = _renorm(obs_next + b_hat)
    new_hat, nm = _renorm(_logdot(x_hat, log_trans_T, trans_exp_T, matmul))
    return (_mask_carry(new_hat, b_hat, valid_next),
            torch.where(valid_next, xm + nm, 0.0))


def forward_scaled(
    log_start: torch.Tensor,
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None = None,
    matmul: bool = True,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scaled forward pass: (alpha_hat[B,L,S], log_c[B,L], loglik[B])
    with ``log_alpha = alpha_hat + log_c`` and every alpha_hat row at
    max 0.  The loglik sums the per-step increments in one reduction
    (not a running carry); zero-length rows get loglik 0.  ``dtype``:
    see ``_cast``."""
    log_start, log_trans, obs = _cast(dtype, log_start, log_trans, obs)
    B, L, S = obs.shape
    lengths = _lengths(lengths, B, L, obs.device)
    trans_exp = torch.exp(log_trans)
    a0 = log_start[None, :] + obs[:, 0]
    a0 = torch.where((lengths > 0)[:, None], a0, LOG_ZERO)
    a_hat, c0 = _renorm(a0)
    hats, incs = [a_hat], [c0]
    for t in range(1, L):
        a_hat, dm = _fwd_step(log_trans, trans_exp, a_hat, obs[:, t],
                              t < lengths, matmul)
        hats.append(a_hat)
        incs.append(dm)
    incs = torch.stack(incs, dim=1)                           # [B,L]
    loglik = (torch.log(torch.exp(a_hat).sum(dim=-1))
              + incs.sum(dim=1))
    loglik = torch.where(lengths > 0, loglik, 0.0)
    return torch.stack(hats, dim=1), torch.cumsum(incs, dim=1), loglik


def backward_scaled(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None = None,
    matmul: bool = True,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scaled backward pass: (beta_hat[B,L,S], log_d[B,L]) with
    ``log_beta = beta_hat + log_d``; beta at the last valid position is
    exactly 0.  ``dtype``: see ``_cast``."""
    log_trans, obs = _cast(dtype, log_trans, obs)
    B, L, S = obs.shape
    lengths = _lengths(lengths, B, L, obs.device)
    log_trans_T = log_trans.T.contiguous()
    trans_exp_T = torch.exp(log_trans_T)
    b_hat = torch.zeros((B, S), dtype=obs.dtype, device=obs.device)
    hats = [b_hat]
    incs = [torch.zeros((B,), dtype=obs.dtype, device=obs.device)]
    for t in range(L - 2, -1, -1):
        b_hat, dm = _bwd_step(log_trans_T, trans_exp_T, b_hat,
                              obs[:, t + 1], t + 1 < lengths, matmul)
        hats.append(b_hat)
        incs.append(dm)
    beta_hat = torch.stack(hats[::-1], dim=1)
    incs = torch.stack(incs[::-1], dim=1)                     # [B,L]
    log_d = torch.flip(torch.cumsum(torch.flip(incs, [1]), dim=1), [1])
    return beta_hat, log_d


def posterior_scaled(alpha_hat: torch.Tensor,
                     beta_hat: torch.Tensor) -> torch.Tensor:
    """gamma from scaled quantities by per-position normalization, so no
    cumulative normalizer enters (accuracy independent of length)."""
    x = alpha_hat + beta_hat
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def forward(log_start, log_trans, obs, lengths=None, matmul=True):
    """Unscaled forward: (log_alpha[B,L,S], loglik[B])."""
    alpha_hat, log_c, loglik = forward_scaled(log_start, log_trans, obs,
                                              lengths, matmul)
    return alpha_hat + log_c[:, :, None], loglik


def backward(log_trans, obs, lengths=None, matmul=True):
    """Unscaled backward: log_beta[B,L,S]."""
    beta_hat, log_d = backward_scaled(log_trans, obs, lengths, matmul)
    return beta_hat + log_d[:, :, None]


def posterior(log_alpha, log_beta, loglik):
    """gamma[b,l,s] = P(state_l = s | obs) from the unscaled scans."""
    return torch.exp(torch.clamp(
        log_alpha + log_beta - loglik[:, None, None], max=0.0))


# ---------------------------------------------------------------------
# carried chunk continuations (whole-chromosome scoring and the exact
# chunked posteriors).  Each runs the same _fwd_step / _bwd_step as the
# monolithic scans, so a chunked sweep is bit-identical to
# forward_scaled / backward_scaled over the whole row.
# ---------------------------------------------------------------------

def forward_final(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    alpha_hat_init: torch.Tensor,
    lengths: torch.Tensor | None = None,
    matmul: bool = True,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward continuation from a carry: every position of the chunk
    applies a transition first.  Returns (final carry f32[B, S], the
    chunk's summed normalizer increments f32[B]); the increments are
    summed in one reduction, not a running carry.  ``dtype``: see
    ``_cast``."""
    log_trans, obs, alpha_hat_init = _cast(dtype, log_trans, obs,
                                           alpha_hat_init)
    B, Lc, S = obs.shape
    lengths = _lengths(lengths, B, Lc, obs.device)
    trans_exp = torch.exp(log_trans)
    a_hat = alpha_hat_init
    dms = []
    for t in range(Lc):
        a_hat, dm = _fwd_step(log_trans, trans_exp, a_hat, obs[:, t],
                              t < lengths, matmul)
        dms.append(dm)
    if not dms:
        return a_hat, torch.zeros((B,), dtype=obs.dtype, device=obs.device)
    return a_hat, torch.stack(dms, dim=1).sum(dim=1)


def streaming_loglik(
    log_start: torch.Tensor,
    log_trans: torch.Tensor,
    obs_chunks,
    lengths_per_chunk=None,
    final_fn=None,
) -> torch.Tensor:
    """Exact log-likelihood f32[B] of arbitrarily long rows from an
    iterator of obs chunks (each f32[B, Lc, S]), in O(B·S) memory.

    ``lengths_per_chunk``: optional iterable of int[B] valid lengths per
    chunk (rows may end mid-stream); zero-length rows get loglik 0.
    ``final_fn``: the forward continuation, ``forward_final`` by default
    (the score passes ``ops.cuda_kernels.forward_loglik``, which takes
    int32 lengths)."""
    final_fn = final_fn or forward_final
    it = iter(obs_chunks)
    lens_it = iter(lengths_per_chunk) if lengths_per_chunk is not None \
        else None
    first = next(it)
    dev = first.device

    def as_lens(x):
        return torch.as_tensor(x, device=dev).to(torch.int32)

    lens0 = as_lens(next(lens_it)) if lens_it is not None else None
    a0 = log_start[None, :] + first[:, 0, :]
    row_lens = None
    if lens0 is not None:
        row_lens = lens0.to(torch.int64)
        a0 = torch.where((row_lens > 0)[:, None], a0, LOG_ZERO)
    a_hat, m0 = _renorm(a0)
    rest_lens = None if lens0 is None else torch.clamp(lens0 - 1, min=0)
    if rest_lens is None:
        rest_lens = torch.full((first.shape[0],), first.shape[1] - 1,
                               dtype=torch.int32, device=dev)
    a_hat, dm = final_fn(log_trans, first[:, 1:, :].contiguous(), a_hat,
                         rest_lens)
    total = m0 + dm
    for chunk in it:
        if lens_it is not None:
            lens = as_lens(next(lens_it))
            row_lens = row_lens + lens
        else:
            lens = torch.full((chunk.shape[0],), chunk.shape[1],
                              dtype=torch.int32, device=dev)
        a_hat, dm = final_fn(log_trans, chunk, a_hat, lens)
        total = total + dm
    total = total + torch.log(torch.exp(a_hat).sum(dim=-1))
    if row_lens is not None:
        total = torch.where(row_lens > 0, total, 0.0)
    return total


def forward_chunk_values(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    a_hat_init: torch.Tensor,
    lengths: torch.Tensor | None = None,
    matmul: bool = True,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position scaled alphas of one chunk from its incoming carry
    (every position applies a transition first).  Returns
    (alpha_hats f32[B, Lc, S], final carry f32[B, S]).  ``dtype``: see
    ``_cast``."""
    log_trans, obs, a_hat_init = _cast(dtype, log_trans, obs, a_hat_init)
    B, Lc, S = obs.shape
    lengths = _lengths(lengths, B, Lc, obs.device)
    trans_exp = torch.exp(log_trans)
    a_hat = a_hat_init
    hats = []
    for t in range(Lc):
        a_hat, _ = _fwd_step(log_trans, trans_exp, a_hat, obs[:, t],
                             t < lengths, matmul)
        hats.append(a_hat)
    return torch.stack(hats, dim=1), a_hat


def forward_checkpoints(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    a_hat_init: torch.Tensor,
    lengths: torch.Tensor | None = None,
    chunk: int = 1,
) -> torch.Tensor:
    """The carry leaving every chunk of ``chunk`` positions:
    f32[B, ceil(L / chunk), S], row c the ``forward_final`` carry of
    chunks 0..c chained (the exact posteriors' forward sweep over a group
    of chunks; ``lengths`` count valid positions over all L)."""
    B, L, S = obs.shape
    lengths = _lengths(lengths, B, L, obs.device)
    a_hat, rows = a_hat_init, []
    for c0 in range(0, L, chunk):
        a_hat, _ = forward_final(log_trans, obs[:, c0:c0 + chunk], a_hat,
                                 torch.clamp(lengths - c0, 0, chunk))
        rows.append(a_hat)
    if not rows:
        return obs.new_empty((B, 0, S))
    return torch.stack(rows, dim=1)


# ---------------------------------------------------------------------
# the piece-operator scan: forward_final's function, sequence-parallel
# within a chunk (Särkkä & García-Fernández; across devices the JAX
# package's parallel/seqpar.py).  The plain version of the card's
# fwd_piece_ops and fwd_piece_compose kernels (csrc/posterior.cu).
# ---------------------------------------------------------------------

# Positions a piece, here and in the kernels (the wrapper passes it): a
# constant, so the bits depend on the inputs and S alone.  sqrt(16384)
# balances the two phases at ``MultitrackHmm.score``'s default chunk.
PIECE = 128


def piece_operators(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None = None,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase A: each piece's operator.  The chunk's positions are cut
    into pieces of PIECE; for each (row b, piece p, state i) the chain
    of ``_fwd_step`` runs over the piece from e_i (0 at i, LOG_ZERO
    elsewhere), steps at or past the row's length carried (a piece past
    it is the identity).  Returns (probs [B, n_p, S, S], the probability
    rows exp(a_hat) at max 1, and log_scale f64[B, n_p, S], the sum n_i
    of row i's increments): in log space the operator is
    log M[i, j] = log probs[i, j] + n_i.  The increments are summed in
    float64, as the kernel does: a float32 n of a piece (|n| ~ 1e3)
    would hold only ~6e-5 of it, an error that reaches the loglik and,
    where rows mix, the carry."""
    log_trans, obs = _cast(dtype, log_trans, obs)
    B, Lc, S = obs.shape
    lengths = torch.clamp(_lengths(lengths, B, Lc, obs.device), max=Lc)
    n_p = -(-Lc // PIECE)
    obs_p = torch.nn.functional.pad(obs, (0, 0, 0, n_p * PIECE - Lc))
    obs_p = obs_p.reshape(B, n_p, PIECE, S)
    trans_exp = torch.exp(log_trans)
    eye = torch.full((S, S), LOG_ZERO, dtype=obs.dtype, device=obs.device)
    eye.fill_diagonal_(0.0)
    a_hat = eye.expand(B, n_p, S, S).reshape(-1, S)          # (b, p, i)
    n = torch.zeros((B * n_p * S,), dtype=torch.float64, device=obs.device)
    starts = torch.arange(n_p, device=obs.device) * PIECE
    for t in range(PIECE):
        valid = (starts[None, :] + t < lengths[:, None])[:, :, None]
        valid = valid.expand(B, n_p, S).reshape(-1)
        o = obs_p[:, :, t, None, :].expand(B, n_p, S, S).reshape(-1, S)
        a_hat, dm = _fwd_step(log_trans, trans_exp, a_hat, o, valid, True)
        n = n + dm.to(torch.float64)
    return (torch.exp(a_hat).reshape(B, n_p, S, S),
            n.reshape(B, n_p, S))


def compose_pieces(
    probs: torch.Tensor,
    log_scale: torch.Tensor,
    a_hat_init: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase B: the pieces composed in order behind the incoming carry.
    Piece p takes x_i = a_i + n_{p,i} (float64), c = max x, and runs the
    forward step's log-dot with its probability rows as the matrix on
    exp(x - c); its increment is c plus the step's normalizer.  Pieces
    at or past a row's length are skipped (the carry passes through
    unchanged, increment 0).  Returns (final carry [B, S], increments
    f64[B, n_p])."""
    B, n_p, S, _ = probs.shape
    lengths = _lengths(lengths, B, n_p * PIECE, probs.device)
    a_hat = a_hat_init.to(probs.dtype)
    incs = []
    for p in range(n_p):
        live = p * PIECE < lengths
        x = a_hat.to(torch.float64) + log_scale[:, p]
        c = x.amax(dim=-1)
        e = torch.exp((x - c[:, None]).to(probs.dtype))
        s = torch.bmm(e[:, None, :], probs[:, p])[:, 0]
        new_hat, m = _renorm(torch.where(s > 0, torch.log(s), LOG_ZERO))
        a_hat = _mask_carry(new_hat, a_hat, live)
        incs.append(torch.where(live, c + m.to(torch.float64), 0.0))
    if not incs:
        return a_hat, torch.zeros((B, 0), dtype=torch.float64,
                                  device=probs.device)
    return a_hat, torch.stack(incs, dim=1)


def forward_loglik_pieces(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    a_hat_init: torch.Tensor,
    lengths: torch.Tensor | None = None,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``forward_final``'s function by the piece-operator scan: phase A
    (``piece_operators``) then phase B (``compose_pieces``).  Returns
    (final carry [B, S], the chunk's summed increments [B], summed in
    float64 and returned in the inputs' dtype).  ``dtype``: see
    ``_cast``."""
    log_trans, obs, a_hat_init = _cast(dtype, log_trans, obs, a_hat_init)
    probs, log_scale = piece_operators(log_trans, obs, lengths)
    a_hat, incs = compose_pieces(probs, log_scale, a_hat_init, lengths)
    return a_hat, incs.sum(dim=1).to(obs.dtype)


def backward_chunk_values(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    x_carry: torch.Tensor,
    continuing: torch.Tensor,
    lengths: torch.Tensor | None = None,
    matmul: bool = True,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position scaled betas of one chunk from its incoming carry.

    ``x_carry`` f32[B, S] is the max-normalized ``obs + beta`` row at the
    NEXT chunk's first position; ``continuing`` bool[B] marks rows that
    extend past this chunk (the others start from beta = 0 at their last
    valid position, as the monolithic scan does); ``lengths`` are the
    valid positions within this chunk.  The boundary step and ``x_out``
    are the two halves of ``_bwd_step``.

    Returns (beta_hats f32[B, Lc, S], x_out f32[B, S]: the carry for the
    previous chunk, taken at this chunk's first position).  ``dtype``:
    see ``_cast``."""
    log_trans, obs, x_carry = _cast(dtype, log_trans, obs, x_carry)
    B, Lc, S = obs.shape
    lengths = _lengths(lengths, B, Lc, obs.device)
    log_trans_T = log_trans.T.contiguous()
    trans_exp_T = torch.exp(log_trans_T)
    b_cont, _ = _renorm(_logdot(x_carry, log_trans_T, trans_exp_T, matmul))
    b_hat = torch.where(continuing.to(torch.bool)[:, None], b_cont,
                        torch.zeros_like(b_cont))
    hats = [b_hat]
    for t in range(Lc - 2, -1, -1):
        b_hat, _ = _bwd_step(log_trans_T, trans_exp_T, b_hat,
                             obs[:, t + 1], t + 1 < lengths, matmul)
        hats.append(b_hat)
    beta_hat = torch.stack(hats[::-1], dim=1)
    x_out, _ = _renorm(obs[:, 0] + beta_hat[:, 0])
    return beta_hat, x_out


def backward_checkpoints(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    x_carry: torch.Tensor,
    continuing: torch.Tensor,
    lengths: torch.Tensor | None = None,
    chunk: int = 1,
) -> torch.Tensor:
    """The x_out of every chunk of ``chunk`` positions:
    f32[B, ceil(L / chunk), S], row c that of ``backward_chunk_values``
    chained from the last chunk to chunk c (the exact posteriors' backward
    sweep over a group of chunks; ``lengths`` count valid positions over
    all L, ``continuing`` says whether a row runs past the L positions, and
    inside them chunk c continues where the row's length passes its
    end)."""
    B, L, S = obs.shape
    lengths = _lengths(lengths, B, L, obs.device)
    n_ck = -(-L // chunk)
    x, rows = x_carry, [None] * n_ck
    for c in reversed(range(n_ck)):
        c0 = c * chunk
        cont = continuing if c == n_ck - 1 else lengths > c0 + chunk
        lens = torch.clamp(lengths - c0, 0, chunk)
        _, x = backward_chunk_values(log_trans, obs[:, c0:c0 + chunk], x,
                                     cont, lens)
        rows[c] = x
    if not rows:
        return obs.new_empty((B, 0, S))
    return torch.stack(rows, dim=1)


def _maxplus_step(log_trans: torch.Tensor, v_hat: torch.Tensor,
                  obs_row: torch.Tensor, valid_t: torch.Tensor
                  ) -> torch.Tensor:
    """The canonical max-plus step shared by viterbi_carry and
    viterbi_chunk_values: best_j = max_i(v_i + trans[i, j]), add obs,
    renormalize, mask."""
    best = (v_hat[:, :, None] + log_trans[None, :, :]).amax(dim=1)
    new_hat, _ = _renorm(best + obs_row)
    return _mask_carry(new_hat, v_hat, valid_t)


def _backtrace_step(log_trans: torch.Tensor, v_prev: torch.Tensor,
                    state: torch.Tensor, valid_t: torch.Tensor
                    ) -> torch.Tensor:
    """argmax_i(v_prev[i] + trans[i, state]), first hit; held at
    ``state`` where the position is padding."""
    col = log_trans.T[state]                                  # [B, S]
    prev = torch.argmax(v_prev + col, dim=-1)
    return torch.where(valid_t, prev, state)


def viterbi(
    log_start: torch.Tensor,
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-plus Viterbi DP + backtrace.

    Returns (path int32[B, L], score f32[B]).  Entries at t >= length
    replicate the state at length-1; zero-length rows get path 0 and
    score 0."""
    B, L, S = obs.shape
    lengths = _lengths(lengths, B, L, obs.device)
    nonempty = lengths > 0

    v0 = log_start[None, :] + obs[:, 0]
    v0_hat, m = _renorm(v0)

    if L == 1:
        # no transitions: the path is the best start-weighted state
        score = torch.where(nonempty, v0.amax(dim=-1), 0.0)
        path = torch.where(nonempty, torch.argmax(v0, dim=-1), 0)
        return path.to(torch.int32)[:, None], score

    rows = [v0_hat]
    v_hat = v0_hat
    for t in range(1, L):
        best = (v_hat[:, :, None] + log_trans[None, :, :]).amax(dim=1)
        new_hat, dm = _renorm(best + obs[:, t])
        valid_t = t < lengths
        v_hat = _mask_carry(new_hat, v_hat, valid_t)
        m = torch.where(valid_t, m + dm, m)
        rows.append(v_hat)
    score = v_hat.amax(dim=-1) + m

    state = torch.argmax(v_hat, dim=-1)
    path = torch.empty((B, L), dtype=torch.int64, device=obs.device)
    for t in range(L - 1, 0, -1):
        path[:, t] = state
        state = _backtrace_step(log_trans, rows[t - 1], state,
                                t < lengths)
    path[:, 0] = state
    score = torch.where(nonempty, score, 0.0)
    path = torch.where(nonempty[:, None], path, 0)
    return path.to(torch.int32), score


def viterbi_carry(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    v_hat_init: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Max-plus forward continuation: only the final carry f32[B, S]
    (the cheap first sweep of checkpointed Viterbi)."""
    B, Lc, S = obs.shape
    lengths = _lengths(lengths, B, Lc, obs.device)
    v_hat = v_hat_init
    for t in range(Lc):
        v_hat = _maxplus_step(log_trans, v_hat, obs[:, t], t < lengths)
    return v_hat


def viterbi_checkpoints(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    v_hat_init: torch.Tensor,
    lengths: torch.Tensor | None = None,
    chunk: int = 1,
) -> torch.Tensor:
    """The carry leaving every chunk of ``chunk`` positions:
    f32[B, ceil(L / chunk), S], row c the ``viterbi_carry`` of chunks
    0..c chained (the exact decoder's forward sweep over a group of
    chunks; ``lengths`` count valid positions over all L)."""
    B, L, S = obs.shape
    lengths = _lengths(lengths, B, L, obs.device)
    v_hat, rows = v_hat_init, []
    for c0 in range(0, L, chunk):
        v_hat = viterbi_carry(log_trans, obs[:, c0:c0 + chunk], v_hat,
                              torch.clamp(lengths - c0, 0, chunk))
        rows.append(v_hat)
    if not rows:
        return obs.new_empty((B, 0, S))
    return torch.stack(rows, dim=1)


def viterbi_chunk_values(
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    v_hat_init: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Every per-position max-plus value row of one chunk from its
    incoming carry: f32[B, Lc, S], where row t holds the values AT chunk
    position t (position 0 already includes one transition from the
    carry)."""
    B, Lc, S = obs.shape
    lengths = _lengths(lengths, B, Lc, obs.device)
    v_hat = v_hat_init
    rows = []
    for t in range(Lc):
        v_hat = _maxplus_step(log_trans, v_hat, obs[:, t], t < lengths)
        rows.append(v_hat)
    return torch.stack(rows, dim=1)


def viterbi_backtrace_chunk(
    log_trans: torch.Tensor,
    v_hats: torch.Tensor,       # [B, Lc, S] from viterbi_chunk_values
    v_carry_in: torch.Tensor,   # [B, S] carry that entered this chunk
    end_state: torch.Tensor,    # int[B] state at the last valid position
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backtrace one chunk given its end state.

    Returns (path int32[B, Lc], entry_state int32[B]) where entry_state
    is the optimal state at the previous chunk's last position (computed
    against ``v_carry_in``)."""
    B, Lc, S = v_hats.shape
    lengths = _lengths(lengths, B, Lc, v_hats.device)
    state = end_state.to(torch.int64)
    path = torch.empty((B, Lc), dtype=torch.int64, device=v_hats.device)
    for t in range(Lc - 1, -1, -1):
        path[:, t] = state
        v_prev = v_hats[:, t - 1] if t > 0 else v_carry_in
        state = _backtrace_step(log_trans, v_prev, state, t < lengths)
    return path.to(torch.int32), state.to(torch.int32)


# ---------------------------------------------------------------------
# the obs-space streaming engine (K5) and the prob-space split (K6)
# ---------------------------------------------------------------------

def scaled_obs_prob(obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """obs f32[..., L, S] -> (obs_p, o_m): obs_p = exp(obs - max_s obs)
    in [0, 1] with a 1 at every position, and o_m f32[..., L] the max the
    prob-space forward's normalizers leave out."""
    o_m = obs.amax(dim=-1)
    return torch.exp(obs - o_m[..., None]), o_m


def viterbi_streaming(
    log_start: torch.Tensor,
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Viterbi over a precomputed obs tensor through the streaming value
    kernel: (path int32[B, L], score f32[B]) with ``viterbi``'s paths
    (first-hit argmax, lowest state index) and its score to float32
    rounding (max of the last row plus the summed normalizers, one
    reduction).  Zero-length rows get path 0 and score 0.

    Counterpart of ``viterbi_pallas_v3`` (tehmm_tpu/ops/pallas_kernels.py
    :1452): the value rows come from ``cuda_kernels.viterbi_values`` (K5;
    its plain version on CPU tensors), any S up to 1024.  The backtrace,
    an XLA scan outside the kernel in the JAX package, is
    ``cuda_kernels.viterbi_backtrace`` (on the card a warp a row, at
    every S the value kernel takes; its plain version, the batched torch
    loop ``viterbi_backtrace_chunk``, on CPU tensors)."""
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    B, L, S = obs.shape
    lens = _lengths(lengths, B, L, obs.device).to(torch.int32)
    v_hats, dm = ck.viterbi_values(log_start.contiguous(),
                                   log_trans.contiguous(),
                                   obs.contiguous(), lens)
    last = v_hats[:, L - 1]
    nonempty = lens > 0
    score = torch.where(nonempty, last.amax(dim=-1) + dm.sum(dim=1), 0.0)
    end_state = torch.argmax(last, dim=-1).to(torch.int32)
    body_lens = torch.clamp(lens - 1, min=0)
    body, first = ck.viterbi_backtrace(log_trans.contiguous(), v_hats[:, 1:],
                                       v_hats[:, 0], end_state, body_lens)
    path = torch.cat([first[:, None], body], dim=1)
    return torch.where(nonempty[:, None], path, 0), score


def viterbi_backpointers(
    log_start: torch.Tensor,
    log_trans: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Viterbi over a precomputed obs tensor through the pointer-writing
    kernel: (path int32[B, L], score f32[B]) with ``viterbi``'s paths and
    its score to float32 rounding (max of the last row plus the summed
    normalizers, one reduction).  Zero-length rows get path 0 and score
    0.

    Counterpart of ``viterbi_pallas`` (tehmm_tpu/ops/pallas_kernels.py
    :333): ``cuda_kernels.viterbi_pointers`` (K8c) writes the argmax
    predecessors and the last value row, ``cuda_kernels.pointer_chase``
    follows them back (the XLA scan of the JAX function); their plain
    versions on CPU tensors.  Any S up to 1024: the pointers are uint8 to
    256 states and uint16 beyond (``cuda_kernels.pointer_dtype``)."""
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    B, L, S = obs.shape
    lens = _lengths(lengths, B, L, obs.device).to(torch.int32)
    ptrs, v_last, dm = ck.viterbi_pointers(log_start.contiguous(),
                                           log_trans.contiguous(),
                                           obs.contiguous(), lens)
    score = torch.where(lens > 0, v_last.amax(dim=-1) + dm.sum(dim=1), 0.0)
    return ck.pointer_chase(ptrs, v_last, lens), score
