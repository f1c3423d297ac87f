#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, and the run exits non-zero):

1. Device and build: the card's name and power limit, and the build of
   the CUDA kernels from ``tehmm_tpu_torch/csrc/*.cu`` (one nvcc per
   source, in parallel).
2. Each kernel against its plain-torch version on the card.  The decode
   kernels (K2, K3) at the decode's shapes (S=10 states, T=5 tracks, V=9
   symbols, B=512 rows of L=4608 = chunk 4096 + 2 x 256 halo, ragged
   lengths incl. 0 and 1): value rows, normalizers, carries and paths
   bit-equal.  The E-step kernels (K1) at bench.py's shape (S=20, T=5,
   V=8, B=2048, L=1024, ragged lengths incl. 0, 1 and 2): statistics and
   logliks within the JAX package's engine tolerances of the plain
   version and of the plain log-space E-step, and bit-identical across
   two launches.  (K1 is checked again at the EM run's own shape in 3b.)
   The K4 decode at the stitched max-posterior decode's shape (S=10,
   T=5, V=9, 64 rows of L=4608, ragged lengths incl. 0 and 1): paths
   agree on >= 99.999% of positions, every differing position a
   near-tie (the plain version's top two alpha_p * b within 1e-5
   relative), two launches bit-identical.  The chunk sweeps X1 and X2
   on obs of 4 rows of 4096 (ragged): hats within 1e-5 absolute,
   carries, x_out and the summed normalizers within 1e-6 relative, two
   launches bit-identical.  Then K2's forward, K1 and the K4 decode
   with each optional observation stream (segment weights in [1, 64],
   2 gaussian tracks with 10% missing values, both) at the same shapes:
   K2's value rows, normalizers and paths bit-equal, K1 at the same
   tolerances (gaussian moments within 1e-4 of each moment's largest
   entry) and bit-identical across two launches, K4 as above.  Times of
   both sides for every kernel and variant, beside the least time the
   card could take for the same work.  The streaming kernels K5
   (``viterbi_values``), K6a (``fwd_prob``) and K6b (``bwd_prob``) on the
   obs tensors of all four ``bench_engines`` shapes (S=20, T=5, V=8,
   B=2048; S=64, T=10, V=12, B=1024; S=128, T=15, V=16, B=512; S=256,
   T=20, V=16, B=256; L=1024, ragged lengths incl. 0, 1 and 2): K5's
   value rows and normalizers, the backtrace on them and the paths of
   ``dp.viterbi_streaming`` bit-equal to plain and to ``dp.viterbi``;
   alpha_p and beta_p within 2e-6 absolute of the plain version carried
   in float64, normalizers within 1e-5, row logliks within 1e-5
   relative of the float32 plain version, two launches bit-identical.
2e. The engine-comparison path through its tools' entry points, at the
   full width of all four ``bench_engines`` shapes (S=20, 64, 128, 256):
   ``tools.bench_engines`` with the E-step engines plain, cuda (K1) and
   cuda_v3 (K6), then ``--decode`` with plain, streaming (K5) and fused
   (K2), then ``tools.profile_estep`` at S=64.  Every pair of engines that
   ran agrees on the loglik within 1e-4 relative and on every position
   of the path; cuda_v3 and streaming ran at all four shapes; a row with
   an ``error`` is accepted only from cuda or fused at S=128 or S=256 and
   only with the shared-memory envelope's message; K5, K6 and the
   backtrace launched at every shape.
3. End to end through the port's CLIs, in-process, at the width of the
   10-state / 5-track supervised decode configuration: a planted
   20,000,000-position chromosome (4 categorical BED tracks + FASTA),
   ``train --supervised`` then stitched ``eval --bed`` on the whole
   chromosome; the BED tiles it, every stitch boundary agrees, and base
   accuracy against the planted truth is >= 0.9.  On a 1,000,000-position
   region ``--exact`` and ``--no-exact`` write the same BED, and on a
   20,000-position region the card's BED equals the CPU's (plain torch).
3d. Max-posterior decoding, ``--pd`` and scoring through ``eval`` with
   phase 3's model: stitched ``--maxPost --bed`` on the whole chromosome
   (K4, and the printed forward loglik through X1): the BED tiles it,
   every stitch boundary agrees, base accuracy >= 0.9, and the loglik is
   finite and at least phase 3's Viterbi path score (less 1e-6 of it).
   On the 1,000,000-position region ``--maxPost --exact`` (X1/X2) and
   ``--no-exact`` (K4) agree on >= 99.999% of bases; on the
   20,000-position region the card and the CPU agree for ``--maxPost``
   (both decoders: >= 99.999% of bases), ``--pd`` (same rows,
   probabilities within 1e-5) and every printed score (1e-5 relative);
   on a 100,000-position region the card's ``--pd`` rows sum to 1
   within 1e-5 and their argmax is the ``--maxPost --exact`` BED.  Stage
   times: load, decode, score, ``--pd`` write.
3b. Unsupervised EM through ``train`` (no ``--supervised``) on the same
   chromosome, 10 states, 15 iterations, chunks of 16384: every logged
   loglik finite and non-decreasing within 1e-4 |loglik|; K1 against
   its plain version at this shape (the learned model, 256 of the
   staged rows of 16384, ragged lengths), at phase 2's tolerances; the
   model decoded with ``eval --bed``; base accuracy after mapping each learned
   state to its majority planted state (printed, not asserted); stage
   times.
3c. The card against the CPU on a 50,000-position region: the same EM
   command on both; per-iteration logliks within 1e-5 relative, learned
   start probabilities within 1e-4 and every learned transition and
   emission probability of state s within 0.5 / n_s clipped to [1e-4,
   1e-3], n_s the positions the CPU's decode gives the state (half an
   expected count behind the row); a state with n_s < 500, whose limit
   would pass 1e-3, is not held and is printed as skipped, and the held
   states must cover >= 90% of the region; decoded BED agreeing on
   >= 99.9% of bases; then ``--reps 2`` on the card, through K1 for both
   restarts.
3e. Gaussian tracks and segment mode on the same chromosome, with one
   gaussian BED track (a record per 500 bases, its value ~ N(mu[state],
   1)).  Base resolution (the phase-3 tracks and the gaussian track):
   ``train --supervised`` and stitched ``eval --bed`` (K2 with the
   gaussian stream); every boundary agrees and base accuracy >= 0.9;
   stitched ``--maxPost`` on the 1,000,000-position region (K1's forward
   and K4 with the gaussian stream; base accuracy >= 0.9); EM on a
   50,000-position region (K1 with the gaussian stream) on the card and
   the CPU, logliks within 1e-5 relative; on the 20,000-position region
   the card's BED and printed score equal the CPU's (1e-5 relative).  Segment mode (the 4 BED tracks and the
   gaussian track): ``segment_tracks`` on the whole chromosome (segment
   count and compression printed), ``train --segment --segLen`` (10
   states, 15 iterations; K1 with both streams; every loglik finite and
   non-decreasing within 1e-4 |loglik|), ``eval --segment --segLen
   --bed`` stitched (K2 with both streams) and ``--maxPost`` (K4 with
   both streams), base accuracy after the majority mapping and the
   printed scores.  On a 200,000-position region the card against the
   CPU in segment mode, with the gaussian track and with the categorical
   tracks only (the weight stream alone): EM logliks within 1e-5
   relative, BED agreeing on >= 99.9% of bases.  Stage times.
4. The launch counters, zeroed just before each tool run of 2e, phase
   3, 3d, 3b's training run, and 3e's base-resolution, segment and
   categorical segment runs and read just after each, show every kernel
   and stream variant of each path ran on it.

The last lines are a JSON object of per-kernel results, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Without CUDA it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

S, T, V = 10, 5, 9                   # states, tracks, symbols (+missing)
B_ROWS, L_ROWS = 512, 4096 + 2 * 256  # one decode group
GC = np.linspace(0.3, 0.7, S)        # per-state GC content
N_CATS, BLOCK = 8, 50                # BED categories, bases per record
RUN_MEAN = 2000                      # mean planted run length
N_POSITIONS = 20_000_000             # the planted chromosome of phase 3
K1_S, K1_T, K1_V, K1_B, K1_L = 20, 5, 8, 2048, 1024   # bench.py's E-step
EM_STATES, EM_ITERS, EM_CHUNK = 10, 15, 16384
K1_EM_ROWS = 256                     # rows of the K1 check at EM's shape
K4_B, K4_L = 64, 4096 + 2 * 256      # one stitched max-posterior group
X_B, X_L = 4, 4096                   # the chunk sweeps' check
NEAR_TIE = 1e-5                      # K4: relative gap of a near-tie
STREAM_VARIANTS = ("+w", "+g", "+wg")  # weights, gaussian tracks, both
STREAM_G = 2                         # gaussian tracks of phase 2's streams
W_LO, W_HI = 1.0, 64.0               # phase 2's segment weights
GAUSS_RECORD = 500                   # 3e: bases per gaussian-track record
GAUSS_MU = np.linspace(-4.5, 4.5, S)  # 3e: that track's per-state mean
SEG_STATES, SEG_ITERS = 10, 15       # 3e: segment-mode EM
# the card's published peaks (H100 SXM datasheet: HBM3
# at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s)
H100_BYTES_PER_S, H100_F32_PER_S = 3.35e12, 67e12
SOURCES = {
    "viterbi_fwd": "tehmm_tpu_torch/csrc/viterbi.cu",
    "viterbi_backtrace": "tehmm_tpu_torch/csrc/viterbi.cu",
    "viterbi_chunk_values": "tehmm_tpu_torch/csrc/viterbi.cu",
    "em_fwd": "tehmm_tpu_torch/csrc/em_estep.cu",
    "em_bwd_stats": "tehmm_tpu_torch/csrc/em_estep.cu",
    "post_decode": "tehmm_tpu_torch/csrc/posterior.cu",
    "fwd_chunk": "tehmm_tpu_torch/csrc/posterior.cu",
    "bwd_chunk": "tehmm_tpu_torch/csrc/posterior.cu",
    "viterbi_values": "tehmm_tpu_torch/csrc/streaming.cu",
    "fwd_prob": "tehmm_tpu_torch/csrc/streaming.cu",
    "bwd_prob": "tehmm_tpu_torch/csrc/streaming.cu",
}
REPLACES = {
    "viterbi_fwd": "tehmm_tpu/ops/pallas_kernels.py:2386",
    "viterbi_backtrace": "tehmm_tpu/ops/pallas_kernels.py:2517",
    "viterbi_chunk_values": "tehmm_tpu/ops/pallas_kernels.py:1284",
    "em_fwd": "tehmm_tpu/ops/pallas_kernels.py:1777",
    "em_bwd_stats": "tehmm_tpu/ops/pallas_kernels.py:1931",
    "post_decode": "tehmm_tpu/ops/pallas_kernels.py:2765",
    # X1 and X2 have no Pallas counterpart: the XLA scans they replace
    "fwd_chunk": "tehmm_tpu/ops/dp.py:378",
    "bwd_chunk": "tehmm_tpu/ops/dp.py:507",
    # K5 (viterbi_pallas_v3's value sweep), K6a, K6b
    "viterbi_values": "tehmm_tpu/ops/pallas_kernels.py:1374",
    "fwd_prob": "tehmm_tpu/ops/pallas_kernels.py:815",
    "bwd_prob": "tehmm_tpu/ops/pallas_kernels.py:885",
}
DECODE_KERNELS = ("viterbi_fwd", "viterbi_backtrace", "viterbi_chunk_values")
EM_KERNELS = ("em_fwd", "em_bwd_stats")
POST_KERNELS = ("em_fwd", "post_decode", "fwd_chunk", "bwd_chunk")
# 3e's paths: base resolution with a gaussian track (+g), segment mode
# with the gaussian track (+wg) and with categorical tracks only (+w)
GAUSS_BASE_KERNELS = ("viterbi_fwd+g", "viterbi_backtrace", "em_fwd+g",
                      "em_bwd_stats+g", "post_decode+g")
SEGMENT_KERNELS = ("em_fwd", "em_bwd_stats", "viterbi_fwd", "post_decode")
# 2e: the engine-comparison path; phase 2 checks K5/K6 and the backtrace
# under dp.viterbi_streaming at each of its shapes
STREAMING_KERNELS = ("viterbi_values", "fwd_prob", "bwd_prob")
ENGINE_CONFIGS = ("S20", "S64", "S128", "S256")
ENGINE_ITERS = 1                     # marginal_time chains of 1 and 6
ENVELOPE_MESSAGE = "beyond the shared-memory envelope"


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def _median_ms(fn, runs: int) -> float:
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _obs_ops(S, T, G, weighted):
    """float32 operations of one position's obs for all S states: T-1
    adds per state; with G gaussian tracks 3G feature products, then per
    state 3G coefficient products, 3G-3 block adds and 2 more; with
    weights one product per state."""
    ops = S * (T - 1)
    if G:
        ops += 3 * G + S * (6 * G - 1)
    if weighted:
        ops += S
    return ops


def _bound(name, shape, valid, G=0, weighted=False) -> dict:
    """bound_ms and bound_by of one call of kernel ``name`` at ``shape`` =
    (B, L, S, T, V) with ``valid`` valid positions: the larger of the
    bytes the function must move (each input read once, each output
    written once) over the HBM rate and its float32 operations (an exp
    or log counted as one) over the card's float32 peak; and library_ms:
    no single PyTorch call computes any of these functions."""
    B, L, S, T, V = shape
    f = 4
    tables = (S * S + S * T * V) * f
    streams = (B * L * f if weighted else 0) + \
        ((B * L * G + 2 * S * G) * f if G else 0)
    sym = (B * L * T + B) * f
    rows = B * L * S * f
    obs = _obs_ops(S, T, G, weighted)
    base = name.split("+")[0].split("@")[0]
    if base == "viterbi_fwd":          # max-plus step, obs, renormalise
        nbytes = sym + tables + S * f + streams + rows + B * L * f
        ops = 2 * S * S + obs + 2 * S
    elif base == "viterbi_backtrace":  # S adds and compares a position
        nbytes = S * S * f + rows + (B * S + 3 * B + B * L) * f
        ops = 2 * S
    elif base == "viterbi_chunk_values":
        nbytes = 2 * rows + (B * S + B + S * S) * f
        ops = 2 * S * S + 3 * S
    elif base == "em_fwd":             # obs_p, S x S product, scale
        nbytes = sym + tables + S * f + streams + rows + 2 * B * L * f
        ops = 2 * S * S + obs + 6 * S
    elif base == "em_bwd_stats":       # obs_p, b step, pair, counts
        nbytes = (sym + tables + streams + rows + B * L * f
                  + (S + S * S + S * T * V + 3 * S * G) * f)
        ops = 4 * S * S + obs + S * T + 6 * S * G + 10 * S
    elif base == "post_decode":        # obs_p, b step, argmax
        nbytes = sym + tables + streams + rows + B * L * f
        ops = 2 * S * S + obs + 8 * S
    elif base in ("fwd_chunk", "bwd_chunk"):   # log-space step
        nbytes = 2 * rows + (2 * B * S + 2 * B + S * S) * f
        ops = 2 * S * S + 4 * S
    elif base in ("viterbi_values", "fwd_prob"):
        # obs in, rows and normalizers out; product, obs, max, rescale
        nbytes = 2 * rows + (B * L + B + S * S + S) * f
        ops = 2 * S * S + 4 * S
    elif base == "bwd_prob":           # two maxes and rescales a step
        nbytes = 2 * rows + (B + S * S) * f
        ops = 2 * S * S + 7 * S
    else:
        raise KeyError(name)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = valid * ops / H100_F32_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------

def _decode_model(rng, device):
    """A sticky random model at the decode configuration's width."""
    from tehmm_tpu_torch.models.params import from_numpy

    trans = rng.dirichlet(np.ones(S), size=S) * 0.05 + np.eye(S) * 0.95
    log_em = np.zeros((S, T, V))
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    return from_numpy(np.log(np.full(S, 1.0 / S)), np.log(trans), log_em,
                      device)


def phase_kernels(device, rng) -> dict:
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    p = _decode_model(rng, device)
    lengths = rng.randint(0, L_ROWS + 1, size=B_ROWS).astype(np.int32)
    lengths[:4] = [L_ROWS, 0, 1, 2]
    sym = torch.from_numpy(
        rng.randint(0, V, size=(B_ROWS, L_ROWS, T)).astype(np.int32)
    ).to(device)
    lens = torch.from_numpy(lengths).to(device)
    fwd_args = (p.log_start, p.log_trans, p.log_em, sym, lens)
    out = {}

    # K2 forward
    v, dm = ck.viterbi_fwd(*fwd_args)
    pv, pdm = ck.viterbi_fwd_plain(*fwd_args)
    assert torch.equal(v, pv) and torch.equal(dm, pdm), \
        "viterbi_fwd disagrees with its plain version"
    out["viterbi_fwd"] = dict(
        max_abs_err=float(max((v - pv).abs().max(), (dm - pdm).abs().max())),
        ms=_median_ms(lambda: ck.viterbi_fwd(*fwd_args), 5),
        plain_ms=_median_ms(lambda: ck.viterbi_fwd_plain(*fwd_args), 3),
    )

    # K2 backtrace, on the forward's rows as viterbi_fused calls it
    end = torch.argmax(v[:, -1], dim=-1).to(torch.int32)
    body_lens = torch.clamp(lens - 1, min=0)
    rows, entry = v[:, 1:], v[:, 0]
    bt_args = (p.log_trans, rows, entry, end, body_lens)
    plain_args = (p.log_trans, rows.contiguous(), entry.contiguous(), end,
                  body_lens)
    got = ck.viterbi_backtrace(*bt_args)
    want = ck.viterbi_backtrace_plain(*plain_args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        "viterbi_backtrace disagrees with its plain version"
    out["viterbi_backtrace"] = dict(
        max_abs_err=float((got[0] - want[0]).abs().max()),
        ms=_median_ms(lambda: ck.viterbi_backtrace(*bt_args), 5),
        plain_ms=_median_ms(
            lambda: ck.viterbi_backtrace_plain(*plain_args), 3),
    )

    # K2 as a whole against dp.viterbi on the plain obs
    path, score = ck.viterbi_fused(*fwd_args)
    obs = track_log_likelihoods(p.log_em, sym)
    want_p, want_s = dp.viterbi(p.log_start, p.log_trans, obs, lens)
    assert torch.equal(path, want_p), "viterbi_fused path != dp.viterbi"
    # tree-order sum of the normalizers vs dp.viterbi's sequential one
    rel = float(((score - want_s).abs()
                 / want_s.abs().clamp(min=1.0)).max())
    assert rel < 1e-5, f"viterbi_fused score rel err {rel}"
    print(f"[kernels] fused decode: paths == dp.viterbi, score rel err "
          f"{rel:.3g}", flush=True)

    # K3, both modes
    init = torch.from_numpy(
        rng.randn(B_ROWS, S).astype(np.float32)).to(device)
    k3_args = (p.log_trans, obs, init, lens)
    got = ck.viterbi_chunk_values(*k3_args)
    want = dp.viterbi_chunk_values(*k3_args)
    carry, want_c = ck.viterbi_carry(*k3_args), dp.viterbi_carry(*k3_args)
    assert torch.equal(got, want) and torch.equal(carry, want_c), \
        "viterbi_chunk_values disagrees with its plain version"
    out["viterbi_chunk_values"] = dict(
        max_abs_err=float(max((got - want).abs().max(),
                              (carry - want_c).abs().max())),
        ms=_median_ms(lambda: ck.viterbi_chunk_values(*k3_args), 5),
        plain_ms=_median_ms(lambda: dp.viterbi_chunk_values(*k3_args), 3),
    )
    shape, valid = (B_ROWS, L_ROWS, S, T, V), int(lengths.sum())
    out["viterbi_fwd"].update(_bound("viterbi_fwd", shape, valid))
    out["viterbi_backtrace"].update(_bound(
        "viterbi_backtrace", (B_ROWS, L_ROWS - 1, S, T, V),
        int(np.clip(lengths - 1, 0, None).sum())))
    out["viterbi_chunk_values"].update(
        _bound("viterbi_chunk_values", shape, valid))
    for name, r in out.items():
        print(f"[kernels] {name:22s} bit-equal  kernel {r['ms']:10.3f} ms"
              f"  plain {r['plain_ms']:10.3f} ms", flush=True)
    return out


def _assert_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} values outside rtol {rtol} / atol "
        f"{atol}; max abs err {float(err.max()):.4g}")
    return float(err.max()) if err.numel() else 0.0


def _k1_against_plain(p, sym, lens):
    """em_fwd, em_bwd_stats and their composition against the plain
    versions on one input, within the stated tolerances, and two
    composed launches bit-identical.  Returns ({kernel: max abs err},
    {call: ms of that one synchronised call})."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck

    once = {}

    def timed(name, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(*a)
        torch.cuda.synchronize()
        once[name] = (time.perf_counter() - t0) * 1e3
        return result

    args = (p.log_start, p.log_trans, p.log_em, sym, lens)
    alpha, dm, m_raw = timed("em_fwd", ck.em_fwd, *args)
    p_alpha, p_dm, p_m = timed("em_fwd plain", ck.em_fwd_plain, *args)
    err = {"em_fwd": max(
        _assert_close("em_fwd alpha", alpha, p_alpha, 1e-5, 1e-6),
        _assert_close("em_fwd m_raw", m_raw, p_m, 1e-5, 0.0),
        _assert_close("em_fwd dm", dm, p_dm, 1e-5, 1e-5))}
    bwd_args = (p.log_trans, p.log_em, sym, lens, alpha, m_raw)
    got = timed("em_bwd_stats", ck.em_bwd_stats, *bwd_args)
    want = timed("em_bwd_stats plain", ck.em_bwd_stats_plain, *bwd_args)
    err["em_bwd_stats"] = max(
        _assert_close(f"em_bwd_stats {n}", g, w, 1e-4, a)
        for n, g, w, a in zip(("start", "pair", "em"), got, want,
                              (1e-5, 1e-5, 1e-4)))
    # the composed E-step, twice bit-identical, against the plain parts
    first = ck.em_counts_fused(*args)
    again = ck.em_counts_fused(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), \
        "two K1 runs on the same input differ"
    want = (*want, ck._loglik_rows(p_alpha, p_dm, lens))
    for n, g, w, r, a in zip(("start", "pair", "em", "loglik"), first,
                             want, (1e-4, 1e-4, 1e-4, 1e-5),
                             (1e-5, 1e-5, 1e-4, 1e-4)):
        _assert_close(f"em_counts_fused {n}", g, w, r, a)
    return err, once


def phase_k1(device, rng) -> dict:
    """K1 against its plain version (and the plain log-space E-step) at
    bench.py's shape, on a random model with dirichlet rows."""
    import torch

    from tehmm_tpu_torch.models.params import from_numpy
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import em

    S, T, V, B, L = K1_S, K1_T, K1_V, K1_B, K1_L
    log_em = np.zeros((S, T, V))
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    p = from_numpy(np.log(rng.dirichlet(np.ones(S))),
                   np.log(rng.dirichlet(np.ones(S), size=S)), log_em,
                   device)
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    lengths[:4] = [L, 0, 1, 2]
    sym = torch.from_numpy(
        rng.randint(0, V, size=(B, L, T)).astype(np.int32)).to(device)
    lens = torch.from_numpy(lengths).to(device)
    args = (p.log_start, p.log_trans, p.log_em, sym, lens)
    err, _once = _k1_against_plain(p, sym, lens)
    alpha, _dm, m_raw = ck.em_fwd(*args)
    bwd_args = (p.log_trans, p.log_em, sym, lens, alpha, m_raw)
    out = {
        "em_fwd": dict(
            max_abs_err=err["em_fwd"],
            ms=_median_ms(lambda: ck.em_fwd(*args), 5),
            plain_ms=_median_ms(lambda: ck.em_fwd_plain(*args), 3)),
        "em_bwd_stats": dict(
            max_abs_err=err["em_bwd_stats"],
            ms=_median_ms(lambda: ck.em_bwd_stats(*bwd_args), 5),
            plain_ms=_median_ms(
                lambda: ck.em_bwd_stats_plain(*bwd_args), 3)),
    }
    for name in EM_KERNELS:
        out[name].update(_bound(name, (B, L, S, T, V), int(lengths.sum())))

    # the whole E-step against the plain log-space engine
    # (tests/test_pallas.py's limits)
    k1 = em.em_sufficient_stats(p, sym, lens, engine="cuda")
    plain = em.em_sufficient_stats(p, sym, lens, engine="plain")
    rel = abs(float(k1.loglik) - float(plain.loglik)) \
        / abs(float(plain.loglik))
    assert rel < 1e-5, f"E-step loglik rel err {rel}"
    for n, r, a in (("start", 1e-4, 1e-5), ("trans", 1e-4, 1e-5),
                    ("em", 1e-4, 1e-4)):
        _assert_close(f"engine cuda vs plain {n}", getattr(k1, n),
                      getattr(plain, n), r, a)
    estep_ms = _median_ms(lambda: ck.em_counts_fused(*args), 5)
    estep_plain_ms = _median_ms(lambda: ck.em_counts_fused_plain(*args), 3)
    print(f"[kernels] K1 at S={S} T={T} V={V} B={B} L={L}: repeat runs "
          f"bit-identical; E-step loglik rel err vs plain log-space "
          f"engine {rel:.3g}", flush=True)
    print(f"[kernels] {'E-step (em_counts_fused)':22s} kernels "
          f"{estep_ms:10.3f} ms  plain {estep_plain_ms:10.3f} ms",
          flush=True)
    for name, r in out.items():
        print(f"[kernels] {name:22s} max_abs_err {r['max_abs_err']:.3g}  "
              f"kernel {r['ms']:10.3f} ms  plain {r['plain_ms']:10.3f} ms",
              flush=True)
    return out


def phase_post_kernels(device, rng) -> dict:
    """K4's decode and the chunk sweeps X1, X2 against their plain
    versions, at the shapes the max-posterior path gives them."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    p = _decode_model(rng, device)
    lengths = rng.randint(0, K4_L + 1, size=K4_B).astype(np.int32)
    lengths[:4] = [K4_L, 0, 1, 2]
    sym = torch.from_numpy(
        rng.randint(0, V, size=(K4_B, K4_L, T)).astype(np.int32)
    ).to(device)
    lens = torch.from_numpy(lengths).to(device)
    args = (p.log_start, p.log_trans, p.log_em, sym, lens)
    out = {}

    # K4: the decode on K1's forward rows, as posterior_decode_fused
    # calls it
    alpha = ck.em_fwd(*args)[0]
    dec_args = (p.log_trans, p.log_em, sym, lens, alpha)
    got = ck.post_decode(*dec_args)
    assert torch.equal(got, ck.post_decode(*dec_args)), \
        "two post_decode launches differ"
    assert torch.equal(got, ck.posterior_decode_fused(*args)), \
        "posterior_decode_fused differs from em_fwd + post_decode"
    want, margin = ck.post_decode_plain(*dec_args, with_margin=True)
    valid = torch.arange(K4_L, device=device)[None, :] < lens[:, None]
    assert not bool((got[~valid] != 0).any()), "K4 path not 0 at padding"
    differ = (got != want) & valid
    n_diff, n_valid = int(differ.sum()), int(valid.sum())
    agree = 1.0 - n_diff / n_valid
    worst = float(margin[differ].max()) if n_diff else 0.0
    assert agree >= 0.99999, f"K4 agrees with plain on {agree} of positions"
    assert worst <= NEAR_TIE, \
        f"K4 differs from plain where the top two are {worst} apart"
    print(f"[kernels] K4 decode at S={S} T={T} V={V}, {K4_B} rows of "
          f"L={K4_L} (ragged): {n_diff} of {n_valid} positions differ from "
          f"the plain version, each a near-tie (largest top-two gap "
          f"{worst:.3g} relative); repeat launches bit-identical",
          flush=True)
    out["post_decode"] = dict(
        max_abs_err=float((got - want).abs().max()),
        differing_positions=n_diff,
        ms=_median_ms(lambda: ck.post_decode(*dec_args), 5),
        plain_ms=_median_ms(lambda: ck.post_decode_plain(*dec_args), 3),
        fused_ms=_median_ms(lambda: ck.posterior_decode_fused(*args), 5),
    )

    # X1 and X2 on obs of a few long rows, ragged
    x_lens = np.asarray([X_L, 0, 1, rng.randint(2, X_L)], np.int32)
    x_sym = torch.from_numpy(
        rng.randint(0, V, size=(X_B, X_L, T)).astype(np.int32)).to(device)
    obs = track_log_likelihoods(p.log_em, x_sym)
    xl = torch.from_numpy(x_lens).to(device)
    init = torch.from_numpy(rng.randn(X_B, S).astype(np.float32)).to(device)
    init = init - init.amax(dim=-1, keepdim=True)
    cont = torch.tensor([True, False, False, False], device=device)
    lt = p.log_trans
    hats, carry = ck.forward_chunk_values(lt, obs, init, xl)
    assert torch.equal(hats, ck.forward_chunk_values(lt, obs, init, xl)[0])
    p_hats, p_carry = dp.forward_chunk_values(lt, obs, init, xl)
    final, dm_sum = ck.forward_final(lt, obs, init, xl)
    assert torch.equal(dm_sum, ck.forward_final(lt, obs, init, xl)[1])
    assert torch.equal(final, carry), "X1's two modes end in other carries"
    p_final, p_dm = dp.forward_final(lt, obs, init, xl)
    out["fwd_chunk"] = dict(max_abs_err=max(
        _assert_close("X1 hats", hats, p_hats, 0.0, 1e-5),
        _assert_close("X1 carry", carry, p_carry, 1e-6, 1e-6),
        _assert_close("X1 dm sum", dm_sum, p_dm, 1e-6, 1e-6)))
    beta, x_out = ck.backward_chunk_values(lt, obs, init, cont, xl)
    assert torch.equal(
        beta, ck.backward_chunk_values(lt, obs, init, cont, xl)[0])
    p_beta, p_x = dp.backward_chunk_values(lt, obs, init, cont, xl)
    out["bwd_chunk"] = dict(max_abs_err=max(
        _assert_close("X2 beta", beta, p_beta, 0.0, 1e-5),
        _assert_close("X2 x_out", x_out, p_x, 1e-6, 1e-6)))
    out["fwd_chunk"].update(
        ms=_median_ms(lambda: ck.forward_chunk_values(lt, obs, init, xl), 5),
        plain_ms=_median_ms(
            lambda: dp.forward_chunk_values(lt, obs, init, xl), 3),
        carry_only_ms=_median_ms(
            lambda: ck.forward_final(lt, obs, init, xl), 5),
        carry_only_plain_ms=_median_ms(
            lambda: dp.forward_final(lt, obs, init, xl), 3),
    )
    out["bwd_chunk"].update(
        ms=_median_ms(
            lambda: ck.backward_chunk_values(lt, obs, init, cont, xl), 5),
        plain_ms=_median_ms(
            lambda: dp.backward_chunk_values(lt, obs, init, cont, xl), 3),
    )
    out["post_decode"].update(_bound("post_decode", (K4_B, K4_L, S, T, V),
                                     int(lengths.sum())))
    for name in ("fwd_chunk", "bwd_chunk"):
        out[name].update(_bound(name, (X_B, X_L, S, T, V),
                                int(x_lens.sum())))
    print(f"[kernels] X1/X2 at S={S}, {X_B} rows of {X_L} (ragged): within "
          f"tolerance of the plain versions, repeat launches "
          f"bit-identical; K4 fused (em_fwd + decode) "
          f"{out['post_decode']['fused_ms']:.3f} ms, X1 carry-only "
          f"{out['fwd_chunk']['carry_only_ms']:.3f} ms (plain "
          f"{out['fwd_chunk']['carry_only_plain_ms']:.3f} ms)", flush=True)
    for name, r in out.items():
        print(f"[kernels] {name:22s} max_abs_err {r['max_abs_err']:.3g}  "
              f"kernel {r['ms']:10.3f} ms  plain {r['plain_ms']:10.3f} ms",
              flush=True)
    return out


def _stream_inputs(rng, device, variant, B, L, S):
    """One variant's optional streams: segment weights drawn in
    [W_LO, W_HI] (+w), STREAM_G gaussian tracks with 10% of the values
    missing and random means and variances (+g)."""
    import torch

    from tehmm_tpu_torch.models.gauss import from_numpy as gauss_from_numpy

    w = vals = gauss = None
    if "w" in variant:
        w = torch.from_numpy(
            rng.uniform(W_LO, W_HI, (B, L)).astype(np.float32)).to(device)
    if "g" in variant:
        v = (rng.randn(B, L, STREAM_G) * 2.0).astype(np.float32)
        v[rng.rand(B, L, STREAM_G) < 0.1] = np.nan
        vals = torch.from_numpy(v).to(device)
        gauss = gauss_from_numpy(rng.randn(S, STREAM_G) * 2.0,
                                 rng.randn(S, STREAM_G) * 0.5, device)
    return dict(obs_weights=w, gauss_params=gauss, gauss_values=vals)


def _ragged(rng, B, L):
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    lengths[:4] = [L, 0, 1, 2]
    return lengths


def phase_stream_kernels(device, rng) -> dict:
    """K2's forward, K1 and K4's decode with each optional observation
    stream (+w, +g, +wg) against their plain versions, at the shapes of
    phase 2's streamless checks."""
    import torch

    from tehmm_tpu_torch.models.emission import obs_log_likelihoods
    from tehmm_tpu_torch.models.params import from_numpy
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    out = {}

    # K2's forward at the decode's shape: value rows, normalizers and
    # paths bit-equal
    p = _decode_model(rng, device)
    lengths = _ragged(rng, B_ROWS, L_ROWS)
    sym = torch.from_numpy(
        rng.randint(0, V, size=(B_ROWS, L_ROWS, T)).astype(np.int32)
    ).to(device)
    lens = torch.from_numpy(lengths).to(device)
    args = (p.log_start, p.log_trans, p.log_em, sym, lens)
    for variant in STREAM_VARIANTS:
        st = _stream_inputs(rng, device, variant, B_ROWS, L_ROWS, S)
        v, dm = ck.viterbi_fwd(*args, **st)
        pv, pdm = ck.viterbi_fwd_plain(*args, **st)
        assert torch.equal(v, pv) and torch.equal(dm, pdm), \
            f"viterbi_fwd{variant} disagrees with its plain version"
        path, _score = ck.viterbi_fused(*args, **st)
        obs = obs_log_likelihoods(p.log_em, sym, st["gauss_params"],
                                  st["gauss_values"], st["obs_weights"])
        want_p, _ = dp.viterbi(p.log_start, p.log_trans, obs, lens)
        assert torch.equal(path, want_p), \
            f"viterbi_fused{variant} path != dp.viterbi"
        del obs, want_p
        out["viterbi_fwd" + variant] = dict(
            max_abs_err=float(max((v - pv).abs().max(),
                                  (dm - pdm).abs().max())),
            ms=_median_ms(lambda: ck.viterbi_fwd(*args, **st), 5),
            plain_ms=_median_ms(lambda: ck.viterbi_fwd_plain(*args, **st),
                                3),
            **_bound("viterbi_fwd" + variant, (B_ROWS, L_ROWS, S, T, V),
                     int(lengths.sum()), STREAM_G if "g" in variant else 0,
                     "w" in variant),
        )
        del v, pv, dm, pdm
    print(f"[streams] K2 forward at S={S} T={T} V={V}, {B_ROWS} rows of "
          f"L={L_ROWS} (ragged), weights in [{W_LO:g}, {W_HI:g}], "
          f"{STREAM_G} gaussian tracks (10% missing): value rows, "
          f"normalizers and paths bit-equal to plain for "
          f"{', '.join(STREAM_VARIANTS)}", flush=True)

    # K1 at bench.py's shape
    S1, T1, V1, B1, L1 = K1_S, K1_T, K1_V, K1_B, K1_L
    log_em = np.zeros((S1, T1, V1))
    for t in range(T1):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V1 - 1), size=S1))
    p1 = from_numpy(np.log(rng.dirichlet(np.ones(S1))),
                    np.log(rng.dirichlet(np.ones(S1), size=S1)), log_em,
                    device)
    lengths1 = _ragged(rng, B1, L1)
    sym1 = torch.from_numpy(
        rng.randint(0, V1, size=(B1, L1, T1)).astype(np.int32)).to(device)
    lens1 = torch.from_numpy(lengths1).to(device)
    args1 = (p1.log_start, p1.log_trans, p1.log_em, sym1, lens1)
    for variant in STREAM_VARIANTS:
        st = _stream_inputs(rng, device, variant, B1, L1, S1)
        alpha, dm, m_raw = ck.em_fwd(*args1, **st)
        pa, pdm, pm = ck.em_fwd_plain(*args1, **st)
        err_fwd = max(
            _assert_close(f"em_fwd{variant} alpha", alpha, pa, 1e-5, 1e-6),
            _assert_close(f"em_fwd{variant} m_raw", m_raw, pm, 1e-5, 0.0),
            _assert_close(f"em_fwd{variant} dm", dm, pdm, 1e-5, 1e-5))
        bwd = (p1.log_trans, p1.log_em, sym1, lens1, alpha, m_raw)
        got = ck.em_bwd_stats(*bwd, **st)
        want = ck.em_bwd_stats_plain(*bwd, **st)
        err_bwd = max(
            _assert_close(f"em_bwd_stats{variant} {n}", g, w, 1e-4, a)
            for n, g, w, a in zip(("start", "pair", "em"), got, want,
                                  (1e-5, 1e-5, 1e-4)))
        if "g" in variant:
            # moments at 1e-4 of each moment's largest entry: gx sums
            # values of both signs, so an entry may cancel to ~0
            for n, g, w in zip(("gn", "gx", "gx2"), got[3], want[3]):
                _assert_close(f"em_bwd_stats{variant} {n}", g, w, 1e-4,
                              1e-4 * float(w.abs().max()))
        first = ck.em_counts_fused(*args1, **st)
        again = ck.em_counts_fused(*args1, **st)
        flat = (lambda r: list(r[:4]) + (list(r[4]) if len(r) > 4 else []))
        assert all(torch.equal(a, b) for a, b in zip(flat(first),
                                                     flat(again))), \
            f"two K1{variant} runs on the same input differ"
        _assert_close(f"em_counts_fused{variant} loglik", first[3],
                      ck._loglik_rows(pa, pdm, lens1), 1e-5, 1e-4)
        shape1 = (B1, L1, S1, T1, V1)
        G = STREAM_G if "g" in variant else 0
        out["em_fwd" + variant] = dict(
            max_abs_err=err_fwd,
            ms=_median_ms(lambda: ck.em_fwd(*args1, **st), 5),
            plain_ms=_median_ms(lambda: ck.em_fwd_plain(*args1, **st), 3),
            **_bound("em_fwd", shape1, int(lengths1.sum()), G,
                     "w" in variant))
        out["em_bwd_stats" + variant] = dict(
            max_abs_err=err_bwd,
            ms=_median_ms(lambda: ck.em_bwd_stats(*bwd, **st), 5),
            plain_ms=_median_ms(lambda: ck.em_bwd_stats_plain(*bwd, **st),
                                3),
            **_bound("em_bwd_stats", shape1, int(lengths1.sum()), G,
                     "w" in variant))
        del alpha, pa, dm, pdm, m_raw, pm, bwd
    print(f"[streams] K1 at S={S1} T={T1} V={V1} B={B1} L={L1} (ragged): "
          f"within tolerance of plain (moments within 1e-4 of their "
          f"largest entry), repeat runs bit-identical, for "
          f"{', '.join(STREAM_VARIANTS)}", flush=True)

    # K4's decode at the stitched max-posterior decode's shape
    lengths4 = _ragged(rng, K4_B, K4_L)
    sym4 = torch.from_numpy(
        rng.randint(0, V, size=(K4_B, K4_L, T)).astype(np.int32)
    ).to(device)
    lens4 = torch.from_numpy(lengths4).to(device)
    args4 = (p.log_start, p.log_trans, p.log_em, sym4, lens4)
    valid = torch.arange(K4_L, device=device)[None, :] < lens4[:, None]
    for variant in STREAM_VARIANTS:
        st = _stream_inputs(rng, device, variant, K4_B, K4_L, S)
        alpha = ck.em_fwd(*args4, **st)[0]
        dec = (p.log_trans, p.log_em, sym4, lens4, alpha)
        got = ck.post_decode(*dec, **st)
        assert torch.equal(got, ck.post_decode(*dec, **st)), \
            f"two post_decode{variant} launches differ"
        assert torch.equal(got, ck.posterior_decode_fused(*args4, **st))
        want, margin = ck.post_decode_plain(*dec, with_margin=True, **st)
        assert not bool((got[~valid] != 0).any())
        differ = (got != want) & valid
        n_diff, n_valid = int(differ.sum()), int(valid.sum())
        worst = float(margin[differ].max()) if n_diff else 0.0
        assert 1.0 - n_diff / n_valid >= 0.99999, \
            f"post_decode{variant} differs from plain on {n_diff} positions"
        assert worst <= NEAR_TIE, \
            f"post_decode{variant} differs where the top two are {worst} " \
            f"apart"
        out["post_decode" + variant] = dict(
            max_abs_err=float((got - want).abs().max()),
            differing_positions=n_diff,
            ms=_median_ms(lambda: ck.post_decode(*dec, **st), 5),
            plain_ms=_median_ms(
                lambda: ck.post_decode_plain(*dec, **st), 3),
            fused_ms=_median_ms(
                lambda: ck.posterior_decode_fused(*args4, **st), 5),
            **_bound("post_decode", (K4_B, K4_L, S, T, V),
                     int(lengths4.sum()), STREAM_G if "g" in variant else 0,
                     "w" in variant))
        print(f"[streams] K4 decode{variant}: {n_diff} of {n_valid} "
              f"positions differ from plain, each a near-tie (largest "
              f"top-two gap {worst:.3g}); repeat launches bit-identical",
              flush=True)
    for name, r in out.items():
        print(f"[streams] {name:22s} max_abs_err {r['max_abs_err']:.3g}  "
              f"kernel {r['ms']:10.3f} ms  plain {r['plain_ms']:10.3f} ms",
              flush=True)
    return out


def phase_streaming_kernels(device, rng, seed) -> dict:
    """K5, K6a, K6b and the backtrace of ``dp.viterbi_streaming`` against
    their plain versions on the obs tensors of every ``bench_engines``
    shape, ragged: the block layouts differ from shape to shape (12, 4,
    2 and 1 row groups per block; at S=256 part of the transition matrix
    is read from global memory).  K6 is held to 2e-6 against the plain
    version carried in float64, whose own rounding then takes nothing of
    that limit; the distance to the float32 plain version is printed.
    The S=20 results of K5 and K6 go under the kernels' names, the
    others under ``name@config``."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp
    from tehmm_tpu_torch.tools import bench_engines

    out = {}
    f64 = torch.float64
    for config in ENGINE_CONFIGS:
        S_, T_, V_, B, L = bench_engines.CONFIGS[config]
        p, sym = bench_engines.make_inputs(S_, T_, V_, B, L, device, seed)
        lengths = _ragged(rng, B, L)
        lens = torch.from_numpy(lengths).to(device)
        obs = track_log_likelihoods(p.log_em, sym)
        del sym
        suffix = "" if config == ENGINE_CONFIGS[0] else "@" + config
        shape, valid = (B, L, S_, T_, V_), int(lengths.sum())

        # K5: bit-equal rows and normalizers, and dp.viterbi's paths
        v_args = (p.log_start, p.log_trans, obs, lens)
        v, dm = ck.viterbi_values(*v_args)
        pv, pdm = ck.viterbi_values_plain(*v_args)
        assert torch.equal(v, pv) and torch.equal(dm, pdm), \
            f"viterbi_values disagrees with its plain version at {config}"
        path, score = dp.viterbi_streaming(*v_args)
        want_p, want_s = dp.viterbi(*v_args)
        assert torch.equal(path, want_p), \
            f"viterbi_streaming path != dp.viterbi at {config}"
        rel = float(((score - want_s).abs()
                     / want_s.abs().clamp(min=1.0)).max())
        assert rel < 1e-5, f"viterbi_streaming score rel err {rel}"
        out["viterbi_values" + suffix] = dict(
            max_abs_err=float(max((v - pv).abs().max(),
                                  (dm - pdm).abs().max())),
            ms=_median_ms(lambda: ck.viterbi_values(*v_args), 5),
            plain_ms=_median_ms(lambda: ck.viterbi_values_plain(*v_args), 3),
            **_bound("viterbi_values", shape, valid))
        # the backtrace as viterbi_streaming calls it, on K5's rows
        end = torch.argmax(v[:, L - 1], dim=-1).to(torch.int32)
        bt_args = (p.log_trans, v[:, 1:], v[:, 0], end,
                   torch.clamp(lens - 1, min=0))
        bt_plain = (p.log_trans, v[:, 1:].contiguous(),
                    v[:, 0].contiguous(), *bt_args[3:])
        got_bt = ck.viterbi_backtrace(*bt_args)
        want_bt = ck.viterbi_backtrace_plain(*bt_plain)
        assert torch.equal(got_bt[0], want_bt[0]) \
            and torch.equal(got_bt[1], want_bt[1]), \
            f"viterbi_backtrace disagrees with its plain version at {config}"
        out["viterbi_backtrace@" + config] = dict(
            max_abs_err=0.0,
            ms=_median_ms(lambda: ck.viterbi_backtrace(*bt_args), 5),
            plain_ms=_median_ms(
                lambda: ck.viterbi_backtrace_plain(*bt_plain), 3),
            **_bound("viterbi_backtrace", (B, L - 1, S_, T_, V_),
                     int(np.maximum(lengths - 1, 0).sum())))
        del v, pv, dm, pdm, path, want_p, got_bt, want_bt, bt_args, bt_plain

        # K6: within tolerance, repeats bit-identical
        obs_p, o_m = dp.scaled_obs_prob(obs)
        del obs
        f_args = (p.log_start, p.log_trans, obs_p, lens)
        alpha, dm = ck.forward_prob(*f_args)
        again = ck.forward_prob(*f_args)
        assert torch.equal(alpha, again[0]) and torch.equal(dm, again[1]), \
            f"two forward_prob launches differ at {config}"
        del again
        r_alpha, r_dm = ck.forward_prob_plain(*f_args, dtype=f64)
        err_f = max(
            _assert_close(f"forward_prob alpha {config}", alpha, r_alpha,
                          0.0, 2e-6),
            _assert_close(f"forward_prob dm {config}", dm, r_dm, 0.0, 1e-5))
        del r_alpha, r_dm
        p_alpha, p_dm = ck.forward_prob_plain(*f_args)
        f32_f = float((alpha - p_alpha).abs().max())
        pad = torch.arange(L, device=device)[None, :] >= lens[:, None]
        o_sum = o_m.masked_fill(pad, 0.0).sum(dim=1)
        ll_rel = _assert_close(
            f"forward_prob loglik {config}",
            ck._loglik_rows(alpha, dm, lens) + o_sum,
            ck._loglik_rows(p_alpha, p_dm, lens) + o_sum, 1e-5, 1e-5)
        empty = lens == 0
        assert bool((alpha[empty] == 1).all()) \
            and bool((dm[empty] == 0).all()), "empty rows not ones/zeros"
        out["fwd_prob" + suffix] = dict(
            max_abs_err=err_f,
            ms=_median_ms(lambda: ck.forward_prob(*f_args), 5),
            plain_ms=_median_ms(lambda: ck.forward_prob_plain(*f_args), 3),
            **_bound("fwd_prob", shape, valid))
        del alpha, p_alpha, dm, p_dm
        b_args = (p.log_trans, obs_p, lens)
        beta = ck.backward_prob(*b_args)
        assert torch.equal(beta, ck.backward_prob(*b_args)), \
            f"two backward_prob launches differ at {config}"
        r_beta = ck.backward_prob_plain(*b_args, dtype=f64)
        err_b = _assert_close(f"backward_prob beta {config}", beta, r_beta,
                              0.0, 2e-6)
        del r_beta
        f32_b = float((beta - ck.backward_prob_plain(*b_args)).abs().max())
        out["bwd_prob" + suffix] = dict(
            max_abs_err=err_b,
            ms=_median_ms(lambda: ck.backward_prob(*b_args), 5),
            plain_ms=_median_ms(lambda: ck.backward_prob_plain(*b_args), 3),
            **_bound("bwd_prob", shape, valid))
        del beta, obs_p, o_m
        print(f"[streaming] K5/K6 at {config} (S={S_} B={B} L={L}, ragged): "
              f"K5 rows, normalizers, backtrace and paths bit-equal (score "
              f"rel err {rel:.3g}); K6 within 2e-6 of plain in float64 "
              f"(alpha_p {err_f:.3g}, beta_p {err_b:.3g}; of plain in "
              f"float32 {f32_f:.3g}, {f32_b:.3g}; row loglik abs err "
              f"{ll_rel:.3g}), repeat launches bit-identical", flush=True)
        torch.cuda.empty_cache()
    for name, r in out.items():
        print(f"[streaming] {name:22s} max_abs_err {r['max_abs_err']:.3g}  "
              f"kernel {r['ms']:9.3f} ms  plain {r['plain_ms']:9.3f} ms  "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})", flush=True)
    return out


def _tool_rows(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def phase_engines(seed) -> dict:
    """2e: the engine-comparison path through its tools, at full width.
    Returns {config: launch counts of that config's two tool runs}."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools import bench_engines, profile_estep

    launches = {}
    t_phase = time.perf_counter()
    for config in ENGINE_CONFIGS:
        counts = {}
        for mode, engines, needed in (
                ((), "plain,cuda,cuda_v3", "cuda_v3"),
                (("--decode",), "plain,streaming,fused", "streaming")):
            ck.reset_launch_counts()
            text = _run_cli(bench_engines, [
                "--configs", config, "--engines", engines, "--iters",
                str(ENGINE_ITERS), "--seed", str(seed), *mode])
            for name, n in ck.LAUNCHES.items():
                counts[name] = counts.get(name, 0) + n
            for line in text.splitlines():
                print(f"[engines] {line}", flush=True)
            rows = {r["engine"]: r for r in _tool_rows(text)}
            assert list(rows) == engines.split(","), list(rows)
            for engine, r in rows.items():
                if "error" in r:
                    assert engine in ("cuda", "fused") \
                        and config in ("S128", "S256") \
                        and ENVELOPE_MESSAGE in r["error"], \
                        f"{config} {engine}: unexpected error row {r}"
            ran = {e: r for e, r in rows.items() if "error" not in r}
            assert needed in ran and "plain" in ran, (config, list(ran))
            if mode:
                bad = {e: r["path_agreement"] for e, r in ran.items()
                       if r["path_agreement"] != 1.0}
                assert not bad, f"{config}: decode paths differ: {bad}"
            else:
                lls = [r["loglik"] for r in ran.values()]
                assert np.isfinite(lls).all(), lls
                rel = max(abs(a - b) / abs(a) for a in lls for b in lls)
                assert rel <= 1e-4, \
                    f"{config}: E-step logliks differ by {rel} relative"
            torch.cuda.empty_cache()
        launches[config] = counts
    ck.reset_launch_counts()
    text = _run_cli(profile_estep, ["S64", "--iters", str(ENGINE_ITERS),
                                    "--seed", str(seed)])
    for line in text.splitlines():
        print(f"[engines] profile_estep {line}", flush=True)
    (stages,) = _tool_rows(text)
    assert all(stages[k] > 0 for k in ("obs_ms", "obs_p_ms", "fwd_ms",
                                       "bwd_ms", "epilogue_ms", "sum_ms"))
    assert ck.LAUNCHES["fwd_prob"] and ck.LAUNCHES["bwd_prob"]
    torch.cuda.empty_cache()
    print(f"[engines] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------------
# phase 3: end to end through the CLIs
# ---------------------------------------------------------------------

def _planted_runs(rng, n):
    """Sticky planted path as runs: (states, starts, lengths)."""
    k = int(n / RUN_MEAN * 2) + 16
    lens = rng.geometric(1.0 / RUN_MEAN, size=k).astype(np.int64)
    states = rng.randint(0, S, size=k)
    ends = np.cumsum(lens)
    k = int(np.searchsorted(ends, n)) + 1
    lens, states = lens[:k], states[:k]
    lens[-1] -= int(ends[k - 1]) - n
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return states, starts, lens


def _write_lines(path, chrom, starts, ends, names):
    with open(path, "w") as fh:
        fh.write("".join(
            f"{chrom}\t{s}\t{e}\t{v}\n"
            for s, e, v in zip(starts.tolist(), ends.tolist(), names)
        ))


def make_dataset(work, rng, n):
    """Planted truth + tracks on disk; returns (xml, truth_bed, truth)."""
    states, starts, lens = _planted_runs(rng, n)
    truth = np.repeat(states, lens).astype(np.int8)
    _write_lines(os.path.join(work, "truth.bed"), "chr1", starts,
                 starts + lens, [f"S{s}" for s in states.tolist()])
    # categorical BED tracks: one record per BLOCK bases, its category
    # drawn from a per-track, per-state distribution (state at the
    # record's first base)
    bstart = np.arange(0, n, BLOCK, dtype=np.int64)
    bend = np.minimum(bstart + BLOCK, n)
    xml = []
    for k in range(T - 1):
        probs = rng.dirichlet(np.full(N_CATS, 0.1), size=S)
        cum = probs[truth[bstart]].cumsum(axis=1)
        cats = (cum < rng.rand(len(bstart), 1)).sum(axis=1) \
            .clip(0, N_CATS - 1)
        _write_lines(os.path.join(work, f"bed{k}.bed"), "chr1", bstart,
                     bend, [f"c{c}" for c in cats.tolist()])
        xml.append(f'  <track name="bed{k}" path="bed{k}.bed"/>')
    # FASTA whose GC content follows the planted state
    gc = rng.random_sample(n) < GC[truth]
    coin = rng.randint(0, 2, size=n).astype(bool)
    bases = np.where(gc, np.where(coin, ord("G"), ord("C")),
                     np.where(coin, ord("A"), ord("T"))).astype(np.uint8)
    width = 80
    with open(os.path.join(work, "genome.fa"), "wb") as fh:
        fh.write(b">chr1\n")
        step = width << 16                # whole lines per write
        for lo in range(0, n, step):
            blk = bases[lo : lo + step]
            full = len(blk) // width * width
            lines = np.concatenate(
                [blk[:full].reshape(-1, width),
                 np.full((full // width, 1), ord("\n"), np.uint8)], axis=1,
            ).tobytes()
            fh.write(lines)
            if full < len(blk):
                fh.write(blk[full:].tobytes() + b"\n")
    xml.append('  <track name="seq" path="genome.fa"/>')
    xml_path = os.path.join(work, "tracks.xml")
    with open(xml_path, "w") as fh:
        fh.write("<teModelConfig>\n" + "\n".join(xml)
                 + "\n</teModelConfig>\n")
    return xml_path, os.path.join(work, "truth.bed"), truth


class _Stages:
    """Wall time of the calls the CLIs make into each layer, recorded by
    wrapping those calls for the duration of a run."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.last: dict[str, object] = {}
        self._undo = []

    def wrap(self, owner, attr, stage, sync=False, keep=False):
        """``sync``: end the span with torch.cuda.synchronize(), so a
        call that only queues work on the card is charged its work.
        ``keep``: hold the last result in ``self.last`` (only for stages
        read afterwards, so the spans hold no other tensor alive)."""
        fn = getattr(owner, attr)
        original = vars(owner)[attr]      # e.g. the classmethod itself

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            if sync:
                import torch

                torch.cuda.synchronize()
            self.seconds[stage] = self.seconds.get(stage, 0.0) \
                + time.perf_counter() - t0
            self.calls[stage] = self.calls.get(stage, 0) + 1
            if keep:
                self.last[stage] = result
            return result

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, original))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def _run_cli(cli, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0, f"{cli.__name__} exited {rc}"
    return buf.getvalue().strip()


def _paint(bed_path, n, names):
    from tehmm_tpu_torch.io import read_bed_intervals

    out = np.full(n, -1, np.int16)
    prev_end = 0
    for chrom, s, e, name in read_bed_intervals(bed_path, ncol=4):
        assert chrom == "chr1" and s == prev_end and e > s, \
            f"BED does not tile the chromosome at {s}"
        out[s:e] = names.index(name)
        prev_end = e
    assert prev_end == n, f"BED ends at {prev_end}, not {n}"
    return out


def _region_bed(work, name, lo, hi):
    path = os.path.join(work, name)
    with open(path, "w") as fh:
        fh.write(f"chr1\t{lo}\t{hi}\n")
    return path


def phase_end_to_end(work, xml, truth_bed, truth, region, small,
                     device="cuda"):
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.cli import train as port_train
    from tehmm_tpu_torch.models.hmm import MultitrackHmm

    n = len(truth)
    regions = os.path.join(work, "regions.bed")
    with open(regions, "w") as fh:
        fh.write(f"chr1\t0\t{n}\n")
    model = os.path.join(work, "model.npz")
    out_bed = os.path.join(work, "decoded.bed")

    stages = _Stages()
    stages.wrap(port_train, "load_track_data", "train: load")
    stages.wrap(MultitrackHmm, "supervised", "train: count + M-step")
    stages.wrap(MultitrackHmm, "save", "train: save")
    stages.wrap(port_eval, "load_track_data", "eval: load")
    stages.wrap(MultitrackHmm, "decode_tables", "eval: decode", keep=True)
    stages.wrap(port_eval, "path_log_score", "eval: path score")
    stages.wrap(port_eval, "write_bed_intervals", "eval: write")
    try:
        t0 = time.perf_counter()
        _run_cli(port_train, [xml, truth_bed, model, "--supervised",
                              "--device", device])
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        score = _run_cli(port_eval, [xml, model, regions, "--bed", out_bed,
                                     "--device", device])
        t_eval = time.perf_counter() - t0
    finally:
        stages.restore()
    paths, report = stages.last["eval: decode"]
    assert report.boundaries_ok, report
    print(f"[e2e] eval printed path score {score}; {report}", flush=True)
    assert np.isfinite(float(score))

    names = MultitrackHmm.load(model, "cpu").state_names
    decoded = _paint(out_bed, n, names)
    name_idx = np.asarray([int(s[1:]) for s in names])
    acc = float((name_idx[decoded] == truth).mean())
    print(f"[e2e] base accuracy vs planted truth: {acc:.6f}", flush=True)
    assert acc >= 0.9, f"base accuracy {acc} < 0.9"

    # exact (K3 + backtrace) and stitched (K2) agree on a region
    lo = n // 4
    region_bed = os.path.join(work, "region.bed")
    with open(region_bed, "w") as fh:
        fh.write(f"chr1\t{lo}\t{lo + region}\n")
    beds = {}
    for flag in ("--exact", "--no-exact"):
        out = os.path.join(work, f"region{flag}.bed")
        t0 = time.perf_counter()
        _run_cli(port_eval, [xml, model, region_bed, "--bed", out,
                             "--device", device, flag])
        print(f"[e2e] {region}-position region {flag}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        beds[flag] = open(out).read()
    assert beds["--exact"] == beds["--no-exact"], \
        "--exact and --no-exact BED differ"

    # the card against the CPU's plain torch on a small region
    small_bed = os.path.join(work, "small.bed")
    with open(small_bed, "w") as fh:
        fh.write(f"chr1\t{lo}\t{lo + small}\n")
    small_out = {}
    for dev in (device, "cpu"):
        out = os.path.join(work, f"small_{dev}.bed")
        _run_cli(port_eval, [xml, model, small_bed, "--bed", out,
                             "--device", dev])
        small_out[dev] = open(out).read()
    assert small_out[device] == small_out["cpu"], \
        "card and CPU BED differ on the small region"
    print(f"[e2e] {small}-position region: card BED == CPU BED",
          flush=True)

    print("[e2e] stage                    seconds", flush=True)
    for stage, sec in stages.seconds.items():
        print(f"[e2e] {stage:24s} {sec:9.3f}", flush=True)
    print(f"[e2e] {'train CLI total':24s} {t_train:9.3f}", flush=True)
    print(f"[e2e] {'eval CLI total':24s} {t_eval:9.3f}", flush=True)
    return acc, float(score)


def _read_pd(path):
    """--pd rows: ([start], f32[n, S]) as written (%.6g)."""
    starts, probs = [], []
    with open(path) as fh:
        for line in fh:
            _chrom, s, _e, p = line.rstrip("\n").split("\t")
            starts.append(int(s))
            probs.append(np.array(p.split(","), dtype=np.float64))
    return np.asarray(starts), np.stack(probs)


def phase_max_posterior(work, xml, truth, viterbi_score, region, small,
                        pd_region, device="cuda"):
    """3d: max-posterior decoding, --pd and scoring through eval with
    phase 3's supervised model."""
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.models import hmm as port_hmm
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    n = len(truth)
    lo = n // 4
    model = os.path.join(work, "model.npz")
    names = port_hmm.MultitrackHmm.load(model, "cpu").state_names
    name_idx = np.asarray([int(s[1:]) for s in names])
    regions = _region_bed(work, "post_regions.bed", 0, n)
    out_bed = os.path.join(work, "maxpost.bed")

    stages = _Stages()
    stages.wrap(port_eval, "load_track_data", "load")
    stages.wrap(port_hmm, "posterior_chunked", "decode (stitched, K4)",
                sync=True, keep=True)
    stages.wrap(port_eval, "posterior_exact", "decode (exact, X1/X2)",
                sync=True)
    stages.wrap(port_hmm.MultitrackHmm, "score", "score (X1)", sync=True)
    stages.wrap(port_eval, "write_bed_intervals", "write BED")
    stages.wrap(port_eval, "_write_pd_streaming", "--pd write", sync=True)

    def run(bed_path, *flags, dev=device):
        t0 = time.perf_counter()
        printed = _run_cli(port_eval, [xml, model, bed_path, *flags,
                                       "--device", dev])
        return float(printed), time.perf_counter() - t0

    try:
        # the whole chromosome: stitched (automatic past 256K positions)
        score, wall = run(regions, "--bed", out_bed, "--maxPost")
        _paths, report = stages.last["decode (stitched, K4)"]
        assert report.boundaries_ok, report
        print(f"[post] {n}-position --maxPost: printed loglik {score!r} "
              f"(Viterbi "
              f"path score {viterbi_score!r}); {report}; eval CLI "
              f"{wall:.3f} s", flush=True)
        assert np.isfinite(score), score
        assert score >= viterbi_score - 1e-6 * abs(viterbi_score), \
            f"log P(x) {score} < Viterbi log P(x, path) {viterbi_score}"
        decoded = _paint(out_bed, n, names)
        acc = float((name_idx[decoded] == truth).mean())
        print(f"[post] base accuracy vs planted truth: {acc:.6f}",
              flush=True)
        assert acc >= 0.9, f"max-posterior base accuracy {acc} < 0.9"
        seconds_20mb = dict(stages.seconds)

        # stitched (K4) against exact (X1/X2) on a region
        region_bed = _region_bed(work, "post_region.bed", lo, lo + region)
        paths = {}
        for flag in ("--exact", "--no-exact"):
            out = os.path.join(work, f"post_region{flag}.bed")
            _, wall = run(region_bed, "--bed", out, "--maxPost", flag)
            paths[flag] = _paint_region(out, lo, region, names)
            print(f"[post] {region}-position region --maxPost {flag}: "
                  f"{wall:.3f} s", flush=True)
        n_diff = int((paths["--exact"] != paths["--no-exact"]).sum())
        assert n_diff <= 1e-5 * region, \
            f"--exact and --no-exact differ on {n_diff} bases"
        print(f"[post] {region}-position region: --maxPost --exact and "
              f"--no-exact differ on {n_diff} bases", flush=True)

        # the card's --pd against its --maxPost --exact on a region
        pd_bed = _region_bed(work, "post_pd.bed", lo, lo + pd_region)
        pd_out = os.path.join(work, "post_pd_rows.bed")
        run(pd_bed, "--pd", pd_out)
        exact_out = os.path.join(work, "post_pd_exact.bed")
        run(pd_bed, "--bed", exact_out, "--maxPost", "--exact")
        starts, probs = _read_pd(pd_out)
        assert np.array_equal(starts, lo + np.arange(pd_region))
        sums = np.abs(probs.sum(axis=1) - 1.0).max()
        assert sums <= 1e-5, f"--pd rows sum to 1 within {sums}"
        arg = probs.argmax(axis=1)
        bed_path = _paint_region(exact_out, lo, pd_region, names)
        differ = arg != bed_path
        # a printed row whose top two round to the same %.6g value has
        # no argmax of its own: only those may differ
        top2 = np.sort(probs, axis=1)[:, -2:]
        ties = int((differ & (top2[:, 0] == top2[:, 1])).sum())
        assert int(differ.sum()) == ties, \
            f"--pd argmax differs from the BED on {int(differ.sum())} rows"
        print(f"[post] {pd_region}-position region: --pd rows sum to 1 "
              f"within {sums:.3g}; their argmax is the --maxPost --exact "
              f"BED on every row ({ties} printed ties)", flush=True)
    finally:
        stages.restore()
    launches = dict(ck.LAUNCHES)          # the card's runs of this phase

    # the card against the CPU on a small region: every mode
    small_bed = _region_bed(work, "post_small.bed", lo, lo + small)
    got = {}
    for dev in (device, "cpu"):
        r = got[dev] = {}
        for flag in ("--exact", "--no-exact"):
            out = os.path.join(work, f"post_small{flag}_{dev}.bed")
            r[f"score {flag}"], _ = run(small_bed, "--bed", out,
                                        "--maxPost", flag, dev=dev)
            r[flag] = _paint_region(out, lo, small, names)
        pd_out = os.path.join(work, f"post_small_pd_{dev}.bed")
        r["score --pd"], _ = run(small_bed, "--pd", pd_out, dev=dev)
        r["pd"] = _read_pd(pd_out)
        r["score"], _ = run(small_bed, dev=dev)
    card, cpu = got[device], got["cpu"]
    for flag in ("--exact", "--no-exact"):
        n_diff = int((card[flag] != cpu[flag]).sum())
        assert n_diff <= 1e-5 * small, \
            f"card and CPU --maxPost {flag} differ on {n_diff} bases"
        print(f"[post] {small}-position region --maxPost {flag}: card and "
              f"CPU differ on {n_diff} bases", flush=True)
    score_rel = max(abs(card[k] - cpu[k]) / abs(cpu[k])
                    for k in card if k.startswith("score"))
    assert score_rel <= 1e-5, f"card and CPU scores differ by {score_rel}"
    assert np.array_equal(card["pd"][0], cpu["pd"][0])
    pd_err = float(np.abs(card["pd"][1] - cpu["pd"][1]).max())
    assert pd_err <= 1e-5, f"card and CPU --pd differ by {pd_err}"
    print(f"[post] {small}-position region: printed scores within "
          f"{score_rel:.3g} relative, --pd probabilities within {pd_err:.3g}",
          flush=True)

    print(f"[post] stage ({n}-position --maxPost run)  seconds",
          flush=True)
    for stage, sec in seconds_20mb.items():
        print(f"[post] {stage:28s} {sec:9.3f}", flush=True)
    print("[post] stage (the card's runs of 3d)  seconds  calls",
          flush=True)
    for stage, sec in stages.seconds.items():
        print(f"[post] {stage:28s} {sec:9.3f}  {stages.calls[stage]}",
              flush=True)
    return launches


def _em_log(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _majority_accuracy(decoded, truth, n_learned):
    """Base accuracy after mapping each learned state to the planted
    state it covers most."""
    counts = np.zeros((n_learned, S), np.int64)
    np.add.at(counts, (decoded.astype(np.int64), truth.astype(np.int64)), 1)
    return float(counts.max(axis=1).sum() / len(truth))


def phase_em(work, xml, truth, seed, device="cuda"):
    """3b: unsupervised EM through the CLI on the whole chromosome, K1
    against its plain version at this run's shape, then the decode of
    the learned model.  Returns (the training run's launch counts, K1's
    errors at this shape)."""
    import torch

    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.cli import train as port_train
    from tehmm_tpu_torch.models import hmm as port_hmm
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import em as port_em

    n = len(truth)
    regions = _region_bed(work, "em_regions.bed", 0, n)
    model = os.path.join(work, "em_model.npz")
    log = os.path.join(work, "em_log.jsonl")
    out_bed = os.path.join(work, "em_decoded.bed")
    stages = _Stages()
    stages.wrap(port_train, "load_track_data", "load")
    stages.wrap(port_hmm, "batch_chunks", "chunk batching")
    stages.wrap(port_hmm, "_stage", "stage batch (H2D)", sync=True,
                keep=True)
    stages.wrap(port_em, "em_sufficient_stats", "E-step (K1)", sync=True)
    stages.wrap(ck, "em_fwd", "  of which em_fwd", sync=True)
    stages.wrap(ck, "em_bwd_stats", "  of which em_bwd_stats", sync=True)
    stages.wrap(port_em, "em_m_step", "M-step", sync=True)
    stages.wrap(port_hmm.MultitrackHmm, "save", "save")
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        _run_cli(port_train, [
            xml, regions, model, "--numStates", str(EM_STATES),
            "--iter", str(EM_ITERS), "--chunk", str(EM_CHUNK),
            "--seed", str(seed), "--device", device, "--logJson", log,
        ])
        t_train = time.perf_counter() - t0
    finally:
        stages.restore()
    launches = dict(ck.LAUNCHES)        # the training run's own launches
    peak = torch.cuda.max_memory_allocated() / 1e6
    lls = [r["loglik"] for r in _em_log(log)]
    assert lls and np.isfinite(lls).all(), f"non-finite loglik: {lls}"
    for i, (a, b) in enumerate(zip(lls, lls[1:])):
        assert b >= a - 1e-4 * abs(a), \
            f"loglik fell at iteration {i + 1}: {a} -> {b}"
    print(f"[em] {n} positions, {EM_STATES} states, chunk {EM_CHUNK}: "
          f"{len(lls)} logged iterations, loglik {lls[0]:.6g} -> "
          f"{lls[-1]:.6g} (non-decreasing within 1e-4 |loglik|)",
          flush=True)
    print(f"[em] loglik trace: {lls}", flush=True)
    k1_err = _k1_at_em_shape(model, stages.last["stage batch (H2D)"][0],
                             np.random.RandomState(seed))

    t0 = time.perf_counter()
    _run_cli(port_eval, [xml, model, regions, "--bed", out_bed,
                         "--device", device])
    t_eval = time.perf_counter() - t0
    names = port_hmm.MultitrackHmm.load(model, "cpu").state_names
    decoded = _paint(out_bed, n, names)
    acc = _majority_accuracy(decoded, truth, len(names))
    print(f"[em] decoded with eval --bed: base accuracy {acc:.6f} after "
          f"mapping each learned state to its majority planted state",
          flush=True)
    e_steps = stages.calls["E-step (K1)"]
    per_iter = (stages.seconds["E-step (K1)"]
                + stages.seconds["M-step"]) / max(e_steps, 1)
    print("[em] stage                    seconds", flush=True)
    for stage, sec in stages.seconds.items():
        print(f"[em] {stage:24s} {sec:9.3f}  ({stages.calls[stage]} calls)",
              flush=True)
    print(f"[em] {'E-step + M-step / iter':24s} {per_iter:9.4f}",
          flush=True)
    print(f"[em] {'train CLI total':24s} {t_train:9.3f}", flush=True)
    print(f"[em] {'eval CLI total':24s} {t_eval:9.3f}", flush=True)
    print(f"[em] peak device memory allocated during training: "
          f"{peak:.1f} MB", flush=True)
    return launches, k1_err


def _k1_at_em_shape(model_path, symbols, rng, rows=K1_EM_ROWS):
    """K1 against its plain version at the EM run's own shape: the
    learned model on the first ``rows`` staged rows (chunks of
    EM_CHUNK), with ragged lengths.  Each warp sums up to EM_CHUNK
    positions into its float32 statistics."""
    import torch

    from tehmm_tpu_torch.models.hmm import MultitrackHmm

    p = MultitrackHmm.load(model_path, "cuda").params
    sym = symbols[:rows].contiguous()
    B, L, T = sym.shape
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    lengths[:4] = [L, 0, 1, 2]
    lens = torch.from_numpy(lengths).to(sym.device)
    err, once = _k1_against_plain(p, sym, lens)
    S, _T, V = p.log_em.shape
    print(f"[em] K1 at this run's shape (learned model, S={S} T={T} V={V}, "
          f"{B} rows of L={L}, ragged): within tolerance of the plain "
          f"version, repeat runs bit-identical", flush=True)
    for name in EM_KERNELS:
        print(f"[em] {name:22s} max_abs_err {err[name]:.3g}  kernel "
              f"{once[name]:10.3f} ms  plain {once[name + ' plain']:10.3f} "
              f"ms (one call each)", flush=True)
    return err


def phase_em_card_vs_cpu(work, xml, n, region, seed, device="cuda"):
    """3c: the same EM on the card (K1) and on the CPU (plain torch)."""
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.cli import train as port_train
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    lo = n // 2
    bed = _region_bed(work, "em_small.bed", lo, lo + region)
    runs = {}
    for dev in (device, "cpu"):
        model = os.path.join(work, f"em_small_{dev}.npz")
        log = os.path.join(work, f"em_small_{dev}.jsonl")
        t0 = time.perf_counter()
        _run_cli(port_train, [xml, bed, model, "--iter", "5", "--chunk",
                              "4096", "--seed", str(seed), "--numStates",
                              str(EM_STATES), "--device", dev,
                              "--logJson", log])
        wall = time.perf_counter() - t0
        out = os.path.join(work, f"em_small_{dev}.bed")
        _run_cli(port_eval, [xml, model, bed, "--bed", out,
                             "--device", dev])
        runs[dev] = (np.load(model), _em_log(log), out)
        print(f"[em-small] {region}-position region on {dev}: train CLI "
              f"{wall:.2f} s", flush=True)
    (gz, glog, gbed), (cz, clog, cbed) = runs[device], runs["cpu"]
    assert len(glog) == len(clog), (len(glog), len(clog))
    g_ll = np.asarray([r["loglik"] for r in glog])
    c_ll = np.asarray([r["loglik"] for r in clog])
    rel = float(np.max(np.abs(g_ll - c_ll) / np.abs(c_ll)))
    assert rel <= 1e-5, f"card and CPU logliks differ by {rel} relative"
    names = [str(i) for i in range(EM_STATES)]
    g_path = _paint_region(gbed, lo, region, names)
    c_path = _paint_region(cbed, lo, region, names)
    # EM feeds each iteration's float32 rounding back through rows that
    # few positions support, so each state's learned row is held to half
    # an expected count of the positions behind it (the CPU decode's
    # occupancy n_s), never tighter than 1e-4 and never looser than 1e-3:
    # a state with fewer than 500 positions is left out and said so
    diff = {k: np.abs(np.exp(gz[k]) - np.exp(cz[k]))
            for k in ("log_start", "log_trans", "log_em")}
    start_err = float(diff["log_start"].max())
    assert start_err <= 1e-4, \
        f"card and CPU start probabilities differ by {start_err}"
    occupancy = np.bincount(c_path.astype(np.int64), minlength=EM_STATES)
    held = occupancy >= 500
    limit = np.clip(0.5 / np.maximum(occupancy, 1), 1e-4, 1e-3)
    row_err = np.maximum(diff["log_trans"].max(axis=1),
                         diff["log_em"].max(axis=(1, 2)))
    print(f"[em-small] learned rows, card vs CPU: occupancy "
          f"{occupancy.tolist()}, largest probability difference per "
          f"state {[float(f'{e:.3g}') for e in row_err]}, limit "
          f"{[float(f'{x:.3g}') for x in limit]}, states skipped for "
          f"fewer than 500 positions: {np.flatnonzero(~held).tolist()}",
          flush=True)
    assert occupancy[held].sum() >= 0.9 * region, \
        f"the held states cover only {occupancy[held].sum()} positions"
    assert (row_err[held] <= limit[held]).all(), \
        f"card and CPU probabilities differ by {row_err} (limit {limit})"
    prob_err = max(start_err, float(row_err[held].max()))
    agree = float((g_path == c_path).mean())
    assert agree >= 0.999, f"card and CPU BED agree on {agree} of bases"
    print(f"[em-small] card vs CPU: {len(glog)} iterations each, loglik "
          f"rel err {rel:.3g}, probability abs err {prob_err:.3g}, BED "
          f"agrees on {agree:.6f} of bases", flush=True)

    # two restarts on the card: K1 runs for each, every E-step
    ck.reset_launch_counts()
    log = os.path.join(work, "em_reps.jsonl")
    _run_cli(port_train, [xml, bed, os.path.join(work, "em_reps.npz"),
                          "--iter", "3", "--chunk", "4096", "--seed",
                          str(seed), "--numStates", str(EM_STATES),
                          "--reps", "2", "--device", device,
                          "--logJson", log])
    logged = len(_em_log(log))
    fwd, bwd = ck.LAUNCHES["em_fwd"], ck.LAUNCHES["em_bwd_stats"]
    assert fwd == bwd and fwd in (2 * logged, 2 * (logged + 1)), \
        f"--reps 2: {fwd}/{bwd} K1 launches for {logged} iterations"
    print(f"[em-small] --reps 2 on the card: {fwd} em_fwd and {bwd} "
          f"em_bwd_stats launches over {logged} logged iterations "
          f"(one pair per restart per E-step)", flush=True)
    return rel, prob_err, agree


def _paint_region(bed_path, lo, n, names):
    from tehmm_tpu_torch.io import read_bed_intervals

    out = np.full(n, -1, np.int16)
    for _chrom, s, e, name in read_bed_intervals(bed_path, ncol=4):
        out[s - lo:e - lo] = names.index(name)
    assert (out >= 0).all(), f"{bed_path} does not tile the region"
    return out


# ---------------------------------------------------------------------
# phase 3e: gaussian tracks and segment mode
# ---------------------------------------------------------------------

def make_gauss_track(work, rng, truth):
    """3e's gaussian BED track (one record per GAUSS_RECORD bases, its
    value ~ N(GAUSS_MU[state at the record's first base], 1) in column 4)
    and three track lists over phase 3's files: base resolution (the 4
    BED tracks, FASTA and the gaussian track), segment mode (the 4 BED
    tracks and the gaussian track: a per-base sequence column would make
    every base its own segment) and categorical segment mode (the 4 BED
    tracks)."""
    n = len(truth)
    starts = np.arange(0, n, GAUSS_RECORD, dtype=np.int64)
    ends = np.minimum(starts + GAUSS_RECORD, n)
    vals = rng.normal(GAUSS_MU[truth[starts]], 1.0)
    with open(os.path.join(work, "gauss.bed"), "w") as fh:
        fh.write("".join(
            f"chr1\t{s}\t{e}\tg\t{v:.4f}\n"
            for s, e, v in zip(starts.tolist(), ends.tolist(), vals.tolist())
        ))
    bed = [f'  <track name="bed{k}" path="bed{k}.bed"/>'
           for k in range(T - 1)]
    seq = '  <track name="seq" path="genome.fa"/>'
    gauss = ('  <track name="score" path="gauss.bed" '
             'distribution="gaussian" valCol="4"/>')
    paths = []
    for name, lines in (("tracks_gauss.xml", bed + [seq, gauss]),
                        ("tracks_seg.xml", bed + [gauss]),
                        ("tracks_cat.xml", bed)):
        paths.append(os.path.join(work, name))
        with open(paths[-1], "w") as fh:
            fh.write("<teModelConfig>\n" + "\n".join(lines)
                     + "\n</teModelConfig>\n")
    return paths


def phase_gauss_base(work, xml, truth_bed, truth, small, region, em_region,
                     seed, device="cuda"):
    """3e, base resolution: ``train --supervised`` and the stitched
    ``eval --bed`` of the whole chromosome with the gaussian track (K2
    with the gaussian stream), stitched ``--maxPost`` on a region (K1's
    forward and K4 with it) and EM on a smaller region (K1 with it); then
    the card against the CPU for the Viterbi decode and the EM.  Returns
    the main path's launch counts."""
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.cli import train as port_train
    from tehmm_tpu_torch.models.hmm import MultitrackHmm
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    n = len(truth)
    lo = n // 4
    regions = _region_bed(work, "gauss_regions.bed", 0, n)
    model = os.path.join(work, "gauss_model.npz")
    out_bed = os.path.join(work, "gauss_decoded.bed")
    stages = _Stages()
    stages.wrap(port_train, "load_track_data", "train: load")
    stages.wrap(MultitrackHmm, "supervised", "train: count + M-step")
    stages.wrap(port_eval, "load_track_data", "eval: load")
    stages.wrap(MultitrackHmm, "decode_tables", "eval: decode (K2 +g)",
                sync=True, keep=True)
    stages.wrap(port_eval, "path_log_score", "eval: path score")
    stages.wrap(port_eval, "write_bed_intervals", "eval: write")
    try:
        t0 = time.perf_counter()
        _run_cli(port_train, [xml, truth_bed, model, "--supervised",
                              "--device", device])
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        score = float(_run_cli(port_eval, [xml, model, regions, "--bed",
                                           out_bed, "--device", device]))
        t_eval = time.perf_counter() - t0
    finally:
        stages.restore()
    # --maxPost (K4 with the gaussian stream) on a region
    mp_out = os.path.join(work, "gauss_maxpost.bed")
    t0 = time.perf_counter()
    mp_score = float(_run_cli(port_eval, [
        xml, model, _region_bed(work, "gauss_mp.bed", lo, lo + region),
        "--bed", mp_out, "--maxPost", "--no-exact", "--device", device]))
    t_mp = time.perf_counter() - t0
    # EM with the gaussian track (K1 with the gaussian stream)
    em_bed = _region_bed(work, "gauss_em.bed", lo, lo + em_region)
    em_logs = {}
    for dev in (device, "cpu"):
        em_logs[dev] = os.path.join(work, f"gauss_em_{dev}.jsonl")
        t0 = time.perf_counter()
        _run_cli(port_train, [
            xml, em_bed, os.path.join(work, f"gauss_em_{dev}.npz"),
            "--iter", "5", "--chunk", "4096", "--seed", str(seed),
            "--numStates", str(EM_STATES), "--device", dev,
            "--logJson", em_logs[dev]])
        if dev == device:
            t_em = time.perf_counter() - t0
            launches = dict(ck.LAUNCHES)
    _paths, report = stages.last["eval: decode (K2 +g)"]
    assert report.boundaries_ok, report
    assert np.isfinite(score), score
    m = MultitrackHmm.load(model, "cpu")
    assert m.gauss is not None and tuple(m.gauss.mu.shape) == (S, 1)
    names = m.state_names
    decoded = _paint(out_bed, n, names)
    name_idx = np.asarray([int(s[1:]) for s in names])
    acc = float((name_idx[decoded] == truth).mean())
    print(f"[gauss] {n} positions, T={T + 1} (the gaussian track keeps an "
          f"all-missing symbol column), G=1: printed path score {score!r}; "
          f"{report}; base accuracy {acc:.6f}", flush=True)
    assert acc >= 0.9, f"base accuracy with the gaussian track {acc} < 0.9"
    mp = _paint_region(mp_out, lo, region, names)
    mp_acc = float((name_idx[mp] == truth[lo:lo + region]).mean())
    assert np.isfinite(mp_score) and mp_acc >= 0.9, (mp_score, mp_acc)
    print(f"[gauss] {region}-position region --maxPost (stitched): printed "
          f"loglik {mp_score!r}, base accuracy {mp_acc:.6f}, eval CLI "
          f"{t_mp:.3f} s", flush=True)
    g_ll, c_ll = ([r["loglik"] for r in _em_log(em_logs[d])]
                  for d in (device, "cpu"))
    assert len(g_ll) == len(c_ll) and np.isfinite(g_ll).all()
    em_rel = float(np.max(np.abs(np.subtract(g_ll, c_ll)) / np.abs(c_ll)))
    assert em_rel <= 1e-5, \
        f"gaussian EM: card and CPU logliks differ by {em_rel} relative"
    print(f"[gauss] {em_region}-position region EM ({EM_STATES} states): "
          f"{len(g_ll)} iterations on the card and the CPU, logliks within "
          f"{em_rel:.3g} relative; card train CLI {t_em:.3f} s", flush=True)

    small_bed = _region_bed(work, "gauss_small.bed", lo, lo + small)
    got = {}
    for dev in (device, "cpu"):
        out = os.path.join(work, f"gauss_small_{dev}.bed")
        s = float(_run_cli(port_eval, [xml, model, small_bed, "--bed", out,
                                       "--no-exact", "--device", dev]))
        got[dev] = (open(out).read(), s)
    assert got[device][0] == got["cpu"][0], \
        "card and CPU BED differ on the small region (gaussian track)"
    rel = abs(got[device][1] - got["cpu"][1]) / abs(got["cpu"][1])
    assert rel <= 1e-5, f"card and CPU scores differ by {rel} relative"
    print(f"[gauss] {small}-position region: card BED == CPU BED, printed "
          f"scores within {rel:.3g} relative", flush=True)
    print("[gauss] stage                      seconds", flush=True)
    for stage, sec in stages.seconds.items():
        print(f"[gauss] {stage:26s} {sec:9.3f}", flush=True)
    print(f"[gauss] {'train CLI total':26s} {t_train:9.3f}", flush=True)
    print(f"[gauss] {'eval CLI total':26s} {t_eval:9.3f}", flush=True)
    return launches


def _segment(work, xml, lo, hi, name):
    """segment_tracks over [lo, hi); returns (segments BED, count)."""
    from tehmm_tpu_torch.cli import segment_tracks as port_seg

    segs = os.path.join(work, name)
    with contextlib.redirect_stderr(io.StringIO()):
        _run_cli(port_seg, [xml, _region_bed(work, name + ".region", lo,
                                             hi), segs])
    with open(segs) as fh:
        return segs, sum(1 for _ in fh)


def phase_segments(work, xml, truth, seed, device="cuda"):
    """3e, segment mode on the whole chromosome: ``segment_tracks``,
    ``train --segment --segLen`` (K1 with both streams), ``eval
    --segment --segLen --bed`` (K2 with both) and ``--maxPost`` (K4 with
    both).  Returns the main path's launch counts."""
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.cli import segment_tracks as port_seg
    from tehmm_tpu_torch.cli import train as port_train
    from tehmm_tpu_torch.models import hmm as port_hmm
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import em as port_em

    n = len(truth)
    stages = _Stages()
    stages.wrap(port_seg, "load_track_data", "segment_tracks: load")
    stages.wrap(port_seg, "segment_table", "segment_tracks: segment")
    stages.wrap(port_train, "load_segment_data", "train: load segments")
    stages.wrap(port_em, "em_sufficient_stats", "train: E-step (K1 +wg)",
                sync=True)
    stages.wrap(port_em, "em_m_step", "train: M-step", sync=True)
    stages.wrap(port_eval, "load_segment_data", "eval: load segments")
    stages.wrap(port_eval, "viterbi_chunked", "eval: decode (K2 +wg)",
                sync=True, keep=True)
    stages.wrap(port_hmm, "posterior_chunked", "eval: decode (K4 +wg)",
                sync=True, keep=True)
    stages.wrap(port_eval, "path_log_score", "eval: path score")
    stages.wrap(port_hmm.MultitrackHmm, "score", "eval: score (X1)",
                sync=True)
    stages.wrap(port_eval, "write_bed_intervals", "eval: write")
    model = os.path.join(work, "seg_model.npz")
    log = os.path.join(work, "seg_log.jsonl")
    walls = {}
    try:
        t0 = time.perf_counter()
        segs, n_segs = _segment(work, xml, 0, n, "segments.bed")
        walls["segment_tracks CLI"] = time.perf_counter() - t0
        print(f"[seg] segment_tracks: {n_segs} segments from {n} positions "
              f"({n / n_segs:.1f}x compression)", flush=True)
        t0 = time.perf_counter()
        _run_cli(port_train, [
            xml, segs, model, "--segment", "--segLen", "--numStates",
            str(SEG_STATES), "--iter", str(SEG_ITERS), "--seed", str(seed),
            "--device", device, "--logJson", log])
        walls["train CLI"] = time.perf_counter() - t0
        scores = {}
        for mode, flags in (("Viterbi", []), ("--maxPost", ["--maxPost"])):
            out = os.path.join(work, f"seg_decoded{len(scores)}.bed")
            t0 = time.perf_counter()
            scores[mode] = float(_run_cli(port_eval, [
                xml, model, segs, "--segment", "--segLen", "--bed", out,
                "--no-exact", "--device", device, *flags]))
            walls[f"eval {mode} CLI"] = time.perf_counter() - t0
            scores[mode + " bed"] = out
    finally:
        stages.restore()
    launches = dict(ck.LAUNCHES)
    lls = [r["loglik"] for r in _em_log(log)]
    assert lls and np.isfinite(lls).all(), f"non-finite loglik: {lls}"
    for i, (a, b) in enumerate(zip(lls, lls[1:])):
        assert b >= a - 1e-4 * abs(a), \
            f"segment loglik fell at iteration {i + 1}: {a} -> {b}"
    print(f"[seg] train --segment --segLen, {SEG_STATES} states: "
          f"{len(lls)} logged iterations, loglik {lls[0]:.6g} -> "
          f"{lls[-1]:.6g} (non-decreasing within 1e-4 |loglik|)",
          flush=True)
    print(f"[seg] loglik trace: {lls}", flush=True)
    _paths, report = stages.last["eval: decode (K2 +wg)"]
    assert report.boundaries_ok, report
    names = port_hmm.MultitrackHmm.load(model, "cpu").state_names
    for mode in ("Viterbi", "--maxPost"):
        assert np.isfinite(scores[mode]), scores
        decoded = _paint(scores[mode + " bed"], n, names)
        acc = _majority_accuracy(decoded, truth, len(names))
        print(f"[seg] eval --segment --segLen {mode}: printed score "
              f"{scores[mode]!r}, base accuracy {acc:.6f} after mapping "
              f"each learned state to its majority planted state",
              flush=True)
    print(f"[seg] Viterbi decode: {report}", flush=True)
    print("[seg] stage                      seconds  calls", flush=True)
    for stage, sec in stages.seconds.items():
        print(f"[seg] {stage:26s} {sec:9.3f}  {stages.calls[stage]}",
              flush=True)
    for name, sec in walls.items():
        print(f"[seg] {name:26s} {sec:9.3f}", flush=True)
    return launches


def phase_segments_card_vs_cpu(work, xml_seg, xml_cat, n, region, seed,
                               device="cuda"):
    """3e, segment mode on the card against the CPU on a region: the
    same ``train --segment --segLen`` and ``eval --segment --segLen``
    (Viterbi and ``--maxPost``, stitched) with the gaussian track, then
    with the categorical tracks only.  Returns the launch counts of the
    categorical card runs (their own path: the weight stream alone)."""
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.cli import train as port_train
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    lo = n // 2
    names = [str(i) for i in range(SEG_STATES)]
    cat_launches = None
    for tag, xml in (("gauss", xml_seg), ("categorical", xml_cat)):
        segs, n_segs = _segment(work, xml, lo, lo + region,
                                f"seg_small_{tag}.bed")
        runs = {}
        for dev in (device, "cpu"):
            if tag == "categorical" and dev == device:
                ck.reset_launch_counts()
            model = os.path.join(work, f"seg_small_{tag}_{dev}.npz")
            log = os.path.join(work, f"seg_small_{tag}_{dev}.jsonl")
            _run_cli(port_train, [
                xml, segs, model, "--segment", "--segLen", "--iter", "5",
                "--chunk", "1024", "--seed", str(seed), "--numStates",
                str(SEG_STATES), "--device", dev, "--logJson", log])
            paths = []
            for flags in ([], ["--maxPost"]):
                out = os.path.join(work, f"seg_small_{tag}_{dev}"
                                         f"{len(paths)}.bed")
                _run_cli(port_eval, [xml, model, segs, "--segment",
                                     "--segLen", "--bed", out, "--no-exact",
                                     "--device", dev, *flags])
                paths.append(_paint_region(out, lo, region, names))
            if tag == "categorical" and dev == device:
                cat_launches = dict(ck.LAUNCHES)
            runs[dev] = ([r["loglik"] for r in _em_log(log)], paths)
        (g_ll, g_paths), (c_ll, c_paths) = runs[device], runs["cpu"]
        assert len(g_ll) == len(c_ll), (len(g_ll), len(c_ll))
        rel = float(np.max(np.abs(np.subtract(g_ll, c_ll))
                           / np.abs(c_ll)))
        assert rel <= 1e-5, f"{tag}: card and CPU segment logliks differ " \
            f"by {rel} relative"
        agree = [float((g == c).mean()) for g, c in zip(g_paths, c_paths)]
        assert min(agree) >= 0.999, \
            f"{tag}: card and CPU segment BED agree on {agree} of bases"
        print(f"[seg-small] {region}-position region, {tag} tracks, "
              f"{n_segs} segments: {len(g_ll)} EM iterations each, loglik "
              f"rel err {rel:.3g}; BED agrees on {agree[0]:.6f} (Viterbi) "
              f"and {agree[1]:.6f} (--maxPost) of bases", flush=True)
    return cat_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    device = torch.device("cuda")
    smi = _smi()
    print(f"[device] {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    ck.load_library()
    print(f"[build] {len(ck.SOURCES)} sources: "
          f"{time.perf_counter() - t0:.2f} s -> {ck.library_path()}",
          flush=True)

    rng = np.random.RandomState(args.seed)
    kernels = phase_kernels(device, rng)
    kernels.update(phase_k1(device, rng))
    kernels.update(phase_post_kernels(device, rng))
    # the stream checks draw from their own generator, so the data of
    # phase 3 on are the same draws with and without them
    kernels.update(phase_stream_kernels(
        device, np.random.RandomState(args.seed + 1)))
    torch.cuda.empty_cache()
    kernels.update(phase_streaming_kernels(
        device, np.random.RandomState(args.seed + 2), args.seed))
    engine_launches = phase_engines(args.seed)

    n = N_POSITIONS
    with tempfile.TemporaryDirectory(prefix="tehmm_chip_smoke_") as work:
        t0 = time.perf_counter()
        xml, truth_bed, truth = make_dataset(work, rng, n)
        print(f"[e2e] dataset: {n} positions, {T} tracks, "
              f"{time.perf_counter() - t0:.1f} s to write", flush=True)

        ck.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        _acc, viterbi_score = phase_end_to_end(work, xml, truth_bed, truth,
                                               1_000_000, 20_000)
        decode_launches = dict(ck.LAUNCHES)
        print(f"[e2e] peak device memory allocated: "
              f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB",
              flush=True)

        ck.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        post_launches = phase_max_posterior(work, xml, truth, viterbi_score,
                                            1_000_000, 20_000, 100_000)
        print(f"[post] peak device memory allocated: "
              f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB",
              flush=True)

        ck.reset_launch_counts()
        em_launches, k1_em_err = phase_em(work, xml, truth, args.seed)
        for name, e in k1_em_err.items():
            kernels[name]["max_abs_err_em_run_shape"] = e

        phase_em_card_vs_cpu(work, xml, n, 50_000, args.seed)

        t0 = time.perf_counter()
        xml_g, xml_seg, xml_cat = make_gauss_track(work, rng, truth)
        print(f"[gauss] gaussian track: {n // GAUSS_RECORD} records, "
              f"{time.perf_counter() - t0:.1f} s to write", flush=True)
        ck.reset_launch_counts()
        gauss_launches = phase_gauss_base(work, xml_g, truth_bed, truth,
                                          20_000, 1_000_000, 50_000,
                                          args.seed)
        ck.reset_launch_counts()
        seg_launches = phase_segments(work, xml_seg, truth, args.seed)
        cat_launches = phase_segments_card_vs_cpu(work, xml_seg, xml_cat, n,
                                                  200_000, args.seed)
    for config, counts in engine_launches.items():
        print(f"[launches] engine-comparison path (2e) at {config}: "
              f"{ {k: n for k, n in counts.items() if n} }", flush=True)
    print(f"[launches] decode path (phase 3): {decode_launches}",
          flush=True)
    print(f"[launches] EM path (phase 3b): {em_launches}", flush=True)
    print(f"[launches] max-posterior path (phase 3d): {post_launches}",
          flush=True)
    print(f"[launches] gaussian base-resolution path (3e): "
          f"{gauss_launches}", flush=True)
    print(f"[launches] segment path (3e): {seg_launches}", flush=True)
    print(f"[launches] categorical segment path (3e, card runs): "
          f"{cat_launches}", flush=True)
    missing = [k for k in DECODE_KERNELS if decode_launches[k] == 0]
    missing += [k for k in EM_KERNELS if em_launches[k] == 0]
    missing += [f"{k} (3d)" for k in POST_KERNELS if post_launches[k] == 0]
    missing += [f"{k} (3e)" for k in GAUSS_BASE_KERNELS
                if gauss_launches[k] == 0]
    missing += [f"{k}+wg (3e)" for k in SEGMENT_KERNELS
                if seg_launches[k + "+wg"] == 0]
    missing += [f"{k}+w (3e)" for k in SEGMENT_KERNELS
                if cat_launches[k + "+w"] == 0]
    missing += [f"{k} (2e, {config})" for config in ENGINE_CONFIGS
                for k in STREAMING_KERNELS + ("viterbi_backtrace",)
                if engine_launches[config][k] == 0]
    assert not missing, f"kernels never launched on their path: {missing}"
    launches = {k: decode_launches[k] for k in DECODE_KERNELS}
    launches.update({k: em_launches[k] for k in EM_KERNELS})
    launches.update({k: post_launches[k] for k in POST_KERNELS
                     if k not in launches})
    by_variant = {"+g": gauss_launches, "+wg": seg_launches,
                  "+w": cat_launches}
    for name in kernels:
        base, _, config = name.partition("@")
        if "+" in name:
            launches[name] = by_variant["+" + name.split("+")[1]][name]
        elif config or base in STREAMING_KERNELS:
            launches[name] = \
                engine_launches[config or ENGINE_CONFIGS[0]][base]
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "tehmm_tpu")
                   for m in sys.modules), "jax or tehmm_tpu was imported"

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source=SOURCES[name.split("+")[0].split("@")[0]],
             replaces=REPLACES[name.split("+")[0].split("@")[0]],
             launches=launches[name], **r)
        for name, r in kernels.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
