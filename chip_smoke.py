#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--parent DIR]

Phases (any failure raises, and the run exits non-zero):

1. Device and build: the card's name and power limit, and the build of
   the CUDA kernels from ``tehmm_tpu_torch/csrc/*.cu`` (one nvcc per
   source, in parallel).
2. Each kernel against its plain-torch version on the card.  The decode
   kernels (K2, K3) at the decode's shapes (S=10 states, T=5 tracks, V=9
   symbols, B=512 rows of L=4608 = chunk 4096 + 2 x 256 halo, ragged
   lengths incl. 0 and 1): value rows, normalizers, carries and paths
   bit-equal; K2's forward (to 32 states its lanes kernel, ``ck.k2_step``)
   in both modes (value rows, and the pointer mode's first-hit pointers
   and last rows) bit for bit the plain versions and the shared kernel
   forced (timed beside it), the value-row backtrace on its rows and
   X3's chase over its pointers (K2's backtrace) the same path on every
   row; K3 in its values, carry, checkpoint and pointer modes, and
   X3 (the exact decoder's backtrace from K3's pointers: the map of end
   states, the compose, the chase) on the same rows.  K3 and X3 also at
   the shapes phase 3's ``--exact`` region gives them (a generator of
   their own): the pointer recompute, map, compose and chase of one
   chunk (1 x 4096) and of the region's group (245 rows of 4096, each
   from its own carry), and the forward sweep over the region in one
   checkpoint launch (1 x 1,003,520, a carry every 4096), bit-equal to
   plain, timed with us a step.  X1 likewise
   at the shapes phase 3d's ``--maxPost --exact`` region gives it: the
   recompute (1 x 4096, 245 x 4096, and 512 rows of 4608, ragged) and
   the forward sweep in one checkpoint launch (1 x 1,003,520), each
   within the F3 limit of its plain version carried in float64 (the
   sweep chunk by chunk from its own carries, and against the float64
   chain over its first chunks).  X2 likewise: the beta recompute (1 x
   4096, 245 x 4096 with each row's own ``continuing``, 512 rows of
   4608, ragged) and the backward sweep in one checkpoint launch (1 x
   1,003,520 from its end), each within the F3 limit of its plain
   version carried in float64 (the sweep chunk by chunk from its own
   stored x_carry, and against the float64 chain over its last chunks).
   The E-step kernels (K1) at bench.py's shape (S=20, T=5,
   V=8, B=2048, L=1024, ragged lengths incl. 0, 1 and 2): statistics and
   logliks within the JAX package's engine tolerances of the plain
   version and of the plain log-space E-step, and bit-identical across
   two launches; to 32 states the lanes kernels run (``ck.k1_step``),
   and every output of both (alpha_p, dm, m_raw, start, pair, em, the
   gaussian moments) is bit for bit the shared kernels', forced with
   ``K1_LANES_MAX_STATES`` = 0 (timed beside; the ``kernels`` line names
   the step).  (K1 is checked again at the EM run's own shape in 3b.)
   The K4 decode at the stitched max-posterior decode's shapes (S=10,
   T=5, V=9, rows of L=4608, ragged lengths incl. 0 and 1: 64, the pass
   before 512, and the pass of ``stitch.MAXPOST_ROWS_PER_PASS``, 512):
   to 32 states the lanes kernel runs (``ck.k4_step``), bit for bit the
   shared kernel's (forced with ``K4_LANES_MAX_STATES`` = 0, timed
   beside it); paths agree with the plain version on >= 99.999% of
   positions, every differing position a near-tie (the plain version's
   top two alpha_p * b within 1e-5 relative), two launches
   bit-identical.  The chunk sweeps X1 and X2
   on obs of 4 rows of 4096 (ragged): hats, carries, betas and x_out
   within 1e-5 plus 4 float32 ulps of the largest |obs| of the plain
   versions carried in float64 (the F3 limit; the float32 plain version
   held to it too), the summed normalizers within 1e-6 relative and
   1e-6 absolute (each check's worst ratio of error to its limit
   printed), two launches bit-identical; the same X1/X2 check again on
   8 draws, seeds 0-7 of its own generator.  The piece-operator scan
   (``ck.forward_loglik``: ``fwd_piece_ops``, ``fwd_piece_compose``; the
   score's route) on a generator of its own at S=10, on 1 row of 4096
   (the eval CLI's score launch), 4 rows of 4096 (ragged) and 1 row of
   16384: each kernel and the whole scan against the plain versions in
   float64 (probability rows and carries within the F3 limit, sums of k
   normalizers within 1e-6 relative plus ``_sum_atol``), two launches
   bit-identical, timed (each kernel's bound is the function's, X1's
   carry-only one, with its own design bound beside it); then the
   same-call A/B of the chain (X1 carry-only) against the pieces at S=10,
   64, 168, 169 and 239 on 1 x 16384 and 4 x 4096 full rows, both held
   to the float64 chain.  Then K2's
   forward, K1 and
   the K4 decode with each optional observation stream (segment weights
   in [1, 64], 2 gaussian tracks with 10% missing values, both) at the
   same shapes:
   K2's value rows, normalizers and paths bit-equal, K1 at the same
   tolerances (gaussian moments within 1e-4 of each moment's largest
   entry) and bit-identical across two launches, K4 as above (at 64 and
   512 rows).  Times of
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
   On the same obs tensors the log-space scans K7a/K8a (``fwd_scaled``)
   and K7b/K8b (``bwd_scaled``): alpha_hat and beta_hat within 1e-5 plus
   4 float32 ulps of the largest |obs| of the plain version carried in
   float64, log_c and log_d within 1e-5 relative (1e-4 absolute), row
   logliks within 1e-6 relative, two launches bit-identical; and K8c
   (``viterbi_ptrs``) with its chase (``pointer_chase``): pointers, last
   rows, normalizers and paths bit-equal to plain, paths == dp.viterbi.
   All of this also at bench_engines' S512 (T=20, V=16, B=128) and S1024
   (B=64) shapes, past 256 states (uint16 pointers), where K5, K6a/K6b,
   K7a/K7b and K8c run the cluster tile (``viterbi_values_cluster``,
   ``fwd_prob_cluster``, ``bwd_prob_cluster``, ``fwd_scaled_cluster``,
   ``bwd_scaled_cluster``, ``viterbi_ptrs_cluster``): every output bit
   for bit the staged tile's, forced
   (``ck.SCAN_CLUSTER_MAX_STATES`` = 0), each tile timed (the staged
   tile's rows under the old names, the cluster tile's with the staged
   time beside).  To 256 states K7a/K8a, K7b/K8b, K6a, K6b, K5 and K8c
   run their own kernels (``ck.log_scan_route``: the lanes step to 32
   states, the rows kernels beyond; ``fwd_scaled_lanes``,
   ``fwd_prob_rows``, ``viterbi_values_rows``, ``viterbi_ptrs_lanes``,
   ...):
   every output bit for bit the block tile's, forced
   (``ck.LOG_SCAN_MAX_STATES`` = 0), its time beside (``tile_ms``; the
   block tile's rows under the old names).  K6a
   and K6b also at 3f's train shape (S=1024, one row
   of 20,000: ``@3f_fit``), both tiles, bit for bit, within 2e-6 of plain
   in float64.  K9
   (``maxplus_sweeps``) at Sp=256, 512, 1024 x Bg=128 on the JAX tool's
   draw: both layouts (the blocks layout at 8, 16 and 32 rows a block)
   bit-equal to plain, timed.  The carried sweeps past their one-warp
   kernels, K3, X1 and X2 on the tile's carry modes at S=240, 256, 257,
   512 and 1024 (4 rows of 4096, ragged): K3 bit-equal, X1/X2 at the F3
   limit of plain in float64, X1's two modes one carry, a sweep cut into
   three chunks bit-equal to one; at 240 and 256 K3's, X1's and X2's
   carry modes run the rows kernels (``viterbi_chunk_rows``,
   ``fwd_chunk_rows``, ``bwd_chunk_rows``), every output (both of K3's
   and X1's modes) bit for bit the block tile's, forced, and both timed; past
   256 K3's, X1's and X2's run the cluster tile, every output (both of K3's and
   X1's modes) bit for bit the staged tile's, forced, and both timed.
2e. The engine-comparison path through its tools' entry points, at the
   full width of all four ``bench_engines`` shapes (S=20, 64, 128, 256):
   ``tools.bench_engines`` with the E-step engines plain, cuda (K1),
   cuda_v3 (K6) and cuda_log (K7a/K7b), then ``--decode`` with plain,
   streaming (K5), fused (K2) and pointers (K8c + chase), then
   ``--maxpost`` with plain, fused (K4) and scans (K7a/K7b), then
   ``tools.profile_estep`` at S=64 for cuda_v3 and cuda_log.  Every pair
   of engines that ran agrees on the loglik within 1e-4 relative, on
   every position of the Viterbi path and on >= 99.999% of the
   max-posterior path; cuda_v3, cuda_log, streaming, pointers and scans
   ran at all four shapes; a row with an ``error`` is accepted only from
   cuda or fused at S=128 or S=256 and only with the shared-memory
   envelope's message; K5, K6, K7, K8c, the chase and the backtrace
   launched at every shape.  The same at S512 and S1024 with the engines
   that run there (E-step plain, cuda_v3, cuda_log; decode plain,
   streaming, pointers; max-posterior plain, scans).
2m. The K9 tool (``tools.exp_maxplus_s256``) at Sp=256, 512, 1024: every
   formulation ok with max|delta| 0.
3. End to end through the port's CLIs, in-process, at the width of the
   10-state / 5-track supervised decode configuration: a planted
   20,000,000-position chromosome (4 categorical BED tracks + FASTA),
   ``train --supervised`` then stitched ``eval --bed`` on the whole
   chromosome; the BED tiles it, every stitch boundary agrees, and base
   accuracy against the planted truth is >= 0.9; the stitched decode's
   split (chunk forming, H2D, K2's forward, the chase, D2H, the stitch
   and the rest) is printed, K2's lanes forward (pointer mode) and the
   chase launched once a pass of 512 rows, and phase 3 launched no
   value-row backtrace and no shared K2 forward.  On a 1,000,000-position
   region ``--exact`` and ``--no-exact`` write the same BED; the exact
   decode's split (obs formation, forward sweep, pointer recompute, map,
   compose, chase, the rest) is printed, and K3 launched twice a group
   of chunks (``stitch.exact_group_chunks``) and X3's three kernels once
   a group each, with no backtrace a chunk; on a 20,000-position region
   the card's BED equals the CPU's (plain torch).
3d. Max-posterior decoding, ``--pd`` and scoring through ``eval`` with
   phase 3's model: stitched ``--maxPost --bed`` on the whole chromosome
   (K4, and the printed forward loglik through the piece-operator scan):
   the BED tiles it, every stitch boundary agrees, base accuracy >= 0.9,
   and the loglik is finite and at least phase 3's Viterbi path score
   (less 1e-6 of it); the stitched decode's split (chunk forming, H2D,
   K1's forward, K4's decode, D2H, the stitch and the rest) is printed
   and K4 launched once a pass of 512 rows; the decode again as the
   parent ran it (64 rows a pass, the shared decode forced), split the
   same way, gives the same paths; the same score again through the
   chain (X1
   carry-only) and through the pieces, each split into kernels, obs
   formation and ``block_of`` with its H2D copy and the loop, each
   chunk's summed increments within the derived limit of the chain's
   (the printed totals within a sanity bound); the score
   stage launched the piece kernels and no X1.
   On the 1,000,000-position region ``--maxPost --exact`` (X1/X2) and
   ``--no-exact`` (K4) agree on >= 99.999% of bases; the exact decode's
   split (obs formation, forward sweep, recompute, backward sweep, beta
   recompute, gamma and consume) is printed and X1 launched twice a
   group of chunks (the checkpoint sweep and the recompute), X2 twice a
   group (the backward checkpoint sweep and the beta recompute) and once
   for position 0, as in ``--pd``'s sweep on the 100,000-position region;
   with ``--parent DIR`` (a ``git archive`` of an earlier commit, built
   in the background from the start of phase 2; its eval runs go on in
   the background beside the phases after the one that made their
   outputs, from 3c on, so a run with ``--parent`` is not one to read
   those phases' times from) that checkout's eval CLI writes phase 3's
   stitched BED of the chromosome and ``--exact`` BED of the region, the
   whole chromosome's stitched
   ``--maxPost`` BED, the region's ``--maxPost --exact`` BED and the
   100,000-position region's ``--pd`` file and BED byte for byte as
   this one's (and in 3e the stitched Viterbi and ``--maxPost`` BEDs
   with the gaussian stream, +g, and in segment mode, +wg and +w); on the
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
   staged rows of 16384, ragged lengths), at phase 2's tolerances, and
   the lanes kernels bit for bit the shared ones' (forced); K1's step,
   the EM iterations' times (the median, largest and summed spacings of
   the log's timestamps) and each K1 kernel's ms a call in the training
   run beside its launches and bound; with ``--parent DIR`` that
   checkout's train CLI and this one's, each alone in a process on the
   same command, learn the same model (every member of the saved file)
   on the same loglik trace, byte for byte, with both iteration times
   printed; the model decoded with ``eval --bed``; base accuracy
   after mapping each learned state to its majority planted state
   (printed, not asserted); stage times.
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
3f. Past the fused kernels' envelopes at the scan tile's full width,
   1024 states, card against CPU: ``train`` on a 20,000-position region
   through ``"auto"``, which takes cuda_v3 (K6a/K6b on the cluster tile,
   the staged tile's K6 not launched) with passes of 1M
   positions (4M x 256 / S): logliks within 1e-5 relative; with a sticky
   random model on 64 regions of 15,625 positions (1,000,000) the
   stitched Viterbi (obs, K5 on the cluster tile, backtrace), the exact
   Viterbi (K3's carry mode on the cluster tile; == the stitched paths),
   the stitched max-posterior (K7a/K7b on the cluster tile),
   ``posterior_sweep`` (``--pd``'s path: X1/X2 on the cluster tile) and
   the score (X1 on the cluster tile), none of them launching the staged
   tile's K5, K7a/K7b or carry modes; both Viterbi decoders again with
   the staged tile forced (the same paths, both times printed); the CPU,
   in a process of its own beside 3c, 3f and 3e (its train and the
   decoders; held to the card's after 3e), on 46,875 of those positions
   (15,625 for ``--pd``
   and the score): Viterbi paths equal; max-posterior and ``--pd``'s
   argmax (against the CPU's, and on the card against each other) equal
   on >= 99.999% of positions, every differing one a near-tie (printed
   with its gap); gammas within 1e-5, scores within 1e-5 relative.
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
3w. The workflow tools, in-process through the dispatcher
   (``tehmm_tpu_torch.__main__``), on a planted chromosome of their own
   (1,000,000 positions, the same 10 states, 5 tracks and 9 symbols,
   drawn from a generator of its own into a subdirectory):
   ``benchmark --device cuda`` with ``sup`` (supervised) and ``em10``
   (10 states, 5 EM iterations: K1, then K2's lanes forward and the
   chase) -- both entries without error, ``sup``'s base accuracy >= 0.9,
   ``em10``'s printed and in [0, 1] -- and ``sup`` again on ``--device
   cpu``: the same ``pred.bed`` byte for byte and the same summary
   entry but the seconds; ``compare-bed-states`` of phase 3's stitched
   BED against its truth, whose base accuracy is phase 3's own within
   1e-9; ``fit-state-names`` of ``em10``'s prediction (every interval
   kept under the printed map, which names states 1:1 onto the truth's
   and leaves one unnamed only where every truth name it overlaps is
   taken; the benchmark's renamed BED byte for byte); ``view`` of
   ``sup``'s model, the same text on the card and the
   CPU; ``bed-tools stats`` of phase 3's BED (its bases sum to the
   chromosome); ``python -m tehmm_tpu_torch`` with no tool exits 2,
   ``--help`` 0, an unknown tool 2, and ``import-model`` exits naming
   its ROADMAP item.  Stage times.
4. The launch counters, zeroed just before each tool run of 2e and 2m,
   phase 3, 3d, 3b's training run, 3f's training run and five decodes,
   3e's base-resolution, segment and categorical segment runs, and 3w,
   and read just after each, show every kernel and stream variant of
   each path ran on it.

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
# K3 at the shapes of phase 3's --exact region (1,000,000 positions,
# eval's chunks of 4096: 245 of them, one group): the recompute of one
# chunk and of the group (a row per chunk, the last one 583 long), and
# the forward sweep over the region in one checkpoint launch
EXACT_REGION, EXACT_CHUNK = 1_000_000, 4096
EXACT_CHUNKS = -(-(EXACT_REGION - 1) // EXACT_CHUNK)
# the plain chain (a Python loop a position) is timed over these, once,
# and the plain values modes once a shape: the host's time, which varies
# most from machine to machine, is kept small
PLAIN_CHUNKS = 4
# the piece-operator scan: the eval CLI's score launch (one table, chunks
# of 4096), the chunk sweeps' check, MultitrackHmm.score's default chunk;
# its A/B against the chain at these S and (rows, L)
PIECE_SHAPES = ((1, 4096), (X_B, X_L), (1, 16384))
PIECE_AB_STATES = (10, 64, 168, 169, 239)
PIECE_AB_SHAPES = ((1, 16384), (X_B, X_L))
F3_SEEDS = 8                         # further draws of that check
NEAR_TIE = 1e-5                      # K4: relative gap of a near-tie
STREAM_VARIANTS = ("+w", "+g", "+wg")  # weights, gaussian tracks, both
STREAM_G = 2                         # gaussian tracks of phase 2's streams
W_LO, W_HI = 1.0, 64.0               # phase 2's segment weights
GAUSS_RECORD = 500                   # 3e: bases per gaussian-track record
GAUSS_MU = np.linspace(-4.5, 4.5, S)  # 3e: that track's per-state mean
SEG_STATES, SEG_ITERS = 10, 15       # 3e: segment-mode EM
# 3f: every route past the fused kernels' envelopes at the scan tile's
# full width: "auto" training (-> cuda_v3) on a region, the decoders and
# the score on ENV_TABLES regions of ENV_TABLE_LEN positions, the CPU on
# the first ENV_CPU_TABLES of them (ENV_PD_TABLES for --pd's gammas)
ENV_STATES = 1024
ENV_FIT_REGION, ENV_FIT_ITERS, ENV_FIT_CHUNK = 20_000, 3, 20_000
ENV_TABLES, ENV_TABLE_LEN = 64, 15_625
ENV_CPU_TABLES, ENV_PD_TABLES, ENV_PD_CHUNK = 3, 1, 4096
# the CPU's rows a pass at ENV_STATES (256 / S of it: one): its plain
# steps make [rows, S, S] temporaries that leave the caches past a row
ENV_CPU_ROWS = 4
# the card's published peaks (H100 SXM datasheet: HBM3
# at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s)
H100_BYTES_PER_S, H100_F32_PER_S = 3.35e12, 67e12
SOURCES = {
    "viterbi_fwd": "tehmm_tpu_torch/csrc/viterbi.cu",
    "viterbi_fwd_lanes": "tehmm_tpu_torch/csrc/viterbi.cu",
    "viterbi_backtrace": "tehmm_tpu_torch/csrc/viterbi.cu",
    "viterbi_chunk_values": "tehmm_tpu_torch/csrc/viterbi.cu",
    "viterbi_checkpoints": "tehmm_tpu_torch/csrc/viterbi.cu",
    "viterbi_chunk_pointers": "tehmm_tpu_torch/csrc/viterbi.cu",
    "chunk_entry_map": "tehmm_tpu_torch/csrc/viterbi.cu",
    "chunk_compose": "tehmm_tpu_torch/csrc/viterbi.cu",
    "chunk_chase": "tehmm_tpu_torch/csrc/viterbi.cu",
    "em_fwd": "tehmm_tpu_torch/csrc/em_estep.cu",
    "em_bwd_stats": "tehmm_tpu_torch/csrc/em_estep.cu",
    "post_decode": "tehmm_tpu_torch/csrc/posterior.cu",
    "post_decode_lanes": "tehmm_tpu_torch/csrc/posterior.cu",
    "fwd_chunk": "tehmm_tpu_torch/csrc/posterior.cu",
    "fwd_checkpoints": "tehmm_tpu_torch/csrc/posterior.cu",
    "bwd_chunk": "tehmm_tpu_torch/csrc/posterior.cu",
    "bwd_checkpoints": "tehmm_tpu_torch/csrc/posterior.cu",
    "viterbi_values": "tehmm_tpu_torch/csrc/streaming.cu",
    "fwd_prob": "tehmm_tpu_torch/csrc/streaming.cu",
    "bwd_prob": "tehmm_tpu_torch/csrc/streaming.cu",
    "fwd_prob_cluster": "tehmm_tpu_torch/csrc/streaming.cu",
    "bwd_prob_cluster": "tehmm_tpu_torch/csrc/streaming.cu",
    "fwd_prob_lanes": "tehmm_tpu_torch/csrc/streaming.cu",
    "fwd_prob_rows": "tehmm_tpu_torch/csrc/streaming.cu",
    "bwd_prob_lanes": "tehmm_tpu_torch/csrc/streaming.cu",
    "bwd_prob_rows": "tehmm_tpu_torch/csrc/streaming.cu",
    "viterbi_values_lanes": "tehmm_tpu_torch/csrc/streaming.cu",
    "viterbi_values_rows": "tehmm_tpu_torch/csrc/streaming.cu",
    "viterbi_chunk_rows": "tehmm_tpu_torch/csrc/streaming.cu",
    "viterbi_ptrs_lanes": "tehmm_tpu_torch/csrc/scans.cu",
    "viterbi_ptrs_rows": "tehmm_tpu_torch/csrc/scans.cu",
    "fwd_scaled": "tehmm_tpu_torch/csrc/scans.cu",
    "bwd_scaled": "tehmm_tpu_torch/csrc/scans.cu",
    "viterbi_ptrs": "tehmm_tpu_torch/csrc/scans.cu",
    "pointer_chase": "tehmm_tpu_torch/csrc/scans.cu",
    "viterbi_chunk_tile": "tehmm_tpu_torch/csrc/streaming.cu",
    "fwd_chunk_tile": "tehmm_tpu_torch/csrc/scans.cu",
    "bwd_chunk_tile": "tehmm_tpu_torch/csrc/scans.cu",
    "fwd_scaled_cluster": "tehmm_tpu_torch/csrc/scans.cu",
    "bwd_scaled_cluster": "tehmm_tpu_torch/csrc/scans.cu",
    "fwd_chunk_cluster": "tehmm_tpu_torch/csrc/scans.cu",
    "bwd_chunk_cluster": "tehmm_tpu_torch/csrc/scans.cu",
    "fwd_scaled_lanes": "tehmm_tpu_torch/csrc/scans.cu",
    "fwd_scaled_rows": "tehmm_tpu_torch/csrc/scans.cu",
    "bwd_scaled_lanes": "tehmm_tpu_torch/csrc/scans.cu",
    "bwd_scaled_rows": "tehmm_tpu_torch/csrc/scans.cu",
    "fwd_chunk_rows": "tehmm_tpu_torch/csrc/scans.cu",
    "bwd_chunk_rows": "tehmm_tpu_torch/csrc/scans.cu",
    "viterbi_values_cluster": "tehmm_tpu_torch/csrc/streaming.cu",
    "viterbi_chunk_cluster": "tehmm_tpu_torch/csrc/streaming.cu",
    "viterbi_ptrs_cluster": "tehmm_tpu_torch/csrc/scans.cu",
    "maxplus_resident": "tehmm_tpu_torch/csrc/maxplus.cu",
    "maxplus_blocks": "tehmm_tpu_torch/csrc/maxplus.cu",
    "fwd_piece_ops": "tehmm_tpu_torch/csrc/posterior.cu",
    "fwd_piece_compose": "tehmm_tpu_torch/csrc/posterior.cu",
}
REPLACES = {
    "viterbi_fwd": "tehmm_tpu/ops/pallas_kernels.py:2386",
    # K2's forward to 32 states (its lanes kernel)
    "viterbi_fwd_lanes": "tehmm_tpu/ops/pallas_kernels.py:2386",
    # the value-row backtrace: the XLA backtrace of viterbi_pallas_v3
    # (no Pallas; timed also on K2's rows, its route before the pointer
    # mode), and a chunk the exact decoder's past 239 states
    # (dp.viterbi_backtrace_chunk, an XLA scan)
    "viterbi_backtrace": "tehmm_tpu/ops/pallas_kernels.py:1475",
    "viterbi_backtrace@3f_exact": "tehmm_tpu/ops/dp.py:601",
    # K2's backtrace: X3's chase over the pointer mode's pointers
    "chunk_chase@K2": "tehmm_tpu/ops/pallas_kernels.py:2517",
    "viterbi_chunk_values": "tehmm_tpu/ops/pallas_kernels.py:1284",
    # K3's checkpoint mode: the exact decoder's forward sweep (on the TPU
    # the XLA scan dp.viterbi_carry, a launch a chunk; K3's function)
    "viterbi_checkpoints": "tehmm_tpu/ops/pallas_kernels.py:1284",
    # K3's pointer mode: the exact decoder's recompute, which on the TPU
    # is viterbi_chunk_values_pallas's value rows
    "viterbi_chunk_pointers": "tehmm_tpu/ops/pallas_kernels.py:1284",
    # X3: the exact decoder's backtrace, on the TPU the XLA scan
    # dp.viterbi_backtrace_chunk a chunk
    "chunk_entry_map": "tehmm_tpu/ops/dp.py:601",
    "chunk_compose": "tehmm_tpu/ops/dp.py:601",
    "chunk_chase": "tehmm_tpu/ops/dp.py:601",
    "em_fwd": "tehmm_tpu/ops/pallas_kernels.py:1777",
    "em_bwd_stats": "tehmm_tpu/ops/pallas_kernels.py:1931",
    "post_decode": "tehmm_tpu/ops/pallas_kernels.py:2765",
    # K4's decode to 32 states (its lanes kernel)
    "post_decode_lanes": "tehmm_tpu/ops/pallas_kernels.py:2765",
    # X1 and X2 have no Pallas counterpart: the XLA scans they replace
    "fwd_chunk": "tehmm_tpu/ops/dp.py:378",
    # X1's checkpoint mode: the exact posteriors' forward sweep (on the TPU
    # the XLA scan dp.forward_chunk_values a chunk, whose carry it chains)
    "fwd_checkpoints": "tehmm_tpu/ops/dp.py:480",
    "bwd_chunk": "tehmm_tpu/ops/dp.py:507",
    # X2's checkpoint mode: the exact posteriors' backward sweep (on the
    # TPU the XLA scan dp.backward_chunk_values a chunk, whose x_out it
    # chains from the last)
    "bwd_checkpoints": "tehmm_tpu/ops/dp.py:507",
    # K5 (viterbi_pallas_v3's value sweep), K6a, K6b
    "viterbi_values": "tehmm_tpu/ops/pallas_kernels.py:1374",
    "fwd_prob": "tehmm_tpu/ops/pallas_kernels.py:815",
    "bwd_prob": "tehmm_tpu/ops/pallas_kernels.py:885",
    # K7a (and K8a, forward_scaled_pallas :131), K7b (and K8b,
    # backward_scaled_pallas :222), K8c, and K8c's XLA backtrace
    "fwd_scaled": "tehmm_tpu/ops/pallas_kernels.py:493",
    "bwd_scaled": "tehmm_tpu/ops/pallas_kernels.py:1012",
    "viterbi_ptrs": "tehmm_tpu/ops/pallas_kernels.py:333",
    "pointer_chase": "tehmm_tpu/ops/pallas_kernels.py:381",
    # K3, X1 and X2 past their one-warp kernels: the tile's carry modes
    "viterbi_chunk_tile": "tehmm_tpu/ops/pallas_kernels.py:1284",
    "fwd_chunk_tile": "tehmm_tpu/ops/dp.py:378",
    "bwd_chunk_tile": "tehmm_tpu/ops/dp.py:507",
    # the same four past 256 states on the cluster tile
    "fwd_scaled_cluster": "tehmm_tpu/ops/pallas_kernels.py:493",
    "bwd_scaled_cluster": "tehmm_tpu/ops/pallas_kernels.py:1012",
    "fwd_chunk_cluster": "tehmm_tpu/ops/dp.py:378",
    "bwd_chunk_cluster": "tehmm_tpu/ops/dp.py:507",
    # the same four to 256 states on the lanes step and the rows kernels
    "fwd_scaled_lanes": "tehmm_tpu/ops/pallas_kernels.py:493",
    "fwd_scaled_rows": "tehmm_tpu/ops/pallas_kernels.py:493",
    "bwd_scaled_lanes": "tehmm_tpu/ops/pallas_kernels.py:1012",
    "bwd_scaled_rows": "tehmm_tpu/ops/pallas_kernels.py:1012",
    "fwd_chunk_rows": "tehmm_tpu/ops/dp.py:378",
    "bwd_chunk_rows": "tehmm_tpu/ops/dp.py:507",
    # K5, K3's carry mode and K8c past 256 states on the cluster tile
    "viterbi_values_cluster": "tehmm_tpu/ops/pallas_kernels.py:1374",
    "viterbi_chunk_cluster": "tehmm_tpu/ops/pallas_kernels.py:1284",
    "viterbi_ptrs_cluster": "tehmm_tpu/ops/pallas_kernels.py:333",
    # K6a and K6b past 256 states on the cluster tile
    "fwd_prob_cluster": "tehmm_tpu/ops/pallas_kernels.py:815",
    "bwd_prob_cluster": "tehmm_tpu/ops/pallas_kernels.py:885",
    # K6a and K6b to 256 states on the lanes step and the rows kernels
    "fwd_prob_lanes": "tehmm_tpu/ops/pallas_kernels.py:815",
    "fwd_prob_rows": "tehmm_tpu/ops/pallas_kernels.py:815",
    "bwd_prob_lanes": "tehmm_tpu/ops/pallas_kernels.py:885",
    "bwd_prob_rows": "tehmm_tpu/ops/pallas_kernels.py:885",
    # K5 (viterbi_pallas_v3's value sweep, _viterbi_values_v3 :1374, its
    # kernel _make_viterbi_kernel_v3 :1284), K3's carry mode past 239
    # states (:1284) and K8c (viterbi_pallas :333, its kernel
    # _viterbi_kernel :277) to 256 states on the lanes step and the rows
    # kernels
    "viterbi_values_lanes": "tehmm_tpu/ops/pallas_kernels.py:1374",
    "viterbi_values_rows": "tehmm_tpu/ops/pallas_kernels.py:1374",
    "viterbi_chunk_rows": "tehmm_tpu/ops/pallas_kernels.py:1284",
    "viterbi_ptrs_lanes": "tehmm_tpu/ops/pallas_kernels.py:333",
    "viterbi_ptrs_rows": "tehmm_tpu/ops/pallas_kernels.py:333",
    # K9's two layouts
    "maxplus_resident": "tools/exp_maxplus_s256.py:115",
    "maxplus_blocks": "tools/exp_maxplus_s256.py:120",
    # X1's carry-only function as a piece-operator scan (the score)
    "fwd_piece_ops": "tehmm_tpu/ops/dp.py:378",
    "fwd_piece_compose": "tehmm_tpu/ops/dp.py:378",
}
# phase 3's path: the stitched K2 decode (at S=10 the lanes forward in
# its pointer mode, then X3's chase), and the exact decode's K3 (its
# checkpoint and pointer modes) and X3; K3's values mode is off it (the
# exact decoder's value rows are its route past 239 states, 3f's), and so
# are K2's shared forward (33 states to its envelope) and the value-row
# backtrace (K5's route and the exact decoder past 239 states)
DECODE_KERNELS = ("viterbi_fwd_lanes", "viterbi_checkpoints",
                  "viterbi_chunk_pointers", "chunk_entry_map",
                  "chunk_compose", "chunk_chase")
OFF_DECODE_PATH = ("viterbi_fwd", "viterbi_backtrace")
X3_KERNELS = ("chunk_entry_map", "chunk_compose", "chunk_chase")
EM_KERNELS = ("em_fwd", "em_bwd_stats")
# 3d's path: K4 (K1's forward and, at S=10, the lanes decode), the exact
# posteriors' X1 and X2, the score's piece-operator scan; K4's shared
# decode (33 states to its envelope) is off it
POST_KERNELS = ("em_fwd", "post_decode_lanes", "fwd_chunk",
                "fwd_checkpoints", "bwd_chunk", "bwd_checkpoints",
                "fwd_piece_ops", "fwd_piece_compose")
SCORE_STAGE = "score (piece-operator scan)"
# 3e's paths: base resolution with a gaussian track (+g), segment mode
# with the gaussian track (+wg) and with categorical tracks only (+w)
GAUSS_BASE_KERNELS = ("viterbi_fwd_lanes+g", "chunk_chase", "em_fwd+g",
                      "em_bwd_stats+g", "post_decode_lanes+g")
SEGMENT_KERNELS = ("em_fwd", "em_bwd_stats", "viterbi_fwd_lanes",
                   "post_decode_lanes")
# 3w: the workflow tools on a chromosome of their own; benchmark's em10
# trains through K1, and both its configs decode through K2's lanes
# forward in pointer mode and the chase
WORKFLOW_POSITIONS = 1_000_000
WORKFLOW_EM_ITERS = 5
WORKFLOW_KERNELS = ("em_fwd", "em_bwd_stats", "viterbi_fwd_lanes",
                    "chunk_chase")
# 2e: the engine-comparison path; phase 2 checks K5/K6, K7/K8 and the
# backtrace under dp.viterbi_streaming at each of its shapes
STREAMING_KERNELS = ("viterbi_values", "fwd_prob", "bwd_prob",
                     "fwd_scaled", "bwd_scaled", "viterbi_ptrs",
                     "pointer_chase")
# to 256 states all nine scans over obs (K7a/K7b, X1's and X2's carry
# modes, K6a/K6b, K5, K3's carry mode and K8c) run their own kernels (the
# lanes step, the rows kernels: ck.log_scan_route), each under its own
# counter (ck.scan_counter), the block tile forced only to compare and
# time it
LOG_SCANS = ("fwd_scaled", "bwd_scaled", "fwd_chunk_tile", "bwd_chunk_tile",
             "fwd_prob", "bwd_prob", "viterbi_values", "viterbi_ptrs",
             "viterbi_chunk_tile")
# past 256 states K7a/K7b, X1's and X2's carry modes, K5, K3's carry mode,
# K8c, K6a and K6b run the cluster tile in their place (the staged tile
# forced only to compare and time it)
CLUSTER_OF = {"fwd_scaled": "fwd_scaled_cluster",
              "bwd_scaled": "bwd_scaled_cluster",
              "fwd_chunk_tile": "fwd_chunk_cluster",
              "bwd_chunk_tile": "bwd_chunk_cluster",
              "viterbi_values": "viterbi_values_cluster",
              "viterbi_chunk_tile": "viterbi_chunk_cluster",
              "viterbi_ptrs": "viterbi_ptrs_cluster",
              "fwd_prob": "fwd_prob_cluster",
              "bwd_prob": "bwd_prob_cluster"}
# K6a and K6b at 3f's train shape (one row of ENV_FIT_REGION at
# ENV_STATES): their rows' suffix
K6_FIT = "3f_fit"
ENGINE_CONFIGS = ("S20", "S64", "S128", "S256")
# the scan tile past 256 states (bench_engines' extra configurations):
# phase 2 holds its kernels to plain there, 2e runs the tools there
WIDE_CONFIGS = ("S512", "S1024")
WIDE_ENGINES = ("plain,cuda_v3,cuda_log", "plain,streaming,pointers",
                "plain,scans")
# K9: phase 2 at Sp x MAXPLUS_BG, bit-equal to plain; 2m runs the tool at
# each Sp
MAXPLUS_SP, MAXPLUS_BG, MAXPLUS_BLKS = (256, 512, 1024), 128, (8, 16, 32)
# the carried sweeps past their one-warp kernels, X_B rows of X_L: K3's,
# X1's and X2's carry modes on the rows kernels at 240 and 256 states, on
# the cluster tile beyond
WIDE_SWEEP_STATES = (240, 256, 257, 512, 1024)
SWEEP_CUTS = (0, 1000, 2500, X_L)    # a sweep cut into three chunks
# 3f's paths and the kernels each must run
ENVELOPE_KERNELS = {"fit": ("fwd_prob_cluster", "bwd_prob_cluster"),
                    "viterbi": ("viterbi_values_cluster",
                                "viterbi_backtrace"),
                    "exact": ("viterbi_chunk_cluster", "viterbi_backtrace"),
                    "maxpost": ("fwd_scaled_cluster", "bwd_scaled_cluster"),
                    "pd": ("fwd_chunk_cluster", "bwd_chunk_cluster"),
                    "score": ("fwd_chunk_cluster",)}
# and the staged tile's scans, which the cluster tile replaced on those
# paths
OFF_ENVELOPE_PATH = {"fit": ("fwd_prob", "bwd_prob"),
                     "viterbi": ("viterbi_values",),
                     "exact": ("viterbi_chunk_tile",),
                     "maxpost": ("fwd_scaled", "bwd_scaled"),
                     "pd": ("fwd_chunk_tile", "bwd_chunk_tile"),
                     "score": ("fwd_chunk_tile",)}
ENGINE_ITERS = 1                     # marginal_time chains of 1 and 6
# --parent's comparisons, by the phase whose outputs they hold: 3, the
# chromosome's stitched BED and the region's --exact BED; 3d, its four
# files; 3b, the learned model and loglik trace; 3e, the stitched Viterbi
# and --maxPost BEDs with the gaussian track and in segment mode
ENVELOPE_MESSAGE = "beyond the shared-memory envelope"
# phase 2's limits for the log-space scans K7/K8 against their plain
# version carried in float64: log values within SCAN_ATOL plus
# SCAN_OBS_ULPS float32 ulps of 1 times the largest |obs| (a step rounds
# obs + log(sum) and its max, each to half an ulp of |obs|), cumulative
# normalizers within SCAN_CUM_RTOL relative (a float32 running sum of up
# to 1024 of them) and 1e-4 absolute
F32_EPS = float(np.finfo(np.float32).eps)
SCAN_ATOL, SCAN_OBS_ULPS, SCAN_CUM_RTOL = 1e-5, 4, 1e-5


def _sum_atol(steps, S_, obs_max):
    """The piece-operator scan's sums of ``steps`` normalizers against
    float64 are held within 1e-6 relative plus this: each normalizer
    carries the rounding of an S-term sum (S float32 ulps of it,
    relative, so S ulps of 1 in its log) and of obs + log(sum) (an ulp of
    the largest |obs|, ``obs_max``), and a piece's terms may cancel."""
    return 1e-6 + steps * F32_EPS * (S_ + obs_max)


def _f3_limit(obs_max):
    """F3's limit for carries, rows and hats against plain in float64."""
    return SCAN_ATOL + SCAN_OBS_ULPS * F32_EPS * obs_max


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def _timed(fn):
    """(fn(), its ms), synchronised before and after as a sample of
    ``_median_ms``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, (time.perf_counter() - t0) * 1e3


def _median_ms(fn, runs: int, samples=()) -> float:
    """Median ms of ``runs`` calls, ``samples`` (ms of calls already
    timed by ``_timed``) counted among them."""
    times = list(samples)
    while len(times) < runs:
        times.append(_timed(fn)[1])
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


def _bound(name, shape, valid, G=0, weighted=False, n_ck=0) -> dict:
    """bound_ms and bound_by of one call of kernel ``name`` at ``shape`` =
    (B, L, S, T, V) with ``valid`` valid positions (``n_ck``: the
    checkpoints a row of K3's, X1's or X2's checkpoint mode writes): the
    larger of the bytes the function must move (each input read once,
    each output written once) over the HBM rate and its float32
    operations (an exp or log counted as one) over the card's float32
    peak; and library_ms: no single PyTorch call computes any of these
    functions."""
    B, L, S, T, V = shape
    f = 4
    tables = (S * S + S * T * V) * f
    streams = (B * L * f if weighted else 0) + \
        ((B * L * G + 2 * S * G) * f if G else 0)
    sym = (B * L * T + B) * f
    rows = B * L * S * f
    obs = _obs_ops(S, T, G, weighted)
    base = name.split("+")[0].split("@")[0]
    if base in ("viterbi_fwd", "viterbi_fwd_lanes"):
        # max-plus step, obs, renormalise; value rows and dm out
        nbytes = sym + tables + S * f + streams + rows + B * L * f
        ops = 2 * S * S + obs + 2 * S
    elif base == "viterbi_fwd_pointers":   # the same; uint8 pointers, the
        nbytes = (sym + tables + S * f + streams + B * L * S   # last row
                  + B * S * f + B * L * f)                     # and dm out
        ops = 2 * S * S + obs + 2 * S
    elif base == "viterbi_backtrace":  # S adds and compares a position
        nbytes = S * S * f + rows + (B * S + 3 * B + B * L) * f
        ops = 2 * S
    elif base == "viterbi_chunk_values":
        nbytes = 2 * rows + (B * S + B + S * S) * f
        ops = 2 * S * S + 3 * S
    elif base == "viterbi_checkpoints":  # obs in, n_ck carries a row out
        nbytes = rows + (B * S + B + S * S + B * n_ck * S) * f
        ops = 2 * S * S + 3 * S
    elif base == "viterbi_chunk_pointers":  # obs in, uint8 pointers out
        nbytes = rows + B * L * S + (B * S + B + S * S) * f
        ops = 2 * S * S + 3 * S
    elif base == "chunk_entry_map":    # S pointers read a valid position
        nbytes = valid * S + (B + B * S) * f   # each walk's), maps out
        ops = S
    elif base == "chunk_compose":      # a map entry read a chunk (shape
        nbytes = (B * L + B * L + 2 * B) * f   # (tables, chunks, S)),
        ops = 1                               # ends and entries out
    elif base == "chunk_chase":        # a pointer read a valid position,
        nbytes = valid + (2 * B + B * L) * f   # the path out
        ops = 1
    elif base == "em_fwd":             # obs_p, S x S product, scale
        nbytes = sym + tables + S * f + streams + rows + 2 * B * L * f
        ops = 2 * S * S + obs + 6 * S
    elif base == "em_bwd_stats":       # obs_p, b step, pair, counts
        nbytes = (sym + tables + streams + rows + B * L * f
                  + (S + S * S + S * T * V + 3 * S * G) * f)
        ops = 4 * S * S + obs + S * T + 6 * S * G + 10 * S
    elif base in ("post_decode", "post_decode_lanes"):
        # obs_p, b step, argmax
        nbytes = sym + tables + streams + rows + B * L * f
        ops = 2 * S * S + obs + 8 * S
    elif base in ("maxplus_resident", "maxplus_blocks"):
        # shape = (Bg, sweeps, Sp): v and T in, v out; an add and a max a
        # term (one float32 instruction each, at half the FMA-counted
        # peak) and a subtraction a cell
        Bg, sweeps, Sp = B, L, S
        nbytes = (2 * Sp * Bg + Sp * Sp) * f
        t_ops = sweeps * (2 * Sp * Sp * Bg + Sp * Bg) \
            / (H100_F32_PER_S / 2)
        t_bytes = nbytes / H100_BYTES_PER_S
        return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=None)
    elif base in ("viterbi_chunk_tile", "viterbi_chunk_cluster",
                  "viterbi_chunk_rows"):
        nbytes = 2 * rows + (B * S + B + S * S) * f
        ops = 2 * S * S + 3 * S
    elif base == "fwd_piece_ops":      # S chains of X1's step a position
        from tehmm_tpu_torch.ops.dp import PIECE

        n_p = -(-L // PIECE)           # out: probability rows, log scales
        nbytes = rows + (B + S * S) * f + B * n_p * S * (S * f + 8)
        ops = S * (2 * S * S + 4 * S)
    elif base == "fwd_piece_compose":  # X1's step a live piece (valid)
        from tehmm_tpu_torch.ops.dp import PIECE

        n_p = -(-L // PIECE)           # in: the operators and the carry
        nbytes = B * n_p * (S * (S * f + 8) + 8) + (2 * B * S + B) * f
        ops = 2 * S * S + 6 * S
    elif base == "forward_final":      # X1's carry-only function: obs,
        nbytes = rows + (2 * B * S + 2 * B + S * S) * f   # carry, sum
        ops = 2 * S * S + 4 * S
    elif base == "fwd_checkpoints":    # obs in, n_ck carries a row out
        nbytes = rows + (B * S + B + S * S + B * n_ck * S) * f
        ops = 2 * S * S + 4 * S
    elif base == "bwd_checkpoints":    # obs, continuing in, n_ck x out
        nbytes = rows + (B * S + 2 * B + S * S + B * n_ck * S) * f
        ops = 2 * S * S + 4 * S
    elif base in ("fwd_chunk", "bwd_chunk", "fwd_chunk_tile",
                  "bwd_chunk_tile", "fwd_chunk_cluster",
                  "bwd_chunk_cluster", "fwd_chunk_rows",
                  "bwd_chunk_rows"):   # log-space step
        nbytes = 2 * rows + (2 * B * S + 2 * B + S * S) * f
        ops = 2 * S * S + 4 * S
    elif base in ("viterbi_values", "viterbi_values_cluster",
                  "viterbi_values_lanes", "viterbi_values_rows", "fwd_prob",
                  "fwd_prob_cluster", "fwd_prob_lanes", "fwd_prob_rows"):
        # obs in, rows and normalizers out; product, obs, max, rescale
        nbytes = 2 * rows + (B * L + B + S * S + S) * f
        ops = 2 * S * S + 4 * S
    elif base in ("bwd_prob", "bwd_prob_cluster", "bwd_prob_lanes",
                  "bwd_prob_rows"):
        # two maxes and rescales a step
        nbytes = 2 * rows + (B + S * S) * f
        ops = 2 * S * S + 7 * S
    elif base in ("fwd_scaled", "fwd_scaled_cluster", "fwd_scaled_lanes",
                  "fwd_scaled_rows"):
        # exp, product, log, obs, max, sub
        nbytes = 2 * rows + (B * L + B + S * S + S) * f
        ops = 2 * S * S + 6 * S
    elif base in ("bwd_scaled", "bwd_scaled_cluster", "bwd_scaled_lanes",
                  "bwd_scaled_rows"):
        # obs, max, sub, exp, product, log, max, sub, dm
        nbytes = 2 * rows + (B * L + B + S * S) * f
        ops = 2 * S * S + 8 * S
    elif base in ("viterbi_ptrs", "viterbi_ptrs_cluster",
                  "viterbi_ptrs_lanes", "viterbi_ptrs_rows"):
        # add-and-compare product, pointers
        ptr = 1 if S <= 256 else 2     # out (uint8, or uint16 past 256)
        nbytes = rows + ptr * B * L * S + (B * S + B * L + B + S * S + S) * f
        ops = 2 * S * S + 4 * S
    elif base == "pointer_chase":      # one pointer read a position
        nbytes = (1 if S <= 256 else 2) * B * L + (B * S + B + B * L) * f
        ops = 1 + S / max(L, 1)
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


def _pointer_rows(args, lengths, suffix=""):
    """K3's pointer mode and X3's map, compose and chase on one shape's
    rows (``args``: K3's log_trans, obs, carry and lengths; ``lengths``
    the same on the host), the exact decoder's four launches a group:
    each bit-equal to its plain version, timed beside it (the plain
    versions once) and the bound, with us a step (ms over the longest
    row's steps, the compose's over its chunks).  The compose takes the
    maps as one table's chunks from state 0; the chase starts row r at
    state r mod S."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck

    lt, obs, init, lens = args
    B, L, S_ = obs.shape
    valid = int(np.clip(lengths, 0, L).sum())
    ptrs = ck.viterbi_chunk_pointers(*args)
    maps = ck.chunk_entry_map(ptrs, lens)
    table = maps.view(1, B, S_)
    ends = (torch.arange(B, device=lens.device) % S_).to(torch.int32)
    shape = (B, L, S_, T, V)
    calls = {
        "viterbi_chunk_pointers": (
            lambda: ck.viterbi_chunk_pointers(*args),
            lambda: ck.viterbi_chunk_pointers_plain(*args), shape, valid),
        "chunk_entry_map": (
            lambda: ck.chunk_entry_map(ptrs, lens),
            lambda: ck.chunk_entry_map_plain(ptrs, lens), shape, valid),
        "chunk_compose": (
            lambda: ck.chunk_compose(table, ends[:1]),
            lambda: ck.chunk_compose_plain(table, ends[:1]),
            (1, B, S_, T, V), B),
        "chunk_chase": (
            lambda: ck.chunk_chase(ptrs, ends, lens),
            lambda: ck.chunk_chase_plain(ptrs, ends, lens), shape, valid),
    }
    out = {}
    for name, (fn, plain, shp, n_valid) in calls.items():
        got, want = fn(), plain()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            f"{name} disagrees with its plain version at {B} x {L}"
        err = max(float((g.int() - w.int()).abs().max()) if g.numel()
                  else 0.0 for g, w in zip(got, want))
        ms = _median_ms(fn, 5)
        out[name + suffix] = dict(
            max_abs_err=err, ms=ms, plain_ms=_median_ms(plain, 1),
            us_per_step=ms * 1e3 / shp[1], **_bound(name, shp, n_valid))
    return out


def _k2_forward_rows(args, shape, valid, G=0, weighted=False, **st):
    """K2's forward at one shape, both modes (``args``: its five tables
    and inputs; ``st``: the optional streams): the kernel of ``k2_step``
    (to 32 states the lanes one) against the plain versions and against
    the shared kernel forced, value rows, normalizers, pointers and last
    rows bit for bit, each timed (median of 5) beside its plain version
    (median of 3, the values mode's once; the check's own plain calls
    among them) and the bound.  Returns the
    rows of both kernels (``viterbi_fwd_lanes`` and ``viterbi_fwd``, the
    stream variant's suffix on each): ``ms``, ``plain_ms`` and the bound
    the pointer mode's, the main path's; ``values_ms``,
    ``plain_values_ms`` and ``values_bound_ms`` the values mode's."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools.time_k1 import shared_k2

    B, L, S_, T_, V_ = shape
    suffix = "+" + ("w" if weighted else "") + ("g" if G else "")
    suffix = "" if suffix == "+" else suffix
    step = ck.k2_step(S_, T_, V_, G)

    def values():
        return ck.viterbi_fwd(*args, **st)

    def pointers():
        return ck.viterbi_fwd_pointers(*args, **st)

    got = {step: (*values(), *pointers())}
    # the plain calls of the check are timing samples too: four plain
    # forwards a stream, not six
    plain_values, plain_values_ms = _timed(
        lambda: ck.viterbi_fwd_plain(*args, **st))
    plain_pointers, first_ms = _timed(
        lambda: ck.viterbi_fwd_pointers_plain(*args, **st))
    plain = (*plain_values, *plain_pointers)
    names = ("value rows", "dm", "pointers", "last row", "pointer dm")
    for k, (a, b) in enumerate(zip(got[step], plain)):
        assert torch.equal(a, b), \
            f"viterbi_fwd{suffix} ({step}) {names[k]} != plain"
    assert torch.equal(got[step][3], got[step][0][:, -1])
    err = float(max((got[step][0] - plain[0]).abs().max(),
                    (got[step][1] - plain[1]).abs().max()))
    plain_ms = _median_ms(
        lambda: ck.viterbi_fwd_pointers_plain(*args, **st), 3, [first_ms])
    del plain
    bound = _bound("viterbi_fwd_pointers", shape, valid, G, weighted)
    values_bound = _bound("viterbi_fwd" + suffix, shape, valid, G, weighted)
    out = {}
    for forced in (False, True) if step == "lanes" else (False,):
        with (shared_k2() if forced else contextlib.nullcontext()):
            if forced:
                got["shared"] = (*values(), *pointers())
                for k, (a, b) in enumerate(zip(got["shared"],
                                               got["lanes"])):
                    assert torch.equal(a, b), \
                        f"viterbi_fwd{suffix} lanes {names[k]} != the " \
                        f"shared kernel's (forced)"
            name = "viterbi_fwd" if forced or step == "shared" \
                else "viterbi_fwd_lanes"
            ms = _median_ms(pointers, 5)
            out[name + suffix] = dict(
                max_abs_err=err, step="shared (forced)" if forced else step,
                ms=ms, values_ms=_median_ms(values, 5), plain_ms=plain_ms,
                plain_values_ms=plain_values_ms,
                values_bound_ms=values_bound["bound_ms"],
                us_per_step=ms * 1e3 / L, **bound)
    print(f"[kernels] K2 forward{suffix} at {B} x {L}, S={S_}: the {step} "
          f"kernel's value rows, dm, pointers and last rows bit-equal to "
          f"plain" + (" and to the shared kernel's (forced)"
                      if step == "lanes" else ""), flush=True)
    return out


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

    # K2 forward: the lanes kernel (k2_step at S=10) and the shared one
    # forced, in both modes
    shape, valid = (B_ROWS, L_ROWS, S, T, V), int(lengths.sum())
    out.update(_k2_forward_rows(fwd_args, shape, valid))
    v, _ = ck.viterbi_fwd(*fwd_args)
    ptrs, last, _ = ck.viterbi_fwd_pointers(*fwd_args)

    # the value-row backtrace on the forward's rows, as viterbi_fused
    # called it before the chase (K5's route and the exact decoder past
    # 239 states call it still)
    end = torch.argmax(last, dim=-1).to(torch.int32)
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
        note="off the stitched decode (its backtrace is the chase "
             "below); launches: 2e's streaming route at S20",
    )
    # K2's backtrace: the chase over the pointer mode's pointers from the
    # same end states, the backtrace's path on every row
    chased = ck.chunk_chase(ptrs, end, lens)
    assert torch.equal(chased, ck.chunk_chase_plain(ptrs, end, lens)), \
        "chunk_chase disagrees with its plain version on K2's pointers"
    assert torch.equal(chased, torch.cat([got[1][:, None], got[0]], 1)), \
        "the chase over K2's pointers != the value-row backtrace"
    ms = _median_ms(lambda: ck.chunk_chase(ptrs, end, lens), 5)
    out["chunk_chase@K2"] = dict(
        max_abs_err=0.0, ms=ms,
        plain_ms=_median_ms(lambda: ck.chunk_chase_plain(ptrs, end, lens),
                            3),
        us_per_step=ms * 1e3 / L_ROWS, **_bound("chunk_chase", shape, valid))
    del ptrs, last, chased

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

    # K3, every mode
    init = torch.from_numpy(
        rng.randn(B_ROWS, S).astype(np.float32)).to(device)
    k3_args = (p.log_trans, obs, init, lens)
    got = ck.viterbi_chunk_values(*k3_args)
    want = dp.viterbi_chunk_values(*k3_args)
    carry, want_c = ck.viterbi_carry(*k3_args), dp.viterbi_carry(*k3_args)
    ckpt = ck.viterbi_checkpoints(*k3_args, 1024)
    want_k = dp.viterbi_checkpoints(*k3_args, 1024)
    assert torch.equal(got, want) and torch.equal(carry, want_c) \
        and torch.equal(ckpt, want_k), \
        "viterbi_chunk_values disagrees with its plain version"
    out["viterbi_chunk_values"] = dict(
        max_abs_err=float(max((got - want).abs().max(),
                              (carry - want_c).abs().max(),
                              (ckpt - want_k).abs().max())),
        ms=_median_ms(lambda: ck.viterbi_chunk_values(*k3_args), 5),
        plain_ms=_median_ms(lambda: dp.viterbi_chunk_values(*k3_args), 3),
    )
    out["viterbi_backtrace"].update(_bound(
        "viterbi_backtrace", (B_ROWS, L_ROWS - 1, S, T, V),
        int(np.clip(lengths - 1, 0, None).sum())))
    out["viterbi_chunk_values"].update(
        _bound("viterbi_chunk_values", shape, valid),
        us_per_step=out["viterbi_chunk_values"]["ms"] * 1e3 / L_ROWS,
        note="values mode: no main path launches it below 240 states, "
             "where the exact decoder's recompute is the pointer mode")
    # K3's pointer mode and X3 on the same rows
    out.update(_pointer_rows(k3_args, lengths))
    for name, r in out.items():
        print(f"[kernels] {name:22s} bit-equal  kernel {r['ms']:10.3f} ms"
              f"  plain {r['plain_ms']:10.3f} ms", flush=True)
    return out


def phase_k3_main_shapes(device, rng) -> dict:
    """K3 and X3 at the shapes phase 3's ``--exact`` region gives them:
    the backtrace of one chunk (1 x 4096) and of the region's one group
    (245 rows of 4096, each from its own carry, the last 583 long): K3's
    pointer mode, X3's map, compose (the 245 maps as one table's chunks)
    and chase (``_pointer_rows``); and the forward sweep over the region
    in one checkpoint launch (1 x 245 x 4096, 999,999 valid, a carry
    every 4096); each bit-equal to its plain version, timed, with us a
    step (ms over the longest row's steps) beside the bound.  The sweep
    is held chunk by chunk: the plain step over every chunk from the
    kernel's carry entering it (all in one call), which by induction is
    the plain chain; its ``plain_ms`` times the plain chain on the first
    ``PLAIN_CHUNKS`` chunks (``plain_positions``), which it must equal
    too.  A decode model and inputs of its own generator."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    p = _decode_model(rng, device)

    def inputs(B, L, lengths):
        sym = torch.from_numpy(
            rng.randint(1, V, size=(B, L, T)).astype(np.int32)).to(device)
        obs = track_log_likelihoods(p.log_em, sym)
        init = torch.from_numpy(rng.randn(B, S).astype(np.float32))
        init = (init - init.amax(dim=-1, keepdim=True)).to(device)
        lens = torch.from_numpy(np.asarray(lengths, np.int32)).to(device)
        return (p.log_trans, obs, init, lens)

    body = EXACT_REGION - 1
    last = body - (EXACT_CHUNKS - 1) * EXACT_CHUNK
    out = {}
    for B, lengths in ((1, [EXACT_CHUNK]),
                       (EXACT_CHUNKS,
                        [EXACT_CHUNK] * (EXACT_CHUNKS - 1) + [last])):
        args = inputs(B, EXACT_CHUNK, lengths)
        out.update(_pointer_rows(args, np.asarray(lengths),
                                 f"@{B}x{EXACT_CHUNK}"))
        del args

    L = EXACT_CHUNKS * EXACT_CHUNK
    args = inputs(1, L, [body])
    lt, obs, init, lens = args
    got = ck.viterbi_checkpoints(*args, EXACT_CHUNK)
    # every chunk through the plain step from the kernel's carry entering
    # it, all chunks as rows of one call: equal at every chunk, so by
    # induction the kernel's carries are the plain chain's
    entries = torch.cat([init[:, None], got[:, :-1]], dim=1)[0]
    starts = torch.arange(EXACT_CHUNKS, device=device) * EXACT_CHUNK
    want = dp.viterbi_carry(
        lt, obs.view(EXACT_CHUNKS, EXACT_CHUNK, S), entries.contiguous(),
        torch.clamp(body - starts, 0, EXACT_CHUNK).to(torch.int32))
    assert torch.equal(got[0], want), \
        "viterbi_checkpoints disagrees with its plain version"
    # the plain chain itself (a Python loop a position: ~75 s over the
    # whole row) on the first PLAIN_CHUNKS chunks, timed once
    n_p = PLAIN_CHUNKS * EXACT_CHUNK
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain = dp.viterbi_checkpoints(lt, obs[:, :n_p].contiguous(), init,
                                   torch.clamp(lens, max=n_p), EXACT_CHUNK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert torch.equal(chain, got[:, :PLAIN_CHUNKS]), \
        "viterbi_checkpoints disagrees with the plain chain"
    ms = _median_ms(lambda: ck.viterbi_checkpoints(*args, EXACT_CHUNK), 5)
    out["viterbi_checkpoints"] = dict(
        max_abs_err=float((got[0] - want).abs().max()), ms=ms,
        plain_ms=plain_ms, plain_positions=n_p, us_per_step=ms * 1e3 / body,
        **_bound("viterbi_checkpoints", (1, L, S, T, V), body,
                 n_ck=EXACT_CHUNKS))
    for name, r in out.items():
        print(f"[kernels] {name:30s} bit-equal  kernel {r['ms']:10.3f} ms"
              f" ({r['us_per_step']:.4f} us a step, bound "
              f"{r['bound_ms']:.4f} ms)  plain {r['plain_ms']:10.3f} ms",
              flush=True)
    return out


def phase_x1_main_shapes(device, rng) -> dict:
    """X1 at the shapes phase 3d's 1,000,000-position ``--maxPost
    --exact`` region gives it: the recompute of one chunk (1 x 4096) and
    of the region's one group (245 rows of 4096, each from its own carry,
    the last 583 long), the ragged rows of phase 2's decode (B_ROWS x
    L_ROWS), and the forward sweep over the region in one checkpoint
    launch (1 x 245 x 4096, 999,999 valid, a carry every 4096); each held
    to its plain version carried in float64 within the F3 limit, timed
    against the float32 plain version, with us a step (ms over the
    longest row's steps) beside the bound.  The sweep is held chunk by
    chunk: the float64 plain step over every chunk from the kernel's
    carry entering it (all in one call); its ``plain_ms`` times the
    float32 plain chain on the first ``PLAIN_CHUNKS`` chunks
    (``plain_positions``), and the kernel's first checkpoints are held to
    the float64 chain over them too.  A decode model and inputs of its
    own generator."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    p = _decode_model(rng, device)
    f64 = torch.float64

    def inputs(B, L, lengths):
        sym = torch.from_numpy(
            rng.randint(0, V, size=(B, L, T)).astype(np.int32)).to(device)
        obs = track_log_likelihoods(p.log_em, sym)
        init = torch.from_numpy(rng.randn(B, S).astype(np.float32))
        init = (init - init.amax(dim=-1, keepdim=True)).to(device)
        lens = torch.from_numpy(np.asarray(lengths, np.int32)).to(device)
        return (p.log_trans, obs, init, lens)

    body = EXACT_REGION - 1
    last = body - (EXACT_CHUNKS - 1) * EXACT_CHUNK
    ragged = rng.randint(0, L_ROWS + 1, size=B_ROWS)
    ragged[:4] = [L_ROWS, 0, 1, 2]
    out = {}
    for B, L, lengths in ((1, EXACT_CHUNK, [EXACT_CHUNK]),
                          (EXACT_CHUNKS, EXACT_CHUNK,
                           [EXACT_CHUNK] * (EXACT_CHUNKS - 1) + [last]),
                          (B_ROWS, L_ROWS, ragged)):
        args = inputs(B, L, lengths)
        lim = _f3_limit(float(args[1].abs().max()))
        hats, carry = ck.forward_chunk_values(*args)
        ref = dp.forward_chunk_values(*args, dtype=f64)
        err = max(_assert_close(f"X1 values at {B} x {L}", hats.double(),
                                ref[0], 0.0, lim),
                  _assert_close(f"X1 carry at {B} x {L}", carry.double(),
                                ref[1], 0.0, lim))
        ms = _median_ms(lambda: ck.forward_chunk_values(*args), 5)
        out[f"fwd_chunk@{B}x{L}"] = dict(
            max_abs_err=err, limit=lim, ms=ms,
            plain_ms=_median_ms(lambda: dp.forward_chunk_values(*args), 1),
            us_per_step=ms * 1e3 / L,
            **_bound("fwd_chunk", (B, L, S, T, V), int(sum(lengths))))
        del args, hats, carry, ref

    L = EXACT_CHUNKS * EXACT_CHUNK
    args = inputs(1, L, [body])
    lt, obs, init, lens = args
    lim = _f3_limit(float(obs.abs().max()))
    got = ck.forward_checkpoints(*args, EXACT_CHUNK)
    # every chunk through the float64 plain step from the kernel's carry
    # entering it, all chunks as rows of one call
    entries = torch.cat([init[:, None], got[:, :-1]], dim=1)[0]
    starts = torch.arange(EXACT_CHUNKS, device=device) * EXACT_CHUNK
    want, _ = dp.forward_final(
        lt, obs.view(EXACT_CHUNKS, EXACT_CHUNK, S), entries.contiguous(),
        torch.clamp(body - starts, 0, EXACT_CHUNK).to(torch.int32),
        dtype=f64)
    err = _assert_close("X1 checkpoints, chunk by chunk", got[0].double(),
                        want, 0.0, lim)
    # the plain chain itself (a Python loop a position) on the first
    # PLAIN_CHUNKS chunks: timed in float32, held in float64
    n_p = PLAIN_CHUNKS * EXACT_CHUNK
    head = (lt, obs[:, :n_p].contiguous(), init, torch.clamp(lens, max=n_p))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp.forward_checkpoints(*head, EXACT_CHUNK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    chain = dp.forward_checkpoints(lt.double(), head[1].double(),
                                   init.double(), head[3], EXACT_CHUNK)
    err = max(err, _assert_close("X1 checkpoints against the plain chain",
                                 got[:, :PLAIN_CHUNKS].double(), chain, 0.0,
                                 lim))
    ms = _median_ms(lambda: ck.forward_checkpoints(*args, EXACT_CHUNK), 5)
    out["fwd_checkpoints"] = dict(
        max_abs_err=err, limit=lim, ms=ms, plain_ms=plain_ms,
        plain_positions=n_p, us_per_step=ms * 1e3 / body,
        **_bound("fwd_checkpoints", (1, L, S, T, V), body,
                 n_ck=EXACT_CHUNKS))
    for name, r in out.items():
        print(f"[kernels] {name:30s} max_abs_err {r['max_abs_err']:.3g} "
              f"(F3 {r['limit']:.3g})  kernel {r['ms']:10.3f} ms "
              f"({r['us_per_step']:.4f} us a step, bound "
              f"{r['bound_ms']:.4f} ms)  plain {r['plain_ms']:10.3f} ms",
              flush=True)
    return out


def phase_x2_main_shapes(device, rng) -> dict:
    """X2 at the shapes phase 3d's 1,000,000-position ``--maxPost
    --exact`` region gives it: the beta recompute of one chunk (1 x 4096)
    and of the region's one group (245 rows of 4096, each from its own
    x_carry, every row continuing past its chunk but the last, 583 long),
    the ragged rows of phase 2's decode (B_ROWS x L_ROWS, each continuing
    or not at random), and the backward sweep over the region in one
    checkpoint launch (1 x 245 x 4096, 999,999 valid, an x_carry every
    4096, the row ending there); each held to its plain version carried
    in float64 within the F3 limit, timed against the float32 plain
    version, with us a step (ms over the longest row's steps) beside the
    bound.  The sweep is held chunk by chunk: the float64 plain values
    mode over every chunk from the kernel's x_carry leaving the chunk
    after it, with each chunk's own ``continuing`` (all in one call); its
    ``plain_ms`` times the float32 plain chain on the last
    ``PLAIN_CHUNKS`` chunks (``plain_positions``), and the kernel's last
    checkpoints are held to the float64 chain over them too.  A decode
    model and inputs of its own generator."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    p = _decode_model(rng, device)
    f64 = torch.float64

    def inputs(B, L, lengths, cont):
        sym = torch.from_numpy(
            rng.randint(0, V, size=(B, L, T)).astype(np.int32)).to(device)
        obs = track_log_likelihoods(p.log_em, sym)
        x_carry = torch.from_numpy(rng.randn(B, S).astype(np.float32))
        x_carry = (x_carry - x_carry.amax(dim=-1, keepdim=True)).to(device)
        cont = torch.from_numpy(np.asarray(cont, bool)).to(device)
        lens = torch.from_numpy(np.asarray(lengths, np.int32)).to(device)
        return (p.log_trans, obs, x_carry, cont, lens)

    body = EXACT_REGION - 1
    last = body - (EXACT_CHUNKS - 1) * EXACT_CHUNK
    ragged = rng.randint(0, L_ROWS + 1, size=B_ROWS)
    ragged[:4] = [L_ROWS, 0, 1, 2]
    out = {}
    for B, L, lengths, cont in (
            (1, EXACT_CHUNK, [EXACT_CHUNK], [True]),
            (EXACT_CHUNKS, EXACT_CHUNK,
             [EXACT_CHUNK] * (EXACT_CHUNKS - 1) + [last],
             [True] * (EXACT_CHUNKS - 1) + [False]),
            (B_ROWS, L_ROWS, ragged, rng.rand(B_ROWS) < 0.5)):
        args = inputs(B, L, lengths, cont)
        lim = _f3_limit(float(args[1].abs().max()))
        beta, x_out = ck.backward_chunk_values(*args)
        ref = [_ref64(x) for x in
               dp.backward_chunk_values(*args, dtype=f64)]
        err = max(_assert_close(f"X2 values at {B} x {L}", beta.double(),
                                ref[0], 0.0, lim),
                  _assert_close(f"X2 x_out at {B} x {L}", x_out.double(),
                                ref[1], 0.0, lim))
        ms = _median_ms(lambda: ck.backward_chunk_values(*args), 5)
        out[f"bwd_chunk@{B}x{L}"] = dict(
            max_abs_err=err, limit=lim, ms=ms,
            plain_ms=_median_ms(lambda: dp.backward_chunk_values(*args), 1),
            us_per_step=ms * 1e3 / L,
            **_bound("bwd_chunk", (B, L, S, T, V), int(sum(lengths))))
        del args, beta, x_out, ref

    L = EXACT_CHUNKS * EXACT_CHUNK
    args = inputs(1, L, [body], [False])
    lt, obs, x_carry, cont, lens = args
    lim = _f3_limit(float(obs.abs().max()))
    got = ck.backward_checkpoints(*args, EXACT_CHUNK)
    # every chunk through the float64 plain values mode from the kernel's
    # x_carry leaving the chunk after it, all chunks as rows of one call
    exits = torch.cat([got[:, 1:], x_carry[:, None]], dim=1)[0]
    starts = torch.arange(EXACT_CHUNKS, device=device) * EXACT_CHUNK
    c_cont = torch.cat([body > starts[:-1] + EXACT_CHUNK, cont])
    _, want = dp.backward_chunk_values(
        lt, obs.view(EXACT_CHUNKS, EXACT_CHUNK, S), exits.contiguous(),
        c_cont, torch.clamp(body - starts, 0, EXACT_CHUNK).to(torch.int32),
        dtype=f64)
    err = _assert_close("X2 checkpoints, chunk by chunk", got[0].double(),
                        _ref64(want), 0.0, lim)
    # the plain chain itself (a Python loop a position) on the last
    # PLAIN_CHUNKS chunks, from the row's end: timed in float32, held in
    # float64
    n_p = PLAIN_CHUNKS * EXACT_CHUNK
    c0 = L - n_p
    tail = (lt, obs[:, c0:].contiguous(), x_carry, cont,
            torch.clamp(lens - c0, 0, n_p).to(torch.int32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp.backward_checkpoints(*tail, EXACT_CHUNK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    chain = dp.backward_checkpoints(lt.double(), tail[1].double(),
                                    x_carry.double(), cont, tail[4],
                                    EXACT_CHUNK)
    err = max(err, _assert_close("X2 checkpoints against the plain chain",
                                 got[:, -PLAIN_CHUNKS:].double(),
                                 _ref64(chain), 0.0, lim))
    ms = _median_ms(lambda: ck.backward_checkpoints(*args, EXACT_CHUNK), 5)
    out["bwd_checkpoints"] = dict(
        max_abs_err=err, limit=lim, ms=ms, plain_ms=plain_ms,
        plain_positions=n_p, us_per_step=ms * 1e3 / body,
        **_bound("bwd_checkpoints", (1, L, S, T, V), body,
                 n_ck=EXACT_CHUNKS))
    for name, r in out.items():
        print(f"[kernels] {name:30s} max_abs_err {r['max_abs_err']:.3g} "
              f"(F3 {r['limit']:.3g})  kernel {r['ms']:10.3f} ms "
              f"({r['us_per_step']:.4f} us a step, bound "
              f"{r['bound_ms']:.4f} ms)  plain {r['plain_ms']:10.3f} ms",
              flush=True)
    return out


def _assert_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} values outside rtol {rtol} / atol "
        f"{atol}; max abs err {float(err.max()):.4g}")
    return float(err.max()) if err.numel() else 0.0


def _limit_ratio(got, want, rtol, atol):
    """The largest ratio of |got - want| to its limit atol + rtol|want|,
    over the entries (< 1 where ``_assert_close`` passes)."""
    err = (got - want).abs()
    return float((err / (atol + rtol * want.abs())).max()) \
        if err.numel() else 0.0


def _ref64(t):
    """A float64 plain version's output as the kernels are held to it:
    LOG_ZERO (-1e30) entries, which a float32 kernel can only hold as
    float32's -1e30, at that value; every other entry as it is."""
    import torch

    return torch.where(t < -1e29, t.float().double(), t)


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


def _k1_lanes_against_shared(args, **st):
    """K1's step on ``args`` (``ck.k1_step``) and, where it is the lanes
    kernels, every output of both (alpha_p, dm, m_raw, start, pair, em
    and the gaussian moments) held to the shared kernels', forced with
    ``K1_LANES_MAX_STATES`` = 0, bit for bit.  Returns the step."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools.time_k1 import shared_k1

    S_, T_, V_ = args[2].shape
    G = 0 if st.get("gauss_values") is None else st["gauss_values"].shape[-1]
    step = ck.k1_step(S_, T_, V_, G)
    if step != "lanes":
        return step

    def outputs():
        alpha, dm, m_raw = ck.em_fwd(*args, **st)
        stats = ck.em_bwd_stats(*args[1:], alpha, m_raw, **st)
        return [alpha, dm, m_raw, *stats[:3]] + \
            (list(stats[3]) if len(stats) > 3 else [])

    lanes = outputs()
    with shared_k1():
        shared = outputs()
    names = ("alpha_p", "dm", "m_raw", "start", "pair", "em", "gn", "gx",
             "gx2")
    for name, a, b in zip(names, lanes, shared):
        assert torch.equal(a, b), \
            f"K1's lanes kernels and the shared ones differ in {name}"
    return step


def phase_k1(device, rng) -> dict:
    """K1 against its plain version (and the plain log-space E-step) at
    bench.py's shape, on a random model with dirichlet rows."""
    import torch

    from tehmm_tpu_torch.models.params import from_numpy
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import em
    from tehmm_tpu_torch.tools.time_k1 import shared_k1

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
    step = _k1_lanes_against_shared(args)
    alpha, _dm, m_raw = ck.em_fwd(*args)
    bwd_args = (p.log_trans, p.log_em, sym, lens, alpha, m_raw)
    out = {
        "em_fwd": dict(
            max_abs_err=err["em_fwd"], step=step,
            ms=_median_ms(lambda: ck.em_fwd(*args), 5),
            plain_ms=_median_ms(lambda: ck.em_fwd_plain(*args), 3)),
        "em_bwd_stats": dict(
            max_abs_err=err["em_bwd_stats"], step=step,
            ms=_median_ms(lambda: ck.em_bwd_stats(*bwd_args), 5),
            plain_ms=_median_ms(
                lambda: ck.em_bwd_stats_plain(*bwd_args), 3)),
    }
    if step == "lanes":           # the shared kernels, forced, beside
        with shared_k1():
            out["em_fwd"]["shared_ms"] = _median_ms(
                lambda: ck.em_fwd(*args), 5)
            out["em_bwd_stats"]["shared_ms"] = _median_ms(
                lambda: ck.em_bwd_stats(*bwd_args), 5)
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
    print(f"[kernels] K1 at S={S} T={T} V={V} B={B} L={L}: the {step} "
          f"kernels (bit for bit the shared ones', forced), repeat runs "
          f"bit-identical; E-step loglik rel err vs plain log-space "
          f"engine {rel:.3g}", flush=True)
    print(f"[kernels] {'E-step (em_counts_fused)':22s} kernels "
          f"{estep_ms:10.3f} ms  plain {estep_plain_ms:10.3f} ms",
          flush=True)
    for name, r in out.items():
        print(f"[kernels] {name:22s} max_abs_err {r['max_abs_err']:.3g}  "
              f"kernel {r['ms']:10.3f} ms ({r['step']}; shared forced "
              f"{r.get('shared_ms', float('nan')):.3f})  plain "
              f"{r['plain_ms']:10.3f} ms", flush=True)
    return out


def _sweep_check(p, device, rng, label="X1/X2"):
    """X1 (``forward_chunk_values``, ``forward_final``) and X2
    (``backward_chunk_values``) at S on X_B rows of X_L (ragged: full,
    0, 1, random) drawn from ``rng``, against the plain versions carried
    in float64: rows and carries alike within the F3 limit, SCAN_ATOL
    plus SCAN_OBS_ULPS float32 ulps of the input's largest |obs| (each
    step rounds obs + log(sum) and its max, each to half an ulp of
    |obs|).  The float32 plain version is held to the same limit, so the
    limit is one float32 arithmetic can meet.  X1's two modes end in one
    carry; repeat launches bit-identical.  Prints each check's worst
    error / limit, the kernel's and the float32 plain version's.
    Returns ((obs, init, cont, lengths, lengths on the host), errors,
    ratios, float32 ratios)."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    x_lens = np.asarray([X_L, 0, 1, rng.randint(2, X_L)], np.int32)
    x_sym = torch.from_numpy(
        rng.randint(0, V, size=(X_B, X_L, T)).astype(np.int32)).to(device)
    obs = track_log_likelihoods(p.log_em, x_sym)
    xl = torch.from_numpy(x_lens).to(device)
    init = torch.from_numpy(rng.randn(X_B, S).astype(np.float32)).to(device)
    init = init - init.amax(dim=-1, keepdim=True)
    cont = torch.tensor([True, False, False, False], device=device)
    lt = p.log_trans
    lim = SCAN_ATOL + SCAN_OBS_ULPS * F32_EPS * float(obs.abs().max())
    hats, carry = ck.forward_chunk_values(lt, obs, init, xl)
    assert torch.equal(hats, ck.forward_chunk_values(lt, obs, init, xl)[0])
    final, _dm = ck.forward_final(lt, obs, init, xl)
    assert torch.equal(final, carry), "X1's two modes end in other carries"
    beta, x_out = ck.backward_chunk_values(lt, obs, init, cont, xl)
    assert torch.equal(
        beta, ck.backward_chunk_values(lt, obs, init, cont, xl)[0])
    ref = [_ref64(x) for x in
           dp.forward_chunk_values(lt, obs, init, xl, dtype=torch.float64)
           + dp.backward_chunk_values(lt, obs, init, cont, xl,
                                      dtype=torch.float64)]
    plain = (dp.forward_chunk_values(lt, obs, init, xl)
             + dp.backward_chunk_values(lt, obs, init, cont, xl))
    names = ("X1 hats", "X1 carry", "X2 beta", "X2 x_out")
    err, ratio, f32 = {}, {}, {}
    for name, got, want, fl in zip(names, (hats, carry, beta, x_out), ref,
                                   plain):
        f32[name] = _limit_ratio(fl, want, 0.0, lim)
        assert f32[name] <= 1.0, \
            f"{label} {name}: float32 plain at {f32[name]:.3f} of the limit"
        err[name] = _assert_close(f"{label} {name}", got, want, 0.0, lim)
        ratio[name] = _limit_ratio(got, want, 0.0, lim)
    print(f"[kernels] {label} X1/X2 at S={S}, {X_B} rows of {X_L}, against "
          f"plain in float64 within {lim:.3g} [worst error/limit: kernel; "
          f"float32 plain]: " + ", ".join(
              f"{k} {err[k]:.3g} [{ratio[k]:.3f}; {f32[k]:.3f}]"
              for k in names), flush=True)
    return (obs, init, cont, xl, x_lens), err, ratio, f32



def _k4_check(args, label, **st):
    """K4's decode on K1's forward rows at one shape, as
    ``posterior_decode_fused`` calls it: the lanes kernel (``ck.k4_step``)
    bit for bit the shared kernel's (forced), two launches bit-identical,
    0 at padding, and the paths within the near-tie rule of the plain
    version (>= 99.999% of positions equal, every differing one a
    near-tie).  Returns (dec_args, lanes path, plain path, differing
    positions, valid positions, largest differing gap)."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools.time_k1 import shared_k4

    _ls, lt, lem, sym, lens = args
    S_, T_, V_ = lem.shape
    G = 0 if st.get("gauss_values") is None else STREAM_G
    assert ck.k4_step(S_, T_, V_, G) == "lanes", "K4 left its lanes step"
    alpha = ck.em_fwd(*args, **st)[0]
    dec = (lt, lem, sym, lens, alpha)
    got = ck.post_decode(*dec, **st)
    assert torch.equal(got, ck.post_decode(*dec, **st)), \
        f"two {label} launches differ"
    with shared_k4():
        shared = ck.post_decode(*dec, **st)
    assert torch.equal(got, shared), \
        f"{label}: the lanes decode differs from the shared one on " \
        f"{int((got != shared).sum())} positions"
    want, margin = ck.post_decode_plain(*dec, with_margin=True, **st)
    L_ = sym.shape[1]
    valid = torch.arange(L_, device=sym.device)[None, :] < lens[:, None]
    assert not bool((got[~valid] != 0).any()), f"{label} not 0 at padding"
    differ = (got != want) & valid
    n_diff, n_valid = int(differ.sum()), int(valid.sum())
    worst = float(margin[differ].max()) if n_diff else 0.0
    assert 1.0 - n_diff / n_valid >= 0.99999, \
        f"{label} differs from plain on {n_diff} of {n_valid} positions"
    assert worst <= NEAR_TIE, \
        f"{label} differs from plain where the top two are {worst} apart"
    return dec, got, want, n_diff, n_valid, worst


def _k4_rows(dec, got, want, n_diff, shape, valid, G=0, **st):
    """The ``kernels`` entries of K4's lanes decode and of its shared one
    (forced) at one shape: each timed (median of 5) beside the plain
    version (median of 3) and the bound, with us a step."""
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools.time_k1 import shared_k4

    L_ = shape[1]
    bound = _bound("post_decode", shape, valid, G, "obs_weights" in st
                   and st["obs_weights"] is not None)
    ms = _median_ms(lambda: ck.post_decode(*dec, **st), 5)
    with shared_k4():
        shared_ms = _median_ms(lambda: ck.post_decode(*dec, **st), 5)
    plain_ms = _median_ms(lambda: ck.post_decode_plain(*dec, **st), 3)
    lanes = dict(max_abs_err=float((got - want).abs().max()),
                 differing_positions=n_diff, step="lanes", ms=ms,
                 us_per_step=ms * 1e3 / L_, shared_ms=shared_ms,
                 shared_us_per_step=shared_ms * 1e3 / L_,
                 plain_ms=plain_ms, **bound)
    shared = dict(max_abs_err=lanes["max_abs_err"],
                  differing_positions=n_diff, step="shared (forced)",
                  ms=shared_ms, us_per_step=shared_ms * 1e3 / L_,
                  plain_ms=plain_ms, **bound)
    return lanes, shared


def phase_post_kernels(device, rng, seed) -> dict:
    """K4's decode and the chunk sweeps X1, X2 against their plain
    versions, at the shapes the max-posterior path gives them; then the
    piece-operator scan (``phase_piece_scan``, on a generator of its own
    so that the later phases draw the same data)."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp
    from tehmm_tpu_torch.parallel import stitch

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
    # calls it: the lanes kernel, bit for bit the shared one (forced), at
    # the pass before 512 rows (K4_B) and at the pass (ragged, a
    # generator of its own so that the later phases draw the same data)
    dec_args, got, want, n_diff, n_valid, worst = _k4_check(args, "K4")
    assert torch.equal(got, ck.posterior_decode_fused(*args)), \
        "posterior_decode_fused differs from em_fwd + post_decode"
    print(f"[kernels] K4 decode at S={S} T={T} V={V}, {K4_B} rows of "
          f"L={K4_L} (ragged): the lanes kernel bit for bit the shared "
          f"one's (forced); {n_diff} of {n_valid} positions differ from "
          f"the plain version, each a near-tie (largest top-two gap "
          f"{worst:.3g} relative); repeat launches bit-identical",
          flush=True)
    out["post_decode_lanes"], out["post_decode"] = _k4_rows(
        dec_args, got, want, n_diff, (K4_B, K4_L, S, T, V),
        int(lengths.sum()))
    out["post_decode_lanes"]["fused_ms"] = _median_ms(
        lambda: ck.posterior_decode_fused(*args), 5)
    out["post_decode"]["note"] = (
        "the shared decode forced at S=10; its route is 33 states to "
        "K4's envelope, which no main path reaches")
    del dec_args, got, want
    prng = np.random.RandomState(seed + 9)
    B5 = stitch.MAXPOST_ROWS_PER_PASS["fused"]
    lengths5 = _ragged(prng, B5, K4_L)
    sym5 = torch.from_numpy(
        prng.randint(0, V, size=(B5, K4_L, T)).astype(np.int32)).to(device)
    args5 = (p.log_start, p.log_trans, p.log_em, sym5,
             torch.from_numpy(lengths5).to(device))
    dec5, got5, want5, n_diff5, n_valid5, worst5 = _k4_check(args5, "K4")
    name5 = f"post_decode_lanes@{B5}x{K4_L}"
    out[name5] = _k4_rows(dec5, got5, want5, n_diff5, (B5, K4_L, S, T, V),
                          int(lengths5.sum()))[0]
    print(f"[kernels] K4 decode at {B5} rows of L={K4_L} (ragged): the "
          f"lanes kernel bit for bit the shared one's; {n_diff5} of "
          f"{n_valid5} positions differ from plain, each a near-tie "
          f"({worst5:.3g}); lanes {out[name5]['ms']:.3f} ms "
          f"({out[name5]['us_per_step']:.4f} us a step), shared "
          f"{out[name5]['shared_ms']:.3f} ms, at {K4_B} rows lanes "
          f"{out['post_decode_lanes']['ms']:.3f} ms, shared "
          f"{out['post_decode']['ms']:.3f} ms", flush=True)
    del dec5, got5, want5, args5, sym5

    # X1 and X2 on obs of a few long rows, ragged, against the plain
    # versions carried in float64 at the F3 limit; then the same check on
    # F3_SEEDS further draws, each from its own generator
    (obs, init, cont, xl, x_lens), err, ratio, f32 = _sweep_check(
        p, device, rng)
    lt = p.log_trans
    final, dm_sum = ck.forward_final(lt, obs, init, xl)
    assert torch.equal(dm_sum, ck.forward_final(lt, obs, init, xl)[1])
    _p_final, p_dm = dp.forward_final(lt, obs, init, xl, dtype=torch.float64)
    # the summed normalizers (|sum| ~ 4e4) are held relative to their size
    dm_rel = _assert_close("X1 dm sum", dm_sum, p_dm, 1e-6, 1e-6) \
        / float(p_dm.abs().max())
    out["fwd_chunk"] = dict(max_abs_err=max(err["X1 hats"],
                                            err["X1 carry"]))
    out["bwd_chunk"] = dict(max_abs_err=max(err["X2 beta"],
                                            err["X2 x_out"]))
    print(f"[kernels] X1 dm sum {dm_rel:.3g} relative", flush=True)
    for seed in range(F3_SEEDS):
        srng = np.random.RandomState(seed)
        _sweep_check(_decode_model(srng, device), device, srng,
                     f"F3 seed {seed}")
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
    for name in ("fwd_chunk", "bwd_chunk"):
        out[name].update(_bound(name, (X_B, X_L, S, T, V),
                                int(x_lens.sum())))
    print(f"[kernels] X1/X2 at S={S}, {X_B} rows of {X_L} (ragged): within "
          f"tolerance of the plain versions, repeat launches "
          f"bit-identical; K4 fused (em_fwd + decode) "
          f"{out['post_decode_lanes']['fused_ms']:.3f} ms, X1 carry-only "
          f"{out['fwd_chunk']['carry_only_ms']:.3f} ms (plain "
          f"{out['fwd_chunk']['carry_only_plain_ms']:.3f} ms)", flush=True)
    for name, r in out.items():
        print(f"[kernels] {name:22s} max_abs_err {r['max_abs_err']:.3g}  "
              f"kernel {r['ms']:10.3f} ms  plain {r['plain_ms']:10.3f} ms",
              flush=True)
    out.update(phase_piece_scan(device, np.random.RandomState(seed + 5)))
    return out


def _piece_inputs(rng, device, S_, B, L, full=False):
    """The decode model (S) or a sticky random one (other S), obs of B
    rows of L from random symbols (one row: full length; four: full, 0,
    1, random, or all full with ``full``), a carry (max 0)."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.models.params import from_numpy

    p = (_decode_model(rng, device) if S_ == S
         else from_numpy(*_sticky_model(rng, S_, T, V), device))
    lengths = np.asarray([L, 0, 1, rng.randint(2, L)][:B], np.int32)
    if full:
        lengths[:] = L
    sym = torch.from_numpy(
        rng.randint(0, V, size=(B, L, T)).astype(np.int32)).to(device)
    obs = track_log_likelihoods(p.log_em, sym)
    init = torch.from_numpy(rng.randn(B, S_).astype(np.float32)).to(device)
    init = init - init.amax(dim=-1, keepdim=True)
    return (p.log_trans, obs, init, torch.from_numpy(lengths).to(device),
            lengths)


def phase_piece_scan(device, rng) -> dict:
    """X1's carry-only function as the piece-operator scan
    (``ck.forward_loglik``: ``fwd_piece_ops``, ``fwd_piece_compose``)
    against its plain versions in float64 at S, at PIECE_SHAPES: phase A's
    probability rows within the F3 limit and log scales within 1e-6
    relative plus ``_sum_atol`` of ``dp.piece_operators``; phase B, fed
    the kernel's operators, the carry within the F3 limit and each
    piece's increment within the same sum limit of ``dp.compose_pieces``;
    the whole scan's carry within the F3 limit and summed increments
    within the sum limit of the chain ``dp.forward_final``; two launches
    bit-identical.  Then the same-call A/B of the chain
    (``ck.forward_final``, X1 carry-only) and the pieces at PIECE_AB_STATES
    x PIECE_AB_SHAPES (chain, pieces, pieces, chain; median of 5 each),
    the two held to the float64 chain at the same limits.  Returns the
    two kernels' rows, timed at the first of PIECE_SHAPES (the eval CLI's
    launch: one table, chunks of 4096) and at the others."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    f64 = torch.float64
    rows = {"fwd_piece_ops": {}, "fwd_piece_compose": {}}
    for B_, L_ in PIECE_SHAPES:
        lt, obs, init, lens, lengths = _piece_inputs(rng, device, S, B_, L_)
        m = float(obs.abs().max())
        lim = _f3_limit(m)
        probs, n = ck.piece_operators(lt, obs, lens)
        n_p = probs.shape[1]
        live = (torch.arange(n_p, device=device)[None, :] * dp.PIECE
                < lens[:, None].long())
        want_p, want_n = dp.piece_operators(lt, obs, lens, dtype=f64)
        err = {"A rows": _assert_close("fwd_piece_ops rows", probs[live],
                                       want_p[live], 0.0, lim),
               "A log scales": _assert_close(
                   "fwd_piece_ops log scales", n[live], want_n[live], 1e-6,
                   _sum_atol(dp.PIECE, S, m))}
        ratio = {"A rows": _limit_ratio(probs[live], want_p[live], 0.0, lim),
                 "A log scales": _limit_ratio(n[live], want_n[live], 1e-6,
                                              _sum_atol(dp.PIECE, S, m))}
        del want_p, want_n
        carry, incs = ck.compose_pieces(probs, n, init, lens)
        want_c, want_i = dp.compose_pieces(probs.double(), n, init.double(),
                                           lens)
        err["B carry"] = _assert_close("fwd_piece_compose carry", carry,
                                       _ref64(want_c), 0.0, lim)
        err["B increments"] = _assert_close(
            "fwd_piece_compose increments", incs, want_i, 1e-6,
            _sum_atol(1, S, m))
        ratio["B carry"] = _limit_ratio(carry, _ref64(want_c), 0.0, lim)
        ratio["B increments"] = _limit_ratio(incs, want_i, 1e-6,
                                             _sum_atol(1, S, m))
        got_c, got_dm = ck.forward_loglik(lt, obs, init, lens)
        again = ck.forward_loglik(lt, obs, init, lens)
        assert torch.equal(got_c, again[0]) and torch.equal(got_dm, again[1])
        ref_c, ref_dm = dp.forward_final(lt, obs, init, lens, dtype=f64)
        err["carry"] = _assert_close("piece scan carry", got_c,
                                     _ref64(ref_c), 0.0, lim)
        err["increments"] = _assert_close("piece scan increments", got_dm,
                                          ref_dm, 1e-6,
                                          _sum_atol(L_, S, m))
        ratio["carry"] = _limit_ratio(got_c, _ref64(ref_c), 0.0, lim)
        ratio["increments"] = _limit_ratio(got_dm, ref_dm, 1e-6,
                                           _sum_atol(L_, S, m))
        print(f"[kernels] piece-operator scan at S={S}, {B_} x {L_}: "
              f"against plain in float64 (F3 limit {lim:.3g}; 1e-6 "
              f"relative) [worst error/limit]: " + ", ".join(
                  f"{k} {err[k]:.3g} [{ratio[k]:.3f}]" for k in err)
              + "; repeat launches bit-identical", flush=True)
        tag = f"{B_}x{L_}"
        valid = int(np.minimum(lengths, L_).sum())
        live_pieces = int(live.sum())
        shape = (B_, L_, S, T, V)
        # both kernels' rows carry the bound of the function they compute
        # together, X1's carry-only function, whatever implements it;
        # beside it each kernel's own design bound (phase A: S chains a
        # position, S times the function's arithmetic)
        function = _bound("forward_final", shape, valid)
        timed = {
            "fwd_piece_ops": dict(
                ms=_median_ms(lambda: ck.piece_operators(lt, obs, lens), 5),
                plain_ms=_median_ms(
                    lambda: dp.piece_operators(lt, obs, lens), 3),
                max_abs_err=max(err["A rows"], err["A log scales"]),
                **function, **_design_bound("fwd_piece_ops", shape, valid)),
            "fwd_piece_compose": dict(
                ms=_median_ms(
                    lambda: ck.compose_pieces(probs, n, init, lens), 5),
                plain_ms=_median_ms(
                    lambda: dp.compose_pieces(probs, n, init, lens), 3),
                max_abs_err=max(err["B carry"], err["B increments"]),
                **function,
                **_design_bound("fwd_piece_compose", shape, live_pieces)),
        }
        whole = _median_ms(lambda: ck.forward_loglik(lt, obs, init, lens), 5)
        for name, r in timed.items():
            r.update(whole_ms=whole)
            rows[name][tag] = r
            print(f"[kernels] {name + ' ' + tag:30s} kernel {r['ms']:9.3f} "
                  f"ms  plain {r['plain_ms']:9.3f} ms  design bound "
                  f"{r['design_bound_ms']:.5f} ms ({r['design_bound_by']})",
                  flush=True)
        print(f"[kernels] piece-operator scan {tag}: forward_loglik "
              f"{whole:.3f} ms; the function's bound (both kernels' "
              f"bound_ms) {function['bound_ms']:.5f} ms "
              f"({function['bound_by']})", flush=True)
        del probs, n, want_c, want_i
    out = {}
    for name, by_shape in rows.items():
        first = f"{PIECE_SHAPES[0][0]}x{PIECE_SHAPES[0][1]}"
        out[name] = dict(by_shape[first])
        for tag, r in by_shape.items():
            if tag != first:
                out[name].update({f"{k}_{tag}": r[k] for k in
                                  ("ms", "plain_ms", "bound_ms",
                                   "design_bound_ms", "whole_ms")})
    out["fwd_piece_ops"]["ab"] = _piece_scan_ab(device, rng)
    return out


def _design_bound(name, shape, valid) -> dict:
    """A piece kernel's own bound (``_bound``), under its own keys."""
    b = _bound(name, shape, valid)
    return dict(design_bound_ms=b["bound_ms"], design_bound_by=b["bound_by"])


def _pieces(lt, obs, init, lens):
    """The piece-operator scan's two kernels, whatever S
    ``ck.forward_loglik`` would route (the A/B times them past it)."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck

    carry, incs = ck.compose_pieces(*ck.piece_operators(lt, obs, lens),
                                    init, lens)
    return carry, incs.sum(dim=1).to(torch.float32)


def _piece_scan_ab(device, rng) -> list:
    """The chain (``ck.forward_final``: X1 carry-only, ``fwd_chunk``) and
    the pieces (``_pieces``) on the same inputs, full rows, in one call:
    chain, pieces, pieces, chain, each the median of 5; both held to the
    float64 chain (carry within the F3 limit, increments within 1e-6
    relative plus ``_sum_atol``).  At 168 and 169 states it reads the
    crossover that ``ck.PIECE_SCAN_MAX_STATES`` keeps; the rows'
    crossover (``ck.piece_scan_route``) is read by ``tools/time_score``."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    out = []
    for S_ in PIECE_AB_STATES:
        for B_, L_ in PIECE_AB_SHAPES:
            lt, obs, init, lens, _ = _piece_inputs(rng, device, S_, B_, L_,
                                                   full=True)
            m = float(obs.abs().max())
            lim = _f3_limit(m)
            ref_c, ref_dm = dp.forward_final(lt, obs, init, lens,
                                             dtype=torch.float64)
            ratio = {}
            for name, fn in (("chain", ck.forward_final),
                             ("pieces", _pieces)):
                c, dm = fn(lt, obs, init, lens)
                _assert_close(f"{name} carry S={S_}", c, _ref64(ref_c), 0.0,
                              lim)
                atol = _sum_atol(L_, S_, m)
                _assert_close(f"{name} increments S={S_}", dm, ref_dm, 1e-6,
                              atol)
                ratio[name] = (_limit_ratio(c, _ref64(ref_c), 0.0, lim),
                               _limit_ratio(dm, ref_dm, 1e-6, atol))
            t = {"chain": [], "pieces": []}
            for name in ("chain", "pieces", "pieces", "chain"):
                fn = ck.forward_final if name == "chain" else _pieces
                t[name].append(_median_ms(lambda: fn(lt, obs, init, lens),
                                          5))
            row = dict(S=S_, rows=B_, L=L_, chain_ms=t["chain"],
                       pieces_ms=t["pieces"],
                       speedup=min(t["chain"]) / min(t["pieces"]),
                       worst_ratio=ratio,
                       route=("pieces" if ck.piece_scan_route(B_, S_)
                              else "chain"))
            out.append(row)
            print(f"[piece A/B] S={S_} {B_} x {L_} (the score's route: "
                  f"{row['route']}): chain {t['chain'][0]:.3f}"
                  f" / {t['chain'][1]:.3f} ms, pieces {t['pieces'][0]:.3f} / "
                  f"{t['pieces'][1]:.3f} ms ({row['speedup']:.2f}x); worst "
                  f"error/limit (carry, increments) chain "
                  f"{ratio['chain'][0]:.3f}, {ratio['chain'][1]:.3f}, "
                  f"pieces {ratio['pieces'][0]:.3f}, "
                  f"{ratio['pieces'][1]:.3f}", flush=True)
            del lt, obs, init, lens, ref_c, ref_dm
            torch.cuda.empty_cache()
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
    from tehmm_tpu_torch.parallel import stitch

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
        out.update(_k2_forward_rows(
            args, (B_ROWS, L_ROWS, S, T, V), int(lengths.sum()),
            STREAM_G if "g" in variant else 0, "w" in variant, **st))
        path, _score = ck.viterbi_fused(*args, **st)
        obs = obs_log_likelihoods(p.log_em, sym, st["gauss_params"],
                                  st["gauss_values"], st["obs_weights"])
        want_p, _ = dp.viterbi(p.log_start, p.log_trans, obs, lens)
        assert torch.equal(path, want_p), \
            f"viterbi_fused{variant} path != dp.viterbi"
        del obs, want_p, path
    print(f"[streams] K2 forward at S={S} T={T} V={V}, {B_ROWS} rows of "
          f"L={L_ROWS} (ragged), weights in [{W_LO:g}, {W_HI:g}], "
          f"{STREAM_G} gaussian tracks (10% missing): value rows, "
          f"normalizers, pointers, last rows and paths bit-equal to plain "
          f"(and the lanes kernel's to the shared one's, forced) for "
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
        step = _k1_lanes_against_shared(args1, **st)
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
            max_abs_err=err_fwd, step=step,
            ms=_median_ms(lambda: ck.em_fwd(*args1, **st), 5),
            plain_ms=_median_ms(lambda: ck.em_fwd_plain(*args1, **st), 3),
            **_bound("em_fwd", shape1, int(lengths1.sum()), G,
                     "w" in variant))
        out["em_bwd_stats" + variant] = dict(
            max_abs_err=err_bwd, step=step,
            ms=_median_ms(lambda: ck.em_bwd_stats(*bwd, **st), 5),
            plain_ms=_median_ms(lambda: ck.em_bwd_stats_plain(*bwd, **st),
                                3),
            **_bound("em_bwd_stats", shape1, int(lengths1.sum()), G,
                     "w" in variant))
        del alpha, pa, dm, pdm, m_raw, pm, bwd
    print(f"[streams] K1 at S={S1} T={T1} V={V1} B={B1} L={L1} (ragged): "
          f"the {step} kernels, bit for bit the shared ones' (forced), "
          f"within tolerance of plain (moments within 1e-4 of their "
          f"largest entry), repeat runs bit-identical, for "
          f"{', '.join(STREAM_VARIANTS)}", flush=True)

    # K4's decode at the stitched max-posterior decode's shape (the pass
    # before 512 rows), lanes and shared
    lengths4 = _ragged(rng, K4_B, K4_L)
    sym4 = torch.from_numpy(
        rng.randint(0, V, size=(K4_B, K4_L, T)).astype(np.int32)
    ).to(device)
    lens4 = torch.from_numpy(lengths4).to(device)
    args4 = (p.log_start, p.log_trans, p.log_em, sym4, lens4)
    # and at the pass (ragged), bit for bit only
    B5 = stitch.MAXPOST_ROWS_PER_PASS["fused"]
    lengths5 = _ragged(rng, B5, K4_L)
    sym5 = torch.from_numpy(
        rng.randint(0, V, size=(B5, K4_L, T)).astype(np.int32)).to(device)
    args5 = (p.log_start, p.log_trans, p.log_em, sym5,
             torch.from_numpy(lengths5).to(device))
    for variant in STREAM_VARIANTS:
        st = _stream_inputs(rng, device, variant, K4_B, K4_L, S)
        G = STREAM_G if "g" in variant else 0
        dec, got, want, n_diff, n_valid, worst = _k4_check(
            args4, "post_decode" + variant, **st)
        assert torch.equal(got, ck.posterior_decode_fused(*args4, **st))
        out["post_decode_lanes" + variant], out["post_decode" + variant] = \
            _k4_rows(dec, got, want, n_diff, (K4_B, K4_L, S, T, V),
                     int(lengths4.sum()), G, **st)
        out["post_decode_lanes" + variant]["fused_ms"] = _median_ms(
            lambda: ck.posterior_decode_fused(*args4, **st), 5)
        del dec, got, want
        st5 = _stream_inputs(rng, device, variant, B5, K4_L, S)
        _dec, _got, _want, n_diff5, n_valid5, worst5 = _k4_check(
            args5, f"post_decode{variant} at {B5} rows", **st5)
        del _dec, _got, _want, st5
        print(f"[streams] K4 decode{variant}: the lanes kernel bit for bit "
              f"the shared one's (forced) at {K4_B} and {B5} rows; "
              f"{n_diff} of {n_valid} and {n_diff5} of {n_valid5} "
              f"positions differ from plain, each a near-tie (largest "
              f"top-two gaps {worst:.3g}, {worst5:.3g}); repeat launches "
              f"bit-identical", flush=True)
    for name, r in out.items():
        print(f"[streams] {name:22s} max_abs_err {r['max_abs_err']:.3g}  "
              f"kernel {r['ms']:10.3f} ms  plain {r['plain_ms']:10.3f} ms",
              flush=True)
    return out


def _scan_rows(out, name, suffix, S_, got, call, plain, err, shape, valid):
    """The rows of a cluster scan (``name``, a key of ``CLUSTER_OF``)
    whose outputs ``got`` (a tuple) came from ``call``: past 256 states
    the cluster tile ran (``CLUSTER_OF[name]``, with the staged tile's
    time beside it), and the staged tile, forced, must give the same bits;
    ``name`` is then the staged tile's row.  To 256 states every scan of
    ``LOG_SCANS`` ran its own kernels (``ck.scan_counter``:
    ``fwd_scaled_lanes``, ``fwd_prob_rows``, ``viterbi_ptrs_rows``, ...,
    with the block tile's time beside, ``tile_ms``), and the block tile,
    forced, must give the same bits; ``name`` is then the block tile's
    row."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools.time_scans import block_tile, staged_tile

    plain_ms = _median_ms(plain, 3)
    ms = _median_ms(call, 5)
    if name in LOG_SCANS and S_ <= 256:
        with block_tile():
            tile = call()
            tile_ms = _median_ms(call, 5)
        assert all(torch.equal(a, b) for a, b in zip(got, tile)), \
            f"{name}: the {ck.log_scan_route(S_)} kernel != the block " \
            f"tile at {shape}"
        own = ck.scan_counter(name, S_)
        out[own + suffix] = dict(
            max_abs_err=err, ms=ms, tile_ms=tile_ms, plain_ms=plain_ms,
            **_bound(own, shape, valid))
        ms = tile_ms
    if ck.scan_route(S_) == "cluster":
        with staged_tile():
            staged = call()
            staged_ms = _median_ms(call, 5)
        assert all(torch.equal(a, b) for a, b in zip(got, staged)), \
            f"{name}: the cluster tile != the staged tile at {shape}"
        out[CLUSTER_OF[name] + suffix] = dict(
            max_abs_err=err, ms=ms, staged_ms=staged_ms, plain_ms=plain_ms,
            **_bound(CLUSTER_OF[name], shape, valid))
        ms = staged_ms
    out[name + suffix] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              **_bound(name, shape, valid))


def phase_streaming_kernels(device, rng, seed) -> dict:
    """K5, K6a, K6b, the backtrace of ``dp.viterbi_streaming``, K8c and
    its chase, K7a/K8a and K7b/K8b against their plain versions on the
    obs tensors of every ``bench_engines`` shape, ragged: the block
    layouts differ from shape to shape (12, 4, 2 and 1 row groups per
    block; at S=256 part of the transition matrix is read from global
    memory).  K6 and K7 are held against the plain version carried in
    float64, whose own rounding then takes nothing of the limits; the
    distance to the float32 plain version is printed.  The S=20 results
    go under the kernels' names, the others under ``name@config``."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp
    from tehmm_tpu_torch.tools import bench_engines

    out = {}
    f64 = torch.float64
    for config in ENGINE_CONFIGS + WIDE_CONFIGS:
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
        _scan_rows(out, "viterbi_values", suffix, S_, (v, dm),
                   lambda: ck.viterbi_values(*v_args),
                   lambda: ck.viterbi_values_plain(*v_args),
                   float(max((v - pv).abs().max(), (dm - pdm).abs().max())),
                   shape, valid)
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
        del v, pv, dm, pdm, path, got_bt, want_bt, bt_args, bt_plain

        # K8c and its chase: pointers, last rows, normalizers and paths
        # bit-equal to plain, and the paths dp.viterbi's
        ptrs = ck.viterbi_pointers(*v_args)
        assert all(torch.equal(a, b) for a, b in
                   zip(ptrs, ck.viterbi_pointers_plain(*v_args))), \
            f"viterbi_pointers disagrees with its plain version at {config}"
        c_args = (ptrs[0], ptrs[1], lens)
        chased = ck.pointer_chase(*c_args)
        assert torch.equal(chased, ck.pointer_chase_plain(*c_args)), \
            f"pointer_chase disagrees with its plain version at {config}"
        assert torch.equal(chased, want_p), \
            f"the chased path != dp.viterbi at {config}"
        _scan_rows(out, "viterbi_ptrs", suffix, S_, ptrs,
                   lambda: ck.viterbi_pointers(*v_args),
                   lambda: ck.viterbi_pointers_plain(*v_args), 0.0, shape,
                   valid)
        out["pointer_chase" + suffix] = dict(
            max_abs_err=0.0,
            ms=_median_ms(lambda: ck.pointer_chase(*c_args), 5),
            plain_ms=_median_ms(lambda: ck.pointer_chase_plain(*c_args), 3),
            **_bound("pointer_chase", shape, B * L))
        del ptrs, chased, c_args, want_p

        # K7a/K8a and K7b/K8b: log values within SCAN_ATOL + SCAN_OBS_ULPS
        # ulps of the largest |obs| of the plain version carried in
        # float64, log_c and log_d within SCAN_CUM_RTOL, logliks within
        # 1e-6 relative; repeats bit-identical
        lim = SCAN_ATOL + SCAN_OBS_ULPS * F32_EPS * float(obs.abs().max())
        s_args = (p.log_start, p.log_trans, obs, lens)
        fwd = ck.forward_scaled(*s_args)
        assert all(torch.equal(a, b) for a, b in
                   zip(fwd, ck.forward_scaled(*s_args))), \
            f"two forward_scaled launches differ at {config}"
        ref = [_ref64(x) for x in ck.forward_scaled_plain(*s_args,
                                                          dtype=f64)]
        err_fs = _assert_close(f"forward_scaled alpha_hat {config}", fwd[0],
                               ref[0], 0.0, lim)
        _assert_close(f"forward_scaled log_c {config}", fwd[1], ref[1],
                      SCAN_CUM_RTOL, 1e-4)
        _assert_close(f"forward_scaled loglik {config}", fwd[2], ref[2],
                      1e-6, 0.0)
        del ref
        f32_fs = float((fwd[0] - ck.forward_scaled_plain(*s_args)[0])
                       .abs().max())
        _scan_rows(out, "fwd_scaled", suffix, S_, fwd,
                   lambda: ck.forward_scaled(*s_args),
                   lambda: ck.forward_scaled_plain(*s_args), err_fs,
                   shape, valid)
        del fwd
        bwd = ck.backward_scaled(*s_args[1:])
        assert all(torch.equal(a, b) for a, b in
                   zip(bwd, ck.backward_scaled(*s_args[1:]))), \
            f"two backward_scaled launches differ at {config}"
        ref = [_ref64(x) for x in ck.backward_scaled_plain(*s_args[1:],
                                                           dtype=f64)]
        err_bs = _assert_close(f"backward_scaled beta_hat {config}", bwd[0],
                               ref[0], 0.0, lim)
        _assert_close(f"backward_scaled log_d {config}", bwd[1], ref[1],
                      SCAN_CUM_RTOL, 1e-4)
        del ref
        f32_bs = float((bwd[0] - ck.backward_scaled_plain(*s_args[1:])[0])
                       .abs().max())
        _scan_rows(out, "bwd_scaled", suffix, S_, bwd,
                   lambda: ck.backward_scaled(*s_args[1:]),
                   lambda: ck.backward_scaled_plain(*s_args[1:]), err_bs,
                   shape, valid)
        del bwd, s_args
        print(f"[streaming] K7/K8 at {config}: pointers, last rows, "
              f"normalizers and chased paths bit-equal to plain and paths "
              f"== dp.viterbi; alpha_hat / beta_hat within {lim:.3g} of "
              f"plain in float64 ({err_fs:.3g}, {err_bs:.3g}; of plain in "
              f"float32 {f32_fs:.3g}, {f32_bs:.3g}), repeat launches "
              f"bit-identical" + (
                  "; the cluster tile's outputs bit for bit the staged "
                  "tile's (forced)" if ck.scan_route(S_) == "cluster"
                  else f"; the {ck.log_scan_route(S_)} kernels' outputs bit "
                  f"for bit the block tile's (forced)"), flush=True)

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
        _scan_rows(out, "fwd_prob", suffix, S_, (alpha, dm),
                   lambda: ck.forward_prob(*f_args),
                   lambda: ck.forward_prob_plain(*f_args), err_f, shape,
                   valid)
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
        _scan_rows(out, "bwd_prob", suffix, S_, (beta,),
                   lambda: (ck.backward_prob(*b_args),),
                   lambda: ck.backward_prob_plain(*b_args), err_b, shape,
                   valid)
        del beta, obs_p, o_m
        print(f"[streaming] K5/K6 at {config} (S={S_} B={B} L={L}, ragged): "
              f"K5 rows, normalizers, backtrace and paths bit-equal (score "
              f"rel err {rel:.3g}); K6 within 2e-6 of plain in float64 "
              f"(alpha_p {err_f:.3g}, beta_p {err_b:.3g}; of plain in "
              f"float32 {f32_f:.3g}, {f32_b:.3g}; row loglik abs err "
              f"{ll_rel:.3g}), repeat launches bit-identical" + (
                  "; K5's, K8c's and K6's outputs on the cluster tile bit "
                  "for bit the staged tile's (forced)"
                  if ck.scan_route(S_) == "cluster"
                  else f"; K5's, K8c's and K6's {ck.log_scan_route(S_)} "
                  f"kernels' outputs bit for bit the block tile's (forced)"),
              flush=True)
        torch.cuda.empty_cache()
    for name, r in out.items():
        staged = f"  staged {r['staged_ms']:9.3f} ms" \
            if "staged_ms" in r else ""
        if "tile_ms" in r:
            staged = f"  block tile {r['tile_ms']:9.3f} ms"
        print(f"[streaming] {name:22s} max_abs_err {r['max_abs_err']:.3g}  "
              f"kernel {r['ms']:9.3f} ms{staged}  plain "
              f"{r['plain_ms']:9.3f} ms  bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']})", flush=True)
    return out


def phase_k6_fit_shape(device, seed) -> dict:
    """K6a and K6b at 3f's train shape: one row of ENV_FIT_REGION
    positions at ENV_STATES states (``bench_engines``' model and symbols
    of that width).  The cluster tile's outputs bit for bit the staged
    tile's (forced), within 2e-6 (dm 1e-5) of plain carried in float64;
    the cluster tile timed as phase 2 times it, the staged tile and the
    plain version once each (a launch of either takes seconds here).
    Rows ``name@K6_FIT``."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp
    from tehmm_tpu_torch.tools import bench_engines
    from tehmm_tpu_torch.tools.time_scans import staged_tile

    S_, T_, V_, _B, _L = bench_engines.CONFIGS[f"S{ENV_STATES}"]
    L = ENV_FIT_REGION
    p, sym = bench_engines.make_inputs(S_, T_, V_, 1, L, device, seed)
    obs_p, _o_m = dp.scaled_obs_prob(track_log_likelihoods(p.log_em, sym))
    del sym
    lens = torch.full((1,), L, dtype=torch.int32, device=device)
    shape = (1, L, S_, T_, V_)
    args = {"fwd_prob": (p.log_start, p.log_trans, obs_p, lens),
            "bwd_prob": (p.log_trans, obs_p, lens)}
    calls = {"fwd_prob": (ck.forward_prob, ck.forward_prob_plain),
             "bwd_prob": (lambda *a: (ck.backward_prob(*a),),
                          lambda *a, **k: (ck.backward_prob_plain(*a, **k),))}
    out = {}
    for name, (kernel, plain) in calls.items():
        a = args[name]
        got = kernel(*a)
        ms = _median_ms(lambda: kernel(*a), 5)
        with staged_tile():
            staged_ms = _median_ms(lambda: kernel(*a), 1)
            staged = kernel(*a)
        assert all(torch.equal(g, w) for g, w in zip(got, staged)), \
            f"{name}: the cluster tile != the staged tile at {shape}"
        del staged
        ref = plain(*a, dtype=torch.float64)
        err = max(_assert_close(f"{name} at 3f's train shape", g, r, 0.0,
                                2e-6 if i == 0 else 1e-5)
                  for i, (g, r) in enumerate(zip(got, ref)))
        del ref, got
        plain_ms = _median_ms(lambda: plain(*a), 1)
        out[f"{CLUSTER_OF[name]}@{K6_FIT}"] = dict(
            max_abs_err=err, ms=ms, staged_ms=staged_ms, plain_ms=plain_ms,
            **_bound(CLUSTER_OF[name], shape, L))
        out[f"{name}@{K6_FIT}"] = dict(
            max_abs_err=err, ms=staged_ms, plain_ms=plain_ms,
            **_bound(name, shape, L))
        print(f"[k6 fit] {name} at 3f's train shape (S={S_}, 1 x {L}): "
              f"the cluster tile {ms:.3f} ms ({ms * 1e3 / L:.3f} us a "
              f"step), the staged tile forced {staged_ms:.3f} ms, bit for "
              f"bit; within {err:.3g} of plain in float64 (plain "
              f"{plain_ms:.3f} ms)", flush=True)
    torch.cuda.empty_cache()
    return out


# the value-row backtrace's shapes on 3f's Viterbi paths at ENV_STATES:
# the stitched decode's passes (scaled_rows(512, S) chunks of 4,096 and
# two halos of 256) and the exact decode's one group (ENV_TABLES chunks
# of ENV_TABLE_LEN - 1): (name suffix, rows, value rows a row)
BT_3F_SHAPES = (("3f_stitched", 128, 4607), ("3f_exact", ENV_TABLES,
                                               ENV_TABLE_LEN - 1))
BT_3F_PATHS = {"3f_stitched": "viterbi", "3f_exact": "exact"}


def phase_backtrace_3f_shapes(device, seed) -> dict:
    """The value-row backtrace at 3f's two shapes (BT_3F_SHAPES), on K5's
    rows of full-length regions of 3f's sticky model with random symbols,
    as ``dp.viterbi_streaming`` passes them: paths and entry states bit
    for bit the plain version's; the kernel timed as phase 2 times it,
    the plain version once (its steps are a few small launches each).
    Rows ``viterbi_backtrace@<suffix>``."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.models.params import from_numpy
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    out = {}
    rng = np.random.RandomState(seed + 5)
    T_, V_ = T, 9
    p = from_numpy(*_sticky_model(rng, ENV_STATES, T_, V_), device)
    for suffix, B, Lb in BT_3F_SHAPES:
        L = Lb + 1
        sym = torch.from_numpy(rng.randint(0, V_, size=(B, L, T_))
                               .astype(np.int32)).to(device)
        obs = track_log_likelihoods(p.log_em, sym)
        del sym
        lens = torch.full((B,), L, dtype=torch.int32, device=device)
        v, _dm = ck.viterbi_values(p.log_start, p.log_trans, obs, lens)
        del obs, _dm
        end = torch.argmax(v[:, L - 1], dim=-1).to(torch.int32)
        args = (p.log_trans, v[:, 1:], v[:, 0], end, lens - 1)
        plain_args = (p.log_trans, v[:, 1:].contiguous(),
                      v[:, 0].contiguous(), end, lens - 1)
        got = ck.viterbi_backtrace(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ck.viterbi_backtrace_plain(*plain_args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            f"viterbi_backtrace disagrees with its plain version at {suffix}"
        ms = _median_ms(lambda: ck.viterbi_backtrace(*args), 5)
        out[f"viterbi_backtrace@{suffix}"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            **_bound("viterbi_backtrace", (B, Lb, ENV_STATES, T_, V_),
                     B * Lb))
        print(f"[backtrace 3f] {suffix} (S={ENV_STATES}, {B} x {Lb}): "
              f"paths and entry states bit-equal to plain; kernel "
              f"{ms:.3f} ms ({ms * 1e3 / Lb:.4f} us a step), plain "
              f"{plain_ms:.3f} ms, bound "
              f"{out[f'viterbi_backtrace@{suffix}']['bound_ms']:.4f} ms",
              flush=True)
        del v, got, want, args, plain_args
        torch.cuda.empty_cache()
    return out


def phase_maxplus(device) -> dict:
    """K9: ``maxplus_sweeps`` in both layouts (the blocks layout at each
    row-block size) against the plain version at Sp x MAXPLUS_BG on the
    JAX tool's draw (seed 0): bit-equal, every operation an exact max or
    one rounded add or subtract.  Times at every Sp; the Sp=256 results
    go under the kernels' names, the others under ``name@S<Sp>``; the
    blocks layout's row is its fastest row-block size."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools import exp_maxplus_s256 as tool

    out = {}
    for Sp in MAXPLUS_SP:
        v, t = tool.make_inputs(Sp, MAXPLUS_BG, device)
        want = ck.maxplus_sweeps_plain(v, t)
        plain_ms = _median_ms(lambda: ck.maxplus_sweeps_plain(v, t), 3)
        suffix = "" if Sp == MAXPLUS_SP[0] else f"@S{Sp}"
        times = {}
        for layout, blk in [("resident", None)] + [
                ("blocks", b) for b in MAXPLUS_BLKS]:
            got = ck.maxplus_sweeps(v, t, layout, blk)
            assert torch.equal(got, want), \
                f"maxplus_sweeps {layout} blk={blk} != plain at Sp={Sp}"
            assert torch.equal(got, ck.maxplus_sweeps(v, t, layout, blk))
            times[layout, blk] = _median_ms(
                lambda: ck.maxplus_sweeps(v, t, layout, blk), 20)
        bound = _bound("maxplus_blocks", (MAXPLUS_BG, ck.MAXPLUS_SWEEPS, Sp,
                                          0, 0), 0)
        best = min(MAXPLUS_BLKS, key=lambda b: times["blocks", b])
        out["maxplus_resident" + suffix] = dict(
            max_abs_err=0.0, ms=times["resident", None], plain_ms=plain_ms,
            **bound)
        out["maxplus_blocks" + suffix] = dict(
            max_abs_err=0.0, ms=times["blocks", best], blk=best,
            plain_ms=plain_ms,
            **{f"ms_blk{b}": times["blocks", b] for b in MAXPLUS_BLKS},
            **bound)
        print(f"[maxplus] K9 at Sp={Sp} Bg={MAXPLUS_BG}, "
              f"{ck.MAXPLUS_SWEEPS} sweeps: both layouts bit-equal to plain; "
              f"resident {times['resident', None]:.3f} ms, blocks " +
              ", ".join(f"blk={b} {times['blocks', b]:.3f} ms"
                        for b in MAXPLUS_BLKS) +
              f"; plain {plain_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})", flush=True)
        del v, t, want
    return out


def phase_maxplus_tool() -> dict:
    """2m: the K9 tool through its entry point at each Sp of phase 2 (its
    own rows: every formulation ok with max|delta| 0).  Returns {Sp:
    launch counts of that run}."""
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools import exp_maxplus_s256 as tool

    launches = {}
    for Sp in MAXPLUS_SP:
        ck.reset_launch_counts()
        text = _run_cli(tool, ["--device", "cuda", "--sp", str(Sp),
                               "--bg", str(MAXPLUS_BG)])
        launches[Sp] = dict(ck.LAUNCHES)
        for line in text.splitlines():
            print(f"[maxplus] tool {line}", flush=True)
        rows = [line for line in text.splitlines()
                if not line.startswith("#")]
        assert len(rows) == 1 + len(MAXPLUS_BLKS) and all(
            " ok " in r and "max|delta| 0.00e+00" in r for r in rows), rows
    return launches


def phase_wide_sweeps(device, rng) -> dict:
    """The carried sweeps past their one-warp kernels (``ck.sweep_fits``
    is False from 240 states): K3 (``viterbi_chunk_values``,
    ``viterbi_carry``), X1 and X2 on the scan tile's carry modes at
    WIDE_SWEEP_STATES, on obs of X_B rows of X_L (ragged: full, 0, 1,
    random) of a sticky random model at T, V.  K3 bit-equal to plain; X1
    and X2 against plain in float64 at the F3 limit; X1's two modes end
    in one carry; each sweep cut at SWEEP_CUTS gives the bits of one
    chunk; to 256 states K3's, X1's and X2's every output (both of K3's
    and X1's modes) bit for bit the block tile's, forced, past 256 the
    staged tile's.  Results under ``name@S<S>``."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.models.params import from_numpy
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp
    from tehmm_tpu_torch.tools.time_scans import block_tile, staged_tile

    out = {}
    f64 = torch.float64
    for S_ in WIDE_SWEEP_STATES:
        assert not ck.sweep_fits(S_)
        p = from_numpy(*_sticky_model(rng, S_, T, V), device)
        lengths = np.asarray([X_L, 0, 1, rng.randint(2, X_L)], np.int32)
        sym = torch.from_numpy(
            rng.randint(0, V, size=(X_B, X_L, T)).astype(np.int32)
        ).to(device)
        obs = track_log_likelihoods(p.log_em, sym)
        lens = torch.from_numpy(lengths).to(device)
        init = torch.from_numpy(
            rng.randn(X_B, S_).astype(np.float32)).to(device)
        init = init - init.amax(dim=-1, keepdim=True)
        cont = torch.tensor([True, False, False, False], device=device)
        lt = p.log_trans
        lim = SCAN_ATOL + SCAN_OBS_ULPS * F32_EPS * float(obs.abs().max())
        suffix = f"@S{S_}"
        # K3: bit-equal, chunked == one chunk
        v = ck.viterbi_chunk_values(lt, obs, init, lens)
        assert torch.equal(v, dp.viterbi_chunk_values(lt, obs, init, lens))
        carry = ck.viterbi_carry(lt, obs, init, lens)
        assert torch.equal(carry, v[:, -1])
        # X1, X2 against plain in float64
        hats, a_carry = ck.forward_chunk_values(lt, obs, init, lens)
        final, dm_sum = ck.forward_final(lt, obs, init, lens)
        assert torch.equal(final, a_carry), "X1's two modes end apart"
        beta, x_out = ck.backward_chunk_values(lt, obs, init, cont, lens)
        ref = [_ref64(x) for x in
               dp.forward_chunk_values(lt, obs, init, lens, dtype=f64)
               + dp.backward_chunk_values(lt, obs, init, cont, lens,
                                          dtype=f64)]
        names = ("X1 hats", "X1 carry", "X2 beta", "X2 x_out")
        err = {n: _assert_close(f"{n} S={S_}", g, w, 0.0, lim)
               for n, g, w in zip(names, (hats, a_carry, beta, x_out), ref)}
        ratio = {n: _limit_ratio(g, w, 0.0, lim)
                 for n, g, w in zip(names, (hats, a_carry, beta, x_out),
                                    ref)}
        del ref
        # a sweep cut into chunks: the bits of one chunk
        v_c, a_c, x_c, c_c = init, init, init, cont
        for lo, hi in zip(SWEEP_CUTS[:-1], SWEEP_CUTS[1:]):
            o = obs[:, lo:hi].contiguous()
            pl = torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)
            assert torch.equal(ck.viterbi_chunk_values(lt, o, v_c, pl),
                               v[:, lo:hi]), f"K3 chunked S={S_}"
            v_c = ck.viterbi_carry(lt, o, v_c, pl)
            h, a_c = ck.forward_chunk_values(lt, o, a_c, pl)
            assert torch.equal(h, hats[:, lo:hi]), f"X1 chunked S={S_}"
        assert torch.equal(v_c, carry) and torch.equal(a_c, a_carry)
        for lo, hi in reversed(list(zip(SWEEP_CUTS[:-1], SWEEP_CUTS[1:]))):
            o = obs[:, lo:hi].contiguous()
            pl = torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)
            b, x_c = ck.backward_chunk_values(lt, o, x_c, c_c, pl)
            assert torch.equal(b, beta[:, lo:hi]), f"X2 chunked S={S_}"
            c_c = lens > lo
        assert torch.equal(x_c, x_out)
        valid = int(lengths.sum())
        shape = (X_B, X_L, S_, T, V)
        # K3's carry mode, X1's modes and X2's on the cluster tile: the
        # staged tile's bits (the carry-only modes' here; the values
        # modes' in _scan_rows)
        if ck.scan_route(S_) == "cluster":
            with staged_tile():
                assert torch.equal(carry, ck.viterbi_carry(lt, obs, init,
                                                           lens)), \
                    f"K3 carry-only: the cluster tile != staged S={S_}"
                assert all(torch.equal(a, b) for a, b in zip(
                    (final, dm_sum), ck.forward_final(lt, obs, init, lens))
                ), f"X1 carry-only: the cluster tile != staged S={S_}"
        elif ck.log_scan_route(S_) == "rows":
            with block_tile():
                assert torch.equal(carry, ck.viterbi_carry(lt, obs, init,
                                                           lens)), \
                    f"K3 carry-only: the rows kernel != the block tile " \
                    f"S={S_}"
                assert all(torch.equal(a, b) for a, b in zip(
                    (final, dm_sum), ck.forward_final(lt, obs, init, lens))
                ), f"X1 carry-only: the rows kernel != the block tile " \
                   f"S={S_}"
        _scan_rows(out, "viterbi_chunk_tile", suffix, S_, (v,),
                   lambda: (ck.viterbi_chunk_values(lt, obs, init, lens),),
                   lambda: dp.viterbi_chunk_values(lt, obs, init, lens),
                   0.0, shape, valid)
        _scan_rows(out, "fwd_chunk_tile", suffix, S_, (hats, a_carry),
                   lambda: ck.forward_chunk_values(lt, obs, init, lens),
                   lambda: dp.forward_chunk_values(lt, obs, init, lens),
                   max(err["X1 hats"], err["X1 carry"]), shape, valid)
        _scan_rows(out, "bwd_chunk_tile", suffix, S_, (beta, x_out),
                   lambda: ck.backward_chunk_values(lt, obs, init, cont,
                                                    lens),
                   lambda: dp.backward_chunk_values(lt, obs, init, cont,
                                                    lens),
                   max(err["X2 beta"], err["X2 x_out"]), shape, valid)
        print(f"[sweeps] K3/X1/X2 on the tile at S={S_}, {X_B} rows of "
              f"{X_L} (ragged): K3 bit-equal to plain; X1/X2 within {lim:.3g}"
              f" of plain in float64 [worst error/limit]: " + ", ".join(
                  f"{n} {err[n]:.3g} [{ratio[n]:.3f}]" for n in names)
              + f"; X1's two modes one carry; cut at {SWEEP_CUTS[1:-1]} "
              f"== one chunk, bit for bit; " + (
                  "K3's, X1's and X2's every output on the cluster tile bit "
                  "for bit the staged tile's (forced)"
                  if ck.scan_route(S_) == "cluster" else
                  "K3's, X1's and X2's every output on the rows kernels bit "
                  "for bit the block tile's (forced)"), flush=True)
        for name in ("viterbi_chunk_tile", "fwd_chunk_tile",
                     "bwd_chunk_tile", "viterbi_chunk_cluster",
                     "fwd_chunk_cluster", "bwd_chunk_cluster",
                     "viterbi_chunk_rows", "fwd_chunk_rows",
                     "bwd_chunk_rows"):
            if name + suffix not in out:
                continue
            r = out[name + suffix]
            staged = f"  staged {r['staged_ms']:9.3f} ms" \
                if "staged_ms" in r else ""
            if "tile_ms" in r:
                staged = f"  block tile {r['tile_ms']:9.3f} ms"
            print(f"[sweeps] {name + suffix:26s} kernel {r['ms']:9.3f} ms "
                  f"{staged} plain {r['plain_ms']:9.3f} ms  bound "
                  f"{r['bound_ms']:.3f} ms ({r['bound_by']}); us a step "
                  f"{r['ms'] * 1e3 / X_L:.2f}", flush=True)
        del p, sym, obs, v, hats, beta
        torch.cuda.empty_cache()
    return out


def _engine_kernels(config):
    """The kernels 2e must launch at ``config``: the streaming ones and
    the backtrace, each scan under the counter of its route at the
    config's S (``ck.scan_counter``: K5, K6a/K6b, K7a/K7b and K8c on the
    cluster tile past 256 states, K7a/K7b and K6a/K6b on the lanes step
    or the rows kernels to 256)."""
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools import bench_engines

    S_ = bench_engines.CONFIGS[config][0]
    return tuple(ck.scan_counter(k, S_) if k in CLUSTER_OF else k
                 for k in STREAMING_KERNELS + ("viterbi_backtrace",))


def _tool_rows(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def phase_engines(seed) -> dict:
    """2e: the engine-comparison path through its tools, at full width.
    Returns {config: launch counts of that config's three tool runs}."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools import bench_engines, profile_estep

    launches = {}
    t_phase = time.perf_counter()
    for config in ENGINE_CONFIGS + WIDE_CONFIGS:
        counts = {}
        lists = WIDE_ENGINES if config in WIDE_CONFIGS else (
            "plain,cuda,cuda_v3,cuda_log", "plain,streaming,fused,pointers",
            "plain,fused,scans")
        for mode, engines, needed in zip(
                ((), ("--decode",), ("--maxpost",)), lists,
                (("cuda_v3", "cuda_log"), ("streaming", "pointers"),
                 ("scans",))):
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
            assert all(e in ran for e in needed + ("plain",)), \
                (config, list(ran))
            if mode == ("--decode",):
                bad = {e: r["path_agreement"] for e, r in ran.items()
                       if r["path_agreement"] != 1.0}
                assert not bad, f"{config}: decode paths differ: {bad}"
            elif mode:
                # max-posterior paths: argmax near-ties of two float32
                # posteriors may differ (as K4's against plain)
                agree = {e: r["path_agreement"] for e, r in ran.items()}
                assert min(agree.values()) >= 0.99999, \
                    f"{config}: max-posterior paths differ: {agree}"
            else:
                lls = [r["loglik"] for r in ran.values()]
                assert np.isfinite(lls).all(), lls
                rel = max(abs(a - b) / abs(a) for a in lls for b in lls)
                assert rel <= 1e-4, \
                    f"{config}: E-step logliks differ by {rel} relative"
            torch.cuda.empty_cache()
        launches[config] = counts
    for engine, kernels in (("cuda_v3", ("fwd_prob_rows", "bwd_prob_rows")),
                            ("cuda_log", ("fwd_scaled_rows",
                                          "bwd_scaled_rows"))):
        ck.reset_launch_counts()
        text = _run_cli(profile_estep, [
            "S64", "--iters", str(ENGINE_ITERS), "--seed", str(seed),
            "--engine", engine])
        for line in text.splitlines():
            print(f"[engines] profile_estep {line}", flush=True)
        (stages,) = _tool_rows(text)
        keys = ("obs_ms", "fwd_ms", "bwd_ms", "epilogue_ms", "sum_ms") \
            + (("obs_p_ms",) if engine == "cuda_v3" else ())
        assert all(stages[k] > 0 for k in keys), stages
        assert all(ck.LAUNCHES[k] for k in kernels), (engine, ck.LAUNCHES)
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
        self.first_call: dict[str, tuple] = {}
        self.launched: dict[str, dict] = {}
        self._undo = []

    def wrap(self, owner, attr, stage, sync=False, keep=False,
             keep_first_call=False, count=False):
        """``sync``: end the span with torch.cuda.synchronize(), so a
        call that only queues work on the card is charged its work.
        ``keep``: hold the last result in ``self.last`` (only for stages
        read afterwards, so the spans hold no other tensor alive);
        ``keep_first_call``: hold the first call's arguments in
        ``self.first_call``.  ``count``: sum each call's kernel launches
        (``ck.LAUNCHES`` after less before) in ``self.launched``."""
        from tehmm_tpu_torch.ops import cuda_kernels as ck

        fn = getattr(owner, attr)
        original = vars(owner)[attr]      # e.g. the classmethod itself

        def timed(*args, **kwargs):
            if keep_first_call:
                self.first_call.setdefault(stage, (args, kwargs))
            before = dict(ck.LAUNCHES)
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
            if count:
                n = self.launched.setdefault(stage, dict.fromkeys(before, 0))
                for k in n:
                    n[k] += ck.LAUNCHES[k] - before[k]
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


# the exact decoders' kernels in the order they run, with their stages
EXACT_SPANS = (("viterbi_checkpoints", "forward sweep"),
               ("viterbi_chunk_pointers", "recompute (pointers)"),
               ("chunk_entry_map", "map"), ("chunk_compose", "compose"),
               ("chunk_chase", "chase"))
POST_EXACT_SPANS = (("forward_checkpoints", "forward sweep"),
                    ("forward_chunk_values", "recompute"),
                    ("backward_checkpoints", "backward sweep"),
                    ("backward_chunk_values", "beta recompute"))


# the stitched decodes' stages (a pass: chunk forming, H2D, the kernels,
# D2H), each span ending synchronised; "stitch and the rest" is the
# decode's total less them.  The kernels' (ck wrapper, stage) by decode:
# max-posterior, K1's forward and K4's decode; Viterbi, K2's forward in
# pointer mode and the chase
STITCH_KERNELS = {
    "post": (("em_fwd", "em_fwd"), ("post_decode", "decode")),
    "e2e": (("viterbi_fwd_pointers", "K2 forward"), ("chunk_chase", "chase")),
    # the Viterbi decode as the parent ran it (``_viterbi_fused_as_parent``)
    "e2e parent": (("viterbi_fwd", "K2 forward"),
                   ("viterbi_backtrace", "backtrace")),
}


def _viterbi_fused_as_parent(log_start, log_trans, log_em, symbols,
                             lengths, obs_weights=None, gauss_params=None,
                             gauss_values=None):
    """``ck.viterbi_fused`` as it was before its pointer mode: K2's value
    rows (``ck.viterbi_fwd``), then the value-row backtrace
    (``ck.viterbi_backtrace``) from the last row's first-hit argmax over
    positions L-1..1, position 0's state its entry state; the same paths
    and score."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck

    L = symbols.shape[1]
    v_hats, dm = ck.viterbi_fwd(log_start, log_trans, log_em, symbols,
                                lengths, obs_weights, gauss_params,
                                gauss_values)
    last = v_hats[:, L - 1]
    end_state = torch.argmax(last, dim=-1).to(torch.int32)
    body, first = ck.viterbi_backtrace(
        log_trans, v_hats[:, 1:], v_hats[:, 0], end_state,
        torch.clamp(lengths - 1, min=0).to(torch.int32))
    path = torch.cat([first[:, None], body], dim=1)
    nonempty = lengths > 0
    score = torch.where(nonempty, last.amax(dim=-1) + dm.sum(dim=1), 0.0)
    return torch.where(nonempty[:, None], path, 0), score


def _stitch_stages(decode):
    return (("chunk forming", "H2D")
            + tuple(stage for _, stage in STITCH_KERNELS[decode]) + ("D2H",))


def _stitched_split(decode="post"):
    """Spans around a stitched decode's calls into each stage
    (``_stitch_stages``), counting the kernels' launches."""
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.parallel import stitch

    stages = _Stages()
    stages.decode = decode
    stages.wrap(stitch, "batch_chunks", "chunk forming")
    stages.wrap(stitch, "_to_device", "H2D", sync=True)
    stages.wrap(stitch, "_f32_to_device", "H2D", sync=True)
    for attr, stage in STITCH_KERNELS[decode]:
        stages.wrap(ck, attr, stage, sync=True, count=True)
    stages.wrap(stitch, "_to_host", "D2H")
    return stages


def _print_stitched_split(label, stages, total):
    """Print one stitched decode's split (tagged by its decode); returns
    each kernel stage's launches (the kernels that ran, by stage)."""
    names = _stitch_stages(stages.decode)
    sec = stages.seconds
    rest = total - sum(sec.get(k, 0.0) for k in names)
    ran = {stage: {k: v for k, v in stages.launched.get(stage, {}).items()
                   if v}
           for _, stage in STITCH_KERNELS[stages.decode]}
    print(f"[{stages.decode.split()[0]}] stitched decode split, {label} "
          f"(s): total "
          f"{total:.4f}, "
          + ", ".join(f"{k} {sec.get(k, 0.0):.4f} "
                      f"({stages.calls.get(k, 0)} calls)" for k in names)
          + f", stitch and the rest {rest:.4f}; launches {ran}",
          flush=True)
    return ran


def _split_stages(total, spans):
    """Spans around an exact decoder's calls, each ending synchronised:
    the decode as a whole (eval's ``total``, with its launches), obs
    formation (``stitch._span_obs``), and each (``ck`` wrapper, stage)
    of ``spans``."""
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.parallel import stitch

    stages = _Stages()
    stages.wrap(port_eval, total, "total", sync=True, count=True)
    stages.wrap(stitch, "_span_obs", "obs formation", sync=True)
    for attr, stage in spans:
        stages.wrap(ck, attr, stage, sync=True)
    return stages


def _chunks_and_groups(region, S_, tensors=2):
    """The chunks of eval's 4096 over one region's body, and the groups
    the exact decoders cut them into (``stitch.exact_group_chunks`` with
    ``tensors`` a chunk: the exact Viterbi's two, the exact posteriors'
    ``stitch.POSTERIOR_GROUP_TENSORS``): fewer groups than chunks."""
    from tehmm_tpu_torch.parallel import stitch

    n_chunks = -(-(region - 1) // EXACT_CHUNK)
    groups = -(-n_chunks // stitch.exact_group_chunks(1, EXACT_CHUNK, S_,
                                                       tensors))
    assert groups < n_chunks, (groups, n_chunks)
    return n_chunks, groups


def _print_split(stages, label, spans, rest, region, S_, tensors=2):
    """Print an exact decode's split (``rest``: the total less the
    stages) and its launches; returns (launches, chunks, groups)."""
    n_chunks, groups = _chunks_and_groups(region, S_, tensors)
    sec = stages.seconds
    parts = ("obs formation",) + tuple(stage for _, stage in spans)
    left = sec["total"] - sum(sec.get(k, 0.0) for k in parts)
    print(f"{label} split (s): " + ", ".join(
        f"{k} {sec.get(k, 0.0):.4f} ({stages.calls.get(k, 0)} calls)"
        for k in ("total",) + parts) + f", {rest} {left:.4f}", flush=True)
    n = stages.launched["total"]
    print(f"{label} launches: "
          f"{ {k: v for k, v in n.items() if v} }; {n_chunks} chunks in "
          f"{groups} group(s)", flush=True)
    return n, n_chunks, groups


def _exact_split(stages, region, S_):
    """Print the exact decode's split and hold its launches: below 240
    states K3 twice a group (the checkpoint sweep and the pointer
    recompute) and X3's map, compose and chase once a group each, a
    fixed number a group whatever the chunks; no value rows and no
    backtrace a chunk."""
    n, n_chunks, groups = _print_split(stages, "[e2e] --exact", EXACT_SPANS,
                                       "rest", region, S_)
    a_group = ("viterbi_checkpoints", "viterbi_chunk_pointers") + X3_KERNELS
    ran = {k: n[k] for k in a_group}
    assert all(v == groups for v in ran.values()), \
        f"the exact decode launched {ran}, not once each a group ({groups})"
    assert n["viterbi_backtrace"] == 0 and n["viterbi_chunk_values"] == 0, \
        f"the exact decode launched the value-row backtrace: {n}"
    print(f"[e2e] --exact: {len(a_group)} launches a group, "
          f"{len(a_group) * groups} for {n_chunks} chunks", flush=True)


def _x1_groups(launched, region, S_, what):
    """Hold one exact posterior sweep's launches: X1 twice a group (the
    checkpoint sweep and the recompute), X2 twice a group (the backward
    sweep and the beta recompute) and once for position 0, no piece
    kernel."""
    from tehmm_tpu_torch.parallel import stitch

    _, groups = _chunks_and_groups(region, S_,
                                   stitch.POSTERIOR_GROUP_TENSORS)
    x1 = (launched["fwd_checkpoints"], launched["fwd_chunk"])
    assert x1 == (groups, groups), \
        f"{what}: X1 launched {x1[0]} + {x1[1]} times, not twice a group " \
        f"({groups})"
    x2 = (launched["bwd_checkpoints"], launched["bwd_chunk"])
    assert x2 == (groups, groups + 1), \
        f"{what}: X2 launched {x2[0]} + {x2[1]} times, not twice a group " \
        f"({groups}) and once for position 0"
    assert not (launched["fwd_piece_ops"] or launched["fwd_piece_compose"]
                or launched["fwd_chunk_tile"]), f"{what} launched {launched}"


# the parent checkout's build, started in the background at start-up
# (``_start_parent_build``) and waited for before its first CLI run, and
# its CLI runs in the background (``jobs``)
_PARENT_BUILD: dict = {}


def _parent_env(parent):
    return dict(os.environ, PYTHONPATH=os.path.abspath(parent))


def _start_parent_build(parent):
    """Build the parent checkout's kernels and native helpers in a process
    of its own, beside phase 2 (into that checkout, as its CLIs would at
    first use)."""
    code = ("from tehmm_tpu_torch import native\n"
            "from tehmm_tpu_torch.ops import cuda_kernels as ck\n"
            "native.available()\n"
            "ck.load_library()\n")
    log = open(os.path.join(parent, "parent_build.log"), "w")
    _PARENT_BUILD.update(
        proc=subprocess.Popen([sys.executable, "-c", code], cwd=parent,
                              env=_parent_env(parent), stdout=log,
                              stderr=subprocess.STDOUT),
        log=log, t0=time.perf_counter())


def _wait_parent_build():
    """Wait for the background build (once); it must have succeeded."""
    proc = _PARENT_BUILD.get("proc")
    if proc is None or "rc" in _PARENT_BUILD:
        return
    t0 = time.perf_counter()
    _PARENT_BUILD["rc"] = proc.wait(timeout=900)
    _PARENT_BUILD["log"].close()
    print(f"[parent] build in the background: exit "
          f"{_PARENT_BUILD['rc']}, {t0 - _PARENT_BUILD['t0']:.1f} s before "
          f"its first use, waited {time.perf_counter() - t0:.1f} s",
          flush=True)
    assert _PARENT_BUILD["rc"] == 0, "the parent checkout's build failed"


def _stop_parent_processes():
    """End the background build and parent runs that still run (a failed
    run)."""
    for proc in [_PARENT_BUILD.get("proc")] + _PARENT_BUILD.get("jobs", []):
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()


def _parent_cli(parent, cli, argvs, wait=True, stderr=None):
    """Run ``tehmm_tpu_torch.cli.<cli>`` of the checkout at ``parent`` (an
    earlier commit of this repository, unpacked with ``git archive``) on
    each argv, in one process of its own, after its build; with ``wait``
    False return the process (its errors to ``stderr``), which
    ``_stop_parent_processes`` ends if the run fails first."""
    _wait_parent_build()
    code = ("import json, sys\n"
            f"from tehmm_tpu_torch.cli import {cli} as c\n"
            "for argv in json.loads(sys.argv[1]):\n"
            "    assert c.main(argv) == 0, argv\n")
    cmd = [sys.executable, "-c", code, json.dumps(argvs)]
    if not wait:
        proc = subprocess.Popen(cmd, cwd=parent, env=_parent_env(parent),
                                stdout=subprocess.DEVNULL, stderr=stderr)
        _PARENT_BUILD.setdefault("jobs", []).append(proc)
        return proc
    proc = subprocess.run(cmd, cwd=parent, env=_parent_env(parent),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]


class _ParentRuns:
    """``--parent``'s comparisons of eval outputs.  The phases queue
    their eval runs ((argv, output), ``add``); ``launch`` starts the
    parent's eval CLI on each queued batch, a background process a batch
    (each output path moved to a file of its own); ``finish`` launches
    what is queued, waits for every batch and holds each output to this
    checkout's byte for byte.  The caller launches between phases, so a
    batch overlaps only the phases after it, never a timed train run."""

    def __init__(self, parent, work):
        self.parent, self.work = parent, work
        self.queued, self.jobs = [], []

    def add(self, runs, tag):
        self.queued.append((list(runs), tag))

    def launch(self):
        if not self.queued:
            return
        _wait_parent_build()
        for runs, tag in self.queued:
            theirs = [os.path.join(self.work, f"parent_{tag}_{k}_"
                                              f"{os.path.basename(path)}")
                      for k, (_argv, path) in enumerate(runs)]
            argvs = [[o if a == path else a for a in argv]
                     for (argv, path), o in zip(runs, theirs)]
            err = tempfile.TemporaryFile()
            proc = _parent_cli(self.parent, "eval", argvs, wait=False,
                               stderr=err)
            self.jobs.append((runs, theirs, tag, proc, err,
                              time.perf_counter()))
        self.queued = []

    def finish(self):
        self.launch()
        for runs, theirs, tag, proc, err, t0 in self.jobs:
            rc = proc.wait(timeout=900)
            err.seek(0)
            assert rc == 0, err.read()[-4000:].decode(errors="replace")
            err.close()
            for (_argv, out), other in zip(runs, theirs):
                mine = open(out, "rb").read()
                other = open(other, "rb").read()
                assert mine == other, \
                    f"{os.path.basename(out)} differs from the parent's " \
                    f"({len(mine)} against {len(other)} bytes)"
                print(f"[{tag}] {os.path.basename(out)}: {len(mine)} bytes, "
                      f"byte-identical to the parent's ({self.parent})",
                      flush=True)
            print(f"[{tag}] the parent's {len(runs)} runs: done "
                  f"{time.perf_counter() - t0:.1f} s after their start",
                  flush=True)
        self.jobs = []


def _npz_members(path):
    """Each member's bytes of a saved model (the zip's own dates aside)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def _iteration_times(log):
    """An EM log's iteration times from its timestamps: the median
    spacing (one iteration's wall time: E-step, M-step and the loglik's
    read) and the largest, in ms, and the first to the last logged
    iteration, in ms with their count (a stall shows there)."""
    ts = [r["ts"] for r in _em_log(log)]
    gaps = np.diff(ts) * 1e3
    return (f"median {float(np.median(gaps)):.3f} ms, largest "
            f"{float(gaps.max()):.3f} ms, {len(gaps)} in "
            f"{(ts[-1] - ts[0]) * 1e3:.3f} ms")


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
    stages.wrap(MultitrackHmm, "decode_tables", "eval: decode", keep=True,
                keep_first_call=True)
    stages.wrap(port_eval, "path_log_score", "eval: path score")
    stages.wrap(port_eval, "write_bed_intervals", "eval: write")
    eval_argv = [xml, model, regions, "--bed", out_bed, "--device", device]
    split = None
    try:
        t0 = time.perf_counter()
        _run_cli(port_train, [xml, truth_bed, model, "--supervised",
                              "--device", device])
        t_train = time.perf_counter() - t0
        # the stitched decode split into its stages
        split = _stitched_split("e2e")
        t0 = time.perf_counter()
        score = _run_cli(port_eval, eval_argv)
        t_eval = time.perf_counter() - t0
    finally:
        if split is not None:
            split.restore()
        stages.restore()
    paths, report = stages.last["eval: decode"]
    assert report.boundaries_ok, report
    print(f"[e2e] eval printed path score {score}; {report}", flush=True)
    assert np.isfinite(float(score))
    # K2's forward (the lanes kernel's pointer mode) and the chase once a
    # pass of 512 rows each, more only for the retries' re-decodes
    ran = _print_stitched_split(
        "512 rows a pass, K2's lanes forward (pointers) and the chase",
        split, stages.seconds["eval: decode"])
    passes = -(-report.n_chunks // 512)
    fwd = ran["K2 forward"].get("viterbi_fwd_lanes", 0)
    assert set(ran["K2 forward"]) == {"viterbi_fwd_lanes"} and \
        ran["chase"] == {"chunk_chase": fwd} and (
            fwd == passes if report.retries == 0 else fwd > passes), \
        f"K2 launched {ran} for {report.n_chunks} chunks in passes of 512 " \
        f"({report.retries} retries)"

    names = MultitrackHmm.load(model, "cpu").state_names
    decoded = _paint(out_bed, n, names)
    name_idx = np.asarray([int(s[1:]) for s in names])
    acc = float((name_idx[decoded] == truth).mean())
    print(f"[e2e] base accuracy vs planted truth: {acc:.6f}", flush=True)
    assert acc >= 0.9, f"base accuracy {acc} < 0.9"

    # exact (K3 + X3) and stitched (K2) agree on a region
    lo = n // 4
    region_bed = os.path.join(work, "region.bed")
    with open(region_bed, "w") as fh:
        fh.write(f"chr1\t{lo}\t{lo + region}\n")
    beds, outs = {}, {}
    for flag in ("--exact", "--no-exact"):
        out = outs[flag] = os.path.join(work, f"region{flag}.bed")
        split = _split_stages("viterbi_exact", EXACT_SPANS) \
            if flag == "--exact" else None
        t0 = time.perf_counter()
        try:
            _run_cli(port_eval, [xml, model, region_bed, "--bed", out,
                                 "--device", device, flag])
        finally:
            if split is not None:
                split.restore()
        print(f"[e2e] {region}-position region {flag}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        beds[flag] = open(out).read()
        if split is not None:
            _exact_split(split, region,
                         MultitrackHmm.load(model, "cpu").num_states)
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
    # the chromosome's stitched run and the region's --exact run, for
    # 3d's comparison with a parent checkout
    exact_run = ([xml, model, region_bed, "--bed", outs["--exact"],
                  "--device", device, "--exact"], outs["--exact"])
    # the stitched decode as the parent ran it, for after the count of
    # this phase's launches
    return acc, float(score), [(eval_argv, out_bed), exact_run], \
        lambda: _viterbi_as_parent(stages, paths, report)


def _viterbi_as_parent(stages, paths, report):
    """Phase 3's stitched decode again, on the same tables, as the parent
    ran it (``_viterbi_fused_as_parent``: K2's shared forward forced,
    value rows, the value-row backtrace), split the same way: the same
    paths and report, and K2's forward and the backtrace once a pass."""
    import torch

    from tehmm_tpu_torch.models.hmm import MultitrackHmm
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.tools.time_k1 import shared_k2

    dec_args, dec_kw = stages.first_call.pop("eval: decode")
    split = _stitched_split("e2e parent")
    fused, ck.viterbi_fused = ck.viterbi_fused, _viterbi_fused_as_parent
    try:
        with shared_k2():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            old_paths, old_report = MultitrackHmm.decode_tables(*dec_args,
                                                               **dec_kw)
            torch.cuda.synchronize()
            t_old = time.perf_counter() - t0
    finally:
        ck.viterbi_fused = fused
        split.restore()
    del dec_args, dec_kw
    ran = _print_stitched_split("512 rows a pass, K2's shared forward "
                                "(forced) and the value-row backtrace, as "
                                "the parent ran it", split, t_old)
    passes = -(-report.n_chunks // 512)
    assert ran == {"K2 forward": {"viterbi_fwd": passes},
                   "backtrace": {"viterbi_backtrace": passes}} \
        or report.retries, ran
    assert old_report == report and all(
        np.array_equal(a, b) for a, b in zip(old_paths, paths)), \
        "the stitched decode's paths differ between the two routes"
    print(f"[e2e] {sum(len(p) for p in paths)}-position stitched decode: "
          f"the same paths and report through the pointers and the chase "
          f"and through the value rows and the backtrace", flush=True)


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
                        pd_region, device="cuda", parent=None,
                        parent_runs=()):
    """3d: max-posterior decoding, --pd and scoring through eval with
    phase 3's supervised model.  ``parent``: the run's ``_ParentRuns``,
    given the runs whose outputs a checkout of an earlier commit must
    write byte for byte: ``parent_runs`` ((argv, output) of earlier eval
    runs: phase 3's stitched BED and ``--exact`` BED) and this phase's
    stitched ``--maxPost`` BED, ``--maxPost --exact`` BEDs and ``--pd``
    file."""
    import torch

    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.models import hmm as port_hmm
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.parallel import stitch
    from tehmm_tpu_torch.tools.time_k1 import shared_k4

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
                sync=True, keep=True, keep_first_call=True)
    stages.wrap(port_eval, "posterior_exact", "decode (exact, X1/X2)",
                sync=True)
    stages.wrap(port_hmm.MultitrackHmm, "score", SCORE_STAGE, sync=True,
                keep_first_call=True, count=True)
    stages.wrap(port_eval, "write_bed_intervals", "write BED")
    stages.wrap(port_eval, "_write_pd_streaming", "--pd write", sync=True,
                count=True)

    same_as_parent = list(parent_runs)    # (argv, output) of each run

    def run(bed_path, *flags, dev=device):
        argv = [xml, model, bed_path, *flags, "--device", dev]
        t0 = time.perf_counter()
        printed = _run_cli(port_eval, argv)
        return float(printed), time.perf_counter() - t0

    try:
        # the whole chromosome: stitched (automatic past 256K positions),
        # its decode split into its stages
        split = _stitched_split()
        try:
            score, wall = run(regions, "--bed", out_bed, "--maxPost")
        finally:
            split.restore()
        same_as_parent.append(([xml, model, regions, "--bed", out_bed,
                                "--maxPost", "--device", device], out_bed))
        paths_20mb, report = stages.last["decode (stitched, K4)"]
        assert report.boundaries_ok, report
        rows = stitch.MAXPOST_ROWS_PER_PASS["fused"]
        k4 = _print_stitched_split(
            f"{rows} rows a pass, the lanes decode", split,
            stages.seconds["decode (stitched, K4)"])["decode"]
        # a launch of K1's forward and of K4's lanes decode a pass, more
        # only for the retries' re-decodes
        passes = -(-report.n_chunks // rows)
        ran = k4.get("post_decode_lanes", 0)
        assert set(k4) == {"post_decode_lanes"} and (
            ran == passes if report.retries == 0 else ran > passes), \
            f"K4 launched {k4} for {report.n_chunks} chunks in passes of " \
            f"{rows} ({report.retries} retries)"
        assert split.launched["em_fwd"]["em_fwd"] == ran
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
            split = _split_stages("posterior_exact", POST_EXACT_SPANS) \
                if flag == "--exact" else None
            if flag == "--exact":
                same_as_parent.append(([xml, model, region_bed, "--bed", out,
                                        "--maxPost", flag, "--device",
                                        device], out))
            try:
                _, wall = run(region_bed, "--bed", out, "--maxPost", flag)
            finally:
                if split is not None:
                    split.restore()
            paths[flag] = _paint_region(out, lo, region, names)
            print(f"[post] {region}-position region --maxPost {flag}: "
                  f"{wall:.3f} s", flush=True)
            if split is not None:
                exact_ran, _, _ = _print_split(
                    split, "[post] --maxPost --exact", POST_EXACT_SPANS,
                    "gamma and consume", region, len(names),
                    stitch.POSTERIOR_GROUP_TENSORS)
                _x1_groups(exact_ran, region, len(names),
                           "--maxPost --exact")
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
        same_as_parent += [
            ([xml, model, pd_bed, "--pd", pd_out, "--device", device],
             pd_out),
            ([xml, model, pd_bed, "--bed", exact_out, "--maxPost", "--exact",
              "--device", device], exact_out)]
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
    if parent is not None:
        parent.add(same_as_parent, "post")
    launches = dict(ck.LAUNCHES)          # the card's runs of this phase

    # the 20 Mb stitched decode again as the parent ran it, 64 rows a
    # pass with K4's shared decode forced (its launches are not the main
    # path's, so after the count above): its split, the same paths
    (dec_args, dec_kw) = stages.first_call["decode (stitched, K4)"]
    split = _stitched_split()
    try:
        with shared_k4():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            old_paths, old_report = port_hmm.posterior_chunked(
                *dec_args, **dict(dec_kw, rows_per_pass=64))
            torch.cuda.synchronize()
            t_old = time.perf_counter() - t0
    finally:
        split.restore()
    del dec_args, dec_kw
    k4_old = _print_stitched_split("64 rows a pass, the shared decode "
                                   "(forced), as the parent ran it",
                                   split, t_old)["decode"]
    assert k4_old == {"post_decode": -(-report.n_chunks // 64)} \
        or report.retries, k4_old
    assert old_report == report and all(
        np.array_equal(a, b) for a, b in zip(old_paths, paths_20mb)), \
        "the stitched decode's paths differ between the two passes"
    print(f"[post] {n}-position stitched decode: the same paths and "
          f"report at {rows} rows a pass (lanes) and at 64 (shared)",
          flush=True)
    del old_paths, paths_20mb
    # the score at S <= 239 ran the piece-operator scan and no chain;
    # --pd's sweep X1 and X2 twice a group each, X2 once more
    ran = stages.launched[SCORE_STAGE]
    assert ran["fwd_piece_ops"] and ran["fwd_piece_compose"] and not (
        ran["fwd_chunk"] or ran["fwd_chunk_tile"]), f"score launched {ran}"
    ran_pd = stages.launched["--pd write"]
    _x1_groups(ran_pd, pd_region, len(names), "--pd's sweep")
    print(f"[post] launches of the score stage: "
          f"{ {k: v for k, v in ran.items() if v} }; of --pd's sweep: "
          f"{ {k: v for k, v in ran_pd.items() if v} }", flush=True)

    # the 20 Mb score again, through the chain (X1 carry-only, the route
    # before the piece-operator scan) and through the pieces, each split
    (score_self, score_tables), score_kw = stages.first_call[SCORE_STAGE]
    S_score = int(score_self.params.log_trans.shape[0])
    chain, chain_split, chain_chunks = _score_split(
        score_self, score_tables, score_kw, ck.forward_final)
    pieces, pieces_split, piece_chunks = _score_split(
        score_self, score_tables, score_kw, ck.forward_loglik)
    del score_self, score_tables
    assert pieces == score, (pieces, score)
    ratio, lim_k = _chunk_ratio(chain_chunks, piece_chunks, S_score)
    tot_c = float(chain_chunks["incs"].sum())
    tot_p = float(piece_chunks["incs"].sum())
    print(f"[post] {n}-position score, {len(lim_k)} chunks: each chunk's "
          f"increments, pieces against chain, worst |difference|/limit "
          f"{ratio:.4f} (limit 2 (1e-6 |d| + _sum_atol) + 2 F3: "
          f"{float(lim_k.min()):.4g}-{float(lim_k.max()):.4g}); their "
          f"float64 sums {tot_p!r} and {tot_c!r}", flush=True)
    assert ratio <= 1.0, f"20 Mb score: a chunk's increments, {ratio}"
    # the printed float32 totals, a sanity bound: streaming_loglik's
    # float32 running total may round each chunk's add apart (an ulp
    # each), 2e-6 of the increments, the carries' tail
    chunk_len = score_kw.get("chunk_len", 1 << 14)
    n_chunks = -(-n // chunk_len)
    lim = (n_chunks * (float(np.spacing(np.float32(abs(chain)))) + 2e-6)
           + 2e-6 * abs(chain) + 1e-4)
    diff = abs(score - chain)
    print(f"[post] {n}-position score: pieces {score!r}, chain {chain!r}: "
          f"|difference| {diff:.6g} (sanity limit {lim:.6g}: {n_chunks} "
          f"chunks' float32 running sum, 2e-6 of the increments, the "
          f"carries' tail), {diff / abs(chain):.3g} relative", flush=True)
    assert diff <= lim, f"20 Mb score: pieces {score}, chain {chain}"
    for name, split in (("chain (X1 fwd_chunk)", chain_split),
                        ("piece-operator scan", pieces_split)):
        print(f"[post] score split, {name}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in split.items()), flush=True)

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


def _chunk_ratio(chain, pieces, S_):
    """The worst ratio, over chunks and rows, of |the pieces' summed
    increments - the chain's| to its limit, and the limits [n_chunks, B]:
    each route's sum is within 1e-6 relative plus ``_sum_atol`` of the
    float64 chain from its incoming carry, and the two incoming carries
    are within two F3 limits of each other, which move a chunk's sum by
    as much (its max over states is 1-Lipschitz in the carry).  ``chain``
    and ``pieces``: ``_score_split``'s chunks."""
    d_c, d_p = chain["incs"], pieces["incs"]
    assert d_c.shape == d_p.shape, (d_c.shape, d_p.shape)
    m = chain["obs_max"].double()[:, None]
    lim = (2 * (1e-6 * d_c.abs() + _sum_atol(chain["steps"][:, None], S_, m))
           + 2 * _f3_limit(m))
    return float(((d_p - d_c).abs() / lim).max()), lim


def _score_split(model, tables, kwargs, route):
    """(``model.score(tables, **kwargs)``, its seconds split, its chunks)
    with ``route`` as the score's forward continuation
    (``ck.forward_loglik``, or the chain ``ck.forward_final``).  The
    split: total; kernels (the route's calls, synchronised); obs
    formation (``obs_log_likelihoods``, synchronised); and the rest,
    ``block_of`` with its H2D copy and the host loop (total less the
    two).  The chunks: each call's summed increments in float64 [n_calls,
    B], its chunk's largest |obs| [n_calls] and its steps, queued on the
    card after the call's span (two small reductions a chunk, in the
    rest)."""
    import torch

    from tehmm_tpu_torch.models import hmm as port_hmm
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    stages = _Stages()
    saved = ck.forward_loglik
    ck.forward_loglik = route
    stages.wrap(ck, "forward_loglik", "kernels", sync=True)
    stages.wrap(port_hmm, "obs_log_likelihoods", "obs formation", sync=True)
    timed, incs, obs_max, steps = ck.forward_loglik, [], [], []

    def recorded(log_trans, obs, a_hat_init, lengths):
        carry, dm = timed(log_trans, obs, a_hat_init, lengths)
        incs.append(dm.double())
        obs_max.append(obs.abs().amax())
        steps.append(obs.shape[1])
        return carry, dm

    ck.forward_loglik = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ll = model.score(tables, **kwargs)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        stages.restore()
        ck.forward_loglik = saved
    split = dict(total=total, kernels=stages.seconds["kernels"],
                 obs_formation=stages.seconds["obs formation"])
    split["block_of_h2d_and_loop"] = \
        total - split["kernels"] - split["obs_formation"]
    chunks = dict(incs=torch.stack(incs), obs_max=torch.stack(obs_max),
                  steps=torch.tensor(steps, dtype=torch.float64,
                                     device=incs[0].device))
    return ll, split, chunks


def _em_log(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _majority_accuracy(decoded, truth, n_learned):
    """Base accuracy after mapping each learned state to the planted
    state it covers most."""
    counts = np.zeros((n_learned, S), np.int64)
    np.add.at(counts, (decoded.astype(np.int64), truth.astype(np.int64)), 1)
    return float(counts.max(axis=1).sum() / len(truth))


def phase_em(work, xml, truth, seed, device="cuda", parent=None):
    """3b: unsupervised EM through the CLI on the whole chromosome, K1
    against its plain version at this run's shape, then the decode of
    the learned model.  ``parent``: a checkout of an earlier commit,
    whose train CLI must learn the same model (every member of the saved
    file) on the same loglik trace, byte for byte.  Returns (the training
    run's launch counts, K1's errors at this shape, each K1 kernel's ms a
    call in the training run with its launches and bound)."""
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
        argv = [xml, regions, model, "--numStates", str(EM_STATES),
                "--iter", str(EM_ITERS), "--chunk", str(EM_CHUNK),
                "--seed", str(seed), "--device", device, "--logJson", log]
        _run_cli(port_train, argv)
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
    staged = stages.last["stage batch (H2D)"][0]
    learned = port_hmm.MultitrackHmm.load(model, "cpu")
    S_, T_, V_ = learned.params.log_em.shape
    shape = (*staged.shape[:2], S_, T_, V_)
    run_shape = {}
    for name in EM_KERNELS:
        span = "  of which " + name
        run_shape[name] = dict(
            em_run_shape=list(shape),
            em_run_shape_ms=stages.seconds[span] * 1e3 / stages.calls[span],
            em_run_shape_launches=launches[name],
            em_run_shape_bound_ms=_bound(name, shape, n)["bound_ms"])
    print(f"[em] K1 step: {ck.k1_step(S_, T_, V_)}; EM iterations (the "
          f"log's timestamps, under the stages' synchronising spans) "
          f"{_iteration_times(log)}; at this run's shape "
          f"{shape}: " + ", ".join(
              f"{k} {r['em_run_shape_ms']:.3f} ms a call x "
              f"{r['em_run_shape_launches']} (bound "
              f"{r['em_run_shape_bound_ms']:.4f} ms)"
              for k, r in run_shape.items()), flush=True)
    if parent is not None:
        # both checkouts' train CLIs on the same command, each bare in a
        # process of its own: their iteration times compare like for like
        here = os.path.dirname(os.path.abspath(__file__))
        bare = {}
        for name, root in (("this checkout", here), ("the parent", parent)):
            t0 = time.perf_counter()
            files = [os.path.join(work, f"bare_{len(bare)}_" +
                                  os.path.basename(x)) for x in (model, log)]
            _parent_cli(root, "train",
                        [[files[[model, log].index(a)] if a in (model, log)
                          else a for a in argv]])
            assert _npz_members(model) == _npz_members(files[0]), \
                f"the learned model differs from {name}'s bare run's"
            their_lls = [r["loglik"] for r in _em_log(files[1])]
            assert lls == their_lls, \
                f"the loglik trace differs from {name}'s: {their_lls}"
            bare[name] = (_iteration_times(files[1]),
                          time.perf_counter() - t0)
        print(f"[em] the learned model (every member of the file) and the "
              f"loglik trace byte-identical to the parent's ({parent}) and "
              f"to this checkout's own bare run", flush=True)
        for name, (times, sec) in bare.items():
            print(f"[em] {name}'s train CLI alone in a process: EM "
                  f"iterations {times}; its run {sec:.1f} s", flush=True)
    k1_err = _k1_at_em_shape(model, staged, np.random.RandomState(seed))

    t0 = time.perf_counter()
    _run_cli(port_eval, [xml, model, regions, "--bed", out_bed,
                         "--device", device])
    t_eval = time.perf_counter() - t0
    names = learned.state_names
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
    return launches, k1_err, run_shape


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
    step = _k1_lanes_against_shared(
        (p.log_start, p.log_trans, p.log_em, sym, lens))
    S, _T, V = p.log_em.shape
    print(f"[em] K1 at this run's shape (learned model, S={S} T={T} V={V}, "
          f"{B} rows of L={L}, ragged): the {step} kernels, bit for bit "
          f"the shared ones' (forced), within tolerance of the plain "
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


def _sticky_model(rng, S_, T_, V_):
    """(log_start, log_trans, log_em) of a sticky random model."""
    trans = rng.dirichlet(np.ones(S_), size=S_) * 0.05 + np.eye(S_) * 0.95
    log_em = np.zeros((S_, T_, V_))
    for t in range(T_):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V_ - 1), size=S_))
    return np.log(np.full(S_, 1.0 / S_)), np.log(trans), log_em


def _windowed_gap(params, table, x, half=2048):
    """The top-two relative gap of the log-space posterior at position x
    of ``table``, computed in plain torch on the CPU over the window of
    ``half`` positions either side (the stitched decoder's own view is a
    window too)."""
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.ops import dp

    lo, hi = max(0, x - half), min(len(table.symbols), x + half)
    sym = torch.from_numpy(
        np.ascontiguousarray(table.symbols[lo:hi], np.int32))[None]
    obs = track_log_likelihoods(params.log_em, sym)
    ah, _, _ = dp.forward_scaled(params.log_start, params.log_trans, obs)
    bh, _ = dp.backward_scaled(params.log_trans, obs)
    top = torch.topk(dp.posterior_scaled(ah, bh)[0, x - lo], 2).values
    return float((top[0] - top[1]) / top[0])


def _env_fit(work, xml, n, seed, dev):
    """3f's train through ``"auto"`` on ``dev``: (its logliks, wall
    seconds)."""
    from tehmm_tpu_torch.cli import train as port_train

    lo = n // 3
    bed = _region_bed(work, f"env_fit_{dev}.bed", lo, lo + ENV_FIT_REGION)
    log = os.path.join(work, f"env_fit_{dev}.jsonl")
    t0 = time.perf_counter()
    _run_cli(port_train, [
        xml, bed, os.path.join(work, f"env_fit_{dev}.npz"),
        "--numStates", str(ENV_STATES), "--iter", str(ENV_FIT_ITERS),
        "--chunk", str(ENV_FIT_CHUNK), "--seed", str(seed), "--device",
        dev, "--logJson", log])
    return (np.asarray([r["loglik"] for r in _em_log(log)]),
            time.perf_counter() - t0)


def _env_tables(xml, n, count):
    """The first ``count`` of 3f's ENV_TABLES regions, loaded."""
    from tehmm_tpu_torch.io import TrackList, load_track_data

    lo = n // 5
    regions = [("chr1", lo + k * ENV_TABLE_LEN, lo + (k + 1) * ENV_TABLE_LEN)
               for k in range(count)]
    return load_track_data(TrackList(xml), regions).tables


def _env_model(seed):
    return _sticky_model(np.random.RandomState(seed + 3), ENV_STATES, T, 9)


@contextlib.contextmanager
def _timed_backtraces(spans):
    """CUDA events around every ``ck.viterbi_backtrace`` call on the
    current stream (the wrapper's launches are there), appended to
    ``spans`` as (start, end); the wrapper restored after."""
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck

    real = ck.viterbi_backtrace

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        result = real(*args)
        end.record()
        spans.append((start, end))
        return result

    ck.viterbi_backtrace = timed
    try:
        yield
    finally:
        ck.viterbi_backtrace = real


def _env_runs(model, dev, tabs, pd_tabs, launches=None, only=None,
              bt_secs=None):
    """(name -> (result, seconds)) of every decoder of 3f on ``tabs`` on
    ``dev`` (the CPU ENV_CPU_ROWS rows a pass); ``--pd``'s sweep and the
    score on ``pd_tabs``; each run's launch counts into ``launches``;
    ``only``: the names to run (all by default); on the card
    ``bt_secs[name]``: the device seconds of its value-row backtrace
    calls (CUDA events around each)."""
    import torch

    from tehmm_tpu_torch.models import hmm as port_hmm
    from tehmm_tpu_torch.models.params import from_numpy
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.parallel import stitch

    params = from_numpy(*model, dev)
    hmm_model = port_hmm.MultitrackHmm(params, None, {}, None)
    rows = {"rows_per_pass": ENV_CPU_ROWS} if dev == "cpu" else {}

    def pd(tb):
        paths = [np.zeros(len(t.symbols), np.int32) for t in tb]
        keep = [np.zeros((len(t.symbols), ENV_STATES), np.float32)
                for t in tb[:ENV_PD_TABLES]]

        def consume(b, start, gamma):
            paths[b][start : start + len(gamma)] = gamma.argmax(axis=-1)
            if b < ENV_PD_TABLES:
                keep[b][start : start + len(gamma)] = gamma

        stitch.posterior_sweep(params, tb, ENV_PD_CHUNK, consume)
        return paths, keep

    calls = [
        ("viterbi", lambda: _checked(stitch.viterbi_chunked(
            params, tabs, **rows))),
        ("exact", lambda: stitch.viterbi_exact(params, tabs)),
        ("maxpost", lambda: _checked(stitch.posterior_chunked(
            params, tabs, **rows))),
        ("pd", lambda: pd(pd_tabs)),
        ("score", lambda: hmm_model.score(pd_tabs)),
    ]
    got = {}
    for name, call in calls:
        if only is not None and name not in only:
            continue
        ck.reset_launch_counts()
        spans = []
        t0 = time.perf_counter()
        with _timed_backtraces(spans) if bt_secs is not None \
                else contextlib.nullcontext():
            result = call()
        if dev != "cpu":
            torch.cuda.synchronize()
            launches[name] = dict(ck.LAUNCHES)
        got[name] = (result, time.perf_counter() - t0)
        if bt_secs is not None:
            bt_secs[name] = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    del params, hmm_model
    if dev != "cpu":
        torch.cuda.empty_cache()
    return got


def _env_cpu_main(spec_json):
    """3f's CPU references in a process of their own (``_EnvCpuRuns``):
    train through ``"auto"``, then the decoders, ``--pd``'s sweep and the
    score on the first regions; results pickled to the spec's ``out``."""
    import pickle

    spec = json.loads(spec_json)
    fit = _env_fit(spec["work"], spec["xml"], spec["n"], spec["seed"],
                   "cpu")
    sub = _env_tables(spec["xml"], spec["n"], ENV_CPU_TABLES)
    cpu = _env_runs(_env_model(spec["seed"]), "cpu", sub,
                    sub[:ENV_PD_TABLES],
                    only=("viterbi", "maxpost", "pd", "score"))
    with open(spec["out"] + ".tmp", "wb") as fh:
        pickle.dump({"fit": fit, "runs": cpu}, fh)
    os.replace(spec["out"] + ".tmp", spec["out"])


class _EnvCpuRuns:
    """3f's CPU references (its train and the decoders, ``--pd``'s sweep
    and the score on the first regions; the host alone, ~200-330 s) in a
    process of their own, started before 3c and held to the card's
    results after 3e, as ``_ParentRuns`` runs the parent's eval runs
    beside the later phases.  Every check and limit is 3f's own."""

    def __init__(self, work, xml, n, seed):
        self.out = os.path.join(work, "env_cpu.pkl")
        self.err = tempfile.TemporaryFile()
        spec = dict(work=work, xml=xml, n=n, seed=seed, out=self.out)
        here = os.path.dirname(os.path.abspath(__file__))
        code = ("import sys\n"
                f"sys.path.insert(0, {here!r})\n"
                "import chip_smoke\n"
                "chip_smoke._env_cpu_main(sys.argv[1])\n")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, json.dumps(spec)],
            stdout=subprocess.DEVNULL, stderr=self.err)
        _PARENT_BUILD.setdefault("jobs", []).append(self.proc)

    def result(self):
        import pickle

        t0 = time.perf_counter()
        rc = self.proc.wait(timeout=1200)
        self.err.seek(0)
        assert rc == 0, self.err.read()[-4000:].decode(errors="replace")
        self.err.close()
        print(f"[envelopes] the CPU references: done "
              f"{time.perf_counter() - self.t0:.1f} s after their start, "
              f"waited {time.perf_counter() - t0:.1f} s", flush=True)
        with open(self.out, "rb") as fh:
            return pickle.load(fh)


def phase_envelopes(work, xml, n, seed, cpu_runs, device="cuda"):
    """3f: every route past the fused kernels' envelopes at the scan
    tile's full width, ENV_STATES states, on the planted chromosome (T=5,
    V=9), card against CPU.  ``train`` through the E-step's ``"auto"`` on
    a region of ENV_FIT_REGION positions: ``auto`` takes ``cuda_v3`` (K6)
    and sizes its passes for it, scaled to 256 / S (asserted), and the
    logliks equal the CPU's within 1e-5 relative.  Then, with a sticky
    random model, on ENV_TABLES regions of ENV_TABLE_LEN positions on the
    card: the stitched Viterbi (obs, K5 on the cluster tile and the
    backtrace kernel), the exact Viterbi (``--exact``: K3's carry mode on
    the cluster tile and the backtrace; its paths equal the stitched
    ones), the stitched max-posterior (K7a/K7b on the cluster tile),
    ``posterior_sweep`` in chunks of ENV_PD_CHUNK (``--pd``'s path: X1 and
    X2 on the cluster tile; its argmax equal to the stitched max-posterior
    on >= 99.999% of the positions, each differing one a near-tie) and
    ``MultitrackHmm.score`` (X1 on the cluster tile); none of these
    launches the staged tile's K5, K3 carry mode, K7a/K7b or X1's or X2's
    carry modes.
    The CPU runs the train, the stitched decoders on the first
    ENV_CPU_TABLES regions and ``--pd``'s sweep and the score on the first
    ENV_PD_TABLES, ENV_CPU_ROWS rows a pass, in a process of its own
    (``cpu_runs``, an ``_EnvCpuRuns`` started before 3c) beside 3c, this
    phase and 3e; ``finish`` (after
    3e) holds them to the card's (the exact Viterbi through the card's:
    exact == stitched on the card, stitched == the CPU's): Viterbi paths
    equal; max-posterior paths and --pd's argmax equal on >= 99.999% of
    the positions, every differing position printed with its top-two
    posterior gap, which must be under NEAR_TIE; gammas within 1e-5,
    scores within 1e-5 relative.  Returns (the launch counts of each run
    on the card, ``finish``)."""
    import torch

    from tehmm_tpu_torch.models import hmm as port_hmm
    from tehmm_tpu_torch.models.params import from_numpy
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    launches = {}
    # train through "auto"
    ck.reset_launch_counts()
    card_logs, wall = _env_fit(work, xml, n, seed, device)
    launches["fit"] = dict(ck.LAUNCHES)
    print(f"[envelopes] train at S={ENV_STATES} on {ENV_FIT_REGION} "
          f"positions on {device}: {wall:.2f} s, logliks "
          f"{card_logs.tolist()}", flush=True)
    fit = launches["fit"]
    assert fit["fwd_prob_cluster"] and fit["bwd_prob_cluster"] \
        and not fit["em_fwd"], \
        f"auto did not take cuda_v3 past K1's envelope: {fit}"
    # and sizes its passes for cuda_v3's [B, L, S] tensors at this S
    fit_params = from_numpy(*_sticky_model(np.random.RandomState(seed),
                                           ENV_STATES, T, 9), device)
    budget = port_hmm._pass_positions(fit_params, None, fit_params.device)
    assert budget == port_hmm._MAX_PASS_POSITIONS * 256 // ENV_STATES, \
        f"pass budget {budget} at S={ENV_STATES}"
    del fit_params

    # the decoders, --pd's sweep and the score
    tables = _env_tables(xml, n, ENV_TABLES)
    T_, V_ = tables[0].symbols.shape[1], 9
    assert T_ == T and max(int(t.symbols.max()) for t in tables) < V_
    model = _env_model(seed)
    assert not ck.k2_fits(ENV_STATES, T_, V_) \
        and not ck.k4_fits(ENV_STATES, T_, V_) \
        and not ck.sweep_fits(ENV_STATES) \
        and ck.scan_route(ENV_STATES) == "cluster"
    bt_secs = {}
    card = _env_runs(model, device, tables, tables, launches=launches,
                     bt_secs=bt_secs)
    n_card = ENV_TABLES * ENV_TABLE_LEN
    for name, (_r, secs) in card.items():
        bt = launches[name]["viterbi_backtrace"]
        of_it = f" (the value-row backtrace {bt_secs[name]:.4f} s of it, " \
            f"{bt} launches)" if bt else ""
        print(f"[envelopes] {name} at S={ENV_STATES} on {ENV_TABLES} regions"
              f" of {ENV_TABLE_LEN} ({n_card} positions) on the card: "
              f"{secs:.2f} s{of_it}; launches "
              f"{ {k: v for k, v in launches[name].items() if v} }",
              flush=True)
    for path, names in ENVELOPE_KERNELS.items():
        assert all(launches[path][k] for k in names), (path, launches[path])
    for path, names in OFF_ENVELOPE_PATH.items():
        assert not any(launches[path][k] for k in names), \
            (path, launches[path])
    # the Viterbi paths again with the staged tile forced (the parent's
    # route for K5 and K3's carry mode): the same paths, and their card
    # seconds beside the cluster tile's (this run second, on warm caches)
    from tehmm_tpu_torch.tools.time_scans import staged_tile

    forced = {}
    with staged_tile():
        staged = _env_runs(model, device, tables, tables, launches=forced,
                           only=("viterbi", "exact"))
    for name, kernel in (("viterbi", "viterbi_values"),
                         ("exact", "viterbi_chunk_tile")):
        for g, e in zip(card[name][0], staged[name][0]):
            assert np.array_equal(g, e), \
                f"{name}: the cluster tile's paths != the staged tile's"
        assert forced[name][kernel] and not forced[name][CLUSTER_OF[kernel]]
        print(f"[envelopes] {name} at S={ENV_STATES} with the staged tile "
              f"forced: {staged[name][1]:.2f} s against the cluster "
              f"tile's {card[name][1]:.2f} s; the same paths; launches "
              f"{ {k: v for k, v in forced[name].items() if v} }",
              flush=True)
    del staged
    assert not launches["viterbi"]["viterbi_fwd"] \
        and not launches["maxpost"]["post_decode"] \
        and not launches["maxpost"]["post_decode_lanes"] \
        and not launches["maxpost"]["em_fwd"]
    # on the card: the exact Viterbi == the stitched one; --pd's argmax ==
    # the stitched max-posterior but at near-ties
    for g, e in zip(card["viterbi"][0], card["exact"][0]):
        assert np.array_equal(g, e), "exact and stitched Viterbi differ"
    pd_card_paths, pd_card_gamma = card["pd"][0]
    cpu_params = from_numpy(*model, "cpu")

    def near_ties(what, mine, theirs, tabs):
        """Positions where two argmax paths differ: >= 99.999% agree, and
        every differing position is a near-tie (printed with its gap)."""
        wheres = [np.flatnonzero(g != c) for g, c in zip(mine, theirs)]
        n_diff = sum(len(w) for w in wheres)
        n_pos = sum(len(c) for c in theirs)
        assert 1.0 - n_diff / n_pos >= 0.99999, \
            f"{what}: {n_diff} of {n_pos} positions differ"
        for b, where in enumerate(wheres):
            for x in where.tolist():
                gap = _windowed_gap(cpu_params, tabs[b], x)
                print(f"[envelopes] {what} differs at region {b} position "
                      f"{x} ({int(mine[b][x])} against {int(theirs[b][x])})"
                      f": top-two posterior gap {gap:.3g} relative",
                      flush=True)
                assert gap <= NEAR_TIE, f"{what}: not a near-tie ({gap})"
        return n_diff

    mp_diff = near_ties("card --pd argmax vs stitched max-posterior",
                        pd_card_paths, card["maxpost"][0], tables)
    print(f"[envelopes] card: exact Viterbi == stitched on every position;"
          f" --pd's argmax differs from the stitched max-posterior on "
          f"{mp_diff} of {n_card} positions, each a near-tie; score "
          f"{card['score'][0]:.6f}", flush=True)
    sub = tables[:ENV_CPU_TABLES]
    sub_score = port_hmm.MultitrackHmm(from_numpy(*model, device), None,
                                       {}, None).score(sub[:ENV_PD_TABLES])
    del tables
    torch.cuda.empty_cache()

    def finish():
        """The CPU's results (from their own process) against the
        card's."""
        ref = cpu_runs.result()
        cpu_logs, cpu_wall = ref["fit"]
        print(f"[envelopes] train at S={ENV_STATES} on {ENV_FIT_REGION} "
              f"positions on cpu: {cpu_wall:.2f} s, logliks "
              f"{cpu_logs.tolist()}", flush=True)
        assert len(card_logs) == len(cpu_logs) >= ENV_FIT_ITERS - 1
        rel = float(np.max(np.abs(card_logs - cpu_logs) / np.abs(cpu_logs)))
        assert rel <= 1e-5, f"train: card and CPU logliks differ by {rel}"
        print(f"[envelopes] auto -> cuda_v3 ({fit['fwd_prob_cluster']} "
              f"fwd_prob_cluster, {fit['bwd_prob_cluster']} "
              f"bwd_prob_cluster, 0 em_fwd launches), {budget} "
              f"positions a pass; loglik rel err card vs CPU {rel:.3g}",
              flush=True)
        cpu = ref["runs"]
        for name, (_r, secs) in cpu.items():
            print(f"[envelopes] {name} on the CPU, {len(sub)} regions: "
                  f"{secs:.2f} s", flush=True)
        for g, c in zip(card["viterbi"][0], cpu["viterbi"][0]):
            assert np.array_equal(g, c), "card and CPU Viterbi paths differ"
        n_sub = sum(len(t.symbols) for t in sub)
        n_diff = (near_ties("maxpost card vs CPU", card["maxpost"][0],
                            cpu["maxpost"][0], sub)
                  + near_ties("pd argmax card vs CPU", pd_card_paths,
                              cpu["pd"][0][0], sub))
        for g, c in zip(pd_card_gamma, cpu["pd"][0][1]):
            _assert_close("--pd gamma card vs CPU", torch.from_numpy(g),
                          torch.from_numpy(c), 0.0, 1e-5)
        s_rel = abs(sub_score - cpu["score"][0]) / abs(cpu["score"][0])
        assert s_rel <= 1e-5, f"scores differ by {s_rel} relative"
        print(f"[envelopes] CPU on {n_sub} positions ({ENV_PD_TABLES} "
              f"region(s) for --pd and the score): Viterbi == card; "
              f"max-posterior and --pd argmax differ on {n_diff} positions, "
              f"each a near-tie; --pd gammas within 1e-5; "
              f"score rel err {s_rel:.3g}", flush=True)

    return launches, finish


def _checked(result):
    """The paths of a stitched decode whose every boundary agreed."""
    paths, report = result
    assert report.boundaries_ok, report
    return paths


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
                     seed, device="cuda", parent=None):
    """3e, base resolution: ``train --supervised`` and the stitched
    ``eval --bed`` of the whole chromosome with the gaussian track (K2
    with the gaussian stream), stitched ``--maxPost`` on a region (K1's
    forward and K4 with it) and EM on a smaller region (K1 with it); then
    the card against the CPU for the Viterbi decode and the EM; with
    ``parent`` (the run's ``_ParentRuns``) a checkout of an earlier
    commit's eval CLI must write the stitched Viterbi and ``--maxPost``
    BEDs byte for byte.  Returns the main path's launch counts."""
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
        eval_argv = [xml, model, regions, "--bed", out_bed, "--device",
                     device]
        score = float(_run_cli(port_eval, eval_argv))
        t_eval = time.perf_counter() - t0
    finally:
        stages.restore()
    # --maxPost (K4 with the gaussian stream) on a region
    mp_out = os.path.join(work, "gauss_maxpost.bed")
    mp_argv = [xml, model, _region_bed(work, "gauss_mp.bed", lo, lo + region),
               "--bed", mp_out, "--maxPost", "--no-exact", "--device",
               device]
    t0 = time.perf_counter()
    mp_score = float(_run_cli(port_eval, mp_argv))
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
    if parent is not None:
        parent.add([(eval_argv, out_bed), (mp_argv, mp_out)], "gauss")
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


def phase_segments(work, xml, truth, seed, device="cuda", parent=None):
    """3e, segment mode on the whole chromosome: ``segment_tracks``,
    ``train --segment --segLen`` (K1 with both streams), ``eval
    --segment --segLen --bed`` (K2 with both) and ``--maxPost`` (K4 with
    both; with ``parent``, the run's ``_ParentRuns``, a checkout of an
    earlier commit's eval CLI must write both BEDs byte for byte).
    Returns the main path's launch counts."""
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
            argv = [xml, model, segs, "--segment", "--segLen", "--bed", out,
                    "--no-exact", "--device", device, *flags]
            t0 = time.perf_counter()
            scores[mode] = float(_run_cli(port_eval, argv))
            walls[f"eval {mode} CLI"] = time.perf_counter() - t0
            scores[mode + " bed"] = out
            scores[mode + " argv"] = argv
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
    if parent is not None:
        parent.add([(scores[m + " argv"], scores[m + " bed"])
                    for m in ("Viterbi", "--maxPost")], "seg")
    print("[seg] stage                      seconds  calls", flush=True)
    for stage, sec in stages.seconds.items():
        print(f"[seg] {stage:26s} {sec:9.3f}  {stages.calls[stage]}",
              flush=True)
    for name, sec in walls.items():
        print(f"[seg] {name:26s} {sec:9.3f}", flush=True)
    return launches


def phase_segments_card_vs_cpu(work, xml_seg, xml_cat, n, region, seed,
                               device="cuda", parent=None):
    """3e, segment mode on the card against the CPU on a region: the
    same ``train --segment --segLen`` and ``eval --segment --segLen``
    (Viterbi and ``--maxPost``, stitched) with the gaussian track, then
    with the categorical tracks only (with ``parent``, the run's
    ``_ParentRuns``, a checkout of an earlier commit's eval CLI must
    write the card's categorical Viterbi and ``--maxPost`` BEDs byte for
    byte).  Returns the launch counts of the categorical card runs
    (their own path: the weight stream alone)."""
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.cli import train as port_train
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    lo = n // 2
    names = [str(i) for i in range(SEG_STATES)]
    cat_launches = None
    same_as_parent = []
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
                argv = [xml, model, segs, "--segment", "--segLen", "--bed",
                        out, "--no-exact", "--device", dev, *flags]
                _run_cli(port_eval, argv)
                paths.append(_paint_region(out, lo, region, names))
                if tag == "categorical" and dev == device:
                    same_as_parent.append((argv, out))
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
    if parent is not None:
        parent.add(same_as_parent, "seg-small")
    return cat_launches


def phase_workflow(work, phase3, seed, device="cuda",
                   n=WORKFLOW_POSITIONS):
    """3w: the workflow tools through the dispatcher's ``main``, in this
    process (one holder of the card, the build and the counters).
    ``phase3``: (stitched BED, truth BED, base accuracy, positions) of
    phase 3.  -> the launch counts of the phase."""
    from tehmm_tpu_torch import __main__ as tools
    from tehmm_tpu_torch.cli.compare_bed_states import base_level_confusion
    from tehmm_tpu_torch.cli.unported import SLICE_TOOLS
    from tehmm_tpu_torch.io import read_bed_intervals
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    wdir = os.path.join(work, "workflow")
    os.makedirs(wdir)
    seconds = {}
    t0 = time.perf_counter()
    xml, truth_bed, _truth = make_dataset(
        wdir, np.random.RandomState(seed + 9), n)
    regions = _region_bed(wdir, "regions.bed", 0, n)
    seconds["dataset"] = time.perf_counter() - t0

    def run(stage, argv):
        t0 = time.perf_counter()
        out = _run_cli(tools, argv)
        seconds[stage] = time.perf_counter() - t0
        return out

    # 1. benchmark on the card, and its supervised config on the CPU
    configs = ["--config", "sup:--supervised", "--config",
               f"em10:--numStates {S} --iter {WORKFLOW_EM_ITERS} "
               f"--seed {seed}"]
    summary, dirs = {}, {}
    for tag, dev, cfg in (("card", device, configs),
                          ("cpu", "cpu", configs[:2])):
        dirs[tag] = os.path.join(wdir, f"bench_{tag}")
        table = run(f"benchmark ({tag})",
                    ["benchmark", xml, truth_bed, regions, dirs[tag],
                     "--device", dev, *cfg])
        print("\n".join(f"[workflow] {tag}: {ln}"
                        for ln in table.splitlines()), flush=True)
        with open(os.path.join(dirs[tag], "summary.json")) as fh:
            summary[tag] = {r["name"]: r for r in json.load(fh)}
    assert list(summary["card"]) == ["sup", "em10"] and \
        list(summary["cpu"]) == ["sup"], summary
    errors = {(tag, name): r["error"] for tag, rs in summary.items()
              for name, r in rs.items() if "error" in r}
    assert not errors, f"3w benchmark configs failed: {errors}"
    sup, em = summary["card"]["sup"], summary["card"]["em10"]
    assert sup["base_accuracy"] >= 0.9, \
        f"3w sup base accuracy {sup['base_accuracy']} < 0.9"
    assert 0.0 <= em["base_accuracy"] <= 1.0, em["base_accuracy"]

    def entry(r):
        return {k: v for k, v in r.items() if not k.endswith("_seconds")}

    assert entry(sup) == entry(summary["cpu"]["sup"]), \
        "3w: sup's summary entry differs between the card and the CPU"
    beds = [open(os.path.join(dirs[tag], "sup.pred.bed"), "rb").read()
            for tag in ("card", "cpu")]
    assert beds[0] == beds[1], "3w: sup.pred.bed differs card vs CPU"
    print(f"[workflow] sup base accuracy {sup['base_accuracy']:.6f} "
          f"(card == CPU: pred.bed {len(beds[0])} bytes, summary entry); "
          f"em10 ({WORKFLOW_EM_ITERS} EM iterations) base accuracy "
          f"{em['base_accuracy']:.6f}", flush=True)

    # 2. compare-bed-states of phase 3's stitched BED
    bed3, truth3, acc3, n3 = phase3
    res = json.loads(run("compare-bed-states",
                         ["compare-bed-states", truth3, bed3, "--json"]))
    assert abs(res["base_accuracy"] - acc3) <= 1e-9, \
        f"compare-bed-states {res['base_accuracy']} != phase 3's {acc3}"
    print(f"[workflow] compare-bed-states of phase 3's BED: base accuracy "
          f"{res['base_accuracy']:.9f} (phase 3: {acc3:.9f})", flush=True)

    # 3. fit-state-names of em10's prediction: each interval kept, its
    # name the printed map's; the map 1:1 onto truth names, and a state
    # it leaves unnamed only where every truth name it overlaps is taken
    # (the greedy is maximal)
    pred = os.path.join(dirs["card"], "em10.pred.bed")
    named = os.path.join(wdir, "em10.named.bed")
    printed = run("fit-state-names",
                  ["fit-state-names", truth_bed, pred, named, "--printMap"])
    mapping = dict(ln.split("\t") for ln in printed.splitlines())
    truth_ivs = read_bed_intervals(truth_bed, ncol=4)
    truth_names = {r[3] for r in truth_ivs}
    before = read_bed_intervals(pred, ncol=4)
    after = read_bed_intervals(named, ncol=4)
    assert [r[:3] + (mapping.get(r[3], r[3]),) for r in before] == after, \
        "fit-state-names dropped, moved or misnamed intervals"
    onto = {p: t for p, t in mapping.items() if t in truth_names}
    assert len(set(onto.values())) == len(onto), mapping
    overlaps = base_level_confusion(truth_ivs, before)
    unnamed = {r[3] for r in before} - set(onto)
    for p in unnamed:
        free = {t for (t, q), v in overlaps.items()
                if q == p and t is not None and v} - set(onto.values())
        assert not free, f"fit-state-names left {p} unnamed beside {free}"
    with open(named, "rb") as a, \
            open(os.path.join(dirs["card"], "em10.fit.bed"), "rb") as b:
        assert a.read() == b.read(), "fit-state-names != benchmark's"
    covered = sum(e - s for _c, s, e, name in after if name in truth_names)
    print(f"[workflow] fit-state-names: {len(after)} intervals kept, "
          f"{len(onto)} of {len(onto) + len(unnamed)} states named onto "
          f"the truth's, {covered / n:.6f} of the bases; map "
          + ", ".join(f"{p}->{t}" for p, t in sorted(mapping.items())),
          flush=True)

    # 4. view of sup's model, on the card and the CPU
    model = os.path.join(dirs["card"], "sup.mod.npz")
    texts = [run(f"view ({dev})", ["view", model, "--device", dev])
             for dev in (device, "cpu")]
    assert texts[0] == texts[1], "view prints differently card vs CPU"
    assert texts[0].startswith(f"states ({len(truth_names)}):"), \
        texts[0][:200]

    # 5. bed-tools stats, and the dispatcher's own exits
    stats = json.loads(run("bed-tools stats",
                           ["bed-tools", "stats", bed3]))
    assert sum(v["total_bases"] for v in stats.values()) == n3, stats
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tehmm_tpu_torch"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and "tools:" in proc.stdout, \
        (proc.returncode, proc.stdout, proc.stderr)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert tools.main(["--help"]) == 0
        assert tools.main(["no-such-tool"]) == 2
        try:
            tools.main(["import-model", "model.hmm"])
        except SystemExit as e:
            assert SLICE_TOOLS in str(e.code), e.code
        else:
            raise AssertionError("import-model did not exit")
    seconds["dispatcher exits"] = time.perf_counter() - t0
    print(f"[workflow] bed-tools stats of phase 3's BED: {len(stats)} "
          f"states over {n3} bases; python -m tehmm_tpu_torch: no tool "
          "2, --help 0, unknown 2, import-model names its ROADMAP item",
          flush=True)
    print("[workflow] stage                    seconds", flush=True)
    for stage, sec in seconds.items():
        print(f"[workflow] {stage:24s} {sec:9.3f}", flush=True)
    return dict(ck.LAUNCHES)


def _phase_done(name, t_run):
    print(f"[time] phase {name} done at {time.perf_counter() - t_run:.1f} s "
          f"of the run", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit (git archive): "
                         "3d holds phase 3's stitched BED of the "
                         "chromosome and --exact BED of its region, 3d's "
                         "stitched --maxPost BED, --maxPost --exact BEDs "
                         "and --pd file, 3b its learned model and loglik "
                         "trace, 3e its stitched Viterbi and --maxPost "
                         "BEDs (+g, +wg, +w), to this one's byte for byte")
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

    parent = None if args.parent is None else os.path.abspath(args.parent)
    try:
        return _run(args, device, smi, parent)
    finally:
        _stop_parent_processes()


def _run(args, device, smi, parent) -> int:
    import torch

    from tehmm_tpu_torch.ops import cuda_kernels as ck

    if parent is not None:
        _start_parent_build(parent)
    t_run = time.perf_counter()
    rng = np.random.RandomState(args.seed)
    kernels = phase_kernels(device, rng)
    # K3 at phase 3's --exact shapes, X1 at 3d's, on generators of their
    # own
    kernels.update(phase_k3_main_shapes(
        device, np.random.RandomState(args.seed + 6)))
    kernels.update(phase_x1_main_shapes(
        device, np.random.RandomState(args.seed + 7)))
    kernels.update(phase_x2_main_shapes(
        device, np.random.RandomState(args.seed + 8)))
    kernels.update(phase_k1(device, rng))
    kernels.update(phase_post_kernels(device, rng, args.seed))
    # the stream checks draw from their own generator, so the data of
    # phase 3 on are the same draws with and without them
    kernels.update(phase_stream_kernels(
        device, np.random.RandomState(args.seed + 1)))
    torch.cuda.empty_cache()
    kernels.update(phase_streaming_kernels(
        device, np.random.RandomState(args.seed + 2), args.seed))
    torch.cuda.empty_cache()
    kernels.update(phase_k6_fit_shape(device, args.seed))
    kernels.update(phase_backtrace_3f_shapes(device, args.seed))
    kernels.update(phase_maxplus(device))
    sweep_rows = phase_wide_sweeps(device,
                                   np.random.RandomState(args.seed + 4))
    kernels.update({k: r for k, r in sweep_rows.items()
                    if k.endswith((f"@S{ENV_STATES}", "@S240", "@S256"))})
    del sweep_rows
    torch.cuda.empty_cache()
    _phase_done("2", t_run)
    engine_launches = phase_engines(args.seed)
    _phase_done("2e", t_run)
    maxplus_launches = phase_maxplus_tool()
    _phase_done("2m", t_run)

    n = N_POSITIONS
    with tempfile.TemporaryDirectory(prefix="tehmm_chip_smoke_") as work:
        # the parent's eval runs; launch and finish do nothing without one
        checks = _ParentRuns(parent, work)
        queue = None if parent is None else checks
        t0 = time.perf_counter()
        xml, truth_bed, truth = make_dataset(work, rng, n)
        print(f"[e2e] dataset: {n} positions, {T} tracks, "
              f"{time.perf_counter() - t0:.1f} s to write", flush=True)

        ck.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        acc3, viterbi_score, viterbi_runs, as_parent = phase_end_to_end(
            work, xml, truth_bed, truth, EXACT_REGION, 20_000)
        decode_launches = dict(ck.LAUNCHES)
        as_parent()
        del as_parent
        print(f"[e2e] peak device memory allocated: "
              f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB",
              flush=True)
        _phase_done("3", t_run)

        ck.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        post_launches = phase_max_posterior(
            work, xml, truth, viterbi_score, 1_000_000, 20_000, 100_000,
            parent=queue, parent_runs=viterbi_runs)
        print(f"[post] peak device memory allocated: "
              f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB",
              flush=True)
        _phase_done("3d", t_run)

        ck.reset_launch_counts()
        em_launches, k1_em_err, k1_em_shape = phase_em(
            work, xml, truth, args.seed, parent=parent)
        # the parent's runs of 3 and 3d beside the phases from 3c on (3b
        # times train runs, each alone in a process)
        checks.launch()
        for name, e in k1_em_err.items():
            kernels[name]["max_abs_err_em_run_shape"] = e
            kernels[name].update(k1_em_shape[name])
        _phase_done("3b", t_run)

        # 3f's CPU references, in a process of their own beside 3c, 3f and
        # 3e; env_finish holds them to the card's
        env_cpu = _EnvCpuRuns(work, xml, n, args.seed)
        phase_em_card_vs_cpu(work, xml, n, 50_000, args.seed)
        _phase_done("3c", t_run)
        env_launches, env_finish = phase_envelopes(work, xml, n, args.seed,
                                                   env_cpu)
        _phase_done("3f, the card", t_run)

        t0 = time.perf_counter()
        xml_g, xml_seg, xml_cat = make_gauss_track(work, rng, truth)
        print(f"[gauss] gaussian track: {n // GAUSS_RECORD} records, "
              f"{time.perf_counter() - t0:.1f} s to write", flush=True)
        ck.reset_launch_counts()
        gauss_launches = phase_gauss_base(work, xml_g, truth_bed, truth,
                                          20_000, 1_000_000, 50_000,
                                          args.seed,
                                          parent=queue)
        checks.launch()
        _phase_done("3e, base resolution", t_run)
        ck.reset_launch_counts()
        seg_launches = phase_segments(work, xml_seg, truth, args.seed,
                                      parent=queue)
        checks.launch()
        cat_launches = phase_segments_card_vs_cpu(
            work, xml_seg, xml_cat, n, 200_000, args.seed,
            parent=queue)
        checks.finish()
        _phase_done("3e, segments", t_run)
        ck.reset_launch_counts()
        workflow_launches = phase_workflow(
            work, (os.path.join(work, "decoded.bed"), truth_bed, acc3, n),
            args.seed)
        _phase_done("3w", t_run)
        env_finish()
        _phase_done("3f, the CPU references", t_run)
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
    print(f"[launches] workflow path (3w): "
          f"{ {k: n for k, n in workflow_launches.items() if n} }",
          flush=True)
    missing = [k for k in DECODE_KERNELS if decode_launches[k] == 0]
    missing += [k for k in EM_KERNELS if em_launches[k] == 0]
    missing += [f"{k} (3d)" for k in POST_KERNELS if post_launches[k] == 0]
    missing += [f"{k} (3e)" for k in GAUSS_BASE_KERNELS
                if gauss_launches[k] == 0]
    missing += [f"{k}+wg (3e)" for k in SEGMENT_KERNELS
                if seg_launches[k + "+wg"] == 0]
    missing += [f"{k}+w (3e)" for k in SEGMENT_KERNELS
                if cat_launches[k + "+w"] == 0]
    missing += [f"{k} (3w)" for k in WORKFLOW_KERNELS
                if workflow_launches[k] == 0]
    missing += [f"{k} (2e, {config})"
                for config in ENGINE_CONFIGS + WIDE_CONFIGS
                for k in _engine_kernels(config)
                if engine_launches[config][k] == 0]
    staged = {(config, k): engine_launches[config][k]
              for config in WIDE_CONFIGS
              for k in ("viterbi_values", "fwd_prob", "bwd_prob",
                        "fwd_scaled", "bwd_scaled", "viterbi_ptrs")
              if engine_launches[config][k]}
    assert not staged, \
        f"2e launched the staged tile's K5, K6, K7a/K7b or K8c: {staged}"
    block = {(config, k): engine_launches[config][k]
             for config in ENGINE_CONFIGS
             for k in ("fwd_scaled", "bwd_scaled", "fwd_prob", "bwd_prob",
                       "viterbi_values", "viterbi_ptrs")
             if engine_launches[config][k]}
    assert not block, \
        f"2e launched the block tile's K7a/K7b, K6a/K6b, K5 or K8c: {block}"
    for Sp, counts in maxplus_launches.items():
        print(f"[launches] K9 tool (2m) at Sp={Sp}: "
              f"{ {k: n for k, n in counts.items() if n} }", flush=True)
        missing += [f"{k} (2m, Sp={Sp})"
                    for k in ("maxplus_resident", "maxplus_blocks")
                    if counts[k] == 0]
    for path, names in ENVELOPE_KERNELS.items():
        print(f"[launches] past the envelopes (3f), {path}: "
              f"{ {k: n for k, n in env_launches[path].items() if n} }",
              flush=True)
        missing += [f"{k} (3f, {path})" for k in names
                    if env_launches[path][k] == 0]
    assert not missing, f"kernels never launched on their path: {missing}"
    off = {k: decode_launches[k] for k in OFF_DECODE_PATH}
    assert not any(off.values()), f"phase 3 launched {off}"
    # phase 3's chases: the exact decoder's, one a group (as its map), and
    # K2's, one a stitched pass (as its forward)
    x3_chases = decode_launches["chunk_entry_map"]
    k2_chases = decode_launches["chunk_chase"] - x3_chases
    k2_forwards = decode_launches["viterbi_fwd_lanes"] + \
        decode_launches["viterbi_fwd"]
    assert k2_chases == k2_forwards, \
        f"phase 3: {k2_chases} chases beside K2's {k2_forwards} forwards"
    launches = {k: decode_launches[k] for k in DECODE_KERNELS}
    launches.update({k: em_launches[k] for k in EM_KERNELS})
    launches.update({k: post_launches[k] for k in POST_KERNELS
                     if k not in launches})
    by_variant = {"+g": gauss_launches, "+wg": seg_launches,
                  "+w": cat_launches}
    # the tile's carry modes at ENV_STATES: 3f's exact Viterbi, --pd's
    # sweep and the score
    tile_paths = {"viterbi_chunk_tile": ("exact",),
                  "viterbi_chunk_cluster": ("exact",),
                  "fwd_chunk_tile": ("pd", "score"), "bwd_chunk_tile": ("pd",),
                  "fwd_chunk_cluster": ("pd", "score"),
                  "bwd_chunk_cluster": ("pd",),
                  "fwd_chunk_rows": ("pd", "score"),
                  "bwd_chunk_rows": ("pd",),
                  "viterbi_chunk_rows": ("exact",)}
    for name in kernels:
        base, _, config = name.partition("@")
        if "+" in name:
            launches[name] = by_variant["+" + name.split("+")[1]][name]
        elif base.startswith("maxplus_"):
            Sp = int(config[1:]) if config else MAXPLUS_SP[0]
            launches[name] = maxplus_launches[Sp][base]
        elif base in tile_paths:
            launches[name] = sum(env_launches[path][base]
                                 for path in tile_paths[base])
        elif config == K6_FIT:
            launches[name] = env_launches["fit"][base]   # 3f's train
        elif base == "viterbi_backtrace" and config in BT_3F_PATHS:
            # 3f's stitched and exact Viterbi decodes
            launches[name] = env_launches[BT_3F_PATHS[config]][base]
        elif base == "chunk_chase" and config not in engine_launches:
            launches[name] = k2_chases if config == "K2" else x3_chases
        elif (base in DECODE_KERNELS or base == "viterbi_chunk_values") \
                and config not in engine_launches:
            # K3 and X3 at --exact's shapes; K3's values mode, off the
            # path since the pointer mode, with its count of 0
            launches[name] = decode_launches[base]
        elif base in POST_KERNELS and config and \
                config not in engine_launches:
            launches[name] = post_launches[base]    # X1, K4 at 3d's shapes
        elif base == "post_decode":
            # K4's shared decode, forced at S=10: 3d's count of it, 0
            launches[name] = post_launches[base]
        elif base == "viterbi_fwd":
            # K2's shared forward, forced at S=10: phase 3's count, 0
            launches[name] = decode_launches[base]
        elif config or base in STREAMING_KERNELS \
                or base in ("viterbi_backtrace", "fwd_scaled_lanes",
                            "bwd_scaled_lanes", "fwd_prob_lanes",
                            "bwd_prob_lanes", "viterbi_values_lanes",
                            "viterbi_ptrs_lanes"):
            # 2e's launches (the backtrace: off the stitched decode, on
            # 2e's streaming route; K7a/K7b, K6a/K6b, K5 and K8c at S20 on
            # the lanes step), and
            # at ENV_STATES also 3f's (K5 and
            # the backtrace on its Viterbi paths, K6 on its train, K7 on
            # its max-posterior)
            launches[name] = \
                engine_launches[config or ENGINE_CONFIGS[0]][base]
            if config == f"S{ENV_STATES}":
                launches[name] += sum(n[base] for n in env_launches.values())
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "tehmm_tpu")
                   for m in sys.modules), "jax or tehmm_tpu was imported"

    def base_of(name):
        return name.split("+")[0].split("@")[0]

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCES[base_of(name)],
             replaces=REPLACES.get(name.split("+")[0],
                                   REPLACES[base_of(name)]),
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
