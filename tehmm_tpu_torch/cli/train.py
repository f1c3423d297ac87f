"""tehmm-train on the port: supervised, unsupervised and
semi-supervised training.

Counterpart of ``tehmm_tpu/cli/train.py``:

  --supervised      the state of every position is the name column of the
                    training BED; counts on the host, M-step on --device
  (default)         Baum-Welch EM over --numStates (flat or random
                    init), with --reps random restarts, --deviceLoop,
                    --initModel resume, --checkpoint and --logJson
  semi-supervised   --initTransProbs/--initEmProbs priors, pinned by
                    --fixTrans/--fixEm/--forceTransProbs/--forceEmProbs
  --segment         EM over segment_tracks output, one observation per
                    segment; --segLen raises each segment's emission to
                    the power of its length

Tracks declared ``distribution="gaussian"`` train normal emissions beside
the categorical ones.  On ``--device cuda`` every E-step runs through K1
(the fused E-step kernels, with their weight and gaussian streams); on
``--device cpu`` through the plain-torch engine.  The model file is the
JAX package's format.  The CFG, sharding and profiling flags are
recognized and exit naming their ROADMAP item.

Usage:
  python -m tehmm_tpu_torch.cli.train tracks.xml training.bed out.npz \\
      [--supervised | --numStates N ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tehmm_tpu_torch.io import TrackList, load_track_data, read_bed_intervals
from tehmm_tpu_torch.io import priors as priors_io
from tehmm_tpu_torch.io.bed import get_merged_bed_intervals
from tehmm_tpu_torch.io.segments import load_segment_data
from tehmm_tpu_torch.utils.common import (
    LOG_ZERO,
    JsonlMetrics,
    add_logging_options,
    logger,
    set_logging_from_options,
)
from tehmm_tpu_torch.cli import unported as up
from tehmm_tpu_torch.models.gauss import init_gauss
from tehmm_tpu_torch.models.hmm import MultitrackHmm, fit_restarts
from tehmm_tpu_torch.models.params import (
    HmmParams,
    apply_emission_conventions,
)
from tehmm_tpu_torch.ops import em as em_ops
from tehmm_tpu_torch.utils.device import resolve_device

UNPORTED = {
    "--cfg": (False, up.SLICE_CFG),
    "--pairStates": (True, up.SLICE_CFG),
    "--maxSpan": (True, up.SLICE_CFG),
    "--matchBonus": (True, up.SLICE_CFG),
    "--cfgEm": (True, up.SLICE_CFG),
    "--saPrior": (True, up.SLICE_CFG),
    "--mesh": (True, up.SLICE_SHARDING),
    "--coordinatorAddress": (True, up.SLICE_SHARDING),
    "--numProcesses": (True, up.SLICE_SHARDING),
    "--processId": (True, up.SLICE_SHARDING),
    "--profile": (True, up.SLICE_TOOLS),
}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tehmm-train (torch)",
        description="Train a multi-track HMM on genomic annotation tracks "
                    "(PyTorch port)",
    )
    p.add_argument("tracksInfo", help="tracks XML config file")
    p.add_argument("trainingBed", help="training regions BED")
    p.add_argument("outputModel", help="output model path (.npz)")
    p.add_argument("--supervised", action="store_true",
                   help="train from the BED name column (state labels)")
    p.add_argument("--numStates", type=int, default=2,
                   help="number of states for unsupervised EM")
    p.add_argument("--iter", type=int, default=100,
                   help="maximum EM iterations")
    p.add_argument("--emThresh", type=float, default=0.001,
                   help="EM convergence threshold on delta log-likelihood")
    p.add_argument("--flatEm", action="store_true",
                   help="flat (uniform) emission initialization")
    p.add_argument("--emRandRange", default="0.1,0.9",
                   help="random emission init range lo,hi")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--reps", type=int, default=1,
                   help="random restarts; best final loglik wins.  They "
                        "share one staged batch unless --deviceLoop is "
                        "given (then they run one after another)")
    p.add_argument("--numThreads", type=int, default=1,
                   help="accepted for reference compatibility; restarts "
                        "run on the one device")
    p.add_argument("--initTransProbs", default=None,
                   help="transition prior text file (init values)")
    p.add_argument("--fixTrans", action="store_true",
                   help="freeze transitions at their initial values")
    p.add_argument("--forceTransProbs", default=None,
                   help="transition text file applied after every M-step")
    p.add_argument("--initEmProbs", default=None,
                   help="emission prior text file (init values)")
    p.add_argument("--fixEm", action="store_true",
                   help="freeze emissions at their initial values")
    p.add_argument("--forceEmProbs", default=None,
                   help="emission text file applied after every M-step")
    p.add_argument("--segment", action="store_true",
                   help="training BED contains segment-tracks output: "
                        "one observation per segment interval "
                        "(reference: teHmmTrain.py --segment)")
    p.add_argument("--segLen", action="store_true",
                   help="with --segment: weight each segment's emission "
                        "log-probability by its base length "
                        "(reference: effectiveSegmentLength scaling)")
    p.add_argument("--chunk", type=int, default=1 << 14,
                   help="EM chunk length (positions per sequence)")
    p.add_argument("--checkpoint", default=None,
                   help="periodic checkpoint path")
    p.add_argument("--checkpointEvery", type=int, default=10)
    p.add_argument("--deviceLoop", action="store_true",
                   help="run the whole EM loop over the whole batch "
                        "without per-iteration logging or checkpoints "
                        "(see ops/em.em_run)")
    p.add_argument("--initModel", default=None,
                   help="resume EM from a saved model instead of a fresh "
                        "initialization")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    add_logging_options(p)
    up.add_unported(p, UNPORTED)
    return p


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    up.reject_unported(opts, UNPORTED)
    set_logging_from_options(opts)
    device = resolve_device(opts.device)
    metrics = JsonlMetrics(opts.logJson)

    track_list = TrackList(opts.tracksInfo)
    # training regions: merged span of the BED (reference:
    # getMergedBedIntervals over the training file)
    regions = get_merged_bed_intervals(opts.trainingBed)
    logger.info("loading %d tracks over %d regions",
                len(track_list), len(regions))
    if opts.segment and opts.supervised:
        raise SystemExit("--segment is an EM-mode option; combine the "
                         "segments with labels via --supervised training "
                         "on base-resolution data instead")
    init_model = None
    init_maps = None
    if opts.initModel and not opts.supervised:
        # resume: symbols come from the saved model's category maps (new
        # values map to missing, as at eval time)
        init_model = MultitrackHmm.load(opts.initModel, device)
        init_maps = init_model.category_maps
    seg_tables = None
    if opts.segment:
        seg_ivs = read_bed_intervals(opts.trainingBed, ncol=3)
        track_data, seg_tables = load_segment_data(
            track_list, seg_ivs, category_maps=init_maps
        )
        logger.info("segment mode: %d segments in %d chains",
                    sum(len(t) for t in seg_tables), len(seg_tables))
    else:
        track_data = load_track_data(track_list, regions,
                                     category_maps=init_maps)
    if opts.supervised:
        labeled = read_bed_intervals(opts.trainingBed, ncol=4)
        model = MultitrackHmm.supervised(track_data, labeled, device)
    else:
        model = _train_unsupervised(opts, track_data, metrics, device,
                                    init_model, seg_tables)
    model.save(opts.outputModel)
    logger.info("saved model to %s", opts.outputModel)
    metrics.close()
    return 0


def _train_unsupervised(opts, track_data, metrics, device,
                        init_model=None, seg_tables=None) -> MultitrackHmm:
    trans_paths = [
        p for p in (opts.initTransProbs, opts.forceTransProbs) if p
    ]
    em_paths = [p for p in (opts.initEmProbs, opts.forceEmProbs) if p]
    state_names = priors_io.collect_state_names(trans_paths, em_paths)
    n_states = max(opts.numStates, len(state_names))
    # auto-fill the remaining states with numeric names, skipping any
    # number a prior file already used as a state name (a duplicate
    # would land the priors on the wrong rows)
    used = set(state_names)
    next_i = 0
    while len(state_names) < n_states:
        if str(next_i) not in used:
            state_names.append(str(next_i))
            used.add(str(next_i))
        next_i += 1

    init = "flat" if opts.flatEm else "random"
    rand_range = tuple(float(x) for x in opts.emRandRange.split(","))
    if init_model is not None:
        model = init_model
        state_names = model.state_names
        n_states = model.num_states
        _apply_init_priors(opts, model, track_data, state_names)
    else:
        model = _init_model(opts, track_data, state_names, n_states, init,
                            opts.seed, rand_range, device)
    masks = _build_masks(opts, model, track_data, state_names, device)
    tables = seg_tables if seg_tables is not None else track_data.tables
    weights = None
    if seg_tables is not None and opts.segLen:
        weights = [t.lengths.astype(np.float32) for t in seg_tables]

    n_reps = max(1, opts.reps)
    if n_reps > 1 and opts.deviceLoop:
        logger.warning(
            "--reps %d with --deviceLoop runs restarts one after another "
            "(R x wall-clock); drop --deviceLoop to share one staged "
            "batch", n_reps,
        )
    if n_reps > 1 and not opts.deviceLoop:
        rep_models = [model] + [
            _init_model(opts, track_data, state_names, n_states, "random",
                        opts.seed + rep, rand_range, device)
            for rep in range(1, n_reps)
        ]
        best_idx, results = fit_restarts(
            rep_models, tables, max_iterations=opts.iter,
            convergence_tol=opts.emThresh, masks=masks,
            chunk_len=opts.chunk, metrics=metrics,
            obs_weight_arrays=weights,
        )
        for rep, res in enumerate(results):
            logger.info(
                "rep %d: loglik %.4f after %d iters (converged=%s)",
                rep, res.logliks[-1] if res.logliks else -np.inf,
                res.iterations, res.converged,
            )
        if opts.checkpoint:
            rep_models[best_idx].save(opts.checkpoint)
        return rep_models[best_idx]

    best = None
    for rep in range(n_reps):
        rep_model = model
        if rep > 0:
            # a random restart with the same init priors re-applied, so
            # the masks pin the user's values, not random ones
            rep_model = _init_model(opts, track_data, state_names, n_states,
                                    "random", opts.seed + rep, rand_range,
                                    device)
        result = rep_model.fit(
            tables, max_iterations=opts.iter,
            convergence_tol=opts.emThresh, masks=masks,
            chunk_len=opts.chunk, metrics=metrics,
            checkpoint_path=opts.checkpoint,
            checkpoint_every=opts.checkpointEvery,
            obs_weight_arrays=weights, device_loop=opts.deviceLoop,
        )
        final = result.logliks[-1] if result.logliks else -np.inf
        logger.info("rep %d: loglik %.4f after %d iters (converged=%s)",
                    rep, final, result.iterations, result.converged)
        if best is None or final > best[0]:
            best = (final, rep_model)
    return best[1]


def _init_model(opts, track_data, state_names, n_states, init, seed,
                rand_range, device) -> MultitrackHmm:
    """Fresh model + init priors, shared by rep 0 and random restarts."""
    if opts.initEmProbs:
        # grow the category maps from the prior file first, so the fresh
        # emission init normalizes over the final alphabet
        priors_io.read_em_prior(
            opts.initEmProbs, state_names, track_data.track_list,
            track_data.category_maps,
        )
    model = MultitrackHmm.initialized(
        n_states, track_data, device, init=init, seed=seed,
        rand_range=rand_range, state_names=state_names,
    )
    if track_data.gauss_track_indices:
        model.gauss = init_gauss(
            n_states, [t.values for t in track_data.tables], device,
            seed=seed,
        )
    _apply_init_priors(opts, model, track_data, state_names)
    return model


def _apply_init_priors(opts, model, track_data, state_names) -> None:
    """Apply --initTransProbs / --initEmProbs onto the model IN PLACE,
    keeping every parameter the prior files do not name."""
    device = model.params.device
    if opts.initTransProbs:
        prior = priors_io.read_trans_prior(opts.initTransProbs,
                                           state_names)
        trans = priors_io.prior_to_init(prior)
        model.params = HmmParams(
            log_start=model.params.log_start,
            log_trans=torch.tensor(
                np.log(np.maximum(trans, 1e-300)), dtype=torch.float32,
                device=device,
            ),
            log_em=model.params.log_em,
        )
    if opts.initEmProbs:
        prior = priors_io.read_em_prior(
            opts.initEmProbs, state_names, track_data.track_list,
            track_data.category_maps,
        )
        # keep the current emissions, padding the symbol axis if the
        # prior grew an alphabet; named entries overwrite and the other
        # real symbols renormalize to the leftover mass
        sizes = track_data.alphabet_sizes
        log_em = model.params.log_em.cpu().numpy()
        if log_em.shape[2] < prior.shape[2]:
            # the new symbol was never seen by the states the file does
            # not name: its column carries ~zero probability (LOG_ZERO,
            # not 0.0, which would be a phantom unit of mass)
            pad = prior.shape[2] - log_em.shape[2]
            log_em = np.pad(log_em, ((0, 0), (0, 0), (0, pad)),
                            constant_values=LOG_ZERO)
        log_em = em_ops._apply_force_em(
            torch.from_numpy(apply_emission_conventions(log_em, sizes)),
            torch.from_numpy(np.asarray(prior[:, :, : log_em.shape[2]],
                                        np.float32)),
            sizes,
        )
        model.params = HmmParams(
            log_start=model.params.log_start,
            log_trans=model.params.log_trans,
            log_em=log_em.to(device),
        )


def _check_force_mass(table: np.ndarray, path: str) -> None:
    """Forced probabilities in any row must not exceed 1 (the free
    entries' scale would go negative and clamp to ~0 silently)."""
    forced = np.where(np.asarray(table) >= 0.0, table, 0.0)
    mass = forced.sum(axis=-1)
    if (mass > 1.0 + 1e-4).any():
        raise SystemExit(
            f"{path}: forced probabilities sum to "
            f"{float(mass.max()):.4f} > 1 in at least one row"
        )


def _build_masks(opts, model, track_data, state_names, device):
    fix_trans = force_trans = fix_em = force_em = None
    S = model.num_states
    if opts.fixTrans:
        fix_trans = torch.ones((S,), dtype=torch.bool, device=device)
    if opts.fixEm:
        fix_em = torch.ones((S,), dtype=torch.bool, device=device)
    if opts.forceTransProbs:
        ft = priors_io.read_trans_prior(opts.forceTransProbs, state_names)
        _check_force_mass(ft, opts.forceTransProbs)
        force_trans = torch.tensor(np.asarray(ft, np.float32),
                                   device=device)
    if opts.forceEmProbs:
        prior = priors_io.read_em_prior(
            opts.forceEmProbs, state_names, track_data.track_list,
            track_data.category_maps, update_maps=False,
        )
        _check_force_mass(prior, opts.forceEmProbs)
        V = model.params.max_symbols
        if prior.shape[2] < V:
            prior = np.pad(prior, ((0, 0), (0, 0), (0, V - prior.shape[2])),
                           constant_values=-1.0)
        force_em = torch.tensor(np.asarray(prior[:, :, :V], np.float32),
                                device=device)
    if any(x is not None for x in (fix_trans, force_trans, fix_em,
                                   force_em)):
        return em_ops.ParamMasks(
            fix_trans_rows=fix_trans, fix_em_states=fix_em,
            force_trans=force_trans, force_em=force_em,
        )
    return None


if __name__ == "__main__":
    sys.exit(main())
