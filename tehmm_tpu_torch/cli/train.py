"""tehmm-train on the port: supervised training only.

Counterpart of ``tehmm_tpu/cli/train.py`` for ``--supervised``: the
state of every position is the name column of the training BED, counts
are taken on the host and the M-step runs on ``--device``.  Every other
mode of the JAX CLI is recognized and exits naming its ROADMAP item.

Usage:
  python -m tehmm_tpu_torch.cli.train tracks.xml training.bed out.npz \
      --supervised [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

from tehmm_tpu.io import TrackList, load_track_data, read_bed_intervals
from tehmm_tpu.io.bed import get_merged_bed_intervals
from tehmm_tpu.utils.common import (
    add_logging_options,
    logger,
    set_logging_from_options,
)
from tehmm_tpu_torch.cli import unported as up
from tehmm_tpu_torch.models.hmm import MultitrackHmm
from tehmm_tpu_torch.utils.device import resolve_device

UNPORTED = {
    "--numStates": (True, up.SLICE_EM),
    "--iter": (True, up.SLICE_EM),
    "--emThresh": (True, up.SLICE_EM),
    "--flatEm": (False, up.SLICE_EM),
    "--emRandRange": (True, up.SLICE_EM),
    "--seed": (True, up.SLICE_EM),
    "--reps": (True, up.SLICE_EM),
    "--numThreads": (True, up.SLICE_EM),
    "--chunk": (True, up.SLICE_EM),
    "--deviceLoop": (False, up.SLICE_EM),
    "--initModel": (True, up.SLICE_EM),
    "--checkpoint": (True, up.SLICE_EM),
    "--checkpointEvery": (True, up.SLICE_EM),
    "--initTransProbs": (True, up.SLICE_EM),
    "--fixTrans": (False, up.SLICE_EM),
    "--forceTransProbs": (True, up.SLICE_EM),
    "--initEmProbs": (True, up.SLICE_EM),
    "--fixEm": (False, up.SLICE_EM),
    "--forceEmProbs": (True, up.SLICE_EM),
    "--cfg": (False, up.SLICE_CFG),
    "--pairStates": (True, up.SLICE_CFG),
    "--maxSpan": (True, up.SLICE_CFG),
    "--matchBonus": (True, up.SLICE_CFG),
    "--cfgEm": (True, up.SLICE_CFG),
    "--saPrior": (True, up.SLICE_CFG),
    "--segment": (False, up.SLICE_SEGMENT),
    "--segLen": (False, up.SLICE_SEGMENT),
    "--mesh": (True, up.SLICE_SHARDING),
    "--coordinatorAddress": (True, up.SLICE_SHARDING),
    "--numProcesses": (True, up.SLICE_SHARDING),
    "--processId": (True, up.SLICE_SHARDING),
    "--profile": (True, up.SLICE_TOOLS),
}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tehmm-train (torch)",
        description="Supervised training of a multi-track HMM on genomic "
                    "annotation tracks (PyTorch port)",
    )
    p.add_argument("tracksInfo", help="tracks XML config file")
    p.add_argument("trainingBed", help="training regions BED")
    p.add_argument("outputModel", help="output model path (.npz)")
    p.add_argument("--supervised", action="store_true",
                   help="train from the BED name column (state labels); "
                        "required: unsupervised EM is not ported yet")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    add_logging_options(p)
    up.add_unported(p, UNPORTED)
    return p


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    up.reject_unported(opts, UNPORTED)
    if not opts.supervised:
        raise SystemExit(
            f"unsupervised EM is not ported to tehmm_tpu_torch yet "
            f"({up.SLICE_EM}); pass --supervised"
        )
    set_logging_from_options(opts)
    device = resolve_device(opts.device)

    track_list = TrackList(opts.tracksInfo)
    # training regions: merged span of the BED (reference:
    # getMergedBedIntervals over the training file)
    regions = get_merged_bed_intervals(opts.trainingBed)
    logger.info("loading %d tracks over %d regions",
                len(track_list), len(regions))
    track_data = load_track_data(track_list, regions)
    labeled = read_bed_intervals(opts.trainingBed, ncol=4)
    model = MultitrackHmm.supervised(track_data, labeled, device)
    model.save(opts.outputModel)
    logger.info("saved model to %s", opts.outputModel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
