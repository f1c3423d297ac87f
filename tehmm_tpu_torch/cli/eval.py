"""tehmm-eval on the port: Viterbi decoding to BED.

Counterpart of ``tehmm_tpu/cli/eval.py`` for ``--bed`` Viterbi
annotation: category maps and track semantics come FROM THE MODEL so
symbols match training; the eval-time XML supplies data paths only.
Prints the decoded path's joint log-probability (reference behavior)
and writes the merged state runs as BED.  Other modes of the JAX CLI
are recognized and exit naming their ROADMAP item.

Usage:
  python -m tehmm_tpu_torch.cli.eval tracks.xml model.npz query.bed \
      --bed out.bed [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from tehmm_tpu.io import (
    TrackList,
    load_track_data,
    read_bed_intervals,
    write_bed_intervals,
)
from tehmm_tpu.utils.common import (
    add_logging_options,
    logger,
    set_logging_from_options,
)
from tehmm_tpu_torch.cli import unported as up
from tehmm_tpu_torch.models.hmm import (
    MultitrackHmm,
    path_log_score,
    path_to_intervals,
)
from tehmm_tpu_torch.parallel.stitch import viterbi_exact
from tehmm_tpu_torch.utils.device import resolve_device

UNPORTED = {
    "--maxPost": (False, up.SLICE_POST),
    "--pd": (True, up.SLICE_POST),
    "--segment": (False, up.SLICE_SEGMENT),
    "--segLen": (False, up.SLICE_SEGMENT),
    "--maxSpan": (True, up.SLICE_CFG),
    "--mesh": (True, up.SLICE_SHARDING),
}

# below this many total positions the sequential exact decoder is
# effectively free — its unconditional exactness is the default there
# (the JAX CLI's rule)
_EXACT_AUTO_LIMIT = 1 << 18


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tehmm-eval (torch)",
        description="Viterbi decoding of genomic regions (PyTorch port)",
    )
    p.add_argument("tracksInfo", help="tracks XML config file")
    p.add_argument("inputModel", help="trained model (.npz)")
    p.add_argument("bedRegions", help="query regions BED")
    p.add_argument("--bed", default=None,
                   help="write Viterbi annotations to this BED file "
                        "(required: scoring alone is not ported yet)")
    p.add_argument("--chunk", type=int, default=4096,
                   help="decode chunk length")
    p.add_argument("--halo", type=int, default=256,
                   help="stitching halo width")
    p.add_argument("--exact", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="use the exact checkpointed chunked decoder "
                        "instead of halo stitching. Default: AUTO — exact "
                        "for inputs of <= 256K positions, stitched beyond; "
                        "--no-exact forces stitching")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    add_logging_options(p)
    up.add_unported(p, UNPORTED)
    return p


def _resolve_exact(opts, tables) -> None:
    if opts.exact is None:
        total = sum(len(t.symbols) for t in tables)
        opts.exact = total <= _EXACT_AUTO_LIMIT
        if opts.exact:
            logger.info(
                "input is small (%d positions) — using the exact "
                "chunked decoder (--no-exact restores stitching)",
                total,
            )


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    up.reject_unported(opts, UNPORTED)
    if opts.bed is None:
        raise SystemExit(
            f"scoring without --bed is not ported to tehmm_tpu_torch yet "
            f"({up.SLICE_POST})"
        )
    set_logging_from_options(opts)
    device = resolve_device(opts.device)

    try:
        model = MultitrackHmm.load(opts.inputModel, device)
    except FileNotFoundError:
        raise SystemExit(f"model file not found: {opts.inputModel}")
    if model.extra.get("cfg"):
        raise SystemExit(
            f"{opts.inputModel} is a pair-grammar (CFG) model, which is "
            f"not ported to tehmm_tpu_torch yet ({up.SLICE_CFG})"
        )
    track_list = TrackList(opts.tracksInfo)
    eval_list = TrackList()
    for t in model.track_list:
        src = track_list.get_track_by_name(t.name)
        if src is None:
            raise SystemExit(
                f"track {t.name!r} required by the model is missing from "
                f"{opts.tracksInfo}"
            )
        eval_list.add(dataclasses.replace(t, path=src.path, number=-1))

    regions = read_bed_intervals(opts.bedRegions, ncol=3)
    track_data = load_track_data(
        eval_list, regions, category_maps=model.category_maps
    )
    _resolve_exact(opts, track_data.tables)
    if opts.exact:
        paths = viterbi_exact(
            model.params, track_data.tables, chunk_len=opts.chunk
        )
    else:
        paths, report = model.decode_tables(
            track_data.tables, chunk_len=opts.chunk, halo=opts.halo
        )
        logger.info(
            "decoded %d chunks (halo %d, retries %d, boundaries ok=%s)",
            report.n_chunks, report.final_halo, report.retries,
            report.boundaries_ok,
        )

    # printed score: the Viterbi path's joint log-prob, from the host
    total_ll = sum(
        path_log_score(model.params, tab.symbols, p)
        for tab, p in zip(track_data.tables, paths)
    )
    print(f"{total_ll}")

    out = []
    for tab, path in zip(track_data.tables, paths):
        out.extend(path_to_intervals(
            tab.chrom, tab.start, np.asarray(path), model.state_names,
        ))
    write_bed_intervals(out, opts.bed)
    logger.info("wrote %d intervals to %s", len(out), opts.bed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
