"""tehmm-eval on the port: Viterbi or max-posterior decoding to BED,
posterior distributions, and the data's log-likelihood.

Counterpart of ``tehmm_tpu/cli/eval.py`` for HMM models, with
categorical and gaussian tracks: category maps and track semantics come
FROM THE MODEL so symbols match training; the eval-time XML supplies data
paths only.

- ``--bed``: Viterbi annotation (stitched, or ``--exact``), printing the
  decoded path's joint log-probability (reference behavior);
- ``--bed --maxPost``: max-posterior annotation (stitched, or
  ``--exact``);
- ``--pd``: per-position posterior distributions, streamed from the
  exact chunk sweep through per-chunk spool files;
- every mode but Viterbi, and a run with no ``--bed``, prints the
  forward log-likelihood of the whole input (``MultitrackHmm.score``);
- ``--segment`` (the query BED is ``segment_tracks`` output): the same
  modes at segment resolution, one observation per segment, with
  ``--segLen`` each segment's emission raised to the power of its length;
  paths expand back to base-space BED and ``--pd`` writes one row per
  segment.

``--maxSpan`` and ``--mesh`` are recognized and exit naming their
ROADMAP item.

Usage:
  python -m tehmm_tpu_torch.cli.eval tracks.xml model.npz query.bed \
      [--bed out.bed [--maxPost]] [--pd post.bed] [--segment [--segLen]] \
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

import numpy as np

from tehmm_tpu_torch.io import (
    TrackList,
    load_track_data,
    read_bed_intervals,
    write_bed_intervals,
)
from tehmm_tpu_torch.io.segments import expand_path, load_segment_data
from tehmm_tpu_torch.utils.common import (
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
from tehmm_tpu_torch.parallel.stitch import (
    posterior_exact,
    posterior_sweep,
    viterbi_chunked,
    viterbi_exact,
)
from tehmm_tpu_torch.utils.device import resolve_device

UNPORTED = {
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
        description="Viterbi/posterior decoding of genomic regions "
                    "(PyTorch port)",
    )
    p.add_argument("tracksInfo", help="tracks XML config file")
    p.add_argument("inputModel", help="trained model (.npz)")
    p.add_argument("bedRegions", help="query regions BED")
    p.add_argument("--bed", default=None,
                   help="write Viterbi annotations to this BED file "
                        "(without it, and without --pd, eval only prints "
                        "the data's log-likelihood)")
    p.add_argument("--maxPost", action="store_true",
                   help="max-posterior decoding instead of Viterbi")
    p.add_argument("--pd", default=None,
                   help="write per-position posterior distribution BED")
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
    p.add_argument("--segment", action="store_true",
                   help="query BED contains segment-tracks output: one "
                        "observation per segment (reference: teHmmEval "
                        "--segment)")
    p.add_argument("--segLen", action="store_true",
                   help="with --segment: length-weighted emissions "
                        "(must match training)")
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
    if opts.segment:
        _track_data, seg_tables = load_segment_data(
            eval_list, regions, category_maps=model.category_maps
        )
        _resolve_exact(opts, seg_tables)
        return _eval_segments(opts, model, seg_tables)
    track_data = load_track_data(
        eval_list, regions, category_maps=model.category_maps
    )
    tables = track_data.tables
    _resolve_exact(opts, tables)

    paths = None
    if opts.bed:
        if opts.maxPost:
            if opts.exact:
                paths = posterior_exact(model.params, tables,
                                        chunk_len=opts.chunk,
                                        gauss_params=model.gauss)
            else:
                paths = model.posterior_decode_tables(
                    tables, chunk_len=opts.chunk, halo=opts.halo
                )
        elif opts.exact:
            paths = viterbi_exact(model.params, tables, chunk_len=opts.chunk,
                                  gauss_params=model.gauss)
        else:
            paths, report = model.decode_tables(
                tables, chunk_len=opts.chunk, halo=opts.halo
            )
            logger.info(
                "decoded %d chunks (halo %d, retries %d, boundaries ok=%s)",
                report.n_chunks, report.final_halo, report.retries,
                report.boundaries_ok,
            )

    # printed score (reference behavior): the Viterbi path's joint
    # log-prob, from the host; every other mode prints the forward
    # log-likelihood of the whole input
    if paths is not None and not opts.maxPost:
        total_ll = sum(
            path_log_score(model.params, tab.symbols, p, gauss=model.gauss,
                           values=tab.values)
            for tab, p in zip(tables, paths)
        )
    else:
        total_ll = model.score(tables, chunk_len=opts.chunk)
    print(f"{total_ll}")

    if opts.bed:
        out = []
        for tab, path in zip(tables, paths):
            out.extend(path_to_intervals(
                tab.chrom, tab.start, np.asarray(path), model.state_names,
            ))
        write_bed_intervals(out, opts.bed)
        logger.info("wrote %d intervals to %s", len(out), opts.bed)
    if opts.pd:
        _write_pd_streaming(opts, model, tables)
    return 0


def _write_pd_streaming(opts, model, tables) -> None:
    """--pd at base resolution in bounded host memory: gamma chunks come
    out of the exact chunk sweep in REVERSE time order into per-chunk
    spool files (beside the output), concatenated in order at the end.
    One line per base: chrom, start, end, the S probabilities as %.6g."""
    tmpdir = tempfile.mkdtemp(
        prefix="tehmm_pd_", dir=os.path.dirname(os.path.abspath(opts.pd))
    )
    spool: dict[tuple[int, int], str] = {}
    try:
        def consume(b, start, gamma):
            tab = tables[b]
            fn = os.path.join(tmpdir, f"{b}_{start}.part")
            base = tab.start + start
            with open(fn, "w") as fh:
                for i, row in enumerate(gamma.tolist()):
                    probs = ",".join(f"{p:.6g}" for p in row)
                    fh.write(f"{tab.chrom}\t{base + i}\t{base + i + 1}"
                             f"\t{probs}\n")
            spool[(b, start)] = fn

        posterior_sweep(model.params, tables, chunk_len=opts.chunk,
                        consume=consume, gauss_params=model.gauss)
        with open(opts.pd, "w") as out_fh:
            for key in sorted(spool):
                with open(spool[key]) as fh:
                    shutil.copyfileobj(fh, out_fh)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _eval_segments(opts, model, seg_tables) -> int:
    """Segment-resolution decode: Viterbi (default), max-posterior
    (``--maxPost``), or posterior distributions (``--pd``) over
    per-segment observations, expanded back to base-space BED; the
    printed score has the base-resolution semantics (the Viterbi path's
    joint log-prob, else the forward log-likelihood), with the segment
    weights under ``--segLen``."""
    weights = None
    if opts.segLen:
        weights = [t.lengths.astype(np.float32) for t in seg_tables]
    dists = None
    if opts.pd:
        dists = model.posterior_distributions(
            seg_tables, chunk_len=opts.chunk, weight_arrays=weights,
        )
    paths = None
    if opts.bed and opts.maxPost:
        if dists is not None:
            # --pd computed the exact posteriors: the path is their argmax
            paths = [np.argmax(d, axis=-1).astype(np.int32) for d in dists]
        elif opts.exact:
            paths = posterior_exact(
                model.params, seg_tables, chunk_len=opts.chunk,
                gauss_params=model.gauss, weight_arrays=weights,
            )
        else:
            paths = model.posterior_decode_tables(
                seg_tables, chunk_len=opts.chunk, halo=opts.halo,
                weight_arrays=weights,
            )
    elif opts.bed and opts.exact:
        paths = viterbi_exact(
            model.params, seg_tables, chunk_len=opts.chunk,
            gauss_params=model.gauss, weight_arrays=weights,
        )
    elif opts.bed:
        paths, report = viterbi_chunked(
            model.params, seg_tables, chunk_len=opts.chunk, halo=opts.halo,
            weight_arrays=weights, gauss_params=model.gauss,
        )
        logger.info("segment decode: %d chunks, boundaries ok=%s",
                    report.n_chunks, report.boundaries_ok)
    if dists is not None:
        rows = []
        for tab, pd in zip(seg_tables, dists):
            for i, row in enumerate(pd.tolist()):
                rows.append((
                    tab.chrom, int(tab.seg_bounds[i]),
                    int(tab.seg_bounds[i + 1]),
                    ",".join(f"{p:.6g}" for p in row),
                ))
        write_bed_intervals(rows, opts.pd)
    if opts.bed:
        out = []
        for tab, path in zip(seg_tables, paths):
            out.extend(expand_path(tab, path, model.state_names))
        write_bed_intervals(out, opts.bed)
        logger.info("wrote %d intervals to %s", len(out), opts.bed)
    if paths is not None and not opts.maxPost:
        total = sum(
            path_log_score(
                model.params, tab.symbols, p, gauss=model.gauss,
                values=tab.values,
                obs_weights=None if weights is None else weights[i],
            )
            for i, (tab, p) in enumerate(zip(seg_tables, paths))
        )
    else:
        total = model.score(seg_tables, chunk_len=opts.chunk,
                            weight_arrays=weights)
    print(f"{total}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
