"""Zero-argument console-script entry points of the port.

Counterpart of ``tehmm_tpu/entrypoints.py``, with the same names, each
over the port's dispatcher (``tehmm_tpu_torch.__main__``): ``te_hmm_train``
runs ``tehmm_tpu_torch.cli.train``, ``add_bed_gaps`` the ``bed-tools
add-gaps`` subtool, and so on (the reference's script names: SURVEY.md
§2b, docs/MIGRATION.md).  ``tehmm`` is the single dispatcher, identical
to ``python -m tehmm_tpu_torch``.  The port runs from its checkout, so
no packaging file registers these; the tools that are not ported yet
exit naming their ROADMAP item.
"""

from __future__ import annotations

import sys


def _dispatch(tool: str, *pre: str):
    """-> zero-arg callable running ``<tool> *pre sys.argv[1:]``."""

    def run() -> int:
        from tehmm_tpu_torch.__main__ import load_tool

        mod = load_tool(tool)
        return mod.main([*pre, *sys.argv[1:]])

    return run


def tehmm() -> int:
    from tehmm_tpu_torch.__main__ import main

    return main()


te_hmm_train = _dispatch("train")
te_hmm_eval = _dispatch("eval")
te_hmm_view = _dispatch("view")
te_hmm_benchmark = _dispatch("benchmark")
segment_tracks = _dispatch("segment-tracks")
set_track_scaling = _dispatch("set-track-scaling")
track_dump = _dispatch("track-dump")
compare_bed_states = _dispatch("compare-bed-states")
fit_state_names = _dispatch("fit-state-names")
add_bed_gaps = _dispatch("bed-tools", "add-gaps")
add_bed_colors = _dispatch("bed-tools", "add-colors")
remove_bed_overlaps = _dispatch("bed-tools", "remove-overlaps")
chunk_bed_regions = _dispatch("bed-tools", "chunk")
bed_stats = _dispatch("bed-tools", "stats")
tsd_finder = _dispatch("tsd-finder")
add_tsd_track = _dispatch("add-tsd-track")
track_ranking = _dispatch("track-ranking")
clean_rm = _dispatch("clean-external", "clean-rm")
clean_ltr_finder_id = _dispatch("clean-external", "clean-ltr")
