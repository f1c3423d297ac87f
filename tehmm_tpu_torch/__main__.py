"""Unified CLI dispatcher: ``python -m tehmm_tpu_torch <tool> [args...]``.

Counterpart of ``tehmm_tpu/__main__.py``, with the same tool names, help
text and exit codes.  Maps reference-style tool names onto the port's cli
submodules, e.g.

    python -m tehmm_tpu_torch train tracks.xml labels.bed model.npz \\
        --supervised
    python -m tehmm_tpu_torch compare-bed-states truth.bed pred.bed

Every tool that runs device code takes ``--device`` (``cuda`` unless
``--device cpu`` is given).  The tools mapped to None are not ported yet
and exit naming their ROADMAP item.
"""

from __future__ import annotations

import importlib
import sys

from tehmm_tpu_torch.cli.unported import SLICE_TOOLS

TOOLS = {
    "train": "tehmm_tpu_torch.cli.train",
    "eval": "tehmm_tpu_torch.cli.eval",
    "view": "tehmm_tpu_torch.cli.view",
    "benchmark": "tehmm_tpu_torch.cli.benchmark",
    "compare-bed-states": "tehmm_tpu_torch.cli.compare_bed_states",
    "fit-state-names": "tehmm_tpu_torch.cli.fit_state_names",
    "segment-tracks": "tehmm_tpu_torch.cli.segment_tracks",
    "set-track-scaling": "tehmm_tpu_torch.cli.set_track_scaling",
    "track-dump": "tehmm_tpu_torch.cli.track_dump",
    "bed-tools": "tehmm_tpu_torch.cli.bed_tools",
    "tsd-finder": None,
    "add-tsd-track": None,
    "track-ranking": "tehmm_tpu_torch.cli.track_ranking",
    "clean-external": "tehmm_tpu_torch.cli.clean_external",
    "import-model": None,
}


def load_tool(tool: str):
    """The cli module of ``tool``; exits naming the ROADMAP item of a
    tool that is not ported yet."""
    mod_name = TOOLS[tool]
    if mod_name is None:
        raise SystemExit(
            f"{tool} is not ported to tehmm_tpu_torch yet ({SLICE_TOOLS})"
        )
    return importlib.import_module(mod_name)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m tehmm_tpu_torch <tool> [args...]\n\ntools:")
        for name in sorted(TOOLS):
            print(f"  {name}")
        return 0 if argv else 2
    tool, *rest = argv
    if tool not in TOOLS:
        print(f"unknown tool {tool!r}; run with --help for the list",
              file=sys.stderr)
        return 2
    mod = load_tool(tool)
    try:
        rc = mod.main(rest)
        # flush HERE so a tail still sitting in the stdout buffer when
        # a pager closed the pipe raises where this handler can catch
        # it (interpreter-shutdown flush would print an ignored-
        # exception message and exit 120 instead)
        sys.stdout.flush()
        return rc
    except BrokenPipeError:
        # downstream pager/head closed the pipe (e.g. `view m | head`)
        # — no traceback, and exit 141 (128+SIGPIPE, the Unix
        # convention) so wrapping scripts can distinguish truncated
        # from complete output.  Redirect stdout to devnull so the
        # interpreter's exit-time flush cannot re-raise.
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
        return 141


if __name__ == "__main__":
    sys.exit(main())
