"""Flags of the JAX package's CLIs that the port does not run yet.

Each is still recognized, so a user's command line fails with the
ROADMAP item that will port it instead of an argparse error (or, worse,
a silently ignored mode).
"""

from __future__ import annotations

import argparse

SLICE_CFG = "ROADMAP Queue 1, slice 5: pair-grammar CFG"
SLICE_SHARDING = "ROADMAP Queue 1, slice 6: sharding"
SLICE_TOOLS = "ROADMAP Queue 1, slice 8: utilities"


def add_unported(parser: argparse.ArgumentParser,
                 flags: dict[str, tuple[bool, str]]) -> None:
    """``flags``: {"--flag": (takes_value, roadmap_item)}."""
    group = parser.add_argument_group(
        "not ported yet (each exits naming its ROADMAP item)"
    )
    for flag, (takes_value, _item) in flags.items():
        if takes_value:
            group.add_argument(flag, default=argparse.SUPPRESS,
                               help=argparse.SUPPRESS)
        else:
            group.add_argument(flag, action="store_true",
                               default=argparse.SUPPRESS,
                               help=argparse.SUPPRESS)


def reject_unported(opts: argparse.Namespace,
                    flags: dict[str, tuple[bool, str]]) -> None:
    """Exit with the ROADMAP item of the first unported flag given."""
    for flag, (_takes_value, item) in flags.items():
        if hasattr(opts, flag.lstrip("-")):
            raise SystemExit(
                f"{flag} is not ported to tehmm_tpu_torch yet ({item})"
            )
