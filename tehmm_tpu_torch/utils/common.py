"""Shared constants and logging helpers.

The port's own copy of ``tehmm_tpu/utils/common.py``; its logger is
``tehmm_tpu_torch``.

Counterpart of the reference's ``common.py`` (EPSILON smoothing constant,
``addLoggingOptions``/``setLoggingFromOptions``, safe-log helpers) — see
SURVEY.md §2a "Shared utilities".  The TPU rebuild additionally defines a
finite "log zero" so that parameter tables never hold IEEE ``-inf`` (an
``-inf`` entry multiplied by a one-hot zero in the MXU emission matmul would
produce NaN; a large negative finite value behaves identically in max-plus
and exp() while staying NaN-safe).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

# Pseudo-count smoothing floor used when normalizing EM sufficient statistics
# (reference: common.py EPSILON).
EPSILON = 1e-10

# Finite stand-in for log(0).  exp(LOG_ZERO) == 0.0 in float32 (underflow),
# max-plus treats it as -inf for any realistic score, and 0.0 * LOG_ZERO == 0
# (unlike 0 * -inf == NaN) so it is safe inside one-hot matmuls.
LOG_ZERO = -1e30

logger = logging.getLogger("tehmm_tpu_torch")


def add_logging_options(parser: argparse.ArgumentParser) -> None:
    """Reference-compatible logging flags (``--logLevel``, ``--logFile``)."""
    group = parser.add_argument_group("logging")
    group.add_argument(
        "--logLevel",
        default="warning",
        help="Logging level: debug, info, warning, error, critical "
        "(default: warning)",
    )
    group.add_argument(
        "--logFile", default=None, help="Write log messages to this file"
    )
    group.add_argument(
        "--logJson",
        default=None,
        help="Write structured JSONL metrics (iter, loglik, wall, cells/s) "
        "to this file (rebuild extension; SURVEY.md §5 metrics/logging)",
    )


def set_logging_from_options(options: argparse.Namespace) -> None:
    name = str(options.logLevel).upper()
    level = getattr(logging, name, None)
    if not isinstance(level, int):
        # a typo like --logLevel=debgu would otherwise silently run at
        # WARNING with the user wondering where their debug output went
        raise SystemExit(
            f"unknown --logLevel {options.logLevel!r} (use debug, "
            f"info, warning, error, or critical)"
        )
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if getattr(options, "logFile", None):
        handlers.append(logging.FileHandler(options.logFile))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )
    logger.setLevel(level)


class JsonlMetrics:
    """Structured per-iteration metric sink (JSONL, one object per line)."""

    def __init__(self, path: str | None):
        self._fh = open(path, "a") if path else None

    def write(self, **fields) -> None:
        if self._fh is None:
            return
        fields.setdefault("ts", time.time())
        self._fh.write(json.dumps(fields) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
