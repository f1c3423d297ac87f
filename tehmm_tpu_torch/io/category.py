"""CategoryMap: raw track values ↔ small-integer symbols.

Rebuild of the reference's ``CategoryMap`` (reference: track.py; SURVEY.md
§2a): a bidirectional map from raw per-position track values (strings or
binned numbers) to contiguous integer symbols, with symbol 0 reserved for
*missing/unannotated* positions.  The map built at training time is saved
with the model and REQUIRED at eval time so symbols line up (SURVEY.md
§3.2 ★ note).

Numeric binning semantics (``scale`` / ``logScale`` / ``shift`` track
attributes, reference: track.py + setTrackScaling.py):

    v' = v + shift                  (shift defaults to 0)
    key = floor(v' * scale)         if scale set
    key = floor(log(max(v', 1e-9)) / log(logScale))   if logScale set
    key = v' as-is (string form)    otherwise

``scale`` and ``logScale`` are mutually exclusive.  The reference mount
was empty at survey time, so the exact rounding mode is reconstructed
[R?]; floor is used consistently here and documented as this framework's
contract (setTrackScaling picks parameters so results fit the alphabet
budget either way).
"""

from __future__ import annotations

import math
from typing import Any

MISSING_SYMBOL = 0


class CategoryMap:
    """Bidirectional value <-> int symbol map; 0 = missing."""

    def __init__(self, reserved: int = 1):
        self._to_int: dict[str, int] = {}
        self._to_val: dict[int, str] = {}
        self._reserved = reserved  # symbols [0, reserved) are special

    @property
    def missing(self) -> int:
        return MISSING_SYMBOL

    def __len__(self) -> int:
        """Alphabet size INCLUDING the reserved missing symbol."""
        return len(self._to_int) + self._reserved

    def get_map(self, val: Any, update: bool = False) -> int:
        """Value -> symbol.  Unknown values map to `missing` unless
        ``update`` (training-time) is set, which assigns the next free
        symbol (reference: CategoryMap.getMap(update=...))."""
        key = self._key(val)
        if key is None:
            return MISSING_SYMBOL
        got = self._to_int.get(key)
        if got is not None:
            return got
        if not update:
            return MISSING_SYMBOL
        sym = len(self._to_int) + self._reserved
        self._to_int[key] = sym
        self._to_val[sym] = key
        return sym

    def get_back_map(self, sym: int) -> str | None:
        """Symbol -> original value key (None for missing/unknown)."""
        return self._to_val.get(int(sym))

    @staticmethod
    def _key(val: Any) -> str | None:
        if val is None:
            return None
        return str(val)

    # ------------------------------------------------------------------
    # serialization (model sidecar)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"reserved": self._reserved, "map": dict(self._to_int)}

    @classmethod
    def from_dict(cls, d: dict) -> "CategoryMap":
        cm = cls(reserved=int(d.get("reserved", 1)))
        for key, sym in d["map"].items():
            cm._to_int[key] = int(sym)
            cm._to_val[int(sym)] = key
        return cm


def bin_value(
    val: Any,
    scale: float | None = None,
    log_scale: float | None = None,
    shift: float | None = None,
) -> Any:
    """Apply the reference's numeric binning (see module docstring).

    With no scale/logScale the value passes through as a categorical
    key (shift-only applies the offset WITHOUT flooring — flooring
    would lossily merge distinct categories just because an offset was
    configured); with scale/logScale it becomes an int bin.
    """
    if scale is None and log_scale is None and shift is None:
        return val
    v = float(val) + (shift or 0.0)
    if scale is not None and log_scale is not None:
        raise ValueError("scale and logScale are mutually exclusive")
    if scale is not None:
        return math.floor(v * scale)
    if log_scale is not None:
        return math.floor(math.log(max(v, 1e-9)) / math.log(log_scale))
    # shift only: keep the full-precision shifted value as the key
    # (int-valued floats print without the trailing .0 for stability)
    return int(v) if v == int(v) else v
