"""Transition / emission prior text files (semi-supervised interface).

Rebuild of the reference's user-prior files (reference: hmm.py
applyUserTrans/applyUserEmission parsing text files passed to
teHmmTrain.py --initTransProbs / --initEmProbs / --forceTransProbs /
--forceEmProbs; SURVEY.md §2b, §5 "Config / flags": these formats are
part of the observable surface).

Transition file: one row per assignment, whitespace-separated::

    fromStateName  toStateName  probability

Emission file::

    stateName  trackName  symbolValue  probability

Lines starting with '#' are comments.  State names appearing in the files
define/extend the model's state-name table (the reference lets users name
otherwise-anonymous unsupervised states this way).  Probabilities left
unspecified in a row's source state are distributed uniformly over the
remaining mass (handled by ParamMasks/_apply_force semantics in ops.em).
"""

from __future__ import annotations

import numpy as np

from tehmm_tpu_torch.io.category import CategoryMap
from tehmm_tpu_torch.io.trackxml import TrackList


def _read_rows(path: str, n_fields: int) -> list[list[str]]:
    rows = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split()
            if len(fields) != n_fields:
                raise ValueError(
                    f"{path}:{ln}: expected {n_fields} fields, got "
                    f"{len(fields)}: {line!r}"
                )
            rows.append(fields)
    return rows


def collect_state_names(
    trans_paths: list[str], em_paths: list[str],
    existing: list[str] | None = None,
) -> list[str]:
    """All state names mentioned across prior files, in first-seen order,
    appended after any existing names."""
    names = list(existing or [])
    seen = set(names)

    def add(n: str):
        if n not in seen:
            seen.add(n)
            names.append(n)

    for p in trans_paths:
        for frm, to, _prob in _read_rows(p, 3):
            add(frm)
            add(to)
    for p in em_paths:
        for state, _track, _sym, _prob in _read_rows(p, 4):
            add(state)
    return names


def read_trans_prior(
    path: str, state_names: list[str]
) -> np.ndarray:
    """-> f32[S, S] with specified probabilities at their cells and -1
    (= unspecified) elsewhere."""
    S = len(state_names)
    idx = {n: i for i, n in enumerate(state_names)}
    out = np.full((S, S), -1.0, dtype=np.float32)
    for frm, to, prob in _read_rows(path, 3):
        for name in (frm, to):
            if name not in idx:
                raise ValueError(
                    f"{path}: state {name!r} is not one of the "
                    f"model's states {state_names}"
                )
        out[idx[frm], idx[to]] = float(prob)
    return out


def read_em_prior(
    path: str,
    state_names: list[str],
    track_list: TrackList,
    category_maps: dict[str, CategoryMap],
    update_maps: bool = True,
) -> np.ndarray:
    """-> f32[S, T, V] with specified probabilities set and -1 elsewhere.

    Symbol values are passed through the track's CategoryMap (new values
    get fresh symbols when ``update_maps``, mirroring training-time map
    construction).
    """
    S = len(state_names)
    T = len(track_list)
    sidx = {n: i for i, n in enumerate(state_names)}
    rows = _read_rows(path, 4)
    # ensure symbols exist in maps first so V is final
    for _state, track, sym, _prob in rows:
        tr = track_list.get_track_by_name(track)
        if tr is None:
            raise ValueError(f"{path}: unknown track {track!r}")
        category_maps[track].get_map(tr.bin(sym), update=update_maps)
    V = max(len(category_maps[t.name]) for t in track_list)
    out = np.full((S, T, V), -1.0, dtype=np.float32)
    for state, track, sym, prob in rows:
        if state not in sidx:
            raise ValueError(
                f"{path}: state {state!r} is not one of the model's "
                f"states {state_names}"
            )
        tr = track_list.get_track_by_name(track)
        v = category_maps[track].get_map(tr.bin(sym), update=False)
        if v == 0 and not update_maps:
            # the maps are frozen (resume / force after training) and
            # this value never appeared in the data: get_map returned
            # the MISSING symbol, and the mask application would then
            # silently drop the user's constraint
            raise ValueError(
                f"{path}: symbol value {sym!r} for track {track!r} "
                f"never appeared in the training data — the prior row "
                f"cannot be applied"
            )
        out[sidx[state], tr.number, v] = float(prob)
    return out


def prior_to_init(
    prior: np.ndarray, uniform_rows: bool = True
) -> np.ndarray:
    """Turn a (-1 = unspecified) prior table into a full probability
    table: specified cells keep their value, the remaining mass of each
    row spreads uniformly over unspecified cells (reference
    --initTransProbs semantics)."""
    if prior.ndim != 2:
        raise ValueError("prior_to_init expects a 2-D table")
    rows = prior.copy()
    for i in range(rows.shape[0]):
        row = rows[i]
        spec = row >= 0
        mass = row[spec].sum() if spec.any() else 0.0
        if mass > 1.0 + 1e-4:
            # the --force* path rejects over-unit rows loudly
            # (cli/train._check_force_mass); the init path silently
            # started EM from a non-stochastic matrix
            raise ValueError(
                f"prior row {i}: specified probabilities sum to "
                f"{float(mass):.4f} > 1"
            )
        free = int((~spec).sum())
        fill = max(0.0, 1.0 - mass) / free if free else 0.0
        row[~spec] = fill
    return rows
