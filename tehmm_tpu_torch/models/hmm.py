"""MultitrackHmm: the user-facing model API (supervised training,
Viterbi decoding, persistence).

Counterpart of part of ``tehmm_tpu/models/hmm.py``: the constructor,
``supervised``, ``decode_tables``, ``decode_to_bed``, ``save`` and
``load``, plus the NumPy helpers ``path_log_score``,
``path_to_intervals``, ``label_tables`` and ``_labeled_runs`` (copied,
because the original module imports JAX).  Supervised counting stays
host-side, through the shared native counters; only the M-step and the
decode touch the device.

Unsupervised EM (``fit``, ``fit_restarts``), posterior decoding,
scoring and gaussian tracks are later slices of the port (ROADMAP,
Queue 1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tehmm_tpu import native
from tehmm_tpu.io.category import CategoryMap
from tehmm_tpu.io.trackdata import TrackData, TrackTable
from tehmm_tpu.io.trackxml import TrackList
from tehmm_tpu.utils.common import EPSILON
from tehmm_tpu_torch.models.params import HmmParams, load_model, save_model
from tehmm_tpu_torch.ops import em as em_ops
from tehmm_tpu_torch.parallel.stitch import StitchReport, viterbi_chunked

_GAUSS_ITEM = (
    "ROADMAP Queue 1, slice 4: gaussian tracks and segment weights"
)


class MultitrackHmm:
    """Multi-track HMM with independent categorical emissions."""

    def __init__(
        self,
        params: HmmParams,
        track_list: TrackList,
        category_maps: dict[str, CategoryMap],
        state_names: list[str] | None = None,
    ):
        self.params = params
        self.track_list = track_list
        self.category_maps = category_maps
        self.extra: dict = {}  # free-form persisted metadata (e.g. cfg)
        S = params.num_states
        self.state_names = state_names or [str(i) for i in range(S)]
        if len(self.state_names) != S:
            raise ValueError(
                f"{len(self.state_names)} state names for {S} states"
            )

    # ------------------------------------------------------------------
    @classmethod
    def supervised(
        cls,
        track_data: TrackData,
        labeled_intervals: Sequence[Sequence],
        device: str | torch.device,
        epsilon: float = EPSILON,
    ) -> "MultitrackHmm":
        """Supervised training: state = BED name column (reference:
        teHmmTrain.py --supervised -> hmm.supervisedTrain counting).

        ``labeled_intervals`` are (chrom, start, end, stateName) covering
        the loaded tables; state names are assigned indices in first-seen
        order.  Counting is host-side (float64); the M-step runs on
        ``device`` in float32.
        """
        if track_data.gauss_track_indices:
            raise NotImplementedError(
                f"gaussian tracks are not ported yet ({_GAUSS_ITEM})"
            )
        state_names: list[str] = []
        name_to_idx: dict[str, int] = {}
        for iv in labeled_intervals:
            name = str(iv[3])
            if name not in name_to_idx:
                name_to_idx[name] = len(state_names)
                state_names.append(name)

        states_per_table = label_tables(
            track_data.tables, labeled_intervals, name_to_idx
        )
        S = len(state_names)
        sizes = track_data.alphabet_sizes
        V = max(sizes)
        T = track_data.num_tracks

        start_c = np.zeros(S, np.float64)
        trans_c = np.zeros((S, S), np.float64)
        em_c = np.zeros((S, T, V), np.float64)
        n_pos = 0
        for tab, states in zip(track_data.tables, states_per_table):
            # maximal labeled runs: transitions never count across
            # unlabeled gaps (each run is its own sequence)
            for s, e in _labeled_runs(states):
                st = states[s:e]
                sym = tab.symbols[s:e]
                n_pos += e - s
                start_c[st[0]] += 1
                tc = native.count_transitions(st, S)
                ec = native.count_emissions(st, sym, S, V)
                if tc is not None:
                    trans_c += tc
                    em_c += ec
                else:  # NumPy fallback (no compiler available)
                    np.add.at(trans_c, (st[:-1], st[1:]), 1)
                    for t in range(T):
                        np.add.at(
                            em_c, (st, t, sym[:, t].astype(np.int64)), 1
                        )
        if n_pos == 0:
            raise ValueError("no labeled positions found")

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        stats = em_ops.EmStats(
            start=f32(start_c), trans=f32(trans_c), em=f32(em_c),
            loglik=f32(0.0), n_obs=f32(float(n_pos)),
        )
        params = em_ops.em_m_step(stats, sizes, epsilon=epsilon)
        return cls(
            params, track_data.track_list, track_data.category_maps,
            state_names,
        )

    # ------------------------------------------------------------------
    def decode_tables(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 4096,
        halo: int = 256,
        rows_per_pass: int = 512,
    ) -> tuple[list[np.ndarray], StitchReport]:
        """Viterbi state paths for each table (halo-stitched, with the
        exact decoder as fallback)."""
        return viterbi_chunked(
            self.params, tables, chunk_len=chunk_len, halo=halo,
            rows_per_pass=rows_per_pass,
        )

    def decode_to_bed(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 4096,
        halo: int = 256,
    ) -> list[tuple]:
        """Viterbi -> merged (chrom, start, end, stateName) intervals."""
        paths, _ = self.decode_tables(tables, chunk_len, halo)
        out: list[tuple] = []
        for tab, path in zip(tables, paths):
            out.extend(path_to_intervals(
                tab.chrom, tab.start, path, self.state_names
            ))
        return out

    # ------------------------------------------------------------------
    # persistence: the JAX package's npz + JSON format
    # ------------------------------------------------------------------
    def save(self, path: str, extra: dict | None = None) -> None:
        meta = {
            "state_names": self.state_names,
            "tracks": self.track_list.to_dicts(),
            "category_maps": {
                name: cm.to_dict()
                for name, cm in self.category_maps.items()
            },
        }
        if extra:
            self.extra.update(extra)
        if self.extra:
            meta["extra"] = self.extra
        save_model(path, self.params, meta)

    @classmethod
    def load(cls, path: str, device: str | torch.device
             ) -> "MultitrackHmm":
        params, meta, arrays = load_model(path, device)
        if "gauss_mu" in arrays:
            raise NotImplementedError(
                f"{path}: models with gaussian tracks are not ported yet "
                f"({_GAUSS_ITEM})"
            )
        track_list = TrackList.from_dicts(meta["tracks"])
        maps = {
            name: CategoryMap.from_dict(d)
            for name, d in meta["category_maps"].items()
        }
        model = cls(params, track_list, maps, meta["state_names"])
        model.extra = meta.get("extra", {})
        return model


def path_log_score(params: HmmParams, symbols: np.ndarray,
                   path: np.ndarray) -> float:
    """Joint log-probability log P(obs, path) of a decoded state path
    (the quantity the reference's ``decode()`` returns).  Host gathers in
    float64, O(L·T): no device pass."""
    log_em = params.log_em.cpu().numpy().astype(np.float64)
    log_trans = params.log_trans.cpu().numpy().astype(np.float64)
    log_start = params.log_start.cpu().numpy().astype(np.float64)
    path = np.asarray(path, np.int64)
    if len(path) == 0:
        return 0.0
    s = float(log_start[path[0]])
    if len(path) > 1:
        s += float(log_trans[path[:-1], path[1:]].sum())
    em_pos = np.zeros(len(path), np.float64)
    for t in range(symbols.shape[1]):
        em_pos += log_em[path, t, symbols[:, t].astype(np.int64)]
    return s + float(em_pos.sum())


def path_to_intervals(
    chrom: str, origin: int, path: np.ndarray,
    state_names: list[str],
) -> list[tuple]:
    """State path -> merged (chrom, start, end, name) runs (native
    run-length encoder when available)."""
    path = np.ascontiguousarray(path, np.int32)
    if len(path) == 0:
        return []
    runs = native.runs_encode(path)
    if runs is None:
        edges = np.flatnonzero(np.diff(path)) + 1
        bounds = np.concatenate([[0], edges, [len(path)]])
        runs = (
            bounds[:-1], bounds[1:],
            path[bounds[:-1]],
        )
    starts, ends, states = runs
    return [
        (chrom, origin + int(s), origin + int(e), state_names[int(v)])
        for s, e, v in zip(starts, ends, states)
    ]


def label_tables(
    tables: Sequence[TrackTable],
    labeled_intervals: Sequence[Sequence],
    name_to_idx: dict[str, int],
) -> list[np.ndarray]:
    """Paint per-position state indices from labeled BED intervals;
    unlabeled positions get -1."""
    out = []
    for tab in tables:
        states = np.full(len(tab), -1, dtype=np.int32)
        for iv in labeled_intervals:
            chrom, start, end, name = iv[0], iv[1], iv[2], str(iv[3])
            if chrom != tab.chrom:
                continue
            s = max(start, tab.start) - tab.start
            e = min(end, tab.end) - tab.start
            if s < e:
                states[s:e] = name_to_idx[name]
        out.append(states)
    return out


def _labeled_runs(states: np.ndarray) -> list[tuple[int, int]]:
    """Maximal [s, e) runs of labeled (>= 0) positions."""
    labeled = states >= 0
    if not labeled.any():
        return []
    edges = np.flatnonzero(np.diff(labeled.astype(np.int8)))
    bounds = np.concatenate([[0], edges + 1, [len(states)]])
    return [
        (int(s), int(e))
        for s, e in zip(bounds[:-1], bounds[1:])
        if labeled[s]
    ]
