"""TrackData: multi-track interval loading into integer symbol matrices.

Rebuild of the reference's ``TrackData.loadTrackData`` pipeline (reference:
track.py `TrackData`, `TrackTable`/`IntegerTrackTable`, trackIO.py
`readTrackData` extension dispatch; SURVEY.md §2a, §3.1): for each query
interval, every configured track is read over that interval, values are
discretized through the track's CategoryMap, and the result is a dense
``[L, T]`` integer matrix (uint8/uint16) ready for the device emission
matmul.

Dispatch by file extension (reference: trackIO.readTrackData):
  .bed                 interval values (name / score / any column)
  .fa .fasta .fna      per-base nucleotide
  .bw .bigwig          per-base numeric (io.bigwig native reader)

Coverage semantics per distribution (reference: track.py [R], SURVEY.md
§2a; re-verify against the reference when its mount is restored):
  multinomial  value := record[valCol]; uncovered := track.default if set,
               else missing (symbol 0)
  binary       covered := "1"; uncovered := default or "0"
  sparse       like multinomial but uncovered is ALWAYS missing
  gaussian     continuous values on TrackTable.values (NaN missing);
               real per-state normal emissions (models/gauss.py) —
               the symbols column stays all-missing/inert

Overlapping records: later records in (chrom, start)-sorted order win.
The reference pipeline expects overlap-free tracks (it ships
removeBedOverlaps.py for exactly this); the rule here only defines
behavior when users skip that step.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from tehmm_tpu_torch.io.bed import read_bed
from tehmm_tpu_torch.io.category import CategoryMap
from tehmm_tpu_torch.io.fasta import FastaFile
from tehmm_tpu_torch.io.trackxml import Track, TrackList
from tehmm_tpu_torch.utils.common import logger


def _dtype_for(n: int):
    return np.uint8 if n <= 255 else np.uint16


@dataclasses.dataclass
class TrackTable:
    """Integer symbol matrix for one query interval
    (reference: track.py IntegerTrackTable).

    ``values`` carries the continuous gaussian-track columns ([L, G]
    f32, NaN = missing) when the track list declares any
    distribution="gaussian" tracks; their symbols column stays
    all-missing so every categorical code path is untouched
    (models/gauss.py)."""

    chrom: str
    start: int
    end: int
    symbols: np.ndarray  # [L, T] unsigned int
    values: np.ndarray | None = None  # [L, G] f32, NaN = missing

    def __len__(self) -> int:
        return self.end - self.start


class _BedSource:
    """One parsed BED file, indexed per chrom, ready to paint intervals.

    Uses the native C++ columnar parser when available (tehmm_tpu_torch.native,
    ~20x faster on genome-scale files); the parsed representation is the
    same either way so painting semantics are identical.
    """

    def __init__(self, path: str, value_col: int = 3):
        from tehmm_tpu_torch import native

        self.by_chrom: dict[str, list] = {}
        cols = native.parse_bed_columnar(path, value_col)
        if cols is not None:
            starts, ends, chrom_ids, value_ids, chroms, values = cols
            order = np.lexsort((ends, starts, chrom_ids))
            for i in order:
                chrom = chroms[chrom_ids[i]]
                vid = value_ids[i]
                val = values[vid] if vid >= 0 else None
                self.by_chrom.setdefault(chrom, []).append(
                    _Rec(int(starts[i]), int(ends[i]), val)
                )
        else:
            for rec in read_bed(path):
                self.by_chrom.setdefault(rec.chrom, []).append(
                    _Rec(rec.start, rec.end, _value_of(rec, value_col))
                )
            for recs in self.by_chrom.values():
                recs.sort(key=lambda r: (r.start, r.end))
        # columnar per-chrom views for fast range selection + painting
        self._cols: dict[str, tuple] = {}
        for chrom, recs in self.by_chrom.items():
            self._cols[chrom] = (
                np.asarray([r.start for r in recs], np.int64),
                np.asarray([r.end for r in recs], np.int64),
                [r.value for r in recs],
            )

    def overlapping(self, chrom: str, start: int, end: int):
        recs = self.by_chrom.get(chrom, [])
        if not recs:
            return []
        starts, ends, _vals = self._cols[chrom]
        hi = int(np.searchsorted(starts, end, side="left"))
        return [r for r in recs[:hi] if r.end > start]

    def range_columnar(self, chrom: str, start: int, end: int):
        """(starts, ends, values) of records overlapping [start, end),
        in paint order."""
        if chrom not in self._cols:
            return None
        starts, ends, vals = self._cols[chrom]
        hi = int(np.searchsorted(starts, end, side="left"))
        keep = np.flatnonzero(ends[:hi] > start)
        return (
            starts[keep], ends[:hi][keep],
            [vals[i] for i in keep],
        )


@dataclasses.dataclass
class _Rec:
    start: int
    end: int
    value: str | None


class _FastaSource:
    def __init__(self, path: str):
        self.fa = FastaFile(path)


def _value_of(rec, val_col: int):
    """Extract the raw value from a BED record by column index
    (reference: trackIO — valCol 3 = name, 4 = score)."""
    if val_col == 3:
        return rec.name
    if val_col == 4:
        return rec.score
    if val_col == 5:
        return rec.strand
    if val_col > 5 and (val_col - 6) < len(rec.extra):
        return rec.extra[val_col - 6]
    return None


class TrackData:
    """All loaded tables plus the category maps that made them."""

    def __init__(
        self,
        track_list: TrackList,
        category_maps: dict[str, CategoryMap],
        tables: list[TrackTable],
    ):
        self.track_list = track_list
        self.category_maps = category_maps
        self.tables = tables

    @property
    def alphabet_sizes(self) -> list[int]:
        return [len(self.category_maps[t.name]) for t in self.track_list]

    @property
    def num_tracks(self) -> int:
        return len(self.track_list)

    @property
    def gauss_track_indices(self) -> list[int]:
        """Track-list indices of distribution="gaussian" tracks (the
        column order of every TrackTable.values matrix)."""
        return [
            i for i, t in enumerate(self.track_list)
            if t.distribution == "gaussian"
        ]

    def maps_to_dict(self) -> dict:
        return {
            name: cm.to_dict() for name, cm in self.category_maps.items()
        }

    @staticmethod
    def maps_from_dict(d: dict) -> dict[str, CategoryMap]:
        return {name: CategoryMap.from_dict(v) for name, v in d.items()}


def load_track_data(
    track_list: TrackList,
    intervals: Sequence[Sequence],
    category_maps: dict[str, CategoryMap] | None = None,
    update_maps: bool | None = None,
) -> TrackData:
    """Load every track over every query interval.

    Args:
      intervals: (chrom, start, end, ...) tuples.
      category_maps: existing maps (eval mode — loaded from the model so
        symbols match training, SURVEY.md §3.2 ★).  None = build fresh.
      update_maps: whether unseen values get new symbols.  Defaults to
        True when maps are fresh, False when maps were supplied.

    Returns:
      TrackData with one TrackTable per interval (same order).
    """
    fresh = category_maps is None
    if update_maps is None:
        update_maps = fresh
    maps = (
        {t.name: CategoryMap() for t in track_list}
        if fresh
        else category_maps
    )

    # open each source once
    sources: dict[str, object] = {}
    for track in track_list:
        p = track.path.lower()
        if p.endswith((".fa", ".fasta", ".fna")):
            sources[track.name] = _FastaSource(track.path)
        elif p.endswith((".bw", ".bigwig")):
            from tehmm_tpu_torch.io.bigwig import BigWigFile

            sources[track.name] = BigWigFile(track.path)
        else:
            sources[track.name] = _BedSource(track.path, track.val_col)

    tracks = list(track_list)
    n_tracks = len(tracks)
    gauss_tracks = [t for t in tracks if t.distribution == "gaussian"]

    # Tracks paint CONCURRENTLY within each interval: every worker owns
    # its track's source and CategoryMap (nothing shared), and the
    # heavy work — native BED/BigWig decode, vectorized binning —
    # releases the GIL.  Round-4 profile: painting was serialized
    # across tracks even though the C++ decoder threads only span
    # blocks WITHIN one call.  TEHMM_LOAD_THREADS overrides.
    import os as _os

    env_threads = _os.environ.get("TEHMM_LOAD_THREADS")
    default_workers = max(1, min(n_tracks, _os.cpu_count() or 1))
    try:
        n_workers = (
            max(1, int(env_threads)) if env_threads else default_workers
        )
    except ValueError:
        logger.warning(
            "TEHMM_LOAD_THREADS=%r is not an integer; using %d",
            env_threads, default_workers,
        )
        n_workers = default_workers
    pool = None
    if n_workers > 1 and n_tracks > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(n_workers)

    from tehmm_tpu_torch import native

    # Native-kernel thread budget for the painting workers' calls
    # (BigWig decode, minmax, binning).  0 = library default
    # (min(8, cores) per call).  A bracketed A/B on the 250M x 15 load
    # could NOT distinguish this from a divided cores/worker budget —
    # run-to-run wall swung 25-94 s for identical code (shared-host
    # contention), so the simpler default stands; tracks finish at
    # different times and BED/FASTA painters use no native threads, so
    # nominally "oversubscribed" calls often land on idle cores anyway.
    nat_threads = 0

    tables: list[TrackTable] = []
    try:
        for iv in intervals:
            chrom, start, end = iv[0], int(iv[1]), int(iv[2])
            L = end - start

            def paint_one(t_idx):
                track = tracks[t_idx]
                src = sources[track.name]
                if track.distribution == "gaussian":
                    return _paint_track_gauss(
                        track, src, chrom, start, end,
                        native_threads=nat_threads,
                    )
                return _paint_track(
                    track, maps[track.name], src, chrom, start, end,
                    bool(update_maps), native_threads=nat_threads,
                )

            if pool is not None:
                cols = list(pool.map(paint_one, range(n_tracks)))
            else:
                cols = [paint_one(i) for i in range(n_tracks)]

            # assemble row-major [L, T] via the blocked native pack
            # (the `mat[:, t]` strided writes cost a cache line per
            # element — ~4 s/track at genome scale, round-4 profile)
            zero_col = None
            cat_cols = []
            g_cols = []
            for t_idx, track in enumerate(tracks):
                if track.distribution == "gaussian":
                    g_cols.append(cols[t_idx])
                    if zero_col is None:
                        # gaussian symbol columns stay all-missing
                        # (categorically inert; values ride .values)
                        zero_col = np.zeros(L, np.uint16)
                    cat_cols.append(zero_col)
                else:
                    cat_cols.append(cols[t_idx])
            mat = np.empty((L, n_tracks), dtype=np.uint16)
            if not native.pack_columns(cat_cols, mat):
                for t_idx, c in enumerate(cat_cols):
                    mat[:, t_idx] = c
            vals = None
            if gauss_tracks:
                vals = np.empty((L, len(g_cols)), np.float32)
                if not native.pack_columns(g_cols, vals):
                    for gi, c in enumerate(g_cols):
                        vals[:, gi] = c
            tables.append(
                TrackTable(chrom, start, end, mat, values=vals)
            )
    finally:
        if pool is not None:
            pool.shutdown()

    # shrink dtype if possible
    max_sym = max(
        (len(maps[t.name]) for t in track_list), default=1
    )
    dt = _dtype_for(max_sym)
    if dt != np.uint16:
        for tab in tables:
            tab.symbols = tab.symbols.astype(dt)

    return TrackData(track_list, maps, tables)


def _paint_track(
    track: Track,
    cm: CategoryMap,
    src,
    chrom: str,
    start: int,
    end: int,
    update: bool,
    native_threads: int = 0,
) -> np.ndarray:
    L = end - start

    # background / uncovered value
    if track.distribution == "sparse":
        bg = cm.missing
    elif track.distribution == "binary":
        bg_val = track.default if track.default is not None else "0"
        bg = cm.get_map(bg_val, update=update)
    elif track.default is not None:
        bg = cm.get_map(track.bin(track.default), update=update)
    else:
        bg = cm.missing
    # allocated lazily: the scale-binned BigWig fast path produces its
    # column straight from the bin LUT and never touches col — a
    # bg-memset of a whole-genome column per signal track is exactly
    # the churn that path exists to avoid
    col = None

    def new_col():
        c = np.zeros(L, dtype=np.uint16)
        c[:] = bg
        return c

    if isinstance(src, _FastaSource):
        col = new_col()
        seq = src.fa.fetch(chrom, start, end)
        arr = np.frombuffer(seq.encode(), dtype=np.uint8)
        if track.distribution == "binary":
            # covered := "1" regardless of base identity
            col[: len(arr)] = cm.get_map("1", update=update)
            return col
        # one 256-entry LUT gather instead of a compare+scatter pass per
        # distinct base; distinct codes via bincount, not np.unique
        # (unique SORTS the 20 Mb window — 0.4 s where bincount is 20 ms)
        lut = np.empty(256, col.dtype)
        codes = np.nonzero(np.bincount(arr, minlength=256))[0]
        for code in codes:
            lut[code] = cm.get_map(chr(int(code)), update=update)
        col[: len(arr)] = lut[arr]
        return col

    if isinstance(src, _BedSource):
        from tehmm_tpu_torch import native

        col = new_col()
        cols = src.range_columnar(chrom, start, end)
        if cols is None:
            return col
        starts_a, ends_a, vals = cols
        syms = np.empty(len(vals), np.uint16)
        keep = np.ones(len(vals), bool)
        cache: dict[str, int] = {}
        for k, raw in enumerate(vals):
            if track.distribution == "binary":
                raw = "1"
            elif raw is None:
                keep[k] = False
                continue
            sym = cache.get(raw)
            if sym is None:
                sym = cm.get_map(track.bin(raw), update=update)
                cache[raw] = sym
            syms[k] = sym
        starts_a, ends_a, syms = starts_a[keep], ends_a[keep], syms[keep]
        if not native.fill_intervals(col, start, starts_a, ends_a, syms):
            for s, e, v in zip(starts_a, ends_a, syms):  # NumPy fallback
                col[max(s, start) - start : min(e, end) - start] = v
        return col

    # BigWig: numeric per-base values (NaN = uncovered)
    vals = src.values(          # float array [L], NaN uncovered
        chrom, start, end, n_threads=native_threads
    )
    covered = ~np.isnan(vals)
    if not covered.any():
        return new_col()
    if track.distribution == "binary":
        # covered := "1", like the BED branch (the docstring's
        # two-symbol contract — binning floats would silently grow
        # an arbitrary alphabet)
        col = new_col()
        col[covered] = cm.get_map("1", update=update)
        return col
    if track.scale is not None or track.log_scale is not None:
        # scale-binned numeric track: bin VECTORIZED with no
        # [covered] gather/scatter (NaN floors to NaN; its int cast
        # is caught by a validity mask), then map the (few)
        # occupied integer bins through a LUT.  The generic path
        # below np.unique-sorts the raw floats — ~40 s per
        # whole-genome signal track where this is ~3 s.  Matches
        # io.category.bin_value exactly: f64 shift, multiply/log,
        # floor (keys are str(int) either way).  Evaluated in BOUNDED
        # BLOCKS: the round-4 profile flagged the per-track
        # whole-genome f64 temporaries (shift copy + floor + int64
        # bins = ~6 GB live per 250M-position track) as load-floor
        # churn; per-block scratch is ~400 MB with identical math.
        shift = float(track.shift or 0.0)

        def fb_of(x):
            v = x + shift                         # f64, NaN kept
            if track.scale is not None:
                return np.floor(v * track.scale)
            return np.floor(
                np.log(np.maximum(v, 1e-9)) / np.log(track.log_scale)
            )

        from tehmm_tpu_torch import native as _native

        mm = _native.nanminmax(vals, n_threads=native_threads)
        with np.errstate(invalid="ignore"):
            # shift+scale/log+floor is monotone (either direction for
            # negative scale / base < 1), so the global bin range comes
            # from the transformed value extremes
            if mm is not None:
                vmin, vmax = mm
            else:
                vmin, vmax = np.nanmin(vals), np.nanmax(vals)
            b0 = fb_of(np.float64(vmin))
            b1 = fb_of(np.float64(vmax))
        bmin = int(min(b0, b1))             # covered.any() holds
        span = int(max(b0, b1)) - bmin + 1
        if span <= (1 << 22):
            nb = _native.bin_scale(
                vals, shift, track.scale, track.log_scale, bmin,
                span, n_threads=native_threads,
            )
            if nb is not None:
                # fused C++ pass, identical f64 math (round-5: the
                # NumPy chain below was ~35 s of the 250M x 15 load)
                bins, present = nb
            else:
                bins = np.empty(L, np.int32)
                present = np.zeros(span, bool)
                BLK = 1 << 24
                with np.errstate(invalid="ignore"):
                    for lo in range(0, L, BLK):
                        fb = fb_of(vals[lo : lo + BLK])
                        fb -= bmin
                        # sentinel bin `span` for NaN -> background
                        fb[np.isnan(fb)] = span
                        blk = fb.astype(np.int32)
                        bins[lo : lo + len(blk)] = blk
                        present |= np.bincount(
                            blk, minlength=span + 1
                        )[:span].astype(bool)
            lut = np.empty(span + 1, np.uint16)
            lut[span] = bg                  # NaN rows -> background
            for b in np.nonzero(present)[0]:
                lut[b] = cm.get_map(int(b) + bmin, update=update)
            return lut[bins]
    w = vals[covered]
    # bin/map only the UNIQUE values: a per-base Python loop costs
    # interpreter minutes on genome-scale dense signal tracks
    u, inv = np.unique(w, return_inverse=True)
    u_syms = np.asarray(
        [cm.get_map(track.bin(v), update=update) for v in u],
        dtype=np.uint16,
    )
    col = new_col()
    col[covered] = u_syms[inv]
    return col


def _gauss_transform(track: Track, v: np.ndarray) -> np.ndarray:
    """Continuous counterpart of bin_value: shift + scale/logScale
    WITHOUT the floor (the value stays real-valued for the normal
    emission)."""
    v = v + (track.shift or 0.0)
    if track.log_scale is not None:
        v = np.log(np.maximum(v, 1e-9)) / np.log(track.log_scale)
    elif track.scale is not None:
        v = v * track.scale
    return v


def _paint_track_gauss(
    track: Track, src, chrom: str, start: int, end: int,
    native_threads: int = 0,
) -> np.ndarray:
    """Continuous values of a gaussian track over one interval.

    NaN = missing (uncovered and no default).  BED values come from the
    configured value column; BigWig values are native floats."""
    L = end - start
    if track.default is not None:
        col = np.full(
            L, _gauss_transform(track, float(track.default)), np.float32
        )
    else:
        col = np.full(L, np.nan, np.float32)

    if isinstance(src, _FastaSource):
        raise ValueError(
            f"track {track.name}: distribution=gaussian is not defined "
            f"for FASTA sequence input"
        )
    if isinstance(src, _BedSource):
        cols = src.range_columnar(chrom, start, end)
        if cols is None:
            return col
        starts_a, ends_a, vals = cols
        for s, e, raw in zip(starts_a, ends_a, vals):
            if raw is None:
                continue
            try:
                v = float(raw)
            except ValueError:
                raise ValueError(
                    f"track {track.name}: gaussian track value {raw!r} "
                    f"is not numeric"
                )
            col[max(s, start) - start : min(e, end) - start] = \
                _gauss_transform(track, v)
        return col

    vals = src.values(
        chrom, start, end, n_threads=native_threads
    ).astype(np.float32)
    covered = ~np.isnan(vals)
    col[covered] = _gauss_transform(track, vals[covered])
    return col
