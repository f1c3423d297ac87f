"""Native BigWig reader (pure Python struct/zlib; no external deps).

The reference reads BigWig tracks through bx-python's C extension
(reference: trackIO.py BigWig branch via `BigWigFile`; SURVEY.md §2a).
Neither bx-python nor pyBigWig is installed here (SURVEY.md §7 verified
environment), so this module implements the BigWig container format
directly from its public specification (Kent et al., "BigWig and BigBed:
enabling browsing of large distributed datasets", Bioinformatics 2010):

  header -> chromosome B+ tree -> R-tree interval index -> (zlib)
  data blocks in bedGraph / varStep / fixedStep binary WIG encoding.

Only reading is supported (matching the reference's usage).  Returns
per-base float values with NaN for uncovered positions.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

BIGWIG_MAGIC = 0x888FFC26
CHROM_TREE_MAGIC = 0x78CA8C91
RTREE_MAGIC = 0x2468ACE0

_WIG_BEDGRAPH = 1
_WIG_VARSTEP = 2
_WIG_FIXEDSTEP = 3


class BigWigFile:
    """Random-access BigWig reader."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        magic = struct.unpack("<I", self._fh.read(4))[0]
        if magic != BIGWIG_MAGIC:
            # try big endian
            if struct.unpack(">I", struct.pack("<I", magic))[0] == BIGWIG_MAGIC:
                raise NotImplementedError(
                    "big-endian BigWig files are not supported"
                )
            raise ValueError(f"{path}: not a BigWig file (magic {magic:#x})")
        (
            self.version,
            self.zoom_levels,
            self.chrom_tree_offset,
            self.full_data_offset,
            self.full_index_offset,
            self.field_count,
            self.defined_field_count,
            self.auto_sql_offset,
            self.total_summary_offset,
            self.uncompress_buf_size,
            _reserved,
        ) = struct.unpack("<HHQQQHHQQIQ", self._fh.read(60))
        self.chroms: dict[str, tuple[int, int]] = {}  # name -> (id, size)
        self._chrom_by_id: dict[int, str] = {}
        self._read_chrom_tree()

    # ------------------------------------------------------------------
    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _read_chrom_tree(self) -> None:
        fh = self._fh
        fh.seek(self.chrom_tree_offset)
        magic, block_size, key_size, val_size, item_count, _res = (
            struct.unpack("<IIIIQQ", fh.read(32))
        )
        if magic != CHROM_TREE_MAGIC:
            raise ValueError("bad chromosome B+ tree magic")

        def walk(offset: int):
            fh.seek(offset)
            is_leaf, _res, count = struct.unpack("<BBH", fh.read(4))
            if is_leaf:
                for _ in range(count):
                    key = fh.read(key_size).rstrip(b"\0").decode()
                    chrom_id, chrom_size = struct.unpack(
                        "<II", fh.read(val_size)
                    )
                    self.chroms[key] = (chrom_id, chrom_size)
                    self._chrom_by_id[chrom_id] = key
            else:
                children = []
                for _ in range(count):
                    fh.read(key_size)
                    (child_off,) = struct.unpack("<Q", fh.read(8))
                    children.append(child_off)
                for off in children:
                    walk(off)

        walk(self.chrom_tree_offset + 32)

    # ------------------------------------------------------------------
    def _find_blocks(
        self, chrom_id: int, start: int, end: int
    ) -> list[tuple[int, int]]:
        """R-tree query -> [(data_offset, data_size)] overlapping blocks."""
        fh = self._fh
        fh.seek(self.full_index_offset)
        (magic, _block_size, _item_count, _sc, _sb, _ec, _eb,
         _end_file_offset, _items_per_slot, _res) = struct.unpack(
            "<IIQIIIIQII", fh.read(48)
        )
        if magic != RTREE_MAGIC:
            raise ValueError("bad R-tree magic")
        root = self.full_index_offset + 48
        out: list[tuple[int, int]] = []

        def overlaps(s_cid, s_base, e_cid, e_base) -> bool:
            if (e_cid, e_base) <= (chrom_id, start):
                return False
            if (s_cid, s_base) >= (chrom_id, end):
                return False
            return True

        def walk(offset: int):
            fh.seek(offset)
            is_leaf, _r, count = struct.unpack("<BBH", fh.read(4))
            if is_leaf:
                raw = fh.read(32 * count)
                for i in range(count):
                    s_cid, s_base, e_cid, e_base, d_off, d_size = (
                        struct.unpack_from("<IIIIQQ", raw, i * 32)
                    )
                    if overlaps(s_cid, s_base, e_cid, e_base):
                        out.append((d_off, d_size))
            else:
                raw = fh.read(24 * count)
                children = []
                for i in range(count):
                    s_cid, s_base, e_cid, e_base, child = (
                        struct.unpack_from("<IIIIQ", raw, i * 24)
                    )
                    if overlaps(s_cid, s_base, e_cid, e_base):
                        children.append(child)
                for child in children:
                    walk(child)

        walk(root)
        return out

    # ------------------------------------------------------------------
    def values(self, chrom: str, start: int, end: int,
               n_threads: int = 0) -> np.ndarray:
        """Per-base values over [start, end); NaN where uncovered
        (matches bx-python BigWigFile.get semantics used by the
        reference).  ``n_threads``: native decode thread budget
        (0 = library default; loaders running several tracks
        concurrently pass their per-worker share)."""
        if chrom not in self.chroms:
            return np.full(end - start, np.nan, dtype=np.float64)
        chrom_id, chrom_size = self.chroms[chrom]
        L = end - start
        out = np.full(L, np.nan, dtype=np.float64)
        blocks = self._find_blocks(chrom_id, start, end)
        if not blocks:
            return out

        # read the raw section bytes in one pass (blocks of one query
        # are nearly always file-adjacent, so reads coalesce)
        raws = []
        pos = None
        for d_off, d_size in blocks:
            if pos != d_off:
                self._fh.seek(d_off)
            raws.append(self._fh.read(d_size))
            pos = d_off + d_size

        # native fast path: one call inflates + paints every section
        # (the per-block zlib+NumPy loop bounded this at ~10 Mbase/s on
        # 1-bp signal tracks; reference's reader is C via bx-python)
        from tehmm_tpu_torch import native

        if native.available():
            offsets = np.zeros(len(raws) + 1, np.int64)
            np.cumsum([len(r) for r in raws], out=offsets[1:])
            if native.bigwig_paint_blocks(
                b"".join(raws), offsets,
                self.uncompress_buf_size > 0,
                max(int(self.uncompress_buf_size), 1),
                chrom_id, start, end, out,
                n_threads=n_threads or None,
            ):
                return out

        for raw in raws:
            if self.uncompress_buf_size > 0:
                raw = zlib.decompress(raw)
            self._paint_block(raw, chrom_id, start, end, out)
        return out

    def intervals(
        self, chrom: str, start: int, end: int
    ) -> list[tuple[int, int, float]]:
        """(start, end, value) runs overlapping the query."""
        vals = self.values(chrom, start, end)
        out = []
        i = 0
        L = len(vals)
        while i < L:
            if np.isnan(vals[i]):
                i += 1
                continue
            j = i + 1
            while j < L and vals[j] == vals[i]:
                j += 1
            out.append((start + i, start + j, float(vals[i])))
            i = j
        return out

    @staticmethod
    def _paint_block(
        raw: bytes, chrom_id: int, q_start: int, q_end: int,
        out: np.ndarray,
    ) -> None:
        (b_chrom_id, b_start, b_end, item_step, item_span, w_type,
         _res, item_count) = struct.unpack_from("<IIIIIBBH", raw, 0)
        if b_chrom_id != chrom_id:
            return
        body = raw[24:]
        if w_type == _WIG_BEDGRAPH:
            arr = np.frombuffer(
                body, dtype=np.dtype(
                    [("start", "<u4"), ("end", "<u4"), ("val", "<f4")]
                ), count=item_count,
            )
            starts, ends = arr["start"], arr["end"]
        elif w_type == _WIG_VARSTEP:
            arr = np.frombuffer(
                body, dtype=np.dtype([("start", "<u4"), ("val", "<f4")]),
                count=item_count,
            )
            starts = arr["start"]
            ends = starts + item_span
        elif w_type == _WIG_FIXEDSTEP:
            vals = np.frombuffer(body, dtype="<f4", count=item_count)
            starts = b_start + item_step * np.arange(item_count, dtype=np.int64)
            ends = starts + item_span
            arr = None
        else:
            raise ValueError(f"unknown WIG section type {w_type}")
        values = vals if w_type == _WIG_FIXEDSTEP else arr["val"]
        s = np.maximum(starts.astype(np.int64), q_start) - q_start
        e = np.minimum(ends.astype(np.int64), q_end) - q_start
        keep = s < e
        s, e = s[keep], e[keep]
        values = np.asarray(values)[keep]
        # vectorized paint: a per-item Python loop degenerates to a
        # per-BASE interpreter loop for 1-bp fixedStep/bedGraph signal
        # tracks (the common conservation/coverage case).  Items within
        # one WIG section never overlap, so scatter order is moot.
        lens = e - s
        if len(lens):
            total = int(lens.sum())
            pos = (
                np.repeat(s, lens)
                + np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(lens) - lens, lens)
            )
            out[pos] = np.repeat(values, lens)
