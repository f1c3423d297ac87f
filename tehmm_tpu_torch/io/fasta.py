"""FASTA reading (reference: trackIO.py fasta branch; SURVEY.md §2a).

Per-base nucleotide symbols become a categorical track.  Sequences are
scanned once and offsets indexed, so fetching an interval of a large
genome does not hold every chromosome in memory at once.

Index reuse: a samtools-compatible ``.fai`` sidecar is read when
present and fresh (so existing ``samtools faidx`` output works
verbatim) and written after a scan when the directory is writable;
the scan itself runs in the native C++ indexer when available
(io/fasta.py's Python loop indexes ~12 MB/s — minutes for a genome).
"""

from __future__ import annotations

import os


class FastaFile:
    """Random-access FASTA: index on first open, slice on demand."""

    def __init__(self, path: str):
        self.path = path
        # name -> (data_start_offset, seq_len, line_base_len, line_full_len)
        self._index: dict[str, tuple[int, int, int, int]] = {}
        if not self._load_fai():
            if not self._build_index_native():
                self._build_index()
            self._write_fai()

    # ------------------------------------------------------------------
    # .fai sidecar (samtools faidx format:
    #   name \t length \t offset \t linebases \t linewidth)
    # ------------------------------------------------------------------

    def _load_fai(self) -> bool:
        fai = self.path + ".fai"
        try:
            # strict ns comparison: a FASTA rewritten in the same
            # second as the index counts as newer (ties -> rescan)
            if (os.stat(fai).st_mtime_ns
                    <= os.stat(self.path).st_mtime_ns):
                return False         # stale: FASTA edited after index
            with open(fai) as fh:
                idx = {}
                for line in fh:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) < 5:
                        return False
                    name, ln, off, lb, lf = parts[:5]
                    idx[name] = (int(off), int(ln), int(lb), int(lf))
        except (OSError, ValueError):
            return False
        self._index = idx
        return True

    def _write_fai(self) -> None:
        fai = self.path + ".fai"
        tmp = fai + f".tmp{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                for name, (off, ln, lb, lf) in self._index.items():
                    fh.write(f"{name}\t{ln}\t{off}\t{lb}\t{lf}\n")
            os.replace(tmp, fai)
        except OSError:              # read-only dir etc: scan next time
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _build_index_native(self) -> bool:
        from tehmm_tpu_torch import native

        if not native.available():
            return False
        res = native.fasta_index(self.path)   # raises on ragged FASTA
        if res is None:
            return False
        names, data_start, seq_len, line_base, line_full = res
        self._index = {
            n: (int(data_start[i]), int(seq_len[i]),
                int(line_base[i]), int(line_full[i]))
            for i, n in enumerate(names)
        }
        return True

    def _build_index(self) -> None:
        with open(self.path, "rb") as fh:
            name = None
            data_start = 0
            seq_len = 0
            line_base = 0
            line_full = 0
            first_line = True
            pending_short = False  # a shorter line must be the LAST

            def commit():
                if name is not None:
                    self._index[name] = (
                        data_start, seq_len, line_base, line_full
                    )

            offset = 0
            for lineno, raw in enumerate(fh, 1):
                ll = len(raw)
                line = raw.rstrip(b"\r\n")
                if line.startswith(b">"):
                    commit()
                    parts = line[1:].split()
                    if not parts:
                        raise ValueError(
                            f"{self.path}:{lineno}: FASTA header "
                            f"with empty record name"
                        )
                    name = parts[0].decode()
                    data_start = offset + ll
                    seq_len = 0
                    line_base = 0
                    line_full = 0
                    first_line = True
                    pending_short = False
                elif not line and name is not None:
                    if seq_len == 0:
                        # blank line between header and sequence: shift
                        # the record's data start past it
                        data_start = offset + ll
                    else:
                        # a BLANK line inside a sequence body shifts
                        # the byte offsets exactly like a ragged line:
                        # fetch() would silently return wrong bases.
                        # Mark it like a short line — anything
                        # following in the same record is an error (a
                        # trailing blank line before the next header/
                        # EOF is harmless).
                        pending_short = True
                elif line:
                    # offset arithmetic in fetch() assumes every sequence
                    # line except the last has the first line's length —
                    # the samtools-faidx invariant.  Ragged interior lines
                    # would silently return WRONG bases, so reject them.
                    if pending_short:
                        raise ValueError(
                            f"{self.path}:{lineno}: ragged FASTA — "
                            f"sequence {name!r} has an interior line "
                            f"shorter than its first line ({line_base}); "
                            f"re-wrap the file to fixed-width lines"
                        )
                    if first_line:
                        line_base = len(line)
                        line_full = ll
                        first_line = False
                    elif len(line) < line_base:
                        pending_short = True
                    elif len(line) > line_base:
                        raise ValueError(
                            f"{self.path}:{lineno}: ragged FASTA — "
                            f"sequence {name!r} line is longer "
                            f"({len(line)}) than its first line "
                            f"({line_base}); re-wrap the file to "
                            f"fixed-width lines"
                        )
                    seq_len += len(line)
                offset += ll
            commit()

    @property
    def names(self) -> list[str]:
        return list(self._index)

    def length(self, name: str) -> int:
        return self._index[name][1]

    def fetch(self, name: str, start: int, end: int) -> str:
        """Subsequence [start, end), uppercased."""
        if name not in self._index:
            raise KeyError(f"sequence {name!r} not in {self.path}")
        data_start, seq_len, line_base, line_full = self._index[name]
        start = max(0, start)
        end = min(end, seq_len)
        if start >= end:
            return ""
        if line_base == 0:
            return ""
        byte_start = data_start + (start // line_base) * line_full + (
            start % line_base
        )
        byte_end = data_start + ((end - 1) // line_base) * line_full + (
            (end - 1) % line_base
        ) + 1
        with open(self.path, "rb") as fh:
            fh.seek(byte_start)
            chunk = fh.read(byte_end - byte_start)
        return chunk.replace(b"\n", b"").replace(b"\r", b"").decode().upper()
