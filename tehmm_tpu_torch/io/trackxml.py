"""Tracks XML config: Track and TrackList.

Rebuild of the reference's track configuration (reference: track.py
`Track`, `TrackList` parsed from the tracks XML file; SURVEY.md §2a, §5
"Config / flags": the XML format is part of the observable surface and
users' files must work unchanged).  Format:

    <teModelConfig>
      <track name="repeats"  path="repeats.bed" distribution="multinomial"
             valCol="3"/>
      <track name="copy"     path="copy.bw"     distribution="multinomial"
             scale="2.0" shift="-1.0"/>
      <track name="cov"      path="cov.bed"     distribution="binary"/>
      <track name="seq"      path="genome.fa"   distribution="multinomial"/>
    </teModelConfig>

Recognized <track> attributes (others are preserved and echoed back on
write, so foreign attributes survive a round-trip):

  name          unique track id (required)
  path          data file; dispatch on extension (.bed/.bb? -> BED,
                .bw/.bigwig -> BigWig, .fa/.fasta -> FASTA)
  distribution  multinomial (default) | binary | sparse | gaussian
                (sparse == multinomial whose *default/uncovered* symbol is
                treated as missing; gaussian == continuous values with
                real per-state normal emissions, models/gauss.py)
  valCol        BED column holding the value (0-based; 3=name, 4=score);
                default 3
  scale, logScale, shift   numeric binning (see io.category)
  default       value assigned to positions not covered by any record
                (absent -> missing for sparse, else its own "none" category)
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Any, Iterator

from tehmm_tpu_torch.io.category import CategoryMap, bin_value

CONFIG_ROOT_TAG = "teModelConfig"

_KNOWN_ATTRS = (
    "name path distribution valCol scale logScale shift default".split()
)


@dataclasses.dataclass
class Track:
    """One annotation track's configuration (reference: track.py Track)."""

    name: str
    path: str
    distribution: str = "multinomial"
    val_col: int = 3
    scale: float | None = None
    log_scale: float | None = None
    shift: float | None = None
    default: str | None = None
    extra_attrs: dict[str, str] = dataclasses.field(default_factory=dict)
    # assigned by TrackList:
    number: int = -1
    # the path AS WRITTEN in the source XML (load_xml resolves ``path``
    # against the XML's directory for opening; persistence must write
    # the original back so users' relative layouts survive round-trips
    # and model sidecars stay machine-portable)
    orig_path: str | None = None

    def __post_init__(self):
        if self.distribution not in (
            "multinomial", "binary", "sparse", "gaussian"
        ):
            raise ValueError(
                f"track {self.name}: unknown distribution "
                f"{self.distribution!r}"
            )

    def bin(self, val: Any) -> Any:
        return bin_value(val, self.scale, self.log_scale, self.shift)

    @classmethod
    def from_xml_element(cls, elem: ET.Element) -> "Track":
        a = dict(elem.attrib)
        if "name" not in a or "path" not in a:
            raise ValueError(
                f"<track> element needs name and path: {a}"
            )
        extra = {k: v for k, v in a.items() if k not in _KNOWN_ATTRS}
        return cls(
            name=a["name"],
            path=a["path"],
            distribution=a.get("distribution", "multinomial"),
            val_col=int(a.get("valCol", 3)),
            scale=float(a["scale"]) if "scale" in a else None,
            log_scale=float(a["logScale"]) if "logScale" in a else None,
            shift=float(a["shift"]) if "shift" in a else None,
            default=a.get("default"),
            extra_attrs=extra,
        )

    def to_xml_element(self, out_dir: str | None = None) -> ET.Element:
        import os

        written = self.orig_path or self.path
        if out_dir is not None and not os.path.isabs(written):
            # Relative data paths resolve against the XML's OWN directory
            # (load_xml above), so an XML written to a different directory
            # must rewrite them or they dangle (observed: tehmm
            # track-ranking writes per-candidate sub-XMLs into outDir and
            # every relative track path broke).  A save that preserves
            # resolution keeps the original string byte-identically;
            # re-rooted saves write the ABSOLUTE resolved path — a
            # lexical relpath between the two directories would
            # mis-resolve through symlinks.  (A track added
            # programmatically with a relative path is CWD-relative,
            # like any other CLI path argument.)
            resolved = (self.path if os.path.isabs(self.path)
                        else os.path.abspath(self.path))
            if os.path.relpath(resolved, out_dir) != written:
                written = resolved
        a: dict[str, str] = {
            "name": self.name, "path": written,
        }
        if self.distribution != "multinomial":
            a["distribution"] = self.distribution
        if self.val_col != 3:
            a["valCol"] = str(self.val_col)
        for attr, key in (
            ("scale", "scale"), ("log_scale", "logScale"), ("shift", "shift")
        ):
            v = getattr(self, attr)
            if v is not None:
                a[key] = repr(v) if v != int(v) else str(int(v))
        if self.default is not None:
            a["default"] = self.default
        a.update(self.extra_attrs)
        return ET.Element("track", a)


class TrackList:
    """Ordered collection of Tracks parsed from a tracks XML file
    (reference: track.py TrackList)."""

    def __init__(self, xml_path: str | None = None):
        self._tracks: list[Track] = []
        self._by_name: dict[str, Track] = {}
        if xml_path is not None:
            self.load_xml(xml_path)

    def load_xml(self, xml_path: str) -> None:
        import os

        root = ET.parse(xml_path).getroot()
        if root.tag != CONFIG_ROOT_TAG:
            raise ValueError(
                f"expected root <{CONFIG_ROOT_TAG}>, got <{root.tag}>"
            )
        base = os.path.dirname(os.path.abspath(xml_path))
        for elem in root.findall("track"):
            track = Track.from_xml_element(elem)
            track.orig_path = track.path
            if not os.path.isabs(track.path):
                # relative data paths resolve against the XML's directory
                # (no lexical normpath: collapsing ".." would mis-resolve
                # through symlinked directories — leave that to the OS)
                track.path = os.path.join(base, track.path)
            self.add(track)

    def add(self, track: Track) -> None:
        if track.name in self._by_name:
            raise ValueError(f"duplicate track name {track.name!r}")
        track.number = len(self._tracks)
        self._tracks.append(track)
        self._by_name[track.name] = track

    def get_track_by_name(self, name: str) -> Track | None:
        return self._by_name.get(name)

    def __iter__(self) -> Iterator[Track]:
        return iter(self._tracks)

    def __len__(self) -> int:
        return len(self._tracks)

    def __getitem__(self, i: int) -> Track:
        return self._tracks[i]

    def save_xml(self, path: str) -> None:
        import os

        out_dir = os.path.dirname(os.path.abspath(path))
        root = ET.Element(CONFIG_ROOT_TAG)
        for t in self._tracks:
            root.append(t.to_xml_element(out_dir))
        ET.indent(root)
        ET.ElementTree(root).write(path)

    # ------------------------------------------------------------------
    # model-sidecar serialization
    # ------------------------------------------------------------------
    def to_dicts(self) -> list[dict]:
        out = []
        for t in self._tracks:
            d = dataclasses.asdict(t)
            d.pop("number")
            out.append(d)
        return out

    @classmethod
    def from_dicts(cls, dicts: list[dict]) -> "TrackList":
        tl = cls()
        for d in dicts:
            tl.add(Track(**d))
        return tl
