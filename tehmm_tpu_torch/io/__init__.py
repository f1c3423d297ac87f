from tehmm_tpu_torch.io.bed import (
    BedInterval,
    read_bed_intervals,
    write_bed_intervals,
    merge_adjacent_intervals,
    get_merged_bed_intervals,
)
from tehmm_tpu_torch.io.category import CategoryMap
from tehmm_tpu_torch.io.trackxml import Track, TrackList
from tehmm_tpu_torch.io.trackdata import TrackData, load_track_data

__all__ = [
    "BedInterval",
    "read_bed_intervals",
    "write_bed_intervals",
    "merge_adjacent_intervals",
    "get_merged_bed_intervals",
    "CategoryMap",
    "Track",
    "TrackList",
    "TrackData",
    "load_track_data",
]
