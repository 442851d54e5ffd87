"""Video IO: probing, containers, frame decoding, long-video segmentation.

This package's own copy of the JAX package's ``video/``.
"""

from .probe import probe_duration
from .segmenter import (
    SegmentInfo,
    create_manifest,
    extract_segment,
    get_manifest_path,
    get_segment_dir,
    load_manifest,
    load_or_create_manifest,
    pending_segments,
    plan_segments,
    save_manifest,
    snap_to_keyframe,
    update_segment_status,
)

__all__ = [
    "probe_duration",
    "SegmentInfo",
    "plan_segments",
    "extract_segment",
    "snap_to_keyframe",
    "get_segment_dir",
    "get_manifest_path",
    "create_manifest",
    "load_manifest",
    "save_manifest",
    "load_or_create_manifest",
    "pending_segments",
    "update_segment_status",
]
