"""Inspection tools.

Port of the JAX package's ``tools.py``: ``how_many_classes``, the label
statistics of the reference's how_many_classes.py. (``render_iuv_boxes``
reads videos through the v2 ``VideoIO`` and comes with the v2 slice.)
"""

from __future__ import annotations

from pathlib import Path


def how_many_classes(labels_txt: Path) -> dict:
    """{'min', 'max', 'num_classes', 'num_videos'} of a ChaLearn labels file
    (lines ``M_path K_path label``), printed as the reference prints them."""
    with Path(labels_txt).open("r") as f:
        lines = f.readlines()
    labels = [int(line.split(" ")[2]) for line in lines if line.strip()]
    stats = {
        "min": min(labels),
        "max": max(labels),
        "num_classes": len(set(labels)),
        "num_videos": len(labels),
    }
    print(stats["min"], stats["max"], stats["num_classes"])
    print(f"num of videos: {stats['num_videos']}")
    return stats
