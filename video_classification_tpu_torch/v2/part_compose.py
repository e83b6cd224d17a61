"""Part compositions and box-union algebra for the v2 pipeline.

A numpy copy of the JAX package's ``v2/part_compose.py`` (the reference's
``PartCompose``, new_feature_test.py:470-550): named surface-index
compositions plus spatial (across parts) and temporal (across a clip)
bounding-box unions producing one fixed crop box per clip. The port imports
nothing from the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

Box = Tuple[int, int, int, int]  # xyxy

# Individual parts (surface indices; new_feature_test.py:474-487).
lHand = [4]
rHand = [3]
lUpArm = [15, 17]
rUpArm = [16, 18]
lLoArm = [19, 21]
rLoArm = [20, 22]
torso = [1, 2]
head = [23, 24]

# Compositions (new_feature_test.py:489-499).
lArm = lUpArm + lLoArm
rArm = rUpArm + rLoArm
TorsoArmHand = torso + lArm + rArm + lHand + rHand
lHandLoArm = lHand + lLoArm
lHandArm = lHand + lArm
lHandArmTorso = lHand + lArm + torso
rHandLoArm = rHand + rLoArm
rHandArm = rHand + rArm
rHandArmTorso = rHand + rArm + torso


def combine_box_xyxy(box_arr: np.ndarray) -> Box:
    """Union of (N, 4) xyxy boxes (new_feature_test.py:501-519)."""
    assert len(box_arr) > 0
    box_arr = np.asarray(box_arr)
    return (
        box_arr[:, 0].min(),
        box_arr[:, 1].min(),
        box_arr[:, 2].max(),
        box_arr[:, 3].max(),
    )


def combine_spatial_box_xyxy(part_boxes: Sequence[Optional[Box]],
                             part_list: Sequence[int]) -> Optional[Box]:
    """Union of one frame's boxes over a part list; None if no part detected
    (new_feature_test.py:521-535)."""
    boxes = [part_boxes[p] for p in part_list]
    boxes = [b for b in boxes if b is not None]
    if not boxes:
        return None
    return combine_box_xyxy(np.asarray(boxes))


def combine_temporal_box_xyxy(temporal_part_boxes: Sequence[Sequence[Optional[Box]]],
                              part_list: Sequence[int]) -> Box:
    """One clip-covering box: spatial union per frame, then union over frames
    (new_feature_test.py:537-549)."""
    per_frame = [combine_spatial_box_xyxy(pb, part_list) for pb in temporal_part_boxes]
    per_frame = [b for b in per_frame if b is not None]
    return combine_box_xyxy(np.asarray(per_frame))


class PartCompose:
    """Class facade matching the reference API."""

    lHand, rHand = lHand, rHand
    lUpArm, rUpArm = lUpArm, rUpArm
    lLoArm, rLoArm = lLoArm, rLoArm
    torso, head = torso, head
    lArm, rArm = lArm, rArm
    TorsoArmHand = TorsoArmHand
    lHandLoArm, lHandArm, lHandArmTorso = lHandLoArm, lHandArm, lHandArmTorso
    rHandLoArm, rHandArm, rHandArmTorso = rHandLoArm, rHandArm, rHandArmTorso

    combine_box_xyxy = staticmethod(combine_box_xyxy)
    combine_spatial_box_xyxy = staticmethod(combine_spatial_box_xyxy)
    combine_temporal_box_xyxy = staticmethod(combine_temporal_box_xyxy)
