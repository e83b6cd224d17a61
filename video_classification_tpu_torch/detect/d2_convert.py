"""detectron2 DensePose checkpoints -> the port's state_dict.

The port's ``DensePoseRCNN`` carries detectron2's module names, so a released
``densepose_rcnn_R_101_FPN_DL_s1x`` checkpoint (``model_final_844d15.pkl``)
loads by name, as ``load_state_dict(strict=True)``, once its buffers with no
counterpart (anchor cell buffers, pixel_mean/std, num_batches_tracked) are
dropped. The key inventory (:func:`d2_key_shapes`) is this package's own copy
of the JAX package's ``detect/d2_convert.py``; with it
:func:`synthesize_state_dict` makes a random checkpoint of the released key
grammar and shapes, which is how the loader is tested without the file.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from .densepose import NUM_CHARTS, RESNET_DEPTHS

_STAGE_DIMS = {2: (64, 256), 3: (128, 512), 4: (256, 1024), 5: (512, 2048)}
_FPN_IN = {2: 256, 3: 512, 4: 1024, 5: 2048}
_SKIPPED_PREFIXES = ("proposal_generator.anchor_generator.",)
_SKIPPED_KEYS = ("pixel_mean", "pixel_std")


def _bn_keys(prefix: str, ch: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.{leaf}", (ch,))
            for leaf in ("weight", "bias", "running_mean", "running_var")]


def d2_key_shapes(depth: int = 101) -> Dict[str, tuple]:
    """Full detectron2 state_dict key -> shape map of the R_{depth}_FPN_DL
    model, the anchor buffers included."""
    keys: List[Tuple[str, tuple]] = []
    bu = "backbone.bottom_up"
    keys.append((f"{bu}.stem.conv1.weight", (64, 3, 7, 7)))
    keys += _bn_keys(f"{bu}.stem.conv1.norm", 64)
    in_ch = 64
    for stage, nblocks in zip((2, 3, 4, 5), RESNET_DEPTHS[depth]):
        inner, out = _STAGE_DIMS[stage]
        for i in range(nblocks):
            p = f"{bu}.res{stage}.{i}"
            block_in = in_ch if i == 0 else out
            if i == 0:
                keys.append((f"{p}.shortcut.weight", (out, block_in, 1, 1)))
                keys += _bn_keys(f"{p}.shortcut.norm", out)
            keys.append((f"{p}.conv1.weight", (inner, block_in, 1, 1)))
            keys += _bn_keys(f"{p}.conv1.norm", inner)
            keys.append((f"{p}.conv2.weight", (inner, inner, 3, 3)))
            keys += _bn_keys(f"{p}.conv2.norm", inner)
            keys.append((f"{p}.conv3.weight", (out, inner, 1, 1)))
            keys += _bn_keys(f"{p}.conv3.norm", out)
        in_ch = out
    for lvl in (2, 3, 4, 5):
        keys += [(f"backbone.fpn_lateral{lvl}.weight", (256, _FPN_IN[lvl], 1, 1)),
                 (f"backbone.fpn_lateral{lvl}.bias", (256,)),
                 (f"backbone.fpn_output{lvl}.weight", (256, 256, 3, 3)),
                 (f"backbone.fpn_output{lvl}.bias", (256,))]
    for lvl in range(5):
        keys.append((f"proposal_generator.anchor_generator.cell_anchors.{lvl}", (3, 4)))
    rh = "proposal_generator.rpn_head"
    keys += [(f"{rh}.conv.weight", (256, 256, 3, 3)), (f"{rh}.conv.bias", (256,)),
             (f"{rh}.objectness_logits.weight", (3, 256, 1, 1)),
             (f"{rh}.objectness_logits.bias", (3,)),
             (f"{rh}.anchor_deltas.weight", (12, 256, 1, 1)),
             (f"{rh}.anchor_deltas.bias", (12,))]
    keys += [("roi_heads.box_head.fc1.weight", (1024, 256 * 7 * 7)),
             ("roi_heads.box_head.fc1.bias", (1024,)),
             ("roi_heads.box_head.fc2.weight", (1024, 1024)),
             ("roi_heads.box_head.fc2.bias", (1024,)),
             ("roi_heads.box_predictor.cls_score.weight", (2, 1024)),
             ("roi_heads.box_predictor.cls_score.bias", (2,)),
             ("roi_heads.box_predictor.bbox_pred.weight", (4, 1024)),
             ("roi_heads.box_predictor.bbox_pred.bias", (4,))]
    # Decoder level heads p{l}: Sequential(conv[, up]...), convs at even indices.
    for lvl, nconvs in ((2, 1), (3, 1), (4, 2), (5, 3)):
        for k in range(nconvs):
            keys += [(f"roi_heads.decoder.p{lvl}.{2 * k}.weight", (256, 256, 3, 3)),
                     (f"roi_heads.decoder.p{lvl}.{2 * k}.bias", (256,))]
    keys += [("roi_heads.decoder.predictor.weight", (256, 256, 1, 1)),
             ("roi_heads.decoder.predictor.bias", (256,))]
    dh = "roi_heads.densepose_head"
    keys += [(f"{dh}.ASPP.convs.0.0.weight", (256, 256, 1, 1)),
             (f"{dh}.ASPP.convs.0.1.weight", (256,)),
             (f"{dh}.ASPP.convs.0.1.bias", (256,))]
    for b in (1, 2, 3):
        keys += [(f"{dh}.ASPP.convs.{b}.0.weight", (256, 256, 3, 3)),
                 (f"{dh}.ASPP.convs.{b}.1.weight", (256,)),
                 (f"{dh}.ASPP.convs.{b}.1.bias", (256,))]
    keys += [(f"{dh}.ASPP.convs.4.1.weight", (256, 256, 1, 1)),
             (f"{dh}.ASPP.convs.4.2.weight", (256,)),
             (f"{dh}.ASPP.convs.4.2.bias", (256,)),
             (f"{dh}.ASPP.project.0.weight", (256, 5 * 256, 1, 1))]
    ch_in = 256
    for i in range(1, 9):
        keys += [(f"{dh}.body_conv_fcn{i}.weight", (512, ch_in, 3, 3)),
                 (f"{dh}.body_conv_fcn{i}.norm.weight", (512,)),
                 (f"{dh}.body_conv_fcn{i}.norm.bias", (512,))]
        ch_in = 512
    dp = "roi_heads.densepose_predictor"
    for head, ch in (("ann_index_lowres", 2), ("index_uv_lowres", NUM_CHARTS + 1),
                     ("u_lowres", NUM_CHARTS + 1), ("v_lowres", NUM_CHARTS + 1)):
        keys += [(f"{dp}.{head}.weight", (512, ch, 4, 4)),
                 (f"{dp}.{head}.bias", (ch,))]
    return dict(keys)


def synthesize_state_dict(depth: int = 101, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random state_dict with the exact released key grammar and shapes."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in d2_key_shapes(depth).items():
        if k.endswith("running_var"):
            out[k] = (0.5 + rng.rand(*shape)).astype(np.float32)
        else:
            out[k] = (rng.randn(*shape) * 0.05).astype(np.float32)
    return out


def load_d2_pkl(path) -> Dict[str, np.ndarray]:
    """Load a detectron2 .pkl checkpoint ({"model": {key: ndarray}})."""
    with open(Path(path), "rb") as f:
        data = pickle.load(f, encoding="latin1")
    model = data.get("model", data)
    return {k: np.asarray(v) for k, v in model.items()}


def coverage_report(state_dict: Iterable[str], depth: int = 101) -> Dict[str, list]:
    """Compare a state_dict's keys against the released inventory."""
    expected = set(d2_key_shapes(depth))
    got = set(state_dict)
    return {"missing": sorted(expected - got), "unexpected": sorted(got - expected)}


def _dropped(key: str) -> bool:
    return (key in _SKIPPED_KEYS or key.endswith(".num_batches_tracked")
            or key.startswith(_SKIPPED_PREFIXES))


def load_densepose_state_dict(pkl_path, depth: int = 101) -> Dict[str, torch.Tensor]:
    """pkl file -> the port's DensePoseRCNN state_dict (float32 tensors).

    Raises if a key of the released inventory is missing or an unknown key
    is present; drops the buffers the port has no counterpart for."""
    sd = {k: v for k, v in load_d2_pkl(pkl_path).items() if not _dropped(k)}
    expected = {k for k in d2_key_shapes(depth) if not _dropped(k)}
    for what, keys in (("missing", expected - set(sd)),
                       ("unexpected", set(sd) - expected)):
        if keys:
            raise ValueError(f"checkpoint has {len(keys)} {what} keys, "
                             f"first: {sorted(keys)[:5]}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}
