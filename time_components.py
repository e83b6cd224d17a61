#!/usr/bin/env python3
"""Device times of the component kernels, K2 (component_extents) and K6
(label_components), of one checkout of the port on one NVIDIA GPU, so that
two checkouts can be compared in one call.

    python3 time_components.py [ROOT]

Imports video_classification_tpu_torch from ROOT (default: this checkout),
builds its kernels there, and times them with CUDA events by this
checkout's chip_smoke.py helpers, each beside its plain version, with each
mask's executed iterations and the time per dependent iteration:

  K6: the synthetic CropHTAH masks, 20 x 56x56, 20 x 112x112 and,
      nearest-resized, 20 x 240x320;
  K2: the synthetic detector's CropHTAH masks, 20 x 56x56 and 20 x 112x112;
      the CropHTAH masks of the DensePose detector's own 112x112 charts from
      one full-width run (depth 101, seeded random weights) on one clip's 20
      padded frames (the serving batch); the six crop streams' part masks of
      that run's first chart nearest-resized to 240x320 and 480x640.

Every case is first held exactly to the plain version. A checkout without
the wide words (its K2 binding refuses masks past 255 px a side) prints
that instead of a time for them. Prints the package's path, one
JSON line per case and the card's nvidia-smi line. Compare two checkouts by
running each in turn, A B B A, in one call.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv) -> int:
    root = Path(argv[1]).resolve() if len(argv) > 1 else HERE
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_components: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import video_classification_tpu_torch as port
    from video_classification_tpu_torch.config.crop_cfg import crop_part_args
    from video_classification_tpu_torch.ops.component_extents import (
        component_extents, component_extents_reference)
    from video_classification_tpu_torch.ops.components import part_mask
    from video_classification_tpu_torch.ops.label_components import (
        label_components, label_components_reference)
    from video_classification_tpu_torch.utils.cuda import build

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cs.log(f"package {Path(port.__file__).parent}")
    ext = build()

    def route(name, h, w):
        fn = getattr(ext, f"{name}_route", None)
        return fn(h, w) if fn else None

    rgb = torch.from_numpy(np.ascontiguousarray(cs.synthetic_videos(1)[0][0][::5][:20])).to(dev)
    padded = rgb.new_zeros((20, 480, 640, 3))
    padded[:, 120:360, 160:480] = rgb
    charts = cs.full_width_detector(dev, str(root / ".torch_ext" / "no_checkpoints"))(padded).charts

    for h, w in ((56, 56), (112, 112), (240, 320)):
        masks = cs.synthetic_part_masks(h, w, dev)
        if not torch.equal(label_components(masks), label_components_reference(masks)):
            raise AssertionError(f"K6 20x{h}x{w}: kernel and plain version differ")
        cs.time_labels(f"20x{h}x{w}", masks, route("label_components", h, w))
    k2 = {f"synthetic 20x{hm}x{hm}": cs.synthetic_part_masks(hm, hm, dev) for hm in (56, 112)}
    k2[f"densepose 20x{charts.shape[-2]}x{charts.shape[-1]}"] = (
        part_mask(charts, crop_part_args[0][0]).contiguous())
    for h, w in ((240, 320), (480, 640)):
        k2[f"densepose chart resized, 6 parts x{h}x{w}"] = cs.part_masks(
            cs.resized(charts[0], h, w))
    for what, masks in k2.items():
        h, w = masks.shape[1:]
        words = route("component_extents", h, w)
        if words is None and max(h, w) > 255:
            # A checkout without the routes has only the byte words, whose
            # binding refuses such masks.
            cs.log(json.dumps({"kernel": "K2", "masks": what, "refused": "H, W <= 255"}))
            continue
        got = component_extents(masks)
        if not all(torch.equal(a, b) for a, b in zip(got, component_extents_reference(masks))):
            raise AssertionError(f"K2 {what}: kernel and plain version differ")
        cs.time_extents(what, masks, 4 if max(h, w) <= 255 else 2, words)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
