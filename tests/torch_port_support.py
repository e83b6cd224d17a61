"""Shared helpers of the PyTorch port's CPU tests.

The suite runs its test files in several processes at once; torch's default
one-thread-per-core intra-op pool in each of them oversubscribes the CPU
(measured: the port's files took 5x longer in parallel). The port's tests
run torch single-threaded, and put the setting back afterwards.

``randomised_variables`` fills a flax variable tree of shapes (from
``jax.eval_shape`` of a model's init, so nothing compiles) from a numpy
seed, for weights that both packages can be given; ``detector_variables``
does so for the DensePose detector. ``configure_serving``
and ``read_video`` are the small serving fixture's settings and decoder,
shared by the serving-slice tests.
"""

import numpy as np
import pytest
import torch


def randomised_variables(shapes, seed: int):
    """kernels N(0, 1/fan_in) (fan_in: every kernel dim but the last);
    norm scales N(1, 0.2); biases and BN means N(0, 0.2); BN variances
    U(0.5, 1.5), so no frozen BN is an identity. Returns
    {'params', 'batch_stats'} of float32 numpy arrays."""
    rng = np.random.RandomState(seed)

    def fill(node):
        out = {}
        for k, v in node.items():
            if hasattr(v, "items"):
                out[k] = fill(v)
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
            elif k == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif k == "scale":
                a = rng.normal(1, 0.2, shape)
            else:  # bias, mean
                a = rng.normal(0, 0.2, shape)
            out[k] = a.astype(np.float32)
        return out

    return {c: fill(shapes[c]) for c in ("params", "batch_stats") if c in shapes}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def detector_variables(shapes, seed: int):
    """``randomised_variables`` of a JAX DensePoseRCNN with its box-delta
    layers scaled by 0.02: decoded boxes then stay near their anchors,
    overlap and have area, so both NMS passes suppress and the ROIs are real
    boxes (unscaled, random deltas give zero-area boxes)."""
    variables = randomised_variables(shapes, seed)
    for module, layer in (("rpn", "deltas"), ("box_head", "box")):
        leaves = variables["params"][module][layer]
        for leaf in leaves:
            leaves[leaf] *= 0.02
    return variables


def configure_serving(c, root):
    """Either package's config for the 64x96 serving fixture: depth 18,
    CLIP_LEN 2, CropLHand, reduced flow (2 outers, 4 sweeps, min width 16)."""
    c.CHALEARN.ROOT = str(root)
    c.CHALEARN.NUM_CLASS = 3
    c.CHALEARN.SAMPLE_CLASS = 3
    c.CHALEARN.CLIP_LEN = 2
    c.CHALEARN.BATCH_SIZE = 2
    c.MODEL.DEPTH = 18
    c.MODEL.NAME = "slowfast-port-test"
    c.MODEL.R3D_INPUT = "CropLHand"
    c.DATA.FLOW_OUTER = 2
    c.DATA.FLOW_SOR = 4
    c.DATA.FLOW_MIN_WIDTH = 16
    return c


def read_video(path, gray):
    """All frames of a video file, (T, H, W, 3) BGR or (T, H, W, 1) uint8."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)[..., None] if gray else frame)
    cap.release()
    return np.stack(frames)
