"""The port's DensePose R-CNN against the JAX package's (CPU, float32).

One JAX run of the depth-50 detector on a unit-scale 100x172 frame (padded
to 128x192 inside; at pixel scale, float32 rounding of the large
activations alone exceeds atol 1e-4), with numpy-seeded weights carried
across by ``detect.state_dict_from_jax`` and every submodule's output
captured (``capture_intermediates``). Each port module then runs on the captured
input of its JAX counterpart, at atol 1e-4 (rtol 1e-5 for the deep backbone
outputs); the whole detector runs on the frame itself, at the bars: valid
equal, boxes within 1e-3 px, scores within 1e-4, charts equal on >= 99.9 %
of pixels and U/V within 1e-3 where they agree. The GroupNorm and
reduction orders differ in the last bits between the two, so a near-tied
chart argmax may flip; the other bars are far above float32 rounding.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.detect import DensePoseRCNN as JaxRCNN
from video_classification_tpu.detect import d2_to_flax
from video_classification_tpu.detect import ops as jops
from video_classification_tpu_torch.detect import (DensePoseRCNN, load_densepose_state_dict,
                                                   state_dict_from_jax, synthesize_state_dict)
from video_classification_tpu_torch.detect.convert import torch_module_name
from torch_port_support import detector_variables, one_torch_thread  # noqa: F401

BUDGET = dict(depth=50, pre_nms_topk=32, post_nms_topk=8, max_detections=2,
              chart_pooler_size=14)
HW = (100, 172)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def run():
    model = JaxRCNN(**BUDGET)
    rng = np.random.RandomState(0)
    image = rng.randn(*HW, 3).astype(np.float32)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), jnp.asarray(image))
    variables = detector_variables(shapes, seed=1)
    apply = jax.jit(lambda v, x: model.apply(
        v, x, train=False, capture_intermediates=True, mutable=["intermediates"]))
    out, state = apply(variables, jnp.asarray(image))
    inter = jax.device_get(state["intermediates"])
    out = jax.device_get(out)
    rois = jops.roi_align(jnp.asarray(inter["decoder"]["__call__"][0][0]),
                          jnp.asarray(out["boxes"]), BUDGET["chart_pooler_size"], 0.25)
    port = DensePoseRCNN(**BUDGET).eval()
    port.load_state_dict(state_dict_from_jax(variables))
    return {"variables": variables, "image": image, "out": out, "inter": inter,
            "rois": np.asarray(rois), "port": port}


def _close(got, want, atol=1e-4, rtol=0.0):
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@torch.no_grad()
def test_bottleneck_stride_in_1x1_matches_jax(run):
    bb = run["inter"]["backbone"]
    block = run["port"].backbone.bottom_up.res3[0]  # stride 2, shortcut conv
    assert block.conv1.stride == (2, 2) and block.conv2.stride == (1, 1)
    got = block(_nchw(bb["res2_2"]["__call__"][0]))
    _close(_nhwc(got), bb["res3_0"]["__call__"][0])


@torch.no_grad()
def test_resnet_fpn_matches_jax(run):
    padded = np.zeros((1, 128, 192, 3), np.float32)
    padded[0, :HW[0], :HW[1]] = run["image"]
    got = run["port"].backbone(_nchw(padded))
    want = run["inter"]["backbone"]["__call__"][0]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), w, rtol=1e-5)


@torch.no_grad()
def test_decoder_matches_jax(run):
    feats = run["inter"]["backbone"]["__call__"][0][:4]
    got = run["port"].roi_heads["decoder"]([_nchw(f) for f in feats])
    _close(_nhwc(got), run["inter"]["decoder"]["__call__"][0], rtol=1e-5)


@torch.no_grad()
def test_aspp_and_deeplab_head_match_jax(run):
    head = run["port"].roi_heads["densepose_head"]
    rois = _nchw(run["rois"])
    want = run["inter"]["densepose_head"]
    _close(_nhwc(head.ASPP(rois)), want["ASPP"]["__call__"][0])
    _close(_nhwc(head(rois)), want["__call__"][0])


@torch.no_grad()
def test_chart_predictor_matches_jax(run):
    x = _nchw(run["inter"]["densepose_head"]["__call__"][0])
    got = run["port"].roi_heads["densepose_predictor"](x)
    want = run["inter"]["densepose_predictor"]["__call__"][0]
    for g, w in zip(got, want):
        assert g.shape[-1] == 4 * BUDGET["chart_pooler_size"]
        _close(_nhwc(g), w)


def _assert_detections_close(got, want):
    """got/want: dicts of numpy arrays of one frame."""
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    same = got["charts"] == want["charts"]
    assert same.mean() >= 0.999, same.mean()
    for f in ("u", "v"):
        np.testing.assert_allclose(got[f][same], want[f][same], atol=1e-3)


@torch.no_grad()
def test_detector_matches_jax(run):
    res = run["port"](torch.from_numpy(run["image"]).permute(2, 0, 1)[None])
    got = {k: v[0].numpy() for k, v in res.items()}
    want = {k: np.asarray(v) for k, v in run["out"].items()}
    assert got["charts"].shape == want["charts"].shape == (2, 56, 56)
    assert got["boxes"][:, 2].max() <= HW[1] and got["boxes"][:, 3].max() <= HW[0]
    _assert_detections_close(got, want)


@torch.no_grad()
def test_batch_equals_frames(run):
    rng = np.random.RandomState(2)
    frames = torch.from_numpy((rng.randn(3, 3, *HW) * 40).astype(np.float32))
    batch = run["port"](frames)
    for i in range(3):
        one = run["port"](frames[i:i + 1])
        _assert_detections_close({k: v[i].numpy() for k, v in batch.items()},
                                 {k: v[0].numpy() for k, v in one.items()})


def test_converter_is_strict(run):
    sd = state_dict_from_jax(run["variables"])
    result = DensePoseRCNN(**BUDGET).load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(run["port"].state_dict())
    with pytest.raises(KeyError):
        torch_module_name(("backbone", "res2_0", "conv4"))
    with pytest.raises(KeyError):
        torch_module_name(("roi_heads", "mystery"))


def test_d2_pkl_loads_as_jax_conversion_carried(tmp_path):
    sd = synthesize_state_dict(depth=50, seed=7)
    sd["backbone.bottom_up.stem.conv1.norm.num_batches_tracked"] = np.zeros((), np.int64)
    pkl = tmp_path / "model_final_fake.pkl"
    with pkl.open("wb") as f:
        pickle.dump({"model": sd, "__author__": "test"}, f)
    loaded = load_densepose_state_dict(pkl, depth=50)
    carried = state_dict_from_jax(d2_to_flax(sd))
    assert set(loaded) == set(carried)
    for k, v in carried.items():
        assert loaded[k].dtype == v.dtype == torch.float32
        assert torch.equal(loaded[k], v), k
    DensePoseRCNN(depth=50).load_state_dict(loaded, strict=True)

    extra = dict(sd, **{"made.up.key": np.zeros((1,), np.float32)})
    short = {k: v for k, v in sd.items() if k != "roi_heads.box_head.fc1.weight"}
    for bad, what in ((extra, "unexpected"), (short, "missing")):
        with pkl.open("wb") as f:
            pickle.dump({"model": bad}, f)
        with pytest.raises(ValueError, match=what):
            load_densepose_state_dict(pkl, depth=50)
