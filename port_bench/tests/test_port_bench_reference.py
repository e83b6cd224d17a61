"""The reference agrees with the program's plain path at a tiny size (CPU,
float32). The program is imported here, in the tests, never by the
reference."""

import pytest
import torch

from port_bench.harness.registry import Registry
from port_bench.harness.traffic import coherent_motion_frames
from port_bench.reference import flow, serve
from port_bench.reference.slowfast import SlowFast, pathways

stream_state_dict = Registry().model("slowfast_streams").stream_state_dict


def _frames(t=6, h=48, w=64, seed=3):
    return coherent_motion_frames(t, h, w, torch.Generator().manual_seed(seed))


def test_state_dict_loads_into_both():
    from video_classification_tpu_torch.config import load_model_cfg
    from video_classification_tpu_torch.models.slowfast import init_my_slowfast

    sd = stream_state_dict(249, 50, 11, "cpu")
    assert SlowFast(249, 50).load_state_dict(sd)
    port = init_my_slowfast(load_model_cfg("slowfast-HTAH"))
    port.load_state_dict(sd)
    assert sum(v.numel() for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))) == 34052161


def test_network_matches_the_program():
    from video_classification_tpu_torch.config import load_model_cfg
    from video_classification_tpu_torch.models.slowfast import init_my_slowfast

    cfg = load_model_cfg("slowfast-LHand", ["MODEL.DEPTH", "18", "CHALEARN.NUM_CLASS", "7"])
    sd = stream_state_dict(7, 18, 5, "cpu")
    port = init_my_slowfast(cfg).eval()
    port.load_state_dict(sd)
    ref = SlowFast(7, 18).eval()
    ref.load_state_dict(sd)
    x = torch.randint(0, 256, (2, 4, 32, 32, 21), generator=torch.Generator().manual_seed(1),
                      dtype=torch.uint8)
    with torch.no_grad():
        a = ref(pathways(x))
        b = port(pathways(x))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start", [0.0, 1.0])
def test_flow_level_matches_the_program(start):
    """One pyramid level from the same inputs: equal to float32 rounding."""
    from video_classification_tpu_torch.ops.flow_level import flow_level_reference

    fr = _frames().float() / 255.0
    u = torch.full((5, 48, 64), 1.2 * start)
    v = torch.full((5, 48, 64), -0.6 * start)
    p = flow.FlowParams(n_outer=3, n_sor=6, min_width=16)
    ur, vr = flow.flow_level(fr[:-1], fr[1:], u, v, p)
    up, vp, _ = flow_level_reference(fr[:-1], fr[1:], u, v, 3, 6, p.alpha, p.omega, p.eps,
                                     p.warp_radius, p.outer_tol)
    assert float((ur - up).abs().max()) < 1e-3 and float((vr - vp).abs().max()) < 1e-3


def test_flow_matches_the_program():
    """The whole pyramid, as the clips use it: the uint8 flow images. A
    pair's warp radius, ceil of its largest flow, jumps where that crosses
    an integer, so a rounding can move a few pixels far."""
    from video_classification_tpu_torch.ops.flow import FlowParams as PortParams
    from video_classification_tpu_torch.ops.flow import coarse2fine_flow, encode_flow_uint8

    fr = _frames().float() / 255.0
    p = flow.FlowParams(n_outer=3, n_sor=6, min_width=16)
    u, v = flow.coarse2fine(fr[:-1], fr[1:], p)
    pu, pv = coarse2fine_flow(fr[:-1], fr[1:], PortParams(n_outer=3, n_sor=6, min_width=16))
    a, b = flow.encode_flow_uint8(u, v).int(), encode_flow_uint8(pu, pv).int()
    assert float(((a - b).abs() <= 1).float().mean()) > 0.99
    assert float(u.abs().max()) > 0.5   # real motion


def test_window_crops_match_the_program():
    from video_classification_tpu_torch.ops.flow import FlowParams as PortParams
    from video_classification_tpu_torch.pipeline.online import OnlineVideoDataset
    from video_classification_tpu_torch.config import load_model_cfg

    rgb = coherent_motion_frames(45, 64, 96, torch.Generator().manual_seed(2))
    depth = rgb.float().mean(-1, keepdim=True).to(torch.uint8)
    cfg = load_model_cfg("slowfast-LHandArm", ["CHALEARN.CLIP_LEN", "4"])
    params = PortParams(n_outer=2, n_sor=2, min_width=16)
    ds = OnlineVideoDataset(cfg, "test", flow_params=params, videos={0: (rgb, depth)},
                            device="cpu")
    port = torch.stack(ds.get_eval_clips(0, None)["clips"])
    ref = serve.video_clips(rgb, depth, ["CropLHandArm"], 4, 5,
                            flow.FlowParams(n_outer=2, n_sor=2, min_width=16))["CropLHandArm"]
    assert port.shape == ref.shape == (2, 4, 128, 128, 21)
    diff = (port.int() - ref.int()).abs()
    assert float((diff <= 1).float().mean()) > 0.999
    assert int(diff.max()) <= 8


def test_train_steps_match_the_program(tiny_registry):
    """Three reference steps against ``Trainer.train_step`` on the same rows."""
    import time

    from port_bench.harness.core import execute

    out = execute(tiny_registry, "tiny.train", 2**31 + 99, 0.5, False, "cpu", time.perf_counter())
    nums = out["record"].numbers
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-5 and nums["update_gap"] < 1e-4
    assert out["result"]["correct"]


def test_serve_matches_the_program(tiny_registry):
    import time

    from port_bench.harness.core import execute

    out = execute(tiny_registry, "tiny.serve", 2**31 + 98, 0.5, False, "cpu", time.perf_counter())
    assert out["record"].numbers["logp_gap"] < 1e-3
    assert out["result"]["correct"] and out["record"].sampled == 2
