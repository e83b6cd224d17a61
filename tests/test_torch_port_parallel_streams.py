"""The port's stream-parallel training (engine/parallel_streams.py) against
the JAX package's (CPU, in this process):

  * ``assign_device_groups`` equals JAX's on lists of labels, over a grid
    of device counts, streams and devices per stream (round-robin reuse
    when the streams outnumber the groups);
  * with injected factories, as tests/test_parallel_streams.py does: every
    stream's result comes from its own config, each trainer gets its
    group's device, every trainer is built before any trains, and a failed
    stream is named in the raised error
    (chained to its exception) while the others finish and are reported;
  * each stream's checkpoint from ``train_streams_parallel`` (two tiny
    synthetic streams in two threads on the CPU) equals, tensor for tensor,
    the one its sequential ``Trainer.train()`` writes;
  * a group of two devices (two CPU "devices") trains its stream
    data-parallel through two CLI ranks (gloo, a free port, a timeout) and
    returns rank 0's accuracy; a failed rank is named.
"""

import pytest
import torch

from video_classification_tpu.engine.parallel_streams import (
    assign_device_groups as jax_assign_device_groups)
from video_classification_tpu_torch.engine import Trainer
from video_classification_tpu_torch.engine import parallel_streams as ps
from video_classification_tpu_torch.engine.checkpoint import ckpt_dir
from torch_port_ranks import tiny_cfg
from test_torch_port_parallel_cli import OPTS
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
@pytest.mark.parametrize("n_streams", [1, 2, 5, 6])
@pytest.mark.parametrize("per", [0, 1, 2, 4])
def test_assign_device_groups_equals_jax(n_devices, n_streams, per):
    labels = [f"dev{i}" for i in range(n_devices)]
    got = ps.assign_device_groups(labels, n_streams, per)
    assert got == jax_assign_device_groups(labels, n_streams, per)
    assert len(got) == n_streams and all(got)


def test_results_are_not_mixed_up_and_devices_are_the_groups(capsys):
    seen, events = {}, []

    class Stub:
        def __init__(self, cfg, device):
            self.cfg, self.device = cfg, device
            events.append("built")

        def train(self):
            events.append("train")
            seen[self.cfg.MODEL.NAME] = self.device
            return self.cfg.CHALEARN.NUM_CLASS / 10

    def cfg_factory(name):
        cfg = tiny_cfg("/nonexistent")
        cfg.MODEL.NAME = name
        cfg.CHALEARN.NUM_CLASS = {"a": 3, "b": 7, "c": 5}[name]
        return cfg

    results = ps.train_streams_parallel(["a", "b", "c"], cfg_factory=cfg_factory,
                                        trainer_factory=Stub, devices=["d0", "d1"])
    assert results == {"a": 0.3, "b": 0.7, "c": 0.5}
    assert seen == {"a": "d0", "b": "d1", "c": "d0"}  # round-robin reuse
    assert events == ["built"] * 3 + ["train"] * 3  # no stream trains before all are built
    out = capsys.readouterr().out
    assert "stream a: done, best acc 0.3000" in out and "stream c: done" in out


def test_a_failed_stream_is_named():
    class Stub:
        def __init__(self, cfg, device):
            self.cfg = cfg

        def train(self):
            if self.cfg.MODEL.NAME == "bad":
                raise KeyError("no crops for bad")
            return 0.5

    def cfg_factory(name):
        cfg = tiny_cfg("/nonexistent")
        cfg.MODEL.NAME = name
        return cfg

    with pytest.raises(RuntimeError, match=r"1/2 streams failed \(bad: KeyError") as info:
        ps.train_streams_parallel(["good", "bad"], cfg_factory=cfg_factory,
                                  trainer_factory=Stub, devices=["cpu"])
    assert "completed: ['good']" in str(info.value)
    assert isinstance(info.value.__cause__, KeyError)


def test_checkpoints_equal_the_sequential_runs(tmp_path):
    names = ["slowfast-a", "slowfast-b"]

    def cfg_factory(root):
        def make(name):
            cfg = tiny_cfg(root)
            cfg.MODEL.NAME = name
            cfg.CUDA.SEED = names.index(name) + 1
            return cfg
        return make

    results = ps.train_streams_parallel(names, cfg_factory=cfg_factory(tmp_path / "par"),
                                        device="cpu")
    for name in names:
        cfg = cfg_factory(tmp_path / "seq")(name)
        assert Trainer(cfg, device="cpu").train() == results[name]
        par = sorted(ckpt_dir(cfg_factory(tmp_path / "par")(name)).glob("*.ckpt"))
        seq = sorted(ckpt_dir(cfg).glob("*.ckpt"))
        assert [p.name for p in par] == [p.name for p in seq] and seq
        for a, b in zip(par, seq):
            sa, sb = torch.load(a), torch.load(b)
            assert set(sa) == set(sb)
            for k in sb:
                assert torch.equal(sa[k], sb[k]), (name, k)


def test_visible_devices():
    assert ps.visible_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ps.visible_devices()


def test_a_group_of_two_devices_trains_data_parallel(tmp_path):
    acc = ps.train_data_parallel("slowfast-Torso", ["CHALEARN.ROOT", str(tmp_path)] + OPTS[1:],
                                 ["cpu", "cpu"], timeout_s=150)
    assert 0.0 <= acc <= 1.0
    assert list((tmp_path / "logs" / "checkpoints" / "slowfast-Torso").glob("*.ckpt"))
    with pytest.raises(RuntimeError, match="rank 0 of 2 exited"):
        ps.train_data_parallel("slowfast-Torso", ["CHALEARN.NO_SUCH_KEY", "1"],
                               ["cpu", "cpu"], timeout_s=150)
