"""torchvision ``raft_large`` checkpoints for the port's RAFT
(``models/raft_convert.py``, ``models/convert.raft_state_dict_from_jax``)
against the JAX package's converter (CPU).

  * the port's key inventory equals the JAX ``raft_key_shapes()``, and the
    port's ``RAFT`` state_dict has exactly those keys and shapes;
  * the synthesized state_dicts are equal, seed for seed, and load into the
    port with no missing or unexpected key;
  * the port on a synthesized state_dict equals the JAX RAFT on
    ``raft_torch_to_flax`` of the same dict (64x96, 4 iterations, float32,
    atol = rtol = 5e-3), and carrying the JAX variables back
    (``raft_state_dict_from_jax``) gives the dict again, exactly;
  * a ``.pth`` written with ``torch.save`` round-trips through
    ``load_raft_checkpoint`` (also wrapped as ``{"model": ...}``); a
    checkpoint missing a key raises before loading, as the JAX loader does,
    and an unexpected key raises too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.models.raft import RAFT as JaxRAFT
from video_classification_tpu.models.raft_convert import (load_raft_checkpoint as
                                                          jax_load_raft_checkpoint)
from video_classification_tpu.models.raft_convert import raft_key_shapes as jax_key_shapes
from video_classification_tpu.models.raft_convert import raft_torch_to_flax
from video_classification_tpu.models.raft_convert import (synthesize_raft_state_dict as
                                                          jax_synthesize)
from video_classification_tpu_torch.models.convert import raft_state_dict_from_jax
from video_classification_tpu_torch.models.raft import RAFT
from video_classification_tpu_torch.models.raft_convert import (load_raft_checkpoint,
                                                                raft_coverage_report,
                                                                raft_key_shapes,
                                                                synthesize_raft_state_dict,
                                                                synthesized_state_dict)
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def test_key_inventory_equals_jax_and_the_port_module():
    assert raft_key_shapes() == jax_key_shapes()
    sd = RAFT().state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == jax_key_shapes()


@pytest.mark.parametrize("seed", [0, 3])
def test_synthesized_state_dict_equals_jax_and_loads(seed):
    got, want = synthesize_raft_state_dict(seed), jax_synthesize(seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert raft_coverage_report(got) == {"missing": [], "unexpected": []}
    result = RAFT().load_state_dict(synthesized_state_dict(seed))
    assert not result.missing_keys and not result.unexpected_keys


def test_port_on_torchvision_weights_equals_jax_on_converted_ones():
    sd = synthesize_raft_state_dict(1)
    variables = raft_torch_to_flax(sd)
    rng = np.random.RandomState(4)
    a = rng.rand(2, 64, 96, 3).astype(np.float32)
    b = np.roll(a, 3, axis=2)
    want_up, want_coarse = (np.asarray(t) for t in JaxRAFT(num_iters=4).apply(
        variables, jnp.asarray(a), jnp.asarray(b)))
    model = RAFT(num_iters=4)
    model.load_state_dict(synthesized_state_dict(1))
    with torch.no_grad():
        up, coarse = model.eval()(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(up.numpy(), want_up, atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(coarse.numpy(), want_coarse, atol=5e-3, rtol=5e-3)
    back = raft_state_dict_from_jax(variables)
    assert list(back) == list(sd)
    for k, v in back.items():
        assert np.array_equal(v.numpy(), np.asarray(sd[k], dtype=v.numpy().dtype)), k


@pytest.mark.parametrize("wrap", [False, True])
def test_pth_round_trip(tmp_path, wrap):
    sd = synthesized_state_dict(3)
    path = tmp_path / "raft_large_fake.pth"
    torch.save({"model": sd} if wrap else sd, path)
    model = load_raft_checkpoint(path, RAFT())
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # The JAX loader reads the same file into the same weights.
    variables = jax_load_raft_checkpoint(path)
    np.testing.assert_array_equal(
        variables["params"]["fnet"]["conv1"]["kernel"],
        model.feature_encoder.convnormrelu[0].weight.detach().numpy().transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(variables["batch_stats"]["cnet"]["norm1"]["var"],
                                  model.context_encoder.convnormrelu[1].running_var.numpy())


def test_missing_or_unexpected_keys_raise(tmp_path):
    sd = synthesized_state_dict(0)
    missing = dict(sd)
    del missing["mask_predictor.conv.bias"]
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(ValueError, match="missing 1 keys"):
        load_raft_checkpoint(tmp_path / "missing.pth", RAFT())
    extra = dict(sd, **{"update_block.extra.weight": torch.zeros(3)})
    torch.save(extra, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_raft_checkpoint(tmp_path / "extra.pth", RAFT())
