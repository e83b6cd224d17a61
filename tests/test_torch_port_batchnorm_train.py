"""Train-mode BatchNorm of the PyTorch port against the JAX package (CPU).

The port's ``models/layers.BatchNorm`` in training mode against flax
``BatchNormLean`` with ``use_running_average=False`` and a mutable
``batch_stats``, on the same numpy-seeded (N, C, T, H, W) input
(channels-last on the JAX side), scale, bias and running statistics:

  * outputs and the gradients of input, scale and bias within
    atol = rtol = 1e-5 (float32; the sums run in another order);
  * running mean and variance after 1 and 3 updates within 1e-6;
  * the biased variance: a channel holding only 0 and 2 stores 1.0 (what
    ``torch.nn.BatchNorm3d`` would store is 2.0);
  * eval mode is unchanged: the running statistics, no update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.models.layers import BatchNormLean
from video_classification_tpu_torch.models.layers import BatchNorm
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (3, 6, 4, 5, 7)  # N, C, T, H, W


def _inputs(seed):
    rng = np.random.RandomState(seed)
    n, c = SHAPE[:2]
    return {
        "x": (rng.normal(0.3, 1.7, SHAPE)).astype(np.float32),
        "scale": rng.normal(1.0, 0.2, (c,)).astype(np.float32),
        "bias": rng.normal(0.0, 0.2, (c,)).astype(np.float32),
        "mean": rng.normal(0.0, 0.2, (c,)).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, (c,)).astype(np.float32),
        "g": rng.normal(0.0, 1.0, SHAPE).astype(np.float32),  # upstream gradient
    }


def _port(inp):
    bn = BatchNorm(SHAPE[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
        bn.running_mean.copy_(torch.from_numpy(inp["mean"]))
        bn.running_var.copy_(torch.from_numpy(inp["var"]))
    return bn.train()


def _jax_step(inp, x_nthwc, stats):
    """(y, vjp grads (x, scale, bias), new stats) of one flax train call."""
    bn = BatchNormLean(use_running_average=False)
    params = {"scale": jnp.asarray(inp["scale"]), "bias": jnp.asarray(inp["bias"])}

    def f(x, p):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    (y, new_stats), vjp = jax.vjp(f, jnp.asarray(x_nthwc), params)
    g = jnp.asarray(np.transpose(inp["g"], (0, 2, 3, 4, 1)))
    gx, gp = vjp((g, jax.tree_util.tree_map(jnp.zeros_like, new_stats)))
    return y, gx, gp, new_stats


def test_train_forward_and_gradients_match_flax():
    inp = _inputs(0)
    bn = _port(inp)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = bn(x)
    y.backward(torch.from_numpy(inp["g"]))

    stats = {"mean": jnp.asarray(inp["mean"]), "var": jnp.asarray(inp["var"])}
    jy, gx, gp, _ = _jax_step(inp, np.transpose(inp["x"], (0, 2, 3, 4, 1)), stats)
    to_ncthw = (0, 4, 1, 2, 3)
    np.testing.assert_allclose(y.detach().numpy(), np.transpose(np.asarray(jy), to_ncthw),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.transpose(np.asarray(gx), to_ncthw),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("updates", [1, 3])
def test_running_statistics_follow_flax(updates):
    inp = _inputs(1)
    bn = _port(inp)
    stats = {"mean": jnp.asarray(inp["mean"]), "var": jnp.asarray(inp["var"])}
    rng = np.random.RandomState(11)
    for _ in range(updates):
        x = rng.normal(-0.4, 2.3, SHAPE).astype(np.float32)
        with torch.no_grad():
            bn(torch.from_numpy(x))
        _, _, _, stats = _jax_step(inp, np.transpose(x, (0, 2, 3, 4, 1)), stats)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)


def test_running_variance_is_biased():
    """One channel of [0, 2] with momentum 0: the stored variance is the
    biased 1.0, as flax's; torch's BatchNorm3d stores the unbiased 2.0."""
    bn = BatchNorm(1, momentum=0.0).train()
    x = torch.tensor([0.0, 2.0]).reshape(2, 1, 1, 1, 1)
    bn(x)
    assert bn.running_mean.item() == 1.0 and bn.running_var.item() == 1.0
    ref = torch.nn.BatchNorm3d(1, momentum=1.0).train()
    ref(x)
    assert ref.running_var.item() == 2.0

    jbn = BatchNormLean(use_running_average=False, momentum=0.0)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.zeros((2, 1, 1, 1, 1)))
    _, mut = jbn.apply(variables, jnp.asarray([0.0, 2.0]).reshape(2, 1, 1, 1, 1),
                       mutable=["batch_stats"])
    assert float(mut["batch_stats"]["var"][0]) == 1.0


def test_eval_mode_uses_running_statistics_and_updates_nothing():
    inp = _inputs(2)
    bn = _port(inp).eval()
    x = torch.from_numpy(inp["x"])
    y = bn(x)
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    want = (x * inv.view(1, -1, 1, 1, 1)
            + (bn.bias - bn.running_mean * inv).view(1, -1, 1, 1, 1))
    torch.testing.assert_close(y, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(bn.running_mean.numpy(), inp["mean"])
    np.testing.assert_array_equal(bn.running_var.numpy(), inp["var"])
