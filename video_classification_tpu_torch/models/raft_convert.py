"""torchvision ``raft_large`` checkpoints for the port's RAFT.

The port's own copy of the JAX package's ``models/raft_convert.py`` key
inventory (``raft_key_shapes``) and synthesized state_dict
(``synthesize_raft_state_dict``): torchvision's released weights are not in
the repo, so tests and full-width runs use a state_dict of the released
grammar and shapes made from a seed. ``models/raft.RAFT`` names its modules
after that grammar, so ``load_raft_checkpoint`` loads a ``.pth`` with
``load_state_dict`` after the JAX loader's coverage check (a missing key
raises); ``write_synthesized_checkpoint`` saves the synthesized
state_dict as such a ``.pth``. ``flax_path`` maps a torchvision key to the
JAX package's flax module path, for the carry of the JAX variables
(``models/convert.raft_state_dict_from_jax``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

_BLOCKS = [(64, 64, 1), (64, 64, 1), (64, 96, 2), (96, 96, 1),
           (96, 128, 2), (128, 128, 1)]  # (in, out, stride) per residual unit


def _bn_keys(prefix: str, ch: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.weight", (ch,)), (f"{prefix}.bias", (ch,)),
            (f"{prefix}.running_mean", (ch,)), (f"{prefix}.running_var", (ch,)),
            (f"{prefix}.num_batches_tracked", ())]


def raft_key_shapes() -> Dict[str, tuple]:
    """Full torchvision raft_large state_dict key -> shape map."""
    keys: List[Tuple[str, tuple]] = []
    for enc, batchnorm in (("feature_encoder", False), ("context_encoder", True)):
        keys.append((f"{enc}.convnormrelu.0.weight", (64, 3, 7, 7)))
        keys.append((f"{enc}.convnormrelu.0.bias", (64,)))
        if batchnorm:
            keys += _bn_keys(f"{enc}.convnormrelu.1", 64)
        for idx, (cin, cout, stride) in enumerate(_BLOCKS):
            layer, j = idx // 2 + 1, idx % 2
            p = f"{enc}.layer{layer}.{j}"
            keys.append((f"{p}.convnormrelu1.0.weight", (cout, cin, 3, 3)))
            keys.append((f"{p}.convnormrelu1.0.bias", (cout,)))
            if batchnorm:
                keys += _bn_keys(f"{p}.convnormrelu1.1", cout)
            keys.append((f"{p}.convnormrelu2.0.weight", (cout, cout, 3, 3)))
            keys.append((f"{p}.convnormrelu2.0.bias", (cout,)))
            if batchnorm:
                keys += _bn_keys(f"{p}.convnormrelu2.1", cout)
            if stride != 1 or cin != cout:
                keys.append((f"{p}.downsample.0.weight", (cout, cin, 1, 1)))
                keys.append((f"{p}.downsample.0.bias", (cout,)))
                if batchnorm:
                    keys += _bn_keys(f"{p}.downsample.1", cout)
        keys.append((f"{enc}.conv.weight", (256, 128, 1, 1)))
        keys.append((f"{enc}.conv.bias", (256,)))
    me = "update_block.motion_encoder"
    corr_ch = 4 * 81  # 4 pyramid levels x (2*4+1)^2 lookup window
    for name, cout, cin, k in (("convcorr1", 256, corr_ch, 1),
                               ("convcorr2", 192, 256, 3),
                               ("convflow1", 128, 2, 7),
                               ("convflow2", 64, 128, 3),
                               ("conv", 126, 256, 3)):
        keys.append((f"{me}.{name}.0.weight", (cout, cin, k, k)))
        keys.append((f"{me}.{name}.0.bias", (cout,)))
    for gru, kern in (("convgru1", (1, 5)), ("convgru2", (5, 1))):
        for gate in ("convz", "convr", "convq"):
            keys.append((f"update_block.recurrent_block.{gru}.{gate}.weight",
                         (128, 384) + kern))
            keys.append((f"update_block.recurrent_block.{gru}.{gate}.bias", (128,)))
    keys += [("update_block.flow_head.conv1.weight", (256, 128, 3, 3)),
             ("update_block.flow_head.conv1.bias", (256,)),
             ("update_block.flow_head.conv2.weight", (2, 256, 3, 3)),
             ("update_block.flow_head.conv2.bias", (2,)),
             ("mask_predictor.convrelu.0.weight", (256, 128, 3, 3)),
             ("mask_predictor.convrelu.0.bias", (256,)),
             ("mask_predictor.conv.weight", (576, 256, 1, 1)),
             ("mask_predictor.conv.bias", (576,))]
    return dict(keys)


def synthesize_raft_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    out = {}
    for k, shape in raft_key_shapes().items():
        if k.endswith("num_batches_tracked"):
            out[k] = np.asarray(0, np.int64)
        elif k.endswith("running_var"):
            out[k] = (0.5 + rng.rand(*shape)).astype(np.float32)
        else:
            out[k] = (rng.randn(*shape) * 0.05).astype(np.float32)
    return out


# The JAX package's flax module names inside its RAFT, for the carry of its
# variables (models/convert.raft_state_dict_from_jax).
_MOTION = {"convcorr1": "convc1", "convcorr2": "convc2",
           "convflow1": "convf1", "convflow2": "convf2", "conv": "conv"}
_GRU_SUFFIX = {"convgru1": "1", "convgru2": "2"}


def _encoder_path(enc_flax: str, sub: List[str]):
    """('fnet'|'cnet', torch module parts) -> (flax path, is_norm)."""
    if sub[0] == "convnormrelu":
        return (enc_flax, "conv1" if sub[1] == "0" else "norm1"), sub[1] == "1"
    if sub[0] == "conv":
        return (enc_flax, "conv2"), False
    layer = int(sub[0].replace("layer", ""))
    j = int(sub[1])
    res = f"res{2 * (layer - 1) + j}"
    mod = sub[2]
    if mod == "downsample":
        name = "downsample" if sub[3] == "0" else "norm3"
        return (enc_flax, res, name), sub[3] == "1"
    # convnormrelu1 / convnormrelu2
    idx = mod[-1]
    name = f"conv{idx}" if sub[3] == "0" else f"norm{idx}"
    return (enc_flax, res, name), sub[3] == "1"


def flax_path(key: str) -> Tuple[Tuple[str, ...], bool]:
    """torchvision key -> (the JAX RAFT's flax module path, is a norm)."""
    parts = key.split(".")
    mods = parts[:-1]
    if mods[0] == "feature_encoder":
        return _encoder_path("fnet", mods[1:])
    if mods[0] == "context_encoder":
        return _encoder_path("cnet", mods[1:])
    if mods[0] == "update_block":
        sub = mods[1:]
        if sub[0] == "motion_encoder":
            return ("update_block", "encoder", _MOTION[sub[1]]), False
        if sub[0] == "recurrent_block":
            gate = sub[2]  # convz|convr|convq
            return ("update_block", "gru", gate + _GRU_SUFFIX[sub[1]]), False
        if sub[0] == "flow_head":
            n = sub[1][-1]  # conv1|conv2
            return ("update_block", f"flow_head{n}"), False
    if mods[0] == "mask_predictor":
        name = "mask1" if mods[1] == "convrelu" else "mask2"
        return ("update_block", name), False
    raise KeyError(f"unrecognized torchvision RAFT key: {key}")


def raft_coverage_report(keys: Iterable[str]) -> Dict[str, list]:
    expected = set(raft_key_shapes())
    got = set(keys)
    return {"missing": sorted(expected - got), "unexpected": sorted(got - expected)}


def read_raft_state_dict(path) -> Dict[str, torch.Tensor]:
    """A torchvision raft_large ``.pth`` (a state_dict, a module, or a dict
    with a ``model`` state_dict) -> its state_dict, on the CPU. Raises if a
    key of ``raft_key_shapes`` is missing."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    report = raft_coverage_report(sd)
    if report["missing"]:
        raise ValueError(f"checkpoint missing {len(report['missing'])} keys, "
                         f"first: {report['missing'][:5]}")
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def load_raft_checkpoint(path, model):
    """Load a torchvision raft_large ``.pth`` into the port's ``RAFT``
    (strict: an unexpected key raises too). Returns the model."""
    model.load_state_dict(read_raft_state_dict(path))
    return model


def synthesized_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """``synthesize_raft_state_dict`` as tensors, for ``load_state_dict``."""
    return {k: torch.from_numpy(np.array(v))  # np.array keeps 0-d arrays 0-d
            for k, v in synthesize_raft_state_dict(seed).items()}


def write_synthesized_checkpoint(path, seed: int = 0):
    """Save ``synthesized_state_dict(seed)`` as a torchvision-grammar
    ``.pth`` at ``path`` (what ``--raft-checkpoint`` reads); returns it."""
    torch.save(synthesized_state_dict(seed), path)
    return path
