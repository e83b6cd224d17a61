"""The reference's first training steps of a stream, in float32.

What ``Trainer.train_step`` is to compute on a batch, step by step
(train.py:147-283 of the ChaLearn reference): normalize, RandomCrop at
offsets drawn from a generator seeded with the run's seed, the network in
training mode (batch statistics, the head's dropout drawing its mask from
the same generator), the mean cross-entropy, its gradients, and Adam with
torch's and optax's defaults (betas 0.9 / 0.999, eps 1e-8 outside the
square root, bias-corrected). The generator's draws are made in the order
the step makes them: the crop rows, then the crop columns, then the
dropout mask. Each block of the network is recomputed in its backward, so a
published batch of float32 activations fits on one card.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .slowfast import SlowFast, pathways

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def crop_offsets(n: int, h: int, w: int, size: int, generator: torch.Generator) -> torch.Tensor:
    pad = size // 10
    dev = generator.device
    oy = torch.randint(0, h + 2 * pad - size + 1, (n,), generator=generator, device=dev)
    ox = torch.randint(0, w + 2 * pad - size + 1, (n,), generator=generator, device=dev)
    return torch.stack([oy, ox], dim=1)


def train_steps(model: SlowFast, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                seed: int, lr: float, size: int) -> Dict:
    """Runs one step per (x (N, T, S, S, 21) uint8, labels (N,)) batch on
    ``model`` (its parameters updated in place). Returns {'loss': [per
    step], 'grad': {name: first step's gradient}, 'start': {name: initial
    parameter}} on the model's device."""
    dev = next(model.parameters()).device
    generator = torch.Generator(dev).manual_seed(int(seed))
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    model.train()
    model.set_checkpoint(True)
    losses: List[float] = []
    first_grad = {}
    for step, (x, labels) in enumerate(batches, start=1):
        x = x.to(dev)
        offsets = crop_offsets(x.shape[0], x.shape[2], x.shape[3], size, generator)
        logits = model(pathways(x, offsets, size), generator)
        loss = F.cross_entropy(logits, labels.to(dev).long())
        for p in params.values():
            p.grad = None
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, p in params.items():
                g = p.grad
                if step == 1:
                    first_grad[k] = g.clone()
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                c1, c2 = 1 - BETAS[0] ** step, 1 - BETAS[1] ** step
                denom = (v[k].sqrt() / c2 ** 0.5).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / c1)
    model.set_checkpoint(False)
    for p in params.values():
        p.grad = None
    return {"loss": losses, "grad": first_grad, "start": start}
