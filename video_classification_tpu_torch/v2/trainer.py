"""v2 model manager and trainer.

Port of the JAX package's ``v2/trainer.py``: the v2 slice trains
``init_my_slowfast(cfg, (5, 2), (64, 8))``, rgb + uv (5 channels) on the
slow pathway and the 2-channel flow on the fast one, with SGD at momentum
0.9 (new_feature_test.py:715,731-739,832). Everything else (the epoch loop,
uniform-sampling eval with per-video mean scores, best-accuracy checkpoints)
is ``engine/trainer.Trainer``, given the v2 dataset and this model manager
through its ``dataset_factory`` and ``model_manager``.

The batch is split into its pathways first; each part is normalized as
``x.float() * (1 / 255)`` (a multiplication by that float32 constant, x/255
only, new_feature_test.py:600), cast to the compute dtype, and in training
cropped (RandomCrop, padding ``INPUT_SIZE // 10``, zero fill) at explicit
per-sample offsets, one window shared by both pathways. The JAX package's
``space_to_depth`` is a TPU layout and changes no value.

``torch.optim.SGD(lr, momentum=0.9)`` with dampening 0 and no Nesterov is
``optax.sgd(lr, momentum=0.9)``: a trace t = g + 0.9 t, then p - lr t.
"""

from __future__ import annotations

import torch

from ..engine.model_manager import ModelManager, _ncdhw
from ..engine.trainer import Trainer
from ..models.slowfast import init_my_slowfast
from ..utils.cuda import resolve_device
from .dataset import ChalearnGestureDataset

PATHWAYS = ((0, 5), (5, 7))  # slow: rgb + uv, fast: flow (new_feature_test.py:731-739)


class V2ModelManager(ModelManager):
    """``engine.ModelManager`` for the v2 (5, 2)-pathway model: the channels
    split into ``PATHWAYS``, the crop at ``MODEL.INPUT_SIZE`` and the v2
    normalization; the rest (seeded weights on the device, crop offsets,
    the NCDHW layout) is the base's."""

    def __init__(self, cfg, device=None):
        super().__init__(cfg, resolve_device(device))
        self._init = lambda c: init_my_slowfast(c, (5, 2), (64, 8))
        self._channels, self._layout = list(PATHWAYS), _ncdhw
        self.crop_size = int(cfg.MODEL.INPUT_SIZE)

    def _normalize(self, x_uint8: torch.Tensor) -> torch.Tensor:
        return (x_uint8.to(torch.float32) * (1.0 / 255.0)).to(self.compute_dtype)


class V2Trainer(Trainer):
    """``engine.Trainer`` with the v2 dataset (``parts``, read through
    ``io``), ``V2ModelManager`` and SGD at momentum 0.9."""

    def __init__(self, cfg, parts=None, io=None, device=None):
        def factory(c, name_of_set):
            return ChalearnGestureDataset(c, name_of_set, parts=parts, io=io)

        super().__init__(cfg, dataset_factory=factory,
                         model_manager=V2ModelManager(cfg, device), device=device)
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=float(cfg.MODEL.LR),
                                         momentum=0.9, dampening=0.0, nesterov=False)
