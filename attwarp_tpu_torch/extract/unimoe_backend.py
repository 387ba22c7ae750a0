"""Uni-MoE-2.0-Omni extraction backend: ``extract/qwen2vl_backend.py``'s
``Qwen2VLBackend`` (its chat template, prompt ids, generate call and
answer-only pass) over ``models/unimoe.py``'s model.

What differs is the image path: pixels are normalized by SigLIP's
statistics (mean and std 0.5) and go to the tower as they are
(``UniMoEModel.image_input``), one ``image_size`` square a sample (the
tower's learned positions fix it, and it is to be given: 384 px at the
published widths, 27 x 27 image tokens, no merge). ``moe_tally`` is the
decoder's device tally of routed pairs (``models/moe.py::MoETally``). Only
random weights are held: there is no checkpoint loading, and
``quantize_int8`` refuses the expert tree.
"""

from __future__ import annotations

import torch

from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
from attwarp_tpu_torch.extract.resize import clip_pixels
from attwarp_tpu_torch.models.moe import MoETally
from attwarp_tpu_torch.models.unimoe import SIGLIP_MEAN, SIGLIP_STD


class UniMoEBackend(Qwen2VLBackend):
    name = "unimoe-torch"

    def _check_image_size(self, image_size: int) -> None:
        if image_size != self.model.cfg.vision.image_size:
            raise ValueError(f"image_size {image_size}: the tower's learned positions "
                             f"take {self.model.cfg.vision.image_size} px only")

    @classmethod
    def load(cls, *args, **kwargs):
        raise NotImplementedError("UniMoEBackend holds random weights only")

    from_hf = load

    @property
    def moe_tally(self) -> MoETally:
        return self.model.tally

    @property
    def num_patches_side(self) -> int:
        return self.image_size // self.model.cfg.vision.patch_size

    def _pixels(self, images) -> torch.Tensor:
        return clip_pixels(images, self.image_size, self.device, SIGLIP_MEAN, SIGLIP_STD)
