"""The AttWarp two-pass pipeline (counterpart of ``attwarp_tpu/pipeline.py``).

Run the MLLM once to extract the question-conditioned attention, build the
MOTA mask, warp the image so attended regions are magnified, and run the
MLLM again on the warped image for the answer (reference ``new_method.py``
example_workflow + main + second pass, :30-130, :508-615):

    from attwarp_tpu_torch.pipeline import AttWarpPipeline
    pipe = AttWarpPipeline(backend)            # extract.llava_backend or
                                               # extract.qwen2vl_backend
    result = pipe.run(images, questions)
    result.second_answers

One flow, the math of the JAX ``_run_device`` (and of its host ``run``,
which JAX takes for backends without device pixels, as its Qwen2-VL
backend): pixels stay on the backend's device from the first resize to the
second pass; masks and warps run per group of images that share a raw
shape, a [0, 1] scale and a bucketed size. Maps are (B, n, n) for any n
(24 for LLaVA-1.5; image_size / 28 for Qwen2-VL).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from attwarp_tpu_torch.extract.resize import (
    resize_images_batch,
    resize_scale_device,
    to01_scale,
)
from attwarp_tpu_torch.utils import profiling
from attwarp_tpu_torch.warp.blend import mota_mask
from attwarp_tpu_torch.warp.transforms import Transform, WarpParams
from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

# the id every span of one ``run`` carries (``batch``)
_batch_ids = itertools.count()


@dataclass
class AttWarpResult:
    warped: np.ndarray               # (B, warp_size, warp_size, 3) float32 in [0, 255]
    attention_maps: np.ndarray       # (B, n, n) extracted maps
    mota_masks: List[np.ndarray]     # per-sample (H, W) masks (uint8 by default)
    first_answers: List[str]         # answers from the extraction pass
    second_answers: Optional[List[str]] = None  # answers on the warped images


@dataclass
class AttWarpPipeline:
    """backend: an extraction backend with ``device``, ``image_size``,
    ``extract`` and ``answer_batch`` (``extract.llava_backend.LlavaBackend``,
    ``extract.qwen2vl_backend.Qwen2VLBackend``).

    ``warp_size``: output H=W of the warped image; ``enhance_coe`` and
    ``kernel_size``: MOTA mask parameters; ``transform`` and its parameters:
    the attention transform of the warp. With ``size_bucket > 0`` each image
    is resized so H and W round up to a multiple of it (capped at
    ``max_side``) before the mask and the warp, as in JAX."""

    backend: object
    warp_size: int = 500
    enhance_coe: float = 10.0
    kernel_size: int = 3
    transform: Transform = Transform.IDENTITY
    exp_scale: float = 1.0
    exp_divisor: float = 1.0
    apply_inverse: bool = False
    max_new_tokens: int = 20
    second_pass: bool = True
    quantize_like_reference: bool = True
    size_bucket: int = 64
    max_side: int = 1024
    params: WarpParams = field(init=False)

    def __post_init__(self):
        self.params = WarpParams(
            transform=self.transform,
            exp_scale=self.exp_scale,
            exp_divisor=self.exp_divisor,
            apply_inverse_to_marginals=self.apply_inverse,
        )

    def run(self, images: Sequence[np.ndarray],
            questions: Sequence[str]) -> AttWarpResult:
        if len(images) != len(questions):
            raise ValueError(f"{len(images)} images but {len(questions)} questions")
        with profiling.span("pipeline.run", batch=next(_batch_ids)):
            B = len(images)
            arrs = [np.asarray(im) for im in images]
            dev = self.backend.device
            size = self.backend.image_size

            # pass 1: extraction on device-resized pixels
            with profiling.span("pipeline.resize"):
                pix1 = resize_images_batch(arrs, size, dev)
            maps, first_answers = self.backend.extract(
                pix1, list(questions), max_new_tokens=self.max_new_tokens)
            if maps.ndim == 4:  # a sequence of extract layers: the first is primary
                maps = maps[0]

            # mask + warp per (raw shape, scale, bucketed shape) group
            S = self.warp_size
            groups: dict = {}
            for b, a in enumerate(arrs):
                tgt = self._bucket_target(a.shape[:2])
                groups.setdefault((a.shape, to01_scale(a), tgt), []).append(b)
            masks: List[Optional[np.ndarray]] = [None] * B
            warped = torch.empty((B, S, S, 3), dtype=torch.float32, device=dev)
            for (shape, scale01, tgt), idxs in groups.items():
                with profiling.span("pipeline.group", shape=list(shape), n=len(idxs)):
                    batch = torch.as_tensor(np.stack([arrs[b] for b in idxs])).to(dev)
                    img255 = resize_scale_device(batch, 255.0 * scale01, tgt)
                    sel = torch.as_tensor(idxs, device=dev)
                    with profiling.span("pipeline.mask"):
                        g_masks = mota_mask(
                            maps[sel], tgt, enhance_coe=self.enhance_coe,
                            kernel_size=self.kernel_size,
                            quantize_like_reference=self.quantize_like_reference,
                        )
                    with profiling.span("pipeline.warp"):
                        warped[sel] = warp_batch_by_attention(
                            img255, g_masks.to(torch.float32), S, S, self.params)
                    with profiling.span("pipeline.to_host"):
                        for j, m in zip(idxs, g_masks.cpu().numpy()):
                            masks[j] = m

            second_answers = None
            if self.second_pass:
                with profiling.span("pipeline.resize"):
                    pix2 = resize_scale_device(warped, 1.0 / 255.0, (size, size))
                second_answers = self.backend.answer_batch(
                    pix2, list(questions), max_new_tokens=self.max_new_tokens)

            with profiling.span("pipeline.to_host"):
                warped_np, maps_np = warped.cpu().numpy(), maps.cpu().numpy()
            return AttWarpResult(
                warped=warped_np,
                attention_maps=maps_np,
                mota_masks=masks,
                first_answers=list(first_answers),
                second_answers=second_answers,
            )

    def _bucket_target(self, hw) -> tuple:
        """Bucketed (H, W) for a raw image size."""
        if self.size_bucket <= 0:
            return (int(hw[0]), int(hw[1]))
        b = self.size_bucket

        def snap(n):
            return min(((n + b - 1) // b) * b, self.max_side)

        return (snap(int(hw[0])), snap(int(hw[1])))
