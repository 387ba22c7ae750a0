"""Stable Diffusion cross-attention capture for the SD-warp ablation
(counterpart of ``attwarp_tpu/warp/sd_capture.py``; reference
``Ablations/Stable_diffusion_based_warp.py``).

The diffusers half of ``warp/cross_attention.py``: everything between
"load a pipeline" and "hand ``run_cross_attention_warp`` a captured-map
dict". Image -> latent (:233-244), prompt -> embeddings (:249-262), the
truncated DDIM inversion (:264-287) as a fold of ``_renoise`` over
consecutive noise levels, and one forward denoise per inversion snapshot
(:292-305) with recording processors on every cross-attention ("attn2")
layer in place of the third-party ``attention_map_diffusers`` hooks.

Captured-map convention: ``{timestep: {layer_key: (B, heads, H, W,
tokens)}}``, each map a detached f32 tensor on the device it was computed
on (the card for a pipeline there).

Everything is duck-typed against the diffusers pipeline surface
(``vae.encode``, ``tokenizer``, ``text_encoder``, ``unet``, ``scheduler``):
``attwarp_tpu_torch/testing/sd_stub.py`` is such a pipeline at SD 2.1's
cross-attention geometry, and the diffusers import happens only inside
``load_sd_pipeline``. The inversion's arithmetic is operator arithmetic
(``** 0.5``, ``*``), so tensors and numpy arrays both go through it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from attwarp_tpu_torch.utils.device import require_device
from attwarp_tpu_torch.warp.blend import resize_cubic

DEFAULT_TIMESTEPS: tuple = (999, 800, 600, 400, 200)


def load_sd_pipeline(model_id: str = "stabilityai/stable-diffusion-2-1", device="cuda"):
    """A diffusers pipeline with a DDIM scheduler (reference :218-230).
    Needs diffusers and the weights on local disk; everything downstream
    takes any duck-typed equivalent."""
    from diffusers import DDIMScheduler, DiffusionPipeline  # gated import

    sched = DDIMScheduler.from_pretrained(model_id, subfolder="scheduler")
    pipe = DiffusionPipeline.from_pretrained(model_id, scheduler=sched)
    return pipe.to(require_device(device, "load_sd_pipeline"))


def _as_pipe_tensor(x: torch.Tensor, pipe):
    """Hand a batch to whatever the pipe's VAE takes: the pipe's own
    ``to_tensor`` where it has one, else ``x`` in the VAE's dtype on the
    pipe's device (each where the pipe names one)."""
    if hasattr(pipe, "to_tensor"):
        return pipe.to_tensor(x)
    dtype = getattr(pipe.vae, "dtype", None)
    device = getattr(pipe, "device", None)
    if dtype is not None:
        x = x.to(dtype)
    if device is not None:
        x = x.to(device)
    return x


def _renoise(scheduler, z, eps, level_from: int, level_to: int):
    """One truncated-DDIM-inversion step: strip the noise ``eps`` predicted at
    ``level_from`` to get the clean estimate, then re-noise it to
    ``level_to`` deterministically (z_t = sqrt(a_t) x0 + sqrt(1 - a_t) eps,
    reference :264-287)."""
    keep_from = float(scheduler.alphas_cumprod[level_from])
    keep_to = float(scheduler.alphas_cumprod[level_to])
    clean = (z - ((1.0 - keep_from) ** 0.5) * eps) * (keep_from ** -0.5)
    return (keep_to ** 0.5) * clean + ((1.0 - keep_to) ** 0.5) * eps


class CrossAttnRecorder:
    """Records cross-attention probabilities from a diffusers UNet.

    ``install(unet)`` swaps every "attn2" (cross-attention) processor for a
    recording wrapper; maps land in ``self.maps`` under the current
    ``self.timestep`` as (B, heads, H, W, tokens) tensors. ``record(layer_key,
    probs, spatial)`` is also callable directly, which is how any custom
    pipeline integrates without diffusers."""

    def __init__(self):
        self.maps: Dict[int, Dict[str, Any]] = {}
        self.timestep: int = 0

    def clear(self):
        self.maps.clear()

    def record(self, layer_key: str, probs, spatial: Optional[tuple] = None):
        """``probs``: (B, heads, Q, tokens) attention probabilities (or
        already (B, heads, H, W, tokens)), a tensor or a numpy array, kept
        as a detached f32 tensor on its device. Q must be H*W when
        ``spatial`` is given, else a square grid is inferred."""
        p = (probs.detach() if isinstance(probs, torch.Tensor)
             else torch.as_tensor(np.asarray(probs))).to(torch.float32)
        if p.ndim == 4:
            B, heads, Q, T = p.shape
            if spatial is None:
                side = int(round(Q ** 0.5))
                if side * side != Q:
                    raise ValueError(f"non-square Q={Q}; pass spatial=(H, W)")
                spatial = (side, side)
            p = p.reshape(B, heads, spatial[0], spatial[1], T)
        self.maps.setdefault(int(self.timestep), {})[layer_key] = p

    def install(self, unet) -> int:
        """Swap the cross-attention processors (diffusers'
        ``attn_processors`` dict API); returns how many were wrapped."""
        procs = dict(unet.attn_processors)
        n = 0
        for name, proc in procs.items():
            if "attn2" not in name:
                continue
            procs[name] = _RecordingProcessor(self, name, proc)
            n += 1
        unet.set_attn_processor(procs)
        return n


class _RecordingProcessor:
    """A diffusers attention-processor wrapper: computes the probabilities
    as the default processor does, hands them to the recorder, then
    delegates."""

    def __init__(self, recorder: CrossAttnRecorder, name: str, inner):
        self.recorder = recorder
        self.name = name
        self.inner = inner

    def __call__(self, attn, hidden_states, encoder_hidden_states=None,
                 attention_mask=None, **kw):
        if encoder_hidden_states is not None:  # cross-attention only
            batch = hidden_states.shape[0]
            q = attn.head_to_batch_dim(attn.to_q(hidden_states))
            k = attn.head_to_batch_dim(attn.to_k(encoder_hidden_states))
            mask = attention_mask
            # a raw (B, T) mask is broadcast to (B*heads, Q, T) before
            # get_attention_scores, as diffusers' default AttnProcessor does
            if mask is not None and hasattr(attn, "prepare_attention_mask"):
                mask = attn.prepare_attention_mask(
                    mask, encoder_hidden_states.shape[1], batch)
            probs = attn.get_attention_scores(q, k, mask)
            B_h, Q, T = probs.shape
            self.recorder.record(self.name, probs.reshape(B_h // attn.heads, attn.heads, Q, T))
        return self.inner(attn, hidden_states,
                          encoder_hidden_states=encoder_hidden_states,
                          attention_mask=attention_mask, **kw)


class DiffusionAttnSource:
    """An attention source backed by a (duck-typed) diffusers pipeline.

    Owns the pipeline and a ``CrossAttnRecorder`` installed on its UNet.
    ``capture(image, prompt)`` runs image -> latent, prompt -> embeddings,
    the truncated DDIM inversion, then one forward denoise per inversion
    snapshot with the recorder on, and returns the captured maps. The image
    is resized on ``device``, the card unless the caller asks for the CPU."""

    def __init__(self, pipe, timesteps: Sequence[int] = DEFAULT_TIMESTEPS,
                 num_inference_steps: int = 10, latent_size: int = 768, device="cuda"):
        if not hasattr(pipe, "unet_eps"):
            pipe.unet_eps = _diffusers_eps_fn(pipe)
        self.pipe = pipe
        self.timesteps = tuple(timesteps)
        self.num_inference_steps = int(num_inference_steps)
        self.latent_size = int(latent_size)
        self.device = require_device(device, "DiffusionAttnSource")
        self.recorder = CrossAttnRecorder()
        self.recorder.install(pipe.unet)

    def image_latent(self, image):
        """``(H, W, 3)`` float [0, 1] or uint8 / [0, 255] -> the scaled VAE
        latent z0; the resize is cv2's cubic on ``self.device``."""
        img = (image if isinstance(image, torch.Tensor) else torch.as_tensor(np.asarray(image)))
        img = img.to(device=self.device, dtype=torch.float32)
        if img.max() > 1.5:  # uint8 / [0, 255] input
            img = img / 255.0
        sized = resize_cubic(img.permute(2, 0, 1), (self.latent_size,) * 2)
        posterior = self.pipe.vae.encode(_as_pipe_tensor(sized[None] * 2.0 - 1.0,
                                                         self.pipe)).latent_dist
        return posterior.sample() * self.pipe.vae.config.scaling_factor

    def prompt_embeddings(self, prompt: str):
        """Prompt -> (last_hidden_state, input_ids) through the pipe's CLIP
        text encoder, padded to the tokenizer's model max length."""
        tk = self.pipe.tokenizer
        batch = tk(prompt, padding="max_length", truncation=True,
                   max_length=tk.model_max_length, return_tensors="pt")
        hidden = self.pipe.text_encoder(
            batch.input_ids, attention_mask=batch.attention_mask
        ).last_hidden_state
        return hidden, batch.input_ids

    def _noise_levels(self) -> list:
        """The requested timesteps clamped into the scheduler's range."""
        horizon = self.pipe.scheduler.config.num_train_timesteps - 1
        return [max(0, min(horizon, int(t))) for t in self.timesteps]

    def invert(self, z0, text_embeds) -> Dict[int, Any]:
        """Truncated DDIM inversion: ``_renoise`` folded over consecutive
        noise-level pairs, the latent kept at each target level. Returns
        ``{level: z_level}`` (the first level seeds the walk and has no
        snapshot, as in the reference)."""
        levels = self._noise_levels()
        snapshots: Dict[int, Any] = {}
        z = z0
        for level_from, level_to in zip(levels, levels[1:]):
            eps = self.pipe.unet_eps(z, level_from, text_embeds)
            z = _renoise(self.pipe.scheduler, z, eps, level_from, level_to)
            snapshots[level_to] = z
        return snapshots

    def denoise_and_record(self, snapshots: Dict[int, Any],
                           prompt: str) -> Dict[int, Dict[str, Any]]:
        """One forward denoise per inversion snapshot, the recording
        processors filing maps under that snapshot's timestep."""
        self.recorder.clear()
        for level, z in snapshots.items():
            self.recorder.timestep = int(level)
            self.pipe(prompt=[prompt], negative_prompt=[""],
                      num_inference_steps=self.num_inference_steps,
                      latents=z, output_type="latent")
        return self.recorder.maps

    def capture(self, image, prompt: str) -> Dict:
        """The ``capture_fn(image, prompt)`` of ``run_cross_attention_warp``."""
        z0 = self.image_latent(image)
        embeds, _ids = self.prompt_embeddings(prompt)
        return self.denoise_and_record(self.invert(z0, embeds), prompt)


def _diffusers_eps_fn(pipe) -> Callable:
    """Adapts a diffusers pipeline to the ``unet_eps(z, t, emb)`` surface
    that the inversion fold calls."""
    def unet_eps(z, t, emb):
        return pipe.unet(z, torch.tensor([t], device=pipe.device),
                         encoder_hidden_states=emb).sample

    return unet_eps


def make_sd_capture_fn(
    pipe=None,
    model_id: str = "stabilityai/stable-diffusion-2-1",
    timesteps: Sequence[int] = DEFAULT_TIMESTEPS,
    num_inference_steps: int = 10,
    device="cuda",
) -> Callable:
    """The ``capture_fn(image, prompt)`` of ``run_cross_attention_warp``:
    the bound ``capture`` of a ``DiffusionAttnSource`` whose recorder is
    installed on the pipe's UNet. A (stub or real) ``pipe`` skips the
    diffusers load."""
    if pipe is None:
        pipe = load_sd_pipeline(model_id, device=device)
    return DiffusionAttnSource(pipe, timesteps=timesteps,
                               num_inference_steps=num_inference_steps,
                               device=device).capture
