"""A duck-typed Stable Diffusion 2.1 pipeline at SD 2.1's cross-attention
geometry, for driving ``warp/sd_capture.py`` where diffusers and the SD
weights are absent. A test double, not a model: random projections drawn
from a seed, no weights.

The geometry is ``stabilityai/stable-diffusion-2-1``'s ``unet/config.json``:
``block_out_channels`` (320, 640, 1280, 1280), ``attention_head_dim`` (5, 10,
20, 20), which diffusers reads as the head count (each head 64 wide),
``cross_attention_dim`` 1024, ``layers_per_block`` 2, ``sample_size`` 96
(a 768 px image), and a 77-token CLIP prompt. That gives 16 cross-attention
("attn2") layers a UNet evaluation, named as diffusers names them: 5 at the
latent's full grid with 5 heads, 5 at half with 10, 5 at a quarter with 20,
and the mid block's one at an eighth with 20.

What each part does:
- ``vae.encode``: 8x8 mean pooling and a random 1x1 projection to 4
  channels; ``latent_dist.sample()`` returns it.
- ``tokenizer``: words hashed (CRC-32) to ids between CLIP's BOS 49406 and
  EOS 49407, padded to 77 with EOS.
- ``text_encoder``: a random table of 4096 rows of 1024 and a random
  position table; ``last_hidden_state`` (1, 77, 1024).
- ``scheduler``: DDIM with SD 2.1's ``scaled_linear`` betas (0.00085 to
  0.012 over 1000 steps), "leading" spacing, ``steps_offset`` 1.
- ``unet(sample, t, encoder_hidden_states)``: per attn2 layer, the latent
  pooled to the layer's grid and projected to its width, handed to the
  installed processor with random ``to_q``/``to_k``;
  ``get_attention_scores`` is ``softmax(q k^T / 8)``. The default
  processors return their input (the stub keeps no attention output); the
  predicted noise is ``0.1 z`` plus a term of ``t`` and of the text.
- ``__call__``: a DDIM denoise of ``num_inference_steps`` with classifier-
  free guidance (scale 7.5): batch 2, the negative prompt's row and the
  prompt's, as diffusers runs it.
"""

from __future__ import annotations

import zlib
from types import SimpleNamespace

import numpy as np
import torch

from attwarp_tpu_torch.utils.device import require_device

BLOCK_OUT_CHANNELS = (320, 640, 1280, 1280)
ATTENTION_HEADS = (5, 10, 20, 20)       # unet/config.json "attention_head_dim"
HEAD_DIM = 64
CROSS_ATTENTION_DIM = 1024
LAYERS_PER_BLOCK = 2
SAMPLE_SIZE = 96
MODEL_MAX_LENGTH = 77
BOS, EOS = 49406, 49407
TEXT_ROWS = 4096
GUIDANCE_SCALE = 7.5


def attn2_layers():
    """``[(processor name, level, channels, heads)]`` in UNet order: a layer
    at level ``l`` works on the latent's grid divided by ``2 ** l``."""
    out = []
    for blk in range(3):                               # CrossAttnDownBlock2D x 3
        for a in range(LAYERS_PER_BLOCK):
            out.append((f"down_blocks.{blk}.attentions.{a}", blk))
    out.append(("mid_block.attentions.0", 3))
    for blk in range(1, 4):                            # CrossAttnUpBlock2D x 3
        for a in range(LAYERS_PER_BLOCK + 1):
            out.append((f"up_blocks.{blk}.attentions.{a}", 3 - blk))
    return [(f"{prefix}.transformer_blocks.0.attn2.processor", level,
             BLOCK_OUT_CHANNELS[level], ATTENTION_HEADS[level]) for prefix, level in out]


class _Attention:
    """The surface of a diffusers ``Attention`` that the recording
    processor calls."""

    def __init__(self, channels, heads, g, device):
        self.heads = heads
        self.scale = HEAD_DIM ** -0.5
        self.wq = (torch.randn(channels, channels, generator=g) / channels ** 0.5).to(device)
        self.wk = (torch.randn(CROSS_ATTENTION_DIM, channels, generator=g)
                   / CROSS_ATTENTION_DIM ** 0.5).to(device)
        self.w_in = (torch.randn(4, channels, generator=g) / 2.0).to(device)

    def to_q(self, x):
        return x @ self.wq

    def to_k(self, x):
        return x @ self.wk

    def head_to_batch_dim(self, x):
        B, S, D = x.shape
        return (x.reshape(B, S, self.heads, D // self.heads).permute(0, 2, 1, 3)
                .reshape(B * self.heads, S, D // self.heads))

    def get_attention_scores(self, q, k, mask=None):
        scores = torch.bmm(q, k.transpose(1, 2)) * self.scale
        if mask is not None:
            scores = scores + mask
        return torch.softmax(scores, dim=-1)


def _identity_processor(attn, hidden_states, encoder_hidden_states=None,
                        attention_mask=None, **kw):
    return hidden_states


class _UNet:
    def __init__(self, g, device):
        self.layers = [(name, level, _Attention(ch, heads, g, device))
                       for name, level, ch, heads in attn2_layers()]
        names = [n for n, _, _ in self.layers]
        self._procs = {n: _identity_processor for n in names}
        # the self-attention layers beside them, which a recorder leaves be
        self._procs.update({n.replace("attn2", "attn1"): _identity_processor for n in names})

    @property
    def attn_processors(self):
        return dict(self._procs)

    def set_attn_processor(self, procs):
        self._procs = dict(procs)

    def __call__(self, sample, timestep, encoder_hidden_states):
        side = sample.shape[-1]
        for name, level, attn in self.layers:
            grid = max(1, side >> level)
            pooled = torch.nn.functional.adaptive_avg_pool2d(sample, grid)
            hidden = pooled.flatten(2).transpose(1, 2) @ attn.w_in   # (B, grid^2, channels)
            self._procs[name](attn, hidden, encoder_hidden_states=encoder_hidden_states)
        t = float(timestep.reshape(-1)[0]) if isinstance(timestep, torch.Tensor) else float(timestep)
        text = encoder_hidden_states.mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
        return SimpleNamespace(sample=0.1 * sample + 1e-3 * (t / 1000.0) + 1e-2 * text)


class _Vae:
    dtype = torch.float32
    config = SimpleNamespace(scaling_factor=0.18215)

    def __init__(self, g, device):
        self.w = (torch.randn(4, 3, generator=g) / 3 ** 0.5).to(device)

    def encode(self, x):
        pooled = torch.nn.functional.avg_pool2d(x, 8)
        z = torch.einsum("oc,bchw->bohw", self.w, pooled)
        return SimpleNamespace(latent_dist=SimpleNamespace(sample=lambda: z))


class _Tokenizer:
    model_max_length = MODEL_MAX_LENGTH

    def __call__(self, prompt, padding="max_length", truncation=True, max_length=None,
                 return_tensors="pt"):
        n = max_length or self.model_max_length
        words = [BOS] + [1 + zlib.crc32(w.encode()) % (BOS - 1) for w in prompt.lower().split()]
        ids = (words[:n - 1] + [EOS])
        ids = ids + [EOS] * (n - len(ids))
        mask = [1] * min(len(words) + 1, n) + [0] * max(0, n - len(words) - 1)
        return SimpleNamespace(input_ids=torch.tensor([ids]), attention_mask=torch.tensor([mask]))


class _TextEncoder:
    def __init__(self, g, device):
        self.table = torch.randn(TEXT_ROWS, CROSS_ATTENTION_DIM, generator=g).to(device)
        self.pos = torch.randn(MODEL_MAX_LENGTH, CROSS_ATTENTION_DIM, generator=g).to(device)

    def __call__(self, input_ids, attention_mask=None):
        ids = input_ids.to(self.table.device) % TEXT_ROWS
        return SimpleNamespace(last_hidden_state=self.table[ids] + self.pos[:ids.shape[1]])


class _Scheduler:
    config = SimpleNamespace(num_train_timesteps=1000, steps_offset=1)

    def __init__(self):
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.timesteps = []

    def set_timesteps(self, n: int):
        step = self.config.num_train_timesteps // n
        self.timesteps = [int(t) for t in (np.arange(n)[::-1] * step + self.config.steps_offset)]
        self._step = step

    def step(self, eps, t: int, z):
        """One DDIM step (eta 0); SD 2.1's final alpha is alphas_cumprod[0]."""
        a_t = float(self.alphas_cumprod[t])
        prev = t - self._step
        a_prev = float(self.alphas_cumprod[prev if prev >= 0 else 0])
        x0 = (z - (1.0 - a_t) ** 0.5 * eps) * a_t ** -0.5
        return a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps


class SD21StubPipeline:
    """The pipeline surface ``warp/sd_capture.py`` drives, on ``device``
    (the card unless the caller asks for the CPU), its random parts drawn
    from a CPU ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, device="cuda", seed: int = 0):
        self.device = require_device(device, "SD21StubPipeline")
        g = torch.Generator().manual_seed(seed)
        self.vae = _Vae(g, self.device)
        self.text_encoder = _TextEncoder(g, self.device)
        self.unet = _UNet(g, self.device)
        self.tokenizer = _Tokenizer()
        self.scheduler = _Scheduler()

    def _embed(self, prompts):
        rows = [self.text_encoder(self.tokenizer(p, max_length=MODEL_MAX_LENGTH).input_ids)
                .last_hidden_state for p in prompts]
        return torch.cat(rows)

    def __call__(self, prompt, negative_prompt, num_inference_steps, latents,
                 output_type="latent"):
        text = self._embed(list(negative_prompt) + list(prompt))     # (2, 77, 1024)
        self.scheduler.set_timesteps(num_inference_steps)
        z = latents
        for t in self.scheduler.timesteps:
            eps = self.unet(torch.cat([z, z]), torch.tensor([t], device=self.device),
                            encoder_hidden_states=text).sample
            eps_u, eps_c = eps.chunk(2)
            z = self.scheduler.step(eps_u + GUIDANCE_SCALE * (eps_c - eps_u), t, z)
        return SimpleNamespace(images=z)
