"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU form, so every test here is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false. This file imports no
JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import math

import numpy as np
import pytest
import torch

from attwarp_tpu_torch.kernels.attn_softmax import scaled_softmax_, scaled_softmax_plain
from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8, decode_attn_plain
from attwarp_tpu_torch.kernels.flash_prefill import flash_prefill, flash_prefill_plain
from attwarp_tpu_torch.kernels.rope_append import rope_append_int8, rope_append_int8_plain
from attwarp_tpu_torch.kernels.warp_resample import (
    backward_kernels_launched,
    k1_plan,
    warp_resample,
    warp_resample_backward,
    warp_resample_backward_plain,
)
from attwarp_tpu_torch.models.llama import QuantKVCache, append_token, apply_rope
from attwarp_tpu_torch.warp.resample import remap_bilinear_separable
from attwarp_tpu_torch.warp.warp import warp_grid_maps

PIX_TOL = 1e-3 * 255   # the repo's warp budget: 1e-3 on [0, 1] pixels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out_hw,att_hw", [
    ((4, 512, 640, 3), (500, 500), (512, 640)),   # the pipeline's warp
    ((1, 512, 512, 3), (500, 500), (512, 512)),   # the dataset driver's, per sample
    ((3, 97, 131, 1), (64, 200), (24, 24)),       # ragged, one channel, low-res maps
])
def test_k1_cuda_matches_plain(cuda, shape, out_hw, att_hw):
    """Within the pixel budget: FMA contraction moves the last bits."""
    g = np.random.default_rng(0)
    img = torch.as_tensor((g.random(shape) * 255).astype(np.float32), device=cuda)
    att = torch.as_tensor(g.random((shape[0], *att_hw)).astype(np.float32), device=cuda)
    mx, my = warp_grid_maps(att, shape[1:3], out_hw[1], out_hw[0])
    before = warp_resample.launches
    got = warp_resample(img, mx.contiguous(), my.contiguous())
    ref = remap_bilinear_separable(img, mx, my)
    torch.cuda.synchronize()
    assert warp_resample.launches == before + 1
    assert got.shape == ref.shape == (shape[0], *out_hw, shape[3])
    assert (got - ref).abs().max().item() <= PIX_TOL


def _k1_maps(g, kind, B, H, W, H_out, W_out):
    """Source coordinates (B, W_out) and (B, H_out): "far" spans far outside
    [-1, W] and [-1, H] (border replicate), with non-monotone jumps; "zoom4"
    a 4x magnification of the image's middle, where one source row pair
    serves four output rows; "random" taps anywhere in the image."""
    if kind == "far":
        mx = g.uniform(-3 * W, 4 * W, (B, W_out))
        my = g.uniform(-3 * H, 4 * H, (B, H_out))
        mx[:, ::7], my[:, ::5] = -1e6, 1e6
    elif kind == "zoom4":
        mx = np.broadcast_to(np.linspace(W / 4, W / 4 + (W_out - 1) / 4, W_out), (B, W_out))
        my = np.broadcast_to(np.linspace(H / 4, H / 4 + (H_out - 1) / 4, H_out), (B, H_out))
    else:
        mx = g.uniform(-1, W, (B, W_out))
        my = g.uniform(-1, H, (B, H_out))
    return (np.ascontiguousarray(mx, np.float32), np.ascontiguousarray(my, np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out_hw,maps", [
    ((2, 37, 131, 1), (50, 77), "grid"),        # rows of 524 bytes: cp.async, not TMA
    ((2, 64, 64, 3), (40, 131), "grid"),        # W_out * C = 393: unaligned output rows
    ((2, 9, 13, 3), (1, 1), "grid"),            # H_out = W_out = 1
    ((3, 40, 52, 3), (60, 70), "far"),          # border replicate, any jumps
    ((2, 64, 64, 3), (256, 256), "zoom4"),      # 4x magnification
    ((128, 336, 336, 3), (336, 336), "grid"),   # the warp-only shape
    ((1, 40, 6000, 3), (40, 5000), "grid"),     # rows too wide for two: column tiles
    ((1, 40, 6000, 3), (40, 5000), "random"),   # tiles whose span overflows a slot: __ldg
    ((1, 1024, 683, 3), (500, 500), "grid"),    # a 683x1024 photo: 8196-byte rows, cp.async
], ids=["row524B", "out393", "1x1", "far", "zoom4", "b128_336", "tiled", "tiled_random",
        "photo683w"])
def test_k1_cuda_edges(cuda, shape, out_hw, maps):
    """The kernel's edges against the plain version, within the pixel
    budget, one launch each."""
    g = np.random.default_rng(1)
    B, H, W, C = shape
    img = torch.as_tensor((g.random(shape) * 255).astype(np.float32), device=cuda)
    if maps == "grid":
        att = torch.as_tensor(g.random((B, 24, 24)).astype(np.float32), device=cuda)
        mx, my = (m.contiguous() for m in warp_grid_maps(att, (H, W), out_hw[1], out_hw[0]))
    else:
        mx, my = (torch.as_tensor(m, device=cuda)
                  for m in _k1_maps(g, maps, B, H, W, *out_hw))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = k1_plan(B, H, W, C, *out_hw, sms)
    assert plan.tiles > 1 if W == 6000 else plan.tiles == 1
    assert plan.slots >= 2
    before = warp_resample.launches
    got = warp_resample(img, mx, my)
    ref = remap_bilinear_separable(img, mx, my)
    torch.cuda.synchronize()
    assert warp_resample.launches == before + 1
    assert got.shape == ref.shape == (B, *out_hw, C)
    assert (got - ref).abs().max().item() <= PIX_TOL


def _k3_case(dev, L, B, S, H, kvH, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    hd = 128
    k_q = torch.randint(-127, 128, (L, B, S, kvH, hd), generator=g, device=dev,
                        dtype=torch.int8)
    v_q = torch.randint(-127, 128, (L, B, S, kvH, hd), generator=g, device=dev,
                        dtype=torch.int8)
    k_s = (torch.rand((L, B, S, kvH), generator=g, device=dev) + 0.5) / 127
    v_s = (torch.rand((L, B, S, kvH), generator=g, device=dev) + 0.5) / 127
    q = torch.randn((B, H, hd), generator=g, device=dev).to(torch.bfloat16)
    ar = torch.arange(S, device=dev)[None, :]
    pad = torch.tensor([(37 * b) % 64 for b in range(B)], device=dev)[:, None]
    cur = torch.tensor([S - 44 + 3 * b for b in range(B)], device=dev)[:, None]
    return q, k_q, k_s, v_q, v_s, (ar >= pad) & (ar <= cur)


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,S,H,kvH", [
    (32, 4, 704, 32, 32),   # LLaVA-1.5-7B decode with the kv8 cache
    (28, 4, 704, 28, 4),    # Qwen2-VL-7B decode with the kv8 cache (n_rep 7)
    (2, 3, 200, 32, 4),     # GQA, S not a multiple of the 32 token groups
], ids=["llava7b", "qwen7b", "gqa"])
def test_k3_cuda_matches_plain(cuda, L, B, S, H, kvH):
    """The kernel keeps q.k and p.v in f32 where the plain version rounds
    them to bf16, so cos > 0.999 and max-abs within 2% of the output range;
    against the plain version in f32 it is tighter still."""
    q, k_q, k_s, v_q, v_s, mask = _k3_case(cuda, L, B, S, H, kvH, seed=4)
    args = (k_q, k_s, v_q, v_s, mask, L - 1, 1.0 / np.sqrt(128))
    before = decode_attn_int8.launches
    got = decode_attn_int8(q, *args).float()
    ref = decode_attn_plain(q, *args).float()
    ref32 = decode_attn_plain(q.float(), *args)
    torch.cuda.synchronize()
    assert decode_attn_int8.launches == before + 1
    for r in (ref, ref32):
        cos = torch.nn.functional.cosine_similarity(got.flatten(), r.flatten(), dim=0)
        assert cos.item() > 0.999
        assert (got - r).abs().max().item() <= 2e-2 * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("L,H,kvH", [(32, 32, 32), (28, 28, 4)], ids=["llava7b", "qwen7b"])
def test_k3_cuda_serving_masks(cuda, L, H, kvH):
    """The masks of a serving slot pool (B=6, S=768): each row its own
    [start, cur_len] window, a retired slot's window [0, 0], and a row with
    no valid position at all, which both versions return as zeros. Finite,
    and within the bars of ``test_k3_cuda_matches_plain``."""
    B, S = 6, 768
    q, k_q, k_s, v_q, v_s, _ = _k3_case(cuda, L, B, S, H, kvH, seed=11)
    mask = torch.zeros((B, S), dtype=torch.bool, device=cuda)
    for b, (start, cur) in enumerate(((37, 640), (0, 703), (60, 120), (0, 0), (5, 767))):
        mask[b, start:cur + 1] = True                 # row 5 stays all False
    args = (k_q, k_s, v_q, v_s, mask, L - 1, 1.0 / np.sqrt(128))
    got = decode_attn_int8(q, *args).float()
    ref = decode_attn_plain(q, *args).float()
    ref32 = decode_attn_plain(q.float(), *args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert not got[5].any() and not ref32[5].any()
    for r in (ref, ref32):
        cos = torch.nn.functional.cosine_similarity(got.flatten(), r.flatten(), dim=0)
        assert cos.item() > 0.999
        assert (got - r).abs().max().item() <= 2e-2 * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,S,H,kvH,window", [
    (2, 9, 96, 32, 32, None),         # S within one chunk: a single split
    (2, 4, 704, 32, 32, (650, 690)),  # every split but one (or two) masked
    (2, 4, 704, 28, 4, (300, 330)),   # the same under GQA
    (32, 1, 704, 32, 32, None),       # B=1: the most splits
    (28, 1, 704, 28, 4, None),
    (2, 2, 704, 32, 2, None),         # n_rep 16: two blocks of 8 heads per kv head
    (2, 3, 704, 24, 2, None),         # n_rep 12: a block of 8 heads and one of 4
    (2, 2, 5000, 32, 32, None),       # S over many 256-position splits
], ids=["one_chunk", "one_split_valid", "one_split_valid_gqa", "b1", "b1_gqa", "rep16",
        "rep12", "long_s"])
def test_k3_cuda_split_edges(cuda, L, B, S, H, kvH, window):
    """Edges of the split plan, within the bars of
    ``test_k3_cuda_matches_plain``: a window that leaves all splits but the
    one or two it falls in masked (those load nothing), S inside one chunk,
    and B=1."""
    q, k_q, k_s, v_q, v_s, mask = _k3_case(cuda, L, B, S, H, kvH, seed=12)
    if window is not None:
        mask = torch.zeros_like(mask)
        mask[:, window[0]:window[1] + 1] = True
    args = (k_q, k_s, v_q, v_s, mask, L - 1, 1.0 / np.sqrt(128))
    got = decode_attn_int8(q, *args).float()
    ref = decode_attn_plain(q, *args).float()
    ref32 = decode_attn_plain(q.float(), *args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for r in (ref, ref32):
        cos = torch.nn.functional.cosine_similarity(got.flatten(), r.flatten(), dim=0)
        assert cos.item() > 0.999
        assert (got - r).abs().max().item() <= 2e-2 * r.abs().max().item()


def _k2_case(dev, B, T, H, kvH, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, T, n, 128), generator=g, device=dev).to(torch.bfloat16)
               for n in (H, kvH, kvH))
    pad = torch.tensor([(37 * b) % 61 for b in range(B)], device=dev)[:, None]
    return q, k, v, torch.arange(T, device=dev)[None, :] >= pad


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,kvH", [
    (4, 640, 32, 32),   # LLaVA-1.5-7B prefill
    (4, 640, 28, 4),    # Qwen2-VL-7B prefill (GQA, n_rep 7)
    (8, 704, 32, 32),   # LLaVA-1.5-7B serving admission group
    (8, 704, 28, 4),    # Qwen2-VL-7B serving admission group
    (3, 200, 28, 4),    # ragged T: no multiple of the 128-row tiles
], ids=["mha", "gqa", "mha_serve", "gqa_serve", "ragged"])
def test_k2_cuda_matches_plain(cuda, B, T, H, kvH):
    """Left padding that differs per row. The kernel keeps q.k and p.v in f32
    where the plain version rounds them to bf16: cos > 0.999 and max-abs
    within 2% of the output range, against the bf16 and the f32 plain
    version."""
    q, k, v, mask = _k2_case(cuda, B, T, H, kvH, seed=6)
    sm = 1.0 / np.sqrt(128)
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, mask, sm).float()
    ref = flash_prefill_plain(q, k, v, mask, sm).float()
    ref32 = flash_prefill_plain(q.float(), k.float(), v.float(), mask, sm)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    assert got.shape == (B, T, H * 128) and torch.isfinite(got).all()
    for r in (ref, ref32):
        cos = torch.nn.functional.cosine_similarity(got.flatten(), r.flatten(), dim=0)
        assert cos.item() > 0.999
        assert (got - r).abs().max().item() <= 2e-2 * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,kvH,pads", [
    (2, 96, 28, 4, [0, 40]),            # T < 128: one query tile, its rows partly below 0
    (3, 333, 32, 32, [0, 17, 90]),      # T no multiple of the 128-row tile (MHA pairs)
    (3, 333, 28, 4, [5, 0, 70]),        # the same under GQA
    (2, 640, 28, 4, [150, 300]),        # padding wider than one 64-key tile
    (2, 704, 32, 32, [129, 260]),       # the same under MHA, ragged tile count
    (2, 16717, 2, 1, [100, 16500]),     # T past the 16384 positions whose segments
    (2, 16717, 2, 2, [16500, 7]),       # sit in shared memory, padding across it
], ids=["t96", "t333_mha", "t333_gqa", "wide_pad_gqa", "wide_pad_mha", "long_t_gqa",
        "long_t_mha"])
def test_k2_cuda_tile_edges(cuda, B, T, H, kvH, pads):
    """Edges of the tiling, within the bars of ``test_k2_cuda_matches_plain``:
    a T shorter than one query tile or no multiple of it (the tiles end at
    T, so the first one has rows below 0), left padding wider than a key
    tile (whole key tiles of padding are skipped for valid rows), and a T
    past the 16384 positions whose segments the kernel keeps in shared
    memory, with the padding ending on either side of it."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((B, T, n, 128), generator=g, device=cuda).to(torch.bfloat16)
               for n in (H, kvH, kvH))
    mask = torch.arange(T, device=cuda)[None, :] >= torch.tensor(pads, device=cuda)[:, None]
    sm = 1.0 / np.sqrt(128)
    got = flash_prefill(q, k, v, mask, sm).float()
    ref = flash_prefill_plain(q, k, v, mask, sm).float()
    ref32 = flash_prefill_plain(q.float(), k.float(), v.float(), mask, sm)
    torch.cuda.synchronize()
    assert got.shape == (B, T, H * 128) and torch.isfinite(got).all()
    for r in (ref, ref32):
        cos = torch.nn.functional.cosine_similarity(got.flatten(), r.flatten(), dim=0)
        assert cos.item() > 0.999
        assert (got - r).abs().max().item() <= 2e-2 * r.abs().max().item()


@pytest.mark.cuda
def test_wrappers_reject_bad_cuda_input(cuda):
    """On a CUDA tensor a wrapper launches its kernel or raises; it never
    falls back to the plain version."""
    img = torch.zeros((1, 8, 8, 3), device=cuda, dtype=torch.float64)
    m = torch.zeros((1, 4), device=cuda)
    with pytest.raises(TypeError):
        warp_resample(img, m, m)
    q, k_q, k_s, v_q, v_s, mask = _k3_case(cuda, 1, 1, 32, 2, 2, seed=5)
    with pytest.raises(ValueError):
        decode_attn_int8(q, k_q, k_s, v_q, v_s, mask, 1, 0.1)   # no layer 1
    q2, k2, v2, m2 = _k2_case(cuda, 1, 64, 2, 2, seed=7)
    with pytest.raises(ValueError):
        flash_prefill(q2[..., :64], k2[..., :64], v2[..., :64], m2, 0.1)  # hd 64


def _k4_logits(dev, shape, scale, dtype=torch.bfloat16, seed=4):
    """Uniform logits that span -30 to 30 once scaled, as a tower's do."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(shape, generator=g, device=dev) * 60.0 - 30.0
    return (x / scale).to(dtype)


def _ulps_apart(a, b):
    """The largest distance in units of the last place between two tensors
    of non-negative values (their bit patterns are ordered like them)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return (a.view(view).long() - b.view(view).long()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,scale", [
    ((16, 2304, 2304), 1.0 / math.sqrt(80)),     # Qwen2-VL-7B's tower, one image
    ((8, 16, 577, 577), 1.0 / 8),                # CLIP ViT-L/14-336, a LLaVA batch
    ((8, 16, 729, 729), 1.0 / math.sqrt(72)),    # SigLIP-so400m, a Uni-MoE batch
    ((16, 3136, 3136), 1.0 / math.sqrt(80)),     # Qwen2-VL at 784 px: the long rows
    ((16, 5184, 5184), 1.0 / math.sqrt(80)),     # Qwen2-VL at 1008 px
], ids=["qwen2vl", "clip", "siglip", "qwen2vl_784px", "qwen2vl_1008px"])
def test_k4_cuda_matches_plain(cuda, shape, scale):
    """Every value within one bf16 ulp of the plain version (only the sum's
    order differs), rows summing to 1, written over the logits."""
    x = _k4_logits(cuda, shape, scale)
    ref = scaled_softmax_plain(x, scale)
    ptr, before = x.data_ptr(), scaled_softmax_.launches
    out = scaled_softmax_(x, scale)
    torch.cuda.synchronize()
    assert out is x and out.data_ptr() == ptr
    assert scaled_softmax_.launches == before + 1
    assert _ulps_apart(out, ref) <= 1
    assert (out.float().sum(-1) - 1.0).abs().max().item() <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((3, 1), torch.bfloat16), ((5, 7), torch.bfloat16), ((9, 9), torch.bfloat16),
    ((33, 577), torch.bfloat16), ((6, 768), torch.bfloat16), ((6, 769), torch.bfloat16),
    ((6, 2311), torch.bfloat16), ((5, 3137), torch.bfloat16),
    ((4, 3), torch.float32), ((2, 16, 577), torch.float32), ((2, 16, 2304), torch.float32),
    ((3, 2305), torch.float32), ((3, 5184), torch.float32),
])
def test_k4_cuda_row_edges(cuda, shape, dtype):
    """Rows shorter than a vector, rows off the 16-byte boundary in every
    phase, the last rows of each register form and the first of the next,
    the long-row form, float32: within one bf16 ulp of the plain
    version, or 8 float32 ulps (the f32 sum's order differs from PyTorch's
    and moves it by a few ulps); a row of equal logits gives 1/L
    everywhere."""
    scale = 0.1
    x = _k4_logits(cuda, shape, scale, dtype, seed=shape[-1])
    ref = scaled_softmax_plain(x, scale)
    scaled_softmax_(x, scale)
    torch.cuda.synchronize()
    assert _ulps_apart(x, ref) <= (1 if dtype == torch.bfloat16 else 8)
    L = shape[-1]
    flat = torch.full(shape, 1.25, device=cuda, dtype=dtype)
    scaled_softmax_(flat, scale)
    assert torch.equal(flat, torch.full_like(flat, 1.0 / L))


@pytest.mark.cuda
def test_k4_cuda_refuses_what_it_cannot_take(cuda):
    x = torch.zeros((4, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        scaled_softmax_(x, 0.1)
    with pytest.raises(ValueError):
        scaled_softmax_(torch.zeros((2, 0), device=cuda, dtype=torch.bfloat16), 0.1)
    with pytest.raises(ValueError):
        scaled_softmax_(torch.zeros((64, 4), device=cuda, dtype=torch.bfloat16).t(), 0.1)



def _k5_case(dev, L, B, S, H, kvH, dtype, per_slot, seed, nan=False):
    """A cache full of earlier tokens, the step's projections (a spread of
    magnitudes, one head of zeros; with ``nan`` a NaN in a k head and in a v
    head), rotary tables at positions that lie below the cache positions by
    each row's left padding, and the cache positions: one int, or a (B,)
    tensor of per-slot positions."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hd = 128
    kv = QuantKVCache(
        torch.randint(-127, 128, (L, B, S, kvH, hd), generator=g, device=dev, dtype=torch.int8),
        torch.rand((L, B, S, kvH), generator=g, device=dev) * 0.02,
        torch.randint(-127, 128, (L, B, S, kvH, hd), generator=g, device=dev, dtype=torch.int8),
        torch.rand((L, B, S, kvH), generator=g, device=dev) * 0.02)
    q = (torch.randn((B, 1, H * hd), generator=g, device=dev) * 3.0).to(dtype)
    k = (torch.randn((B, 1, kvH * hd), generator=g, device=dev) * 3.0).to(dtype)
    v = (torch.randn((B, 1, kvH * hd), generator=g, device=dev) * 0.3).to(dtype)
    k[-1, 0, :hd] = 0
    if nan:
        k[0, 0, 5] = float("nan")
        v[-1, 0, hd + 70] = float("nan")
    cur = (torch.randint(S // 2, S, (B,), generator=g, device=dev) if per_slot else
           torch.full((B,), S - 5, device=dev))
    pad = torch.arange(B, device=dev) * 37 % 64
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, device=dev, dtype=torch.float32) / hd))
    freqs = (cur - pad)[:, None, None].float() * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return kv, q, k, v, torch.cos(emb), torch.sin(emb), cur if per_slot else S - 5


def _bits(t):
    """A tensor's bits, so that NaNs compare equal where their bits are."""
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(t.dtype, t.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,S,H,kvH,dtype,per_slot,nan", [
    (32, 8, 704, 32, 32, torch.bfloat16, False, False),   # LLaVA-1.5-7B's two-pass step
    (28, 8, 704, 28, 4, torch.bfloat16, False, False),    # Qwen2-VL-7B's (GQA 28/4)
    (32, 16, 768, 32, 32, torch.bfloat16, True, False),   # the serve engine's 16 slots
    (4, 4, 64, 32, 32, torch.float32, True, False),       # float32 activations (serve parity)
    (4, 8, 64, 28, 4, torch.bfloat16, True, True),        # a NaN in a k and a v head
], ids=["llava7b", "qwen7b", "llava7b_serve", "f32", "nan"])
def test_k5_cuda_equals_the_eager_sequence(cuda, L, B, S, H, kvH, dtype, per_slot, nan):
    """K5 against the eager PyTorch sequence it replaces on the card,
    ``apply_rope`` then ``append_token``, and against its plain version: the
    rotated q and every cache tensor bit for bit, in one launch. A NaN in a
    head gives that head a NaN scale, as ``torch.amax`` does."""
    kv, q, k, v, cos, sin, pos = _k5_case(cuda, L, B, S, H, kvH, dtype, per_slot, seed=L,
                                          nan=nan)
    layer, hd = L - 2, 128
    eager = QuantKVCache(*(t.clone() for t in kv))
    plain = QuantKVCache(*(t.clone() for t in kv))
    want_q, want_k = apply_rope(q.reshape(B, 1, H, hd), k.reshape(B, 1, kvH, hd), cos, sin)
    at = (torch.arange(B, device=cuda), pos) if per_slot else (slice(None), pos)
    append_token(eager, layer, at, want_k[:, 0], v.reshape(B, kvH, hd))
    plain_q = rope_append_int8_plain(q, k, v, cos, sin, plain, layer, pos)
    before = rope_append_int8.launches
    got_q = rope_append_int8(q, k, v, cos, sin, kv, layer, pos)
    torch.cuda.synchronize()
    assert rope_append_int8.launches == before + 1
    assert got_q.shape == (B, 1, H, hd) and got_q.dtype == dtype
    assert torch.equal(got_q, want_q) and torch.equal(plain_q, want_q)
    for name, got, want, p in zip(("k_q", "k_s", "v_q", "v_s"), kv, eager, plain):
        assert torch.equal(_bits(got), _bits(want)), name
        assert torch.equal(_bits(p), _bits(want)), name
    if nan:
        at = pos if per_slot else torch.full((B,), pos, device=cuda)
        assert kv.k_s[layer, 0, at[0], 0].isnan() and kv.v_s[layer, B - 1, at[B - 1], 1].isnan()


@pytest.mark.cuda
def test_k5_cuda_refuses_what_it_cannot_take(cuda):
    kv, q, k, v, cos, sin, pos = _k5_case(cuda, 2, 2, 32, 4, 2, torch.bfloat16, True, seed=1)
    with pytest.raises(TypeError):
        rope_append_int8(q.half(), k.half(), v.half(), cos, sin, kv, 0, pos)
    with pytest.raises(ValueError):
        rope_append_int8(q, k, v, cos, sin, kv, 2, pos)           # no layer 2
    with pytest.raises(ValueError):
        rope_append_int8(q, k, v, cos, sin, kv, 0, 32)            # no slot 32
    with pytest.raises(ValueError):
        rope_append_int8(q, k, v, cos, sin, kv, 0, pos.int())     # int32 positions
    with pytest.raises(ValueError):
        rope_append_int8(q, k, v, cos.double(), sin, kv, 0, pos)
    small = QuantKVCache(*(t[..., :64].contiguous() if t.ndim == 5 else t for t in kv))
    with pytest.raises(ValueError):
        rope_append_int8(q[..., :256], k[..., :128], v[..., :128], cos[..., :64],
                         sin[..., :64], small, 0, pos)             # head_dim 64


_K5_OUTSIDE = """
import torch
from attwarp_tpu_torch.kernels.rope_append import rope_append_int8
from attwarp_tpu_torch.models.llama import QuantKVCache
dev, L, B, S, H, kvH = "cuda", 2, 4, 32, 4, 2
kv = QuantKVCache(torch.zeros((L, B, S, kvH, 128), dtype=torch.int8, device=dev),
                  torch.zeros((L, B, S, kvH), device=dev),
                  torch.zeros((L, B, S, kvH, 128), dtype=torch.int8, device=dev),
                  torch.zeros((L, B, S, kvH), device=dev))
q = torch.ones((B, 1, H * 128), dtype=torch.bfloat16, device=dev)
k = torch.ones((B, 1, kvH * 128), dtype=torch.bfloat16, device=dev)
v = torch.ones_like(k)
cos = torch.ones((B, 1, 128), device=dev)
sin = torch.zeros((B, 1, 128), device=dev)
pos = torch.tensor([3, 4, {p}, 5], device=dev)
try:
    rope_append_int8(q, k, v, cos, sin, kv, 1, pos)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("stopped:", str(e).splitlines()[0])
else:
    print("wrote")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("p", [32, -1], ids=["past_the_end", "negative"])
def test_k5_cuda_stops_at_a_position_outside_the_cache(cuda, p):
    """A per-row position outside [0, S) stops the kernel with a device
    error, as ATen's index write does, rather than leave the row's slot
    stale for the attention to read. The error ends the process's CUDA
    context, so the call runs in a child process."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _K5_OUTSIDE.format(p=p)], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().startswith("stopped:"), (out.stdout, out.stderr[-2000:])

@pytest.mark.cuda
def test_mota_mask_cuda_equals_the_cpu(cuda):
    """The MOTA mask's box filter on the card, bit for bit the CPU's on the
    same enhanced maps, whose saturated patches put filtered cells on the
    truncation's 254/255 boundary (where a matmul summing in the card's
    order moved them); the masks within the repo's 1 LSB (``enhance``'s
    reductions and sigmoid still round by device)."""
    from attwarp_tpu_torch.warp.blend import _box_pass, enhance, mota_mask, normalize_minmax

    rng = np.random.default_rng(20)
    att = rng.random((8, 24, 24)).astype(np.float32) ** 3
    att[:, 6:12, 6:12] = 4.0 + rng.random((8, 6, 6)).astype(np.float32) * 0.1
    att = torch.as_tensor(att)
    e = enhance(normalize_minmax(att, "min"))
    assert (e == 1.0).sum() >= 8 * 9

    def box(x):
        return _box_pass(_box_pass(x, 3, -2), 3, -1)

    assert torch.equal(box(e.to(cuda)).cpu(), box(e))
    got = mota_mask(att.to(cuda), (512, 640)).cpu().int()
    assert (got - mota_mask(att, (512, 640)).int()).abs().max().item() <= 1


def _grad_close(got, ref, rel):
    """Within ``rel`` of the reference's largest magnitude (exact where the
    reference is all zeros)."""
    return (got - ref).abs().max().item() <= rel * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("needs_grad", ["images", "map_x", "map_y", "all"])
def test_k1_backward_cuda_matches_plain_autograd(cuda, needs_grad):
    """With autograd on and an input that requires a gradient, K1 launches
    its forward and, in the backward pass, its backward kernel: the
    gradients of the inputs that need one within 1e-5 (image) and 1e-4
    (maps: sums over W_out * C or H_out * C terms in another order) of the
    plain version's autograd, None for the others."""
    g = np.random.default_rng(2)
    base = {"images": torch.as_tensor((g.random((2, 24, 32, 3)) * 255).astype(np.float32),
                                      device=cuda),
            "map_x": torch.as_tensor(g.uniform(-1.5, 32.5, (2, 40)).astype(np.float32),
                                     device=cuda),
            "map_y": torch.as_tensor(g.uniform(-1.5, 24.5, (2, 20)).astype(np.float32),
                                     device=cuda)}
    w = torch.as_tensor(g.standard_normal((2, 20, 40, 3)).astype(np.float32), device=cuda)
    wants = list(base) if needs_grad == "all" else [needs_grad]

    def run(fn):
        t = {k: v.clone().requires_grad_(k in wants) for k, v in base.items()}
        (fn(t["images"], t["map_x"], t["map_y"]) * w).sum().backward()
        return {k: t[k].grad for k in base}

    before = (warp_resample.launches, warp_resample_backward.launches)
    got = run(warp_resample)
    torch.cuda.synchronize()
    assert (warp_resample.launches, warp_resample_backward.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    ref = run(remap_bilinear_separable)
    for k in base:
        if k not in wants:
            assert got[k] is None
            continue
        assert _grad_close(got[k], ref[k], 1e-5 if k == "images" else 1e-4), k
        assert ref[k].abs().max().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out_hw,maps", [
    ((2, 24, 32, 3), (30, 50), "clamped"),      # maps at -3 and n + 2: coincident taps
    ((2, 40, 52, 3), (60, 70), "random"),       # non-monotone maps, inside and out
    ((3, 40, 52, 3), (60, 70), "far"),          # far outside, any jumps
    ((2, 64, 64, 3), (256, 256), "zoom4"),      # 4x zoom: many outputs share a source pixel
    ((2, 1, 1, 3), (5, 7), "random"),           # 1x1 images
    ((3, 37, 41, 1), (20, 30), "grid"),         # C = 1
    ((128, 336, 336, 3), (336, 336), "grid"),   # B = 128 at 336 px
], ids=["clamped", "nonmonotone", "far", "zoom4", "1x1", "c1", "b128_336"])
def test_k1_backward_cuda_edges(cuda, shape, out_hw, maps):
    """K1's backward against the plain version's autograd: the image's
    gradient within 1e-5 and the maps' within 1e-4 of the reference's
    largest magnitude, each of the three asked for alone, both maps, and all
    together; two calls bit-equal (every sum in a fixed order), and the
    kernels each call launches as the design says."""
    g = np.random.default_rng(3)
    B, H, W, C = shape
    img = torch.as_tensor((g.random(shape) * 255).astype(np.float32), device=cuda)
    if maps == "grid":
        att = torch.as_tensor(g.random((B, 24, 24)).astype(np.float32), device=cuda)
        mx, my = (m.contiguous() for m in warp_grid_maps(att, (H, W), out_hw[1], out_hw[0]))
    elif maps == "clamped":
        mx = torch.linspace(-3.0, W + 2.0, out_hw[1], device=cuda).repeat(B, 1)
        my = torch.linspace(-3.0, H + 2.0, out_hw[0], device=cuda).repeat(B, 1)
    else:
        mx, my = (torch.as_tensor(m, device=cuda)
                  for m in _k1_maps(g, maps, B, H, W, *out_hw))
    grad = torch.as_tensor(g.standard_normal((B, *out_hw, C)).astype(np.float32), device=cuda)
    ref = warp_resample_backward_plain(grad, img, mx, my)
    for needs in ((True, True, True), (True, False, False), (False, True, True),
                  (False, True, False), (False, False, True)):
        before = warp_resample_backward.launches, backward_kernels_launched()
        got = warp_resample_backward(grad, img, mx, my, *needs)
        again = warp_resample_backward(grad, img, mx, my, *needs)
        torch.cuda.synchronize()
        assert (warp_resample_backward.launches, backward_kernels_launched()) == (
            before[0] + 2, before[1] + 2 * _bwd_kernels(*needs))
        for k, (a, b, r) in enumerate(zip(got, again, ref)):
            if not needs[k]:
                assert a is None
                continue
            assert _grad_close(a, r, 1e-5 if k == 0 else 1e-4), (k, needs)
            assert torch.equal(a, b)


def _bwd_kernels(need_images, need_map_x, need_map_y):
    """The kernels one backward call launches, by the design of
    ``csrc/warp_resample_bwd.cu``: taps and image gradient, the maps' band
    pass, the band sums of grad_map_x."""
    return 2 * need_images + (need_map_x or need_map_y) + need_map_x


@pytest.mark.cuda
@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False),
                                   (False, True, True), (False, False, True)],
                         ids=["all", "image", "maps", "map_y"])
def test_k1_backward_cuda_kernel_count_seen_by_the_profiler(cuda, needs):
    """The kernels of one backward call, as CUDA's own activity trace
    (``torch.profiler``) sees them, equal the library's count and the
    design's."""
    from torch.profiler import ProfilerActivity, profile

    g = np.random.default_rng(4)
    img = torch.as_tensor(g.random((2, 40, 52, 3)).astype(np.float32), device=cuda)
    mx = torch.as_tensor(g.uniform(-2.0, 54.0, (2, 70)).astype(np.float32), device=cuda)
    my = torch.as_tensor(g.uniform(-2.0, 42.0, (2, 60)).astype(np.float32), device=cuda)
    grad = torch.as_tensor(g.standard_normal((2, 60, 70, 3)).astype(np.float32), device=cuda)
    warp_resample_backward(grad, img, mx, my, *needs)      # built and loaded
    torch.cuda.synchronize()
    before = backward_kernels_launched()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warp_resample_backward(grad, img, mx, my, *needs)
        torch.cuda.synchronize()
    names = ("taps_kernel", "grad_img_kernel", "grad_maps_kernel", "sum_bands_kernel")
    seen = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in names)]
    assert len(seen) == backward_kernels_launched() - before == _bwd_kernels(*needs), seen


@pytest.mark.cuda
def test_k1_backward_cuda_rejects_what_it_cannot_take(cuda):
    """An output row beyond the image gradient's shared memory (W_out * C >
    56 Ki floats) is refused by the launch, which raises; the maps'
    gradients alone take it."""
    img = torch.rand((1, 2, 2, 3), device=cuda)
    mx = torch.linspace(0.0, 1.0, 20000, device=cuda)[None]
    my = torch.zeros((1, 1), device=cuda)
    grad = torch.ones((1, 1, 20000, 3), device=cuda)
    with pytest.raises(RuntimeError, match="warp_resample_backward"):
        warp_resample_backward(grad, img, mx, my, True, False, False)
    gx = warp_resample_backward(grad, img, mx, my, False, True, False)[1]
    ref = warp_resample_backward_plain(grad, img, mx, my, False, True, False)[1]
    assert _grad_close(gx, ref, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bias", [
    (4, 4096, 4096, False),       # LLaVA-1.5-7B q/o at the pipeline's decode rows
    (16, 4096, 11008, False),     # gate/up at the 16-slot pool
    (17, 11008, 4096, False),     # down, the first row count cuBLASLt takes unpadded
    (2560, 4096, 4096, False),    # the pipeline's prefill rows
    (4, 3584, 512, True),         # Qwen2-VL-7B k/v, with bias
    (8, 3584, 152064, False),     # Qwen2-VL-7B's +lm8 head
])
def test_int8_matmul_cuda_matches_exact(cuda, M, K, N, bias):
    """The int8 product on the card (``torch._int_mm``, decode rows padded)
    equals an f64 product of the same int8 values exactly, and the w8a8
    linear after the rescale equals the same arithmetic on that product
    bit for bit."""
    from attwarp_tpu_torch.numerics.quant import (
        apply_linear,
        int8_matmul,
        quantize_linear,
        quantize_rows,
        rescale,
    )

    g = torch.Generator(device=cuda).manual_seed(M + N)
    W = torch.randn((N, K), generator=g, device=cuda, dtype=torch.bfloat16) * 0.02
    b = torch.randn((N,), generator=g, device=cuda) if bias else None
    w = quantize_linear({"weight": W, "bias": b} if bias else W)
    h = torch.randn((M, K), generator=g, device=cuda, dtype=torch.bfloat16)
    hq, ascale = quantize_rows(h)
    launches, padded = int8_matmul.launches, int8_matmul.padded
    y = int8_matmul(hq, w["q"])
    exact = hq.double() @ w["q"].double().t()
    assert y.dtype == torch.int32 and y.shape == (M, N)
    assert torch.equal(y.double(), exact)
    assert int8_matmul.launches == launches + 1
    assert int8_matmul.padded == padded + (M < 24)
    got = apply_linear(h, w)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, rescale(exact.to(torch.int32), ascale, w).to(torch.bfloat16))


@pytest.mark.cuda
def test_int8_matmul_cuda_refuses_widths_it_cannot_take(cuda):
    """A width cuBLASLt's int8 GEMM cannot take raises: no dequantized
    fallback."""
    from attwarp_tpu_torch.numerics.quant import int8_matmul

    a = torch.zeros((32, 60), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_matmul(a, torch.zeros((64, 60), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_matmul(torch.zeros((32, 64), dtype=torch.int8, device=cuda),
                    torch.zeros((60, 64), dtype=torch.int8, device=cuda))
