"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU form, so every test here is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false. This file imports no
JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8, decode_attn_plain
from attwarp_tpu_torch.kernels.flash_prefill import flash_prefill, flash_prefill_plain
from attwarp_tpu_torch.kernels.warp_resample import warp_resample
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
