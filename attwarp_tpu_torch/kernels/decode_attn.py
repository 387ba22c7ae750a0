"""Kernel K3: one-token attention over the int8 KV cache.

``decode_attn_int8(q, k_q, k_s, v_q, v_s, mask, layer, sm_scale)``:

- ``q`` (B, H, hd): the new token's queries;
- ``k_q``/``v_q`` (L, B, S, kvH, hd) int8 and ``k_s``/``v_s`` (L, B, S, kvH)
  f32: the WHOLE cache, read at plane ``layer`` (no plane is copied);
- ``mask`` (B, S) bool: valid slots, including the token just written;
- returns (B, H, hd) in q's dtype, written into ``out`` where given (the
  graphed decode step's static buffer, ``models/decode_graph.py``).

The caller writes the current token's int8 K/V into the cache first; the
kernel reads the updated plane. (The TPU kernel read the step-entry cache and
merged the new token in-kernel, because an XLA custom call reading an
updated buffer forced a copy of the cache; eager PyTorch has no such cost.)

- CPU tensors: ``decode_attn_plain``, the ``_attn_quantcache`` math.
- CUDA tensors: ``csrc/decode_attn_int8.cu`` (q in bf16, as the TPU kernel
  takes it; head_dim 128, any S and any GQA ratio), or an exception. The
  kernel splits S into ``decode_split_plan``'s chunks, one block per
  (split, kv head and up to 8 of its query heads, row) that copies its
  whole chunk into shared memory at once (q.k on the tensor cores, and p.v
  too under GQA), and a second small kernel merges
  the splits' partial softmax states from a scratch buffer that the wrapper
  allocates; ``decode_attn_split_plain`` is that arithmetic in plain
  PyTorch.

Replaces the TPU kernel
``attwarp_tpu/ops/pallas_decode_attn.py::decode_attn_quantcache``.
"""

from __future__ import annotations

import torch

from attwarp_tpu_torch.kernels._build import check_launch, library, require_cuda
from attwarp_tpu_torch.utils import profiling

HEAD_DIM = 128   # the only head_dim the CUDA kernel takes (as on the TPU)
MAX_LEN = 256    # positions per split (the kernel holds the split's rows in shared memory)
STREAM_LEN = 128  # positions per split where the plane is more than one wave holds
CHUNK_STEP = 16  # a split's length is a multiple of this
BLOCKS_PER_SM = 2  # the grid the plan aims for, in blocks per SM
WAVE_BYTES_PER_SM = 192 << 10  # K/V bytes one wave of blocks holds per SM (three 64 KB chunks)


def decode_split_plan(B: int, kvH: int, S: int, sms: int) -> tuple[int, int]:
    """``(n_split, chunk)`` for a card of ``sms`` SMs: split ``s`` covers
    positions ``[s * chunk, min(S, (s + 1) * chunk))``. Enough splits that
    the grid of ``n_split x kvH x B`` blocks is at least ``BLOCKS_PER_SM x
    sms`` (as far as splits of ``CHUNK_STEP`` positions allow) and no split
    is longer than ``MAX_LEN``; a single split where the batch alone fills
    the grid and S fits one (no merge then). Where the plane's K and V rows
    are more than one wave of blocks can hold, the blocks stream it in
    splits of at most ``STREAM_LEN`` (more, smaller blocks overlap their
    loads with each other's work); where they fit, one wave takes all of it
    at once."""
    n = max(-(-BLOCKS_PER_SM * sms // (B * kvH)), -(-S // MAX_LEN))
    if B * kvH * S * 2 * HEAD_DIM > WAVE_BYTES_PER_SM * sms:
        n = max(n, -(-S // STREAM_LEN))
    n = min(n, -(-S // CHUNK_STEP))
    chunk = CHUNK_STEP * -(-S // (CHUNK_STEP * n))
    return -(-S // chunk), chunk


def decode_attn_split_plain(q, k_q, k_s, v_q, v_s, mask, layer: int, sm_scale: float,
                            n_split: int, chunk: int) -> torch.Tensor:
    """The CUDA kernel's split-and-merge arithmetic in plain PyTorch, f32:
    per split a partial softmax state (m, l, acc) over its positions, m =
    -inf for a split with no allowed position; then the merge, ``out = sum_s
    acc_s e^(m_s - M) / sum_s l_s e^(m_s - M)``, zeros where no split has
    one. Masked positions are dropped by select."""
    _, B, S, kvH, hd = k_q.shape
    H = q.shape[1]
    qg = q.float().reshape(B, kvH, H // kvH, hd)
    parts = []
    for s in range(n_split):
        sl = slice(s * chunk, min(S, (s + 1) * chunk))
        ok = mask[:, None, None, sl]
        sc = torch.einsum("bgrd,bsgd->bgrs", qg, k_q[layer, :, sl].float())
        sc = sc * k_s[layer, :, sl].permute(0, 2, 1)[:, :, None, :] * sm_scale
        sc = torch.where(ok, sc, torch.tensor(float("-inf")))
        m = sc.amax(dim=-1)
        p = torch.where(ok, torch.exp(sc - torch.where(m.isfinite(), m, 0)[..., None]),
                        torch.tensor(0.0))
        pv = p * v_s[layer, :, sl].permute(0, 2, 1)[:, :, None, :]
        acc = torch.einsum("bgrs,bsgd->bgrd", pv, v_q[layer, :, sl].float())
        parts.append((m, p.sum(dim=-1), acc))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(M)
    for m, l, acc in parts:
        w = torch.where(m.isfinite(), torch.exp(m - torch.where(M.isfinite(), M, 0)),
                        torch.tensor(0.0))
        num = num + acc * w[..., None]
        den = den + l * w
    out = torch.where(M.isfinite()[..., None], num / torch.where(den > 0, den, 1)[..., None],
                      torch.tensor(0.0))
    return out.reshape(B, H, hd)


def decode_attn_plain(q, k_q, k_s, v_q, v_s, mask, layer: int,
                      sm_scale: float) -> torch.Tensor:
    """Plain PyTorch K3: scores ``(q . k_q) * k_s * sm_scale`` masked to
    ``mask``, softmax in f32, ``out = (p * v_s) . v_q``. The dots run in q's
    dtype, as ``models/llama.py::_attn_quantcache`` (and JAX's) do; GQA by
    index (head h reads kv head ``h // (H // kvH)``). A row with no valid
    token returns zeros, as the kernel does (neither the decode loop nor
    the serving engines make one)."""
    _, B, S, kvH, hd = k_q.shape
    H = q.shape[1]
    n_rep = H // kvH
    dt = q.dtype
    qg = q.reshape(B, kvH, n_rep, hd)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k_q[layer].to(dt)).to(torch.float32)
    s = s * k_s[layer].permute(0, 2, 1)[:, :, None, :]
    s = s * sm_scale
    s = s.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1) * mask.any(dim=-1)[:, None, None, None]
    pv = p * v_s[layer].permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bgrs,bsgd->bgrd", pv.to(dt), v_q[layer].to(dt))
    return out.reshape(B, H, hd)


def decode_attn_int8(q, k_q, k_s, v_q, v_s, mask, layer: int,
                     sm_scale: float, out=None) -> torch.Tensor:
    profiling.count("k3.calls")
    if q.device.type == "cpu":
        res = decode_attn_plain(q, k_q, k_s, v_q, v_s, mask, layer, sm_scale)
        return res if out is None else out.copy_(res)
    if k_q.ndim != 5 or k_q.shape != v_q.shape:
        raise ValueError(f"decode_attn_int8: k_q/v_q must be (L, B, S, kvH, "
                         f"hd); got {tuple(k_q.shape)}, {tuple(v_q.shape)}")
    L, B, S, kvH, hd = k_q.shape
    if q.ndim != 3 or q.shape[0] != B or q.shape[2] != hd:
        raise ValueError(f"decode_attn_int8: q must be (B, H, hd) = ({B}, H, "
                         f"{hd}); got {tuple(q.shape)}")
    H = q.shape[1]
    if hd != HEAD_DIM or H % kvH:
        raise ValueError(f"decode_attn_int8: need head_dim {HEAD_DIM} and H a "
                         f"multiple of kvH; got hd={hd}, H={H}, kvH={kvH}")
    if tuple(k_s.shape) != (L, B, S, kvH) or k_s.shape != v_s.shape:
        raise ValueError("decode_attn_int8: scales must be (L, B, S, kvH)")
    if tuple(mask.shape) != (B, S):
        raise ValueError(f"decode_attn_int8: mask must be ({B}, {S})")
    if not 0 <= layer < L:
        raise ValueError(f"decode_attn_int8: layer {layer} not in [0, {L})")
    for name, t, dt in (("k_q", k_q, torch.int8), ("v_q", v_q, torch.int8),
                        ("k_s", k_s, torch.float32), ("v_s", v_s, torch.float32),
                        ("mask", mask, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"decode_attn_int8: {name} must be {dt}, got {t.dtype}")
    if not q.is_floating_point():
        raise TypeError(f"decode_attn_int8: q must be floating, got {q.dtype}")
    if out is not None and (tuple(out.shape) != (B, H, hd) or out.dtype != q.dtype
                            or out.device != q.device or not out.is_contiguous()):
        raise ValueError(f"decode_attn_int8: out must be a contiguous ({B}, {H}, {hd}) "
                         f"{q.dtype} tensor on {q.device}")
    qb = q.to(torch.bfloat16).contiguous()
    require_cuda("decode_attn_int8", qb, k_q, k_s, v_q, v_s, mask)
    res = (out if out is not None and out.dtype == torch.bfloat16 else
           torch.empty((B, H, hd), dtype=torch.bfloat16, device=q.device))
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split, chunk = decode_split_plan(B, kvH, S, sms)
    # the splits' partial states: (B, H, n_split) acc, then m and l
    scratch = (torch.empty(B * H * n_split * (2 + hd), dtype=torch.float32,
                           device=q.device) if n_split > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().attwarp_decode_attn_int8(
            qb.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), mask.data_ptr(), res.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            L, B, S, H, kvH, hd, int(layer), n_split, chunk, float(sm_scale), stream,
        )
    check_launch(rc, "decode_attn_int8")
    decode_attn_int8.launches += 1
    if out is None:
        return res.to(q.dtype)
    return out if res is out else out.copy_(res)


decode_attn_int8.launches = 0
