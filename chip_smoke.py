#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``attwarp_tpu_torch``) on one
NVIDIA GPU.

1. Names the card (and its power limit, from nvidia-smi); turns TF32 off.
2. Builds the port's CUDA kernels from this checkout with nvcc.
3. Kernel K1 (warp resample) against its plain PyTorch version at the
   pipeline's shape: (4, 512, 640, 3) -> 500x500.
4. Kernel K3 (int8-cache decode attention) against its plain version at
   LLaVA-1.5-7B decode geometry, plus a small GQA case.
5. The two-pass AttWarp pipeline once at LLaVA-1.5-7B width with random
   bf16 weights: int8 KV cache, 4 images of 480x640, 20 new tokens per
   pass, 500 px warp. One warm-up run, then one timed run whose kernel
   launch counts must show K1 and K3 on the path; its masks and warps are
   checked against the port's CPU path.

Run from the repo root:  python3 chip_smoke.py
Exits non-zero on any failure and when no CUDA device is present. The last
line of stdout is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches, error and times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls, by CUDA
    events, after one warm-up call. A GPU spin queued first lets the host
    enqueue every call before the device reaches them, so the events time
    back-to-back device work, not the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)   # ~50 ms at H100 clocks
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def alternate_ms(plain, kernel, iters: int):
    """Plain, kernel, kernel, plain; the lower of each pair."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return min(k1, k2), min(p1, p2)


class TimedBackend:
    """Delegates to a backend and times its two passes (host clock around
    work that ends in a device synchronize)."""

    def __init__(self, backend):
        self.backend = backend
        self.seconds = {}

    @property
    def device(self):
        return self.backend.device

    @property
    def image_size(self):
        return self.backend.image_size

    def _timed(self, name, fn, *args, **kwargs):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - t0
        return out

    def extract(self, *args, **kwargs):
        return self._timed("pass1", self.backend.extract, *args, **kwargs)

    def answer_batch(self, *args, **kwargs):
        return self._timed("pass2", self.backend.answer_batch, *args, **kwargs)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {name} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | TF32 off")
    print(smi)
    return name


def phase_build():
    from attwarp_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)        # prints ptxas registers/smem/spills
    _build.library()
    print(f"[2 build] {_build.library_path().name} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_k1(dev):
    import torch

    from attwarp_tpu_torch.kernels.warp_resample import warp_resample
    from attwarp_tpu_torch.warp.blend import mota_mask
    from attwarp_tpu_torch.warp.resample import remap_bilinear_separable
    from attwarp_tpu_torch.warp.warp import warp_grid_maps

    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.rand((4, 512, 640, 3), generator=g, device=dev) * 255.0
    att = torch.rand((4, 24, 24), generator=g, device=dev)
    masks = mota_mask(att, (512, 640)).to(torch.float32)
    mx, my = warp_grid_maps(masks, (512, 640), 500, 500)
    mx, my = mx.contiguous(), my.contiguous()
    got = warp_resample(img, mx, my)
    ref = remap_bilinear_separable(img, mx, my)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 1e-3 * 255
    ms, plain_ms = alternate_ms(lambda: remap_bilinear_separable(img, mx, my),
                                lambda: warp_resample(img, mx, my), 50)
    print(f"[3 K1 warp_resample] (4,512,640,3)->(4,500,500,3) max|kernel-plain| "
          f"{err:.6g} (tol {tol:.3g}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    check(got.shape == (4, 500, 500, 3) and err <= tol, "K1 disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _k3_case(dev, L, B, S, H, kvH, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    hd = 128
    k_q = torch.randint(-127, 128, (L, B, S, kvH, hd), generator=g, device=dev,
                        dtype=torch.int8)
    v_q = torch.randint(-127, 128, (L, B, S, kvH, hd), generator=g, device=dev,
                        dtype=torch.int8)
    k_s = (torch.rand((L, B, S, kvH), generator=g, device=dev) + 0.5) / 127
    v_s = (torch.rand((L, B, S, kvH), generator=g, device=dev) + 0.5) / 127
    q = torch.randn((B, H, hd), generator=g, device=dev).to(torch.bfloat16)
    # left padding and a current length per row, as the decode loop has them
    ar = torch.arange(S, device=dev)[None, :]
    pad = torch.tensor([(37 * b) % 64 for b in range(B)], device=dev)[:, None]
    cur = torch.tensor([S - 44 + 3 * b for b in range(B)], device=dev)[:, None]
    mask = (ar >= pad) & (ar <= cur)
    return q, k_q, k_s, v_q, v_s, mask


def _compare(got, ref):
    import torch

    g, r = got.float().flatten(), ref.float().flatten()
    cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item()
    return cos, (g - r).abs().max().item(), r.abs().max().item()


def phase_k3(dev):
    import torch

    from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8, decode_attn_plain

    sm = 1.0 / 128 ** 0.5
    # LLaVA-1.5-7B decode: L=32, B=4, S=704 (640-token prompt + 20, to 64s)
    q, k_q, k_s, v_q, v_s, mask = _k3_case(dev, 32, 4, 704, 32, 32, seed=2)
    layer = 7
    got = decode_attn_int8(q, k_q, k_s, v_q, v_s, mask, layer, sm)
    ref = decode_attn_plain(q, k_q, k_s, v_q, v_s, mask, layer, sm)
    ref32 = decode_attn_plain(q.float(), k_q, k_s, v_q, v_s, mask, layer, sm)
    torch.cuda.synchronize()
    cos, err, mag = _compare(got, ref)
    cos32, err32, _ = _compare(got, ref32)
    # bf16 rounds the plain version's dots (8-bit mantissa): 2% of the
    # output range bounds a few such roundings
    tol = 2e-2 * mag
    ms, plain_ms = alternate_ms(
        lambda: decode_attn_plain(q, k_q, k_s, v_q, v_s, mask, layer, sm),
        lambda: decode_attn_int8(q, k_q, k_s, v_q, v_s, mask, layer, sm), 50)
    print(f"[4 K3 decode_attn_int8] L=32 B=4 S=704 H=kvH=32 hd=128 bf16: vs plain "
          f"cos {cos:.6f} max|d| {err:.4g} (tol {tol:.4g} = 2% of max|ref| "
          f"{mag:.4g}); vs f32 plain cos {cos32:.6f} max|d| {err32:.4g} | "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    check(cos > 0.999 and cos32 > 0.999 and err <= tol,
          "K3 disagrees with its plain version at 7B geometry")
    del q, k_q, k_s, v_q, v_s, mask

    qg, kq, ks, vq, vs, mg = _k3_case(dev, 2, 2, 192, 32, 4, seed=3)
    gq = decode_attn_int8(qg, kq, ks, vq, vs, mg, 1, sm)
    rq = decode_attn_plain(qg, kq, ks, vq, vs, mg, 1, sm)
    torch.cuda.synchronize()
    gcos, gerr, gmag = _compare(gq, rq)
    print(f"[4 K3 decode_attn_int8] GQA L=2 B=2 S=192 H=32 kvH=4: cos {gcos:.6f} "
          f"max|d| {gerr:.4g} (tol {2e-2 * gmag:.4g})")
    check(gcos > 0.999 and gerr <= 2e-2 * gmag, "K3 disagrees on the GQA case")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_slice(dev):
    import numpy as np
    import torch

    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.resize import resize_scale_device
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8
    from attwarp_tpu_torch.kernels.warp_resample import warp_resample
    from attwarp_tpu_torch.models.llama import LlamaConfig
    from attwarp_tpu_torch.models.llava import LlavaConfig, LlavaModel, random_params
    from attwarp_tpu_torch.pipeline import AttWarpPipeline
    from attwarp_tpu_torch.warp.blend import mota_mask
    from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

    # llava-hf/llava-1.5-7b-hf geometry: CLIP-L/14-336, 32-layer 4096-wide
    # LLaMA, vocab 32064 with the image token at 32000
    cfg = LlavaConfig(text=LlamaConfig(vocab_size=32064), image_token_index=32000)
    t0 = time.perf_counter()
    params = random_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                           torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[5 slice] random bf16 LLaVA-1.5-7B: {n_params / 1e9:.3f} B parameters "
          f"in {time.perf_counter() - t0:.1f} s")
    backend = TimedBackend(LlavaBackend(LlavaModel(cfg, params),
                                        tokenizer=DryRunTokenizer(),
                                        extract_layer=20, kv_quant=True))
    pipe = AttWarpPipeline(backend, warp_size=500, max_new_tokens=20)
    rng = np.random.default_rng(0)
    images = [(rng.random((480, 640, 3)) * 255).astype(np.uint8) for _ in range(4)]
    questions = ["what is the text on the label?", "what is shown here?",
                 "read the code on the tag", "what is the key phrase in the image?"]

    t0 = time.perf_counter()
    pipe.run(images, questions)
    torch.cuda.synchronize()
    print(f"[5 slice] warm-up run {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    warp_resample.launches = 0
    decode_attn_int8.launches = 0
    t0 = time.perf_counter()
    res = pipe.run(images, questions)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"warp_resample": warp_resample.launches,
                "decode_attn_int8": decode_attn_int8.launches}
    peak = torch.cuda.max_memory_allocated()

    L, steps = cfg.text.num_hidden_layers, 20
    want_k3 = steps * (L - 1) + steps * L   # pass 1 skips the extract layer
    want_k1 = 1                             # one shape group
    p1, p2 = backend.seconds["pass1"], backend.seconds["pass2"]
    print(f"[5 slice] maps {res.attention_maps.shape} warped {res.warped.shape} "
          f"masks {res.mota_masks[0].shape} {res.mota_masks[0].dtype}")
    print(f"[5 slice] first answers {res.first_answers}")
    print(f"[5 slice] second answers {res.second_answers}")
    print(f"[5 slice] launches: K1 {launches['warp_resample']} (expected {want_k1}), "
          f"K3 {launches['decode_attn_int8']} (expected {want_k3})")
    print(f"[5 slice] wall: total {total:.3f} s | pass 1 {p1:.3f} s | mask+warp "
          f"and resizes {total - p1 - p2:.3f} s | pass 2 {p2:.3f} s | "
          f"{4 / total:.3f} samples/s | peak memory {peak / 2**30:.2f} GiB")

    check(res.attention_maps.shape == (4, 24, 24), "maps shape")
    check(res.warped.shape == (4, 500, 500, 3), "warped shape")
    check(bool(np.isfinite(res.attention_maps).all()), "maps not finite")
    check(bool(np.isfinite(res.warped).all()), "warped not finite")
    check(np.allclose(res.attention_maps.sum(axis=(1, 2)), 1.0, atol=1e-3),
          "maps do not sum to 1")
    check(all(m.shape == (512, 640) and m.dtype == np.uint8 for m in res.mota_masks),
          "mask shapes")
    check(len(res.first_answers) == 4 and len(res.second_answers) == 4, "answers")
    check(launches["warp_resample"] == want_k1, "K1 launch count")
    check(launches["decode_attn_int8"] == want_k3, "K3 launch count")

    # the card's masks (from its maps) and warps (from its masks) against
    # the port's CPU path on the same inputs
    img255 = resize_scale_device(torch.as_tensor(np.stack(images)),
                                 255.0 * (1.0 / 255.0), (512, 640))
    m_cpu = mota_mask(torch.as_tensor(res.attention_maps), (512, 640)).numpy()
    m_dev = np.stack(res.mota_masks)
    w_cpu = warp_batch_by_attention(img255, torch.as_tensor(m_dev, dtype=torch.float32),
                                    500, 500).numpy()
    mask_d = int(np.abs(m_dev.astype(np.int16) - m_cpu.astype(np.int16)).max())
    warp_d = float(np.abs(res.warped - w_cpu).max())
    print(f"[5 slice] vs CPU path: masks max|d| {mask_d} LSB (tol 1), warped "
          f"max|d| {warp_d:.4g} (tol {1e-3 * 255:.3g})")
    check(mask_d <= 1, "masks disagree with the CPU path")
    check(warp_d <= 1e-3 * 255, "warped images disagree with the CPU path")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    name = phase_device()
    phase_build()
    k1 = phase_k1(dev)
    k3 = phase_k3(dev)
    launches = phase_slice(dev)
    kernels = [
        {"name": "warp_resample", "route": "cuda",
         "source": "attwarp_tpu_torch/csrc/warp_resample.cu",
         "replaces": "attwarp_tpu/ops/pallas_warp.py:87",
         "launches": launches["warp_resample"], **k1},
        {"name": "decode_attn_int8", "route": "cuda",
         "source": "attwarp_tpu_torch/csrc/decode_attn_int8.cu",
         "replaces": "attwarp_tpu/ops/pallas_decode_attn.py:284",
         "launches": launches["decode_attn_int8"], **k3},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
