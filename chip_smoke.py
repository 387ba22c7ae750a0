#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``attwarp_tpu_torch``) on one
NVIDIA GPU.

1. Names the card (and its power limit, from nvidia-smi); turns TF32 off;
   in a child process, reports whether Pillow, OpenCV, transformers and
   tokenizers import, and loads a saved dry-run tokenizer with
   transformers made unimportable.
2. Builds the port's CUDA kernels from this checkout with nvcc (one nvcc
   per source, all at once).
3. Kernel K1 (warp resample) against its plain PyTorch version at the
   pipeline's shape, (4, 512, 640, 3) -> 500x500, at the dataset driver's,
   one 512x512 scene and one 683x1024 photo per launch, and at the
   warp-only shape, (128, 336, 336, 3) -> 336x336; then warps/s of the
   warp-only path (grid maps + K1) at that shape.
4. Kernel K3 (int8-cache decode attention) against its plain version at
   LLaVA-1.5-7B and Qwen2-VL-7B decode geometry (B=4, S=704; 32/32 and
   28/4 heads), at their serving geometry (B=16 and B=8 slots, S=768)
   with per-slot [start, cur] windows, a retired slot's [0, 0] and a free
   slot's [0, j], at step 10's LLaVA-1.5-7B geometry (the driver's B=8
   extraction decode and the harness's 8-slot engine, both S=704), plus a
   small GQA case.
5. Kernel K2 (flash prefill) against its plain version at LLaVA-1.5-7B and
   Qwen2-VL-7B prefill geometry (B=4, T=640; 32/32 and 28/4 heads), at
   their admission geometry (groups of 8 at T=704), at the dataset
   driver's LLaVA-1.5-7B extraction prefill (B=8, T=640), all with per-row
   left padding, plus a ragged T=200.
6. The two-pass AttWarp pipeline once at LLaVA-1.5-7B width with random
   bf16 weights: int8 KV cache, 4 images of 480x640, 20 new tokens per
   pass, 500 px warp. One warm-up run, then one timed run whose kernel
   launch counts must show K1 and K3 on the path; its masks and warps are
   checked against the port's CPU path.
7. The same pipeline at Qwen2-VL-7B width (random bf16 weights, 672 px,
   24x24 maps) with the int8 cache and the flash prefill: first the flash
   prefill against the dense one on the slice's first batch (held on an
   f32 copy of the text weights, where the dense path is exact, and on the
   bf16 weights against the dense path's own distance from f32), then one
   warm-up and one timed run whose launch counts must show K1, K2 and K3.
8. Serving at full width, through ``attwarp_tpu_torch.cli.serve.serve`` on
   the weights of steps 6 and 7, every request submitted at once:
   LLaVA-1.5-7B ``+kv8+flash`` (16 slots, 32 requests in the 640 and 704
   buckets, 8-32 new tokens), the chunked engine on LLaVA-1.5-7B ``+kv8``
   (P=128, 16 slots, 16 requests), one steady ``+kv8+flash`` tick at 16
   slots on the host clock, and Qwen2-VL-7B ``+kv8+flash`` at 672 px (8
   slots, 16 requests). Each run prints tokens/s, TTFT p50/p95, admission
   waves, peak memory, wall and its host-clock split, and its launch
   counts must be K3 = layers x decode steps and K2 = layers x admission
   prefills (0 for the chunked engine). Each model's weights are freed
   after its serve runs.
9. Serving parity at LLaVA-1.5-7B width with 2 vision and 2 decoder layers
   and f32 weights: ``ServeEngine`` (4 slots, ``+flash``) on a dense and on
   an int8 cache gives every request (6 prompts of 600-700 tokens, 8 new
   tokens) the greedy tokens of its own ``generate_with_attention`` on the
   same cache type, left-padded to the same bucket; the chunked engine
   (P=128) gives those of ``ServeEngine`` without ``+flash``.
10. The dataset driver and the eval harness on step 6's LLaVA-1.5-7B
    weights, ``+kv8+flash``: 16 code-tag scenes (512 px, seed 0) through
    ``cli.process_dataset.process_dataset`` (batches of 8, 20 new tokens),
    then ``eval.harness.evaluate_textvqa_accuracy`` on the warped and the
    original images through ``EngineAnswerBackend`` (8 slots, 16 new
    tokens). Checks the artifact tree, that none of the driver's and the
    harness's fallbacks fired (every warp written, no uniform map, the
    first chunk's maps equal to a direct extract, every sample evaluated,
    the engine alive) and the K1/K2/K3 launch counts the path predicts.
11. The code-tag accuracy chain through both CLIs' ``main`` on the card:
    50 scenes (seed 0), the reader proxy backend, batches of 8; K1 = 50,
    50 evaluated, original accuracy <= 0.02, warped-vs-original gain within
    one sample in 50 of the JAX chain's +0.86 on the same JPEG scenes (its
    CPU run). Steps 10 and 11 write under ``build/chip_smoke/`` in the
    checkout; both read and write image files through Pillow.

Steps 3-5 time each kernel at its main-path shapes with L2 flushed before
every call, as a prefill or a decode step finds its layer's tensors cold in
HBM (the time with L2 warm is reported beside it as ``warm_ms``), beside
its plain version, the least time the card could take
for the same work (``kernels/roofline.py``: bytes over 3.35 TB/s or
operations over the peak rate of their type, whichever is larger) and one
PyTorch call computing the same function where there is one:
``F.grid_sample`` for K1 (timed with L2 warm too, ``library_warm_ms``) and
``F.scaled_dot_product_attention`` (fastest backend that takes a bool
mask) for K2, each checked to agree with the plain version; none for K3.

Run from the repo root:  python3 chip_smoke.py
Exits non-zero on any failure and when no CUDA device is present. The last
line of stdout is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches (per path), error and times. Each phase
prints its wall. ``--parent DIR`` also times the K1 of the checkout in DIR
(another commit, e.g. unpacked with ``git archive``) against this one's at
K1's timed shapes, in turns.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time


L2_FLUSH_BYTES = 256 << 20   # over five times the H100's 50 MB L2
_flush_buf = []


def _flush_l2():
    """Reads a buffer larger than L2, so the next call finds its inputs in
    HBM (a read leaves no dirty lines to write back during that call)."""
    import torch

    if not _flush_buf:
        _flush_buf.append(torch.ones(L2_FLUSH_BYTES // 4, device="cuda"))
    _flush_buf[0].sum()


def cuda_ms(fn, iters: int, cold: bool = False) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls, by CUDA
    events, after one warm-up call. A GPU spin queued first lets the host
    enqueue every call before the device reaches them, so the events time
    back-to-back device work, not the host's launch rate. ``cold``: L2 is
    flushed before every call, outside its events."""
    import torch

    fn()
    if cold:
        _flush_l2()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)   # ~50 ms at H100 clocks
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        _flush_l2()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def alternate_ms(fns: dict, iters: int, cold: bool = False) -> dict:
    """Each call of ``fns`` timed in order and then in reverse order (plain,
    kernel, library, library, kernel, plain); the lower of each pair, by
    name."""
    order = list(fns) + list(fns)[::-1]
    times = [(name, cuda_ms(fns[name], iters, cold)) for name in order]
    return {name: min(t for n, t in times if n == name) for name in fns}


def with_bound(entry: dict, work, peak=None) -> dict:
    """``entry`` (with "ms") plus the card's least time for ``work`` (bytes,
    flops) and the share of it the kernel reaches."""
    from attwarp_tpu_torch.kernels import roofline

    b = roofline.bound(*work, **({"peak_flops": peak} if peak else {}))
    return {**entry, **b, "pct_of_bound": 100.0 * b["bound_ms"] / entry["ms"]}


def _bound_text(e: dict) -> str:
    lib = (f"{e['library']} {e['library_ms']:.4f} ms" if e["library_ms"] is not None
           else f"none ({e['library_note']})")
    return (f" | bound {e['bound_ms']:.4f} ms ({e['bound_by']}, {e['bound_peak']}), "
            f"{e['pct_of_bound']:.1f}% of bound | library {lib}")


class TimedBackend:
    """Delegates to a backend and adds up the time of its two passes,
    ``extract`` ("pass1") and ``answer_batch`` ("pass2"), in ``seconds``
    (host clock around work that ends in a device synchronize)."""

    def __init__(self, backend):
        self.backend = backend
        self.seconds = {}

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def _timed(self, name, fn, *args, **kwargs):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    def extract(self, *args, **kwargs):
        return self._timed("pass1", self.backend.extract, *args, **kwargs)

    def answer_batch(self, *args, **kwargs):
        return self._timed("pass2", self.backend.answer_batch, *args, **kwargs)


def _phase(tag, fn, *args):
    """Run one phase and print its wall (host clock)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{tag}] phase wall {time.perf_counter() - t0:.2f} s")
    return out


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
    # which imaging and tokenizer libraries import, and that a checkpoint's
    # tokenizer loads without transformers, from a child process, so that
    # this one imports none of them
    from pathlib import Path

    probe = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.library_probe()"],
        capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent)
    for line in probe.stdout.strip().splitlines():
        print(f"[1 device] {line}")
    check(probe.returncode == 0, f"library probe failed: {probe.stderr[-2000:]}")
    return name


def library_probe():
    """Prints which of Pillow, OpenCV, transformers and tokenizers import,
    then saves the dry-run tokenizer as a checkpoint does and loads it back
    with transformers made unimportable: the port's own reader."""
    import importlib

    found = []
    for m in ("PIL", "cv2", "transformers", "tokenizers"):
        try:
            found.append(f"{m} {importlib.import_module(m).__version__}")
        except Exception as e:
            found.append(f"{m} not importable: {type(e).__name__}")
    print("libraries: " + " | ".join(found))
    sys.modules["transformers"] = None
    from attwarp_tpu_torch.extract.checkpoint import load_tokenizer
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer

    d = _scratch("tokenizer")
    DryRunTokenizer().save_pretrained(d)
    tok = load_tokenizer(d)
    text = "USER: what is the code on the tag? ASSISTANT:"
    check(type(tok) is DryRunTokenizer and tok.encode(text) == DryRunTokenizer().encode(text),
          "the saved tokenizer did not load without transformers")
    print(f"checkpoint tokenizer without transformers: {type(tok).__name__}, "
          f"{len(tok.vocab)} tokens, ids equal")


def phase_build():
    from attwarp_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)        # prints ptxas registers/smem/spills
    _build.library()
    print(f"[2 build] {_build.library_path().name} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


# K1's timed shapes: (B, H, W) -> S x S, C=3
K1_SHAPES = (("pipeline", (4, 512, 640), 500),        # one pipeline batch
             ("dataset_driver", (1, 512, 512), 500),  # one code-tag scene
             # one TextVQA photo, 683 x 1024 (OpenImages' long side): rows of
             # 8196 bytes, no multiple of 16, staged by cp.async, not TMA
             ("dataset_driver_683w", (1, 1024, 683), 500),
             ("warp_only", (128, 336, 336), 336))     # the warp-only headline


def phase_k1(dev):
    """K1 at its timed shapes (see ``_k1_case``), then warps/s of the
    warp-only path (grid maps + K1) at 336 px, B=128, 24x24 attention."""
    import torch

    from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

    out = {name: _k1_case(dev, name, *shape, S) for name, shape, S in K1_SHAPES}
    g = torch.Generator(device=dev).manual_seed(3)
    img = torch.rand((128, 336, 336, 3), generator=g, device=dev) * 255.0
    att = torch.rand((128, 24, 24), generator=g, device=dev)

    def path():
        return warp_batch_by_attention(img, att, 336, 336)

    # a call is ~100 kernels, nearly all of them the grid maps' small ops:
    # 20 calls overflow the launch queue, which blocks the host until the
    # spin ends and then times its launch rate. So the device time comes from 3
    # calls behind a ~0.1 s spin, five times: the median of the runs whose
    # start event was still pending once all 3 were enqueued (back-to-back
    # device work), null where no run was; the eager wall of 20 calls (host
    # clock, ends in a sync) is beside it.
    path()
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            path()
        ahead = not start.query()
        end.record()
        end.synchronize()
        if ahead:
            runs.append(start.elapsed_time(end) / 3)
    ms = statistics.median(runs) if runs else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        path()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 20
    out["warp_only"].update(warps_per_s=128 / (ms / 1e3) if runs else None, path_ms=ms,
                            path_wall_ms=wall_ms, path_runs_ahead=len(runs))
    device = (f"{ms:.4f} ms per batch on the device, {128 / (ms / 1e3):,.0f} warps/s "
              if runs else "not measured on the device (the host fell behind in every run) ")
    print(f"[3 K1 warp_resample] warp-only path (grid maps + K1), 336 px, B=128, 24x24 "
          f"attention: {device}(CUDA events, median of the {len(runs)} of 5 runs of 3 calls "
          f"enqueued ahead of the device) | eager wall {wall_ms:.4f} ms per batch, "
          f"{128 / (wall_ms / 1e3):,.0f} warps/s (host clock, 20 calls)")
    del img, att
    _flush_buf.clear()
    torch.cuda.empty_cache()
    return out


def _k1_inputs(dev, name, B, H, W, S):
    """A K1 shape's image and maps from random attention: through the MOTA
    mask at the pipeline's and the driver's shapes, as they run it;
    straight from 24x24 maps at the warp-only shape."""
    import torch

    from attwarp_tpu_torch.warp.blend import mota_mask
    from attwarp_tpu_torch.warp.warp import warp_grid_maps

    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.rand((B, H, W, 3), generator=g, device=dev) * 255.0
    att = torch.rand((B, 24, 24), generator=g, device=dev)
    if name == "warp_only":
        mx, my = warp_grid_maps(att, (H, W), S, S)
    else:
        mx, my = warp_grid_maps(mota_mask(att, (H, W)).to(torch.float32), (H, W), S, S)
    return img, mx.contiguous(), my.contiguous()


def k1_kernel_times(dev) -> dict:
    """The K1 of the ``attwarp_tpu_torch`` on ``sys.path`` at each timed
    shape: held to its plain version, then timed with L2 flushed and warm
    ({name: [ms, warm_ms]}). ``--parent`` runs this in another checkout."""
    import torch

    from attwarp_tpu_torch.kernels.warp_resample import warp_resample
    from attwarp_tpu_torch.warp.resample import remap_bilinear_separable

    out = {}
    for name, (B, H, W), S in K1_SHAPES:
        img, mx, my = _k1_inputs(dev, name, B, H, W, S)
        err = (warp_resample(img, mx, my) - remap_bilinear_separable(img, mx, my)).abs().max()
        check(err.item() <= 1e-3 * 255, f"K1 disagrees with its plain version ({name})")
        out[name] = [cuda_ms(lambda: warp_resample(img, mx, my), 50, cold=True),
                     cuda_ms(lambda: warp_resample(img, mx, my), 50)]
        del img, mx, my
    torch.cuda.empty_cache()
    return out


def _parent_k1_times(parent) -> dict:
    """``k1_kernel_times`` in a child process whose package is the one in
    directory ``parent`` (a checkout of another commit): its kernels are
    built there, from its own sources."""
    from pathlib import Path

    code = ("import importlib.util, json, torch; "
            f"spec = importlib.util.spec_from_file_location('smoke', {str(Path(__file__).resolve())!r}); "
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
            "print(json.dumps(m.k1_kernel_times(torch.device('cuda:0'))))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=parent)
    check(res.returncode == 0, f"the parent's K1 failed: {res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def phase_k1_parent(k1, parent):
    """The parent checkout's K1 against this one's at each timed shape, in
    turns (parent, change, change, parent) on this card; adds ``parent_ms``
    and ``parent_warm_ms`` (the lower of its two turns) to ``k1``."""
    import torch

    turns = [_parent_k1_times(parent), k1_kernel_times(torch.device("cuda:0")),
             k1_kernel_times(torch.device("cuda:0")), _parent_k1_times(parent)]
    for name, _, _ in K1_SHAPES:
        t = [turn[name] for turn in turns]
        k1[name]["parent_ms"] = min(t[0][0], t[3][0])
        k1[name]["parent_warm_ms"] = min(t[0][1], t[3][1])
        k1[name]["turns_ms"] = t
        print(f"[3 K1 vs parent] {name}: L2 flushed (warm) parent {t[0][0]:.4f} ({t[0][1]:.4f}), "
              f"change {t[1][0]:.4f} ({t[1][1]:.4f}), change {t[2][0]:.4f} ({t[2][1]:.4f}), "
              f"parent {t[3][0]:.4f} ({t[3][1]:.4f}) ms")


def _k1_case(dev, name, B, H, W, S):
    """K1 against its plain version at one timed shape (``_k1_inputs``),
    timed with L2 flushed and warm beside its plain version,
    ``F.grid_sample`` and its bound. Also the bytes it touches: the
    distinct source rows of each image, the maps and the output."""
    import torch

    from attwarp_tpu_torch.kernels import roofline
    from attwarp_tpu_torch.kernels.warp_resample import k1_plan, warp_resample
    from attwarp_tpu_torch.warp.resample import remap_bilinear_separable

    img, mx, my = _k1_inputs(dev, name, B, H, W, S)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = k1_plan(B, H, W, 3, S, S, sms)
    got = warp_resample(img, mx, my)
    ref = remap_bilinear_separable(img, mx, my)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 1e-3 * 255
    # the yardstick: grid_sample on an NCHW copy, border padding (=
    # BORDER_REPLICATE), align_corners so that -1 and 1 are pixel centres 0
    # and W-1; the copy and the grid are made outside the timing
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    gx = (2 * mx / (W - 1) - 1)[:, None, :].expand(B, S, S)
    gy = (2 * my / (H - 1) - 1)[:, :, None].expand(B, S, S)
    grid = torch.stack((gx, gy), dim=-1).contiguous()

    def library():
        return torch.nn.functional.grid_sample(img_nchw, grid, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    lib_err = (library().permute(0, 2, 3, 1) - ref).abs().max().item()
    check(got.shape == (B, S, S, 3), f"K1 output shape ({name})")
    del got, ref

    fns = {"kernel": lambda: warp_resample(img, mx, my), "library": library}
    t = alternate_ms({"plain": lambda: remap_bilinear_separable(img, mx, my), **fns}, 50,
                     cold=True)
    warm = alternate_ms(fns, 50)
    # the source rows the maps read (each image's distinct y0 and y1), the
    # maps and the output: what a kernel that skips unread rows must move
    y0 = torch.floor(my).clamp(0, H - 1)
    y1 = (torch.floor(my) + 1).clamp(0, H - 1)
    rows = sum(int(torch.unique(torch.cat((y0[b], y1[b]))).numel()) for b in range(B))
    touched = 4 * (rows * W * 3 + B * 2 * S + B * S * S * 3)
    work = roofline.k1_work(B, H, W, 3, S, S)
    e = with_bound({"max_abs_err": err, "ms": t["kernel"], "warm_ms": warm["kernel"],
                    "plain_ms": t["plain"], "library_ms": t["library"],
                    "library_warm_ms": warm["library"],
                    "library": "F.grid_sample", "library_max_abs_err": lib_err,
                    "touched_bytes": touched,
                    "pct_of_touched_bound": 100.0 * touched / roofline.HBM_BYTES_PER_S * 1e3
                    / t["kernel"],
                    "plan": {k: getattr(plan, k) for k in ("rows", "tile", "slots", "blocks")}},
                   work, roofline.F32_FLOPS)
    print(f"[3 K1 warp_resample] {name} ({B},{H},{W},3)->({B},{S},{S},3) plan rows "
          f"{plan.rows} slots {plan.slots} blocks {plan.blocks} | max|kernel-plain| "
          f"{err:.6g} (tol {tol:.3g}), max|grid_sample-plain| {lib_err:.6g} | kernel "
          f"{t['kernel']:.4f} ms (L2 warm {warm['kernel']:.4f}), plain {t['plain']:.4f} ms"
          + _bound_text(e) + f" (L2 warm {warm['library']:.4f}) | "
          f"touched {touched / 1e6:.2f} MB of the bound's {work[0] / 1e6:.2f} MB, "
          f"{e['pct_of_touched_bound']:.1f}% of their time")
    check(err <= tol, f"K1 disagrees with its plain version ({name})")
    check(lib_err <= tol, "the grid_sample yardstick computes another function")
    del img, img_nchw, mx, my
    return e


def _serve_windows(B, buckets=(640, 704), depth=60):
    """Per-slot [start, cur] windows of a serving pool: prompts left-padded
    in ``buckets`` at decode depths below ``depth``, then a retired slot's
    [0, 0] and a free slot's [0, j]. The defaults fit the S=768 pools of
    step 8; the harness's engine in step 10 holds prompts of the 640 bucket
    with 16 answer tokens and one tick of 8 in S=704."""
    rows = [((37 * b) % 64, buckets[b % len(buckets)] + (11 * b) % depth)
            for b in range(B - 2)]
    return rows + [(0, 0), (0, 17)]


# the dataset driver's extraction decode (step 10): 8 prompts left-padded
# to T=640, every row at the last of its 20 decode steps, in S=704
_EXTRACT_WINDOWS = [((37 * b) % 64, 640 + 19) for b in range(8)]


def _k3_case(dev, L, B, S, H, kvH, seed, windows=None):
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
    # left padding and a current length per row, as the decode loop has
    # them, or each slot's own window
    if windows is None:
        windows = [((37 * b) % 64, S - 44 + 3 * b) for b in range(B)]
    ar = torch.arange(S, device=dev)[None, :]
    start, cur = (torch.tensor(c, device=dev)[:, None] for c in zip(*windows))
    mask = (ar >= start) & (ar <= cur)
    return q, k_q, k_s, v_q, v_s, mask


def _compare(got, ref):
    import torch

    g, r = got.float().flatten(), ref.float().flatten()
    cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item()
    return cos, (g - r).abs().max().item(), r.abs().max().item()


def phase_k3(dev):
    import torch

    from attwarp_tpu_torch.kernels import roofline
    from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8, decode_attn_plain

    sm = 1.0 / 128 ** 0.5
    out = {}
    # decode caches of S=704 (640-token prompt + 20, to 64s): LLaVA-1.5-7B
    # (32 layers, 32/32 heads) and Qwen2-VL-7B (28 layers, 28 over 4 kv
    # heads, n_rep 7); their serving slot pools (16 and 8 slots of
    # max_seq 768, per-slot windows); LLaVA-1.5-7B in the dataset driver's
    # extraction (B=8) and in the harness's 8-slot engine (S=704); plus a
    # small GQA case with n_rep 8
    for name, (L, B, S, H, kvH), seed, timed, windows in (
            ("llava7b", (32, 4, 704, 32, 32), 2, True, None),
            ("qwen7b", (28, 4, 704, 28, 4), 9, True, None),
            ("llava7b_serve", (32, 16, 768, 32, 32), 12, True, _serve_windows(16)),
            ("qwen7b_serve", (28, 8, 768, 28, 4), 13, True, _serve_windows(8)),
            ("llava7b_dataset", (32, 8, 704, 32, 32), 14, True, _EXTRACT_WINDOWS),
            ("llava7b_dataset_serve", (32, 8, 704, 32, 32), 15, True,
             _serve_windows(8, buckets=(640,), depth=24)),
            ("gqa", (2, 2, 192, 32, 4), 3, False, None)):
        q, k_q, k_s, v_q, v_s, mask = _k3_case(dev, L, B, S, H, kvH, seed, windows)
        layer = min(7, L - 1)
        got = decode_attn_int8(q, k_q, k_s, v_q, v_s, mask, layer, sm)
        ref = decode_attn_plain(q, k_q, k_s, v_q, v_s, mask, layer, sm)
        ref32 = decode_attn_plain(q.float(), k_q, k_s, v_q, v_s, mask, layer, sm)
        torch.cuda.synchronize()
        cos, err, mag = _compare(got, ref)
        cos32, err32, mag32 = _compare(got, ref32)
        # bf16 rounds the plain version's dots (8-bit mantissa): 2% of the
        # output range bounds a few such roundings
        tol = 2e-2 * mag
        line = (f"[4 K3 decode_attn_int8] {name} L={L} B={B} S={S} H={H} kvH={kvH} "
                f"hd=128 bf16: vs plain cos {cos:.6f} max|d| {err:.4g} (tol {tol:.4g} "
                f"= 2% of max|ref| {mag:.4g}); vs f32 plain cos {cos32:.6f} max|d| "
                f"{err32:.4g}")
        if timed:
            def t_kernel():
                return decode_attn_int8(q, k_q, k_s, v_q, v_s, mask, layer, sm)

            t = alternate_ms({
                "plain": lambda: decode_attn_plain(q, k_q, k_s, v_q, v_s, mask, layer, sm),
                "kernel": t_kernel}, 200, cold=True)
            warm = cuda_ms(t_kernel, 200)
            out[name] = e = with_bound(
                {"max_abs_err": err, "ms": t["kernel"], "warm_ms": warm, "plain_ms": t["plain"],
                 "library_ms": None, "library_note": "no single PyTorch call takes an "
                 "int8 cache with per-token scales"},
                roofline.k3_work(B, S, H, kvH, int(mask.sum().item())))
            line += (f" | kernel {t['kernel']:.4f} ms (L2 warm {warm:.4f}), plain "
                     f"{t['plain']:.4f} ms" + _bound_text(e))
        print(line)
        check(bool(torch.isfinite(got).all()) and cos > 0.999 and cos32 > 0.999
              and err <= tol and err32 <= 2e-2 * mag32,
              f"K3 disagrees with its plain version ({name})")
        del q, k_q, k_s, v_q, v_s, mask, got, ref, ref32
    torch.cuda.empty_cache()
    return out


def _k2_case(dev, B, T, H, kvH, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, T, n, 128), generator=g, device=dev).to(torch.bfloat16)
               for n in (H, kvH, kvH))
    # left padding that differs per row, as a batch of prompts has it
    pad = torch.tensor([(37 * b) % 61 for b in range(B)], device=dev)[:, None]
    return q, k, v, torch.arange(T, device=dev)[None, :] >= pad


def _sdpa_yardstick(q, k, v, mask, sm, ref32):
    """K2's library yardstick: ``F.scaled_dot_product_attention`` on q, k, v
    in (B, H, T, 128) with a (B, 1, T, T) bool mask of causal and same
    segment, all made here, outside any timing. Tries the cuDNN and the
    memory-efficient backends, GQA by ``enable_gqa`` and, where a backend
    refuses that, with K/V repeated to H heads; keeps each candidate whose
    output holds K2's bars against the f32 plain version and returns the
    fastest as (its name, a call, what was tried), or (None, None, what
    was tried)."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, T, H, hd = q.shape
    kvH = k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    am = (causal[None] & (mask[:, :, None] == mask[:, None, :]))[:, None].contiguous()
    variants = [("gqa", kt, vt, {"enable_gqa": True})] if H != kvH else [("mha", kt, vt, {})]
    if H != kvH:
        variants.append(("kv repeated", kt.repeat_interleave(H // kvH, dim=1).contiguous(),
                         vt.repeat_interleave(H // kvH, dim=1).contiguous(), {}))
    tried, good = [], []
    for be in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        for vname, kk, vv, kw in variants:
            def call(be=be, kk=kk, vv=vv, kw=kw):
                with sdpa_kernel([be]):
                    return F.scaled_dot_product_attention(qt, kk, vv, attn_mask=am,
                                                          scale=sm, **kw)
            label = f"{be.name.lower()} {vname}"
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    got = call().transpose(1, 2).reshape(B, T, H * hd)
                    torch.cuda.synchronize()
            except Exception as exc:   # a backend that refuses these inputs
                tried.append(f"{label}: refused ({str(exc).splitlines()[0][:60]})")
                continue
            cos, err, mag = _compare(got, ref32)
            if not (cos > 0.999 and err <= 2e-2 * mag):
                tried.append(f"{label}: disagrees (cos {cos:.6f}, max|d| {err:.4g})")
                continue
            ms = cuda_ms(call, 20, cold=True)
            tried.append(f"{label}: {ms:.4f} ms, cos {cos:.6f}")
            good.append((ms, label, call))
            break            # enable_gqa taken: no need to repeat K/V
    if not good:
        return None, None, "; ".join(tried)
    _, label, call = min(good, key=lambda g: g[0])
    return f"F.scaled_dot_product_attention ({label})", call, "; ".join(tried)


def phase_k2(dev):
    import torch

    from attwarp_tpu_torch.kernels import roofline
    from attwarp_tpu_torch.kernels.flash_prefill import flash_prefill, flash_prefill_plain

    sm = 1.0 / 128 ** 0.5
    out = {}
    # the pipeline's B=4 prefill at T=640, the serving engines' admission
    # groups (at most 8) at T=704, the dataset driver's B=8 extraction
    # prefill at T=640, and a ragged T
    for name, (B, T, H, kvH), timed in (("llava7b", (4, 640, 32, 32), True),
                                        ("qwen7b", (4, 640, 28, 4), True),
                                        ("llava7b_serve", (8, 704, 32, 32), True),
                                        ("qwen7b_serve", (8, 704, 28, 4), True),
                                        ("llava7b_dataset", (8, 640, 32, 32), True),
                                        ("ragged", (3, 200, 28, 4), False)):
        q, k, v, mask = _k2_case(dev, B, T, H, kvH, seed=8)
        got = flash_prefill(q, k, v, mask, sm)
        ref = flash_prefill_plain(q, k, v, mask, sm)
        ref32 = flash_prefill_plain(q.float(), k.float(), v.float(), mask, sm)
        torch.cuda.synchronize()
        cos, err, mag = _compare(got, ref)
        cos32, err32, _ = _compare(got, ref32)
        tol = 2e-2 * mag
        line = (f"[5 K2 flash_prefill] {name} B={B} T={T} H={H} kvH={kvH} hd=128 bf16: "
                f"vs plain cos {cos:.6f} max|d| {err:.4g} (tol {tol:.4g} = 2% of "
                f"max|ref| {mag:.4g}); vs f32 plain cos {cos32:.6f} max|d| {err32:.4g}")
        if timed:
            lib_name, library, tried = _sdpa_yardstick(q, k, v, mask, sm, ref32)
            fns = {"plain": lambda: flash_prefill_plain(q, k, v, mask, sm),
                   "kernel": lambda: flash_prefill(q, k, v, mask, sm)}
            if library is not None:
                fns["library"] = library
            t = alternate_ms(fns, 50, cold=True)
            warm = cuda_ms(fns["kernel"], 50)
            pads = (~mask).sum(dim=1).tolist()
            out[name] = e = with_bound(
                {"max_abs_err": err, "ms": t["kernel"], "warm_ms": warm, "plain_ms": t["plain"],
                 "library_ms": t.get("library"), "library": lib_name,
                 "library_note": tried},
                roofline.k2_work(B, T, H, kvH, pads))
            line += (f" | kernel {t['kernel']:.4f} ms (L2 warm {warm:.4f}), plain "
                     f"{t['plain']:.4f} ms" + _bound_text(e) + f" [{tried}]")
        print(line)
        check(bool(torch.isfinite(got).all()) and cos > 0.999 and cos32 > 0.999
              and err <= tol and err32 <= 2e-2 * ref32.abs().max().item(),
              f"K2 disagrees with its plain version ({name})")
        del q, k, v, mask, got, ref, ref32
    _flush_buf.clear()
    torch.cuda.empty_cache()
    return out


IMAGES_SEED = 0
QUESTIONS = ["what is the text on the label?", "what is shown here?",
             "read the code on the tag", "what is the key phrase in the image?"]


def _images():
    import numpy as np

    rng = np.random.default_rng(IMAGES_SEED)
    return [(rng.random((480, 640, 3)) * 255).astype(np.uint8) for _ in range(4)]


def _drive(tag, backend, n_side, counters, want):
    """One warm-up run of the pipeline, then one timed run with every
    kernel's launch count set to 0 just before it and read just after;
    checks the counts, the outputs, and the masks and warps against the
    port's CPU path. Returns the counts."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.extract.resize import resize_scale_device
    from attwarp_tpu_torch.pipeline import AttWarpPipeline
    from attwarp_tpu_torch.warp.blend import mota_mask
    from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

    pipe = AttWarpPipeline(backend, warp_size=500, max_new_tokens=20)
    images = _images()
    t0 = time.perf_counter()
    pipe.run(images, QUESTIONS)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up run {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    backend.seconds.clear()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = pipe.run(images, QUESTIONS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    p1, p2 = backend.seconds["pass1"], backend.seconds["pass2"]
    print(f"[{tag}] maps {res.attention_maps.shape} warped {res.warped.shape} "
          f"masks {res.mota_masks[0].shape} {res.mota_masks[0].dtype}")
    print(f"[{tag}] first answers {res.first_answers}")
    print(f"[{tag}] second answers {res.second_answers}")
    print(f"[{tag}] launches: " + ", ".join(
        f"{name} {launches[name]} (expected {want[name]})" for name in counters))
    print(f"[{tag}] wall: total {total:.3f} s | pass 1 {p1:.3f} s | mask+warp "
          f"and resizes {total - p1 - p2:.3f} s | pass 2 {p2:.3f} s | "
          f"{4 / total:.3f} samples/s | peak memory {peak / 2**30:.2f} GiB")

    check(res.attention_maps.shape == (4, n_side, n_side), "maps shape")
    check(res.warped.shape == (4, 500, 500, 3), "warped shape")
    check(bool(np.isfinite(res.attention_maps).all()), "maps not finite")
    check(bool(np.isfinite(res.warped).all()), "warped not finite")
    check(np.allclose(res.attention_maps.sum(axis=(1, 2)), 1.0, atol=1e-3),
          "maps do not sum to 1")
    check(all(m.shape == (512, 640) and m.dtype == np.uint8 for m in res.mota_masks),
          "mask shapes")
    check(len(res.first_answers) == 4 and len(res.second_answers) == 4, "answers")
    for name in counters:
        check(launches[name] == want[name], f"{name} launch count")

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
    print(f"[{tag}] vs CPU path: masks max|d| {mask_d} LSB (tol 1), warped "
          f"max|d| {warp_d:.4g} (tol {1e-3 * 255:.3g})")
    check(mask_d <= 1, "masks disagree with the CPU path")
    check(warp_d <= 1e-3 * 255, "warped images disagree with the CPU path")
    return launches


def _counters():
    from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8
    from attwarp_tpu_torch.kernels.flash_prefill import flash_prefill
    from attwarp_tpu_torch.kernels.warp_resample import warp_resample

    return {"warp_resample": warp_resample, "flash_prefill": flash_prefill,
            "decode_attn_int8": decode_attn_int8}


def phase_slice(dev):
    import torch

    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.models.llama import LlamaConfig
    from attwarp_tpu_torch.models.llava import LlavaConfig, LlavaModel, random_params

    # llava-hf/llava-1.5-7b-hf geometry: CLIP-L/14-336, 32-layer 4096-wide
    # LLaMA, vocab 32064 with the image token at 32000
    cfg = LlavaConfig(text=LlamaConfig(vocab_size=32064), image_token_index=32000)
    t0 = time.perf_counter()
    params = random_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                           torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[6 llava] random bf16 LLaVA-1.5-7B: {n_params / 1e9:.3f} B parameters "
          f"in {time.perf_counter() - t0:.1f} s")
    backend = TimedBackend(LlavaBackend(LlavaModel(cfg, params),
                                        tokenizer=DryRunTokenizer(),
                                        extract_layer=20, kv_quant=True))
    L, steps = cfg.text.num_hidden_layers, 20
    want = {"warp_resample": 1,                          # one shape group
            "flash_prefill": 0,                          # dense prefill here
            # pass 1 reads the extract layer without K3
            "decode_attn_int8": steps * (L - 1) + steps * L}
    return _drive("6 llava", backend, 24, _counters(), want), backend.backend


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


def _qwen_flash_vs_dense(model, backend, images):
    """Flash against dense prefill of the slice's first batch (the
    pipeline's device-resized pixels), extract layer included.

    Held on an f32 copy of the text weights, where the dense path is exact
    and the gap is K2's own bf16 rounding: last-position logits within 1e-2
    of their range, the extract row within 1e-4. On the bf16 weights the
    pipeline runs, both paths round q.k to bf16 (dense in the score, flash
    in its inputs), so the dense path itself sits above that bar from the
    f32 dense; there flash may be at most 1.5x as far from the f32 dense as
    the bf16 dense is, for the logits and the row alike."""
    import torch

    from attwarp_tpu_torch.extract.resize import resize_images_batch
    from attwarp_tpu_torch.models.qwen2vl import (
        embed_and_splice,
        get_mrope_positions,
        mrope_cos_sin,
        qwen2vl_prefill,
        qwen2vl_vision_features,
    )

    cfg, dev = model.cfg, model.device
    pix = resize_images_batch(images, backend.image_size, dev)
    ids, mask, patches, grid = backend._prepare(pix, QUESTIONS)
    T = ids.shape[1]
    feats = qwen2vl_vision_features(model.params["vision"], cfg.vision, patches, grid[1:])
    embeds = embed_and_splice(model.params, cfg, ids, feats)
    pos, _ = get_mrope_positions(ids.cpu().numpy(), mask.cpu().numpy(), grid,
                                 cfg.image_token_id, cfg.vision.spatial_merge_size)
    cos, sin = mrope_cos_sin(torch.as_tensor(pos, device=dev), cfg.text)

    def prefill(text, x, flash):
        logits, _, row = qwen2vl_prefill(text, cfg.text, x, mask, cos, sin, max_seq=T,
                                         extract_layer=backend.extract_layer,
                                         use_flash=flash)
        return logits.float(), row.float()

    def gap(a, b):
        return (((a[0] - b[0]).abs().max() / b[0].abs().max()).item(),
                (a[1] - b[1]).abs().max().item())

    out = {"bf16": {f: prefill(model.params["text"], embeds, f) for f in (False, True)}}
    text32 = _to_f32(model.params["text"])
    out["f32"] = {f: prefill(text32, embeds.float(), f) for f in (False, True)}
    del text32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rel, row_d = gap(out["f32"][True], out["f32"][False])
    bf_rel, bf_row = gap(out["bf16"][True], out["bf16"][False])
    d_rel, d_row = gap(out["bf16"][False], out["f32"][False])
    f_rel, f_row = gap(out["bf16"][True], out["f32"][False])
    print(f"[7 qwen] flash vs dense prefill, B=4 T={T}, f32 text weights: last logits "
          f"max|d|/max|ref| {rel:.4g} (tol 1e-2); extract row max|d| {row_d:.4g} "
          f"(tol 1e-4)")
    print(f"[7 qwen] bf16 weights: flash vs dense {bf_rel:.4g} / {bf_row:.4g}; "
          f"against the f32 dense: dense {d_rel:.4g} / {d_row:.4g}, flash "
          f"{f_rel:.4g} / {f_row:.4g} (tol 1.5x dense: {1.5 * d_rel:.4g} / "
          f"{1.5 * d_row:.4g}) (logits rel / row max|d|)")
    check(all(bool(torch.isfinite(o[0]).all()) for w in out.values() for o in w.values()),
          "prefill logits not finite")
    check(rel <= 1e-2, "flash logits disagree with dense")
    check(row_d <= 1e-4, "flash extract row disagrees with dense")
    check(f_rel <= 1.5 * d_rel, "bf16 flash logits drift further from f32 than dense")
    check(f_row <= 1.5 * d_row, "bf16 flash extract row drifts further from f32 than dense")
    return T


def phase_qwen(dev):
    import torch

    from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.models.llama import flash_prefill_supported
    from attwarp_tpu_torch.models.qwen2vl import Qwen2VLConfig, Qwen2VLModel, random_params

    # Qwen/Qwen2-VL-7B-Instruct geometry (the config defaults): 32-block
    # 1280-wide vision tower with 2x2 merge; 28-layer 3584-wide decoder,
    # 28 query over 4 kv heads, vocab 152064
    cfg = Qwen2VLConfig()
    t0 = time.perf_counter()
    params = random_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                           torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[7 qwen] random bf16 Qwen2-VL-7B: {n_params / 1e9:.3f} B parameters "
          f"in {time.perf_counter() - t0:.1f} s")
    model = Qwen2VLModel(cfg, params)
    inner = Qwen2VLBackend(model, tokenizer=DryRunTokenizer(), extract_layer=20,
                           image_size=672, kv_quant=True, use_flash=True)
    T = _qwen_flash_vs_dense(model, inner, _images())
    check(flash_prefill_supported(T), f"T={T} takes the dense prefill")
    L, steps = cfg.text.num_hidden_layers, 20
    want = {"warp_resample": 1,                               # one shape group
            "flash_prefill": 2 * L,                           # both prefills
            # pass 1 reads the extract layer without K3
            "decode_attn_int8": steps * (L - 1) + steps * L}
    return _drive("7 qwen", TimedBackend(inner), inner.num_patches_side,
                  _counters(), want), inner


FILLER = " describe every word on the sign in order."


def _serve_requests(backend, n, seed, long_every=2, max_new=(8, 32)):
    """``n`` requests over the 4 smoke images (pixels by the backend's own
    ``_preprocess``): every ``long_every``-th question is padded with filler
    into the next 64-token bucket; ``max_new_tokens`` drawn from
    ``max_new`` (inclusive) by a seeded generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pixels = [backend._preprocess(im) for im in _images()]
    reqs = []
    for i in range(n):
        q = QUESTIONS[i % 4] + (FILLER * 9 if i % long_every == long_every - 1 else "")
        reqs.append({"input_ids": np.asarray(backend.build_ids(q), np.int64),
                     "pixel_values": pixels[i % 4],
                     "max_new_tokens": int(rng.integers(max_new[0], max_new[1] + 1)),
                     "temperature": 0.0})
    return reqs


def _serve_run(tag, backend, requests, slots, steps_per_tick=8, chunked_prefill=0):
    """One serve run of ``requests`` (all submitted at once) with every
    kernel's launch count set to 0 just before it and read just after.
    Prints tokens/s, TTFT p50/p95, admission waves, peak memory and wall;
    checks the outputs and that K3 = layers x decode steps and K2 = layers x
    admission prefills (0 without ``+flash`` or in the chunked engine).
    Returns (launch counts, the outputs)."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.cli.serve import serve

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, outs = serve(backend, requests, slots=slots, max_seq=768,
                      steps_per_tick=steps_per_tick, chunked_prefill=chunked_prefill)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(o) for o in outs)
    ttft = [st["first_token"] - st["submit"] for st in eng.request_stats.values()]
    p50, p95 = np.percentile(ttft, [50, 95])
    L = eng.tcfg.num_hidden_layers
    flash = bool(backend.use_flash) and not chunked_prefill
    want = {"warp_resample": 0, "decode_attn_int8": L * eng.decode_steps,
            "flash_prefill": L * eng.prefill_groups if flash else 0}
    buckets = sorted({-(-len(r["input_ids"]) // 64) * 64 for r in requests})
    admit_s = sum(end - start for start, end, _ in eng.admit_log)
    used = sum(sum(took.values()) for _, took in eng.tick_log)
    print(f"[{tag}] {len(requests)} requests (buckets {buckets}), {n_tok} tokens: "
          f"{n_tok / wall:.1f} tok/s | TTFT p50 {p50 * 1e3:.1f} ms, p95 "
          f"{p95 * 1e3:.1f} ms | {len(eng.admit_log)} admission waves "
          f"({eng.prefill_groups} prefill groups, {eng.decode_steps} decode steps) | "
          f"peak memory {peak / 2**30:.2f} GiB | wall {wall:.3f} s | launches: " + ", ".join(
              f"{name} {launches[name]} (expected {want[name]})" for name in counters))
    print(f"[{tag}] host clock: admission {admit_s:.3f} s, ticks {wall - admit_s:.3f} s "
          f"({(wall - admit_s) / max(eng.decode_steps, 1) * 1e3:.1f} ms per decode step); "
          f"slot occupancy {used / max(eng.decode_steps * eng.slots, 1):.3f} "
          f"(tokens kept / slot-steps run)")
    vocab = eng.tcfg.vocab_size
    check(all(1 <= len(o) <= r["max_new_tokens"] and all(0 <= t < vocab for t in o)
              for o, r in zip(outs, requests)), f"{tag}: outputs")
    check(eng.decode_steps > 0 and want["decode_attn_int8"] > 0, f"{tag}: no decode step")
    for name in counters:
        check(launches[name] == want[name], f"{tag}: {name} launch count")
    return launches, outs


def _time_tick(tag, backend, requests, slots, steps_per_tick=8):
    """A steady serve tick: fill every slot, run two ticks (the first
    activates the slots), and time the next on the host clock (it ends in
    a synchronize)."""
    import torch

    from attwarp_tpu_torch.serving import ServeEngine

    eng = ServeEngine(backend.model, slots=slots, max_seq=768, kv_quant=backend.kv_quant,
                      steps_per_tick=steps_per_tick, use_flash=backend.use_flash)
    for r in requests[:slots]:
        eng.submit(r["input_ids"], r["pixel_values"], max_new_tokens=4 * steps_per_tick)
    eng._admit()
    eng._tick()                                   # activates the slots
    eng._tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._tick()
    torch.cuda.synchronize()
    tick = time.perf_counter() - t0
    print(f"[{tag}] one tick ({steps_per_tick} steps, {slots} slots decoding): host clock "
          f"{tick * 1e3:.1f} ms ({tick / steps_per_tick * 1e3:.1f} ms per step)")


def _agreement(tag, model, requests, outs, k):
    """Greedy tokens of the first ``k`` served requests against per-request
    ``generate_with_attention`` (same cache and prefill, left-padded to the
    same bucket). Reported, not gated: on bf16 weights a near-tie can tip
    with the batch's GEMM shapes."""
    same = sum(o == _generate_one(model, r, True, True)
               for o, r in zip(outs[:k], requests[:k]))
    print(f"[{tag}] agreement with per-request generate (bf16 weights, reported "
          f"only): {same}/{k} requests token-identical")


def _generate_one(model, req, kv_quant, use_flash):
    """Per-request greedy generate of one serve request (answer-only,
    left-padded to its 64-token bucket), cut after EOS as the engine stops."""
    import numpy as np
    import torch

    ids = req["input_ids"]
    Tb = -(-len(ids) // 64) * 64
    pad = Tb - len(ids)
    dev = model.device
    ids_p = torch.zeros((1, Tb), dtype=torch.int64, device=dev)
    ids_p[0, pad:] = torch.as_tensor(ids, device=dev)
    mask = torch.arange(Tb, device=dev)[None] >= pad
    pix = torch.as_tensor(req["pixel_values"][None], device=dev)
    if hasattr(model.cfg, "vision_start_token_id"):
        from attwarp_tpu_torch.models.qwen2vl import patchify_batch

        patches, grid = patchify_batch(pix, model.cfg.vision)
        gen, _ = model.generate_with_attention(
            ids_p, patches, grid, mask, extract_layer=None,
            max_new_tokens=req["max_new_tokens"], kv_quant=kv_quant, use_flash=use_flash)
    else:
        img_start = torch.as_tensor([pad + int(np.argmax(ids == model.cfg.image_token_index))],
                                    device=dev)
        gen, _ = model.generate_with_attention(
            ids_p, pix, mask, img_start, extract_layer=None,
            max_new_tokens=req["max_new_tokens"], kv_quant=kv_quant, use_flash=use_flash)
    row = gen[0].tolist()
    eos = model.cfg.eos_token_id
    return row[: row.index(eos) + 1] if eos in row else row


def phase_llava_serve(backend):
    """LLaVA-1.5-7B serving on the slice's bf16 weights: ``+kv8+flash``
    ServeEngine, the chunked engine ``+kv8``, then one steady
    ``+kv8+flash`` tick."""
    backend.kv_quant, backend.use_flash = True, True
    reqs = _serve_requests(backend, 32, seed=1)
    serve, outs = _serve_run("8 llava serve", backend, reqs, slots=16)
    _agreement("8 llava serve", backend.model, reqs, outs, 4)
    backend.use_flash = False
    chunked, _ = _serve_run("8 llava chunked", backend,
                            _serve_requests(backend, 16, seed=2), slots=16,
                            chunked_prefill=128)
    backend.use_flash = True
    _time_tick("8 llava serve", backend, reqs, slots=16)
    return serve, chunked


def phase_qwen_serve(backend):
    """Qwen2-VL-7B ``+kv8+flash`` serving at 672 px on the slice's weights."""
    reqs = _serve_requests(backend, 16, seed=3)
    launches, outs = _serve_run("8 qwen serve", backend, reqs, slots=8)
    _agreement("8 qwen serve", backend.model, reqs, outs, 2)
    return launches


def phase_serve_parity(dev):
    """f32 serving parity at LLaVA-1.5-7B width, 2 vision and 2 decoder
    layers (see the module docstring, step 9)."""
    import torch

    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
    from attwarp_tpu_torch.models.llama import LlamaConfig
    from attwarp_tpu_torch.models.llava import LlavaConfig, LlavaModel, random_params

    cfg = LlavaConfig(vision=ClipVisionConfig(num_hidden_layers=2),
                      text=LlamaConfig(vocab_size=32064, num_hidden_layers=2),
                      image_token_index=32000)
    params = random_params(cfg, torch.Generator(device=dev).manual_seed(5), dev,
                           torch.float32)
    backend = LlavaBackend(LlavaModel(cfg, params), tokenizer=DryRunTokenizer(),
                           extract_layer=0)
    _serve_parity(backend)
    del params, backend
    torch.cuda.empty_cache()


def _serve_parity(backend):
    """The token bars of step 9 on ``backend``'s (f32) weights."""
    from attwarp_tpu_torch.cli.serve import serve

    model = backend.model
    reqs = _serve_requests(backend, 6, seed=4, max_new=(8, 8))
    kw = dict(slots=4, max_seq=768, steps_per_tick=4)
    for kv in (False, True):
        backend.kv_quant, backend.use_flash = kv, True
        eng, outs = serve(backend, reqs, **kw)
        refs = [_generate_one(model, r, kv, True) for r in reqs]
        same = sum(o == r for o, r in zip(outs, refs))
        print(f"[9 serve parity] f32, {'kv8' if kv else 'dense'}+flash: {same}/{len(reqs)} "
              f"requests token-identical to per-request generate "
              f"({eng.prefill_groups} prefill groups, {eng.decode_steps} decode steps)")
        check(same == len(reqs), "serving tokens differ from per-request generate")
    backend.kv_quant = backend.use_flash = False
    _, base = serve(backend, reqs, **kw)
    _, chunked = serve(backend, reqs, chunked_prefill=128, **kw)
    same = sum(a == b for a, b in zip(base, chunked))
    print(f"[9 serve parity] f32 dense, no flash: chunked engine (P=128) "
          f"{same}/{len(reqs)} requests token-identical to ServeEngine")
    check(same == len(reqs), "chunked engine tokens differ from ServeEngine")


def _scratch(name):
    """A fresh directory under the checkout's (gitignored) build/."""
    import shutil
    from pathlib import Path

    d = Path(__file__).resolve().parent / "build" / "chip_smoke" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _result_json(out_dir):
    import glob
    import os

    paths = [p for p in glob.glob(os.path.join(out_dir, "textvqa_accuracy_*.json"))]
    check(len(paths) == 1, f"one final result JSON in {out_dir}")
    with open(paths[0]) as f:
        return json.load(f)


def _check_tree(out, n, n_side):
    """The driver's nine directories and each sample's files, as JAX names
    them; no sample took a fallback (every warp written, no uniform map).
    Returns the metadata, in dataset order."""
    import os

    import numpy as np

    from attwarp_tpu_torch.cli.process_dataset import ARTIFACT_DIRS
    from attwarp_tpu_torch.data.imageio import read_rgb

    check(sorted(os.listdir(out)) == sorted(ARTIFACT_DIRS), "the nine artifact directories")
    metas = []
    for name in os.listdir(out / "metadata"):
        with open(out / "metadata" / name) as f:
            metas.append(json.load(f))
    metas.sort(key=lambda m: m["original_index"])
    check(len(metas) == n, f"{n} metadata files")
    names = {"original_image": ("original_images", "_original.png"),
             "masked_image": ("masked_images", "_masked.png"),
             "attention_map_image_from_api": ("attention_maps_images", "_attn_map_img.png"),
             "raw_attention_map_npy": ("raw_attention_maps", "_raw_attn.npy"),
             "mota_mask_visualization": ("attention_maps", "_mota_mask_vis.png"),
             "mota_mask_npy": ("attention_maps", "_mota_mask.npy"),
             "warped_image_identity": ("warped_images", "_identity.png")}
    uniform = 0
    for m in metas:
        sid = m["sample_id"]
        for key, (d, suffix) in names.items():
            path = m["saved_paths"].get(key)
            check(path == str(out / d / f"{sid}{suffix}") and os.path.exists(path),
                  f"{sid}: {key}")
        raw = np.load(m["saved_paths"]["raw_attention_map_npy"])
        check(raw.shape == (1, 1, n_side, n_side) and bool(np.isfinite(raw).all()),
              f"{sid}: raw map")
        uniform += bool(np.allclose(raw, 1.0 / n_side**2, rtol=0, atol=1e-9))
        check(read_rgb(m["saved_paths"]["warped_image_identity"]).shape == (500, 500, 3),
              f"{sid}: warped shape")
    check(uniform == 0, f"{uniform} samples got the uniform fallback map")
    return metas


def phase_llava_dataset(backend):
    """LLaVA-1.5-7B ``+kv8+flash`` over 16 code-tag scenes (512 px, seed 0):
    the dataset driver (batches of 8, 20 new tokens), then the harness on
    the warped and the original images through the serving engine (8
    slots, 16 new tokens). Checks the artifacts, that no fallback fired,
    and K1 = 16, K2 = 32 x (2 extraction prefills + the engine's admission
    groups), K3 = 2 x 20 x 31 + 32 x the engine's decode steps."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.cli.process_dataset import process_dataset
    from attwarp_tpu_torch.data.imageio import read_rgb
    from attwarp_tpu_torch.eval.harness import EngineAnswerBackend, evaluate_textvqa_accuracy
    from attwarp_tpu_torch.extract.resize import resize_images_batch
    from attwarp_tpu_torch.testing.reader import write_textvqa_dataset

    root = _scratch("llava_dataset")
    json_path, image_dir = write_textvqa_dataset(str(root / "data"), n=16, seed=0)
    backend.kv_quant = backend.use_flash = True
    timed = TimedBackend(backend)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = process_dataset(json_path, image_dir, str(root / "out"), timed,
                            batch_size=8, max_new_tokens=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    extract_s = timed.seconds["pass1"]
    driver = {name: fn.launches for name, fn in counters.items()}
    answerer = EngineAnswerBackend(backend, slots=8, max_new_tokens=16)
    t0 = time.perf_counter()
    res = evaluate_textvqa_accuracy(str(root / "out" / "metadata"), str(root / "eval"),
                                    answerer, model_name="llava-1.5-7b random bf16 +kv8+flash",
                                    max_new_tokens=16, score_original=True, batch_size=16)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    eng = answerer.engine
    L = backend.model.cfg.text.num_hidden_layers
    alive = eng is not None and not answerer._engine_dead
    want = {"warp_resample": 16,
            "flash_prefill": L * (2 + (eng.prefill_groups if alive else 0)),
            "decode_attn_int8": 2 * 20 * (L - 1) + L * (eng.decode_steps if alive else 0)}
    print(f"[10 llava dataset] driver: {stats['processed']} processed, {stats['failed']} "
          f"failed, wall {wall:.3f} s ({16 / wall:.3f} samples/s; extraction {extract_s:.3f} s"
          f" = {extract_s / wall:.1%}) | launches K1 {driver['warp_resample']}, K2 "
          f"{driver['flash_prefill']}, K3 {driver['decode_attn_int8']}")
    print(f"[10 llava dataset] harness: {res['total_samples_evaluated']} evaluated (warped and "
          f"original), wall {eval_wall:.3f} s | engine alive {alive}, "
          f"{eng.slots if alive else 0} slots, {eng.prefill_groups if alive else 0} prefill "
          f"groups, {eng.decode_steps if alive else 0} decode steps | accuracy warped "
          f"{res['overall_warped_accuracy']:.4f}, original "
          f"{res.get('overall_original_accuracy', float('nan')):.4f} (random weights) | peak "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"[10 llava dataset] launches: " + ", ".join(
        f"{name} {launches[name]} (expected {want[name]})" for name in counters))
    check(stats == {"processed": 16, "failed": 0}, "16 processed, 0 failed")
    metas = _check_tree(root / "out", 16, backend.num_patches_side)
    check(res["total_samples_evaluated"] == 16 and len(res["detailed_results"]) == 16
          and all("original_answer" in r for r in res["detailed_results"]),
          "the harness evaluated every sample, warped and original")
    check(alive, "the serving engine was retired")
    for name in counters:
        check(launches[name] == want[name], f"llava dataset: {name} launch count")

    # the first chunk's maps against a direct extract of the same batch
    first = metas[:8]
    pix = resize_images_batch([read_rgb(m["saved_paths"]["original_image"]) for m in first],
                              backend.image_size, backend.device)
    maps, _ = backend.extract(pix, [m["question"] for m in first], max_new_tokens=20)
    raw = np.stack([np.load(m["saved_paths"]["raw_attention_map_npy"])[0, 0] for m in first])
    d = float(np.abs(maps.cpu().numpy() - raw).max())
    print(f"[10 llava dataset] first chunk's maps vs a direct extract: max|d| {d:.3g} "
          f"(tol 1e-6)")
    check(d <= 1e-6, "the driver's maps differ from a direct extract")
    return launches


# the JAX chain's gain on the same 50 JPEG scenes (seed 0, reader, batches of
# 8: attwarp_tpu.cli.process_dataset then attwarp_tpu.cli.evaluate, on the
# CPU): warped 0.86, original 0.00
JAX_CODETAG_GAIN = 0.86


def phase_codetag():
    """The code-tag accuracy chain through both CLIs' ``main`` on the card:
    50 scenes (seed 0), the reader backend, batches of 8; checks K1 = 50,
    50 evaluated, original accuracy <= 0.02 and a gain within one sample of
    ``JAX_CODETAG_GAIN``."""
    import torch

    from attwarp_tpu_torch.cli import evaluate, process_dataset
    from attwarp_tpu_torch.testing.reader import write_textvqa_dataset

    root = _scratch("codetag")
    t0 = time.perf_counter()
    json_path, image_dir = write_textvqa_dataset(str(root / "data"), n=50, seed=0)
    write_s = time.perf_counter() - t0
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc = process_dataset.main(["--textvqa-json", json_path, "--image-dir", image_dir,
                               "--output-dir", str(root / "out"), "--backend", "reader",
                               "--device", "cuda", "--batch-size", "8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc_eval = evaluate.main(["--metadata-dir", str(root / "out" / "metadata"),
                             "--output-dir", str(root / "eval"), "--model", "reader",
                             "--device", "cuda", "--score-original", "--batch-size", "8"])
    eval_wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    res = _result_json(root / "eval")
    print(f"[11 codetag] 50 scenes written in {write_s:.3f} s | driver wall {wall:.3f} s "
          f"({50 / wall:.3f} samples/s) | harness wall {eval_wall:.3f} s | accuracy warped "
          f"{res['overall_warped_accuracy']:.4f}, original "
          f"{res['overall_original_accuracy']:.4f}, gain {res['accuracy_gain']:+.4f} "
          f"(bars: original <= 0.02, gain {JAX_CODETAG_GAIN:+.2f} +- 0.02) | launches K1 "
          f"{launches['warp_resample']} "
          f"(expected 50), K2 {launches['flash_prefill']}, K3 {launches['decode_attn_int8']}")
    check(rc == 0 and rc_eval == 0, "a CLI exited non-zero")
    _check_tree(root / "out", 50, 32)
    check(launches == {"warp_resample": 50, "flash_prefill": 0, "decode_attn_int8": 0},
          "codetag launch counts")
    check(res["total_samples_evaluated"] == 50, "50 evaluated")
    check(res["overall_original_accuracy"] <= 0.02, "original accuracy above 0.02")
    check(abs(res["accuracy_gain"] - JAX_CODETAG_GAIN) <= 1 / 50 + 1e-9,
          f"accuracy gain more than one sample from the JAX chain's {JAX_CODETAG_GAIN}")
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


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit (e.g. the parent, unpacked with git "
                         "archive): its K1 is timed against this one's, in turns")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t_all = time.perf_counter()
    name = _phase("1 device", phase_device)
    _phase("2 build", phase_build)
    k1 = _phase("3 K1", phase_k1, dev)
    if args.parent:
        _phase("3 K1 vs parent", phase_k1_parent, k1, args.parent)
    k3 = _phase("4 K3", phase_k3, dev)
    k2 = _phase("5 K2", phase_k2, dev)
    paths = {}
    paths["llava"], backend = _phase("6 llava", phase_slice, dev)
    paths["llava_serve"], paths["llava_chunked"] = _phase(
        "8 llava serve", phase_llava_serve, backend)
    paths["llava_dataset"] = _phase("10 llava dataset", phase_llava_dataset, backend)
    paths["codetag"] = _phase("11 codetag", phase_codetag)
    del backend
    gc.collect()                 # free the LLaVA weights before Qwen's
    torch.cuda.empty_cache()
    paths["qwen"], backend = _phase("7 qwen", phase_qwen, dev)
    paths["qwen_serve"] = _phase("8 qwen serve", phase_qwen_serve, backend)
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    _phase("9 serve parity", phase_serve_parity, dev)
    print(f"[all] wall {time.perf_counter() - t_all:.2f} s")

    def launches(name):
        return {"launches": sum(p[name] for p in paths.values()),
                "launches_by_path": {k: p[name] for k, p in paths.items()}}

    kernels = [
        {"name": "warp_resample", "route": "cuda",
         "source": "attwarp_tpu_torch/csrc/warp_resample.cu",
         "replaces": "attwarp_tpu/ops/pallas_warp.py:87",
         **launches("warp_resample"), **k1["pipeline"],
         **{k: k1[k] for k in ("dataset_driver", "dataset_driver_683w", "warp_only")}},
        {"name": "flash_prefill", "route": "cuda",
         "source": "attwarp_tpu_torch/csrc/flash_prefill.cu",
         "replaces": "attwarp_tpu/models/llama.py:218",
         **launches("flash_prefill"), **k2["qwen7b"],
         **{k: k2[k] for k in ("llava7b", "llava7b_serve", "qwen7b_serve",
                               "llava7b_dataset")}},
        {"name": "decode_attn_int8", "route": "cuda",
         "source": "attwarp_tpu_torch/csrc/decode_attn_int8.cu",
         "replaces": "attwarp_tpu/ops/pallas_decode_attn.py:284",
         **launches("decode_attn_int8"), **k3["llava7b"],
         **{k: k3[k] for k in ("qwen7b", "llava7b_serve", "qwen7b_serve",
                               "llava7b_dataset", "llava7b_dataset_serve")}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
