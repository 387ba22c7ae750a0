#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``attwarp_tpu_torch``) on one
NVIDIA GPU.

1. Names the card (and its power limit, from nvidia-smi); turns TF32 off;
   in a child process, reports whether Pillow, OpenCV, transformers,
   tokenizers and matplotlib import, and loads a saved dry-run tokenizer
   with transformers made unimportable.
2. Builds the port's CUDA kernels from this checkout with nvcc (one nvcc
   per source, all at once).
3. Kernel K1 (warp resample) against its plain PyTorch version at the
   pipeline's shape, (4, 512, 640, 3) -> 500x500, at the dataset driver's,
   one 512x512 scene and one 683x1024 photo per launch, at the
   warp-only shape, (128, 336, 336, 3) -> 336x336, and at step 12's, a
   ``predict_and_warp`` chunk (10, 512, 512, 3) -> 500x500 and a training
   debug round (128, 512, 512, 3) -> 512x512; then warps/s of the
   warp-only path (grid maps + K1) at 336 px.
4. Kernel K3 (int8-cache decode attention) against its plain version at
   LLaVA-1.5-7B and Qwen2-VL-7B decode geometry (B=4, S=704; 32/32 and
   28/4 heads), at their serving geometry (B=16 and B=8 slots, S=768)
   with per-slot [start, cur] windows, a retired slot's [0, 0] and a free
   slot's [0, j], at step 10's LLaVA-1.5-7B geometry (the driver's B=8
   extraction decode and the harness's 8-slot engine, both S=704), at a
   tensor-parallel rank's heads (n_model=2: 16/16 and 14/2, B=4, S=704;
   step 15), plus a small GQA case.
5. Kernel K2 (flash prefill) against its plain version at LLaVA-1.5-7B and
   Qwen2-VL-7B prefill geometry (B=4, T=640; 32/32 and 28/4 heads), at
   their admission geometry (groups of 8 at T=704), at the dataset
   driver's LLaVA-1.5-7B extraction prefill (B=8, T=640), at a
   tensor-parallel rank's heads (n_model=2: 16/16 and 14/2, B=4, T=640;
   step 15), all with per-row left padding, plus a ragged T=200.
5b. Kernel K4 (the towers' scaled row softmax, in place) against its plain
   version at one Qwen2-VL-7B image's (16, 2304, 2304) logits and a batch
   of 8 CLIP ViT-L/14-336 (577 tokens) and SigLIP-so400m (729) images:
   within one bf16 ulp, rows summing to 1. Steps 6, 7, 13b and 13c count
   its launches: one a tower block (and image, in Qwen2-VL) a pass.
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
    CPU run). Steps 10-12 write under ``build/chip_smoke/`` in the
    checkout; they read and write image files through Pillow.
12. The learned-warp chain, on step 6's LLaVA-1.5-7B weights still
    loaded. 12a: ``tools/run_marginalnet_chain.py`` at the JAX tool's
    defaults on the card (240 train scenes, 50 eval scenes, 40 epochs of
    batch 16 at 512 px, the reader's frozen features; the learned warp,
    then the oracle driver on the same eval set): original <= 0.02,
    learned gain >= 0.72, oracle gain 0.90 +- 0.02, K1 launches as the
    code predicts, K2 = K3 = 0. 12b: MarginalNet at ``TrainConfig()``'s
    widths (hidden 256, batch 128, 512 px) on LLaVA-1.5-7B features of
    12a's training scenes: 10 ``train_step``s on one batch (the loss must
    fall), then one ``train_loop`` epoch whose train and validation debug
    rounds launch K1. The trainer's metric sink writes locally (wandb is
    made unimportable).

13. The int8 weight forms (``+int8``: the decoder's seven linears w8a8;
    ``+lm8``: the LM head) and HF checkpoint loading. 13a (after 12b): the
    int8 product (``numerics/quant.py::int8_matmul``, ``torch._int_mm``,
    decode rows padded to 24) at every shape the slice runs, LLaVA-1.5-7B
    q/o, gate/up and down at M = 4, 8, 16 and 4 x 640 and its head at M = 4,
    Qwen2-VL-7B k/v (with bias), gate and head at M = 4 and 4 x 640: int32
    sums equal to an f64 product, the output bit-equal to the same
    arithmetic on that product, times (L2 flushed, warm beside) of the
    linear, its GEMM and its activation quantization beside bf16
    ``F.linear`` and the card's least time. 13b: step 6's weights quantized
    in place (``+int8+kv8+flash``; the memory held must fall by the
    quantized bytes within 10%): a warm-up and a timed pipeline run (launch
    counts K1 1, K2 2 x 32, K3 as step 6, the int8 product 7 x 32 per
    prefill and decode step; logits cos > 0.98 against step 6's bf16 first
    pass; peak memory down by at least 90% of the quantized bytes), step
    8's LLaVA serve cell and a steady tick, then ``+lm8`` and one more
    pipeline run (one more product a step; logits cos > 0.999 against the
    dense head's); figures printed beside steps 6 and 8. 13c (after Qwen's
    serve runs): step 7's weights as ``+int8+lm8+kv8+flash``, a warm-up and
    a timed pipeline run with the same checks against step 7. 13d (last,
    in a child process that imports ``transformers``): random HF LLaVA and
    Qwen2-VL at the CPU parity tests' geometry, and LLaVA at 7B width with
    2 vision and 2 decoder layers, written by ``save_pretrained`` under
    ``build/chip_smoke/`` and loaded by ``make_backend("llava:<dir>")`` /
    ``qwen2vl:`` on the card: f32 last-token logits against the HF model's
    own forward there (eager, TF32 off) within atol 2e-4 / rtol 1e-3; the
    ``+int8+kv8+flash`` load in int8 on the card, and at 7B width one
    ``extract`` through K2, K3 and the int8 product.

14. Multi-layer extraction, the layer sweep and the mini test MLLM. 14a
    (on step 6's weights, after 12b): the dataset driver on LLaVA-1.5-7B
    ``+kv8+flash`` extracting layers (20, 4, 8, 12, 16) in one pass over
    step 10's 16 scenes (batches of 8, 20 new tokens): every artifact and
    five per-layer maps a sample, no fallback, K1 16, K2 2 x 32, K3 (32 -
    5) x 20 x 2, layer 20's maps against step 10's (cos > 0.999), samples/s
    beside step 10's. 14b: ``eval.layer_sweep`` over 8 of those scenes at
    ``DEFAULT_LAYERS`` (one B=1 prefill a prompt for all nine layers): K2
    32 x 2 x 8, K3 0, no fallback, scores in [0, 1], the one-pass maps
    equal to a layer at a time (1e-6); K2 is timed at this shape in step
    5. 14d: the mini through ``cli.process_dataset`` and ``cli.evaluate``
    at their default backend on the card (K1 16), and its feature
    extractor against its CPU copy (1e-4). 14c (after Qwen's serve runs):
    Qwen2-VL-7B ``+kv8+flash`` extracting (20, 4, 12) at B=4 (K2 28, K3
    (28 - 3) x 20), then one image's patches shared by 4 questions against
    the image repeated (maps cos > 0.9999, tokens equal), its vision tower
    timed in both forms.

15. The parallel layer (``attwarp_tpu_torch/parallel``, ``serving/
    disagg.py``, the sharded train step) on the one card. References first,
    in this process, on seeded LLaVA-1.5-7B weights: f32 at 2 vision + 2
    decoder layers, then bf16 at full depth (step 6's seed). 15c here: a
    ``DisaggServeEngine`` with both groups on cuda:0 (the prefill model a
    second copy of the weights), LLaVA-1.5-7B ``+kv8+flash``, 8 slots, 16
    requests of 8-32 new tokens: every request's tokens equal
    ``ServeEngine``'s, K2 = 32 x admission groups, K3 = 32 x decode steps,
    one KV block moved per group. The weights freed, two ranks spawned
    (``testing/ranks.py``) share cuda:0 over gloo, whose collectives other
    than all_reduce go through host copies (printed as "host-staged"),
    each building the same seeded weights and keeping its shard. 15a,
    tensor-parallel LLaVA (n_model=2, 16 of 32 heads a rank): f32 2 + 2
    layers, tokens identical to the unsharded model, maps within 1e-5 with
    the dense cache and prefill and within 1.5x the unsharded run's own
    distance from f32 with ``+kv8+flash`` (K2 and K3 round to bf16); bf16
    full depth, maps cos > 0.999 on the samples whose greedy tokens equal
    the unsharded run's (the rest printed), the prefill's maps cos above
    ``P15_ROWS_FLOOR`` (no token can turn there), and the same maps with a
    planted wrong cut (each rank reading the other's kv heads) below it;
    then the two-pass
    pipeline, per rank K1 1, K2 2 x 32, K3 20 x 31 + 20 x 32, its wall and
    peak memory. 15b, ``sp_prefill`` (n=2, ``kv_quant``, B=4 T=640, left
    padding): f32 2 layers, logits and rows within 1e-4 of the dense
    prefill and int8 caches within 1 LSB; bf16 full depth, the ring's wall,
    20 decode steps through K3 (32 x 20 a rank) from its cache, cos
    against the dense prefill printed. 15d: ``make_sharded_warp`` (n_data
    2) at (4,512,640,3) -> 500^2 bit-equal to the unsharded K1 (K1 1 a
    rank); ``make_sharded_train_step`` at ``TrainConfig()`` width, batch
    16, (data, model) = (2, 1) and (1, 2): one bf16 step, loss within
    rtol 2e-2 and parameters within 5e-2 of the one-device step (JAX's
    bars); two f32 steps on two batches, every metric within 1e-5
    relative and each parameter change (both steps; the second alone,
    which reads the AdamW moments) within cos 0.999. 15e: one rank on NCCL
    (world size 1): all_reduce, all_gather and broadcast on CUDA tensors,
    then 15a-15d's code at 2 layers. A failing or hung rank fails the
    step.
16. The ablations and K1's backward. 16a: ``run_cross_attention_warp``
    with ``make_sd_capture_fn`` over the stub pipeline at Stable Diffusion
    2.1's cross-attention geometry (``testing/sd_stub.py``: 16 attn2 layers
    a UNet evaluation, 5 at 96^2 with 5 heads, 5 at 48^2 with 10, 5 at
    24^2 with 20, 1 at 12^2 with 20, batch 2, 77 tokens; random
    projections, no weights) at the JAX defaults (timesteps 999..200, 10
    denoise steps, a 768 px latent image), on a 683x1024 image, top_k 20,
    iterations 1 and 3: K1 1 and 3 and nothing else, iterates finite, in
    range and 500x500x3, iterate 1 of 3 within the warp budget of the
    single pass, the card within 1e-5 (map) and the warp budget
    (iterates) of the port's CPU path on the same captured maps; walls of
    the capture, importance + aggregation, the conditioning and each
    iterate. 16b: K1's backward against autograd of its plain version at
    the pipeline's (4,512,640,3) -> 500^2 with all three gradients, a
    ``predict_and_warp`` chunk's (10,512,512,3) -> 512^2 and 16c's
    (16,512,512,3) -> 512^2 maps only, and a 683x1024 photo -> 500^2 image
    only: image gradient within 1e-5 and map gradients within 1e-4 of the
    reference's largest magnitude, two calls bit-equal, the kernels of a
    call as the kernel library counts them equal to the design's, timed as
    steps 3-5 with ``F.grid_sample``'s backward beside it. 16c: JAX's two ``tests/test_warp_grad.py`` settings at full size
    through ``warp_batch_by_attention`` ((4,512,640,3), 24x24 attention)
    and ``warp_from_cdf`` ((16,512,512,3)) against the plain path on the
    card, within 1e-4, K1 and its backward one launch each.

17. The bench and profile tools (``attwarp_tpu_torch/tools/``), each
    tool's ``run`` on the weights already loaded, repeats and requests cut
    (never widths), every repeat printed with its min, median and spread
    beside the card's name and power limit, launch counts as each run's
    work predicts. 17a (after 14d, on step 6's bf16 LLaVA-1.5-7B,
    ``+kv8+flash`` unless named): ``bench_extract`` at B=4, its maps
    bit-equal to ``extract``'s on the same prompts and pixels;
    ``bench_prefill`` dense (K2 0) and flash (K2 32 a prefill) at B=8
    T=640; ``bench_decode`` ``+kv8`` at B=4, 16 steps (K3 32 x 16 a
    chain); ``bench_pipeline`` and ``profile_pipeline`` at B=4 (K1 1, K2 2
    x 32, K3 as step 6 a run); ``bench_serve`` at 8 slots, 24 requests, 32
    new tokens (K3 = layers x decode steps, K2 = layers x admission
    groups); then, in a child process, one ``bench_pipeline`` repeat
    inside ``utils/profiling.py::device_trace`` under
    ``build/chip_smoke/trace/``, whose ``trace.json`` must hold device
    events of K1's, K2's and K3's kernels (the ten device ops that took
    the most time printed). 17c (then): ``bench_chunked_serve`` ``+kv8``
    (P=128, 16 slots, 16 requests, K2 0), ``tools.bench.main([])`` (its
    JSON line printed, never last) and ``profile_warp_terms`` at their
    defaults. 17b (after 14c, on step 7's Qwen2-VL-7B):
    ``bench_qwen_prefill`` flash at B=8 T=640, ``bench_qwen_decode``
    ``+kv8`` at B=4, ``bench_qwen_serve`` ``+kv8+flash`` at 8 slots, 16
    requests, and ``extract_from_ids`` with one shared image against four
    per-sample copies of it (tokens equal, maps cos > 0.9999). Step 17's
    wall is printed.

The run's order: 1-5, 5b, 6, 8 (LLaVA), 10, 11, 12, 14a, 14b, 14d, 17a, 17c,
13a, 13b, 7, 8 (Qwen), 14c, 17b, 13c, 9, 13d, 15, 16.

Steps 3-5b time each kernel at its main-path shapes with L2 flushed before
every call, as a prefill or a decode step finds its layer's tensors cold in
HBM (the time with L2 warm is reported beside it as ``warm_ms``), beside
its plain version, the least time the card could take
for the same work (``kernels/roofline.py``: bytes over 3.35 TB/s or
operations over the peak rate of their type, whichever is larger) and one
PyTorch call computing the same function where there is one:
``F.grid_sample`` for K1 and its backward for K1's backward (timed with L2
warm too, ``library_warm_ms``) and
``F.scaled_dot_product_attention`` (fastest backend that takes a bool
mask) for K2, each checked to agree with the plain version; none for K3
and K4.

Run from the repo root:  python3 chip_smoke.py
Exits non-zero on any failure and when no CUDA device is present. The last
line of stdout is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches (per path), error and times, and the line
before that the int8 product (a library call, not a kernel of the port)
with its launches per path and step 13a's shapes. Each phase
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
    """Prints which of Pillow, OpenCV, transformers, tokenizers and
    matplotlib (the trainer's plots, which are skipped without it) import,
    then saves the dry-run tokenizer as a checkpoint does and loads it back
    with transformers made unimportable: the port's own reader."""
    import importlib

    found = []
    for m in ("PIL", "cv2", "transformers", "tokenizers", "matplotlib"):
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
             ("warp_only", (128, 336, 336), 336),     # the warp-only headline
             # the learned-warp chain's predict_and_warp (chunks of 10 scenes)
             # and a full-width training debug round (the batch of 128)
             ("chain_predict", (10, 512, 512), 500),
             ("train_debug", (128, 512, 512), 512),
             # a rank's half of the pipeline batch in the data-parallel
             # warp (step 15d)
             ("sharded_warp", (2, 512, 640), 500))
# the shapes whose maps come straight from 24x24 maps (the others go
# through the MOTA mask, as the pipeline and the driver run them); a CDF
# upsampled from MarginalNet's 24 bins inverts to the same kind of map
_FROM_24 = ("warp_only", "chain_predict", "train_debug", "sharded_warp")


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
    straight from 24x24 maps at the others (``_FROM_24``)."""
    import torch

    from attwarp_tpu_torch.warp.blend import mota_mask
    from attwarp_tpu_torch.warp.warp import warp_grid_maps

    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.rand((B, H, W, 3), generator=g, device=dev) * 255.0
    att = torch.rand((B, 24, 24), generator=g, device=dev)
    if name in _FROM_24:
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
    # extraction (B=8) and in the harness's 8-slot engine (S=704); a
    # tensor-parallel rank's heads; step 15's 8-slot disaggregated pool
    # (S=768); plus a small GQA case with n_rep 8
    for name, (L, B, S, H, kvH), seed, timed, windows in (
            ("llava7b", (32, 4, 704, 32, 32), 2, True, None),
            ("qwen7b", (28, 4, 704, 28, 4), 9, True, None),
            ("llava7b_serve", (32, 16, 768, 32, 32), 12, True, _serve_windows(16)),
            ("qwen7b_serve", (28, 8, 768, 28, 4), 13, True, _serve_windows(8)),
            ("llava7b_dataset", (32, 8, 704, 32, 32), 14, True, _EXTRACT_WINDOWS),
            ("llava7b_dataset_serve", (32, 8, 704, 32, 32), 15, True,
             _serve_windows(8, buckets=(640,), depth=24)),
            # a tensor-parallel rank's heads at n_model=2 (step 15), and
            # the 8-slot pool of step 15's disaggregated engine
            ("llava7b_tp2", (32, 4, 704, 16, 16), 16, True, None),
            ("llava7b_disagg", (32, 8, 768, 32, 32), 18, True, _serve_windows(8)),
            ("qwen7b_tp2", (28, 4, 704, 14, 2), 17, True, None),
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
    # prefill at T=640, the layer sweep's B=1 prefill at T=640 (step 14b),
    # and a ragged T
    for name, (B, T, H, kvH), timed in (("llava7b", (4, 640, 32, 32), True),
                                        ("qwen7b", (4, 640, 28, 4), True),
                                        ("llava7b_serve", (8, 704, 32, 32), True),
                                        ("qwen7b_serve", (8, 704, 28, 4), True),
                                        ("llava7b_dataset", (8, 640, 32, 32), True),
                                        ("llava7b_sweep", (1, 640, 32, 32), True),
                                        # a tensor-parallel rank's heads at n_model=2
                                        ("llava7b_tp2", (4, 640, 16, 16), True),
                                        ("qwen7b_tp2", (4, 640, 14, 2), True),
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


def phase_k4(dev):
    """K4 at the towers' shapes: within one bf16 ulp of its plain version
    (the four PyTorch calls it replaced), rows summing to 1; its time, L2
    flushed before every call, beside the plain version's and the bound."""
    import math

    import torch

    from attwarp_tpu_torch.kernels.attn_softmax import scaled_softmax_, scaled_softmax_plain

    out = {}
    # one Qwen2-VL-7B image (16 heads over 2304 patches), a batch of 8 CLIP
    # ViT-L/14-336 images (577 tokens) and of 8 SigLIP-so400m ones (729)
    for name, shape, scale in (("qwen2vl_image", (16, 2304, 2304), 1.0 / math.sqrt(80)),
                               ("clip_batch8", (8, 16, 577, 577), 1.0 / 8),
                               ("siglip_batch8", (8, 16, 729, 729), 1.0 / math.sqrt(72))):
        g = torch.Generator(device=dev).manual_seed(4)
        x = ((torch.rand(shape, generator=g, device=dev) * 60.0 - 30.0) / scale).to(torch.bfloat16)
        ref = scaled_softmax_plain(x, scale)
        got = scaled_softmax_(x.clone(), scale)
        torch.cuda.synchronize()
        ulps = (got.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max().item()
        sums = (got.float().sum(-1) - 1.0).abs().max().item()
        L = shape[-1]
        rows = x.numel() // L
        t = alternate_ms({"plain": lambda: scaled_softmax_plain(x, scale),
                          "kernel": lambda: scaled_softmax_(x, scale)}, 20, cold=True)
        warm = cuda_ms(lambda: scaled_softmax_(x, scale), 20)
        out[name] = e = with_bound(
            {"ulps": ulps, "ms": t["kernel"], "warm_ms": warm, "plain_ms": t["plain"],
             "library_ms": None, "library_note": "no single PyTorch call scales and takes "
             "the softmax in f32 from bf16 to bf16"},
            (4 * rows * L, 5 * rows * L))
        print(f"[5b K4 scaled_softmax_] {name} {tuple(shape)} bf16: vs plain {ulps} ulp "
              f"(tol 1), rows sum to 1 within {sums:.3g} (tol {2.0 ** -7:.3g}) | kernel "
              f"{t['kernel']:.4f} ms (L2 warm {warm:.4f}), plain {t['plain']:.4f} ms"
              + _bound_text(e))
        check(ulps <= 1 and sums <= 2.0 ** -7, f"K4 disagrees with its plain version ({name})")
        del x, ref, got
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


def _k4_want(vision, images, tower_calls) -> int:
    """K4's launches for ``images`` through the vision tower (config
    ``vision``) in ``tower_calls`` calls: one a block and image (Qwen2-VL),
    or one a block up to the feature layer (CLIP, layer -2) and call. A
    pipeline run makes one call a pass; ServeEngine one an admission group,
    the chunked engine one a request."""
    if hasattr(vision, "depth"):
        return images * vision.depth
    return tower_calls * (vision.num_hidden_layers - 1)


def _tower_counters():
    """``_counters()`` and K4, for the paths that run a vision tower."""
    from attwarp_tpu_torch.kernels.attn_softmax import scaled_softmax_

    return {**_counters(), "scaled_softmax_": scaled_softmax_}


def _drive(tag, backend, n_side, counters, want, int8_want=0):
    """One warm-up run of the pipeline, then one timed run with every
    kernel's launch count (and the int8 product's, which must be
    ``int8_want``, and K4's, ``_k4_want``) set to 0 just before it and read
    just after; checks the counts, the outputs, and the masks and warps
    against the port's CPU path. Returns (the counts, the run's wall, pass
    walls and peak memory)."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.extract.resize import resize_scale_device
    from attwarp_tpu_torch.kernels.attn_softmax import scaled_softmax_
    from attwarp_tpu_torch.numerics.quant import int8_matmul
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
    for fn in (*counters.values(), int8_matmul, scaled_softmax_):
        fn.launches = 0
    t0 = time.perf_counter()
    res = pipe.run(images, QUESTIONS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["int8_matmul"] = int8_matmul.launches
    launches["scaled_softmax_"] = scaled_softmax_.launches
    k4_want = _k4_want(backend.model.cfg.vision, 2 * len(images), 2)
    peak = torch.cuda.max_memory_allocated()

    p1, p2 = backend.seconds["pass1"], backend.seconds["pass2"]
    print(f"[{tag}] maps {res.attention_maps.shape} warped {res.warped.shape} "
          f"masks {res.mota_masks[0].shape} {res.mota_masks[0].dtype}")
    print(f"[{tag}] first answers {res.first_answers}")
    print(f"[{tag}] second answers {res.second_answers}")
    print(f"[{tag}] launches: " + ", ".join(
        f"{name} {launches[name]} (expected {want[name]})" for name in counters)
        + f", int8_matmul {launches['int8_matmul']} (expected {int8_want})"
        + f", scaled_softmax_ {launches['scaled_softmax_']} (expected {k4_want})")
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
    check(launches["int8_matmul"] == int8_want, "int8_matmul launch count")
    check(launches["scaled_softmax_"] == k4_want, "scaled_softmax_ launch count")

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
    return launches, {"total": total, "pass1": p1, "pass2": p2, "peak": peak}


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
    launches, stats = _drive("6 llava", backend, 24, _counters(), want)
    # step 13b holds the int8 weights' first-pass logits against these
    stats["logits"] = _first_pass_logits(backend.backend)
    return launches, backend.backend, stats


def _first_pass_logits(backend):
    """Last-position logits (f32, on the host) of the pipeline's first pass
    over the smoke batch: the same device-resized pixels and prompts, one
    prefill as the backend runs it (through K2 where it has ``+flash``)."""
    import torch

    from attwarp_tpu_torch.extract.resize import resize_images_batch

    pix = resize_images_batch(_images(), backend.image_size, backend.device)
    with torch.no_grad():
        if hasattr(backend.model.cfg, "vision_start_token_id"):
            ids, mask, patches, grid = backend._prepare(pix, QUESTIONS)
            logits, _ = backend.model.forward_logits(ids, patches, grid, mask,
                                                     use_flash=backend.use_flash)
        else:
            ids, mask, _, pixels = backend._prepare(pix, QUESTIONS)
            logits, _ = backend.model.forward_logits(ids, pixels, mask,
                                                     use_flash=backend.use_flash)
    return logits.float().cpu()


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
    launches, stats = _drive("7 qwen", TimedBackend(inner), inner.num_patches_side,
                             _counters(), want)
    stats["logits"] = _first_pass_logits(inner)     # for step 13c
    return launches, inner, stats


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


def _serve_run(tag, backend, requests, slots, steps_per_tick=8, chunked_prefill=0,
               int8_per_step=0):
    """One serve run of ``requests`` (all submitted at once) with every
    kernel's launch count set to 0 just before it and read just after.
    Prints tokens/s, TTFT p50/p95, admission waves, peak memory and wall;
    checks the outputs and that K3 = layers x decode steps, K2 = layers x
    admission prefills (0 without ``+flash`` or in the chunked engine), K4
    = the vision tower's blocks x its calls (``_k4_want``) and the int8
    product = ``int8_per_step`` x (prefills + decode steps). Returns
    (launch counts, the outputs, the run's figures)."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.cli.serve import serve
    from attwarp_tpu_torch.numerics.quant import int8_matmul

    counters = _tower_counters()
    for fn in (*counters.values(), int8_matmul):
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, outs = serve(backend, requests, slots=slots, max_seq=768,
                      steps_per_tick=steps_per_tick, chunked_prefill=chunked_prefill)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["int8_matmul"] = int8_matmul.launches
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(o) for o in outs)
    ttft = [st["first_token"] - st["submit"] for st in eng.request_stats.values()]
    p50, p95 = np.percentile(ttft, [50, 95])
    L = eng.tcfg.num_hidden_layers
    flash = bool(backend.use_flash) and not chunked_prefill
    want = {"warp_resample": 0, "decode_attn_int8": L * eng.decode_steps,
            "flash_prefill": L * eng.prefill_groups if flash else 0,
            "scaled_softmax_": _k4_want(backend.model.cfg.vision, len(requests),
                                        len(requests) if chunked_prefill
                                        else eng.prefill_groups),
            "int8_matmul": int8_per_step * (eng.prefill_groups + eng.decode_steps)}
    buckets = sorted({-(-len(r["input_ids"]) // 64) * 64 for r in requests})
    admit_s = sum(end - start for start, end, _ in eng.admit_log)
    used = sum(sum(took.values()) for _, took in eng.tick_log)
    print(f"[{tag}] {len(requests)} requests (buckets {buckets}), {n_tok} tokens: "
          f"{n_tok / wall:.1f} tok/s | TTFT p50 {p50 * 1e3:.1f} ms, p95 "
          f"{p95 * 1e3:.1f} ms | {len(eng.admit_log)} admission waves "
          f"({eng.prefill_groups} prefill groups, {eng.decode_steps} decode steps) | "
          f"peak memory {peak / 2**30:.2f} GiB | wall {wall:.3f} s | launches: " + ", ".join(
              f"{name} {launches[name]} (expected {want[name]})" for name in launches))
    print(f"[{tag}] host clock: admission {admit_s:.3f} s, ticks {wall - admit_s:.3f} s "
          f"({(wall - admit_s) / max(eng.decode_steps, 1) * 1e3:.1f} ms per decode step); "
          f"slot occupancy {used / max(eng.decode_steps * eng.slots, 1):.3f} "
          f"(tokens kept / slot-steps run)")
    vocab = eng.tcfg.vocab_size
    check(all(1 <= len(o) <= r["max_new_tokens"] and all(0 <= t < vocab for t in o)
              for o, r in zip(outs, requests)), f"{tag}: outputs")
    check(eng.decode_steps > 0 and want["decode_attn_int8"] > 0, f"{tag}: no decode step")
    for name in launches:
        check(launches[name] == want[name], f"{tag}: {name} launch count")
    step_ms = (wall - admit_s) / max(eng.decode_steps, 1) * 1e3
    return launches, outs, {"tok_s": n_tok / wall, "ttft_p50": p50, "ttft_p95": p95,
                            "peak": peak, "step_ms": step_ms}


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
    return tick * 1e3


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
    serve, outs, stats = _serve_run("8 llava serve", backend, reqs, slots=16)
    _agreement("8 llava serve", backend.model, reqs, outs, 4)
    backend.use_flash = False
    chunked, _, _ = _serve_run("8 llava chunked", backend,
                               _serve_requests(backend, 16, seed=2), slots=16,
                               chunked_prefill=128)
    backend.use_flash = True
    stats["tick_ms"] = _time_tick("8 llava serve", backend, reqs, slots=16)
    return serve, chunked, stats


def phase_qwen_serve(backend):
    """Qwen2-VL-7B ``+kv8+flash`` serving at 672 px on the slice's weights."""
    reqs = _serve_requests(backend, 16, seed=3)
    launches, outs, _ = _serve_run("8 qwen serve", backend, reqs, slots=8)
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
    with _recording_tokens(backend.model) as tokens:
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
    return launches, {"samples_s": 16 / wall, "extract_s": extract_s, "root": root,
                      "tokens": torch.cat(tokens)}


# the JAX learned-warp chain (tools/run_marginalnet_chain.py at its defaults;
# eval_results/marginalnet_accuracy_gain.json): learned warp 0.82, original
# 0.00, the oracle driver on the same eval set 0.90. (The JAX driver and
# harness on those 50 eval scenes today, on the CPU, read 0.88: the reader
# changed after that file was written; one sample inside the bar.)
JAX_CHAIN_LEARNED_GAIN = 0.82
JAX_CHAIN_ORACLE_GAIN = 0.90


def _stage_sums(run_dir) -> dict:
    """{stage: (seconds in all, count)} from a training run's stages.jsonl."""
    out = {}
    with open(run_dir / "stages.jsonl") as f:
        for line in f:
            r = json.loads(line)
            t, n = out.get(r["stage"], (0.0, 0))
            out[r["stage"]] = (t + r["seconds"], n + 1)
    return out


def phase_marginalnet_chain():
    """12a: the learned-warp chain at the JAX tool's defaults on the card
    (``attwarp_tpu_torch.tools.run_marginalnet_chain.main``, device cuda,
    under ``build/chip_smoke/``). Bars: original <= 0.02; learned gain >=
    0.72 (the JAX chain's 0.82 less five samples in 50: the port trains
    from its own seeded init, in bf16, on other hardware); the oracle on the
    same eval set within one sample of 0.90 (the driver and the reader are
    deterministic and the scenes byte-equal to JAX's); K1 launches as the
    code predicts, K2 = K3 = 0. Returns the launches and the training
    dataset's metadata directory."""
    import math

    from attwarp_tpu_torch.data.loader import split_indices
    from attwarp_tpu_torch.tools import run_marginalnet_chain as chain
    from attwarp_tpu_torch.train.config import TrainConfig

    root = _scratch("marginalnet_chain")
    args = chain.build_parser().parse_args([str(root / "work")])
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    rc = chain.main([str(root / "work"), "--device", "cuda",
                     "--out-json", str(root / "gain.json")])
    launches = {name: fn.launches for name, fn in counters.items()}
    with open(root / "gain.json") as f:
        res = json.load(f)
    oracle = res["oracle_same_eval_set"]
    walls = res["stage_seconds"]

    # K1 per the code: one launch per driver sample (train and eval sets),
    # one per predict_and_warp chunk of 10, and per epoch the validation
    # debug round's three warp_from_cdf (predicted, target, raw map) plus
    # two per train debug round (vis_every = 10000: none at 13 steps an
    # epoch); K2 and K3 have no part in the reader's chain
    cfg = TrainConfig()
    train_idx, _ = split_indices(args.n_train, 0.1, cfg.seed)
    steps = args.epochs * (len(train_idx) // args.batch_size)
    want_k1 = (args.n_train + args.n_eval + math.ceil(args.n_eval / 10)
               + 3 * args.epochs + 2 * (steps // 10_000))
    want = {"warp_resample": want_k1, "flash_prefill": 0, "decode_attn_int8": 0}
    samples_s = steps * args.batch_size / walls["training"]
    stages = _stage_sums(root / "work" / "experiments" / "Experiment_1")
    print(f"[12a marginalnet chain] walls: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items())
        + f" | training {steps} steps of {args.batch_size} ({args.epochs} epochs, "
          f"{args.image_size} px, the validation and its debug rounds included): "
          f"{samples_s:.1f} samples/s; of its wall, features (prepare_batch) "
          f"{stages['features'][0]:.3f} s and train_step {stages['train_step'][0]:.3f} s over "
          f"{stages['train_step'][1]} steps, the rest reading the samples, validation and "
          f"set-up")
    print(f"[12a marginalnet chain] learned warp: warped {res['overall_warped_accuracy']:.4f}, "
          f"original {res['overall_original_accuracy']:.4f}, gain {res['accuracy_gain']:+.4f} "
          f"(bar >= {JAX_CHAIN_LEARNED_GAIN - 0.10:.2f}; JAX {JAX_CHAIN_LEARNED_GAIN:+.2f}) | "
          f"oracle on the same eval set: warped {oracle['overall_warped_accuracy']:.4f}, "
          f"gain {oracle['accuracy_gain']:+.4f} (bar {JAX_CHAIN_ORACLE_GAIN:+.2f} +- 0.02)")
    print(f"[12a marginalnet chain] launches: " + ", ".join(
        f"{name} {launches[name]} (expected {want[name]})" for name in counters))
    check(rc == 0, "the chain tool exited non-zero")
    check(res["total_samples_evaluated"] == args.n_eval, f"{args.n_eval} evaluated")
    check(res["overall_original_accuracy"] <= 0.02, "chain: original accuracy above 0.02")
    check(res["accuracy_gain"] >= JAX_CHAIN_LEARNED_GAIN - 0.10 - 1e-9,
          "chain: learned gain below 0.72")
    check(abs(oracle["accuracy_gain"] - JAX_CHAIN_ORACLE_GAIN) <= 1 / 50 + 1e-9,
          "chain: oracle gain more than one sample from 0.90")
    check(launches == want, "chain: launch counts")
    return launches, root / "work" / "processed_train" / "metadata"


def phase_marginalnet_train(backend, meta_dir):
    """12b: MarginalNet at ``TrainConfig()``'s widths (hidden 256, batch
    128, 512 px, lr 3e-4, w_cdf 10) on frozen LLaVA-1.5-7B features of
    step 6's weights (``LlavaFeatureExtractor``: CLIP ViT-L/14-336 ->
    (128, 24, 24, 1024), LLaMA embeddings -> (128, 32, 4096)) over 12a's
    driver metadata: 10 ``train_step``s on one batch of 128 (the loss must
    fall, ``grad_norm`` stay finite), then ``train_loop`` for one epoch with
    ``vis_every=1``, whose train and validation debug rounds launch K1."""
    import math

    import numpy as np
    import torch

    from attwarp_tpu_torch.data.loader import batch_iterator, split_indices
    from attwarp_tpu_torch.data.manifests import MetadataDirDataset
    from attwarp_tpu_torch.extract.features import LlavaFeatureExtractor
    from attwarp_tpu_torch.train.config import TrainConfig
    from attwarp_tpu_torch.train.train_step import create_train_state, train_step
    from attwarp_tpu_torch.train.trainer import prepare_batch, train_loop

    dev = backend.device
    root = _scratch("marginalnet_train")
    dataset = MetadataDirDataset(str(meta_dir), image_size=512)
    feats = LlavaFeatureExtractor(backend)
    cfg = TrainConfig(experiments_root=str(root / "experiments"), epochs=1, vis_every=1,
                      log_every=1)
    B = cfg.batch_size
    raw = next(batch_iterator(dataset, list(range(B)), B))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch = prepare_batch(raw, feats, dev)
    torch.cuda.synchronize()
    feat_ms = (time.perf_counter() - t0) * 1e3
    # the features' parts: the images' upload, their resize to the tower's
    # 336 px and CLIP normalization, the tower (each ends in a sync)
    from attwarp_tpu_torch.extract.resize import clip_pixels, resize_scale_device
    from attwarp_tpu_torch.models.clip_vit import clip_vision_features

    part_ms, t0 = [], time.perf_counter()
    with torch.no_grad():
        x = torch.as_tensor(raw["image"], device=dev)
        for step in ("upload", "resize", "tower"):
            if step == "resize":
                S = backend.image_size
                x = clip_pixels(resize_scale_device(x, 1.0, (S, S)), S, dev)
            elif step == "tower":
                x = clip_vision_features(backend.model.params["vision"],
                                         backend.model.cfg.vision, x,
                                         backend.model.cfg.vision_feature_layer)
            torch.cuda.synchronize()
            part_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
    del x
    _, state = create_train_state(cfg, cfg.seed, batch)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    losses, norms, step_ms = [], [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss/total"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    steps_launches = {name: fn.launches for name, fn in counters.items()}
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[12b marginalnet train] MarginalNet hidden {cfg.hidden} ({n_params / 1e6:.3f} M "
          f"parameters, bf16 autocast), batch {B} at {cfg.image_size} px: fmap "
          f"{tuple(batch['fmap_v'].shape)} {batch['fmap_v'].dtype}, ttok "
          f"{tuple(batch['ttok'].shape)} | features {feat_ms:.1f} ms per batch (host clock, "
          f"ends in a sync; again in parts: upload {part_ms[0]:.1f}, resize and normalize "
          f"{part_ms[1]:.1f}, CLIP tower {part_ms[2]:.1f} ms) | train_step first {step_ms[0]:.1f} ms, then median "
          f"{statistics.median(step_ms[1:]):.2f} ms per batch (host clock, each ends in a "
          f"sync) | peak memory {peak / 2**30:.2f} GiB")
    print(f"[12b marginalnet train] loss over 10 steps on one batch: "
          + ", ".join(f"{x:.5f}" for x in losses)
          + f" | grad_norm {norms[0]:.4g} -> {norms[-1]:.4g}")
    check(losses[-1] < losses[0], "12b: the loss did not fall over 10 steps")
    check(all(math.isfinite(x) for x in losses + norms), "12b: a loss or grad_norm not finite")
    check(steps_launches == {"warp_resample": 0, "flash_prefill": 0, "decode_attn_int8": 0},
          "12b: a kernel launched inside train_step")
    del state, batch
    torch.cuda.empty_cache()

    # one epoch of the loop: train and validation debug rounds through K1
    train_idx, val_idx = split_indices(len(dataset), 0.1, cfg.seed)
    steps = len(train_idx) // B
    want = {"warp_resample": 2 * steps + 3, "flash_prefill": 0, "decode_attn_int8": 0}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_dir = train_loop(cfg, dataset=dataset, feature_extractor=feats, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    stages = _stage_sums(run_dir)
    debug = sorted(p.name for p in (run_dir / "debug").glob("*.png"))
    debug_val = sorted(p.name for p in (run_dir / "debug_validation").glob("*.png"))
    print(f"[12b marginalnet train] train_loop, 1 epoch ({steps} step of {B}, validation "
          f"{len(val_idx)}): wall {wall:.3f} s | stages " + ", ".join(
              f"{k} {1e3 * t / n:.1f} ms x {n}" for k, (t, n) in stages.items())
          + f" | debug grids {debug + debug_val} | peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[12b marginalnet train] launches: " + ", ".join(
        f"{name} {launches[name]} (expected {want[name]})" for name in counters))
    check(launches == want, "12b: launch counts")
    check(len(list((run_dir / "checkpoints").glob("*.pt"))) == 1, "12b: one checkpoint")
    check(bool(np.isfinite([json.loads(line)["loss/train_total"]
                            for line in open(run_dir / "metrics.jsonl")
                            if "loss/train_total" in line]).all()), "12b: train loss")
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


# ── step 14: multi-layer extraction, the layer sweep and the mini ──────

LAYERS_14A = (20, 4, 8, 12, 16)


class _recording_tokens:
    """Context that records the greedy tokens of every
    ``generate_with_attention`` of ``model`` (on the host, in call order)."""

    def __init__(self, model):
        self.model, self.tokens = model, []

    def __enter__(self):
        inner = self.model.generate_with_attention

        def generate(*args, **kwargs):
            gen, maps = inner(*args, **kwargs)
            self.tokens.append(gen.cpu())
            return gen, maps
        self.model.generate_with_attention = generate
        return self.tokens

    def __exit__(self, *exc):
        del self.model.generate_with_attention
        return False


class _CountingBackend(TimedBackend):
    """``TimedBackend`` that also records each ``extract`` call's batch size
    (a batch that fell back to per-sample extraction shows as calls of 1)."""

    def __init__(self, backend):
        super().__init__(backend)
        self.calls = []

    def extract(self, images, questions, **kwargs):
        self.calls.append(len(questions))
        return super().extract(images, questions, **kwargs)


def phase_llava_layers(backend, step10):
    """14a: the dataset driver on LLaVA-1.5-7B ``+kv8+flash`` extracting
    layers (20, 4, 8, 12, 16) in one pass (``--layer-index 20,4,8,12,16``)
    over step 10's 16 code-tag scenes, batches of 8, 20 new tokens. Checks
    every artifact and the five per-layer maps of each sample, that no
    fallback fired (two batch calls of 8, no uniform map), K1 = 16, K2 =
    32 x 2, K3 = (32 - 5) x 20 x 2, and layer 20's maps against step 10's
    single-layer run: cos > 0.999 on every sample whose greedy tokens are
    step 10's (the listed layers 4-16 leave K3 for the plain path, which
    rounds bf16 otherwise, and on random weights a near-tie can turn a
    sample's tokens, and so its later rows, another way), and on the first
    batch at one new token, where no token can diverge."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.cli.process_dataset import parse_layer_spec, process_dataset
    from attwarp_tpu_torch.data.imageio import read_rgb
    from attwarp_tpu_torch.extract.resize import resize_images_batch
    from attwarp_tpu_torch.testing.reader import write_textvqa_dataset

    root = _scratch("llava_layers")
    json_path, image_dir = write_textvqa_dataset(str(root / "data"), n=16, seed=0)
    backend.kv_quant = backend.use_flash = True
    # the layers as ``--layer-index 20,4,8,12,16`` gives them
    backend.extract_layer = parse_layer_spec(",".join(map(str, LAYERS_14A)))
    check(backend.extract_layer == LAYERS_14A, "14a: the layer list")
    timed = _CountingBackend(backend)
    counters = _counters()
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _recording_tokens(backend.model) as tokens:
            stats = process_dataset(json_path, image_dir, str(root / "out"), timed,
                                    batch_size=8, max_new_tokens=20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        backend.extract_layer = 20
    tokens = torch.cat(tokens)
    L, n = backend.model.cfg.text.num_hidden_layers, len(LAYERS_14A)
    want = {"warp_resample": 16, "flash_prefill": L * 2,
            "decode_attn_int8": (L - n) * 20 * 2}
    extract_s = timed.seconds["pass1"]
    per_step = (extract_s - step10["extract_s"]) / (2 * 20) * 1e3
    print(f"[14a llava layers] driver, layers {LAYERS_14A}: {stats['processed']} processed, "
          f"{stats['failed']} failed, wall {wall:.3f} s ({16 / wall:.3f} samples/s; step 10, "
          f"one layer: {step10['samples_s']:.3f}) | extraction {extract_s:.3f} s (step 10: "
          f"{step10['extract_s']:.3f} s; {per_step:+.2f} ms a decode step over 2 x 20 steps) | "
          f"extract calls {timed.calls}")
    print("[14a llava layers] launches: " + ", ".join(
        f"{name} {launches[name]} (expected {want[name]})" for name in counters))
    check(stats == {"processed": 16, "failed": 0}, "14a: 16 processed, 0 failed")
    check(timed.calls == [8, 8], "14a: a batch fell back to per-sample extraction")
    for name in counters:
        check(launches[name] == want[name], f"14a: {name} launch count")
    metas = _check_tree(root / "out", 16, 24)
    d_max, cos_same, diverged = 0.0, [], []
    same_tokens = [bool(torch.equal(a, b)) for a, b in zip(tokens, step10["tokens"])]
    for m, same in zip(metas, same_tokens):
        sid = m["sample_id"]
        check(m["extract_layers"] == list(LAYERS_14A), f"{sid}: extract_layers")
        per = m["saved_paths"]["raw_attention_maps_per_layer"]
        check(sorted(per) == sorted(map(str, LAYERS_14A)), f"{sid}: per-layer paths")
        maps = {}
        for lid, path in per.items():
            check(path == str(root / "out" / "raw_attention_maps" / f"{sid}_raw_attn_layer{lid}.npy"),
                  f"{sid}: layer {lid} path")
            maps[lid] = np.load(path)
            check(maps[lid].shape == (1, 1, 24, 24) and bool(np.isfinite(maps[lid]).all())
                  and not np.allclose(maps[lid], 1 / 576, rtol=0, atol=1e-9),
                  f"{sid}: layer {lid} map")
        primary = np.load(m["saved_paths"]["raw_attention_map_npy"])
        check(np.array_equal(primary, maps["20"]), f"{sid}: the first layer is primary")
        ref = np.load(step10["root"] / "out" / "raw_attention_maps" / f"{sid}_raw_attn.npy")
        d_max = max(d_max, float(np.abs(primary - ref).max()))
        c = _cos(torch.as_tensor(primary), torch.as_tensor(ref))
        (cos_same if same else diverged).append(c)
    print(f"[14a llava layers] layer 20 vs step 10's single-layer maps: max|d| {d_max:.4g}; "
          f"{len(cos_same)} samples with step 10's greedy tokens, min cos "
          f"{min(cos_same, default=float('nan')):.6f} (bar > 0.999); {len(diverged)} whose "
          f"tokens diverged (a near-tie on random weights), cos "
          + " ".join(f"{c:.6f}" for c in diverged))
    check(len(cos_same) > 0 and min(cos_same) > 0.999,
          "14a: layer 20's maps drift from step 10's on the same tokens")

    # one decode step, where the tokens cannot diverge: the plain path of
    # the listed layers against K3 is bf16 rounding alone
    first = metas[:8]
    pix = resize_images_batch([read_rgb(m["saved_paths"]["original_image"]) for m in first],
                              backend.image_size, backend.device)
    qs = [m["question"] for m in first]
    one, _ = backend.extract(pix, qs, max_new_tokens=1)
    try:
        backend.extract_layer = LAYERS_14A
        five, _ = backend.extract(pix, qs, max_new_tokens=1)
    finally:
        backend.extract_layer = 20
    c1 = min(_cos(a, b) for a, b in zip(one.float(), five[0].float()))
    print(f"[14a llava layers] one new token, first batch: layer 20 alone vs among five, min "
          f"cos {c1:.6f} (bar > 0.999)")
    check(c1 > 0.999, "14a: the listed layers' plain path moves layer 20's one-step maps")
    return launches, root


def phase_llava_sweep(backend, data_root):
    """14b: ``eval.layer_sweep.layer_sweep`` at LLaVA-1.5-7B width
    (``+kv8+flash``) over 8 of 14a's code-tag scenes, ``DEFAULT_LAYERS``,
    each scene's tag box (``tag_box_yxs``: y, x, size) as xywh. One prefill
    a prompt for all nine layers: K2 = 32 x 2 x 8, K3 = 0, no fallback;
    every score finite and in [0, 1]; the one-pass maps of layers 4 and 20
    equal ``_extract_at_layer``'s (1e-6)."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.data.imageio import read_rgb
    from attwarp_tpu_torch.eval import layer_sweep as ls

    with open(data_root / "data" / "codetag_val.json") as f:
        data = json.load(f)["data"][:8]
    samples = []
    for d in data:
        y, x, size = d["tag_box_yxs"]
        samples.append({"image": read_rgb(str(data_root / "data" / "images" /
                                              f"{d['image_id']}.jpg")),
                        "question": d["question"], "bbox": (x, y, size, size)})
    ids = [backend._prepare(samples[0]["image"][None], [q])[0] for q in
           (samples[0]["question"], ls.GENERIC_PROMPT)]
    T = {int(i.shape[1]) for i in ids}
    check(T == {640}, f"14b: prompts of {T} tokens (K2's sweep row is timed at T=640)")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    ls._extract_all_layers.fallbacks = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = ls.layer_sweep(backend, samples, layers=ls.DEFAULT_LAYERS,
                             out_dir=str(_scratch("llava_sweep")))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    L = backend.model.cfg.text.num_hidden_layers
    want = {"warp_resample": 0, "flash_prefill": L * 2 * 8, "decode_attn_int8": 0}
    print(f"[14b llava sweep] {len(ls.DEFAULT_LAYERS)} layers x 8 scenes, prompts T=640, B=1: "
          f"wall {wall:.3f} s ({wall / 16 * 1e3:.1f} ms a prompt), fallbacks "
          f"{ls._extract_all_layers.fallbacks} | launches " + ", ".join(
              f"{name} {launches[name]} (expected {want[name]})" for name in counters))
    print("[14b llava sweep] " + "; ".join(
        f"{k} top1 {v['top1']:.3f} am {v['am_all']:.4f}" for k, v in summary.items()
        if k.startswith("absolute")) + " (random weights: plumbing only)")
    check(ls._extract_all_layers.fallbacks == 0, "14b: the one-pass extraction fell back")
    for name in counters:
        check(launches[name] == want[name], f"14b: {name} launch count")
    check(len(summary) == 2 * len(ls.DEFAULT_LAYERS)
          and all(v["n"] == 8 for v in summary.values()), "14b: summary rows")
    check(all(np.isfinite(v[k]) and 0.0 <= v[k] <= 1.0 for v in summary.values()
              for k in ("top1", "am_all")), "14b: a score not finite or outside [0, 1]")
    s0 = samples[0]
    one = ls._extract_all_layers(backend, s0["image"][None], [s0["question"]], ls.DEFAULT_LAYERS)
    for layer in (4, 20):
        single = ls._extract_at_layer(backend, s0["image"][None], [s0["question"]], layer)
        d = float(np.abs(one[layer] - single).max())
        print(f"[14b llava sweep] one pass vs _extract_at_layer at layer {layer}: max|d| {d:.3g} "
              f"(tol 1e-6)")
        check(d <= 1e-6, f"14b: the one-pass map of layer {layer} differs")
    return launches


def phase_qwen_layers(inner):
    """14c: Qwen2-VL-7B ``+kv8+flash`` at 672 px on step 7's weights:
    ``extract_layer=(20, 4, 12)`` at B=4 (K2 = 28, K3 = (28 - 3) x 20);
    then one image's (N, D) patches shared by 4 questions against the same
    image repeated per sample: maps cos > 0.9999, greedy tokens equal; the
    vision tower timed in both forms."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.extract.resize import resize_images_batch

    images = _images()
    pix = resize_images_batch(images, inner.image_size, inner.device)
    counters = _counters()
    old = inner.extract_layer
    try:
        inner.extract_layer = (20, 4, 12)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps, texts = inner.extract(pix, QUESTIONS, max_new_tokens=20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        inner.extract_layer = old
    L = inner.model.cfg.text.num_hidden_layers
    want = {"warp_resample": 0, "flash_prefill": L, "decode_attn_int8": (L - 3) * 20}
    m = maps.float().cpu().numpy()
    print(f"[14c qwen layers] extract (20, 4, 12), B=4, 20 new tokens: maps {m.shape}, wall "
          f"{wall:.3f} s | launches " + ", ".join(
              f"{name} {launches[name]} (expected {want[name]})" for name in counters))
    check(m.shape == (3, 4, 24, 24) and bool(np.isfinite(m).all())
          and np.allclose(m.sum(axis=(2, 3)), 1.0, atol=1e-3), "14c: maps")
    for name in counters:
        check(launches[name] == want[name], f"14c: {name} launch count")

    model = inner.model
    ids, mask, patches, grid = inner._prepare(resize_images_batch([images[0]] * 4,
                                                                  inner.image_size, inner.device),
                                              QUESTIONS)
    check(bool((patches == patches[:1]).all()), "14c: the repeated patches are one image's")
    shared = patches[0].contiguous()
    kw = dict(extract_layer=(20, 4, 12), max_new_tokens=20, kv_quant=True, use_flash=True)
    with torch.no_grad():
        g_rep, m_rep = model.generate_with_attention(ids, patches, grid, mask, **kw)
        g_one, m_one = model.generate_with_attention(ids, shared, grid, mask, **kw)
        t_rep = cuda_ms(lambda: model.image_features(patches, grid), 3)
        t_one = cuda_ms(lambda: model.image_features(shared, grid), 3)
    cos = min(_cos(a, b) for a, b in zip(m_one.reshape(12, -1), m_rep.reshape(12, -1)))
    same = bool(torch.equal(g_one, g_rep))
    print(f"[14c qwen layers] one image shared by 4 questions vs repeated: maps min cos "
          f"{cos:.6f} (bar > 0.9999), greedy tokens equal {same} | vision tower "
          f"{t_one:.2f} ms shared vs {t_rep:.2f} ms for 4 copies")
    check(cos > 0.9999, "14c: shared-image maps differ from the repeated image's")
    check(same, "14c: shared-image tokens differ from the repeated image's")
    return launches


def phase_mini(dev):
    """14d: the mini test MLLM at the CLIs' defaults on the card:
    ``cli.process_dataset.main`` with no ``--backend`` over step 10's 16
    code-tag scenes (K1 = 16, 0 failed, every artifact), then
    ``cli.evaluate.main`` with no ``--model``; ``MiniFeatureExtractor`` on
    the card against its CPU copy on the same weights (1e-4)."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.cli import evaluate, process_dataset
    from attwarp_tpu_torch.extract.extraction import MiniLLaVABackend
    from attwarp_tpu_torch.extract.features import MiniFeatureExtractor
    from attwarp_tpu_torch.testing.reader import write_textvqa_dataset

    root = _scratch("mini")
    json_path, image_dir = write_textvqa_dataset(str(root / "data"), n=16, seed=0)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = process_dataset.main(["--textvqa-json", json_path, "--image-dir", image_dir,
                               "--output-dir", str(root / "out"), "--batch-size", "8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {"warp_resample": 16, "flash_prefill": 0, "decode_attn_int8": 0}
    t0 = time.perf_counter()
    rc_eval = evaluate.main(["--metadata-dir", str(root / "out" / "metadata"),
                             "--output-dir", str(root / "eval"), "--score-original",
                             "--max-new-tokens", "16"])
    eval_wall = time.perf_counter() - t0
    res = _result_json(root / "eval")
    print(f"[14d mini] cli.process_dataset (default backend): rc {rc}, wall {wall:.3f} s "
          f"({16 / wall:.3f} samples/s) | launches " + ", ".join(
              f"{name} {launches[name]} (expected {want[name]})" for name in counters)
          + f" | cli.evaluate (default model): rc {rc_eval}, {res['total_samples_evaluated']} "
          f"evaluated, wall {eval_wall:.3f} s")
    check(rc == 0 and rc_eval == 0, "14d: a CLI failed")
    metas = _check_tree(root / "out", 16, 24)
    check(all(m["api_model_name"] == "mini-llava" for m in metas), "14d: the mini backend ran")
    check(res["total_samples_evaluated"] == 16, "14d: 16 evaluated")
    for name in counters:
        check(launches[name] == want[name], f"14d: {name} launch count")

    card = MiniFeatureExtractor(MiniLLaVABackend(device=dev, seed=0))
    tree = card.backend.params

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu(v) for v in t]
        return t.cpu()
    host = MiniFeatureExtractor(MiniLLaVABackend(card.cfg, device="cpu", params=to_cpu(tree)))
    imgs = np.stack([im[:480, :480] for im in _images()]).astype(np.float32) / 255.0
    d_vis = float((card.visual_tokens(imgs).cpu() - host.visual_tokens(imgs)).abs().max())
    (e_c, m_c), (e_h, m_h) = card.text_tokens(QUESTIONS), host.text_tokens(QUESTIONS)
    d_txt = float((e_c.cpu() - e_h).abs().max())
    print(f"[14d mini] MiniFeatureExtractor on the card vs the CPU: visual_tokens max|d| "
          f"{d_vis:.3g}, text_tokens max|d| {d_txt:.3g} (tol 1e-4)")
    check(d_vis <= 1e-4 and d_txt <= 1e-4 and torch.equal(m_c.cpu(), m_h),
          "14d: MiniFeatureExtractor differs between the card and the CPU")
    return launches


# ── step 13: int8 weights (+int8, +lm8) and HF checkpoints ──────────────

INT8_ITERS = 20


def _int8_shapes():
    """(name, M, K, N, bias, head) of every w8a8 product the slice runs: the
    LLaVA-1.5-7B linears at the decode rows (M = 4 in the pipeline, 8 and 16
    in the slot pools, padded to 24 rows) and the pipeline's prefill (M = 4
    x 640), its ``+lm8`` head at the decode rows; Qwen2-VL-7B's biased k/v,
    its gate and its ``+lm8`` head at M = 4 and 4 x 640."""
    shapes = []
    for M in (4, 8, 16, 2560):
        shapes += [(f"llava7b_qo_m{M}", M, 4096, 4096, False, False),
                   (f"llava7b_gate_up_m{M}", M, 4096, 11008, False, False),
                   (f"llava7b_down_m{M}", M, 11008, 4096, False, False)]
    shapes.append(("llava7b_lm8_m4", 4, 4096, 32064, False, True))
    for M in (4, 2560):
        shapes += [(f"qwen7b_kv_m{M}", M, 3584, 512, True, False),
                   (f"qwen7b_gate_m{M}", M, 3584, 18944, False, False),
                   (f"qwen7b_lm8_m{M}", M, 3584, 152064, False, True)]
    return shapes


def phase_int8_matmul(dev) -> dict:
    """13a: the int8 product (``numerics/quant.py::int8_matmul``,
    ``torch._int_mm``) at every shape the slice runs: its int32 sums equal
    an f64 product of the same int8 values (exact: |sum| <= K * 127^2 <
    2^53), and the w8a8 linear's output after the rescale is bit-equal to
    the same arithmetic on that exact product. Times (L2 flushed, warm
    beside) of the whole w8a8 linear, of the GEMM alone and of the
    activation quantization alone, beside bf16 ``F.linear`` on the same
    shapes and the card's least time for the linear."""
    import torch
    import torch.nn.functional as F

    from attwarp_tpu_torch.kernels import roofline
    from attwarp_tpu_torch.numerics.quant import (
        apply_linear,
        int8_matmul,
        lm_logits,
        quantize_linear,
        quantize_rows,
        rescale,
    )

    out = {}
    for i, (name, M, K, N, bias, head) in enumerate(_int8_shapes()):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        W = torch.randn((N, K), generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02)
        b = torch.randn((N,), generator=g, device=dev, dtype=torch.bfloat16) if bias else None
        w = quantize_linear({"weight": W, "bias": b} if bias else W)
        h = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
        if head:
            params = {"lm_head": w, "embed_tokens": W}

            def linear():
                return lm_logits(h, params)
        else:
            def linear():
                return apply_linear(h, w)
        hq, ascale = quantize_rows(h)
        y = int8_matmul(hq, w["q"])
        exact = hq.double() @ w["q"].double().t()
        sums_equal = bool(torch.equal(y.double(), exact))
        plain = rescale(exact.to(torch.int32), ascale, w)
        plain = plain if head else plain.to(h.dtype)
        got = linear()
        bit_equal = bool(torch.equal(got, plain))
        del exact, plain, got, y
        fns = {"w8a8": linear, "gemm": lambda: int8_matmul(hq, w["q"]),
               "quantize": lambda: quantize_rows(h), "bf16_linear": lambda: F.linear(h, W)}
        if head:   # the dense head as the port runs it without +lm8: f32 upcast
            fns["dense_f32_head"] = lambda: lm_logits(h, {"lm_head": W, "embed_tokens": W})
        cold = alternate_ms(fns, INT8_ITERS, cold=True)
        warm = {k: cuda_ms(fns[k], INT8_ITERS) for k in ("w8a8", "bf16_linear")}
        e = with_bound({"M": M, "K": K, "N": N, "padded_rows": max(M, 24),
                        "ms": cold["w8a8"], "warm_ms": warm["w8a8"], "gemm_ms": cold["gemm"],
                        "quantize_ms": cold["quantize"], "library": "F.linear bf16",
                        "library_ms": cold["bf16_linear"], "library_warm_ms": warm["bf16_linear"],
                        "sums_exact": sums_equal, "bit_equal": bit_equal},
                       roofline.w8a8_work(M, K, N, bias, out_elem=4 if head else 2),
                       roofline.INT8_OPS)
        if head:
            e["dense_f32_head_ms"] = cold["dense_f32_head"]
        out[name] = e
        print(f"[13a int8] {name} ({M}x{K} -> {N}{', bias' if bias else ''}): int32 sums "
              f"{'exact' if sums_equal else 'DIFFER'}, output "
              f"{'bit-equal' if bit_equal else 'DIFFERS'} | w8a8 {e['ms']:.4f} ms (warm "
              f"{e['warm_ms']:.4f}) = GEMM {e['gemm_ms']:.4f} + quantize {e['quantize_ms']:.4f} "
              f"+ rescale | bf16 F.linear {e['library_ms']:.4f} (warm {e['library_warm_ms']:.4f})"
              + (f" | dense f32 head {e['dense_f32_head_ms']:.4f}" if head else "")
              + f" | bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
              f"{e['pct_of_bound']:.1f}% of bound")
        check(sums_equal, f"{name}: int8 sums differ from the exact product")
        check(bit_equal, f"{name}: w8a8 output differs from the plain arithmetic")
        del W, b, w, h, hq, ascale, fns
    torch.cuda.empty_cache()
    return out


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _quantized_bytes(text, head: bool) -> int:
    """Bytes of the decoder's seven linears in every layer, and of the LM
    head where ``head``."""
    from attwarp_tpu_torch.numerics.quant import DECODER_LINEAR_KEYS

    n = sum(_tree_bytes(lp[k]) for lp in text["layers"] for k in DECODER_LINEAR_KEYS)
    return n + (_tree_bytes(text.get("lm_head", text["embed_tokens"])) if head else 0)


def _quantize_in_place(tag, backend, text, int8=True, lm8=False):
    """Quantizes ``backend`` in place (``+int8`` and/or ``+lm8``) and checks
    that the memory it holds falls by the bytes the tree says, within 10%.
    Returns that fall in bytes."""
    import torch

    before = _quantized_bytes(text, lm8)
    gc.collect()
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if int8:
        backend.quantize_int8()
    if lm8:
        backend.quantize_lm_head()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    gc.collect()
    a1 = torch.cuda.memory_allocated()
    predicted = before - _quantized_bytes(text, lm8)
    print(f"[{tag}] quantized in place in {secs:.2f} s: memory held {a0 / 2**30:.2f} -> "
          f"{a1 / 2**30:.2f} GiB, a fall of {(a0 - a1) / 1e9:.3f} GB against the tree's "
          f"{predicted / 1e9:.3f} GB (tol 10%)")
    check(abs((a0 - a1) - predicted) <= 0.1 * predicted,
          f"{tag}: the memory held did not fall by the quantized bytes")
    return predicted


def _print_pipeline_beside(tag, stats, base, base_tag, tokens):
    """The timed pipeline run's figures beside another run's (host clock)."""
    def line(s):
        return (f"{4 / s['total']:.3f} samples/s, {tokens / (s['pass1'] + s['pass2']):.1f} "
                f"generated tok/s over both passes | pass 1 {s['pass1']:.3f} s, mask+warp and "
                f"resizes {s['total'] - s['pass1'] - s['pass2']:.3f} s, pass 2 "
                f"{s['pass2']:.3f} s | peak {s['peak'] / 2**30:.2f} GiB")
    print(f"[{tag}] {line(stats)}")
    print(f"[{tag}] beside {base_tag}: {line(base)}")


def phase_llava_int8(backend, base6, base8):
    """13b: step 6's LLaVA-1.5-7B weights, quantized in place
    (``+int8+kv8+flash``): one warm-up and one timed pipeline run, the
    serve run of step 8's cell, then ``+lm8`` and one more pipeline run."""
    L, steps = backend.model.cfg.text.num_hidden_layers, 20
    text = backend.model.params["llama"]
    fall = _quantize_in_place("13b llava int8", backend, text)
    backend.kv_quant, backend.use_flash = True, True
    want = {"warp_resample": 1, "flash_prefill": 2 * L,
            "decode_attn_int8": steps * (L - 1) + steps * L}
    per_step = 7 * L
    launches, stats = _drive("13b llava int8", TimedBackend(backend), 24, _counters(), want,
                             int8_want=per_step * 2 * (1 + steps))
    _print_pipeline_beside("13b llava int8", stats, base6, "step 6 (bf16 +kv8)", 2 * 4 * steps)
    logits = _first_pass_logits(backend)
    cos = _cos(logits, base6["logits"])
    peak_fall = base6["peak"] - stats["peak"]
    print(f"[13b llava int8] first-pass logits vs step 6's bf16: cos {cos:.6f} (bar > 0.98) | "
          f"peak memory {stats['peak'] / 2**30:.2f} GiB vs step 6's "
          f"{base6['peak'] / 2**30:.2f} GiB: down {peak_fall / 1e9:.3f} GB (bar >= 90% of "
          f"the {fall / 1e9:.3f} GB quantized)")
    check(cos > 0.98, "13b: int8 logits too far from bf16")
    check(peak_fall >= 0.9 * fall, "13b: peak memory did not fall with the int8 weights")

    reqs = _serve_requests(backend, 32, seed=1)
    serve, _, s = _serve_run("13b llava int8 serve", backend, reqs, slots=16,
                             int8_per_step=per_step)
    s["tick_ms"] = _time_tick("13b llava int8 serve", backend, reqs, slots=16)
    print(f"[13b llava int8 serve] +int8+kv8+flash {s['tok_s']:.1f} tok/s, TTFT p50 "
          f"{s['ttft_p50'] * 1e3:.1f} / p95 {s['ttft_p95'] * 1e3:.1f} ms, "
          f"{s['step_ms']:.1f} ms per decode step, steady tick {s['tick_ms']:.1f} ms, peak "
          f"{s['peak'] / 2**30:.2f} GiB | step 8 (+kv8+flash, bf16): {base8['tok_s']:.1f} "
          f"tok/s, TTFT p50 {base8['ttft_p50'] * 1e3:.1f} / p95 {base8['ttft_p95'] * 1e3:.1f} "
          f"ms, {base8['step_ms']:.1f} ms per decode step, steady tick "
          f"{base8['tick_ms']:.1f} ms, peak {base8['peak'] / 2**30:.2f} GiB")

    head_fall = _quantize_in_place("13b llava lm8", backend, text, int8=False, lm8=True)
    lm8, lm8_stats = _drive("13b llava int8+lm8", TimedBackend(backend), 24, _counters(),
                            want, int8_want=(per_step + 1) * 2 * (1 + steps))
    _print_pipeline_beside("13b llava int8+lm8", lm8_stats, stats, "+int8 (dense head)",
                           2 * 4 * steps)
    cos_head = _cos(_first_pass_logits(backend), logits)
    print(f"[13b llava int8+lm8] logits vs the dense head's: cos {cos_head:.6f} (bar > 0.999)"
          f" | the head's {head_fall / 1e9:.3f} GB quantized")
    check(cos_head > 0.999, "13b: the int8 head's logits too far from the dense head's")
    return {"llava_int8": launches, "llava_int8_serve": serve, "llava_int8_lm8": lm8}


def phase_qwen_int8(backend, base7):
    """13c: step 7's Qwen2-VL-7B weights, quantized in place after its serve
    run (``+int8+lm8+kv8+flash``, 672 px): one warm-up and one timed
    pipeline run."""
    L, steps = backend.model.cfg.text.num_hidden_layers, 20
    fall = _quantize_in_place("13c qwen int8+lm8", backend, backend.model.params["text"],
                              lm8=True)
    backend.kv_quant, backend.use_flash = True, True
    want = {"warp_resample": 1, "flash_prefill": 2 * L,
            "decode_attn_int8": steps * (L - 1) + steps * L}
    launches, stats = _drive("13c qwen int8+lm8", TimedBackend(backend),
                             backend.num_patches_side, _counters(), want,
                             int8_want=(7 * L + 1) * 2 * (1 + steps))
    _print_pipeline_beside("13c qwen int8+lm8", stats, base7, "step 7 (bf16 +kv8+flash)",
                           2 * 4 * steps)
    cos = _cos(_first_pass_logits(backend), base7["logits"])
    peak_fall = base7["peak"] - stats["peak"]
    print(f"[13c qwen int8+lm8] first-pass logits vs step 7's bf16: cos {cos:.6f} (bar > "
          f"0.98) | peak memory {stats['peak'] / 2**30:.2f} GiB vs step 7's "
          f"{base7['peak'] / 2**30:.2f} GiB: down {peak_fall / 1e9:.3f} GB (bar >= 90% of "
          f"the {fall / 1e9:.3f} GB quantized)")
    check(cos > 0.98, "13c: int8 logits too far from bf16")
    check(peak_fall >= 0.9 * fall, "13c: peak memory did not fall with the int8 weights")
    return {"qwen_int8_lm8": launches}


def phase_hf():
    """13d, in a child process (``transformers`` is imported there only):
    see ``hf_child``. Returns the launch counts of its ``+int8`` extract."""
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.hf_child()"],
                          capture_output=True, text=True, timeout=900,
                          cwd=Path(__file__).resolve().parent)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"[13d hf] {line}")
    check(proc.returncode == 0 and lines, f"13d failed: {proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def _hf_configs():
    """(name, model class, config, extract layer, 7B width) of the random
    HF checkpoints of step 13d: both families at the CPU parity tests'
    geometry, and LLaVA-1.5-7B's widths with 2 vision and 2 decoder
    layers."""
    import transformers as tf

    tiny_llava = tf.LlavaConfig(
        vision_config=tf.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                          num_hidden_layers=3, num_attention_heads=2,
                                          image_size=28, patch_size=14, projection_dim=32),
        text_config=tf.LlamaConfig(vocab_size=128, hidden_size=48, intermediate_size=96,
                                   num_hidden_layers=3, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=256,
                                   rms_norm_eps=1e-5),
        image_token_index=99, vision_feature_layer=-2, vision_feature_select_strategy="default")
    tiny_llava.image_token_id = 99
    tiny_qwen = tf.Qwen2VLConfig(
        text_config=dict(vocab_size=128, hidden_size=48, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         rms_norm_eps=1e-6, rope_theta=10000.0,
                         rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]},
                         max_position_embeddings=512),
        vision_config=dict(depth=2, embed_dim=32, hidden_size=48, num_heads=2, in_channels=3,
                           patch_size=14, spatial_merge_size=2, temporal_patch_size=2,
                           mlp_ratio=2, hidden_act="quick_gelu"),
        image_token_id=97, video_token_id=98, vision_start_token_id=96)
    wide_llava = tf.LlavaConfig(
        vision_config=tf.CLIPVisionConfig(hidden_size=1024, intermediate_size=4096,
                                          num_hidden_layers=2, num_attention_heads=16,
                                          image_size=336, patch_size=14, projection_dim=768),
        text_config=tf.LlamaConfig(vocab_size=32064, hidden_size=4096, intermediate_size=11008,
                                   num_hidden_layers=2, num_attention_heads=32,
                                   num_key_value_heads=32, max_position_embeddings=4096,
                                   rms_norm_eps=1e-5),
        image_token_index=32000, vision_feature_layer=-2,
        vision_feature_select_strategy="default")
    wide_llava.image_token_id = 32000
    return (("llava_tiny", tf.LlavaForConditionalGeneration, tiny_llava, 1, False),
            ("qwen2vl_tiny", tf.Qwen2VLForConditionalGeneration, tiny_qwen, 1, False),
            ("llava7b_width", tf.LlavaForConditionalGeneration, wide_llava, 1, True))


def _hf_inputs(name, cfg, dev, forward):
    """Seeded inputs for one HF forward (``forward``, the HF model's):
    (its kwargs, the port's forward arguments)."""
    import inspect

    import numpy as np
    import torch

    from attwarp_tpu_torch.models.qwen2vl import patchify_image

    rng = np.random.default_rng(13)
    if name.startswith("qwen2vl"):
        patches, grid = patchify_image(rng.random((56, 56, 3)).astype(np.float32), cfg.vision)
        ids = rng.integers(3, 90, size=(2, 14)).astype(np.int64)
        ids[:, 2] = cfg.vision_start_token_id
        ids[:, 3:7] = cfg.image_token_id
        ids_t = torch.as_tensor(ids, device=dev)
        mask = torch.ones_like(ids_t)
        hf_kw = dict(input_ids=ids_t, attention_mask=mask,
                     pixel_values=torch.as_tensor(np.concatenate([patches, patches]), device=dev),
                     image_grid_thw=torch.tensor([list(grid)] * 2, device=dev))
        if "mm_token_type_ids" in inspect.signature(forward).parameters:
            # transformers 5.x: which tokens are image tokens (1) for M-RoPE,
            # as its processor returns them
            hf_kw["mm_token_type_ids"] = (ids_t == cfg.image_token_id).long()
        return hf_kw, (ids_t, torch.as_tensor(np.stack([patches, patches]), device=dev), grid,
                       mask.bool())
    n_img, S = cfg.num_image_tokens, cfg.vision.image_size
    ids = rng.integers(3, 90, size=(2, n_img + 9)).astype(np.int64)
    ids[:, 1:1 + n_img] = cfg.image_token_index
    ids = np.concatenate([np.zeros((2, 3), np.int64), ids], axis=1)   # row 1 left-padded
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    pixels = torch.as_tensor(rng.standard_normal((2, 3, S, S)).astype(np.float32), device=dev)
    ids_t, mask_t = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
    hf_kw = dict(input_ids=ids_t, pixel_values=pixels, attention_mask=mask_t)
    return hf_kw, (ids_t, pixels.permute(0, 2, 3, 1), mask_t.bool())


def hf_child():
    """13d: random HF checkpoints (``_hf_configs``) written by
    ``save_pretrained`` under ``build/chip_smoke/``, loaded on the card by
    ``make_backend("<family>:<dir>")`` (f32) and ``"<family>:<dir>+int8+kv8
    +flash"``: the f32 load's last-token logits against the HF model's own
    forward on the card (f32, eager attention, TF32 off) within the LLaVA
    parity bars (atol 2e-4, rtol 1e-3); the int8 load's tree in int8 on the
    card; at LLaVA-1.5-7B width one ``extract`` through K2, K3 and the int8
    product, with its launch counts (the last line of stdout)."""
    import numpy as np
    import torch
    import transformers

    from attwarp_tpu_torch.cli.process_dataset import make_backend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8
    from attwarp_tpu_torch.kernels.flash_prefill import flash_prefill
    from attwarp_tpu_torch.kernels.warp_resample import warp_resample
    from attwarp_tpu_torch.numerics.quant import int8_matmul, is_quantized

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(f"transformers {transformers.__version__}, torch {torch.__version__}")
    counts = {}
    for name, cls, hf_cfg, layer, wide in _hf_configs():
        t0 = time.perf_counter()
        torch.manual_seed(0)
        hf = cls(hf_cfg).eval()
        d = _scratch(f"hf_{name}")
        hf.save_pretrained(str(d))
        family = "qwen2vl" if name.startswith("qwen2vl") else "llava"
        t1 = time.perf_counter()
        be = make_backend(f"{family}:{d}", layer, dev)
        t2 = time.perf_counter()
        leaves = list(_leaves(be.model.params))
        check(all(t.device.type == dev.type and t.dtype == torch.float32 for t in leaves),
              f"{name}: the f32 load is not f32 on the card")
        if hasattr(hf, "set_attn_implementation"):
            hf.set_attn_implementation("eager")
        else:
            hf.config._attn_implementation = "eager"
        hf = hf.to(dev)
        hf_kw, ours = _hf_inputs(name, be.model.cfg, dev, hf.forward)
        with torch.no_grad():
            ref = hf(**hf_kw).logits[:, -1].float()
            got, _ = be.model.forward_logits(*ours)
        err = (got - ref).abs()
        ok = bool((err <= 2e-4 + 1e-3 * ref.abs()).all())
        tc = be.model.cfg.text
        print(f"{name}: saved in {t1 - t0:.1f} s, '{family}:<dir>' loaded in {t2 - t1:.1f} s "
              f"({sum(t.numel() for t in leaves) / 1e6:.1f} M parameters, f32 on {dev}; rope "
              f"theta {tc.rope_theta}{', mrope ' + str(tc.mrope_section) if family == 'qwen2vl' else ''}); "
              f"last-token logits vs HF's forward (f32, eager): max|d| {err.max().item():.3g}, "
              f"max|ref| {ref.abs().max().item():.3g} (bar atol 2e-4 + rtol 1e-3): "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: logits disagree with HF's")
        del hf, be, leaves
        torch.cuda.empty_cache()
        be = make_backend(f"{family}:{d}+int8+kv8+flash", layer, dev)
        text = be.model.params["text" if family == "qwen2vl" else "llama"]
        check(all(is_quantized(lp["down_proj"]) and lp["down_proj"]["q"].device.type == dev.type
                  for lp in text["layers"]), f"{name}: +int8 did not quantize on the card")
        check(be.kv_quant and be.use_flash, f"{name}: +kv8+flash not set")
        if wide:
            be.tokenizer = DryRunTokenizer()
            fns = (warp_resample, flash_prefill, decode_attn_int8, int8_matmul)
            for fn in fns:
                fn.launches = 0
            steps, L = 4, be.model.cfg.text.num_hidden_layers
            maps, texts = be.extract(_images(), QUESTIONS, max_new_tokens=steps)
            torch.cuda.synchronize()
            counts = {fn.__name__: fn.launches for fn in fns}
            want = {"warp_resample": 0, "flash_prefill": L,
                    "decode_attn_int8": steps * (L - 1), "int8_matmul": 7 * L * (1 + steps)}
            print(f"{name} +int8+kv8+flash extract: maps {tuple(maps.shape)}, answers {texts} | "
                  "launches: " + ", ".join(f"{k} {counts[k]} (expected {want[k]})"
                                           for k in want))
            m = maps.float().cpu().numpy()
            check(m.shape == (4, 24, 24) and bool(np.isfinite(m).all())
                  and np.allclose(m.sum(axis=(1, 2)), 1.0, atol=1e-3), f"{name}: maps")
            check(counts == want, f"{name}: launch counts")
        del be, text
        torch.cuda.empty_cache()
    print(json.dumps({"hf_llava7b_width": counts}))


# ── step 15: the parallel layer on one card ─────────────────────────────

# 15a's floor on the cos of the bf16 tensor-parallel prefill maps against
# the unsharded ones
P15_ROWS_FLOOR = 0.995


def _p15_cfg(depth=None):
    """LLaVA-1.5-7B geometry (step 6's), or cut to ``depth`` vision and
    decoder layers."""
    import dataclasses

    from attwarp_tpu_torch.models.llama import LlamaConfig
    from attwarp_tpu_torch.models.llava import LlavaConfig

    cfg = LlavaConfig(text=LlamaConfig(vocab_size=32064), image_token_index=32000)
    if depth is None:
        return cfg
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=depth),
        text=dataclasses.replace(cfg.text, num_hidden_layers=depth))


def _p15_model(depth, dtype, dev):
    """Seeded random LLaVA weights on the card: full depth in bf16 (step 6's
    seed), or ``depth`` layers in f32 (seed 5); the config and the tree."""
    import torch

    from attwarp_tpu_torch.models.llava import random_params

    cfg = _p15_cfg(depth)
    seed = 0 if depth is None else 5
    return cfg, random_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev, dtype)


def _p15_backend(cfg, params, layer):
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.models.llava import LlavaModel

    return LlavaBackend(LlavaModel(cfg, params), tokenizer=DryRunTokenizer(),
                        extract_layer=layer, kv_quant=True, use_flash=True)


def _p15_generate(backend, kernels=True, steps=20):
    """The first pass of the pipeline as a direct generate: 4 images, 640-
    token prompts, ``steps`` new tokens, ``+kv8+flash`` (or, without
    ``kernels``, the dense cache and prefill: no K2, no K3); (tokens, maps)
    on the host and the prompt length. At ``steps=0`` the maps are the
    prefill's rows alone, where no token can turn."""
    import torch

    from attwarp_tpu_torch.extract.resize import resize_images_batch

    pix = resize_images_batch(_images(), backend.image_size, backend.device)
    ids, mask, start, pixels = backend._prepare(pix, QUESTIONS)
    with torch.no_grad():
        gen, maps = backend.model.generate_with_attention(
            ids, pixels, mask, start, extract_layer=backend.extract_layer, max_new_tokens=steps,
            kv_quant=kernels, use_flash=kernels)
    return gen.cpu(), maps.float().cpu(), ids.shape[1]


def _p15_sp_inputs(llama, dev):
    """15b's prompt: the embeddings of seeded random token ids (B=4,
    T=640), left padding per row."""
    import torch

    from attwarp_tpu_torch.models.llama import embed

    g = torch.Generator(device=dev).manual_seed(21)
    ids = torch.randint(3, 32000, (4, 640), generator=g, device=dev)
    pad = torch.tensor([(37 * b) % 61 for b in range(4)], device=dev)[:, None]
    return embed(llama, ids), torch.arange(640, device=dev)[None] >= pad


def _p15_warp_inputs(dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(41)
    return (torch.rand((4, 512, 640, 3), generator=g, device=dev) * 255,
            torch.rand((4, 24, 24), generator=g, device=dev))


def _p15_train_batch(dev, B=16, seed=31):
    """A batch at ``TrainConfig()``'s width: 512 px images and attention,
    LLaVA-1.5-7B's feature widths (CLIP 24x24x1024, text 4096)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.rand(shape, generator=g, device=dev)

    ar = torch.arange(B, device=dev)
    return {"image": r(B, 512, 512, 3), "attention_map": r(B, 512, 512),
            "sqrt_mask": (ar % 2).float(), "none_mask": (ar % 4 == 3).float(),
            "fmap_v": r(B, 24, 24, 1024), "ttok": r(B, 32, 4096),
            "tmask": torch.ones((B, 32, 1), device=dev)}


def _p15_decode(llama, cfg, cache, logits, mask, steps=20):
    """Greedy decode steps from a prefill cache; the tokens (B, steps + 1)."""
    import torch

    from attwarp_tpu_torch.models.llama import embed, llama_decode_step

    B, T = mask.shape
    full = torch.nn.functional.pad(mask, (0, cache[0].shape[2] - T))
    lengths = mask.sum(dim=1)
    tok = torch.argmax(logits, dim=-1)
    toks = [tok]
    for step in range(steps):
        full[:, T + step] = True
        logits, cache, _ = llama_decode_step(llama, cfg, embed(llama, tok)[:, None], cache,
                                             T + step, lengths + step, full)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1).cpu()


def _p15_reset(counters):
    import torch

    from attwarp_tpu_torch.parallel.comm import host_staged

    for fn in counters.values():
        fn.launches = 0
    host_staged.calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def _p15_read(counters, t0):
    import torch

    from attwarp_tpu_torch.parallel.comm import host_staged

    torch.cuda.synchronize()
    return {"wall": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated(),
            "staged": host_staged(), **{k: fn.launches for k, fn in counters.items()}}


def _p15_train(batches, mesh_shape, dev, dtype):
    """Sharded MarginalNet steps at ``TrainConfig()`` width, one on each of
    ``batches``, computing in ``dtype``, on a (data, model) mesh beside as
    many one-device steps from the same init: each step's metrics on both
    sides, the parameters' max |difference| after the last step, and the
    cosine between the two parameter changes (all steps; the last step
    alone, which reads the AdamW moments of the steps before)."""
    import torch

    from attwarp_tpu_torch.marginalnet.model import MarginalNet
    from attwarp_tpu_torch.parallel.mesh import gather_state_dict, make_mesh
    from attwarp_tpu_torch.train.config import TrainConfig
    from attwarp_tpu_torch.train.train_step import (
        TrainState,
        make_optimizer,
        make_sharded_train_step,
        train_step,
    )

    from attwarp_tpu_torch.parallel.mesh import shard_batch

    cfg = TrainConfig()
    steps = len(batches)

    def net():
        return MarginalNet(batches[0]["fmap_v"].shape[-1], batches[0]["ttok"].shape[-1],
                           cfg.hidden,
                           eps=cfg.eps, compute_dtype=dtype,
                           generator=torch.Generator().manual_seed(cfg.seed)).to(dev)

    def snap(sd):
        return {k: v.detach().float().clone() for k, v in sd.items()}

    one = net()
    init = snap(one.state_dict())
    state = TrainState(0, one, make_optimizer(cfg, one))
    ref, ref_sd = [], []
    for batch in batches:
        state, m = train_step(state, batch, cfg)
        ref.append({k: float(v) for k, v in m.items()})
        ref_sd.append(snap(one.state_dict()))
    mesh = make_mesh(*mesh_shape)
    sharded = net()
    fn, s, _ = make_sharded_train_step(
        sharded, cfg, mesh, TrainState(0, sharded, make_optimizer(cfg, sharded)), batches[0])
    got, got_sd = [], []
    for batch in batches:
        s, m = fn(s, shard_batch(batch, mesh))
        got.append({k: float(v) for k, v in m.items()})
        got_sd.append(snap(gather_state_dict(sharded, mesh)))

    def change(sds, a, b):
        return torch.cat([(sds[b][k] - (sds[a][k] if a >= 0 else init[k])).flatten()
                          for k in init])

    def cos(a, b):
        return _cos(change(got_sd, a, b), change(ref_sd, a, b))

    d = max((got_sd[-1][k] - ref_sd[-1][k]).abs().max().item() for k in init)
    return {"got": got, "ref": ref, "d": d, "cos_all": cos(-1, steps - 1),
            "cos_last": cos(steps - 2, steps - 1)}


def _phase15_rank(rank, world, dev):
    """One of 15's two ranks sharing ``dev`` (cuda:0) over gloo (see
    ``phase_parallel``)."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.parallel.llava_sharding import shard_llava_params
    from attwarp_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from attwarp_tpu_torch.parallel.sp_prefill import sp_prefill
    from attwarp_tpu_torch.parallel.warp_sharded import make_sharded_warp
    from attwarp_tpu_torch.pipeline import AttWarpPipeline
    from attwarp_tpu_torch.models.llama import llama_prefill

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _tower_counters()
    out = {}
    tp = make_mesh(n_data=1, n_model=2)
    sp_mesh = make_mesh(n_data=2, n_model=1)

    # 15a, f32 at 2 + 2 layers, then bf16 at full depth: generate, pipeline
    cfg_s, small = _p15_model(2, torch.float32, dev)
    be = _p15_backend(cfg_s, shard_llava_params(small, tp, cfg_s), 1)
    out["a_small"] = _p15_generate(be)
    out["a_small_f32"] = _p15_generate(be, kernels=False)
    del be
    cfg, full = _p15_model(None, torch.bfloat16, dev)
    layer = 20
    tree = shard_llava_params(full, tp, cfg)
    backend = TimedBackend(_p15_backend(cfg, tree, layer))
    out["a_full"] = _p15_generate(backend)
    out["a_full_rows"] = _p15_generate(backend, steps=0)
    # a planted fault for the prefill maps' floor, a wrong cut of the heads:
    # every decoder layer of this rank reads the other rank's kv heads
    kv = cfg.text.kv_heads // 2 * cfg.text.head_dim
    wrong = dict(tree, llama=dict(tree["llama"], layers=[
        dict(lp, **{k: full["llama"]["layers"][i][k].narrow(0, (1 - rank) * kv, kv)
                    for k in ("k_proj", "v_proj")})
        for i, lp in enumerate(tree["llama"]["layers"])]))
    out["a_wrong_rows"] = _p15_generate(_p15_backend(cfg, wrong, layer), steps=0)
    del wrong, tree
    pipe = AttWarpPipeline(backend, warp_size=500, max_new_tokens=20)
    t0 = _p15_reset(counters)
    res = pipe.run(_images(), QUESTIONS)
    out["a_pipe"] = {**_p15_read(counters, t0), "pass1": backend.seconds["pass1"],
                     "pass2": backend.seconds["pass2"],
                     "maps": res.attention_maps, "warped_shape": res.warped.shape,
                     "warped_finite": bool(np.isfinite(res.warped).all()),
                     "answers": res.second_answers}
    del backend, pipe, res
    torch.cuda.empty_cache()

    # 15b, sequence-parallel prefill (kv_quant), f32 at 2 layers then bf16
    emb, mask = _p15_sp_inputs(small["llama"], dev)
    logits, cache, rows = sp_prefill(small["llama"], cfg_s.text, emb, mask, sp_mesh,
                                     max_seq=704, extract_layer=1, kv_quant=True)
    out["b_small"] = (logits.cpu(), [c.cpu() for c in cache], rows.cpu())
    del small, emb, logits, cache, rows
    emb, mask = _p15_sp_inputs(full["llama"], dev)
    t0 = _p15_reset(counters)
    logits, cache, rows = sp_prefill(full["llama"], cfg.text, emb, mask, sp_mesh,
                                     max_seq=704, extract_layer=layer, kv_quant=True)
    ring = _p15_read(counters, t0)
    t0 = _p15_reset(counters)
    toks = _p15_decode(full["llama"], cfg.text, cache, logits, mask)
    out["b_decode"] = {**_p15_read(counters, t0), "ring_wall": ring["wall"],
                       "ring_peak": ring["peak"], "ring_staged": ring["staged"],
                       "tokens": toks, "logits": logits.float().cpu(), "rows": rows.cpu()}
    del cache
    if rank == 0:
        # the dense prefill on the same weights and inputs, and its decode
        dl, dc, dr = llama_prefill(full["llama"], cfg.text, emb, mask, max_seq=704,
                                   extract_layer=layer, kv_quant=True)
        out["b_dense"] = {"logits": dl.float().cpu(), "rows": dr.cpu(),
                          "tokens": _p15_decode(full["llama"], cfg.text, dc, dl, mask)}
        del dc
    del full, emb
    torch.cuda.empty_cache()

    # 15d, the data-parallel warp, then the sharded train step at (2, 1), (1, 2)
    images, atts = _p15_warp_inputs(dev)
    b = shard_batch({"i": images, "a": atts}, sp_mesh)
    t0 = _p15_reset(counters)
    warped = make_sharded_warp(sp_mesh, 500, 500, gather=True)(b["i"], b["a"])
    out["d_warp"] = {**_p15_read(counters, t0), "warped": warped.cpu()}
    batches = [_p15_train_batch(dev), _p15_train_batch(dev, seed=32)]
    # one step in bf16 (JAX's bars), then two in f32 on two batches (the
    # update and the moments held)
    out["d_train"] = {(shape, dtype): _p15_train(batches[:n], shape, dev, dtype)
                      for shape in ((2, 1), (1, 2))
                      for dtype, n in ((torch.bfloat16, 1), (torch.float32, 2))}
    out["jax"] = any(m == "jax" or m.startswith(("jax.", "attwarp_tpu.")) or m == "attwarp_tpu"
                     for m in sys.modules)
    return out


def _phase15_nccl(rank, world, dev):
    """15e: one rank on NCCL (world size 1, ``dev``): the collectives NCCL
    takes on CUDA tensors, then 15a-15d's code at 2 layers on a (1, 1)
    mesh."""
    import torch
    import torch.distributed as dist

    from attwarp_tpu_torch.parallel.llava_sharding import shard_llava_params
    from attwarp_tpu_torch.parallel.mesh import make_mesh
    from attwarp_tpu_torch.parallel.sp_prefill import sp_prefill
    from attwarp_tpu_torch.parallel.warp_sharded import make_sharded_warp

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    x = torch.arange(8.0, device=dev)
    dist.all_reduce(x)
    gathered = [torch.empty(8, device=dev)]
    dist.all_gather(gathered, x)
    dist.broadcast(x, src=0)
    backend = dist.get_backend()
    mesh = make_mesh(1, 1)
    cfg_s, small = _p15_model(2, torch.float32, dev)
    gen, maps, _ = _p15_generate(_p15_backend(cfg_s, shard_llava_params(small, mesh, cfg_s), 1))
    emb, mask = _p15_sp_inputs(small["llama"], dev)
    logits, _, rows = sp_prefill(small["llama"], cfg_s.text, emb, mask, mesh, max_seq=704,
                                 extract_layer=1, kv_quant=True)
    images, atts = _p15_warp_inputs(dev)
    warped = make_sharded_warp(mesh, 500, 500, gather=True)(images, atts)
    train = _p15_train([_p15_train_batch(dev, B=4)], (1, 1), dev, torch.bfloat16)
    return {"backend": backend, "collectives_ok": bool(torch.equal(x, gathered[0])),
            "gen": gen, "maps": maps, "logits": logits.cpu(), "rows": rows.cpu(),
            "warped": warped.cpu(), "train": train}


def _train_ok(res, dtype) -> bool:
    """JAX's bars (``tests/test_train_step.py``) on every run: the first
    loss within rtol 2e-2 and the parameters within 5e-2 of the one-device
    steps'. In f32 also every metric of every step within 1e-5 relative
    (``tests/test_torch_parallel.py``'s bar) and both parameter changes
    within cos 0.999 of the one-device ones: a step that skips the update,
    or moments cut from the wrong slice, moves the parameters elsewhere."""
    ref, got = res["ref"][0]["loss/total"], res["got"][0]["loss/total"]
    import torch

    ok = abs(got - ref) <= 2e-2 * abs(ref) and res["d"] <= 5e-2
    if dtype == torch.float32:
        ok = (ok and _metrics_rel(res) <= 1e-5 and res["cos_all"] > 0.999
              and res["cos_last"] > 0.999)
    return ok


def _metrics_rel(res) -> float:
    """The largest relative difference of any metric of any step."""
    return max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-9)
               for g, r in zip(res["got"], res["ref"]) for k in r)


def phase_parallel(dev):
    """Step 15 (see the module docstring): references in this process, then
    two gloo ranks on ``dev`` (15a, 15b, 15d) and one NCCL rank (15e)."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.kernels.warp_resample import warp_resample
    from attwarp_tpu_torch.models.llama import flash_prefill_supported, llama_prefill
    from attwarp_tpu_torch.models.llava import LlavaModel
    from attwarp_tpu_torch.serving import DisaggServeEngine, ServeEngine, split_devices
    from attwarp_tpu_torch.testing.ranks import run_ranks
    from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

    counters = _tower_counters()
    paths = {}
    # the unsharded references, on the same seeded weights
    cfg_s, small = _p15_model(2, torch.float32, dev)
    be = _p15_backend(cfg_s, small, 1)
    ref_small = _p15_generate(be)
    # the same weights with no kernel on the path: f32 throughout (K2 and
    # K3 compute in bf16 whatever their inputs)
    ref_small_f32 = _p15_generate(be, kernels=False)
    del be
    emb, mask = _p15_sp_inputs(small["llama"], dev)
    dl, dc, dr = llama_prefill(small["llama"], cfg_s.text, emb, mask, max_seq=704,
                               extract_layer=1, kv_quant=True)
    ref_sp = (dl.cpu(), [c.cpu() for c in dc], dr.cpu(), mask.cpu())
    del small, emb, dl, dc, dr
    cfg, full = _p15_model(None, torch.bfloat16, dev)
    L = cfg.text.num_hidden_layers
    fails = []

    def bar(cond, what):
        # every rank's figures are printed before the step fails
        if not cond:
            fails.append(what)

    backend = _p15_backend(cfg, full, 20)
    ref_full = _p15_generate(backend)
    ref_rows = _p15_generate(backend, steps=0)
    # the code's launch counts for a two-pass pipeline run on these prompts
    k2_pass = L if flash_prefill_supported(ref_full[2]) else 0

    # 15c: DisaggServeEngine, both groups on cuda:0, against ServeEngine
    decode_devs, prefill_devs = split_devices([dev, dev])
    check(decode_devs == prefill_devs == [dev], "15c: split_devices")
    prefill_model = LlavaModel(cfg, {k: _clone_tree(v) for k, v in full.items()})
    reqs = _serve_requests(backend, 16, seed=15)
    kw = dict(slots=8, max_seq=768, kv_quant=True, use_flash=True, steps_per_tick=8)
    outs = {}
    for name, eng in (("serve", ServeEngine(backend.model, **kw)),
                      ("disagg", DisaggServeEngine(backend.model, prefill_model, **kw))):
        t0 = _p15_reset(counters)
        rids = [eng.submit(r["input_ids"], r["pixel_values"], r["max_new_tokens"]) for r in reqs]
        res = eng.run()
        got = _p15_read(counters, t0)
        outs[name] = [res[r] for r in rids]
        want = {"warp_resample": 0, "flash_prefill": L * eng.prefill_groups,
                "decode_attn_int8": L * eng.decode_steps,
                "scaled_softmax_": _k4_want(cfg.vision, len(reqs), eng.prefill_groups)}
        n_tok = sum(len(o) for o in outs[name])
        print(f"[15c {name}] 16 requests, 8 slots, {n_tok} tokens in {got['wall']:.3f} s "
              f"({n_tok / got['wall']:.1f} tok/s), {eng.prefill_groups} admission groups, "
              f"{eng.decode_steps} decode steps, peak {got['peak'] / 2**30:.2f} GiB | launches: "
              + ", ".join(f"{k} {got[k]} (expected {want[k]})" for k in want)
              + (f" | KV blocks moved {eng.kv_transfers}" if name == "disagg" else ""))
        for k in want:
            check(got[k] == want[k], f"15c {name}: {k} launch count")
        if name == "disagg":
            paths["disagg"] = {k: got[k] for k in want}
            check(eng.kv_transfers == eng.prefill_groups, "15c: one KV move per group")
    same = sum(a == b for a, b in zip(outs["serve"], outs["disagg"]))
    print(f"[15c disagg] {same}/16 requests token-identical to ServeEngine's")
    check(same == 16, "15c: disaggregated tokens differ from ServeEngine's")
    del backend, prefill_model, full, eng
    gc.collect()
    torch.cuda.empty_cache()

    # 15d's reference: the unsharded K1 on the same images
    images, atts = _p15_warp_inputs(dev)
    ref_warp = warp_batch_by_attention(images, atts, 500, 500).cpu()
    del images, atts
    warp_resample.launches = 0
    torch.cuda.empty_cache()
    print(f"[15] references done; memory held {torch.cuda.memory_allocated() / 2**30:.2f} GiB; "
          f"spawning 2 gloo ranks on {dev}")

    t0 = time.perf_counter()
    ranks = run_ranks(_phase15_rank, 2, (dev,), backend="gloo", timeout=900)
    print(f"[15] 2 ranks done in {time.perf_counter() - t0:.2f} s")
    n_side = cfg.vision.image_size // cfg.vision.patch_size
    for r, out in enumerate(ranks):
        bar(not out["jax"], f"15: rank {r} imported JAX")
        # 15a
        gen, maps, _ = out["a_small_f32"]
        d = (maps - ref_small_f32[1]).abs().max().item()
        print(f"[15a rank {r}] f32 2+2 layers, n_model=2, dense cache and prefill (f32 "
              f"throughout): tokens {'identical' if torch.equal(gen, ref_small_f32[0]) else 'DIFFER'}"
              f", maps max|d| {d:.3g} (bar 1e-5)")
        bar(torch.equal(gen, ref_small_f32[0]) and d <= 1e-5, "15a: f32 TP disagrees")
        gen, maps, _ = out["a_small"]
        d = (maps - ref_small[1]).abs().max().item()
        # K2 and K3 round q, k and v to bf16: the unsharded model's own
        # distance from f32 sets the scale of what the kernels may move
        noise = (ref_small[1] - ref_small_f32[1]).abs().max().item()
        print(f"[15a rank {r}] f32 2+2 layers, n_model=2, +kv8+flash: tokens "
              f"{'identical' if torch.equal(gen, ref_small[0]) else 'DIFFER'}, maps max|d| "
              f"{d:.3g} from the unsharded +kv8+flash (bar max(1e-5, 1.5 x {noise:.3g}, the "
              f"unsharded +kv8+flash's distance from f32))")
        bar(torch.equal(gen, ref_small[0]) and d <= max(1e-5, 1.5 * noise),
            "15a: f32 TP +kv8+flash disagrees")
        gen, maps, _ = out["a_full"]
        same = [b for b in range(4) if torch.equal(gen[b], ref_full[0][b])]
        cos = [_cos(maps[b], ref_full[1][b]) for b in range(4)]
        print(f"[15a rank {r}] bf16 full depth, n_model=2: samples with the unsharded "
              f"tokens {same}, maps cos on them {[f'{cos[b]:.6f}' for b in same]} (bar "
              f"0.999); the others {[f'{cos[b]:.6f}' for b in range(4) if b not in same]}")
        bar(all(cos[b] > 0.999 for b in same), "15a: bf16 TP maps drift")
        rows = out["a_full_rows"][1]
        cos = [_cos(rows[b], ref_rows[1][b]) for b in range(4)]
        wrong = [_cos(out["a_wrong_rows"][1][b], ref_rows[1][b]) for b in range(4)]
        # a floor against a wrong cut of the heads: the planted one (each
        # rank reading the other's kv heads) must fall below it
        print(f"[15a rank {r}] bf16 full depth, n_model=2, the prefill's layer-20 maps (no "
              f"token to turn): cos {[f'{c:.6f}' for c in cos]} (bar {P15_ROWS_FLOOR}); with "
              f"the planted wrong cut of the kv heads {[f'{c:.6f}' for c in wrong]} (must be "
              f"below the bar)")
        bar(min(cos) > P15_ROWS_FLOOR, "15a: bf16 TP prefill maps drift")
        bar(max(wrong) < P15_ROWS_FLOOR, "15a: the prefill maps' floor misses a wrong cut")
        p = out["a_pipe"]
        want = {"warp_resample": 1, "flash_prefill": 2 * k2_pass,
                "decode_attn_int8": 20 * (L - 1) + 20 * L,
                "scaled_softmax_": _k4_want(cfg.vision, 8, 2)}
        print(f"[15a rank {r}] two-pass pipeline: wall {p['wall']:.3f} s (pass 1 "
              f"{p['pass1']:.3f}, pass 2 {p['pass2']:.3f}; {4 / p['wall']:.3f} samples/s), "
              f"peak {p['peak'] / 2**30:.2f} GiB, gloo host-staged collectives {p['staged']} "
              f"| launches: " + ", ".join(f"{k} {p[k]} (expected {want[k]})" for k in want))
        bar(p["maps"].shape == (4, n_side, n_side) and bool(np.isfinite(p["maps"]).all())
              and p["warped_shape"] == (4, 500, 500, 3) and p["warped_finite"],
              "15a: pipeline outputs")
        for k in want:
            bar(p[k] == want[k], f"15a: {k} launch count")
        paths[f"tp_llava_r{r}"] = {k: p[k] for k in want}
        # 15b
        logits, cache, rows = out["b_small"]
        dl, dc, dr, m = ref_sp
        el, er = (logits - dl).abs().max().item(), (rows - dr).abs().max().item()
        valid = m.cpu()
        lsb = max((a[:, :, :640][:, valid].int() - b[:, :, :640][:, valid].int()).abs().max().item()
                  for a, b in ((cache[0], dc[0]), (cache[2], dc[2])))
        es = max((a[:, :, :640][:, valid] - b[:, :, :640][:, valid]).abs().max().item()
                 for a, b in ((cache[1], dc[1]), (cache[3], dc[3])))
        print(f"[15b rank {r}] sp_prefill n=2, f32 2 layers, kv_quant: logits max|d| {el:.3g}, "
              f"rows {er:.3g} (bar 1e-4); int8 cache max {lsb} LSB (bar 1), scales max|d| "
              f"{es:.3g}")
        bar(el <= 1e-4 and er <= 1e-4 and lsb <= 1, "15b: f32 ring prefill disagrees")
        bd = out["b_decode"]
        print(f"[15b rank {r}] bf16 full depth: ring prefill wall {bd['ring_wall']:.3f} s "
              f"(peak {bd['ring_peak'] / 2**30:.2f} GiB, gloo host-staged collectives "
              f"{bd['ring_staged']}); 20 decode steps from its int8 cache {bd['wall']:.3f} s, "
              f"K3 {bd['decode_attn_int8']} (expected {20 * L})")
        bar(bd["decode_attn_int8"] == 20 * L and bd["flash_prefill"] == 0, "15b: launches")
        paths[f"sp_decode_r{r}"] = {k: bd[k] for k in counters}
        # 15d
        w = out["d_warp"]
        print(f"[15d rank {r}] sharded warp, n_data=2, (4,512,640,3)->500^2: gathered "
              f"{'bit-equal' if torch.equal(w['warped'], ref_warp) else 'DIFFERENT'} to the "
              f"unsharded K1; K1 launches {w['warp_resample']} (expected 1), staged "
              f"{w['staged']}")
        bar(torch.equal(w["warped"], ref_warp) and w["warp_resample"] == 1, "15d: warp")
        paths[f"sharded_warp_r{r}"] = {k: w[k] for k in counters}
        for (shape, dtype), res in out["d_train"].items():
            n = len(res["got"])
            print(f"[15d rank {r}] sharded train (data, model) = {shape}, TrainConfig() "
                  f"(hidden 256, 512 px), batch 16, {str(dtype)[6:]} compute, {n} step(s): "
                  f"losses {[f'{m['loss/total']:.6f}' for m in res['got']]} vs one-device "
                  f"{[f'{m['loss/total']:.6f}' for m in res['ref']]}, grad_norm "
                  f"{[f'{m['grad_norm']:.6f}' for m in res['got']]} vs "
                  f"{[f'{m['grad_norm']:.6f}' for m in res['ref']]}; metrics max rel|d| "
                  f"{_metrics_rel(res):.3g}, params max|d| {res['d']:.3g} (atol 5e-2), "
                  f"cos of the parameter change {res['cos_all']:.6f}, of the last step's "
                  f"{res['cos_last']:.6f}")
            bar(_train_ok(res, dtype), f"15d: train {shape} {dtype}")
    b0 = ranks[0]["b_decode"]
    dense = ranks[0]["b_dense"]
    agree = int((b0["tokens"] == dense["tokens"]).all(dim=1).sum())
    print(f"[15b] bf16 full depth against the dense prefill: logits cos "
          f"{_cos(b0['logits'], dense['logits']):.6f}, rows cos "
          f"{_cos(b0['rows'], dense['rows']):.6f}; {agree}/4 rows decode the same 21 tokens")
    bar(bool(torch.isfinite(b0["logits"]).all()), "15b: logits not finite")

    t0 = time.perf_counter()
    (nc,) = run_ranks(_phase15_nccl, 1, (dev,), backend="nccl", timeout=600)
    ok = (nc["collectives_ok"] and torch.equal(nc["gen"], ref_small[0])
          and (nc["maps"] - ref_small[1]).abs().max().item() <= 1e-5
          and (nc["logits"] - ref_sp[0]).abs().max().item() <= 1e-4
          and torch.equal(nc["warped"], ref_warp)
          and _train_ok(nc["train"], torch.bfloat16))
    print(f"[15e] backend {nc['backend']}, world size 1 on {dev}: all_reduce, "
          f"all_gather and broadcast on its tensors "
          f"{'ok' if nc['collectives_ok'] else 'WRONG'}; 15a-15d at 2 layers on the (1, 1) "
          f"mesh {'agree with the references' if ok else 'DISAGREE'} "
          f"({time.perf_counter() - t0:.2f} s)")
    bar(nc["backend"] == "nccl" and ok, "15e: NCCL pass")
    check(not fails, "; ".join(fails))
    return paths


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_clone_tree(v) for v in t]
    return t.clone()

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ── step 16: the ablations and K1's backward ────────────────────────────

PIX_TOL = 1e-3 * 255          # the repo's warp budget: 1e-3 on [0, 1] pixels
XATTN_PROMPT = "a red tag with a white code on a wooden shelf"
# the timed shapes of K1's backward: (name, (B, H, W), S, K1 input kind,
# (need_images, need_map_x, need_map_y))
K1B_SHAPES = (("pipeline", (4, 512, 640), 500, "pipeline", (True, True, True)),
              # a predict_and_warp chunk under a MarginalNet loss: maps only
              ("chain_predict", (10, 512, 512), 512, "chain_predict", (False, True, True)),
              # 16c's warp_grad_cdf batch, maps only
              ("warp_grad_cdf", (16, 512, 512), 512, "chain_predict", (False, True, True)),
              # a 683x1024 photo: the image alone
              ("photo_683w", (1, 1024, 683), 500, "dataset_driver_683w", (True, False, False)))


def _counters16():
    from attwarp_tpu_torch.kernels.warp_resample import warp_resample_backward

    return {**_counters(), "warp_resample_backward": warp_resample_backward}


class _walls:
    """Wraps module functions for one ``with`` block so that each call's
    wall (host clock, ending in a device sync) is appended under its name."""

    def __init__(self, *targets):
        self.targets = targets
        self.seconds = {}

    def __enter__(self):
        import torch

        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.targets]

        def timed(name, fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
                return out
            return call

        for mod, name, fn in self.saved:
            setattr(mod, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_xattn(dev):
    """16a: ``run_cross_attention_warp`` end to end on the card with
    ``make_sd_capture_fn`` over the stub pipeline at SD 2.1's cross-attention
    geometry (``testing/sd_stub.py``: 16 attn2 layers a UNet evaluation,
    batch 2, 77 tokens), the JAX defaults (timesteps 999..200, 4 snapshots,
    10 denoise steps, a 768 px latent image), a 683x1024 photo, top_k 20,
    iterations 1 and 3. Checks launches (K1 = iterations, nothing else), the
    captured maps, the iterates (finite, in the image's range, 500x500x3),
    the map's span, iterate 1 of 3 against the single pass, and the card
    against the port's CPU path on the same captured maps."""
    import numpy as np
    import torch

    from attwarp_tpu_torch.testing.sd_stub import SAMPLE_SIZE, SD21StubPipeline, attn2_layers
    from attwarp_tpu_torch.warp import cross_attention, iterative
    from attwarp_tpu_torch.warp.sd_capture import DEFAULT_TIMESTEPS, make_sd_capture_fn

    t0 = time.perf_counter()
    pipe = SD21StubPipeline(device=dev, seed=0)
    capture = make_sd_capture_fn(pipe=pipe, device=dev)
    print(f"[16a xattn] stub pipeline at SD 2.1's geometry built in "
          f"{time.perf_counter() - t0:.2f} s")
    image = np.random.default_rng(16).integers(0, 256, (1024, 683, 3), dtype=np.uint8)
    counters = _counters16()
    paths, runs = {}, {}
    for iterations in (1, 3):
        kept = {}

        def timed_capture(img, prompt):
            torch.cuda.synchronize()
            t = time.perf_counter()
            kept["maps"] = capture(img, prompt)
            torch.cuda.synchronize()
            kept["capture_s"] = time.perf_counter() - t
            return kept["maps"]

        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        with _walls((cross_attention, "compute_token_importance"),
                    (cross_attention, "aggregate_attention_map_for_tokens"),
                    (cross_attention, "condition_attention_map"),
                    (iterative, "warp_image_by_attention")) as w:
            t = time.perf_counter()
            outs, att = cross_attention.run_cross_attention_warp(
                image, XATTN_PROMPT, timed_capture, top_k=20, iterations=iterations,
                width=500, height=500, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in counters.items()}
        s = w.seconds
        maps = kept["maps"]
        peak = torch.cuda.max_memory_allocated()
        print(f"[16a xattn] iterations {iterations}: wall {wall:.3f} s | capture "
              f"{kept['capture_s']:.3f} s | importance + aggregation "
              f"{s['compute_token_importance'][0] + s['aggregate_attention_map_for_tokens'][0]:.4f} s"
              f" | conditioning {s['condition_attention_map'][0]:.4f} s | iterates "
              + ", ".join(f"{x * 1e3:.2f}" for x in s["warp_image_by_attention"])
              + f" ms | launches " + ", ".join(f"{k} {v}" for k, v in launches.items())
              + f" | peak memory {peak / 2**30:.2f} GiB")
        check(launches == {"warp_resample": iterations, "flash_prefill": 0,
                           "decode_attn_int8": 0, "warp_resample_backward": 0},
              "16a: launch counts")
        check(sorted(maps) == sorted(DEFAULT_TIMESTEPS[1:]), "16a: captured timesteps")
        for layers in maps.values():
            check(len(layers) == 16, "16a: 16 attn2 layers a snapshot")
            for name, level, _, heads in attn2_layers():
                side = SAMPLE_SIZE >> level
                check(tuple(layers[name].shape) == (2, heads, side, side, 77)
                      and layers[name].device.type == "cuda", f"16a: map {name}")
        check(len(outs) == iterations, "16a: iterates")
        for o in outs:
            check(tuple(o.shape) == (500, 500, 3) and bool(torch.isfinite(o).all()),
                  "16a: an iterate is not finite or not 500x500x3")
            check(float(o.min()) >= -1e-3 and float(o.max()) <= 255 + 1e-3,
                  "16a: an iterate leaves the image's range")
        check(tuple(att.shape) == (1024, 683) and abs(float(att.min())) <= 1e-6
              and abs(float(att.max()) - 1.0) <= 1e-6, "16a: the conditioned map spans [0, 1]")
        paths[f"xattn_warp_{iterations}"] = launches
        runs[iterations] = (outs, att, maps)
    d13 = float((runs[3][0][0] - runs[1][0][0]).abs().max())
    print(f"[16a xattn] iterate 1 of 3 vs the single pass: max|d| {d13:.4g} (tol {PIX_TOL:.3g})")
    check(d13 <= PIX_TOL, "16a: iterate 1 of 3 differs from the single pass")
    # the port's CPU path on the card's captured maps
    outs, att, maps = runs[3]
    host = {t: {k: v.cpu() for k, v in d.items()} for t, d in maps.items()}
    c_outs, c_att = cross_attention.run_cross_attention_warp(
        image, XATTN_PROMPT, lambda img, prompt: host, top_k=20, iterations=3, width=500,
        height=500, device="cpu")
    d_att = float((att.cpu() - c_att).abs().max())
    d_out = max(float((o.cpu() - c).abs().max()) for o, c in zip(outs, c_outs))
    print(f"[16a xattn] card vs the CPU path on the same maps: conditioned map max|d| "
          f"{d_att:.4g} (tol 1e-5), iterates max|d| {d_out:.4g} (tol {PIX_TOL:.3g})")
    check(d_att <= 1e-5, "16a: the conditioned map disagrees with the CPU path")
    check(d_out <= PIX_TOL, "16a: the iterates disagree with the CPU path")
    del runs, maps, host, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def _k1b_case(dev, name, B, H, W, S, kind, needs):
    """K1's backward against its plain version (autograd of
    ``remap_bilinear_separable`` on the same CUDA tensors) at one shape, two
    calls bit-equal, the kernels of one call as the library counts them
    against the design's; timed with L2 flushed and warm beside its plain
    version, its bound and ``F.grid_sample``'s backward
    (``aten.grid_sampler_2d_backward`` on the full 2-D grid, its grid
    gradient summed back to the two maps to check it)."""
    import torch

    from attwarp_tpu_torch.kernels import roofline
    from attwarp_tpu_torch.kernels.warp_resample import (
        backward_kernels_launched,
        warp_resample_backward,
        warp_resample_backward_plain,
    )

    need_images, need_x, need_y = needs
    need_maps = need_x or need_y
    img, mx, my = _k1_inputs(dev, kind, B, H, W, S)
    g = torch.randn((B, S, S, 3), generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev)
    args = (g, img, mx, my, *needs)
    k0 = backward_kernels_launched()
    got = warp_resample_backward(*args)
    per_call = backward_kernels_launched() - k0
    # the design: taps and image gradient, the maps' band pass, grad_map_x's band sums
    design = 2 * need_images + need_maps + need_x
    check(per_call == design, f"16b: {per_call} kernels a call, the design says {design} ({name})")
    again = warp_resample_backward(*args)
    ref = warp_resample_backward_plain(*args)
    torch.cuda.synchronize()
    errs, rels = [], []
    for k, (a, b, r) in enumerate(zip(got, again, ref)):
        if r is None:
            check(a is None, f"16b: a gradient not asked for was computed ({name})")
            continue
        err = (a - r).abs().max().item()
        rel = err / r.abs().max().item()
        errs.append(err)
        rels.append(rel)
        check(rel <= (1e-5 if k == 0 else 1e-4), f"16b: K1 backward disagrees ({name}, {k})")
        check(torch.equal(a, b), f"16b: two calls of K1 backward differ ({name}, {k})")
    # the yardstick: grid_sample's backward, NCHW, border padding,
    # align_corners (as K1's forward yardstick)
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack(((2 * mx / (W - 1) - 1)[:, None, :].expand(B, S, S),
                        (2 * my / (H - 1) - 1)[:, :, None].expand(B, S, S)), -1).contiguous()
    mask = [need_images, bool(need_maps)]

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 1, True, mask)

    li, lg = library()
    lib_rel, skipped = [], []
    if need_images:
        lib_rel.append(((li.permute(0, 2, 3, 1) - ref[0]).abs().max() / ref[0].abs().max()).item())
    if need_maps:
        # where a coordinate lies on a pixel boundary the derivative is
        # one-sided: the plain version takes the difference to the right
        # (floor), grid_sample's clip gives 0 at the border, and its
        # normalized grid may round a coordinate to either side of an
        # integer. Held at coordinates inside the image and more than 1e-3
        # from an integer.
        for m, n, lgm, r, dim in ((mx, W, lg[..., 0], ref[1], 1), (my, H, lg[..., 1], ref[2], 2)):
            held = (m > 0) & (m < n - 1) & ((m - torch.round(m)).abs() > 1e-3)
            lm = lgm.sum(dim) * (2.0 / (n - 1))
            lib_rel.append(((lm - r).abs() * held).max().item() / r.abs().max().item())
            skipped.append(int((~held).sum()))
    t = alternate_ms({"plain": lambda: warp_resample_backward_plain(*args),
                      "kernel": lambda: warp_resample_backward(*args), "library": library},
                     20, cold=True)
    warm = alternate_ms({"kernel": lambda: warp_resample_backward(*args), "library": library}, 20)
    work = roofline.k1_backward_work(B, H, W, 3, S, S, need_images, need_maps)
    e = with_bound({"max_abs_err": max(errs), "max_rel_err": max(rels), "ms": t["kernel"],
                    "warm_ms": warm["kernel"], "plain_ms": t["plain"],
                    "library_ms": t["library"], "library_warm_ms": warm["library"],
                    "library": "F.grid_sample backward (aten.grid_sampler_2d_backward)",
                    "library_max_rel_err": max(lib_rel),
                    "library_unheld_map_entries": sum(skipped), "need_images": need_images,
                    "need_maps": need_maps, "kernels_per_call": per_call},
                   work, roofline.F32_FLOPS)
    print(f"[16b K1 backward] {name} ({B},{H},{W},3)->({B},{S},{S},3) image grad "
          f"{need_images}, map grads {need_maps}: {per_call} kernels a call (library's "
          f"count; design {design}) | max rel err {max(rels):.3g} (tol image 1e-5, maps 1e-4), two "
          f"calls bit-equal | grid_sample backward vs plain {max(lib_rel):.3g} ("
          f"{sum(skipped)} map entries on a pixel boundary not held) | kernel "
          f"{t['kernel']:.4f} ms (L2 warm {warm['kernel']:.4f}), plain {t['plain']:.4f} ms"
          + _bound_text(e) + f" (L2 warm {warm['library']:.4f})")
    check(max(lib_rel) <= 1e-3, "16b: the grid_sample yardstick computes another function")
    del img, mx, my, g, got, again, ref, g_nchw, img_nchw, grid, li, lg
    return e


def phase_k1_backward(dev):
    """16b: K1's backward at its four timed shapes (``K1B_SHAPES``)."""
    import torch

    out = {name: _k1b_case(dev, name, *shape, S, kind, needs)
           for name, shape, S, kind, needs in K1B_SHAPES}
    _flush_buf.clear()
    torch.cuda.empty_cache()
    return out


def phase_warp_grad(dev):
    """16c: gradients through the product's entry points on the card, JAX's
    two ``tests/test_warp_grad.py`` settings at full size, against the same
    losses through the plain path (grid maps, then
    ``remap_bilinear_separable``) on the card: finite, non-zero, within 1e-4
    of the reference's largest magnitude, K1 and its backward one launch
    each (its kernels: 4 with the image's gradient, 2 for the maps alone, as
    the library counts them)."""
    import torch

    from attwarp_tpu_torch.kernels.warp_resample import backward_kernels_launched
    from attwarp_tpu_torch.numerics.cdf import cdf_from_density
    from attwarp_tpu_torch.warp.grid import inverse_axis_map_from_cdf
    from attwarp_tpu_torch.warp.resample import remap_bilinear_separable
    from attwarp_tpu_torch.warp.warp import (
        warp_batch_by_attention,
        warp_from_cdf,
        warp_grid_maps,
    )

    gen = torch.Generator(device=dev).manual_seed(16)
    img = torch.rand((4, 512, 640, 3), generator=gen, device=dev) * 255.0
    att = torch.rand((4, 24, 24), generator=gen, device=dev) + 0.1
    img16 = torch.rand((16, 512, 512, 3), generator=gen, device=dev) * 255.0
    p = torch.rand((16, 512), generator=gen, device=dev) + 0.1

    def batch_loss(warp, i, a):
        return torch.sum(warp(i, a) ** 2)

    def cdf_loss(warp, q):
        F_ = cdf_from_density(q)
        return torch.mean((warp(F_) - img16) ** 2)

    cases = {
        "warp_grad_batch": (
            lambda i, a: batch_loss(lambda x, y: warp_batch_by_attention(x, y, 500, 500), i, a),
            lambda i, a: batch_loss(lambda x, y: remap_bilinear_separable(
                x, *warp_grid_maps(y, (512, 640), 500, 500)), i, a),
            (img, att), 4),
        "warp_grad_cdf": (
            lambda q: cdf_loss(lambda F_: warp_from_cdf(img16, F_, F_, tie_jitter=False), q),
            lambda q: cdf_loss(lambda F_: remap_bilinear_separable(
                img16, inverse_axis_map_from_cdf(F_, 512, tie_jitter=False),
                inverse_axis_map_from_cdf(F_, 512, tie_jitter=False)), q),
            (p,), 2),
    }
    counters = _counters16()
    paths = {}
    for tag, (loss, plain_loss, inputs, design) in cases.items():
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        for fn in counters.values():
            fn.launches = 0
        k0 = backward_kernels_launched()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = torch.autograd.grad(loss(*leaves), leaves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        kernels = backward_kernels_launched() - k0
        ref_leaves = [x.clone().requires_grad_(True) for x in inputs]
        refs = torch.autograd.grad(plain_loss(*ref_leaves), ref_leaves)
        rels = [((gr - r).abs().max() / r.abs().max()).item() for gr, r in zip(grads, refs)]
        print(f"[16c {tag}] forward + backward {wall * 1e3:.2f} ms | max rel err vs the plain "
              "path " + ", ".join(f"{x:.3g}" for x in rels) + " (tol 1e-4) | launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items())
              + f" | backward kernels {kernels} (design {design})")
        check(kernels == design, f"16c {tag}: backward kernels")
        for gr in grads:
            check(bool(torch.isfinite(gr).all()) and gr.abs().max().item() > 0,
                  f"16c {tag}: a gradient is not finite or is zero")
        check(max(rels) <= 1e-4, f"16c {tag}: gradients disagree with the plain path")
        check(launches == {"warp_resample": 1, "flash_prefill": 0, "decode_attn_int8": 0,
                           "warp_resample_backward": 1}, f"16c {tag}: launch counts")
        paths[tag] = launches
    del img, att, img16, p
    torch.cuda.empty_cache()
    return paths


# ── step 17: the bench and profile tools ────────────────────────────────

# the kernels' __global__ functions a device trace of a +kv8+flash pipeline
# run must hold (K3's split plane and its merge kernel both count as K3)
TRACE_KERNELS = {"warp_resample": ("warp_resample_kernel",),
                 "flash_prefill": ("flash_prefill_kernel",),
                 "decode_attn_int8": ("decode_attn_mha", "decode_attn_gqa")}


def _counted(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every kernel's launch count set to 0
    just before it; returns (its output, the counts just after)."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = fn(*args, **kwargs)
    return out, {name: c.launches for name, c in counters.items()}


def _expect(tag, launches, want):
    print(f"[{tag}] launches: " + ", ".join(
        f"{name} {launches[name]} (expected {want.get(name, 0)})" for name in launches))
    for name in launches:
        check(launches[name] == want.get(name, 0), f"{tag}: {name} launch count")
    return launches


def _serve_want(L, r, flash=True):
    return {"decode_attn_int8": L * r["work"]["decode_steps"],
            "flash_prefill": L * r["work"]["prefill_groups"] if flash else 0}


def phase_tools_llava(backend):
    """17a: the LLaVA tools' ``run`` on step 6's bf16 LLaVA-1.5-7B weights
    (``+kv8+flash`` unless named): ``bench_extract`` at B=4, its maps
    bit-equal to ``extract``'s on the same prompts and pixels;
    ``bench_prefill`` dense and flash at B=8 T=640; ``bench_decode`` ``+kv8``
    at B=4, 16 steps; ``bench_pipeline`` and ``profile_pipeline`` at B=4;
    ``bench_serve`` at 8 slots, 24 requests, 32 new tokens; then one
    ``bench_pipeline`` repeat inside ``device_trace``, in a child process
    (a profiler session slows what runs after it in its process), whose
    trace must hold K1's, K2's and K3's kernels. Each run's launch counts
    as its work predicts. Repeats and requests are cut, never widths."""
    import torch

    from attwarp_tpu_torch.tools import (
        bench_decode,
        bench_extract,
        bench_pipeline,
        bench_prefill,
        bench_serve,
        profile_pipeline,
    )

    L, steps = backend.model.cfg.text.num_hidden_layers, 20
    old = backend.kv_quant, backend.use_flash
    backend.kv_quant = backend.use_flash = True
    paths = {}
    per_extract = {"flash_prefill": L, "decode_attn_int8": (L - 1) * steps}
    per_pipeline = {"warp_resample": 1, "flash_prefill": 2 * L,
                    "decode_attn_int8": (L - 1) * steps + L * steps}
    try:
        r, n = _counted(bench_extract.run, backend, B=4, repeats=2, iters=1,
                        label="bf16+kv8+flash")
        paths["bench_extract"] = _expect("17a bench_extract", n,
                                         {k: 3 * v for k, v in per_extract.items()})
        images = _images()
        ids, mask, _, _ = backend._prepare(images, QUESTIONS)
        _, m_tool = bench_extract.one_round(backend, ids, mask, images)
        m_lib, _ = backend.extract(images, QUESTIONS)
        same = bool(torch.equal(m_tool, m_lib))
        print(f"[17a bench_extract] maps of the tool's round and of extract on the same "
              f"prompts and pixels bit-equal: {same}")
        check(same, "17a: bench_extract's maps differ from extract's")

        text, tcfg = backend.model.params["llama"], backend.model.cfg.text
        for mode in ("dense", "flash"):
            r, n = _counted(bench_prefill.run, text, tcfg, mode == "flash", B=8, T=640,
                            repeats=2, iters=2, device=backend.device)
            check(bool(r["logits"].isfinite().all()), f"17a: {mode} prefill logits")
            paths[f"bench_prefill_{mode}"] = _expect(
                f"17a bench_prefill {mode}", n, {"flash_prefill": 5 * L if mode == "flash" else 0})

        r, n = _counted(bench_decode.run, text, tcfg, True, B=4, steps=16, repeats=2,
                        device=backend.device, label="bf16+kv8")
        check(tuple(r["tokens"].shape) == (4, 16), "17a: decode tokens")
        paths["bench_decode"] = _expect("17a bench_decode", n, {"decode_attn_int8": 3 * L * 16})

        r, n = _counted(bench_pipeline.run, backend, B=4, repeats=2, iters=1,
                        label="bf16+kv8+flash")
        res = r["result"]
        check(res.attention_maps.shape == (4, 24, 24) and res.warped.shape == (4, 500, 500, 3)
              and len(res.second_answers) == 4, "17a: pipeline outputs")
        paths["bench_pipeline"] = _expect("17a bench_pipeline", n,
                                          {k: 3 * v for k, v in per_pipeline.items()})

        r, n = _counted(profile_pipeline.run, backend, B=4, iters=2, label="bf16+kv8+flash")
        check(r["warped"].shape == (4, 500, 500, 3), "17a: profile outputs")
        paths["profile_pipeline"] = _expect("17a profile_pipeline", n,
                                            {k: 2 * v for k, v in per_pipeline.items()})

        r, n = _counted(bench_serve.run, backend.model, slots=8, n_req=24, max_new=32,
                        flash=True, repeats=1, label="bf16+kv8+flash")
        check(len(r["tokens"]) == 24 and all(1 <= len(t) <= 32 for t in r["tokens"]),
              "17a: serve outputs")
        paths["bench_serve"] = _expect("17a bench_serve", n, _serve_want(L, r))
    finally:
        backend.kv_quant, backend.use_flash = old
    paths["trace"] = _phase("17a trace", phase_trace)
    return paths


def phase_trace():
    """17a's traced run, in a child process: see ``trace_child``."""
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.trace_child()"],
                          capture_output=True, text=True, timeout=900,
                          cwd=Path(__file__).resolve().parent)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"[17a trace] {line}")
    check(proc.returncode == 0 and lines, f"17a trace failed: {proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def trace_child():
    """Step 6's LLaVA-1.5-7B weights (the same seed) ``+kv8+flash``: one
    ``bench_pipeline`` warm-up run, then one repeat at B=4 inside
    ``device_trace`` under ``build/chip_smoke/trace/``. Its ``trace.json``
    must hold device events of K1's, K2's and K3's ``__global__``
    functions; prints the ten device ops that took the most time and, on
    the last line, the launch counts of both runs."""
    import torch

    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.tools.bench_utils import make_llava_7b_backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    backend, label = make_llava_7b_backend("bf16+kv8+flash", tokenizer=DryRunTokenizer(),
                                           device="cuda:0")
    print(json.dumps(_traced_pipeline(backend, label)))


def _traced_pipeline(backend, label):
    import collections

    from attwarp_tpu_torch.tools import bench_pipeline

    d = _scratch("trace")
    t0 = time.perf_counter()
    _, n = _counted(bench_pipeline.run, backend, B=4, repeats=1, iters=1, trace_dir=d,
                    label=label)
    print(f"traced run (warm-up untraced, one repeat traced, export included) "
          f"{time.perf_counter() - t0:.2f} s")
    with open(d / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    dev_ms = collections.Counter()
    calls = collections.Counter()
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            dev_ms[e["name"]] += e["dur"] / 1e3
            calls[e["name"]] += 1
    total = sum(dev_ms.values())
    print(f"trace.json {(d / 'trace.json').stat().st_size / 2**20:.1f} MiB, "
          f"{len(events)} events; device ops {sum(calls.values())}, {total:.2f} ms")
    for name, ms in dev_ms.most_common(10):
        print(f"  {ms:9.3f} ms  {calls[name]:6d} calls  {name[:110]}")
    found = {k: sum(calls[nm] for nm in calls if any(g in nm for g in globs))
             for k, globs in TRACE_KERNELS.items()}
    print(f"kernel events in the trace: {found}")
    for k, v in found.items():
        check(v > 0, f"trace: no device event of {k}")
    L, steps = backend.model.cfg.text.num_hidden_layers, 20
    want = {"warp_resample": 2, "flash_prefill": 4 * L,
            "decode_attn_int8": 2 * ((L - 1) * steps + L * steps)}
    return _expect("trace", n, want)


def phase_tools_chunked_warp(backend):
    """17c: ``bench_chunked_serve`` on step 6's LLaVA-1.5-7B ``+kv8`` (P=128,
    16 slots, 16 requests; the chunked engine runs no K2), then
    ``tools.bench.main([])`` (its JSON line printed here, never last) and
    ``profile_warp_terms`` at their defaults (336 px, b128, 200 warps a
    chain)."""
    from attwarp_tpu_torch.tools import bench, bench_chunked_serve, profile_warp_terms

    L = backend.model.cfg.text.num_hidden_layers
    paths = {}
    r, n = _counted(bench_chunked_serve.run, backend.model, slots=16, n_req=16, P=128,
                    repeats=1, label="bf16+kv8")
    check(len(r["tokens"]) == 16 and all(1 <= len(t) <= 128 for t in r["tokens"]),
          "17c: chunked outputs")
    paths["bench_chunked_serve"] = _expect("17c bench_chunked_serve", n,
                                           _serve_want(L, r, flash=False))
    rc, n = _counted(bench.main, [])
    check(rc == 0, "17c: bench.main")
    paths["bench_warp"] = _expect("17c bench", n, {"warp_resample": 4 * bench.ITERS})
    r, n = _counted(profile_warp_terms.run, "cuda")
    print(f"[17c profile_warp_terms] us per image: full {r['full_us_per_image']:.3f}, grid "
          f"{r['grid_us_per_image']:.3f}, resample {r['resample_us_per_image']:.3f} "
          f"({r['full_warps_per_sec']:.1f} warps/s) | {r['card']}")
    paths["profile_warp_terms"] = _expect("17c profile_warp_terms", n,
                                          {"warp_resample": 2 * 4 * 200})
    return paths


def phase_tools_qwen(backend):
    """17b: the Qwen tools' ``run`` on step 7's bf16 Qwen2-VL-7B weights:
    ``bench_qwen_prefill`` flash at B=8 T=640, ``bench_qwen_decode`` ``+kv8``
    at B=4, ``bench_qwen_serve`` ``+kv8+flash`` at 8 slots, 16 requests (128
    new tokens); then ``extract_from_ids`` with one shared image and with
    four per-sample copies of it: tokens equal, maps cos > 0.9999 (14c's
    bar: the vision tower runs at another batch)."""
    import torch

    from attwarp_tpu_torch.extract.resize import clip_pixels
    from attwarp_tpu_torch.tools import bench_qwen_decode, bench_qwen_prefill, bench_qwen_serve

    L = backend.model.cfg.text.num_hidden_layers
    text, tcfg = backend.model.params["text"], backend.model.cfg.text
    paths = {}
    r, n = _counted(bench_qwen_prefill.run, text, tcfg, True, B=8, T=640, repeats=2, iters=2,
                    device=backend.device)
    check(bool(r["logits"].isfinite().all()), "17b: prefill logits")
    paths["bench_qwen_prefill"] = _expect("17b bench_qwen_prefill", n, {"flash_prefill": 5 * L})
    r, n = _counted(bench_qwen_decode.run, text, tcfg, True, B=4, steps=16, repeats=2,
                    device=backend.device, label="bf16+kv8")
    paths["bench_qwen_decode"] = _expect("17b bench_qwen_decode", n,
                                         {"decode_attn_int8": 3 * L * 16})
    r, n = _counted(bench_qwen_serve.run, backend.model, slots=8, n_req=16, flash=True,
                    repeats=1, label="bf16+kv8+flash")
    check(len(r["tokens"]) == 16, "17b: serve outputs")
    paths["bench_qwen_serve"] = _expect("17b bench_qwen_serve", n, _serve_want(L, r))

    images = _images()
    ids, mask = backend._prompt_ids(QUESTIONS)
    one = clip_pixels([images[0]], backend.image_size, backend.device)[0]
    (g1, m1), n1 = _counted(backend.extract_from_ids, ids, mask, one)
    (g4, m4), n4 = _counted(backend.extract_from_ids, ids, mask, one[None].expand(4, -1, -1, -1))
    cos = min(_cos(a, b) for a, b in zip(m1.reshape(4, -1), m4.reshape(4, -1)))
    same = bool(torch.equal(g1, g4))
    print(f"[17b qwen extract_from_ids] one shared image vs 4 copies: maps {tuple(m1.shape)} "
          f"min cos {cos:.6f} (bar > 0.9999), greedy tokens equal {same}")
    check(tuple(m1.shape) == (4, 24, 24) and cos > 0.9999, "17b: shared-image maps")
    check(same, "17b: shared-image tokens")
    want = {"flash_prefill": L, "decode_attn_int8": (L - 1) * 20}
    for n_ in (n1, n4):
        _expect("17b qwen extract_from_ids", n_, want)
    paths["qwen_extract_from_ids"] = {k: n1[k] + n4[k] for k in n1}
    return paths


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
    # the trainer's metric sink would try wandb online where it imports; this
    # run records metrics locally only (train/metrics.py's JSONL fallback)
    sys.modules["wandb"] = None
    t_all = time.perf_counter()
    name = _phase("1 device", phase_device)
    _phase("2 build", phase_build)
    k1 = _phase("3 K1", phase_k1, dev)
    if args.parent:
        _phase("3 K1 vs parent", phase_k1_parent, k1, args.parent)
    k3 = _phase("4 K3", phase_k3, dev)
    k2 = _phase("5 K2", phase_k2, dev)
    k4 = _phase("5b K4", phase_k4, dev)
    paths = {}
    paths["llava"], backend, base6 = _phase("6 llava", phase_slice, dev)
    paths["llava_serve"], paths["llava_chunked"], base8 = _phase(
        "8 llava serve", phase_llava_serve, backend)
    paths["llava_dataset"], step10 = _phase("10 llava dataset", phase_llava_dataset, backend)
    paths["codetag"] = _phase("11 codetag", phase_codetag)
    paths["marginalnet_chain"], meta_dir = _phase("12a marginalnet chain",
                                                  phase_marginalnet_chain)
    paths["marginalnet_train"] = _phase("12b marginalnet train", phase_marginalnet_train,
                                        backend, meta_dir)
    paths["llava_layers"], layers_root = _phase("14a llava layers", phase_llava_layers,
                                                backend, step10)
    paths["llava_sweep"] = _phase("14b llava sweep", phase_llava_sweep, backend, layers_root)
    paths["mini_dataset"] = _phase("14d mini", phase_mini, dev)
    t17 = time.perf_counter()
    paths.update(_phase("17a llava tools", phase_tools_llava, backend))
    paths.update(_phase("17c chunked and warp tools", phase_tools_chunked_warp, backend))
    wall17 = time.perf_counter() - t17
    gc.collect()
    torch.cuda.empty_cache()
    int8 = _phase("13a int8 product", phase_int8_matmul, dev)
    paths.update(_phase("13b llava int8", phase_llava_int8, backend, base6, base8))
    del backend
    gc.collect()                 # free the LLaVA weights before Qwen's
    torch.cuda.empty_cache()
    paths["qwen"], backend, base7 = _phase("7 qwen", phase_qwen, dev)
    paths["qwen_serve"] = _phase("8 qwen serve", phase_qwen_serve, backend)
    paths["qwen_layers"] = _phase("14c qwen layers", phase_qwen_layers, backend)
    t17 = time.perf_counter()
    paths.update(_phase("17b qwen tools", phase_tools_qwen, backend))
    wall17 += time.perf_counter() - t17
    print(f"[17] step 17 wall {wall17:.2f} s (17a, 17c and 17b)")
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(_phase("13c qwen int8", phase_qwen_int8, backend, base7))
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    _phase("9 serve parity", phase_serve_parity, dev)
    paths.update(_phase("13d hf", phase_hf))
    paths.update(_phase("15 parallel", phase_parallel, dev))
    paths.update(_phase("16a xattn", phase_xattn, dev))
    k1b = _phase("16b K1 backward", phase_k1_backward, dev)
    paths.update(_phase("16c warp grad", phase_warp_grad, dev))
    print(f"[all] wall {time.perf_counter() - t_all:.2f} s")

    def launches(name):
        return {"launches": sum(p.get(name, 0) for p in paths.values()),
                "launches_by_path": {k: p.get(name, 0) for k, p in paths.items()}}

    kernels = [
        {"name": "warp_resample", "route": "cuda",
         "source": "attwarp_tpu_torch/csrc/warp_resample.cu",
         "replaces": "attwarp_tpu/ops/pallas_warp.py:87",
         **launches("warp_resample"), **k1["pipeline"],
         **{k: k1[k] for k in ("dataset_driver", "dataset_driver_683w", "warp_only",
                               "chain_predict", "train_debug", "sharded_warp")}},
        {"name": "warp_resample_backward", "route": "cuda",
         "source": "attwarp_tpu_torch/csrc/warp_resample_bwd.cu",
         "replaces": "XLA autodiff of attwarp_tpu/warp/resample.py:42 (no Pallas backward)",
         **launches("warp_resample_backward"), **k1b["pipeline"],
         **{k: k1b[k] for k in ("chain_predict", "warp_grad_cdf", "photo_683w")}},
        {"name": "flash_prefill", "route": "cuda",
         "source": "attwarp_tpu_torch/csrc/flash_prefill.cu",
         "replaces": "attwarp_tpu/models/llama.py:218",
         **launches("flash_prefill"), **k2["qwen7b"],
         **{k: k2[k] for k in ("llava7b", "llava7b_serve", "qwen7b_serve",
                               "llava7b_dataset", "llava7b_sweep", "llava7b_tp2",
                               "qwen7b_tp2")}},
        {"name": "decode_attn_int8", "route": "cuda",
         "source": "attwarp_tpu_torch/csrc/decode_attn_int8.cu",
         "replaces": "attwarp_tpu/ops/pallas_decode_attn.py:284",
         **launches("decode_attn_int8"), **k3["llava7b"],
         **{k: k3[k] for k in ("qwen7b", "llava7b_serve", "qwen7b_serve",
                               "llava7b_dataset", "llava7b_dataset_serve", "llava7b_tp2",
                               "llava7b_disagg", "qwen7b_tp2")}},
    ]
    # K4 is counted on the paths that check it: the pipelines (``_drive``),
    # the serve engines (``_serve_run``) and step 15's
    k4_paths = {k: p["scaled_softmax_"] for k, p in paths.items() if "scaled_softmax_" in p}
    kernels.append({"name": "scaled_softmax_", "route": "cuda",
                    "source": "attwarp_tpu_torch/csrc/attn_softmax.cu",
                    "replaces": "none: the softmax of attwarp_tpu/models/{qwen2vl,clip_vit}.py's "
                                "towers is plain einsum code",
                    "launches": sum(k4_paths.values()), "launches_by_path": k4_paths,
                    **k4["qwen2vl_image"],
                    **{k: k4[k] for k in ("clip_batch8", "siglip_batch8")}})
    # the int8 product is a library call (torch._int_mm), not a kernel of
    # the port: its own line, beside the kernels'
    print(json.dumps({"library_products": [{
        "name": "int8_matmul", "call": "torch._int_mm",
        "source": "attwarp_tpu_torch/numerics/quant.py",
        "replaces": "attwarp_tpu/numerics/quant.py:84 (XLA dot_general, not Pallas)",
        **launches("int8_matmul"), "shapes": int8}]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
