"""Dataset driver (counterpart of ``attwarp_tpu/cli/process_dataset.py``).

Parity with ``main.py:203-580`` and ``main_batched.py:123-314``: walks a
TextVQA-layout dataset (or a generic JSONL), extracts each sample's
attention map in batches and writes the artifact set

    original_images/{sid}_original.png
    masked_images/{sid}_masked.png               (JET overlay)
    raw_attention_maps/{sid}_raw_attn.npy        ((1, 1, n, n) float32)
    attention_maps_images/{sid}_attn_map_img.png (raw map as an image)
    attention_maps/{sid}_mota_mask_vis.png       (grayscale MOTA mask)
    attention_maps/{sid}_mota_mask.npy
    warped_images/{sid}_identity.png             (identity warp, 500 x 500)
    metadata/{sid}_metadata.json                 (the saved_paths contract)

with resumable progress (``data/progress.py``) and the batched path's
failure ladder: a failed batch extraction is retried per sample, and a
failed sample gets the uniform map (main_batched.py:214-233). The device
extracts batch N+1 while a writer thread writes batch N; on a CUDA device
the writer's MOTA mask and warp (kernel K1, one launch per sample) run on
the card.

    python -m attwarp_tpu_torch.cli.process_dataset --backend reader \\
        --textvqa-json data/codetag_val.json --image-dir data/images \\
        --output-dir processed --batch-size 8

A backend spec is ``reader`` (the resolution-limited proxy of
``testing/reader.py``), ``llava-ckpt:<dir>`` or ``qwen2vl-ckpt:<dir>`` (a
directory written by the backend's ``save``), with ``+kv8`` (int8 KV
cache, decode attention through kernel K3) and ``+flash`` (prefill
attention through kernel K2) composable in any order:
``llava-ckpt:/ckpt+kv8+flash``. ``--backend`` is required: JAX's default
test backend ``mini`` is not ported. ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
from typing import List, Optional

import numpy as np
import torch

from attwarp_tpu_torch.data.imageio import MissingPillowError, read_rgb, write_png
from attwarp_tpu_torch.data.progress import ProgressManifest
from attwarp_tpu_torch.data.textvqa import TextVQADataset
from attwarp_tpu_torch.extract.resize import resize_for_backend, resize_images_batch
from attwarp_tpu_torch.utils.device import require_device
from attwarp_tpu_torch.warp.blend import blend_mask
from attwarp_tpu_torch.warp.io import save_warped_image

DEFAULT_WIDTH = 500
DEFAULT_HEIGHT = 500

ARTIFACT_DIRS = (
    "attention_maps",
    "warped_images",
    "visualizations",
    "original_images",
    "metadata",
    "masked_images",
    "attention_maps_images",
    "raw_attention_maps",
    "checkpoints",
)

# what each part of the JAX grammar that the port cannot load yet waits for
_SUFFIX_NOT_PORTED = {
    "int8": "w8a8 decoder weights ('+int8') wait for ROADMAP Queue 1 item 5",
    "lm8": "the int8 LM head ('+lm8') waits for ROADMAP Queue 1 item 5",
}
_SPEC_NOT_PORTED = {
    "llava": "loading HF checkpoints ('llava:', from_hf) waits for ROADMAP "
             "Queue 1 item 4; use llava-ckpt:<dir>",
    "qwen2vl": "loading HF checkpoints ('qwen2vl:', from_hf) waits for ROADMAP "
               "Queue 1 item 8; use qwen2vl-ckpt:<dir>",
    "mini": "the mini test backend waits for ROADMAP Queue 1 item 3",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("attwarp process-dataset (PyTorch)")
    p.add_argument("--textvqa-json", default=None,
                   help="TextVQA_0.5.1-style json (with --image-dir)")
    p.add_argument("--jsonl", default=None,
                   help="generic JSONL: one {image_path, question, ...} per "
                        "line (GQA/DocVQA-style inputs)")
    p.add_argument("--image-dir", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--batch-size", type=int, default=32,
                   help="1 = sequential driver semantics; >1 = batched")
    p.add_argument("--layer-index", type=str, default="20",
                   help="decoder layer for attention extraction (one layer; "
                        "lists wait for ROADMAP Queue 1 item 4)")
    p.add_argument("--max-new-tokens", type=int, default=20)
    p.add_argument("--enhance-coe", type=float, default=10.0)
    p.add_argument("--kernel-size", type=int, default=3)
    p.add_argument("--width", type=int, default=DEFAULT_WIDTH)
    p.add_argument("--height", type=int, default=DEFAULT_HEIGHT)
    p.add_argument("--limit", type=int, default=None, help="Process at most N samples")
    p.add_argument("--backend", required=True,
                   help="'reader', 'llava-ckpt:<dir>' or 'qwen2vl-ckpt:<dir>' "
                        "('+kv8' and '+flash' suffixes compose)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the weights, the masks and the warps")
    return p


def parse_layer_spec(spec) -> "int | tuple":
    """'20' -> 20; '4,8,20' -> (4, 8, 20); ints and tuples pass through."""
    if isinstance(spec, (int, tuple)):
        return spec
    layers = tuple(int(x) for x in str(spec).split(",") if x.strip())
    if not layers:
        raise ValueError(f"empty --layer-index spec {spec!r}")
    return layers[0] if len(layers) == 1 else layers


def make_backend(name: str, layer_index, device):
    """The backend a spec names, its weights loaded onto ``device`` (the
    reader has none)."""
    layer_index = parse_layer_spec(layer_index)
    base, sep, suffix = name.rpartition("+")
    if sep and suffix in ("kv8", "flash", "int8", "lm8"):
        if suffix in _SUFFIX_NOT_PORTED:
            raise ValueError(f"{name!r}: {_SUFFIX_NOT_PORTED[suffix]}")
        be = make_backend(base, layer_index, device)
        attr = "kv_quant" if suffix == "kv8" else "use_flash"
        if not hasattr(be, attr):
            raise ValueError(f"backend {base!r} has no '+{suffix}' path")
        setattr(be, attr, True)
        return be
    family, _, path = name.partition(":")
    if family in _SPEC_NOT_PORTED:
        raise ValueError(f"{name!r}: {_SPEC_NOT_PORTED[family]}")
    if not isinstance(layer_index, int):
        raise ValueError("multi-layer extraction is not ported yet (ROADMAP "
                         "Queue 1 item 4); give one --layer-index")
    if name == "reader":
        from attwarp_tpu_torch.testing.reader import ReaderBackend

        return ReaderBackend()
    if family == "llava-ckpt" and path:
        from attwarp_tpu_torch.extract.llava_backend import LlavaBackend

        return LlavaBackend.load(path, device, extract_layer=layer_index)
    if family == "qwen2vl-ckpt" and path:
        from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend

        return Qwen2VLBackend.load(path, device, extract_layer=layer_index)
    raise ValueError(f"unknown backend {name}")


def _host(maps) -> np.ndarray:
    if isinstance(maps, torch.Tensor):
        return maps.detach().cpu().numpy()
    return np.asarray(maps)


def _extract_with_fallback(backend, images, questions: List[str],
                           max_new_tokens: int):
    """Batch extract; on failure retry per sample; the uniform map as the
    last resort. Returns (maps (B, n, n) float32 on the host, texts)."""
    try:
        maps, texts = backend.extract(images, questions,
                                      max_new_tokens=max_new_tokens)
        return _host(maps), texts
    except Exception as e:
        print(f"Batch extraction failed ({e}); retrying per-sample.")
    maps, texts = [], []
    n_side = getattr(backend, "num_patches_side", 24)
    uniform = np.full((n_side, n_side), 1.0 / n_side**2, np.float32)
    for i in range(len(questions)):
        try:
            m, t = backend.extract(images[i:i + 1], [questions[i]],
                                   max_new_tokens=max_new_tokens)
            maps.append(_host(m)[0])
            texts.append(t[0])
        except Exception as e2:
            print(f"Per-sample extraction failed ({e2}); uniform map fallback.")
            maps.append(uniform)
            texts.append("")
    return np.stack(maps), texts


class JsonlDataset:
    """Generic driver input: JSONL of {image_path, question, answers?, ...}
    (GQA/DocVQA-style processing)."""

    def __init__(self, jsonl_path: str):
        self.samples = []
        with open(jsonl_path, "r") as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        self.samples.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        sample = dict(self.samples[idx])
        path = sample.get("image_path")
        img = None
        if path and os.path.exists(path):
            try:
                img = read_rgb(path)
            except MissingPillowError:
                raise
            except Exception as e:
                print(f"Error reading {path}: {e}")
        sample["loaded_image"] = img
        sample.setdefault("image_id", os.path.splitext(os.path.basename(path or f"s{idx}"))[0])
        return sample


def process_dataset(
    textvqa_json: Optional[str],
    image_dir: Optional[str],
    output_dir: str,
    backend,
    jsonl: Optional[str] = None,
    batch_size: int = 32,
    max_new_tokens: int = 20,
    enhance_coe: float = 10.0,
    kernel_size: int = 3,
    width: int = DEFAULT_WIDTH,
    height: int = DEFAULT_HEIGHT,
    limit: Optional[int] = None,
    device=None,
) -> dict:
    """Process the dataset into ``output_dir``; returns {"processed",
    "failed"} (counts of the progress manifest, earlier runs included).
    ``device``: where the masks and warps run; by default the backend's,
    else ``cuda``."""
    device = require_device(device if device is not None
                            else getattr(backend, "device", "cuda"), "process_dataset")
    dirs = {}
    for d in ARTIFACT_DIRS:
        dirs[d] = os.path.join(output_dir, d)
        os.makedirs(dirs[d], exist_ok=True)

    if jsonl:
        dataset = JsonlDataset(jsonl)
    elif textvqa_json:
        dataset = TextVQADataset(textvqa_json, image_dir)
    else:
        raise ValueError("need --textvqa-json or --jsonl")
    # candidates come from the metadata alone (images decode one chunk at a
    # time); progress is keyed by the stable dataset index, so a resume
    # stays right if the set of loadable images changes between runs
    candidates = []
    for idx in range(len(dataset)):
        if dataset.samples[idx].get("question"):
            candidates.append(idx)
        if limit and len(candidates) >= limit:
            break
    if not candidates:
        print("No valid samples.")
        return {"processed": 0, "failed": 0}

    progress = ProgressManifest(
        os.path.join(dirs["checkpoints"], "processing_progress.json"))
    progress.install_handlers()
    remaining = [i for i in candidates if i not in progress.processed_internal_indices]
    print(f"Processing {len(remaining)} of {len(candidates)} samples.")

    # the device extracts batch N+1 while the writer thread writes batch N
    work_q: "queue.Queue" = queue.Queue(maxsize=2)
    sentinel = object()

    def writer():
        while True:
            item = work_q.get()
            if item is sentinel:
                return
            items, maps = item
            try:
                write_chunk(items, maps)
            except Exception as e:
                # the writer must never die: a dead consumer would block the
                # bounded queue and hang the driver
                print(f"Writer error for chunk starting at {items[0][0]}: {e}")
                for i, _img, _q, _meta in items:
                    try:
                        progress.mark(i, failed=True)
                    except Exception:
                        pass

    def write_chunk(items, maps):
        for k, (i, image, _question, meta) in enumerate(items):
            image_id = meta.get("image_id", f"sample{i}")
            sid = f"{image_id}_{meta['original_index']}"
            att = np.asarray(maps[k], np.float32)
            image = np.asarray(image, np.uint8)
            failed = False
            saved = {
                "original_image": None,
                "masked_image": None,
                "attention_map_image_from_api": None,
                "raw_attention_map_npy": None,
                "mota_mask_visualization": None,
                "mota_mask_npy": None,
                "warped_image_identity": None,
            }
            try:
                orig_path = os.path.join(dirs["original_images"], f"{sid}_original.png")
                write_png(orig_path, image)
                saved["original_image"] = orig_path

                raw_path = os.path.join(dirs["raw_attention_maps"], f"{sid}_raw_attn.npy")
                np.save(raw_path, att[None, None])  # (1, 1, n, n)
                saved["raw_attention_map_npy"] = raw_path

                attn_img_path = os.path.join(dirs["attention_maps_images"],
                                             f"{sid}_attn_map_img.png")
                a = att - att.min()
                a = a / max(a.max(), 1e-12)
                write_png(attn_img_path, (a * 255).astype(np.uint8))
                saved["attention_map_image_from_api"] = attn_img_path

                overlay, mota = blend_mask(image, att, enhance_coe, kernel_size,
                                           device=device)
                masked_path = os.path.join(dirs["masked_images"], f"{sid}_masked.png")
                write_png(masked_path, overlay)
                saved["masked_image"] = masked_path

                mota_vis = os.path.join(dirs["attention_maps"], f"{sid}_mota_mask_vis.png")
                write_png(mota_vis, mota)
                saved["mota_mask_visualization"] = mota_vis
                mota_npy = os.path.join(dirs["attention_maps"], f"{sid}_mota_mask.npy")
                np.save(mota_npy, mota)
                saved["mota_mask_npy"] = mota_npy

                warped_path = os.path.join(dirs["warped_images"], f"{sid}_identity.png")
                if save_warped_image(image_path=image, att_map=mota,
                                     original_image_save_path=None,
                                     masked_overlay_save_path=None,
                                     output_path=warped_path, width=width,
                                     height=height, transform="identity",
                                     device=device):
                    saved["warped_image_identity"] = warped_path
            except Exception as e:
                print(f"Error processing {sid}: {e}")
                failed = True
            finally:
                meta_out = dict(meta)
                meta_out["sample_id"] = sid
                meta_out["api_model_name"] = getattr(backend, "name", "unknown")
                meta_out["saved_paths"] = saved
                meta_path = os.path.join(dirs["metadata"], f"{sid}_metadata.json")
                try:
                    with open(meta_path, "w", encoding="utf-8") as f:
                        json.dump(meta_out, f, indent=2, ensure_ascii=False, default=str)
                except Exception as e:
                    print(f"Critical: metadata save failed for {sid}: {e}")
                    failed = True
                progress.mark(i, failed=failed)

    writer_thread = threading.Thread(target=writer, daemon=True)
    writer_thread.start()
    step = max(batch_size, 1)
    try:
        for start in range(0, len(remaining), step):
            items = []
            for i in remaining[start:start + step]:
                entry = dataset[i]              # decodes this chunk's images only
                if entry.get("loaded_image") is None:
                    progress.mark(i, failed=True)
                    continue
                meta = {k: v for k, v in entry.items() if k != "loaded_image"}
                meta["original_index"] = i
                items.append((i, entry["loaded_image"], entry["question"], meta))
            if not items:
                continue
            images = [im for _, im, _, _ in items]
            if getattr(backend, "supports_device_pixels", False):
                # one upload and one resize per shape group, on the device
                batch = resize_images_batch(images, backend.image_size, backend.device)
            else:
                batch = np.stack([resize_for_backend(im, backend.image_size)
                                  for im in images])
            maps, _texts = _extract_with_fallback(
                backend, batch, [q for _, _, q, _ in items], max_new_tokens)
            work_q.put((items, maps))
    finally:
        work_q.put(sentinel)
        writer_thread.join()

    print(f"Done. processed={progress.processed_count} failed={progress.failed_count}")
    return {"processed": progress.processed_count, "failed": progress.failed_count}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    backend = make_backend(args.backend, args.layer_index, args.device)
    if hasattr(backend, "build_ids") and backend.tokenizer is None:
        # without a tokenizer every extraction fails and every sample would
        # get the uniform fallback map
        raise SystemExit(f"{args.backend!r} has no tokenizer; the driver needs "
                         "one to build prompts")
    stats = process_dataset(
        args.textvqa_json,
        args.image_dir,
        args.output_dir,
        backend,
        jsonl=args.jsonl,
        batch_size=args.batch_size,
        max_new_tokens=args.max_new_tokens,
        enhance_coe=args.enhance_coe,
        kernel_size=args.kernel_size,
        width=args.width,
        height=args.height,
        limit=args.limit,
        device=args.device,
    )
    return 0 if stats["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
