"""Manifest-driven training datasets.

Parity with ``model/marginalnet_full_dataset/dataloader.py``:
- ``FullDataset`` (dataloader.py:34-273): mixes GQA/TextVQA/DocVQA entries
  from ``logs/metadata.jsonl`` under each dataset root; artifact selection by
  (type, layer) with highest-layer fallback (:143-157); attention loading
  with the npy -> raw -> overlay fallback chain and [0,1] normalization
  (:160-189); ``CLIP/`` -> ``data/`` path remap (:192-202); seeded
  ``num_samples_per_dataset`` subsample + shuffle (:111-121); GQA bucket
  passthrough (:267-272).
- ``MixedMetadataDataset`` = legacy ``MixedGQATextVQADataset`` (:275-402)
  over the drivers' per-sample ``*_metadata.json`` + ``saved_paths`` schema.
- transform routing (data.py:10-47): GQA bucket -> transform name (fallback
  'sqrt'), everything else 'iden'.

Items are numpy (images HWC float [0,1], attention (H, W) float);
batching/collation lives in attwarp_tpu_torch.data.loader. A copy of
``attwarp_tpu/data/manifests.py`` whose image files and resizes go through
``data/imageio.py`` (Pillow, imported at first use); the tests pin its
items equal to the original's.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from attwarp_tpu_torch.data.imageio import read_gray, read_rgb, resize_u8

GQA_CATEGORY_TO_TRANSFORM: Dict[str, str] = {
    "query_rel": "sqrt",
    "query_attr": "sqrt",
    "verify_rel": "sqrt",
    "logical_attr": "none",
    "query_cat": "sqrt",
    "verify_attr": "none",
    "choose_attr": "iden",
    "logical_obj": "iden",
    "compare_attr": "none",
    "choose_rel": "sqrt",
    "verify_obj": "sqrt",
    "query_global": "sqrt",
    "choose_cat": "iden",
    "verify_global": "none",
    "choose_global": "sqrt",
}


def load_gqa_transform_map(_: str = "") -> Dict[str, str]:
    return dict(GQA_CATEGORY_TO_TRANSFORM)


def transform_for_sample(
    dataset_name: Any, bucket: Any, mapping: Dict[str, str]
) -> str:
    """GQA: bucket map with 'sqrt' fallback; others: 'iden'."""
    try:
        ds = str(dataset_name).lower() if dataset_name is not None else ""
        if "gqa" in ds:
            b = str(bucket) if bucket is not None else None
            if b in mapping:
                return mapping[b]
            return "sqrt"
        return "iden"
    except Exception:
        return "iden"


def resolve_file_path(path: Optional[str]) -> Optional[str]:
    """Existing path, or the ``CLIP/`` -> ``data/`` remap, else None."""
    if not path:
        return None
    if os.path.isfile(path):
        return path
    if "CLIP/" in path:
        alt = path.replace("CLIP/", "data/", 1)
        if os.path.isfile(alt):
            return alt
    return None


def select_artifact(
    artifacts: List[Dict[str, Any]], desired_layer: int, desired_type: str
) -> Optional[Dict[str, Any]]:
    """Exact (type, layer) match, else highest layer among same type, else
    any artifact."""
    if not artifacts:
        return None
    same_type = [
        a for a in artifacts if str(a.get("type", "")).lower() == desired_type
    ]
    if not same_type:
        same_type = artifacts
    for a in same_type:
        if int(a.get("layer", -1)) == int(desired_layer):
            return a
    try:
        return sorted(same_type, key=lambda x: int(x.get("layer", -1)))[-1]
    except Exception:
        return same_type[0]


def load_attention_artifact(artifact: Dict[str, Any]) -> np.ndarray:
    """npy -> raw -> overlay fallback chain; normalized to [0,1] float32."""
    npy_path = resolve_file_path(artifact.get("npy_path"))
    raw_path = resolve_file_path(artifact.get("raw_path"))
    overlay_path = resolve_file_path(artifact.get("overlay_path"))

    if npy_path:
        arr = np.load(npy_path)
    elif raw_path:
        arr = np.load(raw_path)
    elif overlay_path:
        return read_gray(overlay_path).astype(np.float32) / 255.0
    else:
        raise FileNotFoundError("No valid artifact path found (npy/raw/overlay)")

    arr = np.asarray(arr, dtype=np.float32)
    arr = np.squeeze(arr)
    if arr.ndim == 3:
        arr = arr.mean(axis=2)
    max_val = float(arr.max()) if arr.size else 0.0
    if max_val > 1.0:
        arr = arr / max_val
    arr = np.nan_to_num(arr, nan=0.0, posinf=0.0, neginf=0.0)
    return np.clip(arr, 0.0, 1.0)


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    entries: List[Dict[str, Any]] = []
    if not os.path.isfile(path):
        return entries
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                if isinstance(obj, dict):
                    entries.append(obj)
            except Exception:
                continue
    return entries


def _load_image_rgb(path: str) -> np.ndarray:
    return read_rgb(path).astype(np.float32) / 255.0


def _resize_np(
    arr: np.ndarray, hw: Tuple[int, int], nearest: bool = False
) -> np.ndarray:
    """PIL-based resize matching the reference's torchvision path: bilinear
    for images, NEAREST for attention maps. The uint8 round-trip (255
    levels) is intentional reference parity — the reference also builds a
    PIL 'L' image from ``(attn * 255).astype(uint8)`` (dataloader.py:230-238).
    """
    res = resize_u8((np.clip(arr, 0, 1) * 255).astype(np.uint8), hw, nearest)
    return res.astype(np.float32) / 255.0


class FullDataset:
    """Mixes GQA/TextVQA/DocVQA log entries; see module docstring."""

    def __init__(
        self,
        gqa_root_dir: str,
        textvqa_root_dir: str,
        docvqa_root_dir: str,
        num_samples_per_dataset: int = 15000,
        artifact_type: str = "relative",
        artifact_layer: int = 16,
        random_seed: int = 42,
        image_size: Optional[int] = None,
    ):
        if artifact_type not in {"relative", "absolute"}:
            raise ValueError("artifact_type must be 'relative' or 'absolute'")
        self.artifact_type = artifact_type
        self.artifact_layer = int(artifact_layer)
        self.image_size = int(image_size) if image_size is not None else None

        rng = random.Random(random_seed)
        pools = {
            "gqa": _read_jsonl(os.path.join(gqa_root_dir, "logs", "metadata.jsonl")),
            "textvqa": _read_jsonl(os.path.join(textvqa_root_dir, "logs", "metadata.jsonl")),
            "docvqa": _read_jsonl(os.path.join(docvqa_root_dir, "logs", "metadata.jsonl")),
        }
        for name, entries in pools.items():
            if len(entries) < num_samples_per_dataset:
                raise ValueError(
                    f"Not enough log samples in {name} "
                    f"({len(entries)} < {num_samples_per_dataset})"
                )
        self.samples: List[Tuple[Dict[str, Any], str]] = []
        for name in ("gqa", "textvqa", "docvqa"):
            for entry in rng.sample(pools[name], num_samples_per_dataset):
                self.samples.append((entry, name))
        rng.shuffle(self.samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        meta, dataset_name = self.samples[idx]
        question = meta.get("question", "")
        answer_val = meta.get("answer", None)
        answer = answer_val if isinstance(answer_val, str) else ""

        img_path = resolve_file_path(meta.get("image_path"))
        if not img_path:
            raise FileNotFoundError(f"Image path not found: {meta.get('image_path')}")
        image = _load_image_rgb(img_path)

        art = select_artifact(
            meta.get("artifacts", []), self.artifact_layer, self.artifact_type
        )
        if art is None:
            raise FileNotFoundError("No artifacts listed in log JSON")
        attn = load_attention_artifact(art)

        if self.image_size is not None:
            image = _resize_np(image, (self.image_size, self.image_size))
            attn = _resize_np(attn, (self.image_size, self.image_size), nearest=True)
        elif attn.shape != image.shape[:2]:
            attn = _resize_np(attn, image.shape[:2], nearest=True)

        dset = str(meta.get("dataset", dataset_name))
        qid = (
            meta.get("question_id")
            or meta.get("questionId")
            or meta.get("qid")
            or meta.get("id")
        )
        bucket = (
            (
                meta.get("bucket")
                or meta.get("category")
                or meta.get("gqa_bucket")
                or meta.get("question_type")
            )
            if "gqa" in dset.lower()
            else None
        )
        return {
            "image": image,            # (H, W, 3) float32 [0, 1]
            "attention_map": attn,     # (H, W) float32 [0, 1]
            "question": question,
            "answer": answer,
            "dataset": dset,
            "question_id": qid,
            "bucket": bucket,
        }


class MetadataDirDataset:
    """Training dataset over ONE driver output's ``metadata/`` directory
    (the ``saved_paths`` contract of ``cli/process_dataset.py``) — the
    single-dataset complement of ``MixedMetadataDataset`` for training
    MarginalNet directly on artifacts the driver just produced (the
    learned-warp evidence chain: driver -> train -> predict_and_warp ->
    evaluate).

    ``attention_key`` picks the training target: ``"mota"`` (default) is
    the image-res enhanced mask — the exact quantity the oracle driver
    warps with (main.py:500-533) — with raw-attention fallback; ``"raw"``
    forces the raw extracted map.
    """

    def __init__(self, metadata_dir: str, image_size: Optional[int] = None,
                 dataset_name: str = "textvqa", attention_key: str = "mota"):
        self.image_size = int(image_size) if image_size is not None else None
        self.dataset_name = dataset_name
        self.attention_key = attention_key
        self.paths = sorted(
            os.path.join(metadata_dir, f)
            for f in os.listdir(metadata_dir) if f.endswith(".json")
        )
        if not self.paths:
            raise FileNotFoundError(f"no metadata JSONs in {metadata_dir}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        with open(self.paths[idx], "r") as f:
            meta = json.load(f)
        saved = meta.get("saved_paths", {})
        image = _load_image_rgb(saved["original_image"])
        keys = (["mota_mask_npy", "raw_attention_map_npy"]
                if self.attention_key == "mota"
                else ["raw_attention_map_npy"])
        attn = None
        for k in keys:
            p = saved.get(k)
            if p and os.path.isfile(p):
                arr = np.squeeze(np.asarray(np.load(p), np.float32))
                if arr.ndim == 3:
                    arr = arr.mean(axis=2)
                # same value rule as MixedMetadataDataset._load_attention
                # (reference dataloader.py:275-402): 0-255-scaled artifacts
                # divide by 255 — NOT by per-sample max, which would
                # contrast-stretch targets differently per sample
                if arr.max() > 1.0:
                    arr = arr / 255.0
                attn = np.clip(arr, 0.0, 1.0)
                break
        if attn is None:
            raise FileNotFoundError(f"no attention artifact for {self.paths[idx]}")
        if self.image_size is not None:
            image = _resize_np(image, (self.image_size, self.image_size))
            attn = _resize_np(attn, (self.image_size, self.image_size),
                              nearest=True)
        elif attn.shape != image.shape[:2]:
            attn = _resize_np(attn, image.shape[:2], nearest=True)
        answers = meta.get("answers", [])
        return {
            "image": image,
            "attention_map": attn,
            "question": meta.get("question", ""),
            "answer": answers[0] if answers else "",
            "dataset": self.dataset_name,
            "question_id": meta.get("question_id") or meta.get("sample_id"),
            "bucket": None,
        }


class MixedMetadataDataset:
    """Legacy per-sample ``*_metadata.json`` dataset over the drivers'
    ``saved_paths`` contract (dataloader.py:275-402)."""

    def __init__(
        self,
        gqa_metadata_dir: str,
        textvqa_metadata_dir: str,
        num_samples_per_dataset: int = 2000,
        image_size: int = 224,
        random_seed: int = 42,
    ):
        self.image_size = image_size
        rng = random.Random(random_seed)

        def _list(d):
            return sorted(
                os.path.join(d, f) for f in os.listdir(d) if f.endswith("_metadata.json")
            )

        gqa_all, tv_all = _list(gqa_metadata_dir), _list(textvqa_metadata_dir)
        if len(gqa_all) < num_samples_per_dataset or len(tv_all) < num_samples_per_dataset:
            raise ValueError("Not enough samples in one of the datasets")
        self.samples: List[Tuple[str, str]] = [
            *((p, "gqa") for p in rng.sample(gqa_all, num_samples_per_dataset)),
            *((p, "textvqa") for p in rng.sample(tv_all, num_samples_per_dataset)),
        ]
        rng.shuffle(self.samples)

    def __len__(self) -> int:
        return len(self.samples)

    def _load_attention(self, saved_paths: Dict[str, Any]) -> np.ndarray:
        npy = saved_paths.get("mota_mask_npy") or saved_paths.get("raw_attention_map_npy")
        if npy and os.path.isfile(npy):
            arr = np.asarray(np.load(npy), np.float32)
            arr = np.squeeze(arr)
            if arr.ndim == 3:
                arr = arr.mean(axis=2)
            if arr.max() > 1.0:
                arr = arr / 255.0
            return arr
        img = saved_paths.get("mota_mask_visualization") or saved_paths.get(
            "attention_map_image_from_api"
        )
        if img and os.path.isfile(img):
            return read_gray(img).astype(np.float32) / 255.0
        raise FileNotFoundError("No attention map found for sample")

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        meta_path, dataset_name = self.samples[idx]
        with open(meta_path, "r") as f:
            meta = json.load(f)
        question = meta["question"]
        if dataset_name == "gqa":
            answer = meta["answer"]
        else:
            answers = meta.get("answers", [])
            answer = answers[0] if answers else ""
        saved_paths = meta["saved_paths"]
        image = _load_image_rgb(saved_paths["original_image"])
        attn = self._load_attention(saved_paths)
        hw = (self.image_size, self.image_size)
        image = _resize_np(image, hw)
        attn = _resize_np(attn, hw, nearest=True)
        warped_path = (
            saved_paths.get("warped_image_identity")
            or saved_paths.get("warped_image")
            or saved_paths.get("saved_warped_image")
        )
        if warped_path and os.path.isfile(warped_path):
            warped = _resize_np(_load_image_rgb(warped_path), hw)
        else:
            warped = np.zeros_like(image)
        qid = (
            meta.get("question_id")
            or meta.get("questionId")
            or meta.get("qid")
            or meta.get("id")
        )
        return {
            "image": image,
            "attention_map": attn,
            "saved_warped_image": warped,
            "question": question,
            "answer": answer,
            "dataset": dataset_name,
            "question_id": qid,
            "bucket": None,
        }
