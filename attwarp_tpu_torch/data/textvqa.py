"""TextVQA dataset reader, the driver's input (counterpart of
``attwarp_tpu/data/textvqa.py``).

Parity with ``main.py:82-181`` / ``main_batched.py:68-101``: loads the
``TextVQA_0.5.1_val.json`` layout (``{dataset_type, dataset_name,
dataset_version, data: [...]}``) and reads ``{image_id}.jpg`` under the
image directory through ``data/imageio.py`` (Pillow). A missing or
unreadable image gives ``loaded_image = None``; on a machine without
Pillow reading raises. JAX's
optional flickr download (``download_images``), which no driver turns on,
is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from attwarp_tpu_torch.data.imageio import MissingPillowError, read_rgb


class TextVQADataset:
    def __init__(self, json_path: str, image_dir: Optional[str] = None):
        self.json_path = json_path
        self.image_dir = image_dir
        self.metadata: Dict[str, Any] = {}
        self.samples: List[Dict[str, Any]] = []
        try:
            with open(json_path, "r") as f:
                data = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError) as e:
            print(f"Error loading TextVQA json: {e}")
            return
        self.metadata = {
            "dataset_type": data.get("dataset_type"),
            "dataset_name": data.get("dataset_name"),
            "dataset_version": data.get("dataset_version"),
        }
        self.samples = data.get("data", [])

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if idx < 0 or idx >= len(self.samples):
            raise IndexError(idx)
        sample = dict(self.samples[idx])
        sample["loaded_image"] = self._get_image(sample)
        return sample

    def _get_image(self, sample: Dict[str, Any]) -> Optional[np.ndarray]:
        image_id = sample.get("image_id")
        if not image_id or not self.image_dir:
            return None
        path = os.path.join(self.image_dir, f"{image_id}.jpg")
        if not os.path.exists(path):
            return None
        try:
            return read_rgb(path)
        except MissingPillowError:
            raise
        except Exception as e:
            print(f"Error reading {path}: {e}")
            return None
