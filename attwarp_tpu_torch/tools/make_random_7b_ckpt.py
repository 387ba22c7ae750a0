"""Write a random-weights LLaVA-1.5-7B checkpoint directory of the port
(counterpart of ``tools/make_random_7b_ckpt.py``).

The geometry of ``llava-hf/llava-1.5-7b-hf`` (CLIP-L/14-336 vision tower,
32-layer 4096-wide LLaMA decoder, vocabulary 32064 with the image token at
32000), random bf16 weights made on the device from a seeded
``torch.Generator`` (``models/llava.py::random_params``), and the dry-run
word-level tokenizer (``extract/tokenizer.py``), written by
``LlavaBackend.save`` (~14 GB). Every driver then runs at 7B shape with no
download:

    python -m attwarp_tpu_torch.tools.make_random_7b_ckpt --out /ckpt/llava7b
    python -m attwarp_tpu_torch.cli.process_dataset \\
        --backend llava-ckpt:/ckpt/llava7b+int8+kv8+flash ...

``--device`` defaults to ``cuda`` and never falls back to the CPU.
"""

from __future__ import annotations

import argparse

import torch

from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.models.llama import LlamaConfig
from attwarp_tpu_torch.models.llava import LlavaConfig, LlavaModel, random_params
from attwarp_tpu_torch.utils.device import require_device


def llava_7b_config() -> LlavaConfig:
    """llava-hf/llava-1.5-7b-hf: the default CLIP-L/14-336 tower and 7B
    decoder, the text vocabulary padded to 32064, the image token at 32000."""
    return LlavaConfig(text=LlamaConfig(vocab_size=32064), image_token_index=32000)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("make-random-7b-ckpt (PyTorch)")
    p.add_argument("--out", required=True, help="output checkpoint directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device the weights are made on")
    args = p.parse_args(argv)

    device = require_device(args.device, "make_random_7b_ckpt")
    cfg = llava_7b_config()
    print(f"Generating random bf16 LLaVA-1.5-7B-shape parameters on {device} ...")
    params = random_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                           device, torch.bfloat16)
    print(f"Saving the checkpoint to {args.out} ...")
    LlavaBackend(LlavaModel(cfg, params), tokenizer=DryRunTokenizer()).save(args.out)
    print("Done. Load with LlavaBackend.load or --backend llava-ckpt:<dir> "
          "(tokenizer included).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
