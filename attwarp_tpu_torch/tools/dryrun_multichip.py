"""Dry run of the parallel layer on n ranks (counterpart of
``__graft_entry__.py::dryrun_multichip``).

Spawns n gloo ranks on the CPU, lays them out as a ``(n/2, 2)`` mesh
(``(n, 1)`` for odd n) and runs on tiny shapes:

1. one full sharded MarginalNet train step (hidden 128, so its kernels
   split over ``model``), and
2. the tensor-parallel tiny LLaVA: generate with extraction, the w8a8
   decoder extracting two layers, and ``ServeEngine`` with an int8 KV cache
   over it.

Every rank's loss, tokens and maps must be finite, and equal across the
ranks (each holds a replicated result). Prints one JSON line; exits 0.

    python -m attwarp_tpu_torch.tools.dryrun_multichip --ranks 4
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def _rank(rank: int, world: int):
    from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
    from attwarp_tpu_torch.models.llama import LlamaConfig
    from attwarp_tpu_torch.models.llava import LlavaConfig, LlavaModel, random_params
    from attwarp_tpu_torch.numerics.quant import quantize_decoder_params
    from attwarp_tpu_torch.parallel.llava_sharding import shard_llava_params
    from attwarp_tpu_torch.parallel.mesh import make_mesh
    from attwarp_tpu_torch.serving.engine import ServeEngine
    from attwarp_tpu_torch.train.config import TrainConfig
    from attwarp_tpu_torch.train.train_step import create_train_state, make_sharded_train_step

    n_model = 2 if world % 2 == 0 else 1
    n_data = world // n_model
    mesh = make_mesh(n_data=n_data, n_model=n_model)

    rng = np.random.default_rng(0)
    B = max(n_data * 2, 4)
    batch = {
        "image": rng.random((B, 64, 64, 3)),
        "attention_map": rng.random((B, 64, 64)),
        "sqrt_mask": rng.integers(0, 2, (B,)),
        "none_mask": np.zeros((B,)),
        "fmap_v": rng.random((B, 8, 8, 32)),
        "ttok": rng.random((B, 12, 48)),
        "tmask": np.ones((B, 12, 1)),
    }
    batch = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in batch.items()}
    cfg = TrainConfig(hidden=128)
    model, state = create_train_state(cfg, 0, batch)
    step_fn, s_state, s_batch = make_sharded_train_step(model, cfg, mesh, state, batch)
    _, metrics = step_fn(s_state, s_batch)
    loss = float(metrics["loss/total"])

    # the tensor-parallel MLLM path: a tiny LLaVA, generate + extraction
    lcfg = LlavaConfig(
        vision=ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, image_size=28, patch_size=14),
        text=LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2),
        image_token_index=99)
    full = random_params(lcfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
    ids = rng.integers(3, 90, size=(2, 12)).astype(np.int64)
    ids[:, 2:6] = 99
    pix = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    args = (torch.as_tensor(ids), torch.as_tensor(pix), torch.ones(ids.shape, dtype=torch.bool),
            torch.as_tensor([2, 2]))
    gen, maps = LlavaModel(lcfg, shard_llava_params(full, mesh, lcfg)).generate_with_attention(
        *args, extract_layer=1, max_new_tokens=2)

    # the int8 (w8a8) decoder under the same sharding, two layers extracted
    quantize_decoder_params(full["llama"])
    qmodel = LlavaModel(lcfg, shard_llava_params(full, mesh, lcfg))
    gen_q, maps_q = qmodel.generate_with_attention(*args, extract_layer=(0, 1),
                                                   max_new_tokens=2)

    # the serving engine over it, int8 KV slots
    eng = ServeEngine(qmodel, slots=2, max_seq=48, bucket=16, kv_quant=True,
                      steps_per_tick=2)
    eng.submit(ids[0], rng.standard_normal((28, 28, 3)).astype(np.float32), max_new_tokens=3)
    eng.submit(ids[1][:10], None, max_new_tokens=3)
    served = eng.run()
    return {"loss": loss, "gen": gen.numpy(), "maps": maps.numpy(),
            "gen_q": gen_q.numpy(), "maps_q": maps_q.numpy(),
            "served": served, "jax": "jax" in sys.modules}


def dryrun_multichip(n_devices: int) -> dict:
    """Run the dry run on ``n_devices`` spawned ranks; returns rank 0's
    results after checking every rank's."""
    from attwarp_tpu_torch.testing.ranks import run_ranks

    outs = run_ranks(_rank, n_devices)
    first = outs[0]
    for r, out in enumerate(outs):
        if not np.isfinite(out["loss"]):
            raise AssertionError(f"rank {r}: non-finite loss {out['loss']}")
        for k in ("maps", "maps_q"):
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"rank {r}: non-finite {k}")
        if out["maps_q"].shape[0] != 2:
            raise AssertionError(f"rank {r}: maps_q {out['maps_q'].shape} is not (L=2, ...)")
        if out["jax"]:
            raise AssertionError(f"rank {r} imported JAX")
        same = (out["loss"] == first["loss"] and out["served"] == first["served"]
                and all(np.array_equal(out[k], first[k])
                        for k in ("gen", "maps", "gen_q", "maps_q")))
        if not same:
            raise AssertionError(f"rank {r}'s results differ from rank 0's")
    return first


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.ranks)
    print(json.dumps({"ranks": args.ranks, "loss": out["loss"],
                      "tokens": out["gen"].tolist(), "served": {str(k): v for k, v in
                                                                out["served"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
