"""Learned-warp evidence chain: driver -> train -> predict -> warp -> gain
(counterpart of ``tools/run_marginalnet_chain.py``, with the same steps,
flags and defaults, plus ``--device``).

1. synthesize a code-tag TextVQA train set (seed 100) and a disjoint eval
   set (seed 900) (``testing/reader.py::write_textvqa_dataset``);
2. run the dataset driver (``cli/process_dataset.py --backend reader``) on
   the train set for its attention artifacts;
3. train MarginalNet on those artifacts with the frozen reader-proxy
   features (``testing/reader.py::ReaderFeatureExtractor``) through
   ``train/trainer.py::train_loop``;
4. for each eval image (never seen in training), predict the marginals and
   warp from the predicted CDFs (``marginalnet/inference.py::
   predict_and_warp``, chunks of 10; no oracle attention pass) and write
   the driver's ``saved_paths`` metadata;
5. score warped against original through the harness (``cli/evaluate.py
   --model reader --score-original``);
6. run the driver on the eval set and score it the same way: the oracle
   on the same eval set;
7. write the JAX tool's JSON to ``--out-json`` (default: in the work
   directory), with the wall of each stage added under ``stage_seconds``.

    python -m attwarp_tpu_torch.tools.run_marginalnet_chain /tmp/mn_chain \\
        --device cuda --out-json /tmp/mn_chain/gain.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run-marginalnet-chain (PyTorch)")
    p.add_argument("workdir")
    p.add_argument("--n-train", type=int, default=240)
    p.add_argument("--n-eval", type=int, default=50)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--out-json", default=None,
                   help="result JSON (default: marginalnet_accuracy_gain.json in workdir)")
    p.add_argument("--geometry", choices=("center", "hard"), default="center",
                   help="'hard' = off-center varying-scale tags among distractors")
    p.add_argument("--device", default="cuda",
                   help="torch device of the driver, training and warps (default cuda)")
    return p


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from attwarp_tpu_torch.cli import evaluate as evaluate_cli
    from attwarp_tpu_torch.cli import process_dataset as process_cli
    from attwarp_tpu_torch.data.imageio import read_rgb, resize_u8, write_png
    from attwarp_tpu_torch.data.loader import batch_iterator
    from attwarp_tpu_torch.data.manifests import MetadataDirDataset
    from attwarp_tpu_torch.marginalnet.inference import predict_and_warp
    from attwarp_tpu_torch.testing.reader import (
        ReaderFeatureExtractor,
        write_textvqa_dataset,
    )
    from attwarp_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint
    from attwarp_tpu_torch.train.config import TrainConfig
    from attwarp_tpu_torch.train.train_step import create_train_state
    from attwarp_tpu_torch.train.trainer import prepare_batch, train_loop
    from attwarp_tpu_torch.utils.device import require_device

    device = require_device(args.device, "run_marginalnet_chain")
    dev_args = ["--device", str(device)]
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    walls = {}
    t_all = t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        _sync(device)
        walls[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # ── 1. datasets (disjoint seeds -> disjoint tag contents/positions) ──
    train_json, train_imgs = write_textvqa_dataset(
        os.path.join(wd, "train_data"), args.n_train, seed=100, geometry=args.geometry)
    eval_json, eval_imgs = write_textvqa_dataset(
        os.path.join(wd, "eval_data"), args.n_eval, seed=900, geometry=args.geometry)
    print(f"[chain] datasets: {args.n_train} train / {args.n_eval} eval ({args.geometry})")
    lap("scenes")

    def driver(json_path, image_dir, out_dir):
        meta = os.path.join(out_dir, "metadata")
        if not os.path.isdir(meta) or not os.listdir(meta):
            rc = process_cli.main([
                "--textvqa-json", json_path, "--image-dir", image_dir,
                "--output-dir", out_dir, "--backend", "reader", "--batch-size", "8",
            ] + dev_args)
            if rc not in (0, None):
                raise RuntimeError(f"process_dataset exited {rc}")
        return meta

    # ── 2. the driver on the train set (oracle artifacts) ──────────────
    proc_meta = driver(train_json, train_imgs, os.path.join(wd, "processed_train"))
    print(f"[chain] driver artifacts: {len(os.listdir(proc_meta))} samples")
    lap("driver_train")

    # ── 3. train MarginalNet on the driver's artifacts ──────────────────
    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size,
        image_size=args.image_size, vis_every=10_000, log_every=50,
        checkpoint_every_epochs=args.epochs,  # final checkpoint only
        experiments_root=os.path.join(wd, "experiments"),
        warmup_steps=0, alpha0=0.0, mllm_backend="mini",  # unused: feats injected
    )
    dataset = MetadataDirDataset(proc_meta, image_size=args.image_size)
    feats = ReaderFeatureExtractor()
    run_dir = train_loop(cfg, dataset=dataset, feature_extractor=feats, device=device)
    lap("training")

    # restore the trained parameters
    probe = next(batch_iterator(dataset, [0, 1], 2, drop_last=False))
    _, state = create_train_state(cfg, 0, prepare_batch(probe, feats, device))
    ep, ckpt = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    state = restore_checkpoint(ckpt, state)
    model = state.model.eval()
    print(f"[chain] trained; restored epoch-{ep} checkpoint")

    # ── 4. learned warp on the EVAL set (no oracle attention pass) ──────
    with open(eval_json) as f:
        eval_meta = json.load(f)["data"]
    out_root = os.path.join(wd, "learned_eval")
    meta_dir = os.path.join(out_root, "metadata")
    warp_dir = os.path.join(out_root, "warped_images")
    orig_dir = os.path.join(out_root, "original_images")
    for d in (meta_dir, warp_dir, orig_dir):
        os.makedirs(d, exist_ok=True)

    S = args.image_size
    B_EV = 10
    for start in range(0, len(eval_meta), B_EV):
        chunk = eval_meta[start:start + B_EV]
        imgs = [read_rgb(os.path.join(eval_imgs, f"{e['image_id']}.jpg")) for e in chunk]
        batch = np.stack([resize_u8(im, (S, S)).astype(np.float32) / 255.0 for im in imgs])
        fmap = torch.as_tensor(feats.visual_tokens(batch), device=device)
        ttok, tmask = (torch.as_tensor(t, device=device)
                       for t in feats.text_tokens([e["question"] for e in chunk]))
        warped, _px, _py = predict_and_warp(
            model, torch.as_tensor(batch, device=device), fmap, ttok, tmask,
            out_size=(500, 500))
        warped = np.clip(warped.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
        for e, im, w in zip(chunk, imgs, warped):
            sid = e["image_id"]
            wpath = os.path.join(warp_dir, f"{sid}_warped.png")
            opath = os.path.join(orig_dir, f"{sid}_original.png")
            write_png(wpath, w)
            write_png(opath, im)
            with open(os.path.join(meta_dir, f"{sid}_metadata.json"), "w") as f:
                json.dump({
                    "sample_id": sid,
                    "question": e["question"],
                    "answers": e["answers"],
                    "saved_paths": {
                        "warped_image_identity": wpath,
                        "original_image": opath,
                    },
                }, f)
    print(f"[chain] learned-warped {len(eval_meta)} eval images")
    lap("prediction")

    # ── 5. score through the harness ────────────────────────────────────
    def score(meta_path, out_dir):
        rc = evaluate_cli.main([
            "--metadata-dir", meta_path, "--output-dir", out_dir,
            "--model", "reader", "--score-original", "--batch-size", "8",
        ] + dev_args)
        if rc not in (0, None):
            raise RuntimeError(f"evaluate exited {rc}")
        finals = sorted(
            f for f in os.listdir(out_dir)
            if f.startswith("textvqa_accuracy_") and f.endswith(".json")
            and "interim" not in f
        )
        with open(os.path.join(out_dir, finals[-1])) as f:
            return json.load(f)

    final = score(meta_dir, os.path.join(wd, "eval_out"))
    lap("harness_learned")

    # ── 6. oracle on the SAME eval set, at the driver's input contract:
    # the driver warps from the image-res MOTA mask (main.py:500-533), the
    # same mask the learned targets come from (MetadataDirDataset
    # attention_key="mota"), so learned and oracle compare on identical
    # data with identical warp semantics
    proc_eval = driver(eval_json, eval_imgs, os.path.join(wd, "processed_eval"))
    lap("driver_eval")
    oracle = score(proc_eval, os.path.join(wd, "eval_out_oracle"))
    lap("harness_oracle")
    final["oracle_same_eval_set"] = {
        "overall_warped_accuracy": oracle["overall_warped_accuracy"],
        "overall_original_accuracy": oracle.get("overall_original_accuracy"),
        "accuracy_gain": oracle.get("accuracy_gain"),
        "path": "driver image-res MOTA-mask warp (production contract)",
    }

    # ── 7. the result ───────────────────────────────────────────────────
    final["model"] = "marginalnet+reader"
    final["geometry"] = args.geometry
    final["produced_by"] = (
        f"attwarp_tpu_torch/tools/run_marginalnet_chain.py on {device}: "
        f"process_dataset --backend reader (n={args.n_train}) -> train_loop "
        f"({args.epochs} epochs, bs {args.batch_size}, image {S}px, "
        f"ReaderFeatureExtractor frozen features) -> predict_and_warp on a "
        f"disjoint eval set (n={args.n_eval}, NO oracle attention pass) -> "
        f"cli.evaluate --score-original"
    )
    final["stage_seconds"] = walls
    out_json = args.out_json or os.path.join(wd, "marginalnet_accuracy_gain.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(final, f, indent=2)
    print(f"[chain] done in {time.perf_counter() - t_all:.0f}s: "
          f"warped={final['overall_warped_accuracy']:.3f} "
          f"original={final.get('overall_original_accuracy')} "
          f"gain={final.get('accuracy_gain')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
