"""Rank programs of the port's parallel tests (``test_torch_parallel.py``,
``test_torch_sp_prefill.py``, ``test_torch_disagg.py``).

Each job runs inside a spawned gloo rank (``attwarp_tpu_torch/testing/
ranks.py``), so this module imports neither JAX nor the JAX package. Inputs
come from the parent as numpy (weights as numpy trees, converted with the
port's ``params_from_jax``); results go back as numpy. ``run_jobs`` runs a
list of jobs in one spawn, each on a mesh of its own.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    if isinstance(x, (tuple, list)):
        return [_np(t) for t in x]
    return x


def run_jobs(rank: int, world: int, jobs):
    """``jobs``: [(key, function name, kwargs)]; returns {key: result} plus
    whether JAX or the JAX package was imported in this rank."""
    out = {}
    for key, name, kw in jobs:
        out[key] = globals()[name](rank, world, **kw)
    out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "attwarp_tpu."))
                              or m == "attwarp_tpu" for m in sys.modules)
    return out


def _mesh(world, n_model):
    from attwarp_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_data=world // n_model, n_model=n_model)


# ── the sharded warp and the loader ─────────────────────────────────────


def warp(rank, world, images, atts, size):
    from attwarp_tpu_torch.parallel.mesh import shard_batch
    from attwarp_tpu_torch.parallel.warp_sharded import make_sharded_warp

    mesh = _mesh(world, 1)
    b = shard_batch({"i": torch.as_tensor(images), "a": torch.as_tensor(atts)}, mesh)
    local = make_sharded_warp(mesh, size[1], size[0])(b["i"], b["a"])
    whole = make_sharded_warp(mesh, size[1], size[0], gather=True)(b["i"], b["a"])
    return _np(local), _np(whole)


def host_indices(rank, world, n_model, indices):
    from attwarp_tpu_torch.data.loader import host_local_indices

    mesh = _mesh(world, n_model)
    return mesh.data.rank, host_local_indices(indices)


# ── tensor-parallel LLaVA and Qwen2-VL ──────────────────────────────────


def _llava(tree, cfg, int8):
    from attwarp_tpu_torch.models.llava import config_from_dict, params_from_jax
    from attwarp_tpu_torch.numerics.quant import quantize_decoder_params

    cfg = config_from_dict(cfg)
    params = params_from_jax(tree)
    if int8:
        quantize_decoder_params(params["llama"])
    return cfg, params


def llava_generate(rank, world, tree, cfg, inputs, n_model, kv_quant=False, int8=False,
                   shard_data=False):
    """Tensor-parallel generate; with ``shard_data`` the batch is split over
    the data axis too. Returns (data rank, tokens, maps, local shapes)."""
    from attwarp_tpu_torch.models.llava import LlavaModel
    from attwarp_tpu_torch.parallel.llava_sharding import shard_llava_params
    from attwarp_tpu_torch.parallel.mesh import shard_batch

    mesh = _mesh(world, n_model)
    cfg, params = _llava(tree, cfg, int8)
    sharded = shard_llava_params(params, mesh, cfg)
    del params
    ids, pix, mask, start = (torch.as_tensor(a) for a in inputs)
    if shard_data:
        b = shard_batch({"ids": ids, "pix": pix, "mask": mask, "start": start}, mesh)
        ids, pix, mask, start = b["ids"], b["pix"], b["mask"], b["start"]
    gen, maps = LlavaModel(cfg, sharded).generate_with_attention(
        ids, pix, mask, start, extract_layer=1, max_new_tokens=4, kv_quant=kv_quant)
    lp = sharded["llama"]["layers"][0]
    shapes = {k: ({n: tuple(t.shape) for n, t in lp[k].items()} if isinstance(lp[k], dict)
                  else tuple(lp[k].shape)) for k in ("q_proj", "k_proj", "o_proj", "down_proj")}
    shapes["vision_q"] = tuple(sharded["vision"]["layers"][0]["q_proj"]["weight"].shape)
    return mesh.data.rank, _np(gen), _np(maps), shapes


def llava_serve(rank, world, tree, cfg, requests, n_model, kv_quant, chunk=0):
    """``ServeEngine`` (or, with ``chunk``, ``ChunkedPrefillEngine``)
    unchanged over a tensor-parallel LLaVA."""
    from attwarp_tpu_torch.models.llava import LlavaModel
    from attwarp_tpu_torch.parallel.llava_sharding import shard_llava_params
    from attwarp_tpu_torch.serving import ChunkedPrefillEngine, ServeEngine

    mesh = _mesh(world, n_model)
    cfg, params = _llava(tree, cfg, False)
    model = LlavaModel(cfg, shard_llava_params(params, mesh, cfg))
    kw = dict(slots=2, max_seq=128, kv_quant=kv_quant, steps_per_tick=4)
    eng = ChunkedPrefillEngine(model, prefill_chunk=chunk, **kw) if chunk else ServeEngine(
        model, **kw)
    for ids, pix, max_new in requests:
        eng.submit(ids, pix, max_new_tokens=max_new)
    return eng.run()


def qwen_generate(rank, world, tree, cfg, ids, patches, grid, mask, n_model, kv_quant):
    from attwarp_tpu_torch.models.llava import params_from_jax
    from attwarp_tpu_torch.models.qwen2vl import Qwen2VLModel, config_from_dict
    from attwarp_tpu_torch.parallel.llava_sharding import shard_qwen2vl_params

    mesh = _mesh(world, n_model)
    cfg = config_from_dict(cfg)
    params = shard_qwen2vl_params(params_from_jax(tree), mesh, cfg)
    gen, maps = Qwen2VLModel(cfg, params).generate_with_attention(
        torch.as_tensor(ids), torch.as_tensor(patches), tuple(grid),
        torch.as_tensor(mask).bool(), extract_layer=1, max_new_tokens=3, kv_quant=kv_quant)
    return _np(gen), _np(maps), tuple(params["text"]["layers"][0]["k_proj"]["weight"].shape)


# ── sequence-parallel prefill ───────────────────────────────────────────


def _greedy_decode(params, cfg, cache, logits, mask, steps):
    """Greedy decode steps from a prefill cache (LLaMA rotary positions)."""
    from attwarp_tpu_torch.models.llama import embed, llama_decode_step

    B, T = mask.shape
    full = torch.nn.functional.pad(mask, (0, cache[0].shape[2] - T))
    lengths = mask.sum(dim=1)
    tok = torch.argmax(logits, dim=-1)
    toks = [tok]
    for step in range(steps):
        full[:, T + step] = True
        logits, cache, _ = llama_decode_step(params, cfg, embed(params, tok)[:, None], cache,
                                             T + step, lengths + step, full)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def sp(rank, world, tree, cfg, embeds, mask, max_seq, extract_layer, kv_quant, decode=0):
    """``sp_prefill`` over the data axis of a (world, 1) mesh: (logits,
    cache tensors, rows, tokens of ``decode`` greedy steps from its cache)."""
    from attwarp_tpu_torch.models.llama import LlamaConfig
    from attwarp_tpu_torch.models.llava import params_from_jax
    from attwarp_tpu_torch.parallel.sp_prefill import sp_prefill

    mesh = _mesh(world, 1)
    cfg = LlamaConfig(**cfg)
    params = params_from_jax(tree)
    m = torch.as_tensor(mask)
    logits, cache, rows = sp_prefill(params, cfg, torch.as_tensor(embeds), m, mesh,
                                     max_seq=max_seq, extract_layer=extract_layer,
                                     kv_quant=kv_quant)
    got = _np(logits), [t.clone().numpy() for t in cache], _np(rows)
    # the decode steps write their tokens into the cache in place
    toks = _greedy_decode(params, cfg, cache, logits, m, decode) if decode else None
    return (*got, _np(toks))


def sp_errors(rank, world, tree, cfg, embeds, mask):
    """The ValueErrors of an indivisible T and a too-small max_seq."""
    from attwarp_tpu_torch.models.llama import LlamaConfig
    from attwarp_tpu_torch.models.llava import params_from_jax
    from attwarp_tpu_torch.parallel.sp_prefill import sp_prefill

    mesh = _mesh(world, 1)
    cfg, params = LlamaConfig(**cfg), params_from_jax(tree)
    e, m = torch.as_tensor(embeds), torch.as_tensor(mask)
    msgs = []
    for args in ((e[:, :-1], m[:, :-1], None), (e, m, e.shape[1] - 1)):
        try:
            sp_prefill(params, cfg, args[0], args[1], mesh, max_seq=args[2])
            msgs.append(None)
        except ValueError as err:
            msgs.append(str(err))
    return msgs


def sp_qwen(rank, world, tree, cfg, embeds, mask, cos, sin, max_seq, extract_layer, kv_quant):
    from attwarp_tpu_torch.models.llava import params_from_jax
    from attwarp_tpu_torch.models.qwen2vl import Qwen2VLTextConfig
    from attwarp_tpu_torch.parallel.sp_prefill import sp_prefill_qwen

    mesh = _mesh(world, 1)
    cfg = Qwen2VLTextConfig(**dict(cfg, mrope_section=tuple(cfg["mrope_section"])))
    logits, cache, rows = sp_prefill_qwen(
        params_from_jax(tree), cfg, torch.as_tensor(embeds), torch.as_tensor(mask),
        torch.as_tensor(cos), torch.as_tensor(sin), mesh, max_seq=max_seq,
        extract_layer=extract_layer, kv_quant=kv_quant)
    return _np(logits), _np(list(cache)), _np(rows)


# ── the sharded MarginalNet step ────────────────────────────────────────


def train(rank, world, state_dict, batch, kw, n_model, steps=1):
    """``make_sharded_train_step`` on an f32 MarginalNet: the metrics of
    each step and the whole parameters after the last, gathered."""
    from attwarp_tpu_torch.marginalnet.model import MarginalNet
    from attwarp_tpu_torch.parallel.mesh import gather_state_dict
    from attwarp_tpu_torch.train.config import TrainConfig
    from attwarp_tpu_torch.train.train_step import (
        TrainState,
        make_optimizer,
        make_sharded_train_step,
    )

    mesh = _mesh(world, n_model)
    cfg = TrainConfig(**kw)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    model = MarginalNet(b["fmap_v"].shape[-1], b["ttok"].shape[-1], cfg.hidden,
                        compute_dtype=torch.float32)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    state = TrainState(0, model, make_optimizer(cfg, model))
    fn, eval_fn, state, local = make_sharded_train_step(model, cfg, mesh, state, b,
                                                        with_eval=True)
    metrics = []
    for _ in range(steps):
        state, m = fn(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    ev = {k: float(v) for k, v in eval_fn(state, local).items()}
    whole = gather_state_dict(state.model, mesh)
    local_shapes = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
    return metrics, ev, {k: _np(v) for k, v in whole.items()}, local_shapes


def train_loop(rank, world, roots, kw, out_root):
    """``train_loop`` under the world's process group, on the reader's
    features: (this rank's returned run directory, the rows of each batch
    this rank featurized)."""
    from attwarp_tpu_torch.data.manifests import FullDataset
    from attwarp_tpu_torch.testing.reader import ReaderFeatureExtractor
    from attwarp_tpu_torch.train.config import TrainConfig
    from attwarp_tpu_torch.train.trainer import train_loop as loop

    sys.modules["wandb"] = None
    sys.modules["matplotlib"] = None
    ds = FullDataset(*roots, num_samples_per_dataset=6, image_size=48, random_seed=13)
    rows = []

    class Counting(ReaderFeatureExtractor):
        def visual_tokens(self, images):
            rows.append(len(images))
            return super().visual_tokens(images)

    run = loop(TrainConfig(experiments_root=out_root, **kw), ds, Counting(), device="cpu")
    return None if run is None else str(run), rows

