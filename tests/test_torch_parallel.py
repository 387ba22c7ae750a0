"""The port's parallel layer against the JAX package: meshes and sharding
specs, the data-parallel warp, ``host_local_indices``, tensor-parallel
LLaVA-1.5 and Qwen2-VL (dense, ``+kv8``, ``+int8``; ``ServeEngine`` over
them), the sharded MarginalNet train step, the trainer's multi-device
branch and ``tools/dryrun_multichip.py``.

The port's ranks are spawned gloo processes on the CPU
(``attwarp_tpu_torch/testing/ranks.py``): one spawn of two ranks and one of
four, each running every check of its world size
(``tests/torch_parallel_ranks.py``), with inputs from numpy seeds here and
results back as numpy. The JAX side runs here, on the conftest's 8 CPU
devices. f32 throughout: greedy tokens must be identical, maps within 1e-5.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from attwarp_tpu.data.loader import host_local_indices as j_host_local_indices
from attwarp_tpu.marginalnet import MarginalNet as JMarginalNet
from attwarp_tpu.models import LlavaModel as JLlavaModel
from attwarp_tpu.models import qwen2vl as jq
from attwarp_tpu.numerics.quant import quantize_decoder_params as j_quantize
from attwarp_tpu.parallel import llava_sharding as jls
from attwarp_tpu.parallel import make_mesh as j_make_mesh
from attwarp_tpu.parallel import mesh as jmesh
from attwarp_tpu.train import TrainConfig as JTrainConfig
from attwarp_tpu.warp import warp_batch_by_attention as j_warp

from attwarp_tpu_torch.data.loader import host_local_indices
from attwarp_tpu_torch.marginalnet.model import ATTENTION_GRID, MarginalNet, params_from_jax
from attwarp_tpu_torch.models.llava import LlavaModel
from attwarp_tpu_torch.models.llava import params_from_jax as tree_from_jax
from attwarp_tpu_torch.models.qwen2vl import Qwen2VLModel
from attwarp_tpu_torch.parallel import llava_sharding as tls
from attwarp_tpu_torch.parallel import mesh as tmesh
from attwarp_tpu_torch.serving.engine import ServeEngine
from attwarp_tpu_torch.testing.ranks import run_ranks
from attwarp_tpu_torch.tools.dryrun_multichip import dryrun_multichip
from attwarp_tpu_torch.train import train_step as tts
from attwarp_tpu_torch.train.config import TrainConfig
from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

import torch_parallel_ranks as jobs
from test_torch_llava import IMG_TOK, _inputs, tiny_configs
from test_torch_qwen2vl import numpy_params as qwen_numpy_params
from test_torch_qwen2vl import tiny_configs as qwen_configs
from test_torch_train import _make_root

jts = importlib.import_module("attwarp_tpu.train.train_step")

PIX_TOL = 1e-3 * 255   # the repo's warp budget: 1e-3 on [0, 1] pixels


def _P(spec):
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(spec)


# ── inputs, built once ──────────────────────────────────────────────────


@pytest.fixture(scope="module")
def llava():
    jcfg, tcfg = tiny_configs()
    jparams = graft._random_llava_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.device_get(jparams)
    return jcfg, tcfg, jparams, tree, _inputs()


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = qwen_configs()
    tree = qwen_numpy_params(jcfg)
    rng = np.random.default_rng(3)
    n_img = 4
    ids = rng.integers(3, 90, size=(2, 9 + n_img)).astype(np.int64)
    ids[:, 1] = jcfg.vision_start_token_id
    ids[:, 2:2 + n_img] = jcfg.image_token_id
    mask = np.ones_like(ids)
    img = rng.standard_normal((56, 56, 3)).astype(np.float32)
    patches, grid = jq.patchify_image(img, jcfg.vision)
    return jcfg, tcfg, tree, (ids, patches, grid, mask)


def _mn_batch(rng, B=8, img=48, hv=8, Dv=16, Lt=6, Dt=12):
    return {
        "image": rng.random((B, img, img, 3)).astype(np.float32),
        "attention_map": rng.random((B, img, img)).astype(np.float32),
        "sqrt_mask": (np.arange(B) % 2).astype(np.float32),
        "none_mask": (np.arange(B) % 4 == 3).astype(np.float32),
        "fmap_v": rng.random((B, hv, hv, Dv)).astype(np.float32),
        "ttok": rng.random((B, Lt, Dt)).astype(np.float32),
        "tmask": np.ones((B, Lt, 1), np.float32),
    }


TRAIN_KW = dict(hidden=128, lr=1e-3, alpha0=0.5, alpha_decay_steps=4, watch_gradients=True)


@pytest.fixture(scope="module")
def train_case():
    """An f32 MarginalNet at hidden 128 (so its kernels split over
    ``model``), the same weights on both sides, and a batch of 8."""
    b = _mn_batch(np.random.default_rng(7))
    jm = JMarginalNet(hidden=TRAIN_KW["hidden"], compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), b["fmap_v"], ATTENTION_GRID, b["ttok"],
                     b["tmask"])["params"]
    sd = {k: v.numpy() for k, v in params_from_jax(jax.device_get(params)).items()}
    return jm, params, sd, b


def _llava_inputs(case):
    ids, mask, pix, start = case[4]
    return (ids, pix, mask, start.astype(np.int64))


LOOP_KW = dict(hidden=128, image_size=48, epochs=1, vis_every=2, log_every=1, seed=5)
# train_loop on two ranks: (batch size, mesh flags)
LOOP_CASES = {"sharded": (4, {"mesh_model": 2}), "indivisible": (3, {"mesh_data": 2}),
              "data": (4, {"mesh_data": 2})}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("roots")
    rng = np.random.default_rng(11)
    return [_make_root(tmp, "gqa", 8, rng, with_bucket=True, overlay_every=3),
            _make_root(tmp, "textvqa", 8, rng), _make_root(tmp, "docvqa", 8, rng)]


@pytest.fixture(scope="module")
def ranks2(llava, qwen, train_case, roots, tmp_path_factory):
    _, tcfg, _, tree, _ = llava
    cfg = dataclasses.asdict(tcfg)
    _, qcfg, qtree, (qids, qpatches, qgrid, qmask) = qwen
    rng = np.random.default_rng(11)
    images = (rng.random((4, 32, 40, 3)) * 255).astype(np.float32)
    atts = rng.random((4, 8, 8)).astype(np.float32)
    _, _, sd, b = train_case
    todo = [
        ("warp", "warp", dict(images=images, atts=atts, size=(24, 20))),
        ("indices", "host_indices", dict(n_model=1, indices=list(range(11)))),
        *[(f"llava_{k}", "llava_generate",
           dict(tree=tree, cfg=cfg, inputs=_llava_inputs(llava), n_model=2, **kw))
          for k, kw in (("dense", {}), ("kv8", {"kv_quant": True}), ("int8", {"int8": True}))],
        ("serve", "llava_serve", dict(tree=tree, cfg=cfg, requests=_serve_requests(),
                                      n_model=2, kv_quant=True)),
        ("chunked", "llava_serve", dict(tree=tree, cfg=cfg, requests=_serve_requests(),
                                        n_model=2, kv_quant=True, chunk=16)),
        *[(f"qwen_{k}", "qwen_generate",
           dict(tree=qtree, cfg=dataclasses.asdict(qcfg), ids=qids, patches=qpatches,
                grid=qgrid, mask=qmask, n_model=2, kv_quant=kv))
          for k, kv in (("dense", False), ("kv8", True))],
        *[(f"train_{d}x{m}", "train", dict(state_dict=sd, batch=b, kw=TRAIN_KW, n_model=m,
                                           steps=2))
          for d, m in ((2, 1), (1, 2))],
        *[(f"loop_{case}", "train_loop",
           dict(roots=roots, kw=dict(LOOP_KW, batch_size=bs, **mesh),
                out_root=str(tmp_path_factory.mktemp(f"loop_{case}"))))
          for case, (bs, mesh) in LOOP_CASES.items()],
    ]
    return run_ranks(jobs.run_jobs, 2, (todo,))


@pytest.fixture(scope="module")
def ranks4(llava, qwen, train_case):
    _, tcfg, _, tree, _ = llava
    cfg = dataclasses.asdict(tcfg)
    _, qcfg, qtree, (qids, qpatches, qgrid, qmask) = qwen
    _, _, sd, b = train_case
    todo = [
        ("indices", "host_indices", dict(n_model=2, indices=list(range(11)))),
        ("llava_grid", "llava_generate", dict(tree=tree, cfg=cfg, inputs=_llava_inputs(llava),
                                              n_model=2, kv_quant=True, shard_data=True)),
        ("llava_m4", "llava_generate", dict(tree=tree, cfg=cfg, inputs=_llava_inputs(llava),
                                            n_model=4, kv_quant=True)),
        ("qwen_grid", "qwen_generate", dict(tree=qtree, cfg=dataclasses.asdict(qcfg), ids=qids,
                                            patches=qpatches, grid=qgrid, mask=qmask,
                                            n_model=2, kv_quant=True)),
        ("train_2x2", "train", dict(state_dict=sd, batch=b, kw=TRAIN_KW, n_model=2, steps=2)),
    ]
    return run_ranks(jobs.run_jobs, 4, (todo,))


# ── meshes, specs, loader ───────────────────────────────────────────────


def test_solo_mesh_and_batch_sharding():
    """Without a process group the mesh is the (1, 1) grid: the batch and
    every collective pass through; a mesh larger than the world and an
    indivisible batch are refused, as in JAX."""
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and tmesh.current_mesh() is mesh
    x = {"a": torch.arange(6.0).reshape(3, 2), "s": ["q"] * 3}
    assert tmesh.shard_batch(x, mesh)["a"].equal(x["a"])
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(n_data=2, n_model=1)
    assert tmesh.batch_shardings({"a": x["a"]}, mesh) == {"a": ("data", None)}
    assert tmesh.replicated(mesh) == ()
    sd = {"w": torch.zeros(256, 3), "b": torch.zeros(256), "h": torch.zeros(1, 256, 1)}
    assert tmesh.param_shardings(sd, mesh) == {"w": (None, "model"), "b": (None,),
                                               "h": (None, None, None)}


def test_param_sharding_rules_match_jax(train_case):
    """The port's rule on the torch shapes gives JAX's spec on the flax
    shapes, for every MarginalNet parameter."""
    _, params, sd, _ = train_case
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    jspecs = {}
    for path, leaf in flat:
        mod, kind = path[0].key, path[1].key
        jspecs[f"{mod}.{'weight' if kind == 'kernel' else 'bias'}"] = _P(
            jmesh.param_sharding_rules("", leaf.shape))
    got = {k: tmesh.param_sharding_rules(k, v.shape) for k, v in sd.items()}
    assert got == jspecs
    assert sum("model" in s for s in got.values()) == 7


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_llava_and_qwen_specs_match_jax(llava, qwen, int8):
    """``_quant_aware(llava_param_specs)`` and the Qwen specs on the port's
    trees equal JAX's on its trees (int8: ``q`` keeps the dense spec,
    ``s``/``b`` follow the output axis)."""
    jcfg, _, jparams, tree, _ = llava
    jtree = dict(jparams, llama=j_quantize(jparams["llama"])) if int8 else jparams
    ttree = tree_from_jax(jax.device_get(jtree))
    want = jax.tree_util.tree_map(_P, jls._quant_aware(jtree, jls.llava_param_specs(jtree)),
                                  is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert tls._quant_aware(ttree, tls.llava_param_specs(ttree)) == want
    qtree = qwen[2]
    want_q = jax.tree_util.tree_map(_P, jls.qwen2vl_param_specs(qtree),
                                    is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert tls.qwen2vl_param_specs(tree_from_jax(qtree)) == want_q


def test_host_local_indices_match_jax(ranks2, ranks4):
    """Explicit arguments as JAX's; the defaults are the data-axis rank and
    size of the rank's mesh (world 2 as (2, 1), world 4 as (2, 2))."""
    idx = list(range(11))
    for pi, pc in ((0, 1), (1, 3), (2, 3)):
        assert host_local_indices(idx, pi, pc) == j_host_local_indices(idx, pi, pc)
    for outs in (ranks2, ranks4):
        for out in outs:
            d, got = out["indices"]
            assert got == j_host_local_indices(idx, d, 2)


def test_ranks_import_no_jax(ranks2, ranks4):
    assert not any(out["jax_imported"] for out in ranks2 + ranks4)


# ── the data-parallel warp ──────────────────────────────────────────────


def test_sharded_warp_matches_unsharded_and_jax(ranks2):
    """Each rank's slice bit-equal to the unsharded port's warp of it, the
    gathered batch too, and within the repo's warp budget (``PIX_TOL``) of
    JAX's warp on 0-255 images."""
    rng = np.random.default_rng(11)
    images = (rng.random((4, 32, 40, 3)) * 255).astype(np.float32)
    atts = rng.random((4, 8, 8)).astype(np.float32)
    ref = warp_batch_by_attention(torch.as_tensor(images), torch.as_tensor(atts), 20, 24).numpy()
    jref = np.asarray(j_warp(jnp.asarray(images), jnp.asarray(atts), 20, 24, method="gather"))
    for r, out in enumerate(ranks2):
        local, whole = out["warp"]
        np.testing.assert_array_equal(local, ref[2 * r:2 * r + 2])
        np.testing.assert_array_equal(whole, ref)
        np.testing.assert_allclose(whole, jref, atol=PIX_TOL)


# ── tensor-parallel LLaVA-1.5 ───────────────────────────────────────────


@pytest.fixture(scope="module")
def llava_refs(llava):
    """JAX's unsharded and (4, 2)-mesh sharded generate, per form."""
    jcfg, _, jparams, _, case = llava
    args = tuple(jnp.asarray(a) for a in _llava_inputs(llava))
    mesh = j_make_mesh(n_data=4, n_model=2)
    out = {}
    for form, kw in (("dense", {}), ("kv8", {"kv_quant": True}), ("int8", {})):
        params = dict(jparams, llama=j_quantize(jparams["llama"])) if form == "int8" else jparams
        ref = JLlavaModel(jcfg, params).generate_with_attention(
            *args, extract_layer=1, max_new_tokens=4, **kw)
        tp = JLlavaModel(jcfg, jls.shard_llava_params(params, mesh)).generate_with_attention(
            *args, extract_layer=1, max_new_tokens=4, **kw)
        out[form] = [tuple(np.asarray(x) for x in ref), tuple(np.asarray(x) for x in tp)]
    return out


@pytest.mark.parametrize("form", ["dense", "kv8", "int8"])
def test_tp_llava_generate_matches_jax(ranks2, llava_refs, form):
    """n_model=2: every rank's tokens identical to JAX's unsharded and
    sharded runs, maps within 1e-5; each rank holds half the heads (2 of 4
    query, 1 of 2 kv), half the FFN, and half CLIP's heads; an int8
    linear's scale follows its output axis."""
    (g_ref, m_ref), (g_tp, m_tp) = llava_refs[form]
    np.testing.assert_array_equal(g_ref, g_tp)
    for out in ranks2:
        _, gen, maps, shapes = out[f"llava_{form}"]
        np.testing.assert_array_equal(gen, g_ref)
        np.testing.assert_allclose(maps, m_ref, atol=1e-5)
        np.testing.assert_allclose(maps, m_tp, atol=1e-5)
        q = shapes["q_proj"]
        if form == "int8":
            assert q == {"q": (32, 64), "s": (32,)}
            assert shapes["down_proj"] == {"q": (64, 64), "s": (64,)}
        else:
            assert q == (32, 64) and shapes["o_proj"] == (64, 32)
        assert shapes["vision_q"] == (16, 32)


def test_tp_llava_on_grid_and_indivisible_heads(ranks4, llava_refs):
    """World 4: a (2, 2) grid, the batch split over ``data`` too (each row
    its sample), and n_model=4, where CLIP's 2 heads do not divide (its
    attention stays whole) and the 2 kv heads do not either (each rank keeps
    the one its query head reads): tokens identical, maps within 1e-5."""
    g_ref, m_ref = llava_refs["kv8"][0]
    for out in ranks4:
        d, gen, maps, _ = out["llava_grid"]
        np.testing.assert_array_equal(gen, g_ref[d:d + 1])
        np.testing.assert_allclose(maps, m_ref[d:d + 1], atol=1e-5)
        _, gen, maps, shapes = out["llava_m4"]
        np.testing.assert_array_equal(gen, g_ref)
        np.testing.assert_allclose(maps, m_ref, atol=1e-5)
        assert shapes["k_proj"] == (16, 64) and shapes["q_proj"] == (16, 64)
        assert shapes["vision_q"] == (32, 32)


def _serve_requests():
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(4):
        T = 22 + (i % 3)
        ids = rng.integers(3, 100, size=(T,)).astype(np.int64)
        ids[2:18] = IMG_TOK
        reqs.append((ids, rng.standard_normal((56, 56, 3)).astype(np.float32), 3 + i))
    return reqs


def test_serve_engine_on_tp_llava(ranks2, llava):
    """``ServeEngine`` and ``ChunkedPrefillEngine`` (16-token chunks)
    unchanged over the n_model=2 model: every request's tokens identical to
    the unsharded engine's and to a per-request generate, on both ranks."""
    _, tcfg, _, tree, _ = llava
    model = LlavaModel(tcfg, tree_from_jax(tree))
    eng = ServeEngine(model, slots=2, max_seq=128, kv_quant=True, steps_per_tick=4)
    for ids, pix, n in _serve_requests():
        eng.submit(ids, pix, max_new_tokens=n)
    ref = eng.run()
    for rid, (ids, pix, n) in enumerate(_serve_requests()):
        gen, _ = model.generate_with_attention(
            torch.as_tensor(ids[None]), torch.as_tensor(pix[None]),
            torch.ones((1, len(ids)), dtype=torch.bool), torch.as_tensor([2]),
            extract_layer=None, max_new_tokens=n, kv_quant=True)
        want = gen[0].tolist()
        if tcfg.eos_token_id in want:
            want = want[:want.index(tcfg.eos_token_id) + 1]
        assert ref[rid] == want
    for out in ranks2:
        assert out["serve"] == ref and out["chunked"] == ref


# ── tensor-parallel Qwen2-VL ────────────────────────────────────────────


@pytest.fixture(scope="module")
def qwen_refs(qwen):
    jcfg, _, tree, (ids, patches, grid, mask) = qwen
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    out = {}
    for kv in (False, True):
        gen, maps = jq.Qwen2VLModel(jcfg, jparams).generate_with_attention(
            ids, patches, grid, mask, extract_layer=1, max_new_tokens=3, kv_quant=kv)
        out[kv] = (np.asarray(gen), np.asarray(maps))
    mesh = j_make_mesh(n_data=4, n_model=2)
    gen, maps = jq.Qwen2VLModel(jcfg, jls.shard_qwen2vl_params(jparams, mesh)) \
        .generate_with_attention(ids, patches, grid, mask, extract_layer=1, max_new_tokens=3)
    out["tp"] = (np.asarray(gen), np.asarray(maps))
    return out


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "kv8"])
def test_tp_qwen_generate_matches_jax(ranks2, ranks4, qwen_refs, kv_quant):
    """Qwen2-VL at n_model=2 (2 of 4 query heads over 1 of 2 kv heads a
    rank; the fused vision qkv cut per q, k and v) and on a (2, 2) grid:
    tokens identical to JAX's unsharded and sharded runs, maps within
    1e-5."""
    g_ref, m_ref = qwen_refs[kv_quant]
    np.testing.assert_array_equal(qwen_refs["tp"][0], qwen_refs[False][0])
    outs = [o[f"qwen_{'kv8' if kv_quant else 'dense'}"] for o in ranks2]
    if kv_quant:
        outs += [o["qwen_grid"] for o in ranks4]
    for gen, maps, k_shape in outs:
        np.testing.assert_array_equal(gen, g_ref)
        np.testing.assert_allclose(maps, m_ref, atol=1e-5)
        assert k_shape == (128, 512)


def test_tp_qwen_unsharded_port_agrees(qwen, qwen_refs):
    """The port's own unsharded Qwen2-VL on the same inputs (the baseline
    the sharded runs reproduce)."""
    _, tcfg, tree, (ids, patches, grid, mask) = qwen
    gen, maps = Qwen2VLModel(tcfg, tree_from_jax(tree)).generate_with_attention(
        torch.as_tensor(ids), torch.as_tensor(patches), grid, torch.as_tensor(mask).bool(),
        extract_layer=1, max_new_tokens=3)
    np.testing.assert_array_equal(gen.numpy(), qwen_refs[False][0])
    np.testing.assert_allclose(maps.numpy(), qwen_refs[False][1], atol=1e-5)


# ── the sharded MarginalNet train step ──────────────────────────────────


@pytest.fixture(scope="module")
def train_refs(train_case):
    """The port's one-device steps and JAX's (4, 2)-mesh sharded steps, two
    of each, from the same weights."""
    jm, params, sd, b = train_case
    tcfg = TrainConfig(**TRAIN_KW)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    model = MarginalNet(b["fmap_v"].shape[-1], b["ttok"].shape[-1], tcfg.hidden,
                        compute_dtype=torch.float32)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    state = tts.TrainState(0, model, tts.make_optimizer(tcfg, model))
    single = []
    for _ in range(2):
        state, m = tts.train_step(state, tb, tcfg)
        single.append({k: float(v) for k, v in m.items()})
    one = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}

    jcfg = JTrainConfig(**TRAIN_KW)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    js = jts.TrainState(jnp.zeros((), jnp.int32), params, jts.make_optimizer(jcfg).init(params))
    fn, s_state, s_batch = jts.make_sharded_train_step(jm, jcfg, j_make_mesh(4, 2), js, jb)
    jmetrics = []
    for _ in range(2):
        s_state, m = fn(s_state, s_batch)
        jmetrics.append({k: float(v) for k, v in m.items()})
    jparams = {k: v.numpy() for k, v in params_from_jax(jax.device_get(s_state.params)).items()}
    return single, one, jmetrics, jparams


@pytest.mark.parametrize("grid", ["2x1", "1x2", "2x2"])
def test_sharded_train_step_matches(ranks2, ranks4, train_refs, train_case, grid):
    """Two steps at (data, model) = ``grid``: the losses within rtol 2e-2
    and the parameters within atol 5e-2 (JAX's bars,
    ``tests/test_train_step.py``) of the port's one-device steps and of
    JAX's sharded steps; in f32 every metric is in fact within 1e-5
    relative. The kernels of 128 output channels are held as halves over
    ``model``."""
    single, one, jmetrics, jparams = train_refs
    outs = ranks4 if grid == "2x2" else ranks2
    n_model = int(grid[-1])
    for out in outs:
        metrics, ev, whole, local = out[f"train_{grid}"]
        for step in range(2):
            for ref in (single[step], jmetrics[step]):
                np.testing.assert_allclose(metrics[step]["loss/total"], ref["loss/total"],
                                           rtol=2e-2)
            for k, v in single[step].items():
                np.testing.assert_allclose(metrics[step][k], v, rtol=1e-5, atol=1e-9,
                                           err_msg=k)
        for k in one:
            np.testing.assert_allclose(whole[k], one[k], atol=5e-2, err_msg=k)
            np.testing.assert_allclose(whole[k], jparams[k], atol=5e-2, err_msg=k)
        assert np.isfinite(ev["loss/total"])
        assert local["proj_v2.weight"][0] == 128 // n_model
        assert local["head_x_conv2.weight"] == (1, 128, 1)


# ── the trainer's multi-device branch and the dry run ───────────────────


def _single_loop(roots, tmp_path, **kw):
    from attwarp_tpu_torch.data.manifests import FullDataset
    from attwarp_tpu_torch.testing.reader import ReaderFeatureExtractor
    from attwarp_tpu_torch.train.trainer import train_loop

    ds = FullDataset(*roots, num_samples_per_dataset=6, image_size=48, random_seed=13)
    return train_loop(TrainConfig(experiments_root=str(tmp_path), **kw), ds,
                      ReaderFeatureExtractor(), device="cpu")


def _losses(run):
    import json

    return [x["loss/train_total"] for x in map(json.loads, open(run / "metrics.jsonl"))
            if "loss/train_total" in x]


def _ckpt(run):
    return torch.load(run / "checkpoints" / "marginal_net_epoch_1.pt", weights_only=True)


@pytest.mark.parametrize("case", list(LOOP_CASES), ids=list(LOOP_CASES))
def test_train_loop_on_two_ranks(ranks2, roots, tmp_path, monkeypatch, case):
    """``train_loop`` on two ranks. Batch 4 with ``mesh_model=2``: the
    (1, 2) mesh and the sharded step; rank 0 alone writes, and its
    checkpoint holds the whole weights and moments, within JAX's bars of a
    one-device run (bf16 compute), its logged losses within rtol 2e-2.
    Batch 4 with ``mesh_data=2``: the (2, 1) mesh, the same bars, and each
    rank featurizes only its own 2 rows of a batch, except the probe and
    the batches of a debug round (every ``vis_every``-th step, the first
    validation batch), which are whole. Batch 3 with ``mesh_data=2`` does
    not divide by the data axis: each rank trains alone on the whole batch,
    JAX's single-device fallback, bit-equal to a one-device run."""
    import sys

    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    batch_size = LOOP_CASES[case][0]
    runs = [out[f"loop_{case}"] for out in ranks2]
    assert runs[1][0] is None and runs[0][0] is not None
    from pathlib import Path

    run = Path(runs[0][0])
    kw = dict(LOOP_KW, batch_size=batch_size)
    # one thread, as the ranks run, so that the fallback's sums are in the same order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _single_loop(roots, tmp_path, **kw)
    finally:
        torch.set_num_threads(threads)
    a, b = _ckpt(run), _ckpt(ref)
    assert a["step"] == b["step"] and a["model"].keys() == b["model"].keys()
    exact = case == "indivisible"
    for k in b["model"]:
        assert a["model"][k].shape == b["model"][k].shape, k
        if exact:
            assert torch.equal(a["model"][k], b["model"][k]), k
        else:
            np.testing.assert_allclose(a["model"][k], b["model"][k], atol=5e-2, err_msg=k)
    for i, st in b["optimizer"]["state"].items():
        for name, v in st.items():
            assert a["optimizer"]["state"][i][name].shape == v.shape
    np.testing.assert_allclose(_losses(run), _losses(ref), rtol=0 if exact else 2e-2)
    assert sorted(p.name for p in (run / "debug").glob("*.png")) == \
        sorted(p.name for p in (ref / "debug").glob("*.png"))
    if case == "data":
        # the probe, then steps 1-4 (a debug round on 2 and 4), then the
        # one validation batch (a debug round)
        steps = len(_losses(ref))
        want = [4] + [4 if s % 2 == 0 else 2 for s in range(1, steps + 1)]
        for _, rows in runs:
            assert rows[:steps + 1] == want and len(rows) == steps + 2, rows


def test_dryrun_multichip_runs_on_four_ranks():
    """``tools/dryrun_multichip.py``: one sharded train step on a (2, 2)
    mesh, the tensor-parallel tiny LLaVA (dense and w8a8 with two layers
    extracted) and ``ServeEngine`` over it, equal on every rank."""
    out = dryrun_multichip(4)
    assert np.isfinite(out["loss"]) and out["maps_q"].shape[0] == 2
    assert sorted(out["served"]) == [0, 1]
