"""The port's disaggregated serving (``serving/disagg.py``) against the port's
``ServeEngine`` and JAX's ``DisaggServeEngine`` on the same weights.

``DisaggServeEngine`` runs admission prefills on ``prefill_model`` and moves
each finished KV block to the decode device with one ``.to()``. On the CPU
both "devices" are the CPU (as on one card both are ``cuda:0``): the engine
must then give exactly ``ServeEngine``'s tokens, since the same arithmetic
runs in the same order. JAX's engine runs on the conftest's 8-device mesh
split 4 + 4.
"""

import jax
import numpy as np
import pytest
import torch

from attwarp_tpu.serving import DisaggServeEngine as JDisagg
from attwarp_tpu.serving import split_meshes

from attwarp_tpu_torch.serving import DisaggServeEngine, ServeEngine, split_devices

from test_torch_serving import build_llava, build_qwen, llava_request, qwen_request

KW = dict(slots=2, max_seq=96, bucket=16, steps_per_tick=4)


@pytest.fixture(scope="module")
def llava():
    return build_llava()


@pytest.fixture(scope="module")
def qwen():
    return build_qwen()


def _copy(model):
    """A second instance of the same weights (the prefill device's copy)."""
    def clone(t):
        if isinstance(t, dict):
            return {k: clone(v) for k, v in t.items()}
        if isinstance(t, list):
            return [clone(v) for v in t]
        return t.clone()

    return type(model)(model.cfg, clone(model.params))


def _serve(engine, reqs):
    rids = [engine.submit(ids, px, max_new_tokens=n) for ids, px, n in reqs]
    out = engine.run()
    return [out[r] for r in rids]


def _llava_reqs():
    rng = np.random.default_rng(5)
    return [(*llava_request(rng, 9 + (i % 4), image=i != 3), 3 + 2 * (i % 3))
            for i in range(6)]


def test_split_devices_is_a_disjoint_cover():
    devs = [f"cuda:{i}" for i in range(8)]
    decode, prefill = split_devices(devs)
    assert prefill == [torch.device(f"cuda:{i}") for i in range(4)]
    assert decode == [torch.device(f"cuda:{i}") for i in range(4, 8)]
    decode, prefill = split_devices(devs, prefill_devices=3)
    assert not set(decode) & set(prefill) and len(decode) + len(prefill) == 8
    for bad in (0, 8):
        with pytest.raises(ValueError):
            split_devices(devs, prefill_devices=bad or 99)
    with pytest.raises(ValueError):
        split_devices(["cuda:0"])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "kv8"])
def test_disagg_matches_serve_engine_and_jax(llava, kv_quant):
    """The same request stream (images and text only, three bucket sizes)
    through the port's disaggregated engine, its ``ServeEngine`` and JAX's
    ``DisaggServeEngine``: identical tokens per request; the slot cache on
    the decode device; one KV transfer per admission group."""
    jmodel, tmodel = llava
    reqs = _llava_reqs()
    kw = dict(KW, kv_quant=kv_quant)
    eng = DisaggServeEngine(tmodel, prefill_model=_copy(tmodel), **kw)
    got = _serve(eng, reqs)
    assert got == _serve(ServeEngine(tmodel, **kw), reqs)
    assert eng.kv_transfers == eng.prefill_groups > 0
    assert all(t.device == tmodel.device for t in eng.kv)

    d_mesh, p_mesh = split_meshes()
    sh = jax.sharding.NamedSharding(p_mesh, jax.sharding.PartitionSpec())
    p_model = type(jmodel)(jmodel.cfg, jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sh), jmodel.params))
    jeng = JDisagg(jmodel, prefill_model=p_model, decode_mesh=d_mesh, prefill_mesh=p_mesh, **kw)
    want = [[int(t) for t in r] for r in _serve(jeng, reqs)]
    assert got == want


def test_disagg_serves_qwen(qwen):
    """Qwen2-VL (M-RoPE deltas set on the prefill side, read on the decode
    side) through the disaggregated engine: ``ServeEngine``'s tokens."""
    _, tmodel = qwen
    rng = np.random.default_rng(9)
    reqs = [(*qwen_request(rng, 10 + i, 56 if i % 2 else 28), 4) for i in range(4)]
    kw = dict(KW, kv_quant=True)
    got = _serve(DisaggServeEngine(tmodel, prefill_model=_copy(tmodel), **kw), reqs)
    assert got == _serve(ServeEngine(tmodel, **kw), reqs)


def test_disagg_prefill_model_is_the_one_that_runs(llava):
    """Admission embeds and prefills with ``prefill_model``'s weights (a
    prefill copy with its LM head zeroed gives first tokens of 0), and
    decode with ``model``'s."""
    _, tmodel = llava
    broken = _copy(tmodel)
    broken.params["llama"]["lm_head"].zero_()
    eng = DisaggServeEngine(tmodel, prefill_model=broken, **KW)
    out = _serve(eng, _llava_reqs()[:2])
    assert [r[0] for r in out] == [0, 0]
    ref = _serve(ServeEngine(tmodel, **KW), _llava_reqs()[:2])
    assert [r[0] for r in ref] != [0, 0]
