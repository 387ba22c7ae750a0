"""The port's ``ChunkedPrefillEngine`` against the JAX one and against the
port's ``ServeEngine``, on the same tiny weights (see
``tests/test_torch_serving.py``, whose model builders this file shares):
prefill chunks riding the decode steps change where the prompt's layers run,
not any request's tokens.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from attwarp_tpu.serving import ChunkedPrefillEngine as JChunked
from attwarp_tpu.serving.chunked import _chunk_mask as j_chunk_mask

from attwarp_tpu_torch.serving import ChunkedPrefillEngine, ServeEngine
from attwarp_tpu_torch.serving.chunked import chunk_mask
from test_torch_serving import build_llava, build_qwen, llava_request, qwen_request


@pytest.fixture(scope="module")
def models():
    return {"llava": build_llava(), "qwen2vl": build_qwen()}


def _requests(family, rng):
    if family == "llava":
        return [llava_request(rng, T) for T in (10, 13, 17, 9, 21, 33)]
    return [qwen_request(rng, T, side)
            for T, side in ((12, 56), (15, 84), (10, 56), (11, None), (17, 84))]


def _serve(engine, reqs, max_new=5):
    rids = [engine.submit(ids, px, max_new_tokens=max_new) for ids, px in reqs]
    out = engine.run()
    return [[int(t) for t in out[r]] for r in rids]


@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "kv8"])
@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
def test_chunked_matches_engine_and_jax(models, family, kv_quant, P):
    """More requests than slots, prompts of several chunks that cross tick
    boundaries, slot reuse: tokens equal the port's ServeEngine and JAX's
    ChunkedPrefillEngine."""
    jm, tm = models[family]
    reqs = _requests(family, np.random.default_rng(20))
    kw = dict(slots=2, max_seq=96, bucket=16, kv_quant=kv_quant, steps_per_tick=4)
    got = _serve(ChunkedPrefillEngine(tm, prefill_chunk=P, **kw), reqs)
    assert got == _serve(ServeEngine(tm, **kw), reqs)
    assert got == _serve(JChunked(jm, prefill_chunk=P, stage_len=48, **kw), reqs)


def test_chunk_mask_matches_jax():
    """The port's mask over [history | chunk] is JAX's with the staging
    history cut at ``dst`` (JAX's later history columns are all masked)."""
    SK, P = 48, 8
    for dst, pad, n in ((0, 5, 8), (8, 5, 8), (16, 0, 8), (40, 13, 3)):
        ref = np.asarray(j_chunk_mask(SK, P, jnp.int32(dst), jnp.int32(pad)))[0]
        got = chunk_mask(dst, n, pad, "cpu")[0].numpy()
        assert got.shape == (n, dst + n)
        np.testing.assert_array_equal(got[:, :dst], ref[:n, :dst])
        np.testing.assert_array_equal(got[:, dst:], ref[:n, SK:SK + n])
        assert not ref[:, dst:SK].any()


def test_only_decoding_slots_write(models):
    """Free slots' rows write nothing: with one request in three slots, the
    other two slots' cache rows stay zero (JAX parks them out of bounds)."""
    tm = models["llava"][1]
    eng = ChunkedPrefillEngine(tm, slots=3, max_seq=96, bucket=16, kv_quant=True,
                               steps_per_tick=4, prefill_chunk=8)
    _serve(eng, [llava_request(np.random.default_rng(21), 13)])
    assert eng.decode_steps > 0
    for t in eng.kv:
        assert bool(t[:, 0].any()) and not bool(t[:, 1:].any())


def test_chunked_text_only_and_sampling(models):
    tm = models["llava"][1]
    rng = np.random.default_rng(22)
    ids = rng.integers(3, 90, size=(11,))
    px_req = llava_request(rng, 14)

    def run():
        eng = ChunkedPrefillEngine(tm, slots=2, max_seq=96, bucket=16, steps_per_tick=4,
                                   prefill_chunk=8, seed=3)
        r1 = eng.submit(ids, None, max_new_tokens=4)
        r2 = eng.submit(*px_req, max_new_tokens=4, temperature=0.8)
        out = eng.run()
        return out[r1], out[r2]

    a, b = run(), run()
    assert a == b and all(1 <= len(v) <= 4 for v in a)
    eng = ServeEngine(tm, slots=2, max_seq=96, bucket=16, steps_per_tick=4)
    rid = eng.submit(ids, None, max_new_tokens=4)
    assert eng.run()[rid] == a[0]


def test_chunked_failed_embedding_rolls_back(models, monkeypatch):
    """A failed prompt embedding puts the request back at the head of the
    queue and leaves its slot free; the engine then serves it as the base
    engine does."""
    tm = models["llava"][1]
    reqs = [llava_request(np.random.default_rng(23), T) for T in (12, 20)]
    eng = ChunkedPrefillEngine(tm, slots=2, max_seq=96, bucket=16, prefill_chunk=8)
    rids = [eng.submit(ids, px, max_new_tokens=4) for ids, px in reqs]

    def boom(self, Tb, with_image, chunk):
        raise RuntimeError("injected embedding failure")

    monkeypatch.setattr(ChunkedPrefillEngine, "_embed_group", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng._start_admissions()
    assert [r.rid for r in eng.queue] == rids
    assert not any(s.pending or s.active for s in eng._slots) and not eng._admitting
    monkeypatch.undo()
    out = eng.run()
    assert [out[r] for r in rids] == _serve(ServeEngine(tm, slots=2, max_seq=96, bucket=16),
                                           reqs, max_new=4)
