"""The family seam of ``models/mllm.py`` (``prompt``, ``decode_rope``,
``map_shape``, ``image_input``) on the tiny LLaVA, Qwen2-VL and Uni-MoE
models of ``test_torch_llava.py``, ``test_torch_qwen2vl.py`` and
``test_torch_unimoe.py``, against the JAX package's rotary tables.

For a left-padded prompt, ``prompt`` must give every prompt position the
rotary of JAX's prefill, and ``decode_rope(T + offset)`` the rotary that
JAX's generate loop gives the first generated token: LLaVA's ``lengths +
step`` (``attwarp_tpu/models/llava.py:221``) and Qwen2-VL's ``T +
rope_delta + step`` on all three M-RoPE streams
(``attwarp_tpu/models/qwen2vl.py:652``), at step 0. Uni-MoE's positions
are Qwen2-VL's over its tower's grid with no merge. The host form of the
prompt (the serving engines') gives the same tables and offsets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attwarp_tpu.models import qwen2vl as jq
from attwarp_tpu.models.llama import rope_cos_sin as j_rope_cos_sin

from attwarp_tpu_torch.models import llava as tl
from attwarp_tpu_torch.models import qwen2vl as tq
from attwarp_tpu_torch.models.llava import params_from_jax

import test_torch_llava as llava_t
import test_torch_qwen2vl as qwen_t
import test_torch_unimoe as unimoe_t

PADS = (5, 0, 2)      # each row's left pad


def _llava():
    _, cfg = llava_t.tiny_configs()
    g = torch.Generator().manual_seed(0)
    model = tl.LlavaModel(cfg, tl.random_params(cfg, g, "cpu", torch.float32))
    return model, cfg.image_token_index, 56, None


def _qwen():
    jcfg, cfg = qwen_t.tiny_configs()
    return (tq.Qwen2VLModel(cfg, params_from_jax(qwen_t.numpy_params(jcfg))),
            cfg.image_token_id, 56, cfg.vision.spatial_merge_size)


def _unimoe():
    model = unimoe_t.make_model(unimoe_t.tiny_cfg())
    return model, model.cfg.image_token_id, model.cfg.vision.image_size, 1


def _jax_text_config(t):
    """The JAX ``Qwen2VLTextConfig`` of a port text config's rotary."""
    return jq.Qwen2VLTextConfig(hidden_size=t.hidden_size,
                                num_attention_heads=t.num_attention_heads,
                                rope_theta=t.rope_theta, mrope_section=t.mrope_section)


def _prompt(image_token, n_img):
    """Left-padded ids (B, T) with an image block of ``n_img`` tokens after
    three text tokens, and their mask."""
    rng = np.random.default_rng(3)
    T = 3 + n_img + 8 + max(PADS)
    ids = rng.integers(3, 90, size=(len(PADS), T)).astype(np.int64)
    mask = np.ones(ids.shape, bool)
    for b, pad in enumerate(PADS):
        ids[b, :pad] = 1
        mask[b, :pad] = False
        ids[b, pad + 3:pad + 3 + n_img] = image_token
    return ids, mask


@pytest.mark.parametrize("family", [_llava, _qwen, _unimoe], ids=["llava", "qwen2vl", "unimoe"])
def test_seam_gives_the_rotary_of_jax_prompt_and_first_step(family):
    model, image_token, size, merge = family()
    pixels = torch.randn((len(PADS), size, size, 3), generator=torch.Generator().manual_seed(1))
    image = model.image_input(pixels)
    h, w = model.map_shape(image)
    ids, mask = _prompt(image_token, h * w)
    B, T = ids.shape
    t = model.cfg.text
    if merge is None:   # LLaVA: positions count the valid tokens (JAX llama.py:379-381)
        pos = np.clip(np.cumsum(mask.astype(np.int32), axis=1) - 1, 0, None)
        want_prompt = j_rope_cos_sin(jnp.asarray(pos), t.head_dim, t.rope_theta)
        lengths = mask.sum(1)
        want_first = j_rope_cos_sin(jnp.asarray(lengths)[:, None], t.head_dim, t.rope_theta)
    else:
        jt = _jax_text_config(t)
        grid = image[1]
        pos, deltas = jq.get_mrope_positions(ids, mask, grid, image_token, merge)
        want_prompt = jq.mrope_cos_sin(jnp.asarray(pos), jt)
        p = T + deltas
        want_first = jq.mrope_cos_sin(jnp.broadcast_to(p[None, :, None], (3, B, 1)), jt)

    ids_t, mask_t = torch.as_tensor(ids), torch.as_tensor(mask)
    embeds, cos, sin, offset = model.prompt(ids_t, mask_t, image, None)
    assert embeds.shape == (B, T, t.hidden_size)
    for got, want in zip((cos, sin), want_prompt):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for got, want in zip(model.decode_rope(T + offset), want_first):
        assert got.shape == (B, 1, t.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    # the engines' form: host ids and mask give the same tables and a host offset
    embeds_h, cos_h, sin_h, offset_h = model.prompt(ids_t, mask_t, image, (ids, mask))
    assert isinstance(offset_h, np.ndarray)
    np.testing.assert_array_equal(offset_h, offset.numpy())
    for a, b in ((embeds_h, embeds), (cos_h, cos), (sin_h, sin)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
