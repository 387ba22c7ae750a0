"""The port's two-pass pipeline against the JAX pipeline on the same
weights, and the port's copies of the pure-Python text helpers (dry-run
tokenizer, prompts, offsets) against their originals.

Pipeline tolerances: answers equal; maps 1e-5 (f32 on both sides); masks
within 1 uint8 LSB (two uint8 quantization points); warped images within
the warp budget 1e-3 on [0, 1] pixels.
"""

import jax
import numpy as np
import pytest

from attwarp_tpu.extract import offsets as j_offsets
from attwarp_tpu.extract import prompts as j_prompts
from attwarp_tpu.extract.llava_backend import LlavaBackend as JBackend
from attwarp_tpu.pipeline import AttWarpPipeline as JPipeline
from tools.make_random_7b_ckpt import build_dry_run_tokenizer

from attwarp_tpu_torch.extract import offsets as t_offsets
from attwarp_tpu_torch.extract import prompts as t_prompts
from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.pipeline import AttWarpPipeline

from test_torch_llava import models  # noqa: F401  (module-scoped fixture)

TEXTS = [
    "what is the text on the label?",
    "A chat between a curious human and an artificial intelligence assistant.",
    "USER: <image>\nread the code; tag (key-phrase) ASSISTANT:",
    "what's 3.5 é Über   spaces\tand\nlines!!",
    "",
]


def test_tokenizer_matches_dry_run_tokenizer(rng):
    hf, ours = build_dry_run_tokenizer(), DryRunTokenizer()
    assert ours.vocab == hf.get_vocab()
    for text in TEXTS:
        for special in (True, False):
            assert ours.encode(text, add_special_tokens=special) == \
                hf.encode(text, add_special_tokens=special), text
    for n in (0, 1, 7, 40):
        ids = [int(i) for i in rng.integers(0, 130, n)] + [32000, 5000]
        for skip in (True, False):
            assert ours.decode(ids, skip_special_tokens=skip) == \
                hf.decode(ids, skip_special_tokens=skip), ids


def test_tokenizer_files_read_by_hf(tmp_path):
    """The files the port's tokenizer writes: ``tokenizers`` and
    ``transformers.AutoTokenizer`` read them into a tokenizer with the
    port's ids and text, and the port reads them back unchanged."""
    from tokenizers import Tokenizer
    from transformers import AutoTokenizer

    ours = DryRunTokenizer()
    ours.save_pretrained(tmp_path)
    raw = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    auto = AutoTokenizer.from_pretrained(str(tmp_path))
    assert auto.vocab == ours.vocab and auto.all_special_ids == ours.all_special_ids
    assert (auto.bos_token_id, auto.eos_token_id, auto.pad_token_id, auto.unk_token_id) == \
        (ours.bos_token_id, ours.eos_token_id, ours.pad_token_id, ours.unk_token_id)
    for text in TEXTS + ["USER: </s> the <s> tag <unk>"]:
        ids = ours.encode(text)
        assert raw.encode(text).ids == ids, text
        assert raw.encode(text, add_special_tokens=False).ids == ours.encode(text, False)
        for special in (True, False):
            assert auto.encode(text, add_special_tokens=special) == \
                ours.encode(text, add_special_tokens=special), text
        for skip in (True, False):
            assert auto.decode(ids, skip_special_tokens=skip) == \
                ours.decode(ids, skip_special_tokens=skip)
    back = DryRunTokenizer.from_pretrained(tmp_path)
    assert vars(back).keys() == vars(ours).keys()
    assert all(getattr(back, k) == v for k, v in vars(ours).items())
    assert DryRunTokenizer.from_pretrained(tmp_path / "none") is None


def test_prompt_and_offset_copies_match():
    for mode in list(j_prompts.CONV_TEMPLATES) + ["unknown"]:
        for q in ("what is shown?", "see <image-placeholder> here"):
            for se in (False, True):
                assert t_prompts.build_prompt(q, mode, se) == j_prompts.build_prompt(q, mode, se)
        assert t_prompts.stop_str_for(mode) == j_prompts.stop_str_for(mode)
    for name in ("llava-v1.5-7b", "llava-llama-2", "mpt-7b", "other"):
        assert t_prompts.infer_conv_mode(name) == j_prompts.infer_conv_mode(name)
    ids = [[1, 5, -200, 7], [1, -200], [4, 4, 4, 4, 4, -200, 9]]
    for bucket in (1, 4, 64):
        assert t_offsets.left_pad(ids, 2, bucket) == j_offsets.left_pad(ids, 2, bucket)
    lens = [len(x) for x in ids]
    pos = [t_offsets.image_token_position(x) for x in ids]
    assert pos == [j_offsets.image_token_position(x) for x in ids]
    assert t_offsets.batch_image_token_ranges(lens, pos, 16) == \
        j_offsets.batch_image_token_ranges(lens, pos, 16)


def test_pipeline_matches_jax(models, rng):  # noqa: F811
    jm, tm = models
    jbe = JBackend(jm, tokenizer=build_dry_run_tokenizer(), extract_layer=1,
                   kv_quant=True)
    tbe = LlavaBackend(tm, tokenizer=DryRunTokenizer(), extract_layer=1,
                       kv_quant=True)
    images = [
        (rng.random((60, 80, 3)) * 255).astype(np.uint8),
        rng.random((72, 72, 3)).astype(np.float32),
        (rng.random((60, 80, 3)) * 255).astype(np.uint8),
    ]
    questions = ["what is the text?", "read the label", "what is shown here?"]
    kw = dict(warp_size=48, max_new_tokens=3, size_bucket=16, max_side=96)
    ref = JPipeline(jbe, **kw).run(images, questions)
    jax.effects_barrier()
    got = AttWarpPipeline(tbe, **kw).run(images, questions)

    assert got.first_answers == ref.first_answers
    assert got.second_answers == ref.second_answers
    np.testing.assert_allclose(got.attention_maps, ref.attention_maps, atol=1e-5)
    assert len(got.mota_masks) == 3
    for m_t, m_j in zip(got.mota_masks, ref.mota_masks):
        assert m_t.shape == m_j.shape and m_t.dtype == m_j.dtype == np.uint8
        assert np.abs(m_t.astype(np.int16) - m_j.astype(np.int16)).max() <= 1
    assert got.warped.shape == ref.warped.shape == (3, 48, 48, 3)
    assert np.max(np.abs(got.warped - ref.warped)) <= 1e-3 * 255


@pytest.mark.parametrize("bucket,max_side,want", [
    (64, 1024, (512, 640)), (0, 1024, (480, 640)), (64, 600, (512, 600)),
])
def test_bucket_target_matches_jax(bucket, max_side, want):
    ours = AttWarpPipeline(None, size_bucket=bucket, max_side=max_side)
    theirs = JPipeline(None, size_bucket=bucket, max_side=max_side)
    assert ours._bucket_target((480, 640)) == theirs._bucket_target((480, 640)) == want
