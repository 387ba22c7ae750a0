"""Left-padded batched decode offset arithmetic.

A copy of ``attwarp_tpu/extract/offsets.py``: the JAX package's
``extract/__init__.py`` imports JAX, so the port cannot import it from
there. ``tests/test_torch_pipeline.py`` pins the two equal.

Parity with ``getmask_batch`` (attention_extraction/functions.py:254-291):
prompts are tokenized to variable lengths, left-padded to the batch max;
multimodal expansion replaces the single image-placeholder token with
``num_image_tokens`` embeddings and re-left-pads, so each sample's
image-token span shifts by its padding offset:

    expanded_len_i = unpadded_len_i - 1 + 576
    pad_offset_i   = max(expanded_len) - expanded_len_i
    img_start_i    = pad_offset_i + image_token_pos_i
    img_end_i      = img_start_i + 576

Pure-Python (host-side, shapes are static per batch) and unit-tested against
the reference formulas.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

IMAGE_TOKEN_INDEX = -200  # llava.constants convention
NUM_IMAGE_TOKENS = 576


def expanded_length(unpadded_len: int, num_image_tokens: int = NUM_IMAGE_TOKENS) -> int:
    """Prompt length after the 1 placeholder expands to N image tokens."""
    return unpadded_len - 1 + num_image_tokens


def image_token_position(token_ids: Sequence[int]) -> int:
    """Index of the image placeholder; falls back to 1 (after BOS) if absent
    (functions.py:117-122)."""
    try:
        return list(token_ids).index(IMAGE_TOKEN_INDEX)
    except ValueError:
        return 1


def batch_image_token_ranges(
    unpadded_lens: Sequence[int],
    image_token_positions: Sequence[int],
    num_image_tokens: int = NUM_IMAGE_TOKENS,
) -> Tuple[List[int], List[int]]:
    """Per-sample (start, end) of the image-token span in the left-padded,
    multimodally-expanded batch (functions.py:273-291)."""
    expanded = [expanded_length(ul, num_image_tokens) for ul in unpadded_lens]
    max_expanded = max(expanded)
    starts, ends = [], []
    for exp_len, pos in zip(expanded, image_token_positions):
        st = (max_expanded - exp_len) + pos
        starts.append(st)
        ends.append(st + num_image_tokens)
    return starts, ends


def bucket_length(n: int, bucket: int = 64) -> int:
    """Round a sequence length up to the next bucket multiple. Bucketing the
    padded length means one XLA compilation serves every batch whose max
    prompt falls in the same bucket — a TPU concern the reference (eager
    PyTorch) never had."""
    if bucket <= 1:
        return n
    return ((n + bucket - 1) // bucket) * bucket


def left_pad(
    ids_list: Sequence[Sequence[int]], pad_id: int = 0, bucket: int = 1
) -> Tuple[List[List[int]], List[List[int]]]:
    """Left-pad variable-length token lists to the max length (rounded up to
    ``bucket``); returns (padded_ids, attention_mask) (functions.py:254-266)."""
    max_len = bucket_length(max(len(ids) for ids in ids_list), bucket)
    padded, mask = [], []
    for ids in ids_list:
        n = len(ids)
        padded.append([pad_id] * (max_len - n) + list(ids))
        mask.append([0] * (max_len - n) + [1] * n)
    return padded, mask
