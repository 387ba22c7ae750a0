"""Attention extraction: prompts, tokenizers, accumulator, resizes, the LLaVA
and Qwen2-VL backends, and the mini test MLLM with its API (``extraction``)."""
