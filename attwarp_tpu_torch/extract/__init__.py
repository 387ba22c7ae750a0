"""Attention extraction: prompts, tokenizer, accumulator, resizes and the LLaVA backend."""
