"""LLaVA-1.5: CLIP vision tower, LLaMA decoder and the two-tower model."""
