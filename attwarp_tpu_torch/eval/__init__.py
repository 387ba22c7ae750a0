"""Evaluation: VQA answer scoring and the TextVQA accuracy harness."""
