"""The model's share of the card's bf16 peak over the window, in %: the
model FLOPs the window's requests need (vision tower and projector, the causal prefill of each prompt, decode of each served token over its cache, the LM head where a token is produced), counted from the configuration's widths
(``counts/model_flops.py``), over the window's time, over 989 TFLOP/s."""

from benchmark.counts.model_flops import BF16_PEAK_FLOPS

LAYER = "model step"
MOVES = "served_tok_per_s"


def read(r):
    f = r.counters.get("model_flops")
    return 100.0 * f / r.window_s / BF16_PEAK_FLOPS if f else None
