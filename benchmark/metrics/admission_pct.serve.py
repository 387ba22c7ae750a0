"""The share of the window the serving engines spent admitting (the summed
intervals of their ``admit_log``: vision tower, prefill and the cache
insert), in %."""

LAYER = "serving engine"
MOVES = "served_tok_per_s"


def read(r):
    a = r.counters.get("admission_s")
    return 100.0 * a / r.window_s if a is not None and r.window_s > 0 else None
