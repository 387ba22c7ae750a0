"""The serving engine's slot occupancy over the window, in %: the decode
tokens kept (the engines' ``tick_log``) over decode steps times slots (their
``decode_steps`` and ``slots``)."""

LAYER = "serving engine"
MOVES = "served_tok_per_s"


def read(r):
    s = r.counters.get("slot_steps")
    return 100.0 * r.counters["tokens_kept"] / s if s else None
