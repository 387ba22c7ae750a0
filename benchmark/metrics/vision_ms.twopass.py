"""The vision tower's wall per two-pass batch, both passes summed, in ms:
the span around the vision entry the configuration file names
(``vision_entry``)."""

LAYER = "vision tower"
MOVES = "samples_per_s"


def read(r):
    v, b = r.spans.get("vision"), r.spans.get("batch")
    return 1e3 * sum(v) / len(b) if v and b else None
