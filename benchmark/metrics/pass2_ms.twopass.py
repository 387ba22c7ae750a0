"""Pass 2 of a two-pass batch: the backend's ``answer_batch`` on the warped
images, its mean wall per batch in ms, from the span around it."""

LAYER = "backends"
MOVES = "samples_per_s"


def read(r):
    s = r.spans.get("pass2")
    return 1e3 * sum(s) / len(s) if s else None
