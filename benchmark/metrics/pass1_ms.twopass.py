"""Pass 1 of a two-pass batch: the backend's ``extract`` (vision tower,
prefill, decode with the extract layer's rows), its mean wall per batch in
ms, from the span around it."""

LAYER = "backends"
MOVES = "samples_per_s"


def read(r):
    s = r.spans.get("pass1")
    return 1e3 * sum(s) / len(s) if s else None
