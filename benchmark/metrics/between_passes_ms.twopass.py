"""What a two-pass batch spends outside the two backend passes (the
pipeline's resizes, shape grouping, the MOTA masks, the warp and the host
copies): the mean over batches of the batch's span less its two pass
spans, in ms."""

LAYER = "pipeline"
MOVES = "samples_per_s"


def read(r):
    b, p1, p2 = (r.spans.get(k) for k in ("batch", "pass1", "pass2"))
    if not b or not p1 or not p2 or not len(b) == len(p1) == len(p2):
        return None
    return 1e3 * sum(x - y - z for x, y, z in zip(b, p1, p2)) / len(b)
