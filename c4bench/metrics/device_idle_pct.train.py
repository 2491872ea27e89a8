"""Share of the traced training segment in which the card ran no kernel,
copy or set, in percent (one minus the union of the card's work over the
segment's length). None when the trace holds no work of the card."""


def read(seg):
    if seg["kernels"] == 0:
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"])
