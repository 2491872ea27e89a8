"""Model FLOP utilisation of self-play, in percent: the moves of the traced
segment times the evaluations a move needs times the whole net's operations
a board (``flops.net_flops``), over the segment's length times the H100's
bf16 peak. None without a move."""

from c4bench import flops


def read(seg):
    if not seg.get("moves"):
        return None
    work = seg["moves"] * flops.evaluations_per_move(seg["search"]) * flops.net_flops(seg["net"])
    return 100.0 * work / (seg["window_s"] * flops.PEAK_BF16_FLOPS)
