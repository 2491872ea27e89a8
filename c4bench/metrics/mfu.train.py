"""Model FLOP utilisation of training, in percent: the positions trained in
the traced segment times three times the whole net's forward operations a
board (the convention that a backward pass costs two forwards), over the
segment's length times the H100's bf16 peak. None without a step."""

from c4bench import flops


def read(seg):
    if not seg.get("positions"):
        return None
    return 100.0 * seg["positions"] * 3 * flops.net_flops(seg["net"]) / (seg["window_s"] * flops.PEAK_BF16_FLOPS)
