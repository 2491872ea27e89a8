"""Share of the tower kernels' roofline in self-play, in percent.

The least time the forwards the traffic needs could take on an H100 (each
move's evaluations, ``flops.evaluations_per_move``, times the tower's
operations at the configuration's widths, ``flops.tower_flops``, over the
bf16 peak; whatever batch or padding the program runs them at) over the
device time of the program's tower kernels in the traced segment, by their
names (``tower_kernel``, ``tower_kernel_wide``, ``tower_layer``). None when
the trace holds no tower kernel.
"""

from c4bench import flops


def read(seg):
    kernel_s = sum(v for k, v in seg["kernel_s"].items() if "tower_kernel" in k or "tower_layer" in k)
    if kernel_s <= 0 or not seg["moves"]:
        return None
    bound_s = seg["moves"] * flops.evaluations_per_move(seg["search"]) * flops.tower_flops(seg["net"]) \
        / flops.PEAK_BF16_FLOPS
    return 100.0 * bound_s / kernel_s
