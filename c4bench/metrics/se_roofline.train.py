"""Share of the learner's squeeze-and-excitation gate kernels' roofline in
training, in percent: the bytes the gate must move in the traced steps
(``se_gate_bytes`` of the configuration's architecture, a board at a time,
for every position trained) over the memory rate, over the device time of
the program's kernels named ``se_gate`` in the traced segment. None when
the trace holds no such kernel or the architecture has no gate."""

from c4bench import flops
from c4bench.reference import net as ref_net


def read(seg):
    kernel_s = sum(v for k, v in seg["kernel_s"].items() if "se_gate" in k)
    arch = ref_net.arch(seg["net"])
    if kernel_s <= 0 or not seg.get("positions") or not hasattr(arch, "se_gate_bytes"):
        return None
    return 100.0 * seg["positions"] * arch.se_gate_bytes(seg["net"]) / flops.PEAK_BYTES / kernel_s
