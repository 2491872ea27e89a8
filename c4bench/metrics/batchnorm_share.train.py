"""Share of the card's kernel time in the traced training segment spent in
batch-norm kernels, in percent, matched by name: cuDNN's ``bn_fw`` and
``bn_bw`` kernels and ATen's ``batch_norm`` kernels (any case). None when
the trace holds no kernel."""

PATTERNS = ("bn_fw", "bn_bw", "batch_norm", "batchnorm")


def read(seg):
    total = sum(seg["kernel_s"].values())
    if total <= 0:
        return None
    bn = sum(v for k, v in seg["kernel_s"].items() if any(p in k.lower() for p in PATTERNS))
    return 100.0 * bn / total
