"""What the two kinds of traffic share: seeds, the weights the benchmark
makes, the program's net built from them, and the split of set-up."""

from __future__ import annotations

import hashlib
import time
from typing import Dict

import torch

from c4bench import builders
from c4bench.reference import net as ref_net


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (any size of int)."""
    key = ":".join([str(int(seed))] + [str(t) for t in tags]).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *tags))


@torch.no_grad()
def make_weights(net: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The net's weights and BatchNorm statistics, float32 on ``device``,
    from two draws of a generator on ``device``, each leaf as its
    architecture marks it (``ref_net.leaves``): kernels normal with
    variance 1 / fan-in, Dense and 1x1-conv biases 0.1 / sqrt(fan-in)
    normal, BatchNorm scales 1 + 0.1 normal and shifts 0.1 normal, running
    means 0.1 normal, running variances uniform in [1, 1.5)."""
    leaves = ref_net.leaves(net)
    g = generator(seed, device, "weights")
    sizes = [torch.Size(leaf.shape).numel() for leaf in leaves.values()]
    normal = torch.randn(sum(sizes), generator=g, device=device).split(sizes)
    uniform = torch.rand(sum(sizes), generator=g, device=device).split(sizes)
    out, fan_in = {}, None
    for (name, (shape, kind)), z, u in zip(leaves.items(), normal, uniform):
        z, u = z.view(shape), u.view(shape)
        if kind == ref_net.BN_SCALE:
            out[name] = 1.0 + 0.1 * z
        elif kind in (ref_net.BN_SHIFT, ref_net.BN_MEAN):
            out[name] = 0.1 * z
        elif kind == ref_net.BN_VAR:
            out[name] = 1.0 + 0.5 * u
        elif kind == ref_net.KERNEL:
            fan_in = torch.Size(shape[1:]).numel()
            out[name] = z / fan_in ** 0.5
        else:  # the bias of the layer whose kernel came just before
            out[name] = 0.1 * z / fan_in ** 0.5
    return out


def program_net(net: dict, weights: Dict[str, torch.Tensor], device):
    """The program's net of this configuration on ``device``, holding
    ``weights``, in inference mode: built by the program side of the net's
    architecture (``c4bench/builders/<arch>.py``)."""
    return builders.find(net).build(net, weights, device)


class SetupClock:
    """Seconds of set-up by part, on the host clock with the card
    synchronised at each boundary."""

    def __init__(self, device):
        self.device, self.parts = torch.device(device), {}
        self._t = time.perf_counter()

    def mark(self, part: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self._t
        self._t = now
