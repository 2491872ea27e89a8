"""What the two kinds of traffic share: seeds, the weights the benchmark
makes, the program's net built from them, and the split of set-up."""

from __future__ import annotations

import hashlib
import time
from typing import Dict

import torch

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
    from two draws of a generator on ``device``: kernels normal with
    variance 1 / fan-in, Dense and 1x1-conv biases 0.1 / sqrt(fan-in)
    normal, BatchNorm scales 1 + 0.1 normal and shifts 0.1 normal, running
    means 0.1 normal, running variances uniform in [1, 1.5)."""
    shapes = ref_net.param_shapes(net)
    g = generator(seed, device, "weights")
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    normal = torch.randn(sum(sizes), generator=g, device=device).split(sizes)
    uniform = torch.rand(sum(sizes), generator=g, device=device).split(sizes)
    out, fan_in = {}, None
    for (name, shape), z, u in zip(shapes.items(), normal, uniform):
        z, u = z.view(shape), u.view(shape)
        leaf = name.rsplit(".", 1)[1]
        if ".bn" in name:
            out[name] = {"weight": 1.0 + 0.1 * z, "bias": 0.1 * z, "running_mean": 0.1 * z,
                         "running_var": 1.0 + 0.5 * u}[leaf]
        elif leaf == "weight":
            fan_in = torch.Size(shape[1:]).numel()
            out[name] = z / fan_in ** 0.5
        else:  # the bias of the layer whose kernel came just before
            out[name] = 0.1 * z / fan_in ** 0.5
    return out


def program_net(net: dict, weights: Dict[str, torch.Tensor], device):
    """The program's net of this configuration on ``device``, holding
    ``weights`` (its default initialisation runs on ``device`` and is
    overwritten), in inference mode."""
    from connect4_tpu_torch.config import NetConfig
    from connect4_tpu_torch.models.net import Connect4Net

    config = NetConfig(channels=net["channels"], filters=net["filters"], n_fc_layers=net["n_fc_layers"],
                       n_residuals=net["n_residuals"], compute_dtype=net["compute_dtype"])
    with torch.device(device):
        model = Connect4Net(config)
    state = {k: v.clone() for k, v in weights.items()}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
    model.load_state_dict(state, strict=True)
    return model.eval()


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
