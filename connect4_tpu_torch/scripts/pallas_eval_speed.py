"""A/B the tower kernel against the folded net through the library's convolutions.

The counterpart of the JAX package's ``scripts/pallas_eval_speed.py``, which
sets the fused Pallas tower against XLA's folded-BN path on the packaged
gen-161 net. Here the two routes of that net (``models.convert.
load_example_net``) are:

- ``library`` (the JAX script's ``xla_fwd``): the folded ``InferenceNet`` in
  bf16 (``models.net.inference_net``), one library convolution a layer
  (cuDNN on the card);
- ``kernel`` (its ``pallas_fwd``): the folded tower of ``models.tower``
  (``tower.forward``), the hand-written kernel on the card.

At each batch (``--batches``, default 2048 and 4096) it prints the kernel
route's first call at that batch (in a fresh process the first batch's
includes the kernel's build and load), the largest |dv| and |dp| between
the two routes on the same boards, and each route's ms a call and TFLOP/s
over ``--iters`` calls (default 30), host-timed with the card synchronised
around the calls, as the JAX script times them. The operations are the tower's convs at the net's own width
(``tower.tower_bound``: 37.3 MFLOP a board at gen-161's F=64). The boards
are the JAX script's kind, each plane cell set with probability 1/4, drawn
with numpy from the batch size as the seed (``boards``), so that the same
boards can be fed to the JAX package.

With ``--device cpu`` both routes run on the CPU: the tower's plain version
(float32 products rounded to nearest) against the library's CPU
convolutions.

    python -m connect4_tpu_torch.scripts.pallas_eval_speed [--batches 2048 4096] [--iters 30] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.types import HEIGHT, WIDTH
from connect4_tpu_torch.utils import resolve_device


def boards(b: int) -> np.ndarray:
    """``[b, 6, 7, 3]`` float32 planes, each cell 1 with probability 1/4,
    drawn with numpy from the seed ``b``."""
    return (np.random.default_rng(b).random((b, HEIGHT, WIDTH, 3)) < 0.25).astype(np.float32)


def eval_speed(net, batches=(2048, 4096), iters: int = 30, device="cuda") -> dict:
    """Both routes of the bf16 ``net`` at each of ``batches``: the kernel
    route's first call, max |dv| and |dp| between the routes, and each
    route's ms and TFLOP/s over ``iters`` calls. Returns ``{"rows": [...],
    ...}``, one row a batch."""
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.net import fold_bn_params, inference_net

    dev = resolve_device(device)
    config = net.config
    if config.compute_dtype != "bfloat16":
        raise ValueError(f"the tower kernel computes in bf16; the net computes in {config.compute_dtype}")
    packed = tower.pack_weights(config, fold_bn_params(net))
    routes = {"library": inference_net(net), "kernel": lambda x: tower.forward(packed, x)}
    rows = []
    with torch.no_grad():
        for b in batches:
            x = torch.from_numpy(boards(b)).to(dev)
            vx, px = routes["library"](x)
            (vp, pp), first_s = _common.timed(lambda: routes["kernel"](x), dev)
            row = {"batch": b, "first_s": first_s,
                   "max_dv": (vp.float() - vx.float()).abs().max().item(),
                   "max_dp": (pp.float() - px.float()).abs().max().item()}
            flops = tower.tower_bound(config, b)[2]
            for name, route in routes.items():
                route(x)  # warm
                _, seconds = _common.timed(lambda: [route(x) for _ in range(iters)], dev)
                ms = seconds / iters * 1e3
                row[f"{name}_ms"] = ms
                row[f"{name}_tflops"] = flops / ms / 1e9
            rows.append(row)
    return {"net_config": dataclasses.asdict(config), "iters": iters, "rows": rows,
            "device": _common.device_name(dev)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[2048, 4096])
    parser.add_argument("--iters", type=int, default=30)
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    from connect4_tpu_torch.models.convert import load_example_net

    dev = resolve_device(args.device)
    r = eval_speed(load_example_net(device=dev), args.batches, args.iters, dev)
    for row in r["rows"]:
        print(f"B={row['batch']}: kernel first call {row['first_s']:.1f}s", flush=True)
        print(f"  max |dv|={row['max_dv']:.4f}  max |dp|={row['max_dp']:.4f}")
        for name in ("library", "kernel"):
            print(f"  {name:7s} {row[name + '_ms']:6.3f} ms  ({row[name + '_tflops']:.1f} TFLOP/s)", flush=True)
    _common.emit({**r, "net": "gen161"})
    return r


if __name__ == "__main__":
    main()
