"""Where the time of the port's train step goes on the GPU.

Runs ``connect4_tpu_torch.training.learner.make_train_step`` on the
full-width net (F=64, fc 6, res 6) at batch 4096 on stored uint8 NCHW planes
of legal positions, warms up, then profiles a few steps under
``torch.profiler`` and prints, for bf16 and float32:

- ms per step by CUDA events without the profiler, and the host's time to
  enqueue a step;
- the device busy time per step and the number of device kernels per step;
- the top device kernels by total time, and the shares of BatchNorm (cuDNN's
  forward-training and backward kernels) and of the convolutions (forward,
  data gradient, weight gradient, their layout changes) in device busy time.

Needs a CUDA card. A JSON copy goes to ``chiprun_out/profile_train_step.json``.

    python3 scripts/profile_train_step_gpu.py [--batch 4096 --steps 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import random_positions, timed_ms
    from connect4_tpu_torch.config import ModelConfig, NetConfig
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.training.learner import init_train_state, make_train_step
    from connect4_tpu_torch.utils import make_generator, resolve_device

    if not torch.cuda.is_available():
        print("profile_train_step_gpu: needs a CUDA card", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    g = make_generator(0, dev)
    n = args.batch
    planes = to_planes(random_positions(n, g, dev), dtype=torch.uint8)
    values = torch.randint(0, 3, (n,), generator=g, device=dev).float() / 2
    priors = torch.softmax(2 * torch.randn((n, 7), generator=g, device=dev), -1)

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(f"card: {smi}")
    report = {"card": smi, "torch": torch.__version__, **vars(args), "dtypes": {}}
    for dtype in ("bfloat16", "float32"):
        config = ModelConfig(net_config=NetConfig(
            filters=64, n_fc_layers=6, n_residuals=6, compute_dtype=dtype))
        state = init_train_state(config, torch.Generator().manual_seed(0), dev)
        step = make_train_step(state.net, state.optimizer)
        ms = timed_ms(lambda: step(planes, values, priors), iters=10, warmup=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(planes, values, priors)
        enqueue_ms = (time.perf_counter() - t0) / args.steps * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                step(planes, values, priors)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in events)
        by_name = {}
        for e in events:
            c, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[: args.top]
        conv_words = ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad", "fprop", "fft2d",
                      "winograd", "nchwToNhwc", "nhwcToNchw")
        bn_us = sum(t for name, (_, t) in by_name.items() if "::bn_" in name or "batch_norm" in name)
        conv_us = sum(t for name, (_, t) in by_name.items()
                      if "::bn_" not in name and any(w in name for w in conv_words))
        row = {
            "ms": ms, "enqueue_ms": enqueue_ms, "device_busy_ms": busy_us / 1e3 / args.steps,
            "device_kernels_per_step": len(events) / args.steps,
            "batchnorm_share_of_busy": bn_us / busy_us, "conv_share_of_busy": conv_us / busy_us,
            "top": [{"name": k[:110], "count": c, "ms_per_step": t / 1e3 / args.steps} for k, (c, t) in top],
        }
        report["dtypes"][dtype] = row
        print(f"{dtype}: {ms:.3f} ms a step at batch {n} ({n / ms * 1e3:,.0f} positions/s); host "
              f"enqueues a step in {enqueue_ms:.3f} ms; device busy {row['device_busy_ms']:.3f} ms a step in "
              f"{row['device_kernels_per_step']:.0f} kernels; BatchNorm "
              f"{row['batchnorm_share_of_busy']:.1%} and convolutions with their layout changes "
              f"{row['conv_share_of_busy']:.1%} of busy time")
        for r in row["top"]:
            print(f"  {r['ms_per_step']:8.3f} ms  {r['count'] // args.steps:4d}x  {r['name']}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_train_step.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
