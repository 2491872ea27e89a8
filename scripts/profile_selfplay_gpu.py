"""Where the time of the port's self-play goes on the GPU.

Runs the main path of ``connect4_tpu_torch`` (``make_net_evaluator`` with the
packaged gen-161 net, ``make_refill_play_fn``) once to warm up, then once
under ``torch.profiler`` and once without it, and prints:

- the generation's wall-clock with and without the profiler;
- the device busy share: the summed time of the device kernels, memory
  copies and sets (one stream, so they do not overlap) over the profiled
  wall-clock, and over the unprofiled one (the profiler slows the host,
  which is what bounds this loop, so the truth lies between the two);
- the number of device kernels launched, in all and per search wave;
- the top device kernels by total time, with the hand-written tower
  kernel's share.

Needs a CUDA card. A JSON copy goes to ``chiprun_out/profile_selfplay.json``.

    python3 scripts/profile_selfplay_gpu.py [--slots 512 --games 1024 --sims 64 --parallel-sims 8]
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
    parser.add_argument("--slots", type=int, default=512)
    parser.add_argument("--games", type=int, default=1024)
    parser.add_argument("--sims", type=int, default=64)
    parser.add_argument("--parallel-sims", type=int, default=8)
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.training.self_play import make_refill_play_fn
    from connect4_tpu_torch.utils import make_generator

    if not torch.cuda.is_available():
        print("profile_selfplay_gpu: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    config = MCTSConfig(
        simulations=args.sims, root_dirichlet_alpha=0.3, root_exploration_fraction=0.25,
        num_sampling_moves=6, parallel_sims=args.parallel_sims,
    )
    play = make_refill_play_fn(
        make_net_evaluator(load_example_net(device=dev)), config, args.slots, args.games, device=dev
    )

    def generation(seed):
        waves = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = play(make_generator(seed, dev), progress=lambda w, n: waves.append(n))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, len(waves), int(out.mask.sum())

    generation(1)  # warm-up: builds the kernel, loads cuBLAS
    tower.run_tower.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof, waves, moves = generation(0)
    launches = tower.run_tower.launches
    wall, _, _ = generation(0)

    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device_events)
    by_name = {}
    for e in device_events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[: args.top]
    tower_us = sum(t for name, (_, t) in by_name.items() if "tower_kernel" in name)

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    report = {
        "card": smi, "torch": torch.__version__, **vars(args),
        "wall_s": wall, "wall_profiled_s": wall_prof, "waves": waves, "moves": moves,
        "moves_per_s": moves / wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall_prof,
        "device_busy_share_unprofiled": busy_us / 1e6 / wall,
        "device_events": len(device_events), "device_events_per_wave": len(device_events) / waves,
        "tower_launches": launches, "tower_s": tower_us / 1e6,
        "tower_share_of_busy": tower_us / busy_us,
        "top": [{"name": n[:120], "count": c, "s": t / 1e6} for n, (c, t) in top],
    }
    print(f"card: {smi}")
    print(f"generation: {moves} moves in {wall:.3f} s ({moves / wall:.1f} moves/s) over {waves} waves; "
          f"{wall_prof:.3f} s under the profiler")
    print(f"device busy {busy_us / 1e6:.3f} s = {report['device_busy_share']:.1%} of the profiled "
          f"wall-clock ({report['device_busy_share_unprofiled']:.1%} of the unprofiled one); "
          f"{len(device_events)} device events ({report['device_events_per_wave']:.0f} per wave)")
    print(f"tower kernel: {launches} launches, {tower_us / 1e6:.3f} s = "
          f"{report['tower_share_of_busy']:.1%} of device busy time")
    for row in report["top"]:
        print(f"  {row['s']:9.4f} s  {row['count']:7d}x  {row['name']}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_selfplay.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
