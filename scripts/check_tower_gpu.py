"""Build the tower kernel, hold it against its plain version, optionally time it.

The short first run after an edit of ``connect4_tpu_torch/models/csrc/tower.cu``:
builds the kernel (printing the ptxas report: registers, spills), runs it on
legal positions with the packaged gen-161 net (F=64) and a small random net
(F=16 and F=32) at a few batch sizes, for every chain length, and prints
each against ``tower_plain`` summed in the same order, with the tensor
core's accumulate emulated (``model``: the count of differing elements
should be 0) and rounded to nearest. With ``--time`` it
then times the kernel per chain length at B=4096, 512 and 64 (CUDA events,
20 launches after 3 warm-ups). ``--filters 264 512`` adds fresh nets of
those widths at full depth (fc 6, res 6), which above 256 filters run
through the layer kernel: compared at the same batches (every element must
equal the emulated version, the padded channels must be 0) and, with
``--time``, timed at B=4096, 512 and 64 beside the bound.

Needs a CUDA card (sm_90a) and nvcc. Exits 1 if the shipped chain exceeds
the tolerances ``chip_smoke.py`` states against the emulated version.

    python3 scripts/check_tower_gpu.py [--time] [--batches 261 1] [--filters 264 512]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--time", action="store_true")
    parser.add_argument("--batches", type=int, nargs="+", default=[261, 1])
    parser.add_argument("--filters", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("check_tower_gpu: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import TOL_TOWER_MEAN, TOL_VALUE_PRIOR, random_positions, timed_ms
    from connect4_tpu_torch import build
    from connect4_tpu_torch.config import NetConfig
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.models.net import fold_bn_params, init_net
    from connect4_tpu_torch.utils import make_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    tower._library()
    print(build.BUILD_LOGS.get(tower.SOURCE, "(already built)").strip(), flush=True)

    gen = make_generator(0, dev)
    nets = {"gen161": load_example_net(device=dev)}
    for f in (16, 32):
        cfg = NetConfig(filters=f, n_fc_layers=2, n_residuals=2, compute_dtype="bfloat16")
        nets[f"random F={f}"] = init_net(cfg, torch.Generator().manual_seed(f), device=dev)
    for f in args.filters:
        cfg = NetConfig(filters=f, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16")
        nets[f"random F={f}"] = init_net(cfg, torch.Generator().manual_seed(f), device=dev)
    bad = []
    for name, net in nets.items():
        packed = tower.pack_weights(net.config, fold_bn_params(net))
        chains = tower.CHAINS if net.config.filters == 64 else (tower.CHAIN,)
        for b in args.batches:
            x2d = (to_planes(random_positions(b, gen, dev)).permute(0, 2, 3, 1)
                   .reshape(b * 42, net.config.channels).float().contiguous())
            for chain in chains:
                with torch.no_grad():
                    layers = tower.run_tower.layer_launches
                    tk = tower.run_tower(packed, x2d, chain=chain)
                    torch.cuda.synchronize()
                    vk, pk = tower.heads(packed, tk)
                    finite = bool(torch.isfinite(tk.float()).all())
                    padded_zero = not tk[:, net.config.filters:].any()
                    print(f"[compare] {name} B={b} packed F={tk.shape[1]}: layer launches "
                          f"{tower.run_tower.layer_launches - layers}, padded channels all 0 {padded_zero}")
                    for ref, tensor_core in (("model", True), ("nearest", False)):
                        tp = tower.tower_plain(packed, x2d, chain, tensor_core)
                        vp, pp = tower.heads(packed, tp)
                        d = (tk.float() - tp.float()).abs()
                        e = (d.max().item(), d.mean().item(), (vk - vp).abs().max().item(),
                             (pk - pp).abs().max().item())
                        print(f"[compare] {name} B={b} chain={chain} vs {ref}: "
                              f"{int((tk != tp).sum())} differ, |tower| max {e[0]:.6g} "
                              f"mean {e[1]:.3g}  |value| max {e[2]:.6g}  |prior| max {e[3]:.6g}"
                              f"{'' if finite else '  NOT FINITE'}", flush=True)
                        if chain == tower.CHAIN and tensor_core and (
                                not finite or e[1] > TOL_TOWER_MEAN or max(e[2:]) > TOL_VALUE_PRIOR
                                or not padded_zero
                                or (tower.is_layer_width(tk.shape[1]) and int((tk != tp).sum()))):
                            bad.append((name, b, e))
    if bad:
        print(f"check_tower_gpu: FAILED: {bad}")
        return 1

    if args.time:
        packed = tower.pack_weights(nets["gen161"].config, fold_bn_params(nets["gen161"]))
        with torch.no_grad():
            for b in (4096, 512, 64):
                x2d = (to_planes(random_positions(b, gen, dev)).permute(0, 2, 3, 1)
                       .reshape(b * 42, 3).float().contiguous())
                print(f"[time] B={b}: (boards a block, blocks) {tower.tile_plan(b)}, shipped chain {tower.CHAIN}")
                for chain in tower.CHAINS:
                    ms = timed_ms(lambda: tower.run_tower(packed, x2d, chain=chain))
                    print(f"[time] B={b} chain={chain}: {ms:.4f} ms", flush=True)
        for f in args.filters:
            net = nets[f"random F={f}"]
            packed = tower.pack_weights(net.config, fold_bn_params(net))
            with torch.no_grad():
                for b in (4096, 512, 64):
                    x2d = (to_planes(random_positions(b, gen, dev)).permute(0, 2, 3, 1)
                           .reshape(b * 42, 3).float().contiguous())
                    ms = timed_ms(lambda: tower.run_tower(packed, x2d))
                    bound_ms, bound_by, flops, _ = tower.tower_bound(net.config, b)
                    print(f"[time] F={f} (packed {tower.kernel_width(f)}) B={b}: {ms:.4f} ms, bound "
                          f"{bound_ms:.4f} ms by {bound_by}, {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
