"""Build the tower kernel, hold it against its plain version, optionally time it.

The short first run after an edit of ``connect4_tpu_torch/models/csrc/tower.cu``:
builds the kernel (printing the ptxas report, then each instantiation's
registers and spills, and the layer kernel's cluster size, ``kCluster`` in
the source: how many blocks share each weight slab), runs it on legal
positions with the packaged
gen-161 net (F=64) and a small random net (F=16 and F=32) at a few batch
sizes, for every chain length, and prints each against ``tower_plain``
summed in the same order, with the tensor core's accumulate emulated
(``model``: the count of differing elements should be 0) and rounded to
nearest. With ``--time`` it then times the kernel per chain length at
B=4096, 512 and 64 (CUDA events, 20 launches after 3 warm-ups).
``--filters 264 512 1024`` adds fresh nets of those widths at full depth
(fc 6, res 6), which above 256 filters run through the layer kernel:
compared at the same batches (every element must equal the emulated
version, the padded channels must be 0) and, with ``--time``, timed twice
at B=4096, 2048, 512 and 64 beside the bound and cuDNN's bf16 tower. To
compare with another commit, run that commit's own copy of this script in
the same call (``git archive`` it into a directory ``.gitignore`` lists).

Needs a CUDA card (sm_90a) and nvcc. Exits 1 if the shipped chain exceeds
the tolerances ``chip_smoke.py`` states against the emulated version. The
numbers also go to ``chiprun_out/check_tower_gpu.json``.

    python3 scripts/check_tower_gpu.py [--time] [--batches 261 1] [--filters 264 512 1024]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TIME_BATCHES = (4096, 2048, 512, 64)


def ptxas_summary(log: str) -> list:
    """``[(kernel, registers, spill stores, spill loads)]`` of each entry
    function in an ``nvcc -Xptxas -v`` report, with the templates' arguments
    read back from the mangled names."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            for pattern, fmt in ((r"tower_layerILi(\d+)ELb([01])E", "tower_layer<N={}, first={}>"),
                                 (r"tower_kernel_wideILi(\d+)E", "tower_kernel_wide<F={}>"),
                                 (r"tower_kernelILi(\d+)ELi(\d+)E", "tower_kernel<F={}, chain={}>")):
                k = re.search(pattern, name)
                if k:
                    out.append((fmt.format(*k.groups()), int(m.group(1)), *spills))
                    break
            name = None
    return out


def layer_cluster(source: str) -> int:
    """The layer kernel's cluster size, the ``kCluster`` constant of its source."""
    with open(source) as fh:
        return int(re.search(r"constexpr int kCluster = (\d+);", fh.read()).group(1))


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
    from chip_smoke import TOL_TOWER_MEAN, TOL_VALUE_PRIOR, cudnn_tower, random_positions, timed_ms
    from connect4_tpu_torch import build
    from connect4_tpu_torch.config import NetConfig
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.models.net import fold_bn_params, init_net
    from connect4_tpu_torch.utils import make_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(smi)
    tower._library()
    log = build.BUILD_LOGS.get(tower.SOURCE, "")
    print(log.strip() or "(already built)", flush=True)
    report = {"nvidia_smi": smi, "layer_cluster": layer_cluster(tower.SOURCE), "ptxas": ptxas_summary(log),
              "compare": [], "time": []}
    for kernel, regs, stores, loads in report["ptxas"]:
        print(f"[ptxas] {kernel}: {regs} registers, spill stores {stores} B, spill loads {loads} B")
    print(f"[cluster] the layer kernel multicasts each weight slab to {report['layer_cluster']} blocks",
          flush=True)

    def rows(b, gen):
        return (to_planes(random_positions(b, gen, dev)).permute(0, 2, 3, 1)
                .reshape(b * 42, 3).float().contiguous())

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
        layered = tower.is_layer_width(packed["conv1_w"].shape[1])
        chains = tower.CHAINS if net.config.filters == 64 else (tower.CHAIN,)
        for b in args.batches:
            x2d = rows(b, gen)
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
                        differ = int((tk != tp).sum())
                        print(f"[compare] {name} B={b} chain={chain} vs {ref}: "
                              f"{differ} differ, |tower| max {e[0]:.6g} "
                              f"mean {e[1]:.3g}  |value| max {e[2]:.6g}  |prior| max {e[3]:.6g}"
                              f"{'' if finite else '  NOT FINITE'}", flush=True)
                        report["compare"].append({"net": name, "boards": b, "chain": chain, "vs": ref,
                                                  "differ": differ, "errors": e})
                        if chain == tower.CHAIN and tensor_core and (
                                not finite or e[1] > TOL_TOWER_MEAN or max(e[2:]) > TOL_VALUE_PRIOR
                                or not padded_zero or (layered and differ)):
                            bad.append((name, b, e))
    if bad:
        print(f"check_tower_gpu: FAILED: {bad}")
        return 1

    if args.time:
        packed = tower.pack_weights(nets["gen161"].config, fold_bn_params(nets["gen161"]))
        with torch.no_grad():
            for b in (4096, 512, 64):
                x2d = rows(b, gen)
                print(f"[time] B={b}: (boards a block, blocks) {tower.tile_plan(b)}, shipped chain {tower.CHAIN}")
                for chain in tower.CHAINS:
                    ms = timed_ms(lambda: tower.run_tower(packed, x2d, chain=chain))
                    print(f"[time] B={b} chain={chain}: {ms:.4f} ms", flush=True)
        for f in args.filters:
            net = nets[f"random F={f}"]
            folded = fold_bn_params(net)
            packed = tower.pack_weights(net.config, folded)
            fp = packed["conv1_w"].shape[1]
            lib_tower = cudnn_tower(folded, net.config)
            with torch.no_grad():
                for b in TIME_BATCHES:
                    x2d = rows(b, gen)
                    nhwc = x2d.reshape(b, 6, 7, 3)
                    bound_ms, bound_by, flops, _ = tower.tower_bound(net.config, b)
                    t = {"filters": f, "packed": fp, "boards": b, "bound_ms": bound_ms, "bound_by": bound_by}
                    t["ms"] = timed_ms(lambda: tower.run_tower(packed, x2d))
                    t["ms_again"] = timed_ms(lambda: tower.run_tower(packed, x2d))
                    t["library_ms"] = timed_ms(lambda: lib_tower(nhwc))
                    report["time"].append(t)
                    print(f"[time] F={f} (packed {fp}) B={b}: {t['ms']:.4f} ms (again {t['ms_again']:.4f}), "
                          f"cuDNN {t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
                          f"{flops / t['ms'] / 1e9:.1f} TFLOP/s, {100 * bound_ms / t['ms']:.1f}% of the bound",
                          flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "check_tower_gpu.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
