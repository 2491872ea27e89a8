"""Time edited copies of the tower kernel's source against the tree's layer kernel.

Builds each given copy of ``connect4_tpu_torch/models/csrc/tower.cu`` (all
at once, one ``nvcc`` each) beside the tree's own, prints each build's
ptxas summary for the layer kernel (registers, spills), holds each copy's
layer kernel to the tree's bit for bit on fresh full-depth nets (fc 6, res
6) at every width of ``--filters`` (B=64), and times them in turns (the
tree's first, then each copy, then the same in reverse; CUDA events, 20
launches after 3 warm-ups) at every width and batch. A copy must keep the
layer kernel's C interface and weight layout (``tower.layer_image``).
A cluster size other than the shipped one, for example, is an edited copy:

    sed 's/constexpr int kCluster = 2;/constexpr int kCluster = 1;/' \
        connect4_tpu_torch/models/csrc/tower.cu > build/variants/cluster1.cu

Needs a CUDA card (sm_90a) and nvcc. The numbers also go to
``chiprun_out/time_layer_variants.json``.

    python3 scripts/time_layer_variants_gpu.py build/variants/a.cu build/variants/b.cu
        [--filters 320 512 1024] [--batches 4096 2048 512]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="+")
    parser.add_argument("--filters", type=int, nargs="+", default=[320, 512, 1024])
    parser.add_argument("--batches", type=int, nargs="+", default=[4096, 2048, 512])
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_layer_variants_gpu: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import timed_ms
    from connect4_tpu_torch import build
    from connect4_tpu_torch.config import NetConfig
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.net import fold_bn_params, init_net
    from scripts.check_tower_gpu import ptxas_summary

    dev = torch.device("cuda")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(smi, flush=True)
    sources = [tower.SOURCE] + [os.path.abspath(p) for p in args.sources]
    names = ["tree"] + [os.path.basename(p) for p in args.sources]
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    libs = [build.load_library(src) for src in sources]
    for lib in libs:
        lib.c4_tower_layer.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.c4_tower_layer.restype = ctypes.c_int
    report = {"nvidia_smi": smi, "variants": names, "ptxas": {}, "equal": {}, "time": []}
    for name, src in zip(names, sources):
        rows = [r for r in ptxas_summary(build.BUILD_LOGS.get(src, "")) if r[0].startswith("tower_layer")]
        report["ptxas"][name] = rows
        print(f"[ptxas] {name}: " + "; ".join(f"{k} {r} registers, spills {s}/{l} B" for k, r, s, l in rows))

    def run(lib, packed, x2d):
        out = torch.empty((x2d.shape[0], packed["conv1_w"].shape[1]), dtype=torch.bfloat16, device=dev)
        tower._tower_layers(lib, packed, x2d, out, torch.cuda.current_stream().cuda_stream)
        return out

    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for f in args.filters:
            config = NetConfig(filters=f, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16")
            packed = tower.pack_weights(config, fold_bn_params(
                init_net(config, torch.Generator().manual_seed(f), device=dev)))
            x2d = (torch.rand((64 * 42, 3), generator=gen, device=dev) < 0.25).float()
            want = run(libs[0], packed, x2d)
            for name, lib in zip(names[1:], libs[1:]):
                same = bool(torch.equal(run(lib, packed, x2d), want))
                report["equal"][f"{name} F={f}"] = same
                print(f"[equal] {name} F={f} B=64: the tree's bits {same}", flush=True)
            for b in args.batches:
                x2d = (torch.rand((b * 42, 3), generator=gen, device=dev) < 0.25).float()
                order = list(range(len(libs))) + list(reversed(range(len(libs))))
                ms = {name: [] for name in names}
                for i in order:
                    ms[names[i]].append(timed_ms(lambda: run(libs[i], packed, x2d)))
                bound_ms = tower.tower_bound(config, b)[0]
                report["time"].append({"filters": f, "boards": b, "bound_ms": bound_ms, "ms": ms})
                print(f"[time] F={f} B={b} (bound {bound_ms:.4f} ms): "
                      + ", ".join(f"{n} {v[0]:.4f} / {v[1]:.4f} ms" for n, v in ms.items()), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "time_layer_variants.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return 0 if all(report["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
