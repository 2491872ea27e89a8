"""Time edited copies of the tower kernel's source against the tree's kernel.

Builds each given copy of ``connect4_tpu_torch/models/csrc/tower.cu`` (all
at once, one ``nvcc`` each) beside the tree's own, prints each build's
ptxas summary for the kernel under test (registers, spills), holds each
copy's kernel to the tree's bit for bit on fresh full-depth nets (fc 6, res
6) at every width of ``--filters`` (at ``EQUAL_BOARDS``), and times them in
turns (the tree's first, then each copy, then the same in reverse; CUDA
events, 20 launches after 3 warm-ups) at every width and batch, ``--turns``
times over. Beside each time it prints the SM clock (MHz) and power (W)
that ``nvidia-smi`` sampled, every 50 ms, while it ran (the mean of the
samples in its window, or the nearest sample), since a card under a power
limit slows its clock under load.

``--kernel layer`` (the default) tests the layer kernel ``tower_layer``
(widths above 256); a copy must keep its C interface and weight layout
(``tower.layer_image``). ``--kernel wide`` tests the fused kernel at 128
and 256 filters (``tower_kernel_wide``, through ``c4_tower_forward``); a
copy must keep that interface and the ``smem_image`` layout. A copy that
computes something else on purpose (the products switched off, to time the
copy pipeline alone) is timed all the same; its ``[equal]`` line says
False and the script exits 1. A cluster size other than the shipped one,
for example, is an edited copy:

    sed 's/constexpr int kCluster = 2;/constexpr int kCluster = 1;/' \
        connect4_tpu_torch/models/csrc/tower.cu > build/variants/cluster1.cu

Needs a CUDA card (sm_90a) and nvcc. The numbers also go to
``chiprun_out/time_layer_variants.json`` (``time_wide_variants.json`` with
``--kernel wide``).

    python3 scripts/time_layer_variants_gpu.py build/variants/a.cu build/variants/b.cu
        [--kernel layer|wide] [--filters 320 512 1024] [--batches 4096 2048 512] [--turns 1]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import datetime
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# batches each copy is held to the tree's bits at: at 3 boards a block, 64
# boards are 22 blocks (a whole number of clusters of two), 49 are 17 (the
# last cluster holds a pad block)
EQUAL_BOARDS = (64, 49)
KERNELS = {  # --kernel: (the ptxas name's prefix, default widths)
    "layer": ("tower_layer", (320, 512, 1024)),
    "wide": ("tower_kernel_wide", (128, 256)),
}


@contextlib.contextmanager
def smi_sampling(path: str):
    """``nvidia-smi`` logs the SM clock and power every 50 ms to ``path``
    while the block runs."""
    with open(path, "w") as out:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=out, stderr=subprocess.DEVNULL)
        try:
            yield
        finally:
            proc.terminate()
            proc.wait()


def smi_samples(path: str) -> list:
    """``[(time, SM MHz, W)]`` from the log of ``nvidia-smi --query-gpu=
    timestamp,clocks.sm,power.draw --format=csv,noheader,nounits -lms``."""
    out = []
    with open(path) as fh:
        for line in fh:
            parts = [p.strip() for p in line.split(",")]
            try:
                out.append((datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f"),
                            float(parts[1]), float(parts[2])))
            except (ValueError, IndexError):
                continue
    return out


def window_clock(samples: list, t0, t1):
    """Mean SM clock and power of the samples taken from ``t0`` to ``t1``,
    or of the sample nearest the window's middle."""
    inside = [(c, w) for t, c, w in samples if t0 <= t <= t1]
    if not inside and samples:
        mid = t0 + (t1 - t0) / 2
        inside = [min(samples, key=lambda s: abs((s[0] - mid).total_seconds()))[1:]]
    if not inside:
        return None, None
    return sum(c for c, _ in inside) / len(inside), sum(w for _, w in inside) / len(inside)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="+")
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="layer")
    parser.add_argument("--filters", type=int, nargs="+")
    parser.add_argument("--batches", type=int, nargs="+", default=[4096, 2048, 512])
    parser.add_argument("--turns", type=int, default=1)
    args = parser.parse_args(argv)
    prefix, default_filters = KERNELS[args.kernel]
    filters = args.filters or list(default_filters)

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
        lib.c4_tower_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.c4_tower_layer.restype = lib.c4_tower_forward.restype = ctypes.c_int
    report = {"nvidia_smi": smi, "kernel": args.kernel, "variants": names, "ptxas": {}, "equal": {}, "time": []}
    for name, src in zip(names, sources):
        rows = [r for r in ptxas_summary(build.BUILD_LOGS.get(src, "")) if r[0].startswith(prefix)]
        report["ptxas"][name] = rows
        print(f"[ptxas] {name}: " + "; ".join(f"{k} {r} registers, spills {s}/{l} B" for k, r, s, l in rows))

    def run(lib, packed, x2d):
        out = torch.empty((x2d.shape[0], packed["conv1_w"].shape[1]), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if args.kernel == "layer":
            tower._tower_layers(lib, packed, x2d, out, stream)
            return out
        err = lib.c4_tower_forward(
            x2d.data_ptr(), packed["conv1_img"].data_ptr(), packed["conv1_b"].data_ptr(),
            packed["res_img"].data_ptr(), packed["res_b"].data_ptr(), out.data_ptr(),
            x2d.shape[0] // 42, x2d.shape[1], out.shape[1], packed["res_img"].shape[0], stream)
        if err != 0:
            raise RuntimeError(f"tower kernel launch failed with cudaError {err}")
        return out

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    smi_log = os.path.join(ROOT, "chiprun_out", f"time_{args.kernel}_variants_smi.csv")
    windows = []  # (index of the report's time entry, variant, start, end)
    gen = torch.Generator(device=dev).manual_seed(0)
    with smi_sampling(smi_log), torch.no_grad():
        for f in filters:
            config = NetConfig(filters=f, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16")
            packed = tower.pack_weights(config, fold_bn_params(
                init_net(config, torch.Generator().manual_seed(f), device=dev)))
            for b in EQUAL_BOARDS:
                x2d = (torch.rand((b * 42, 3), generator=gen, device=dev) < 0.25).float()
                want = run(libs[0], packed, x2d)
                for name, lib in zip(names[1:], libs[1:]):
                    same = bool(torch.equal(run(lib, packed, x2d), want))
                    report["equal"][f"{name} F={f} B={b}"] = same
                    print(f"[equal] {name} F={f} B={b}: the tree's bits {same}", flush=True)
            for b in args.batches:
                x2d = (torch.rand((b * 42, 3), generator=gen, device=dev) < 0.25).float()
                order = (list(range(len(libs))) + list(reversed(range(len(libs))))) * args.turns
                ms = {name: [] for name in names}
                for i in order:
                    t0 = datetime.datetime.now()
                    ms[names[i]].append(timed_ms(lambda: run(libs[i], packed, x2d)))
                    windows.append((len(report["time"]), names[i], t0, datetime.datetime.now()))
                bound_ms = tower.tower_bound(config, b)[0]
                report["time"].append({"filters": f, "boards": b, "bound_ms": bound_ms, "ms": ms})
    samples = smi_samples(smi_log)
    for k, entry in enumerate(report["time"]):
        entry["clock_mhz"] = {n: [] for n in entry["ms"]}
        entry["power_w"] = {n: [] for n in entry["ms"]}
        for at, name, t0, t1 in windows:
            if at == k:
                clock, power = window_clock(samples, t0, t1)
                entry["clock_mhz"][name].append(clock)
                entry["power_w"][name].append(power)
        print(f"[time] F={entry['filters']} B={entry['boards']} (bound {entry['bound_ms']:.4f} ms): " + ", ".join(
            f"{n} " + " / ".join(
                f"{t:.4f}" + (f" ({c:.0f} MHz, {w:.0f} W)" if c is not None else "")
                for t, c, w in zip(v, entry["clock_mhz"][n], entry["power_w"][n])) + " ms"
            for n, v in entry["ms"].items()), flush=True)
    out_name = "time_layer_variants.json" if args.kernel == "layer" else "time_wide_variants.json"
    with open(os.path.join(ROOT, "chiprun_out", out_name), "w") as fh:
        json.dump(report, fh, indent=1)
    return 0 if all(report["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
