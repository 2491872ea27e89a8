"""One run of one cell of the benchmark of ``connect4_tpu_torch``.

    python3 -m c4bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``c4bench/`` and
the program. Everything is found by the names in ``BENCHMARK.json``: the
cell's configuration file, its traffic mix ``c4bench/traffic/<traffic>.json``
(whose ``kind`` names the driver, ``c4bench/kinds/<kind>.py``), its limits
``c4bench/limits/<cell>.json``, each per-layer metric's reader
``c4bench/metrics/<metric>.py``, and the architecture that the
configuration's ``net`` names under ``"arch"`` (``"oinkoink-resnet"`` where
it names none): its plain reference and operation counts
``c4bench/reference/archs/<arch>.py`` and the builder of the program's net
``c4bench/builders/<arch>.py``. So a later cell, with a new configuration,
architecture, traffic mix or metric, is new files and new entries in
``BENCHMARK.json`` alone, and edits no file of the harness.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled part of the same
window. Every run judges what its window produced against the plain
reference (``c4bench/reference``) and prints each compared number beside its
limit, on standard error last and under ``checks`` in the result, which is
the last line of standard output. Needs CUDA: without a card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits with 2 or 3.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from c4bench import plugins  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "c4bench")
# module names that must not be loaded, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "connect4_tpu")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_parts(bench: dict, workload: str):
    """``(cell, configuration, traffic, limits)`` of ``workload``; exits
    where the configuration's architecture has no files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"c4bench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(ROOT, config["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{workload}.json"))
    from c4bench import builders
    from c4bench.reference import net as ref_net

    ref_net.arch(cfg["net"])
    builders.find(cfg["net"])
    return cell, cfg, traffic, limits


def reader(name: str):
    """The ``read`` function of the per-layer metric ``name``."""
    return plugins.load(os.path.join(HERE, "metrics", f"{name}.py"), f"reader of metric {name!r}").read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(out: dict, limits: dict):
    """``(correct, failed, checks)``: every exact count must be 0 and every
    gap at most its limit; a compared number the limits do not name fails."""
    checks, failed = {}, 0
    for name, value in out["exact"].items():
        checks[name] = {"value": float(value), "limit": 0.0}
        failed += int(value)
    for name, value in out["gaps"].items():
        if name not in limits:
            if name.rsplit("_", 1)[-1] in ("fp8", "half", "still"):
                continue  # a control's reading, for the record only
            raise SystemExit(f"c4bench: no limit for {name}")
        checks[name] = {"value": float(value), "limit": float(limits[name])}
        failed += int(not value <= limits[name])
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, failed, checks


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one run of one cell of the benchmark")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # the program's kernel builds go to build/ in the checkout; a Triton cache
    # would go beside them, at a fixed path
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    bench = manifest()
    cell, cfg, traffic, limits = cell_parts(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"c4bench: {args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    kind = importlib.import_module(f"c4bench.kinds.{traffic['kind']}")
    log(f"c4bench: {args.workload} on {torch.cuda.get_device_name(0)} ({card()}); torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; seed {args.seed}, {args.seconds} s, trace {args.trace}")
    out = kind.run(cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)

    found = forbidden_modules()
    if found:
        log(f"c4bench: loaded in this process after the window: {', '.join(found)}")
        return 3
    parts = ", ".join(f"{k} {v:.3f}" for k, v in out["setup_parts"].items())
    log(f"c4bench: setup_s {out['setup_s']:.3f} = {parts} (the rest: the program's own set-up)")
    log(f"c4bench: window {out['window_s']:.3f} s; counts {json.dumps(out['counts'])}")

    workload = args.workload
    metrics = {}
    if args.trace:
        seg = out["trace"]
        for m in bench["per_layer"]:
            if applies(m, workload):
                value = reader(m["name"])(seg)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {}
    if args.trace:
        device.update(busy_s=out["trace"]["busy_s"], window_s=out["trace"]["window_s"])
        result["breakdown"] = {"device_ops": out["trace"]["device_ops"], "idle_gaps": out["trace"]["idle_gaps"]}
    correct, failed, checks = judge(out, limits)
    result = {"correct": correct, "attempted": int(out["attempted"]), "failed": failed, "metrics": metrics,
              "device": device, **result, "checks": checks}
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
