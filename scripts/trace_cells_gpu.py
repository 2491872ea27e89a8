"""A cell of the benchmark with the program's tracing on: the card's time by
span and the search's evaluations by class.

    python scripts/trace_cells_gpu.py --workload f64-selfplay [--seed 1] [--seconds 51] [--cost]

It runs the cell's own driver (``c4bench/kinds/<kind>.py``, as
``python3 -m c4bench.run --trace 1`` runs it) with
``connect4_tpu_torch.launches.tracing`` on before the driver builds the
program, the counters reset where the driver's profiled segment starts and
read where it stops, and the segment's events read by
``connect4_tpu_torch.scripts._common.span_times``. It prints the span
table, the evaluations by class, the hand kernels' launch counters over the
segment (``LAUNCH_COUNTERS``: the tower's forwards and its squeeze-and-
excitation gates, the learner's fused BatchNorm pair and its gate calls, each
counted at every replay of a graph), what the spans give the cell (a self-play
iteration's phases and the eager work a wave, a training step's parts and
how long the card waited on the learner's host; the card's busy time that
the spans hold), whether the run's outputs passed the cell's limits, and
one JSON line. With ``--cost`` it first runs the cell untraced four times
with the same seed, tracing off, on, on and off, and gives each end-to-end
rate: what the marks and counters cost. Needs a CUDA card; imports no JAX.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the spans whose card time is a wave's eager work
EAGER = ("search.init", "search.finish", "selfplay.record_refill", "selfplay.compact")
# the launch counters read over the segment: (printed name, module, function, attribute)
LAUNCH_COUNTERS = (
    ("run_tower.launches", "connect4_tpu_torch.models.tower", "run_tower", "launches"),
    ("run_tower.se_blocks", "connect4_tpu_torch.models.tower", "run_tower", "se_blocks"),
    ("batch_norm_act.launches", "connect4_tpu_torch.models.batch_norm", "batch_norm_act", "launches"),
    ("batch_norm_act.backward_launches", "connect4_tpu_torch.models.batch_norm", "batch_norm_act",
     "backward_launches"),
    ("se_gate.launches", "connect4_tpu_torch.models.se_gate", "se_gate", "launches"),
    ("se_gate.backward_launches", "connect4_tpu_torch.models.se_gate", "se_gate", "backward_launches"),
)


def launch_counts() -> dict:
    """The values of ``LAUNCH_COUNTERS`` now."""
    return {name: getattr(getattr(importlib.import_module(mod), fn), attr) for name, mod, fn, attr in LAUNCH_COUNTERS}


def chrome_events(events):
    """The raw events of a ``c4bench.trace.Segment`` as the complete events
    of a Chrome trace, as far as ``span_times`` reads them."""
    import torch

    out = []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue  # a host range's span on the card
            cat = "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
            args = {"stream": e.device_resource_id(), "correlation": e.correlation_id()}
        elif e.is_user_annotation():
            cat, args = "user_annotation", {}
        elif name.startswith("cu"):
            cat, args = "cuda_runtime", {"correlation": e.correlation_id()}
        else:
            continue
        out.append({"ph": "X", "cat": cat, "name": name, "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3,
                    "tid": e.start_thread_id(), "args": args})
    return out


def figures(kind: str, seg: dict, times: dict, evals) -> dict:
    """What the spans and counters give the cell, in ms a unit of its work
    and in percent."""
    from connect4_tpu_torch.launches import LEARNER_PARTS, SEARCH_PHASES

    spans = times["spans"]
    out = {"in_spans_pct": 100.0 * times["attributed_ms"] / times["busy_ms"]}
    if kind == "selfplay":
        iterations = spans["search.descend"]["calls"]
        out.update({f"{n.split('.')[1]}_ms": spans[n]["marked_ms"] / iterations for n in SEARCH_PHASES})
        out["eager_ms"] = sum(spans[n]["busy_ms"] for n in EAGER) / seg["waves"]
        out["useful_eval_pct"] = 100.0 * evals["useful"] / sum(evals.values())
    else:
        steps = spans["learner.step"]["calls"]
        out.update({f"{n.split('.')[1]}_ms": spans[n]["busy_ms"] / steps for n in LEARNER_PARTS[1:]})
        out["learner_wait_ms"] = spans["learner.step"]["wait_ms"] / steps
        out["learner_in_spans_pct"] = 100.0 * sum(spans[n]["busy_ms"] for n in LEARNER_PARTS) / times["busy_ms"]
    labelled = sum(v for k, v in seg["idle_gaps"] if k.startswith("host:"))
    unnamed = sum(v for k, v in seg["idle_gaps"] if k.startswith("host: - /"))
    out["idle_unnamed_pct"] = 100.0 * unnamed / labelled if labelled else None
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--cost", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from c4bench import run as c4run
    from c4bench import trace as tr
    from connect4_tpu_torch import launches
    from connect4_tpu_torch.scripts import _common

    if not torch.cuda.is_available():
        raise SystemExit("trace_cells_gpu: needs a CUDA card")
    cell, cfg, traffic, limits = c4run.cell_parts(c4run.manifest(), args.workload)
    kind = importlib.import_module(f"c4bench.kinds.{traffic['kind']}")
    print(f"{args.workload} on {torch.cuda.get_device_name(0)} ({c4run.card()}); torch {torch.__version__}; "
          f"seed {args.seed}, {args.seconds} s", flush=True)

    result = {"workload": args.workload, "card": c4run.card(), "seed": args.seed, "seconds": args.seconds}
    if args.cost:
        rates = []
        for on in (False, True, True, False):
            launches.tracing(on)
            out = kind.run(cfg, traffic, args.seed, args.seconds, False, "cuda:0", time.perf_counter())
            (metric, rate), = out["e2e"].items()
            rates.append({"tracing": on, metric: rate, "setup_s": out["setup_s"]})
            print(f"untraced run, tracing {'on ' if on else 'off'}: {metric} {rate:.1f}, setup {out['setup_s']:.2f} s",
                  flush=True)
        result["cost"] = rates

    caught = {}

    class Segment(tr.Segment):
        def start(self):
            super().start()
            launches.reset_counters()
            caught["counts"] = launch_counts()

        def stop(self):
            events = super().stop()
            caught["counts"] = {k: v - caught["counts"][k] for k, v in launch_counts().items()}
            caught["evals"] = launches.counters().get("evals")
            caught["events"] = events
            return events

    tr.Segment = Segment
    launches.tracing(True)
    out = kind.run(cfg, traffic, args.seed, args.seconds, True, "cuda:0", time.perf_counter())
    correct, _, _ = c4run.judge(out, limits)
    seg = out["trace"]
    events = chrome_events(caught["events"])
    (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == tr.SEGMENT]
    times = _common.span_times(events, (lo, hi))
    print("\n".join(_common.span_table(times)))
    print(f"evaluations by class: {caught['evals']}")
    print(f"launch counters over the segment: {caught['counts']}")
    result.update(correct=correct, e2e=out["e2e"], figures=figures(traffic["kind"], seg, times, caught["evals"]),
                  spans=times, evals=caught["evals"], launch_counts=caught["counts"], idle_gaps=seg["idle_gaps"],
                  window_s=seg["window_s"], busy_s=seg["busy_s"])
    for k, v in result["figures"].items():
        print(f"{k}: {v}")
    print(f"correct: {correct}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
