"""The readings a cell's limits are set from, many seeds in one process.

    python3 -m c4bench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed this runs the cell as ``c4bench.run`` does (set-up, a window
of ``--seconds``, the judgement) and also reads the control: the reference
computed in float8 e4m3 put in the program's place on the same trees or the
same three steps, and for training the reference with half of each batch
left out and the mean taken over the rest. One JSON line a seed, with the
program's readings and the control's; nothing is judged against a limit.
The benchmark's own runs never run this. Needs CUDA.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from c4bench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("c4bench.control: needs CUDA", file=sys.stderr)
        return 2
    cell, cfg, traffic, limits = bench_run.cell_parts(bench_run.manifest(), args.workload)
    kind = importlib.import_module(f"c4bench.kinds.{traffic['kind']}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = kind.run(cfg, traffic, seed, args.seconds, False, "cuda:0", t0, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "gaps": out["gaps"], "diag": out["diag"], "exact": out["exact"],
                          "e2e": out["e2e"], "setup_s": out["setup_s"], "setup_parts": out["setup_parts"], "counts": out["counts"],
                          "limits": limits, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
