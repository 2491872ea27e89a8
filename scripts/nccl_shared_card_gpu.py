"""What NCCL does when two ranks name the same card.

    python3 scripts/nccl_shared_card_gpu.py

Spawns two processes that join one NCCL group on ``cuda:0`` and all-reduce
one tensor, then two that do the same through gloo. Prints, per backend,
each rank's outcome (the sum, or the error) as one JSON line. A rank still
running after 120 s is killed and reported as hung. This is why
``parallel.mesh`` names gloo for several ranks on one card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank(rank, backend, init_file, out_file):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from connect4_tpu_torch.parallel import mesh as pmesh

    try:
        pmesh.initialize_distributed(backend, "cuda:0", init_method=f"file://{init_file}", rank=rank,
                                     world_size=2)
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        result = {"sum": t.tolist()}
    except Exception as exc:  # the outcome is what this script reports
        result = {"error": f"{type(exc).__name__}: {exc}"[:600]}
    with open(f"{out_file}.{rank}", "w") as fh:
        json.dump(result, fh)
    if dist.is_initialized():
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as tmp

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    report = {}
    for backend in ("nccl", "gloo"):
        with tempfile.TemporaryDirectory() as d:
            ctx = tmp.spawn(_rank, args=(backend, os.path.join(d, "init"), os.path.join(d, "out")),
                            nprocs=2, join=False, start_method="spawn")
            deadline = time.monotonic() + 120
            try:
                while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                    if time.monotonic() >= deadline:
                        for p in ctx.processes:
                            p.kill()
                        break
            except Exception as exc:  # a rank that died is an outcome too
                report[f"{backend}_exit"] = f"{type(exc).__name__}: {exc}"[:600]
            outcome = []
            for r in range(2):
                path = os.path.join(d, f"out.{r}")
                if os.path.exists(path):
                    with open(path) as fh:
                        outcome.append(json.load(fh))
                else:
                    outcome.append({"error": "hung or died before reporting"})
            report[backend] = outcome
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
