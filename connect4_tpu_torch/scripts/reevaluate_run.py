"""Re-evaluate a run's per-generation checkpoints on the benchmark sets.

The counterpart of the JAX package's ``scripts/reevaluate_run.py``: for
every generation checkpoint under the run's ``save_dir`` (every
``--stride``-th, and the last), the evaluation the training loop runs after
each generation (``training.loop.value_stats`` on the 8-ply set,
``combined_stats`` on the 7-ply set: the same batches, the same
statistics), written as the tables ``8ply`` and ``7ply`` (JSON, one row a
generation with its ``generation``) in ``--out``, then the learning curves
drawn there. A set that is only partly solved is refused unless
``--allow-partial``, which evaluates its solved rows.

    python -m connect4_tpu_torch.scripts.reevaluate_run -c connect4_tpu_torch/examples/config_r3_k8.py \\
        --out DIR [--data-dir DIR] [--allow-partial] [--stride 1] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import np_load_retry, resolve_device


def load_set(data_dir: str, name: str, with_policy: bool, allow_partial: bool):
    """``(planes, values, policies or None, n_solved, n_total)`` of the
    solved rows of ``<data_dir>/<name>``, or None when it is absent."""
    path = os.path.join(data_dir, name)
    if not os.path.exists(path):
        return None
    with np_load_retry(path) as d:
        planes, values = d["planes"], d["values"]
        policies = d["policies"] if with_policy else None
        solved = d["solved"] if "solved" in d else np.ones(len(values), bool)
    n_solved, n_total = int(solved.sum()), len(values)
    if n_solved < n_total:
        if not allow_partial:
            raise SystemExit(
                f"{name} is partially built ({n_solved}/{n_total}); full-set re-evaluation needs the "
                f"completed dataset (pass --allow-partial to evaluate the subset anyway)"
            )
        print(f"WARNING: {name} subset {n_solved}/{n_total} — results are NOT comparable to "
              f"full-set numbers", flush=True)
    return (planes[solved], values[solved], None if policies is None else policies[solved],
            n_solved, n_total)


def reevaluate(save_dir: str, data_dir: str, out: str, allow_partial: bool = False, stride: int = 1,
               device="cuda") -> dict:
    """Evaluate the checkpoints, write the tables and the curves to
    ``out``; returns the rows."""
    from connect4_tpu_torch.training import checkpoint as ckpt
    from connect4_tpu_torch.training.learner import make_eval_fn
    from connect4_tpu_torch.training.loop import combined_stats, value_stats
    from connect4_tpu_torch.training.tables import save_table

    dev = resolve_device(device)
    gens = ckpt.checkpoint_generations(save_dir)
    if not gens:
        raise SystemExit(f"no generation checkpoints under {save_dir}")
    gens = [g for g in gens if g % stride == 0 or g == gens[-1]]
    set8 = load_set(data_dir, "connect4dataset_8ply.npz", False, allow_partial)
    set7 = load_set(data_dir, "connect4dataset_7ply.npz", True, allow_partial)
    if set8 is None and set7 is None:
        raise SystemExit(f"no benchmark npz files in {data_dir}")

    os.makedirs(out, exist_ok=True)
    rows8, rows7 = [], []
    for gen in gens:
        state, _ = ckpt.restore_checkpoint(save_dir, gen, device=dev)
        forward = make_eval_fn(state.net)
        if set8 is not None:
            stats = value_stats(forward, set8[0], set8[1], dev)
            rows8.append({**stats.to_dict(), "generation": gen})
            print(f"gen {gen}: 8ply MSE {stats.loss:.4f} acc {stats.accuracy:.4f}", flush=True)
        if set7 is not None:
            stats = combined_stats(forward, set7[0], set7[1], set7[2], dev)
            rows7.append({**stats.to_dict(), "generation": gen})
            print(f"gen {gen}: 7ply MSE {stats.value_stats.loss:.4f} "
                  f"weak-move acc {stats.prior_stats.accuracy:.4f}", flush=True)
    if rows8:
        save_table(out, "8ply", rows8)
    if rows7:
        save_table(out, "7ply", rows7)
    curves = draw_curves(out)
    print(f"re-evaluated {len(gens)} generations -> {out}", flush=True)
    return {"device": _common.device_name(dev), "generations": gens, "8ply": rows8, "7ply": rows7,
            "curves": curves,
            "sets": {name: None if s is None else [s[3], s[4]] for name, s in (("8ply", set8), ("7ply", set7))}}


def draw_curves(save_dir: str) -> Optional[bool]:
    """Render the curves of ``save_dir``'s tables; without matplotlib print
    one line saying that none were drawn and return False."""
    from connect4_tpu_torch.training.plots import render

    try:
        render(save_dir)
    except ImportError as exc:
        print(f"no curves drawn: {exc}", flush=True)
        return False
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-c", "--config", required=True,
                        help="the run's Python config file (for save_dir and data_dir)")
    parser.add_argument("--data-dir", default=None,
                        help="benchmark npz dir (default: the config's, the packaged sets unless it says otherwise)")
    parser.add_argument("--out", required=True, help="output dir for the re-evaluated tables and curves")
    parser.add_argument("--allow-partial", action="store_true",
                        help="evaluate on the solved subset when the sets are still incomplete")
    parser.add_argument("--stride", type=int, default=1, help="evaluate every Nth generation (default: all)")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    from connect4_tpu_torch.config import load_config_file

    dev = resolve_device(args.device)
    config = load_config_file(args.config)
    r = reevaluate(config.storage_config.save_dir, args.data_dir or config.storage_config.data_dir,
                   args.out, args.allow_partial, args.stride, dev)
    _common.emit({"device": r["device"], "generations": r["generations"], "out": args.out,
                  "curves": r["curves"], "sets": r["sets"]})
    return r


if __name__ == "__main__":
    main()
