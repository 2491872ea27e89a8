"""Package a training run's generation as an example net, with its curves.

The counterpart of the JAX package's ``scripts/ship_run_artifacts.py``,
which ships a run the way the reference ships its product: a playable
trained net plus the learning-curve history. Here:

- ``<dest>/example_net/example_net_<gen>.npz``: the chosen generation's net
  in the layout ``models.convert.read_example_net`` reads (the packaged
  gen-161's), so ``load_example_net(path)`` plays it, plus
  ``net_config.json``;
- ``<dest>/example_run/``: the metric tables (``8ply``, ``7ply``,
  ``match_results``, JSON), their curves drawn anew (one line says so when
  matplotlib is missing), the run's config file, the training log when
  given, and ``PACKAGED.json``.

It writes only under ``--dest``, so the net ``cli game`` loads by default
stays the packaged one. Run it while training is live to snapshot progress
(checkpoints are written whole, one a generation), and again at the end.
Like the JAX tool it needs no card: the checkpoint is restored to the CPU.

    python -m connect4_tpu_torch.scripts.ship_run_artifacts -c CONFIG --dest DIR \\
        [--gen N] [--log train.log]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
from typing import Optional

from connect4_tpu_torch.scripts import _common

TABLES = ("8ply", "7ply", "match_results")


def ship(config_path: str, dest: str, gen: Optional[int] = None, log: Optional[str] = None) -> dict:
    from connect4_tpu_torch.config import load_config_file
    from connect4_tpu_torch.models.convert import write_example_net
    from connect4_tpu_torch.scripts.reevaluate_run import draw_curves
    from connect4_tpu_torch.training import checkpoint as ckpt
    from connect4_tpu_torch.training.tables import load_table, save_table

    config = load_config_file(config_path)
    run_dir = config.storage_config.save_dir
    gen = gen if gen is not None else ckpt.latest_generation(run_dir)
    if gen is None:
        raise SystemExit(f"no checkpoints under {run_dir}")
    state, _ = ckpt.restore_checkpoint(run_dir, gen, device="cpu")
    dest = os.path.abspath(dest)

    net_dir = os.path.join(dest, "example_net")
    if os.path.isdir(net_dir):  # exactly one generation is packaged
        shutil.rmtree(net_dir)
    npz = write_example_net(os.path.join(net_dir, f"example_net_{gen}.npz"), state.net, gen)
    with open(os.path.join(net_dir, "net_config.json"), "w") as fh:
        json.dump(dataclasses.asdict(state.net.config), fh, indent=2)
    print(f"packaged generation {gen} -> {npz}")

    run_out = os.path.join(dest, "example_run")
    os.makedirs(run_out, exist_ok=True)
    copied = []
    for name in TABLES:
        rows = load_table(run_dir, name)
        if rows:
            save_table(run_out, name, rows)
            copied.append(f"{name}.json")
    shutil.copy2(config_path, os.path.join(run_out, "config.py"))
    copied.append("config.py")
    if log and os.path.exists(log):
        shutil.copy2(log, os.path.join(run_out, "train.log"))
        copied.append("train.log")
    with open(os.path.join(run_out, "PACKAGED.json"), "w") as fh:
        json.dump({"generation": gen, "run_dir": run_dir, "npz": os.path.basename(npz)}, fh, indent=2)
    print(f"copied {', '.join(copied)} -> {run_out}")
    curves = draw_curves(run_out)
    return {"generation": gen, "npz": npz, "run_out": run_out,
            "copied": copied, "curves": curves}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-c", "--config", required=True, help="the run's Python config file")
    parser.add_argument("--dest", required=True, help="destination directory")
    parser.add_argument("--gen", type=int, default=None, help="generation to package (default: latest)")
    parser.add_argument("--log", default=None, help="training log file to include")
    args = parser.parse_args(argv)
    r = ship(args.config, args.dest, args.gen, args.log)
    _common.emit(r)
    return r


if __name__ == "__main__":
    main()
