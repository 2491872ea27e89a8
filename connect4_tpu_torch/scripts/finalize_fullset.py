"""Full-set finalization: re-evaluate a run and check the net's capacity on the completed sets.

The counterpart of the JAX package's ``scripts/finalize_fullset.sh``, as a
module like the other tools. In order:

0. check that both benchmark sets are 100% solved: the 8-ply set's 67,557
   positions and the 7-ply set's 54,131;
1. re-evaluate every checkpoint of the run on the completed sets
   (``reevaluate_run.reevaluate`` with no ``allow_partial``) into ``--out``;
2. (left out) the JAX script's step 2, ``ref_net_draw_check``, loads the
   reference implementation's own checkpoint, which is not in the
   repository;
3. the supervised capacity check on the completed sets
   (``verify_supervised.verify_supervised``, 10 epochs).

It writes only under ``--out``: the JAX script's copy of the re-evaluation
into its package's ``example_run/reeval_liveset`` has no counterpart, and
the port writes nothing into either package. A set that is not complete
stops it before anything is written.

    python -m connect4_tpu_torch.scripts.finalize_fullset --out DIR \\
        [-c connect4_tpu_torch/examples/config_r3_k8_draw.py] [--data-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np

from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import resolve_device

SOLVED = {"connect4dataset_8ply.npz": 67557, "connect4dataset_7ply.npz": 54131}
DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                              "config_r3_k8_draw.py")
SUPERVISED_EPOCHS = 10


def check_solved(data_dir: str, expected: Dict[str, int] = SOLVED) -> Dict[str, int]:
    """The solved count of each set; raises unless it is ``expected``."""
    counts = {}
    for name, total in expected.items():
        with np.load(os.path.join(data_dir, name)) as d:
            counts[name] = int(d["solved"].sum())
        if counts[name] != total:
            raise SystemExit(f"{name}: {counts[name]}/{total} solved - dataset not complete yet")
    print("both datasets 100% solved", flush=True)
    return counts


def finalize(config_path: str, out: str, data_dir: Optional[str] = None, device="cuda",
             expected: Dict[str, int] = SOLVED, supervised: Optional[dict] = None) -> dict:
    """Steps 1 and 3 on the run of ``config_path``; returns both steps'
    results. ``supervised`` passes more arguments to ``verify_supervised``
    (its batch size and net, for a small run)."""
    from connect4_tpu_torch.config import load_config_file
    from connect4_tpu_torch.scripts import reevaluate_run, verify_supervised

    dev = resolve_device(device)
    config = load_config_file(config_path)
    data_dir = data_dir or config.storage_config.data_dir
    solved = check_solved(data_dir, expected)
    print("=== 1/3 reevaluate_run (full sets) ===", flush=True)
    reeval = reevaluate_run.reevaluate(config.storage_config.save_dir, data_dir, out, device=dev)
    print("=== 2/3 ref_net_draw_check: left out (the reference's checkpoint is not in the repository) ===")
    print("=== 3/3 verify_supervised (full sets) ===", flush=True)
    sup = verify_supervised.verify_supervised(data_dir, epochs=SUPERVISED_EPOCHS, device=dev, **(supervised or {}))
    print("ALL DONE", flush=True)
    return {"device": _common.device_name(dev), "solved": solved, "out": out, "reevaluate_run": reeval,
            "verify_supervised": sup}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-c", "--config", default=DEFAULT_CONFIG,
                        help="the run's Python config file (for save_dir and data_dir)")
    parser.add_argument("--data-dir", default=None,
                        help="benchmark npz dir (default: the config's, the packaged sets unless it says otherwise)")
    parser.add_argument("--out", required=True, help="output dir for the re-evaluated tables and curves")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    r = finalize(args.config, args.out, args.data_dir, args.device)
    sup = r["verify_supervised"]
    _common.emit({"device": r["device"], "solved": r["solved"], "out": r["out"],
                  "generations": r["reevaluate_run"]["generations"], "curves": r["reevaluate_run"]["curves"],
                  "supervised": [{k: v for k, v in e.items() if k != "losses"} for e in sup["epochs"]]})
    return r


if __name__ == "__main__":
    main()
