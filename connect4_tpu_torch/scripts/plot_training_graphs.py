"""Render the learning curves of a run: ``8ply.png``, ``7ply.png`` and
``match_results.png`` from the metric tables a training run writes.

The counterpart of the JAX package's ``scripts/plot_training_graphs.py``,
on the port's JSON tables (``training.tables``) through
``training.plots.render``. Without matplotlib it draws nothing and exits
non-zero, saying so.

    python -m connect4_tpu_torch.scripts.plot_training_graphs SAVE_DIR
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("save_dir")
    args = parser.parse_args(argv)

    from connect4_tpu_torch.training.plots import render

    try:
        render(args.save_dir)
    except ImportError as exc:
        raise SystemExit(f"plot_training_graphs: {exc}") from exc
    written = sorted(f for f in os.listdir(args.save_dir) if f.endswith(".png"))
    print(json.dumps({"save_dir": args.save_dir, "png": written}))
    return written


if __name__ == "__main__":
    main()
