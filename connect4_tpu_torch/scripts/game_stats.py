"""First-move histogram, results and game lengths of a generation.

The counterpart of the JAX package's ``scripts/game_stats.py``, on the
``games.npz`` that either package writes.

    python -m connect4_tpu_torch.scripts.game_stats SAVE_DIR/GEN/games.npz
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def game_stats(path: str) -> dict:
    with np.load(path) as d:
        moves, result, length = d["moves"], d["result"], d["length"]
    return {
        "games": int(len(moves)),
        "first_moves": np.bincount(moves[:, 0], minlength=7).tolist(),
        "o_wins": int((result == 1).sum()), "draws": int((result == 3).sum()),
        "x_wins": int((result == 2).sum()),
        "length_mean": float(length.mean()), "length_min": int(length.min()),
        "length_max": int(length.max()),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path")
    args = parser.parse_args(argv)
    s = game_stats(args.path)
    print("games:", s["games"])
    print("first-move histogram:", s["first_moves"])
    print("results: o wins {}, draws {}, x wins {}".format(s["o_wins"], s["draws"], s["x_wins"]))
    print("game length: mean {:.1f} min {} max {}".format(s["length_mean"], s["length_min"], s["length_max"]))
    print(json.dumps(s))
    return s


if __name__ == "__main__":
    main()
