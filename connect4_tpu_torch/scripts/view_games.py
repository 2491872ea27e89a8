"""Pretty-print a recorded self-play game from a generation's ``games.npz``.

The counterpart of the JAX package's ``scripts/view_games.py``: board by
board, each move with its value and policy target
(``training.replay.game_str``), then the result.

    python -m connect4_tpu_torch.scripts.view_games SAVE_DIR/GEN/games.npz [GAME_INDEX]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def view_game(path: str, index: int = 0) -> str:
    from connect4_tpu_torch.training.replay import game_str
    from connect4_tpu_torch.types import Result

    with np.load(path) as d:
        text = game_str(d["moves"][index], d["move_values"][index], d["policies"][index],
                        d["length"][index])
        result = Result.from_code(int(d["result"][index]))
    return f"{text}\nResult: {result}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path")
    parser.add_argument("index", type=int, nargs="?", default=0)
    args = parser.parse_args(argv)
    text = view_game(args.path, args.index)
    print(text)
    print(json.dumps({"path": args.path, "index": args.index, "plies": text.count("Move:"),
                      "result": text.rsplit("Result: ", 1)[1]}))
    return text


if __name__ == "__main__":
    main()
