"""Replay storage: per-generation files + sliding training window.

The counterpart of the JAX package's ``training.replay``, with the same
layout (``save_dir/<gen>/{data,games}.npz``), keys and dtypes, so that
files written by either package load in the other. The training window is
the last ``min(20, (gen + 1) // 2)`` generations, concatenated.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from connect4_tpu_torch.training.self_play import SelfPlayOutput, training_arrays
from connect4_tpu_torch.types import RESULT_VALUE


def _np(x, dtype=None) -> np.ndarray:
    """A record field (a tensor on any device, or an array) as numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def generation_dir(save_dir: str, gen: int) -> str:
    return os.path.join(save_dir, str(gen))


def window_size(gen: int) -> int:
    return min(20, (gen + 1) // 2)


def save_generation(save_dir: str, gen: int, output: SelfPlayOutput) -> int:
    """Write ``<gen>/data.npz`` (augmented training arrays) and
    ``<gen>/games.npz`` (raw per-game records, the ``games.pkl``
    equivalent). Returns the number of training positions written."""
    folder = generation_dir(save_dir, gen)
    os.makedirs(folder, exist_ok=True)

    planes, values, policies = training_arrays(output)
    np.savez_compressed(
        os.path.join(folder, "data.npz"),
        planes=planes,
        values=values,
        policies=policies,
    )
    np.savez_compressed(
        os.path.join(folder, "games.npz"),
        moves=_np(output.moves, np.int8),
        move_values=_np(output.move_values, np.float32),
        policies=_np(output.policies, np.float32),
        mask=_np(output.mask),
        result=_np(output.result, np.int8),
        length=_np(output.length, np.int32),
    )
    return len(values)


def append_generation(save_dir: str, gen: int, outputs) -> int:
    """Like save_generation but concatenates several self-play waves."""
    folder = generation_dir(save_dir, gen)
    os.makedirs(folder, exist_ok=True)

    parts = [training_arrays(o) for o in outputs]
    planes = np.concatenate([p[0] for p in parts])
    values = np.concatenate([p[1] for p in parts])
    policies = np.concatenate([p[2] for p in parts])
    np.savez_compressed(
        os.path.join(folder, "data.npz"),
        planes=planes, values=values, policies=policies,
    )
    np.savez_compressed(
        os.path.join(folder, "games.npz"),
        moves=np.concatenate([_np(o.moves, np.int8) for o in outputs]),
        move_values=np.concatenate([_np(o.move_values, np.float32) for o in outputs]),
        policies=np.concatenate([_np(o.policies, np.float32) for o in outputs]),
        mask=np.concatenate([_np(o.mask) for o in outputs]),
        result=np.concatenate([_np(o.result, np.int8) for o in outputs]),
        length=np.concatenate([_np(o.length, np.int32) for o in outputs]),
    )
    return len(values)


def window_generations(save_dir: str, gen: int) -> list[int]:
    """Generations of the window ending at ``gen`` whose ``data.npz``
    exists, descending. Generations missing from disk are skipped with a
    notice: a run continued from a packaged checkpoint (e.g. the shipped
    example net) has no history before its first new generation, and the
    window simply starts shallower and refills as generations accrue.
    Raises if the window is entirely absent — training on nothing is
    always a caller error."""
    n = window_size(gen)
    present = [
        g
        for g in range(gen, gen - n, -1)
        if os.path.exists(os.path.join(generation_dir(save_dir, g), "data.npz"))
    ]
    if not present:
        raise FileNotFoundError(
            f"no replay data for generations {gen - n + 1}..{gen} under {save_dir}"
        )
    if len(present) < n:
        missing = sorted(set(range(gen - n + 1, gen + 1)) - set(present))
        print(
            f"replay window {gen - n + 1}..{gen}: {len(missing)} generation(s) "
            f"missing from disk ({missing[0]}..{missing[-1]}), training on the "
            f"{len(present)} present",
            flush=True,
        )
    return present


def load_window(
    save_dir: str, gen: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate the replay window ending at ``gen`` (inclusive)."""
    planes, values, policies = [], [], []
    for g in window_generations(save_dir, gen):
        path = os.path.join(generation_dir(save_dir, g), "data.npz")
        with np.load(path) as data:
            planes.append(data["planes"])
            values.append(data["values"])
            policies.append(data["policies"])
    return (
        np.concatenate(planes),
        np.concatenate(values),
        np.concatenate(policies),
    )


def _recover_q(folder: str, z_values: np.ndarray) -> Optional[np.ndarray]:
    """Per-row search values (q) for a generation's ``data.npz`` rows,
    reconstructed from ``games.npz``.

    ``training_arrays`` emits rows as ``[selected, mirrored-duplicates]``
    in ``np.nonzero(mask)`` order, so ``move_values[nonzero(mask)]``
    duplicated twice lines up exactly — *when the generation was written
    in one part*. Alignment is verified by recomputing the z column the
    same way and requiring an exact match against the stored values (a
    multi-part ``append_generation`` interleaves parts and fails this
    check); returns None when q cannot be recovered.
    """
    games_path = os.path.join(folder, "games.npz")
    if not os.path.exists(games_path):
        return None
    with np.load(games_path) as g:
        mask = g["mask"]
        move_values = g["move_values"]
        results = g["result"]
    b_idx, t_idx = np.nonzero(mask)
    if 2 * len(b_idx) != len(z_values):
        return None
    z_check = np.asarray(RESULT_VALUE, dtype=np.float32)[results][b_idx]
    expected = np.concatenate([z_check, z_check])
    if not np.array_equal(expected, z_values):
        return None
    q = move_values[b_idx, t_idx].astype(np.float32)
    return np.concatenate([q, q])


def load_window_ex(
    save_dir: str,
    gen: int,
    value_target_mix: float = 0.0,
    draw_loss_weight: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """``load_window`` plus the draw-bucket training extensions: value
    targets mixed with per-move search values ((1-λ)z + λq) and a
    per-row value-loss weight array (``draw_loss_weight`` on rows from
    drawn games, 1 elsewhere; None when no weighting is requested).

    Generations whose q cannot be recovered (no games.npz, or multi-part
    alignment) fall back to pure-z targets for their rows."""
    planes, values, policies, weights = [], [], [], []
    lam = float(value_target_mix)
    for g in window_generations(save_dir, gen):
        folder = generation_dir(save_dir, g)
        with np.load(os.path.join(folder, "data.npz")) as data:
            planes.append(data["planes"])
            z = data["values"].astype(np.float32)
            policies.append(data["policies"])
        target = z
        if lam > 0.0:
            q = _recover_q(folder, z)
            if q is not None:
                target = (1.0 - lam) * z + lam * q
        values.append(target)
        weights.append(
            np.where(z == 0.5, np.float32(draw_loss_weight), np.float32(1.0))
        )
    w = np.concatenate(weights) if draw_loss_weight != 1.0 else None
    return (
        np.concatenate(planes),
        np.concatenate(values),
        np.concatenate(policies),
        w,
    )


def game_str(moves, move_values, policies, length) -> str:
    """Pretty-print one recorded game, board by board."""
    from connect4_tpu_torch.env.host_board import HostBoard

    board = HostBoard()
    out = [str(board)]
    for t in range(int(length)):
        board.make_move(int(moves[t]))
        out.append(
            "Move: {}  Value: {:.4f} Policy: {}\n{}".format(
                int(moves[t]),
                float(move_values[t]),
                np.round(np.asarray(policies[t]), 3),
                board,
            )
        )
    return "\n".join(out)
