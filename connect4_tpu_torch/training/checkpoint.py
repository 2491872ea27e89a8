"""Checkpoints of the full learner state as torch state dicts.

The counterpart of ``connect4_tpu.training.checkpoint`` (Orbax there): the
net (parameters and BatchNorm statistics), the optimiser (momentum buffers
and learning rate), the state of the loop's random generator, the
generation number and the net's architecture (``net_config``) are saved per
generation in one file, ``save_dir/<gen>/ckpt/state.pt``, so that a player
can be built from a checkpoint without being told its widths. Resume scans ``save_dir`` for the highest
numeric generation that still reads.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re
from typing import Optional, Tuple

import torch

from connect4_tpu_torch.config import ModelConfig, net_config_from_dict
from connect4_tpu_torch.training.learner import TrainState, init_train_state
from connect4_tpu_torch.utils import DeviceLike, resolve_device

FILE_NAME = "state.pt"


def _ckpt_path(save_dir: str, gen: int) -> str:
    return os.path.abspath(os.path.join(save_dir, str(gen), "ckpt"))


def save_checkpoint(
    save_dir: str, gen: int, state: TrainState, generator: torch.Generator
) -> str:
    """Write the checkpoint of generation ``gen``; returns its directory.
    The file is written under a temporary name and renamed, so a crash
    leaves either the whole file or none."""
    path = _ckpt_path(save_dir, gen)
    os.makedirs(path, exist_ok=True)
    payload = {
        "net": state.net.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": generator.get_state(),
        "gen": int(gen),
        "net_config": dataclasses.asdict(state.net.config),
    }
    tmp = os.path.join(path, FILE_NAME + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, FILE_NAME))
    return path


def restore_checkpoint(
    save_dir: str,
    gen: int,
    state: Optional[TrainState] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[TrainState, Optional[torch.Generator]]:
    """Load generation ``gen`` into ``state`` (a net and optimiser of the
    same configuration, for instance freshly initialised) and, when given,
    into ``generator``, in place; returns both. With ``state`` None the net
    is built from the architecture the checkpoint carries, on ``device``
    (default CUDA). Tensors are read onto ``device`` (default: where the
    net is). All or nothing: when any part fails to load, ``state`` and
    ``generator`` are put back as they were before the error is raised."""
    if state is None:
        device = resolve_device(device)
    elif device is None:
        device = next(state.net.parameters()).device
    payload = torch.load(
        os.path.join(_ckpt_path(save_dir, gen), FILE_NAME),
        map_location=torch.device(device), weights_only=True,
    )
    if int(payload["gen"]) != int(gen):
        raise ValueError(f"checkpoint under generation {gen} says generation {payload['gen']}")
    if state is None:
        config = ModelConfig(net_config=net_config_from_dict(payload["net_config"]))
        state = init_train_state(config, torch.Generator().manual_seed(0), device)
    before = (
        copy.deepcopy(state.net.state_dict()),
        copy.deepcopy(state.optimizer.state_dict()),
        None if generator is None else generator.get_state(),
    )
    try:
        state.net.load_state_dict(payload["net"])
        state.optimizer.load_state_dict(payload["optimizer"])
        if generator is not None:
            generator.set_state(payload["generator"].cpu())
    except Exception:
        state.net.load_state_dict(before[0])
        state.optimizer.load_state_dict(before[1])
        if generator is not None:
            generator.set_state(before[2])
        raise
    return state, generator


def checkpoint_generations(save_dir: str) -> list[int]:
    """All numeric subdirectories containing a checkpoint dir, ascending."""
    if not os.path.isdir(save_dir):
        return []
    gens = []
    for name in os.listdir(save_dir):
        if re.fullmatch(r"\d+", name) and os.path.isdir(
            os.path.join(save_dir, name, "ckpt")
        ):
            gens.append(int(name))
    return sorted(gens)


def latest_generation(save_dir: str) -> Optional[int]:
    """Highest numeric subdirectory containing a checkpoint, or None."""
    gens = checkpoint_generations(save_dir)
    return gens[-1] if gens else None


def restore_latest(
    save_dir: str,
    state: Optional[TrainState] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Optional[Tuple[int, TrainState, Optional[torch.Generator]]]:
    """Restore the newest *readable* checkpoint, falling back one
    generation at a time past empty, half-written or corrupt directories.
    Returns ``(gen, state, generator)`` or ``None`` when no checkpoint is
    readable."""
    for gen in reversed(checkpoint_generations(save_dir)):
        try:
            restored, generator = restore_checkpoint(save_dir, gen, state, generator, device)
            return gen, restored, generator
        except Exception as exc:  # a damaged file fails in torch.load in many ways
            print(
                f"checkpoint for generation {gen} is unreadable "
                f"({type(exc).__name__}: {exc}); falling back one generation"
            )
    return None
