"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or left as the default) and
    there is none; the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (the port's stand-in for
    a ``jax.random`` key)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
