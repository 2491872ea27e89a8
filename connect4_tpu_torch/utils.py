"""Device selection, float32 precision, phase timers and file loading
shared by the port's entry points."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or left as the default) and
    there is none; the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        full_float32()
    return dev


def full_float32() -> None:
    """What float32 means in the port: IEEE float32 products and sums, on
    the card as on the CPU. PyTorch would otherwise let cuDNN convolutions
    (and, if asked, matmuls) of float32 tensors run on the tensor cores in
    TF32, with 10 mantissa bits. Every entry point reaches this through
    ``resolve_device``; the fast path is ``compute_dtype="bfloat16"``, which
    says what it rounds."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (the port's stand-in for
    a ``jax.random`` key)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(int(seed))


def np_load_retry(path: str, attempts: int = 5):
    """``np.load`` with retries on truncated-zip errors: a benchmark npz may
    be rewritten in place by a long-running process that solves more
    positions, so concurrent
    readers retry briefly instead of crashing a training generation."""
    import zipfile

    import numpy as np

    for attempt in range(attempts):
        try:
            return np.load(path)
        except FileNotFoundError:
            raise  # a missing file is not transient
        except (zipfile.BadZipFile, EOFError, OSError, ValueError):
            if attempt == attempts - 1:
                raise
            time.sleep(2.0 * (attempt + 1))


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block with ``torch.profiler`` (host ops, and
    the card's kernels and copies where CUDA is available) and write a
    Chrome/Perfetto trace, ``<log_dir>/trace.json``, when it ends. Yields
    ``log_dir`` (default ``~/connect4_tpu_torch_traces/<timestamp>``). Use
    around a warm region: one throwaway call first, so that the kernel's
    build and cuDNN's algorithm search stay out of the trace. The profiler's
    own post-processing runs when the block ends and grows with the number
    of ops traced."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.expanduser(f"~/connect4_tpu_torch_traces/{int(time.time())}")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class PhaseTimer:
    """Structured wall-clock accounting across named phases.

    ``with timer.phase("self_play"): ...`` accumulates seconds per phase;
    ``summary(counters)`` renders seconds plus any ``unit/phase`` rates
    (e.g. ``counters={"self_play": ("moves", 31000)}`` -> moves/s). The
    clock is the host's: a phase that leaves work queued on the card must
    synchronise before it ends.
    """

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.time() - t0

    def summary(self, counters: Optional[Dict[str, tuple]] = None) -> str:
        parts = []
        for name, secs in self.seconds.items():
            part = f"{name}: {secs:.1f}s"
            if counters and name in counters:
                unit, count = counters[name]
                if secs > 0:
                    part += f" ({count / secs:,.0f} {unit}/s)"
            parts.append(part)
        return "  ".join(parts)
