"""The latency of one dependent load that hits L2 on the card, and the
device time of a kernel that does nothing: the two terms of the descent
kernel's latency floor (``mcts/csrc/descent.cu`` walks a chain of dependent
reads, one L2 round trip a level).

One thread follows a random cycle of links through a buffer of ``MIB``
MiB, a 128-byte line a link, with loads that are cached in L2 and not in L1
(``csrc/l2_chase.cu``). One pass over the whole cycle first puts every line
in L2. The profiler's device time of ``STEPS`` links, less that of no
link, over ``STEPS`` is the round trip; the time of no link (one store) is
the empty kernel's. Each is the median of ``REPS`` launches. The buffer is
about the size of the descent's slabs at the bench shape (children_base,
stats and priors of 512 rows of 702 columns: 16.5 MiB).

    python -m connect4_tpu_torch.scripts.l2_latency
"""

from __future__ import annotations

import ctypes
import os
import statistics
import tempfile
from typing import Dict

import torch

from connect4_tpu_torch.build import load_library
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import resolve_device, trace

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "l2_chase.cu")
LINE_INTS = 32  # 128 B
MIB = 16
STEPS = 2048
REPS = 7


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.c4_l2_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.c4_l2_chase.restype = ctypes.c_int
    return lib


def measure(device: torch.device) -> Dict:
    """``{"round_trip_ms", "empty_ms", ...}`` on ``device`` (a CUDA card)."""
    lib = _library()
    lines = MIB * 2**20 // (LINE_INTS * 4)
    perm = torch.randperm(lines, generator=torch.Generator().manual_seed(0)) * LINE_INTS
    chain = torch.zeros(lines * LINE_INTS, dtype=torch.int32)
    chain[perm] = perm.roll(-1).int()
    chain = chain.to(device)
    out = torch.zeros(1, dtype=torch.int32, device=device)
    start = int(perm[0])
    stream = torch.cuda.current_stream(device).cuda_stream

    def chase(n: int) -> None:
        err = lib.c4_l2_chase(chain.data_ptr(), start, n, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"l2 chase kernel launch failed with cudaError {err}")

    chase(lines)  # the whole cycle once: every line in L2
    torch.cuda.synchronize(device)
    if int(out[0]) != start:
        raise RuntimeError("l2 chase: the chain is not one cycle")
    with tempfile.TemporaryDirectory(prefix="l2_latency_") as log_dir:
        with trace(log_dir):
            for _ in range(REPS):
                chase(0)
                chase(STEPS)
            torch.cuda.synchronize(device)
        events = _common.trace_events(log_dir)
    durs = [e["dur"] for e in sorted(events, key=lambda e: e["ts"])
            if e.get("cat") == "kernel" and "l2_chase_kernel" in e["name"]]
    if len(durs) != 2 * REPS:
        raise RuntimeError(f"l2 chase: the trace holds {len(durs)} kernels, not {2 * REPS}")
    empty_us, chase_us = statistics.median(durs[0::2]), statistics.median(durs[1::2])
    return {"round_trip_ms": (chase_us - empty_us) / STEPS / 1e3, "empty_ms": empty_us / 1e3,
            "chase_ms": chase_us / 1e3, "mib": MIB, "steps": STEPS, "reps": REPS}


def main() -> None:
    device = resolve_device("cuda")
    _common.emit({"device": _common.device_name(device), **measure(device)})


if __name__ == "__main__":
    main()
