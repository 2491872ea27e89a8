"""The search's descent as one hand-written CUDA kernel: its build and
its ctypes binding.

``launch`` walks every row of a search workspace that still descends from
where it stands to a childless node, in place, on the ``Descent`` buffers
of ``batched``: one launch of the kernel of ``csrc/descent.cu`` (a warp a
row, the whole walk in registers, no host involved). It takes CUDA tensors
only, and raises on anything else and on a failed build or launch. The
search calls it through ``batched.descend``, which counts the launches and
takes the plain version, ``batched.descend_plain``, for CPU tensors.

The counterpart of the two ``lax.while_loop`` descents of the JAX search
(``connect4_tpu/mcts/batched.py``, ``_simulate_exact`` and
``_simulate_parallel``), whose condition, ``jnp.any(descending)``, the
device computes: here each row's loop ends on the card where the row
reaches its leaf. ``k = 0`` scores children exactly, ``k = K > 1`` with
the K lockstep walkers' constant overlay (``batched._score_parts``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from connect4_tpu_torch.build import load_library
from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.types import HEIGHT, WIDTH

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "descent.cu")


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.c4_descend.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                               + [ctypes.c_void_p])
    lib.c4_descend.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...], device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"descent kernel: {name} must be a contiguous {dtype} tensor of shape {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} ({'contiguous' if t.is_contiguous() else 'strided'})"
        )


def launch(d, tree, config: MCTSConfig, capacity: int, path_max: int, k: int) -> None:
    """One launch of the descent kernel on the current stream: every row of
    the ``batched.Descent`` ``d`` (paths of ``path_max`` columns) that
    still descends walks to its leaf in the ``batched.TreeArrays`` ``tree``
    (slabs of ``capacity + 1`` columns), in place, at most ``path_max - 2``
    levels deep; ``k`` is 0 for the exact score or the walkers K.
    The tensors are CUDA tensors (``batched.descend`` sends no others).
    Raises on a tensor the kernel does not take, a failed build and a
    failed launch."""
    batch = d.node.shape[0]
    dev = d.node.device
    n1 = capacity + 1
    if k < 0:
        raise ValueError(f"descent kernel: k must be 0 (the exact score) or the walkers K, got {k}")
    for t, name, dtype, shape in (
        (tree.children_base, "children_base", torch.int32, (batch, n1)),
        (tree.stats, "stats", torch.float32, (batch, n1, 4)),
        (tree.prior, "prior", torch.float32, (batch, n1, WIDTH)),
        (d.node, "node", torch.long, (batch,)),
        (d.board.pieces, "pieces", torch.bool, (batch, 2, HEIGHT, WIDTH)),
        (d.board.height, "height", torch.int32, (batch, WIDTH)),
        (d.board.age, "age", torch.int32, (batch,)),
        (d.descending, "descending", torch.bool, (batch,)),
        (d.path, "path", torch.long, (batch, path_max)),
        (d.depth, "depth", torch.long, (batch,)),
        (d.level, "level", torch.long, (1,)),
    ):
        _check(t, name, dtype, shape, dev)
    if tree.stats.data_ptr() % 16:
        raise ValueError("descent kernel: stats must start on a 16-byte boundary (it is read as float4)")
    if batch == 0:
        return
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.c4_descend(
            tree.children_base.data_ptr(), tree.stats.data_ptr(), tree.prior.data_ptr(), d.node.data_ptr(),
            d.board.pieces.data_ptr(), d.board.height.data_ptr(), d.board.age.data_ptr(),
            d.descending.data_ptr(), d.path.data_ptr(), d.depth.data_ptr(), d.level.data_ptr(),
            batch, capacity, path_max, k, config.pb_c_base, config.pb_c_init, stream,
        )
    if err != 0:
        raise RuntimeError(f"descent kernel launch failed with cudaError {err} ({batch} rows, k {k})")
