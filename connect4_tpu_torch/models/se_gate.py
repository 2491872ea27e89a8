"""The squeeze-and-excitation gate of Leela Chess Zero's residual block
(``config.SENetConfig``): one hand-written CUDA kernel a direction
(``csrc/se_gate.cu``), its build, its ctypes binding, its autograd and its
plain version.

``se_gate(y, skip, w1, b1, w2, b2, dtype)`` is ``relu(sigmoid(gamma) * y +
shift + skip)`` in float32, ``(gamma, shift)`` the split of ``W2 relu(W1 s +
b1) + b2`` and ``s`` the mean of ``y`` over each board's 42 cells; ``y`` and
``skip`` are ``[N, F, 6, 7]``. It returns ``(out, copy)``: the float32
output and its copy in ``dtype`` (bf16 for a bf16 net, what the next conv
takes), which for float32 is ``out`` itself. The backward takes the
gradients of both and adds them.

For a CUDA tensor it launches the kernels (channels_last activations, F a
multiple of 32 up to 1024; anything else raises), for a CPU tensor it runs
the plain version, ``se_gate_plain``: the same arithmetic in PyTorch ops,
with its backward written out. The kernels keep the learner's step short in
launches: the gate in autograd's ops is about 25 launches a block, and at
20 blocks the step then queues more kernels than the card's launch queue
holds, so that the host waits on the card. ``se_gate.launches`` and
``.backward_launches`` count the kernels' forwards and backwards, where they
launch, through ``launches.count``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from connect4_tpu_torch import launches
from connect4_tpu_torch.build import load_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "se_gate.cu")
_LIB = []  # the library with its signatures set, once loaded


def _library() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library(SOURCE)
        lib.c4_se_gate_fwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.c4_se_gate_bwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        for fn in (lib.c4_se_gate_fwd, lib.c4_se_gate_bwd):
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _pointer(t):
    return None if t is None else t.data_ptr()


class _GatePlain(torch.autograd.Function):
    """The plain version: ``se_gate``'s arithmetic in PyTorch ops with its
    backward written out."""

    @staticmethod
    def forward(ctx, y, skip, w1, b1, w2, b2, dtype):
        f = y.shape[1]
        s = y.mean(dim=(2, 3))
        z = torch.relu(torch.addmm(b1, s, w1.t()))
        e = torch.addmm(b2, z, w2.t())
        g = torch.sigmoid(e[:, :f])
        out = torch.add(skip, e[:, f:, None, None]).addcmul_(g[:, :, None, None], y).relu_()
        ctx.save_for_backward(y, s, z, g, out, w1, w2)
        ctx.set_materialize_grads(False)
        return out if dtype == out.dtype else (out, out.to(dtype))

    @staticmethod
    def backward(ctx, grad, grad_c=None):
        if grad is None and grad_c is None:
            return (None,) * 7
        y, s, z, g, out, w1, w2 = ctx.saved_tensors
        return (*backward_plain(grad, grad_c, y, s, z, g, out, w1, w2), None)


def backward_plain(grad, grad_c, y, s, z, g, out, w1, w2):
    """The gate's backward in PyTorch ops, from what its forward kept (the
    mean ``s``, the squeeze ``z``, the gate ``g``, the output):
    ``(d_y, d_skip, d_w1, d_b1, d_w2, d_b2)``."""
    if grad is None:
        grad = grad_c.to(out.dtype)
    elif grad_c is not None:
        grad = grad + grad_c
    d_pre = torch.ops.aten.threshold_backward(grad, out, 0)  # through the ReLU: 0 where out is 0
    d_e = torch.cat([torch.ops.aten.sigmoid_backward((d_pre * y).sum(dim=(2, 3)), g), d_pre.sum(dim=(2, 3))], 1)
    d_h = torch.ops.aten.threshold_backward(d_e @ w2, z, 0)
    d_s = (d_h @ w1).div_(y.shape[2] * y.shape[3])
    d_y = torch.addcmul(d_s[:, :, None, None], d_pre, g[:, :, None, None])
    return d_y, d_pre, d_h.t() @ s, d_h.sum(0), d_e.t() @ z, d_e.sum(0)


class _GateCuda(torch.autograd.Function):
    """The kernels: ``se_gate_fwd`` and ``se_gate_bwd``; the weights'
    gradients, which sum over the boards, as two products each."""

    @staticmethod
    def forward(ctx, y, skip, w1, b1, w2, b2, dtype):
        n, f = y.shape[:2]
        sq = w1.shape[0]
        if f % 32 or f > 1024 or y.shape[2] * y.shape[3] != 42 or dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"se_gate kernels: [N, F, 6, 7] with F a multiple of 32 up to 1024 and a float32 or "
                             f"bf16 copy; got {tuple(y.shape)}, {dtype}")
        y, skip = _nhwc(y), _nhwc(skip)
        w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
        out = torch.empty_like(y)
        out_c = None if dtype == torch.float32 else torch.empty_like(y, dtype=dtype)
        s, z, g = y.new_empty((n, f)), y.new_empty((n, sq)), y.new_empty((n, f))
        with torch.cuda.device(y.device):
            err = _library().c4_se_gate_fwd(
                y.data_ptr(), skip.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                out.data_ptr(), _pointer(out_c), s.data_ptr(), z.data_ptr(), g.data_ptr(), n, f, sq,
                torch.cuda.current_stream(y.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"se_gate forward launch failed with cudaError {err} ({n} boards, {f} channels)")
        launches.count(_record, "launches")
        ctx.save_for_backward(y, out, s, z, g, w1, w2)
        ctx.set_materialize_grads(False)
        return out if out_c is None else (out, out_c)

    @staticmethod
    def backward(ctx, grad, grad_c=None):
        if grad is None and grad_c is None:
            return (None,) * 7
        y, out, s, z, g, w1, w2 = ctx.saved_tensors
        n, f = y.shape[:2]
        sq = w1.shape[0]
        grad = None if grad is None else _nhwc(grad.float())
        grad_c = None if grad_c is None else _nhwc(grad_c.to(torch.bfloat16))
        d_skip, d_y = torch.empty_like(out), torch.empty_like(out)
        d_e, d_h = y.new_empty((n, 2 * f)), y.new_empty((n, sq))
        with torch.cuda.device(y.device):
            err = _library().c4_se_gate_bwd(
                _pointer(grad), _pointer(grad_c), y.data_ptr(), out.data_ptr(), g.data_ptr(), z.data_ptr(),
                w1.data_ptr(), w2.data_ptr(), d_skip.data_ptr(), d_y.data_ptr(), d_e.data_ptr(), d_h.data_ptr(),
                n, f, sq, torch.cuda.current_stream(y.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"se_gate backward launch failed with cudaError {err} ({n} boards, {f} channels)")
        launches.count(_record, "backward_launches")
        return d_y, d_skip, d_h.t() @ s, d_h.sum(0), d_e.t() @ z, d_e.sum(0), None


def _apply(fn, y, skip, w1, b1, w2, b2, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    out = fn.apply(y.float(), skip.float(), w1.float(), b1.float(), w2.float(), b2.float(), dtype)
    return out if isinstance(out, tuple) else (out, out)


def se_gate(y: torch.Tensor, skip: torch.Tensor, w1, b1, w2, b2, dtype=torch.float32):
    """``(out, copy)`` of the gate (the module's docstring): the kernels for
    a CUDA tensor, the plain version for a CPU tensor; anything else
    raises."""
    if y.device.type == "cuda":
        return _apply(_GateCuda, y, skip, w1, b1, w2, b2, dtype)
    if y.device.type == "cpu":
        return _apply(_GatePlain, y, skip, w1, b1, w2, b2, dtype)
    raise ValueError(f"se_gate: no implementation for device {y.device}")


def se_gate_plain(y: torch.Tensor, skip: torch.Tensor, w1, b1, w2, b2, dtype=torch.float32):
    """``se_gate``'s plain version on any device."""
    return _apply(_GatePlain, y, skip, w1, b1, w2, b2, dtype)


se_gate.launches = 0
se_gate.backward_launches = 0


def _record(field: str) -> None:
    setattr(se_gate, field, getattr(se_gate, field) + 1)
