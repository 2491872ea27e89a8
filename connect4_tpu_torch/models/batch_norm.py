"""The learner's train-mode BatchNorm fused with its activation and skip add:
one hand-written CUDA kernel pair a direction (``csrc/batch_norm.cu``),
its build, its ctypes binding, its autograd and its plain version.

``batch_norm_act(x, bn, skip, stream, act)`` is ``act(BatchNorm(x) +
skip)`` in training mode over an NHWC activation, ``act`` one of ``ACTS``:
LeakyReLU (the default, the oinkoink ResNet's), ReLU, or none (the
squeeze-and-excitation body's; ``net.SENetConfig``). The kernels take it as
a template parameter, so each activation is code of its own: ``x`` the conv output, a
``channels_last`` ``[N, C, H, W]`` tensor or a ``[R, C]`` matrix (bf16, or
float32 for a float32 net); ``skip`` the float32 residual stream or None.
It normalises with the batch's mean and biased variance, moves ``bn``'s
running statistics as ``net._bn`` does (momentum 0.9, the biased
variance), and returns ``(y, y_stream)``: ``y`` in ``x``'s type, what the
next convolution takes, and, with ``stream=True``, the same activation in
float32 for the skip that follows (``y`` itself for a float32 ``x``), else
None. Its backward takes the gradients of both outputs and returns those of
``x``, of ``bn``'s scale and bias, and of ``skip``.

For a CUDA tensor it launches the kernels, or raises; for a CPU tensor it
runs the plain version, ``_forward_plain`` and ``_backward_plain``: the
kernels' arithmetic in PyTorch ops. ``batch_norm_act.launches`` and
``.backward_launches`` count the fused forwards and backwards on the card
(through ``launches.count``, so a captured graph's count at each replay).

The net calls it on the card in training mode on one rank, as
``batch_norm_act_unchecked`` (``net._bn_act``); every other path keeps
``net._bn`` and ``net.lrelu``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from connect4_tpu_torch import launches
from connect4_tpu_torch.build import load_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "batch_norm.cu")

EPS = 1e-5  # net.BN_EPS
MOMENTUM = 0.9  # net.BN_MOMENTUM: the weight of the old running value
SLOPE = 0.01  # net.LEAKY_SLOPE
# the activations after the BatchNorm (the kernels' kAct* values, in order)
# and the slope each takes below 0
ACTS = ("leaky", "relu", "none")
SLOPES = {"leaky": SLOPE, "relu": 0.0, "none": 1.0}
BLOCKS_PER_SM = 2  # a reduction's grid: at most this many blocks an SM
MAX_TILES = 64  # tickets a stream holds: one a tile of 512 channel packs (kThreads)
MAX_CHANNELS = MAX_TILES * 512  # so at most MAX_TILES tiles, whatever the pack

# per (device, stream, channels): the reductions' scratch (``_scratch``)
_SCRATCH: Dict[Tuple[torch.device, int, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]] = {}
_LIB = []  # the library with its signatures set, once loaded


def _library() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library(SOURCE)
        lib.c4_batch_norm_act_fwd.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10
                                              + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                                              + [ctypes.c_int, ctypes.c_void_p])
        lib.c4_batch_norm_act_bwd.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                                              + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        for fn in (lib.c4_batch_norm_act_fwd, lib.c4_batch_norm_act_bwd):
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` -> ``[N*H*W, C]`` in (n, h, w) order; a view of a
    ``channels_last`` tensor. A matrix as it is."""
    return t if t.dim() == 2 else t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _unrows(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``_rows``' inverse, in ``like``'s shape (``channels_last`` strides)."""
    if like.dim() == 2:
        return t
    n, c, h, w = like.shape
    return t.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its channels innermost in dense memory (no copy if so)."""
    return t.contiguous() if t.dim() == 2 else t.contiguous(memory_format=torch.channels_last)


def _is_nhwc(t: torch.Tensor) -> bool:
    return t.is_contiguous() if t.dim() == 2 else t.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# the plain version


def _activate(pre: torch.Tensor, act: str) -> torch.Tensor:
    return pre if act == "none" else torch.where(pre >= 0, pre, pre * SLOPES[act])


def _forward_plain(x, weight, bias, running_mean, running_var, skip, stream, act="leaky"):
    """The kernels' forward in PyTorch ops: ``(y, y_stream, stats)``,
    ``stats`` the float32 ``[4, C]`` mean, inverse deviation, scale and
    shift the backward reads."""
    xf = _rows(x).float()
    mean = xf.mean(0)
    var = (xf - mean).square().mean(0)
    invstd = 1.0 / torch.sqrt(var + EPS)
    scale = weight * invstd
    shift = bias - mean * scale
    pre = torch.addcmul(shift, xf, scale)
    if skip is not None:
        pre = pre + _rows(skip)
    y = _activate(pre, act)
    with torch.no_grad():
        running_mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
        running_var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)
    stats = torch.stack([mean, invstd, scale, shift])
    return _unrows(y.to(x.dtype), x), (_unrows(y, x) if stream else None), stats


def _backward_plain(x, skip, stats, g_c, g_f, act="leaky"):
    """The kernels' backward in PyTorch ops: ``(dx, dgamma, dbeta, dskip)``."""
    mean, invstd, scale, shift = stats
    xf = _rows(x).float()
    pre = torch.addcmul(shift, xf, scale)
    if skip is not None:
        pre = pre + _rows(skip)
    g = torch.zeros_like(pre)
    if g_f is not None:
        g = g + _rows(g_f)
    if g_c is not None:
        g = g + _rows(g_c).float()
    dpre = g if act == "none" else torch.where(pre >= 0, g, g * SLOPES[act])
    xhat = (xf - mean) * invstd
    dbeta, dgamma = dpre.sum(0), (dpre * xhat).sum(0)
    rows = xf.shape[0]
    dx = scale * (dpre - dbeta / rows - xhat * (dgamma / rows))
    return (_unrows(dx.to(x.dtype), x), dgamma, dbeta,
            _unrows(dpre, x) if skip is not None else None)


# ---------------------------------------------------------------------------
# the kernels


def _pointer(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _aligned(*ts: Optional[torch.Tensor]) -> int:
    return int(all(t is None or t.data_ptr() % 16 == 0 for t in ts))


def _scratch(dev: torch.device, c: int):
    """This stream's handle and its scratch for ``c`` channels: the
    reductions' partials (``[blocks, 2c]`` float32), the backward's
    coefficients (``[2, c]``), the tickets (zero between launches: each
    grid's last block resets its own) and the most blocks. Launches on one
    stream run in turn, so they share it; made once, so a step allocates
    none of it. The handle is read raw, as PyTorch's generated kernels read
    it: ``torch.cuda.current_stream`` makes a Stream object, 50 times the
    cost."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    got = _SCRATCH.get((dev, stream, c))
    if got is None:
        blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
        got = _SCRATCH[dev, stream, c] = (torch.empty((blocks, 2 * c), dtype=torch.float32, device=dev),
                                          torch.empty((2, c), dtype=torch.float32, device=dev),
                                          torch.zeros(MAX_TILES, dtype=torch.int32, device=dev), blocks)
    return got, stream


def _call(fn, dev: torch.device, *args) -> int:
    """``fn(*args)`` with ``dev`` current (kernels launch on the current
    device)."""
    if dev.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _check(x, skip, weight, bias, running_mean, running_var) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() not in (2, 4) or not _is_nhwc(x):
        raise ValueError(f"batch_norm_act: x must be a bf16 or float32 channels_last [N, C, H, W] tensor or a "
                         f"contiguous [R, C] matrix, got {x.dtype} {tuple(x.shape)} with strides {x.stride()}")
    c = x.shape[1]
    if x.numel() == 0 or c > MAX_CHANNELS:
        raise ValueError(f"batch_norm_act: {tuple(x.shape)}: no rows, or more than {MAX_CHANNELS} channels")
    for t, name in ((weight, "weight"), (bias, "bias"), (running_mean, "running_mean"),
                    (running_var, "running_var")):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"batch_norm_act: {name} must be a contiguous float32 [{c}] tensor on {x.device}")
    if skip is not None and (skip.device != x.device or skip.dtype != torch.float32 or skip.shape != x.shape
                             or not _is_nhwc(skip)):
        raise ValueError(f"batch_norm_act: skip must be float32 of x's shape {tuple(x.shape)} and layout")


def _forward_cuda(x, weight, bias, running_mean, running_var, skip, stream, act="leaky"):
    rows, c = x.numel() // x.shape[1], x.shape[1]
    bf16 = int(x.dtype == torch.bfloat16)
    y = torch.empty_like(x)
    y_stream = torch.empty_like(x, dtype=torch.float32) if stream else None
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    (work, _, tickets, blocks), cuda_stream = _scratch(x.device, c)
    err = _call(_library().c4_batch_norm_act_fwd, x.device,
                x.data_ptr(), bf16, _pointer(skip), y.data_ptr(), _pointer(y_stream), weight.data_ptr(),
                bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), stats.data_ptr(),
                work.data_ptr(), tickets.data_ptr(), rows, c, _aligned(x, skip, y, y_stream, stats), blocks,
                MOMENTUM, EPS, ACTS.index(act), cuda_stream)
    if err != 0:
        raise RuntimeError(f"batch_norm_act forward launch failed with cudaError {err} ({rows} rows, {c} channels)")
    launches.count(_record, "launches")
    return y, y_stream, stats


def _backward_cuda(x, skip, stats, g_c, g_f, act="leaky"):
    rows, c = x.numel() // x.shape[1], x.shape[1]
    bf16 = int(x.dtype == torch.bfloat16)
    g_c = None if g_c is None else _nhwc(g_c)
    g_f = None if g_f is None else _nhwc(g_f)
    dx = torch.empty_like(x)
    dpre = torch.empty_like(x, dtype=torch.float32) if skip is not None else None
    dgamma = torch.empty((c,), dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    (work, coef, tickets, blocks), cuda_stream = _scratch(x.device, c)
    err = _call(_library().c4_batch_norm_act_bwd, x.device,
                x.data_ptr(), bf16, _pointer(skip), _pointer(g_c), _pointer(g_f), stats.data_ptr(),
                _pointer(dpre), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), coef.data_ptr(),
                work.data_ptr(), tickets.data_ptr(), rows, c, _aligned(x, skip, g_c, g_f, stats, dpre, dx, coef),
                blocks, ACTS.index(act), cuda_stream)
    if err != 0:
        raise RuntimeError(f"batch_norm_act backward launch failed with cudaError {err} ({rows} rows, {c} channels)")
    launches.count(_record, "backward_launches")
    return dx, dgamma, dbeta, dpre


def _record(field: str) -> None:
    setattr(batch_norm_act, field, getattr(batch_norm_act, field) + 1)


# ---------------------------------------------------------------------------
# autograd and the wrapper


class _BatchNormAct(torch.autograd.Function):
    """Outputs ``(y, y_stream)`` with ``stream``, else ``y`` alone."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, skip, stream, act):
        run = _forward_cuda if x.device.type == "cuda" else _forward_plain
        y, y_stream, stats = run(x, weight, bias, running_mean, running_var, skip, stream, act)
        ctx.save_for_backward(x, skip, stats)
        ctx.set_materialize_grads(False)
        ctx.act = act
        return (y, y_stream) if stream else y

    @staticmethod
    def backward(ctx, g_c, g_f=None):
        x, skip, stats = ctx.saved_tensors
        run = _backward_cuda if x.device.type == "cuda" else _backward_plain
        dx, dgamma, dbeta, dskip = run(x, skip, stats, g_c, g_f, ctx.act)
        return dx, dgamma, dbeta, None, None, dskip if ctx.needs_input_grad[5] else None, None, None


def batch_norm_act(x: torch.Tensor, bn: nn.BatchNorm2d, skip: Optional[torch.Tensor] = None,
                   stream: bool = False, act: str = "leaky") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``act(BatchNorm(x) + skip)`` in training mode: ``(y, y_stream)``
    (the module's docstring). The kernels for a CUDA tensor, the plain
    version for a CPU tensor; anything else raises, as do arguments of
    another type, shape or layout, and an activation not in ``ACTS``."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"batch_norm_act: no implementation for device {x.device}")
    if act not in ACTS:
        raise ValueError(f"batch_norm_act: act must be one of {ACTS}, got {act!r}")
    _check(x, skip, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    return batch_norm_act_unchecked(x, bn, skip, stream, act)


def batch_norm_act_unchecked(x: torch.Tensor, bn: nn.BatchNorm2d, skip: Optional[torch.Tensor] = None,
                             stream: bool = False, act: str = "leaky") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``batch_norm_act`` without the checks of its arguments, for a caller
    that makes them so: the net's train step, whose conv outputs are
    ``channels_last`` (its inputs and weights are) and whose BatchNorms are
    its own. The checks take about 10 us of a forward's 50-70 us of host
    time on an H100's host, and the F=64 train step is paced by the host."""
    two = stream and x.dtype != torch.float32
    out = _BatchNormAct.apply(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, skip, two, act)
    if two:
        return out
    return out, (out if stream else None)


batch_norm_act.launches = 0
batch_norm_act.backward_launches = 0
