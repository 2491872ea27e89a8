"""Folded-BN inference tower: the hand-written CUDA kernel, its plain
PyTorch version, and the head epilogue.

The counterpart of ``connect4_tpu.models.pallas_net``. ``pack_weights``
flattens a folded parameter set (``models.net.fold_bn_params``) into
kernel-shaped bf16 tensors; ``run_tower`` computes the 13-conv tower (at the
shipped net) on ``[B*42, channels]`` rows; ``heads`` runs the value and
policy heads on its output; ``forward`` chains them.

``run_tower`` launches the CUDA kernel of ``csrc/tower.cu`` for a CUDA
tensor, and takes the plain version ``tower_plain`` only for a CPU tensor.
It never falls back: a CUDA input that the kernel does not take raises.
``run_tower.launches`` counts kernel launches.

Numerics (both versions, as in the Pallas kernel): inputs rounded to bf16,
bf16 weights, float32 accumulation, float32 bias add, LeakyReLU, a round
to bf16 at every layer boundary, the residual add in float32. The heads
take the bf16 tower output through float32 products and round to bf16
where the Pallas epilogue does; tanh and softmax run in float32.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from connect4_tpu_torch.build import load_library
from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.models.net import lrelu
from connect4_tpu_torch.types import AREA, HEIGHT, WIDTH

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "tower.cu")
KERNEL_FILTERS = (16, 32, 64)  # widths the kernel is instantiated for
MAX_CHANNELS = 4

_BF16 = torch.bfloat16


def pack_weights(config: NetConfig, folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Kernel-shaped tensors from an ``InferenceNet`` state dict, on its
    device. 3x3 kernels become im2col matrices ``[9*Cin, F]`` with rows in
    (dr, dc, cin) order, as ``pack_weights`` of the Pallas tower makes them;
    ``res_wt`` holds the residual convs' matrices transposed, ``[2n, F, 9F]``,
    the layout the CUDA kernel reads. Biases are rounded to bf16, as there."""

    def im2col(w):  # OIHW [F, Cin, 3, 3] -> [9*Cin, F]
        return w.detach().permute(2, 3, 1, 0).reshape(-1, w.shape[0]).to(_BF16)

    def bf(name):
        return folded[name].detach().to(_BF16)

    f = config.filters
    res_w = [im2col(folded[f"res.{i}.weight"]) for i in range(2 * config.n_residuals)]
    res_b = [bf(f"res.{i}.bias") for i in range(2 * config.n_residuals)]
    dev = folded["conv0.weight"].device
    res_w = torch.stack(res_w) if res_w else torch.zeros((0, 9 * f, f), dtype=_BF16, device=dev)
    res_b = torch.stack(res_b) if res_b else torch.zeros((0, f), dtype=_BF16, device=dev)
    n_fc = config.n_fc_layers

    def dense(name):  # Linear [out, in] -> Dense kernel [in, out]
        return folded[name].detach().T.contiguous().to(_BF16)

    return {
        "conv1_w": im2col(folded["conv0.weight"]).contiguous(),  # [9*channels, F]
        "conv1_b": bf("conv0.bias"),
        "res_w": res_w.contiguous(),  # [2n, 9F, F]
        "res_wt": res_w.transpose(1, 2).contiguous(),  # [2n, F, 9F]
        "res_b": res_b.contiguous(),  # [2n, F]
        "vh_conv_w": folded["vh_conv.weight"].detach().reshape(1, f).T.contiguous().to(_BF16),
        "vh_conv_b": bf("vh_conv.bias"),
        "vh_fc_w": [dense(f"vh_fcs.{i}.weight") for i in range(n_fc)],
        "vh_fc_b": [bf(f"vh_fcs.{i}.bias") for i in range(n_fc)],
        "vh_out_w": dense("vh_out.weight"),
        "vh_out_b": bf("vh_out.bias"),
        "ph_conv_w": folded["ph_conv.weight"].detach().reshape(2, f).T.contiguous().to(_BF16),
        "ph_conv_b": bf("ph_conv.bias"),
        "ph_fc_w": dense("ph_fc.weight"),  # [84, 7], rows in (r, c, ch) order
        "ph_fc_b": bf("ph_fc.bias"),
    }


# ---------------------------------------------------------------------------
# plain PyTorch version


def _conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One folded conv + bias on bf16 boards ``[B, 6, 7, Cin]`` -> float32
    ``[B, 6, 7, F]``: im2col over the zero-padded board, bf16 values
    multiplied in float32.

    The sum runs in the CUDA kernel's order: where the contraction depth
    9*Cin is a multiple of 16 (the residual convs) each 16-deep slice is
    its own product and the slices are added in turn, as the kernel's
    tensor-core steps are; otherwise (the input conv) the terms are added
    one by one, as the kernel's scalar loop adds them. The two versions
    then differ only inside a 16-term product. Any other order flips the
    bf16 rounding of some outputs of every layer, and the flips compound
    through the tower."""
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    patches = torch.cat(
        [xp[:, dr:dr + HEIGHT, dc:dc + WIDTH, :] for dr in range(3) for dc in range(3)],
        dim=-1,
    )  # [B, 6, 7, 9*Cin], (dr, dc, cin) order
    depth = patches.shape[-1]
    chunk = 16 if depth % 16 == 0 else 1
    parts = torch.einsum(
        "...ks,ksf->...kf",
        patches.unflatten(-1, (depth // chunk, chunk)),
        w.float().unflatten(0, (depth // chunk, chunk)),
    )  # [B, 6, 7, depth/chunk, F]
    acc = parts[..., 0, :]
    for i in range(1, depth // chunk):
        acc = acc + parts[..., i, :]
    return acc + b.float()


def tower_plain(packed: Dict[str, torch.Tensor], x2d: torch.Tensor) -> torch.Tensor:
    """The tower in plain tensor code: ``[B*42, C]`` -> ``[B*42, F]`` bf16."""
    b = x2d.shape[0] // AREA
    x = x2d.to(_BF16).reshape(b, HEIGHT, WIDTH, -1)
    x = lrelu(_conv3x3_plain(x, packed["conv1_w"], packed["conv1_b"])).to(_BF16)
    res_w, res_b = packed["res_w"], packed["res_b"]
    for i in range(res_w.shape[0] // 2):
        y = lrelu(_conv3x3_plain(x, res_w[2 * i], res_b[2 * i])).to(_BF16)
        y2 = _conv3x3_plain(y, res_w[2 * i + 1], res_b[2 * i + 1])
        x = lrelu(y2 + x.float()).to(_BF16)
    return x.reshape(b * AREA, -1)


# ---------------------------------------------------------------------------
# the CUDA kernel


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.c4_tower_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...], device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"tower kernel: {name} must be a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f" ({'contiguous' if t.is_contiguous() else 'strided'})"
        )


def _tower_cuda(packed: Dict[str, torch.Tensor], x2d: torch.Tensor) -> torch.Tensor:
    rows, cin = x2d.shape
    f = packed["conv1_w"].shape[1]
    n_layers = packed["res_wt"].shape[0]
    if rows % AREA or f not in KERNEL_FILTERS or not 1 <= cin <= MAX_CHANNELS:
        raise ValueError(
            f"tower kernel takes [B*42, C<= {MAX_CHANNELS}] rows and F in "
            f"{KERNEL_FILTERS}; got rows {rows}, C {cin}, F {f}"
        )
    dev = x2d.device
    _check(x2d, "x", torch.float32, (rows, cin), dev)
    _check(packed["conv1_w"], "conv1_w", _BF16, (9 * cin, f), dev)
    _check(packed["conv1_b"], "conv1_b", _BF16, (f,), dev)
    _check(packed["res_wt"], "res_wt", _BF16, (n_layers, f, 9 * f), dev)
    _check(packed["res_b"], "res_b", _BF16, (n_layers, f), dev)
    out = torch.empty((rows, f), dtype=_BF16, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.c4_tower_forward(
            x2d.data_ptr(), packed["conv1_w"].data_ptr(), packed["conv1_b"].data_ptr(),
            packed["res_wt"].data_ptr(), packed["res_b"].data_ptr(), out.data_ptr(),
            rows // AREA, cin, f, n_layers, stream,
        )
    if err != 0:
        raise RuntimeError(f"tower kernel launch failed with cudaError {err}")
    run_tower.launches += 1
    return out


def run_tower(packed: Dict[str, torch.Tensor], x2d: torch.Tensor) -> torch.Tensor:
    """``[B*42, C]`` float32 rows of ``(board, r, c)`` -> ``[B*42, F]`` bf16
    tower output. The CUDA kernel for a CUDA tensor; the plain version for
    a CPU tensor; anything else raises."""
    if x2d.device.type == "cuda":
        return _tower_cuda(packed, x2d)
    if x2d.device.type == "cpu":
        return tower_plain(packed, x2d)
    raise ValueError(f"tower: no implementation for device {x2d.device}")


run_tower.launches = 0


# ---------------------------------------------------------------------------
# heads and the whole forward


def _dot(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 products accumulated in float32, plus the bias."""
    return x.float() @ w.float() + b.float()


def heads(packed: Dict[str, torch.Tensor], t: torch.Tensor):
    """Value and policy heads on the bf16 tower output ``[B*42, F]``
    -> ``(value [B] f32, prior [B, 7] f32)``."""
    b = t.shape[0] // AREA
    v = lrelu(_dot(t, packed["vh_conv_w"], packed["vh_conv_b"])).to(_BF16)
    v = v.reshape(b, AREA)
    for wi, bi in zip(packed["vh_fc_w"], packed["vh_fc_b"]):
        v = _dot(v, wi, bi).to(_BF16)
    v = lrelu(v.float()).to(_BF16)
    v = _dot(v, packed["vh_out_w"], packed["vh_out_b"])
    value = ((torch.tanh(v) + 1.0) * 0.5).reshape(b)

    p = lrelu(_dot(t, packed["ph_conv_w"], packed["ph_conv_b"])).to(_BF16)
    p = p.reshape(b, AREA * 2)  # (r, c, ch) flatten order
    prior = torch.softmax(_dot(p, packed["ph_fc_w"], packed["ph_fc_b"]), dim=-1)
    return value, prior


def forward(packed: Dict[str, torch.Tensor], nhwc: torch.Tensor):
    """``nhwc [B, 6, 7, channels] -> (value [B] f32, prior [B, 7] f32)``."""
    b = nhwc.shape[0]
    x2d = nhwc.reshape(b * AREA, nhwc.shape[-1]).float().contiguous()
    return heads(packed, run_tower(packed, x2d))
