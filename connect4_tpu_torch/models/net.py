"""Value+policy network in PyTorch.

The counterpart of ``connect4_tpu.models.net``: a conv+BN tower with
residual blocks over the 3x(6x7) input planes, a value head mapping to
[0, 1] via tanh, and a policy head emitting a softmax over the 7 columns.
The public forward takes NHWC ``[N, 6, 7, channels]`` planes, as the JAX
package does; inside, the tower runs NCHW, and ``nchw=True`` hands it the
stored ``[N, channels, 6, 7]`` planes as they are.

Parity details kept from the JAX net:

- The value head's Dense stack has *no* activation between its layers,
  with a single LeakyReLU after the stack.
- Both heads flatten their 1x1-conv output in (row, col, channel) order,
  the Flax NHWC order, so ``Dense`` kernels carry over without permuting
  rows (``models.convert``).
- With ``compute_dtype="bfloat16"`` convs and Dense layers run in bf16
  while BatchNorm, tanh and softmax run in float32 (Flax's ``dtype``
  promotion).

- In training mode (``net.train()``; ``init_net`` and ``from_flax`` return
  ``net.eval()``, and the learner switches explicitly) BatchNorm normalises
  with the batch's mean and biased variance and moves its running
  statistics as Flax's ``BatchNorm(momentum=0.9)`` does:
  ``0.9 * running + 0.1 * batch``, with the *biased* batch variance
  (``nn.BatchNorm2d`` would store the unbiased one).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.types import AREA, WIDTH
from connect4_tpu_torch.utils import DeviceLike, resolve_device

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * LEAKY_SLOPE)


def compute_dtype(config: NetConfig) -> torch.dtype:
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, padding=conv.padding)


def _dense(x: torch.Tensor, fc: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype))


BN_MOMENTUM = 0.9  # Flax's convention: the weight of the old running value


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm in float32 on the conv's output (bf16 or float32)."""
    x = x.float()
    if not bn.training:
        return F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
            training=False, eps=BN_EPS,
        )
    # With momentum 1 the fused op leaves the batch mean and the unbiased
    # batch variance in the two scratch buffers, at no extra pass over x.
    mean, var = torch.zeros_like(bn.running_mean), torch.zeros_like(bn.running_var)
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, training=True, momentum=1.0, eps=BN_EPS)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=(1.0 - BN_MOMENTUM) * (n - 1) / n)
    return y


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, H*W*C] in Flax's (row, col, channel) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, filters: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, filters, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(filters, eps=BN_EPS)

    def forward(self, x, dtype):
        return lrelu(_bn(_conv(x, self.conv, dtype), self.bn))


class _ResidualBlock(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.conv0 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters, eps=BN_EPS)

    def forward(self, x, dtype):
        y = lrelu(_bn(_conv(x, self.conv0, dtype), self.bn0))
        y = _bn(_conv(y, self.conv1, dtype), self.bn1)
        return lrelu(y + x.float())


class _ValueHead(nn.Module):
    def __init__(self, filters: int, n_fc_layers: int):
        super().__init__()
        self.conv = nn.Conv2d(filters, 1, 1)
        self.bn = nn.BatchNorm2d(1, eps=BN_EPS)
        self.fcs = nn.ModuleList([nn.Linear(AREA, AREA) for _ in range(n_fc_layers)])
        self.out = nn.Linear(AREA, 1)

    def forward(self, x, dtype):
        x = _flatten_nhwc(lrelu(_bn(_conv(x, self.conv, dtype), self.bn)))
        for fc in self.fcs:  # no activation between the Dense layers
            x = _dense(x, fc, dtype)
        x = _dense(lrelu(x), self.out, dtype)
        return ((torch.tanh(x.float()) + 1.0) * 0.5).reshape(-1)


class _PolicyHead(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.conv = nn.Conv2d(filters, 2, 1)
        self.bn = nn.BatchNorm2d(2, eps=BN_EPS)
        self.fc = nn.Linear(AREA * 2, WIDTH)

    def forward(self, x, dtype):
        x = _flatten_nhwc(lrelu(_bn(_conv(x, self.conv, dtype), self.bn)))
        return torch.softmax(_dense(x, self.fc, dtype).float(), dim=-1)


class Connect4Net(nn.Module):
    """Value+policy tower. Input: NHWC ``[N, 6, 7, channels]`` float planes
    (or NCHW ``[N, channels, 6, 7]`` with ``nchw=True``). Returns
    ``(value [N] in [0,1], prior [N,7] summing to 1)``."""

    def __init__(self, config: NetConfig):
        super().__init__()
        self.config = config
        f = config.filters
        self.conv_block = _ConvBlock(config.channels, f)
        self.res_blocks = nn.ModuleList(
            [_ResidualBlock(f) for _ in range(config.n_residuals)]
        )
        self.value_head = _ValueHead(f, config.n_fc_layers)
        self.policy_head = _PolicyHead(f)

    def forward(self, planes: torch.Tensor, nchw: bool = False):
        dtype = compute_dtype(self.config)
        x = self.conv_block(planes if nchw else planes.permute(0, 3, 1, 2), dtype)
        for blk in self.res_blocks:
            x = blk(x, dtype)
        return self.value_head(x, dtype), self.policy_head(x, dtype)


# ---------------------------------------------------------------------------
# Folded-BN inference path
#
# At inference BatchNorm is an affine map with frozen statistics, so it
# folds exactly into the preceding convolution's kernel and bias:
#     s = gamma / sqrt(var + eps);  y = s * conv(x) + (beta - s * mean)


class InferenceNet(nn.Module):
    """``Connect4Net`` with every BatchNorm folded away (inference only).
    Its parameters come from ``fold_bn_params``. Rounding follows the Flax
    ``InferenceNet``: every conv and Dense runs in the compute dtype,
    bias included."""

    def __init__(self, config: NetConfig):
        super().__init__()
        self.config = config
        f = config.filters
        self.conv0 = nn.Conv2d(config.channels, f, 3, padding=1)
        self.res = nn.ModuleList(
            [nn.Conv2d(f, f, 3, padding=1) for _ in range(2 * config.n_residuals)]
        )
        self.vh_conv = nn.Conv2d(f, 1, 1)
        self.vh_fcs = nn.ModuleList(
            [nn.Linear(AREA, AREA) for _ in range(config.n_fc_layers)]
        )
        self.vh_out = nn.Linear(AREA, 1)
        self.ph_conv = nn.Conv2d(f, 2, 1)
        self.ph_fc = nn.Linear(AREA * 2, WIDTH)

    def forward(self, nhwc: torch.Tensor):
        dt = compute_dtype(self.config)
        x = lrelu(_conv(nhwc.permute(0, 3, 1, 2), self.conv0, dt))
        for i in range(self.config.n_residuals):
            y = lrelu(_conv(x, self.res[2 * i], dt))
            x = lrelu(_conv(y, self.res[2 * i + 1], dt) + x)
        v = _flatten_nhwc(lrelu(_conv(x, self.vh_conv, dt)))
        for fc in self.vh_fcs:
            v = _dense(v, fc, dt)
        v = _dense(lrelu(v), self.vh_out, dt)
        value = ((torch.tanh(v.float()) + 1.0) * 0.5).reshape(-1)
        p = _flatten_nhwc(lrelu(_conv(x, self.ph_conv, dt)))
        prior = torch.softmax(_dense(p, self.ph_fc, dt).float(), dim=-1)
        return value, prior


def _fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    """Fold one (Conv, BatchNorm) pair into a biased conv, exactly."""
    s = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    weight = conv.weight * s[:, None, None, None]  # scale each output channel
    bias = bn.bias - bn.running_mean * s
    if conv.bias is not None:
        bias = bias + conv.bias * s
    return weight, bias


@torch.no_grad()
def fold_bn_params(net: Connect4Net) -> Dict[str, torch.Tensor]:
    """``InferenceNet`` state dict from a ``Connect4Net``'s weights and
    running statistics."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, wb):
        out[f"{name}.weight"], out[f"{name}.bias"] = wb

    put("conv0", _fold_conv_bn(net.conv_block.conv, net.conv_block.bn))
    for i, blk in enumerate(net.res_blocks):
        put(f"res.{2 * i}", _fold_conv_bn(blk.conv0, blk.bn0))
        put(f"res.{2 * i + 1}", _fold_conv_bn(blk.conv1, blk.bn1))
    vh, ph = net.value_head, net.policy_head
    put("vh_conv", _fold_conv_bn(vh.conv, vh.bn))
    for i, fc in enumerate(vh.fcs):
        put(f"vh_fcs.{i}", (fc.weight, fc.bias))
    put("vh_out", (vh.out.weight, vh.out.bias))
    put("ph_conv", _fold_conv_bn(ph.conv, ph.bn))
    put("ph_fc", (ph.fc.weight, ph.fc.bias))
    return {k: v.detach().clone() for k, v in out.items()}


def inference_net(net: Connect4Net) -> InferenceNet:
    """The folded ``InferenceNet`` of ``net``, on the same device."""
    inf = InferenceNet(net.config).to(next(net.parameters()).device)
    inf.load_state_dict(fold_bn_params(net))
    return inf.eval()


@torch.no_grad()
def init_net(
    config: NetConfig, generator: torch.Generator, device: DeviceLike = None
) -> Connect4Net:
    """A freshly initialised net with Flax's defaults: LeCun-normal
    (truncated) kernels, zero biases, BatchNorm scale 1 / bias 0, running
    mean 0 / variance 1. The draws come from ``generator`` (a CPU
    generator, so that a seed gives the same net on every device)."""
    net = Connect4Net(config)
    for module in net.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = w[0].numel()  # OIHW: Cin*kh*kw; Linear [out, in]: in
            # Flax lecun_normal: variance_scaling(1, fan_in, truncated_normal)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
    return net.to(resolve_device(device)).eval()


def count_params(net: nn.Module) -> int:
    """Trainable parameters (BatchNorm running statistics excluded, as
    Flax keeps them in ``batch_stats``)."""
    return sum(p.numel() for p in net.parameters())


__all__ = [
    "Connect4Net",
    "InferenceNet",
    "count_params",
    "fold_bn_params",
    "inference_net",
    "init_net",
    "lrelu",
]
