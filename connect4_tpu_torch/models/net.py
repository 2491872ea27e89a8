"""Value+policy network in PyTorch.

The counterpart of ``connect4_tpu.models.net``: a conv+BN tower with
residual blocks over the 3x(6x7) input planes, a value head mapping to
[0, 1] via tanh, and a policy head emitting a softmax over the 7 columns.
The public forward takes NHWC ``[N, 6, 7, channels]`` planes, as the JAX
package does; inside, the tower runs on ``[N, channels, 6, 7]`` tensors, and
``nchw=True`` hands it the stored planes in that form as they are.

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
- Under data parallelism (``forward(..., mesh=...)`` in training mode on
  more than one rank) BatchNorm takes the mean and variance of the
  *global* batch, as the JAX package's partitioner does: the per-channel
  sum is all-reduced first, then the sum of squared deviations from the
  global mean, both with a gradient (``parallel.mesh.all_reduce_with_grad``;
  ``nn.SyncBatchNorm`` refuses CPU tensors). Every rank holds the same
  number of rows.
- On the card in training mode on one rank, each BatchNorm with the
  LeakyReLU after it (and a residual block's skip add) is one hand-written
  kernel pair a direction (``models.batch_norm``) over NHWC activations, and
  the tower's activations stay ``channels_last`` from the input planes to
  the heads, so that cuDNN's convolutions take and give NHWC with no
  transposes; the heads' 1x1 convs are products of the tower's rows with
  their kernels. The pair writes each activation once in the compute dtype,
  what the next conv takes, and, where a skip follows, once in float32, the
  residual stream. CPU tensors, eval mode and the data-parallel BatchNorm
  keep ``_bn`` and ``lrelu``.

An ``SENetConfig`` builds Leela Chess Zero's squeeze-and-excitation body
(lczero-training ``tf/tfprocess.py``) under the same heads: ReLU wherever
the body has an activation, and in each residual block, after the second
BatchNorm (no activation there), ``se_gate``: the mean of each channel over
the board's 42 cells, a Dense layer of ``filters // se_ratio`` with ReLU, a
Dense layer of ``2 * filters`` split into gammas and then shifts, and
``relu(sigmoid(gamma) * y + shift + skip)`` (``models.se_gate``: a
hand-written kernel a direction on the card, its plain version on the
CPU). The gate runs in float32 on every path (it is per board, so data
parallelism adds no all-reduce); on the fused path the second BatchNorm
hands it its float32 output.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from connect4_tpu_torch.config import NetConfig, SENetConfig
from connect4_tpu_torch.models import batch_norm
from connect4_tpu_torch.models.se_gate import se_gate
from connect4_tpu_torch.types import AREA, WIDTH
from connect4_tpu_torch.utils import DeviceLike, resolve_device

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * LEAKY_SLOPE)


# the body's activation after a BatchNorm, by name (``batch_norm.ACTS``)
_ACTS = {"leaky": lrelu, "relu": torch.relu, "none": lambda x: x}


def is_se(config: NetConfig) -> bool:
    """Whether ``config`` builds the squeeze-and-excitation body."""
    return isinstance(config, SENetConfig)


def body_act(config: NetConfig) -> str:
    """The body's activation: ReLU in the squeeze-and-excitation body,
    LeakyReLU in the ResNet's."""
    return "relu" if is_se(config) else "leaky"


def compute_dtype(config: NetConfig) -> torch.dtype:
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype, fused: bool = False) -> torch.Tensor:
    """The conv in ``dtype``; ``fused`` (``_fused``) casts its weight to
    ``channels_last`` as the fused path's activations are."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    weight = conv.weight.to(dtype, memory_format=torch.channels_last) if fused else conv.weight.to(dtype)
    return F.conv2d(x.to(dtype), weight, bias, padding=conv.padding)


def _dense(x: torch.Tensor, fc: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype))


BN_MOMENTUM = 0.9  # Flax's convention: the weight of the old running value


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d, mesh=None) -> torch.Tensor:
    """BatchNorm in float32 on the conv's output (bf16 or float32); in
    training mode over the global batch of ``mesh``'s ranks."""
    x = x.float()
    if not bn.training:
        return F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
            training=False, eps=BN_EPS,
        )
    if mesh is not None and mesh.world_size > 1:
        return _bn_global(x, bn, mesh)
    # With momentum 1 the fused op leaves the batch mean and the unbiased
    # batch variance in the two scratch buffers, at no extra pass over x.
    mean, var = torch.zeros_like(bn.running_mean), torch.zeros_like(bn.running_var)
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, training=True, momentum=1.0, eps=BN_EPS)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=(1.0 - BN_MOMENTUM) * (n - 1) / n)
    return y


def _bn_global(x: torch.Tensor, bn: nn.BatchNorm2d, mesh) -> torch.Tensor:
    """Training-mode BatchNorm with the statistics of every rank's rows:
    the global mean from the all-reduced per-channel sum, then the global
    biased variance from the all-reduced sum of squared deviations from it
    (two passes, as a single-device batch computes them)."""
    from connect4_tpu_torch.parallel.mesh import all_reduce_with_grad

    n = x.numel() // x.shape[1] * mesh.world_size
    mean = all_reduce_with_grad(x.sum(dim=(0, 2, 3)), mesh) / n
    d = x - mean[None, :, None, None]
    var = all_reduce_with_grad((d * d).sum(dim=(0, 2, 3)), mesh) / n
    scale = bn.weight * torch.rsqrt(var + BN_EPS)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
    return d * scale[None, :, None, None] + bn.bias[None, :, None, None]


def _fused(planes: torch.Tensor, training: bool, mesh) -> bool:
    """Whether the net's BatchNorms run as the fused kernel pair: on the
    card, in training mode, on one rank."""
    return planes.device.type == "cuda" and training and (mesh is None or mesh.world_size == 1)


def _bn_act(x: torch.Tensor, bn: nn.BatchNorm2d, mesh=None, fused: bool = False, skip=None, stream: bool = False,
            act: str = "leaky"):
    """``act(BatchNorm(x) + skip)`` as ``(y, y_stream)`` (``act`` LeakyReLU,
    ReLU or none): ``y`` what the next conv takes, ``y_stream`` the float32
    activation where ``stream`` asks for it (a skip or the gate follows).
    ``fused`` runs ``batch_norm_act``; otherwise both are the float32
    ``act(_bn(x) + skip)``."""
    if fused:
        return batch_norm.batch_norm_act_unchecked(x, bn, skip, stream, act=act)
    y = _bn(x, bn, mesh)
    y = _ACTS[act](y if skip is None else y + skip)
    return y, y


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, H*W*C] in Flax's (row, col, channel) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, filters: int, act: str = "leaky"):
        super().__init__()
        self.conv = nn.Conv2d(cin, filters, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.act = act

    def forward(self, x, dtype, mesh=None, fused=False, stream=False):
        """``(conv input, float32 stream)`` of the tower's first layer."""
        return _bn_act(_conv(x, self.conv, dtype, fused), self.bn, mesh, fused, stream=stream, act=self.act)


class _ResidualBlock(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.conv0 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters, eps=BN_EPS)

    def forward(self, x, dtype, mesh=None, fused=False, stream=False):
        """``x`` = (conv input, float32 stream) -> the same of the block's
        output."""
        x, skip = x
        y, _ = _bn_act(_conv(x, self.conv0, dtype, fused), self.bn0, mesh, fused)
        return _bn_act(_conv(y, self.conv1, dtype, fused), self.bn1, mesh, fused, skip=skip, stream=stream)


class _SqueezeExcitation(nn.Module):
    """The gate's two Dense layers: ``filters`` -> ``filters // se_ratio``
    -> ``2 * filters`` (gammas, then shifts)."""

    def __init__(self, filters: int, se_ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(filters, filters // se_ratio)
        self.fc2 = nn.Linear(filters // se_ratio, 2 * filters)


class _SEResidualBlock(nn.Module):
    """lc0's residual block: conv, BatchNorm, ReLU, conv, BatchNorm, then
    ``se_gate`` with the block's input as the skip."""

    def __init__(self, filters: int, se_ratio: int):
        super().__init__()
        self.conv0 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.conv1 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.se = _SqueezeExcitation(filters, se_ratio)

    def forward(self, x, dtype, mesh=None, fused=False, stream=False):
        """``x`` = (conv input, float32 stream) -> the same of the block's
        output (the stream is the gate's float32 output either way)."""
        x, skip = x
        y, _ = _bn_act(_conv(x, self.conv0, dtype, fused), self.bn0, mesh, fused, act="relu")
        _, y = _bn_act(_conv(y, self.conv1, dtype, fused), self.bn1, mesh, fused, stream=True, act="none")
        se = self.se
        out, out_c = se_gate(y, skip, se.fc1.weight, se.fc1.bias, se.fc2.weight, se.fc2.bias, dtype)
        return out_c, out


def _head_bn_act(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype, mesh, fused) -> torch.Tensor:
    """A head's 1x1 conv, BatchNorm and LeakyReLU, flattened to
    ``[N, H*W*C]`` in Flax's order. On the fused path the 1x1 conv is the
    product of the ``channels_last`` tower output's ``[N*H*W, F]`` rows
    with the ``[F, C]`` kernel, so its ``[N*H*W, C]`` output is already the
    matrix ``batch_norm_act`` takes and its flattening a view (cuDNN's NHWC
    convolutions pad and transpose C = 1 and 2)."""
    if not fused:
        return _flatten_nhwc(_bn_act(_conv(x, conv, dtype), bn, mesh)[0])
    rows = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    y = F.linear(rows.to(dtype), conv.weight.reshape(conv.out_channels, -1).to(dtype), conv.bias.to(dtype))
    return batch_norm.batch_norm_act_unchecked(y, bn)[0].reshape(x.shape[0], -1)


class _ValueHead(nn.Module):
    def __init__(self, filters: int, n_fc_layers: int):
        super().__init__()
        self.conv = nn.Conv2d(filters, 1, 1)
        self.bn = nn.BatchNorm2d(1, eps=BN_EPS)
        self.fcs = nn.ModuleList([nn.Linear(AREA, AREA) for _ in range(n_fc_layers)])
        self.out = nn.Linear(AREA, 1)

    def forward(self, x, dtype, mesh=None, fused=False):
        x = _head_bn_act(x, self.conv, self.bn, dtype, mesh, fused)
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

    def forward(self, x, dtype, mesh=None, fused=False):
        x = _head_bn_act(x, self.conv, self.bn, dtype, mesh, fused)
        return torch.softmax(_dense(x, self.fc, dtype).float(), dim=-1)


class Connect4Net(nn.Module):
    """Value+policy tower. Input: NHWC ``[N, 6, 7, channels]`` float planes
    (or NCHW ``[N, channels, 6, 7]`` with ``nchw=True``). Returns
    ``(value [N] in [0,1], prior [N,7] summing to 1)``. In training mode a
    ``mesh`` (``parallel.mesh.Mesh``) makes every BatchNorm take the
    statistics of all its ranks' rows. On the card in training mode on one
    rank the tower runs ``channels_last`` through ``batch_norm_act``."""

    def __init__(self, config: NetConfig):
        super().__init__()
        self.config = config
        f = config.filters
        self.conv_block = _ConvBlock(config.channels, f, body_act(config))
        block = (lambda: _SEResidualBlock(f, config.se_ratio)) if is_se(config) else (lambda: _ResidualBlock(f))
        self.res_blocks = nn.ModuleList([block() for _ in range(config.n_residuals)])
        self.value_head = _ValueHead(f, config.n_fc_layers)
        self.policy_head = _PolicyHead(f)

    def forward(self, planes: torch.Tensor, nchw: bool = False, mesh=None):
        dtype = compute_dtype(self.config)
        fused = _fused(planes, self.training, mesh)
        x = planes if nchw else planes.permute(0, 3, 1, 2)
        if fused:
            x = x.contiguous(memory_format=torch.channels_last)
        n = len(self.res_blocks)
        x = self.conv_block(x, dtype, mesh, fused, stream=n > 0)
        for i, blk in enumerate(self.res_blocks):
            x = blk(x, dtype, mesh, fused, stream=i + 1 < n)
        x = x[0]
        return self.value_head(x, dtype, mesh, fused), self.policy_head(x, dtype, mesh, fused)


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
    bias included. The squeeze-and-excitation body's gate runs in float32
    (``se_gate``) on the folded second conv's output."""

    def __init__(self, config: NetConfig):
        super().__init__()
        self.config = config
        f = config.filters
        self.conv0 = nn.Conv2d(config.channels, f, 3, padding=1)
        self.res = nn.ModuleList(
            [nn.Conv2d(f, f, 3, padding=1) for _ in range(2 * config.n_residuals)]
        )
        if is_se(config):
            s = f // config.se_ratio
            self.se_fc1 = nn.ModuleList([nn.Linear(f, s) for _ in range(config.n_residuals)])
            self.se_fc2 = nn.ModuleList([nn.Linear(s, 2 * f) for _ in range(config.n_residuals)])
        self.vh_conv = nn.Conv2d(f, 1, 1)
        self.vh_fcs = nn.ModuleList(
            [nn.Linear(AREA, AREA) for _ in range(config.n_fc_layers)]
        )
        self.vh_out = nn.Linear(AREA, 1)
        self.ph_conv = nn.Conv2d(f, 2, 1)
        self.ph_fc = nn.Linear(AREA * 2, WIDTH)

    def forward(self, nhwc: torch.Tensor):
        dt = compute_dtype(self.config)
        act = _ACTS[body_act(self.config)]
        x = act(_conv(nhwc.permute(0, 3, 1, 2), self.conv0, dt))
        for i in range(self.config.n_residuals):
            y = act(_conv(x, self.res[2 * i], dt))
            if is_se(self.config):
                fc1, fc2 = self.se_fc1[i], self.se_fc2[i]
                x = se_gate(_conv(y, self.res[2 * i + 1], dt), x, fc1.weight, fc1.bias, fc2.weight, fc2.bias, dt)[1]
            else:
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
        if is_se(net.config):
            put(f"se_fc1.{i}", (blk.se.fc1.weight, blk.se.fc1.bias))
            put(f"se_fc2.{i}", (blk.se.fc2.weight, blk.se.fc2.bias))
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
    "is_se",
    "lrelu",
    "se_gate",
]
