"""Leela Chess Zero's squeeze-and-excitation residual body under the
oinkoink heads, in plain PyTorch and float32: the yardstick the port's
squeeze-and-excitation net (``config.SENetConfig``) is held to, in eval and
in training. It imports nothing of the port and no JAX, and turns TF32 off
(``full_float32``) before it computes anything.

Written from lczero-training ``tf/tfprocess.py`` (``conv_block``,
``residual_block``, ``squeeze_excitation``, ``ApplySqueezeExcitation``):

    input:  x0 = ReLU(BN(conv3x3(planes)))
    block:  h  = ReLU(BN0(conv3x3(x)))
            y  = BN1(conv3x3(h))
            s  = mean of y over the 42 cells                 [N, C]
            z  = ReLU(W1 s + b1)                              [N, C/r]
            e  = W2 z + b2                                    [N, 2C]
            g, b = e[:, :C], e[:, C:]                         (gammas first)
            out = ReLU(sigmoid(g) * y + b + x)

Where this departs from lc0, as the port does:

- The heads are oinkoink's (willis-richard/connect4: a 1x1 conv to one
  channel, BatchNorm, LeakyReLU(0.01), ``n_fc_layers`` Dense layers of 42
  with no activation between them, LeakyReLU, a Dense to 1 and ``(tanh +
  1) / 2``; a 1x1 conv to two channels, BatchNorm, LeakyReLU and a Dense to
  7 under a softmax; both flattened in (row, column, channel) order).
  lc0's heads are chess heads (a 1,858-move policy, a WDL value).
- ``se_ratio`` is the configuration's (8 at 256 filters): lc0 sets it per
  training run.
- Every BatchNorm keeps a learned scale; lc0 fixes it at 1 where a ReLU
  follows (``scale=False``). At inference the scale folds into the conv.
- The loss is the port's (``training.learner.loss_fn``): the mean squared
  value error plus the mean binary cross-entropy of the seven prior
  probabilities against their targets, each logarithm clamped at -100; SGD
  with momentum and coupled weight decay on every weight but the
  BatchNorm statistics (lc0 also regularises the gate's Dense kernels,
  which coupled decay does too).

Weights are a dict of float32 tensors under the port's state-dict names
(``leaves``). In training BatchNorm normalises by the batch's mean and
biased variance, epsilon 1e-5, and moves no running statistics.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
CELLS = 42
SLOPE = 0.01  # the heads' LeakyReLU

Weights = Dict[str, torch.Tensor]


def full_float32() -> None:
    """float32 products and sums on the card as on the CPU (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def leaves(channels: int, filters: int, n_residuals: int, n_fc_layers: int, se_ratio: int) -> "OrderedDict[str, tuple]":
    """Every weight and BatchNorm statistic by name, with its shape, in the
    order of the port's ``Connect4Net.state_dict`` (its BatchNorm counters
    left out)."""
    out: "OrderedDict[str, tuple]" = OrderedDict()

    def bn(name, ch):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (ch,)

    def dense(name, cin, cout):
        out[f"{name}.weight"] = (cout, cin)
        out[f"{name}.bias"] = (cout,)

    f, sq = filters, filters // se_ratio
    out["conv_block.conv.weight"] = (f, channels, 3, 3)
    bn("conv_block.bn", f)
    for i in range(n_residuals):
        out[f"res_blocks.{i}.conv0.weight"] = (f, f, 3, 3)
        bn(f"res_blocks.{i}.bn0", f)
        out[f"res_blocks.{i}.conv1.weight"] = (f, f, 3, 3)
        bn(f"res_blocks.{i}.bn1", f)
        dense(f"res_blocks.{i}.se.fc1", f, sq)
        dense(f"res_blocks.{i}.se.fc2", sq, 2 * f)
    out["value_head.conv.weight"] = (1, f, 1, 1)
    out["value_head.conv.bias"] = (1,)
    bn("value_head.bn", 1)
    for i in range(n_fc_layers):
        dense(f"value_head.fcs.{i}", CELLS, CELLS)
    dense("value_head.out", CELLS, 1)
    out["policy_head.conv.weight"] = (2, f, 1, 1)
    out["policy_head.conv.bias"] = (2,)
    bn("policy_head.bn", 2)
    dense("policy_head.fc", 2 * CELLS, 7)
    return out


def _bn(w: Weights, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
    scale = w[f"{name}.weight"] / torch.sqrt(var + EPS)
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] + w[f"{name}.bias"][None, :, None, None]


def _conv(w: Weights, name: str, x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.conv2d(x, w[f"{name}.weight"], w.get(f"{name}.bias"), padding=pad)


def _dense(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * SLOPE)


def squeeze_excitation(w: Weights, name: str, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """lc0's gate and the block's end: ``relu(sigmoid(g) * y + b + x)``."""
    c = y.shape[1]
    z = torch.relu(_dense(w, f"{name}.fc1", y.mean(dim=(2, 3))))
    gamma, shift = _dense(w, f"{name}.fc2", z).split(c, dim=1)
    return torch.relu(torch.sigmoid(gamma)[:, :, None, None] * y + shift[:, :, None, None] + x)


def forward(w: Weights, planes: torch.Tensor, n_residuals: int, n_fc_layers: int, train: bool = False):
    """``(value [N] in [0, 1], prior [N, 7])`` of float NCHW ``planes``
    ``[N, 3, 6, 7]``; ``train`` normalises by the batch's statistics."""
    full_float32()
    x = torch.relu(_bn(w, "conv_block.bn", _conv(w, "conv_block.conv", planes.float(), 1), train))
    for i in range(n_residuals):
        p = f"res_blocks.{i}"
        h = torch.relu(_bn(w, f"{p}.bn0", _conv(w, f"{p}.conv0", x, 1), train))
        y = _bn(w, f"{p}.bn1", _conv(w, f"{p}.conv1", h, 1), train)
        x = squeeze_excitation(w, f"{p}.se", y, x)
    n = x.shape[0]
    v = _lrelu(_bn(w, "value_head.bn", _conv(w, "value_head.conv", x, 0), train))
    v = v.permute(0, 2, 3, 1).reshape(n, -1)
    for i in range(n_fc_layers):
        v = _dense(w, f"value_head.fcs.{i}", v)
    v = _dense(w, "value_head.out", _lrelu(v))
    value = (torch.tanh(v[:, 0]) + 1.0) * 0.5
    p = _lrelu(_bn(w, "policy_head.bn", _conv(w, "policy_head.conv", x, 0), train))
    p = p.permute(0, 2, 3, 1).reshape(n, -1)
    prior = torch.softmax(_dense(w, "policy_head.fc", p), dim=-1)
    return value, prior


def loss(w: Weights, planes, values, policies, n_residuals: int, n_fc_layers: int) -> torch.Tensor:
    """The port's training loss in training mode: mean squared value error
    plus the mean binary cross-entropy of the prior probabilities, each
    logarithm clamped at -100."""
    value, prior = forward(w, planes, n_residuals, n_fc_layers, train=True)
    log_p = torch.clamp(torch.log(prior), min=-100.0)
    log_q = torch.clamp(torch.log1p(-prior), min=-100.0)
    return ((value - values.float()) ** 2).mean() - (policies * log_p + (1.0 - policies) * log_q).mean()


def trainable(w: Weights) -> List[str]:
    """The names SGD moves: all but the BatchNorm statistics."""
    return [k for k in w if not k.endswith(("running_mean", "running_var"))]


def gradients(w: Weights, planes, values, policies, n_residuals: int, n_fc_layers: int) -> Tuple[float, Weights]:
    """``(loss, {name: gradient})`` of every trainable weight."""
    names = trainable(w)
    live = {k: v.detach().clone().float().requires_grad_(k in names) for k, v in w.items()}
    total = loss(live, planes, values, policies, n_residuals, n_fc_layers)
    grads = torch.autograd.grad(total, [live[k] for k in names])
    return float(total.detach()), dict(zip(names, grads))


def sgd_steps(w0: Weights, batches: Sequence[tuple], n_residuals: int, n_fc_layers: int, lr: float,
              momentum: float, weight_decay: float) -> Tuple[List[float], Weights]:
    """SGD with momentum and coupled weight decay (PyTorch's, no dampening)
    over ``batches`` of ``(planes, values, policies)``: each step's loss and
    the weights after the last step."""
    w = {k: v.detach().clone().float() for k, v in w0.items()}
    buf: Weights = {}
    losses = []
    for i, (planes, values, policies) in enumerate(batches):
        total, grads = gradients(w, planes, values, policies, n_residuals, n_fc_layers)
        losses.append(total)
        for k, g in grads.items():
            d = g + weight_decay * w[k]
            buf[k] = d if i == 0 else momentum * buf[k] + d
            w[k] = w[k] - lr * buf[k]
    return losses, w
