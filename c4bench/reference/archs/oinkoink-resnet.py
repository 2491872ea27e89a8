"""The oinkoink value and policy ResNet: its leaves, its forward body and
its operation counts, in plain PyTorch.

Written from the published architecture of the oinkoink net
(willis-richard/connect4, ``oinkoink/neural/pytorch/net.py``): a 3x3 conv
block and ``n_residuals`` residual blocks of ``filters`` channels, each conv
followed by BatchNorm and a leaky ReLU (slope 0.01); a value head of a 1x1
conv to one channel, BatchNorm, leaky ReLU, ``n_fc_layers`` Dense layers of
42 with no activation between them, a leaky ReLU, a Dense to one output and
``(tanh + 1) / 2``; a policy head of a 1x1 conv to two channels, BatchNorm,
leaky ReLU and a Dense to 7 under a softmax. The heads flatten their conv
output in (row, column, channel) order.

The counts are a frozen copy of the arithmetic of the program's tower bound
(``connect4_tpu_torch.models.tower.tower_bound``): every multiply-add of the
convolutions on the 42 cells of a board counts two operations, at the
configuration's own widths, whatever padding or batching the program uses.
The heads add their 1x1 convolutions and Dense layers.
"""

from __future__ import annotations

import torch

from c4bench.reference.net import CELLS, Leaves

SLOPE = 0.01
KEYS = ("channels", "filters", "n_residuals", "n_fc_layers", "compute_dtype")


def leaves(net: dict) -> Leaves:
    c, f = net["channels"], net["filters"]
    out = Leaves()
    out.conv("conv_block.conv", c, f, 3, False)
    out.bn("conv_block.bn", f)
    for i in range(net["n_residuals"]):
        out.conv(f"res_blocks.{i}.conv0", f, f, 3, False)
        out.bn(f"res_blocks.{i}.bn0", f)
        out.conv(f"res_blocks.{i}.conv1", f, f, 3, False)
        out.bn(f"res_blocks.{i}.bn1", f)
    out.conv("value_head.conv", f, 1, 1, True)
    out.bn("value_head.bn", 1)
    for i in range(net["n_fc_layers"]):
        out.dense(f"value_head.fcs.{i}", CELLS, CELLS)
    out.dense("value_head.out", CELLS, 1)
    out.conv("policy_head.conv", f, 2, 1, True)
    out.bn("policy_head.bn", 2)
    out.dense("policy_head.fc", 2 * CELLS, 7)
    return out


def _lrelu(x):
    return torch.where(x >= 0, x, x * SLOPE)


def _block(ops, x, conv, bn):
    return _lrelu(ops.bn(ops.conv(x, conv, 1), bn))


def body(ops, planes: torch.Tensor, net: dict):
    x = _block(ops, planes, "conv_block.conv", "conv_block.bn")
    for i in range(net["n_residuals"]):
        y = _block(ops, x, f"res_blocks.{i}.conv0", f"res_blocks.{i}.bn0")
        y = ops.bn(ops.conv(y, f"res_blocks.{i}.conv1", 1), f"res_blocks.{i}.bn1")
        x = _lrelu(y + x)
    n = x.shape[0]
    v = _lrelu(ops.bn(ops.conv(x, "value_head.conv", 0), "value_head.bn"))
    v = v.permute(0, 2, 3, 1).reshape(n, -1)
    for i in range(net["n_fc_layers"]):
        v = ops.dense(v, f"value_head.fcs.{i}")
    v = ops.dense(_lrelu(v), "value_head.out")
    value = (torch.tanh(v[:, 0]) + 1.0) * 0.5
    p = _lrelu(ops.bn(ops.conv(x, "policy_head.conv", 0), "policy_head.bn"))
    p = p.permute(0, 2, 3, 1).reshape(n, -1)
    prior = torch.softmax(ops.dense(p, "policy_head.fc"), dim=-1)
    return value, prior


def tower_flops(net: dict) -> int:
    """Operations of the conv tower on one board: the 3x3 input conv and
    two 3x3 convs a residual block."""
    c, f, n = net["channels"], net["filters"], net["n_residuals"]
    return CELLS * 2 * (9 * c * f + 2 * n * 9 * f * f)


def head_flops(net: dict) -> int:
    """Operations of both heads on one board: the value head's 1x1 conv to
    one channel and its Dense layers, the policy head's 1x1 conv to two
    channels and its Dense to 7."""
    f, n_fc = net["filters"], net["n_fc_layers"]
    value = CELLS * 2 * f + n_fc * 2 * CELLS * CELLS + 2 * CELLS
    policy = CELLS * 2 * f * 2 + 2 * (2 * CELLS) * 7
    return value + policy
