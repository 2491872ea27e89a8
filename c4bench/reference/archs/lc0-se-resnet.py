"""Leela Chess Zero's squeeze-and-excitation residual body under the
oinkoink heads: its leaves, its forward body and its operation counts, in
plain PyTorch.

Written from lczero-training ``tf/tfprocess.py`` (``conv_block``,
``residual_block``, ``squeeze_excitation``, ``ApplySqueezeExcitation``): a
3x3 conv block and ``n_residuals`` residual blocks of ``filters``
channels, every activation of the body a ReLU; a block is conv, BatchNorm,
ReLU, conv, BatchNorm, then the gate: the mean of each channel over the 42
cells, a Dense layer to ``filters // se_ratio`` with ReLU, a Dense layer to
``2 * filters`` split into gammas (first) and shifts, and ``relu(sigmoid(
gamma) * y + shift + x)`` with ``x`` the block's input. The heads are the
oinkoink net's (``oinkoink-resnet.py``), as in the program: lc0's are chess
heads. Every BatchNorm has a learned scale (lc0 fixes it at 1 where a ReLU
follows; at inference it folds into the conv). ``se_ratio`` is the
configuration's: lc0 sets it per training run.

The counts: every multiply-add of the convolutions on the 42 cells of a
board and of the gate's two Dense layers once a board counts two
operations, at the configuration's own widths; the heads add their 1x1
convolutions and Dense layers, as the oinkoink net's.
"""

from __future__ import annotations

import torch

from c4bench.reference.net import CELLS, Leaves

SLOPE = 0.01  # the heads' leaky ReLU
KEYS = ("channels", "filters", "n_residuals", "n_fc_layers", "compute_dtype", "se_ratio")


def leaves(net: dict) -> Leaves:
    c, f = net["channels"], net["filters"]
    sq = f // net["se_ratio"]
    out = Leaves()
    out.conv("conv_block.conv", c, f, 3, False)
    out.bn("conv_block.bn", f)
    for i in range(net["n_residuals"]):
        out.conv(f"res_blocks.{i}.conv0", f, f, 3, False)
        out.bn(f"res_blocks.{i}.bn0", f)
        out.conv(f"res_blocks.{i}.conv1", f, f, 3, False)
        out.bn(f"res_blocks.{i}.bn1", f)
        out.dense(f"res_blocks.{i}.se.fc1", f, sq)
        out.dense(f"res_blocks.{i}.se.fc2", sq, 2 * f)
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


def _gate(ops, y, x, name):
    """``relu(sigmoid(gamma) * y + shift + x)`` of lc0's squeeze and
    excitation, ``(gamma, shift)`` from the mean of ``y`` over the cells."""
    z = torch.relu(ops.dense(y.mean(dim=(2, 3)), f"{name}.fc1"))
    gamma, shift = ops.dense(z, f"{name}.fc2").split(y.shape[1], dim=1)
    return torch.relu(torch.sigmoid(gamma)[:, :, None, None] * y + shift[:, :, None, None] + x)


def body(ops, planes: torch.Tensor, net: dict):
    x = torch.relu(ops.bn(ops.conv(planes, "conv_block.conv", 1), "conv_block.bn"))
    for i in range(net["n_residuals"]):
        h = torch.relu(ops.bn(ops.conv(x, f"res_blocks.{i}.conv0", 1), f"res_blocks.{i}.bn0"))
        y = ops.bn(ops.conv(h, f"res_blocks.{i}.conv1", 1), f"res_blocks.{i}.bn1")
        x = _gate(ops, y, x, f"res_blocks.{i}.se")
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
    """Operations of the body on one board: the 3x3 input conv and two 3x3
    convs a residual block on 42 cells, and a block's gate, Dense ``filters
    -> filters // se_ratio`` and ``-> 2 * filters``, once a board."""
    c, f, n = net["channels"], net["filters"], net["n_residuals"]
    sq = f // net["se_ratio"]
    return CELLS * 2 * (9 * c * f + 2 * n * 9 * f * f) + n * 2 * (f * sq + sq * 2 * f)


def head_flops(net: dict) -> int:
    """Operations of both heads on one board, as the oinkoink net's."""
    f, n_fc = net["filters"], net["n_fc_layers"]
    value = CELLS * 2 * f + n_fc * 2 * CELLS * CELLS + 2 * CELLS
    policy = CELLS * 2 * f * 2 + 2 * (2 * CELLS) * 7
    return value + policy


def se_gate_bytes(net: dict) -> int:
    """Bytes the learner's gate must move a board in a train step, forward
    and backward, each once: forward, ``y`` and the block's input in
    float32, the output in float32 and its bf16 copy; backward, the two
    gradients (float32 and bf16), ``y`` and the output, the gradients of
    ``y`` and of the input in float32. The last block's float32 output
    takes no gradient (the heads read the copy): 4 bytes fewer a cell. The
    per-board vectors and the weights are a few KB and left out."""
    f, n = net["filters"], net["n_residuals"]
    per_cell = (4 + 4 + 4 + 2) + (4 + 2 + 4 + 4 + 4 + 4)
    return CELLS * f * (n * per_cell - 4)

