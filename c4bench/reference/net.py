"""The value and policy net, its loss and its SGD step, in plain PyTorch.

Written from the published architecture of the oinkoink net
(willis-richard/connect4, ``oinkoink/neural/pytorch/net.py``): a 3x3 conv
block and ``n_residuals`` residual blocks of ``filters`` channels, each conv
followed by BatchNorm and a leaky ReLU (slope 0.01); a value head of a 1x1
conv to one channel, BatchNorm, leaky ReLU, ``n_fc_layers`` Dense layers of
42 with no activation between them, a leaky ReLU, a Dense to one output and
``(tanh + 1) / 2``; a policy head of a 1x1 conv to two channels, BatchNorm,
leaky ReLU and a Dense to 7 under a softmax. The heads flatten their conv
output in (row, column, channel) order. BatchNorm's epsilon is 1e-5; in
training it normalises by the batch's mean and biased variance.

Weights are a dict of tensors under the names of ``param_shapes``; nothing
here reads the program. ``precision`` is ``"f32"`` (IEEE float32: TF32 must
be off, see ``full_float32``) or ``"fp8"``, the control: every conv and
Dense input and weight rounded to float8 e4m3 with a per-tensor scale that
maps its largest magnitude to 448, products summed in float32; backward,
each product's output gradient and each gradient its inputs pass back
rounded to float8 e5m2 with such a scale, as float8 training does.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

SLOPE = 0.01
EPS = 1e-5
CELLS = 42
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0

Weights = Dict[str, torch.Tensor]


def full_float32() -> None:
    """float32 products and sums on the card as on the CPU (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def param_shapes(net: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every weight and statistic of the net described by ``net`` (the
    configuration's ``net`` object), in a fixed order."""
    c, f = net["channels"], net["filters"]
    out: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()

    def conv(name, cin, cout, k, bias):
        out[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            out[f"{name}.bias"] = (cout,)

    def bn(name, ch):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (ch,)

    conv("conv_block.conv", c, f, 3, False)
    bn("conv_block.bn", f)
    for i in range(net["n_residuals"]):
        conv(f"res_blocks.{i}.conv0", f, f, 3, False)
        bn(f"res_blocks.{i}.bn0", f)
        conv(f"res_blocks.{i}.conv1", f, f, 3, False)
        bn(f"res_blocks.{i}.bn1", f)
    conv("value_head.conv", f, 1, 1, True)
    bn("value_head.bn", 1)
    for i in range(net["n_fc_layers"]):
        out[f"value_head.fcs.{i}.weight"] = (CELLS, CELLS)
        out[f"value_head.fcs.{i}.bias"] = (CELLS,)
    out["value_head.out.weight"] = (1, CELLS)
    out["value_head.out.bias"] = (1,)
    conv("policy_head.conv", f, 2, 1, True)
    bn("policy_head.bn", 2)
    out["policy_head.fc.weight"] = (7, 2 * CELLS)
    out["policy_head.fc.bias"] = (7,)
    return out


def trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with a per-tensor scale that
    maps its largest magnitude to ``top``."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """Forward: ``x`` in float8 e4m3. Backward: the incoming gradient in
    float8 e5m2, as float8 training keeps gradients."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, FP8_E5M2_MAX)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


class _GradFp8(torch.autograd.Function):
    """Identity forward; the gradient of a product's output in float8 e5m2
    backward, which both of its gradient products then take."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, FP8_E5M2_MAX)


def _lrelu(x):
    return torch.where(x >= 0, x, x * SLOPE)


class _Net:
    def __init__(self, w: Weights, precision: str, train: bool):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.w, self.train = w, train
        same = lambda x: x  # noqa: E731
        self.q = _fp8 if precision == "fp8" else same
        self.g = _GradFp8.apply if precision == "fp8" else same

    def conv(self, x, name, pad):
        bias = self.w.get(f"{name}.bias")
        return self.g(F.conv2d(self.q(x), self.q(self.w[f"{name}.weight"]), bias, padding=pad))

    def dense(self, x, name):
        return self.g(F.linear(self.q(x), self.q(self.w[f"{name}.weight"]), self.w[f"{name}.bias"]))

    def bn(self, x, name):
        w = self.w
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        else:
            mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
        scale = w[f"{name}.weight"] / torch.sqrt(var + EPS)
        return (x - mean[None, :, None, None]) * scale[None, :, None, None] + w[f"{name}.bias"][None, :, None, None]

    def block(self, x, conv, bn):
        return _lrelu(self.bn(self.conv(x, conv, 1), bn))

    def __call__(self, planes: torch.Tensor, n_res: int, n_fc: int):
        x = self.block(planes, "conv_block.conv", "conv_block.bn")
        for i in range(n_res):
            y = self.block(x, f"res_blocks.{i}.conv0", f"res_blocks.{i}.bn0")
            y = self.bn(self.conv(y, f"res_blocks.{i}.conv1", 1), f"res_blocks.{i}.bn1")
            x = _lrelu(y + x)
        n = x.shape[0]
        v = _lrelu(self.bn(self.conv(x, "value_head.conv", 0), "value_head.bn"))
        v = v.permute(0, 2, 3, 1).reshape(n, -1)
        for i in range(n_fc):
            v = self.dense(v, f"value_head.fcs.{i}")
        v = self.dense(_lrelu(v), "value_head.out")
        value = (torch.tanh(v[:, 0]) + 1.0) * 0.5
        p = _lrelu(self.bn(self.conv(x, "policy_head.conv", 0), "policy_head.bn"))
        p = p.permute(0, 2, 3, 1).reshape(n, -1)
        prior = torch.softmax(self.dense(p, "policy_head.fc"), dim=-1)
        return value, prior


def forward(w: Weights, net: dict, planes: torch.Tensor, precision: str = "f32", train: bool = False):
    """``(value [N] in [0, 1], prior [N, 7])`` of float32 NCHW ``planes``
    ``[N, 3, 6, 7]``; ``train`` normalises by the batch's statistics."""
    return _Net(w, precision, train)(planes.float(), net["n_residuals"], net["n_fc_layers"])


@torch.no_grad()
def evaluate(w: Weights, net: dict, planes: torch.Tensor, precision: str = "f32", block: int = 4096):
    """``forward`` in inference, in blocks of ``block`` boards."""
    vs, ps = [], []
    for i in range(0, planes.shape[0], block):
        v, p = forward(w, net, planes[i:i + block], precision)
        vs.append(v)
        ps.append(p)
    return torch.cat(vs), torch.cat(ps)


def sample_losses(w: Weights, net: dict, planes, values, policies, precision: str = "f32") -> torch.Tensor:
    """Each row's share of ``loss``, times the number of rows: its squared
    value error plus the mean binary cross-entropy of its seven prior
    probabilities against its policy targets, each logarithm clamped at
    -100, in training mode (BatchNorm over all the rows)."""
    value, prior = forward(w, net, planes, precision, train=True)
    log_p = torch.clamp(torch.log(prior), min=-100.0)
    log_q = torch.clamp(torch.log1p(-prior), min=-100.0)
    bce = -(policies * log_p + (1.0 - policies) * log_q).mean(1)
    return (value - values) ** 2 + bce


def loss(w: Weights, net: dict, planes, values, policies, precision: str = "f32") -> torch.Tensor:
    """Mean squared value error plus the mean binary cross-entropy of the
    prior probabilities against the policy targets, in training mode."""
    return sample_losses(w, net, planes, values, policies, precision).mean()


def sgd_steps(w0: Weights, net: dict, batches: Sequence[tuple], lr: float, momentum: float,
              weight_decay: float, precision: str = "f32") -> Tuple[List[float], Weights, Weights, Weights]:
    """SGD with momentum and coupled weight decay on every trainable leaf
    over ``batches`` of ``(planes, values, policies)``. Returns each step's
    loss, the first gradient as the optimizer takes it (gradient plus
    ``weight_decay`` times the weight), the gradient alone, and the
    trainable leaves after the last step."""
    names = [k for k in w0 if trainable(k)]
    params = {k: w0[k].detach().clone().float() for k in names}
    fixed = {k: v for k, v in w0.items() if not trainable(k)}
    buf: Weights = {}
    losses, first, grad0 = [], {}, {}
    for i, (planes, values, policies) in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        total = loss({**fixed, **leaves}, net, planes.float(), values.float(), policies.float(), precision)
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        losses.append(float(total.detach()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                d = g + weight_decay * params[k]
                if i == 0:
                    first[k], grad0[k] = d.clone(), g.clone()
                    buf[k] = d
                else:
                    buf[k] = momentum * buf[k] + d
                params[k] = (params[k] - lr * buf[k]).detach()
    return losses, first, grad0, params
