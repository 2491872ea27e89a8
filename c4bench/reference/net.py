"""The value and policy net's shared parts, its loss and its SGD step, in
plain PyTorch.

A configuration's ``net`` names its architecture under ``"arch"``
(``"oinkoink-resnet"`` where it names none). The architecture is the file
``c4bench/reference/archs/<arch>.py``, found by that name (``arch``): its
``KEYS`` (the ``net`` keys it reads besides ``arch``), its ``leaves(net)``
(every weight and statistic in order, built with ``Leaves``, which marks
each as a kernel, a bias or a BatchNorm scale, shift or statistic), its
forward ``body(ops, planes, net)`` written with the layers of ``Ops``, and
its operation counts ``tower_flops(net)`` and ``head_flops(net)``. What does
not depend on the architecture is here and dispatches by the name:
``forward``, ``evaluate``, ``sample_losses``, ``loss``, ``sgd_steps`` and
``trainable``.

BatchNorm's epsilon is 1e-5; in training it normalises by the batch's mean
and biased variance. Weights are a dict of tensors under the names of
``leaves``; nothing here reads the program. ``precision`` is ``"f32"``
(IEEE float32: TF32 must be off, see ``full_float32``) or ``"fp8"``, the
control: every conv and Dense input and weight rounded to float8 e4m3 with a
per-tensor scale that maps its largest magnitude to 448, products summed in
float32; backward, each product's output gradient and each gradient its
inputs pass back rounded to float8 e5m2 with such a scale, as float8
training does. Every architecture's body gets both through ``Ops``.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Sequence, Set, Tuple

import torch
import torch.nn.functional as F

from c4bench import plugins

EPS = 1e-5
CELLS = 42
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0
DEFAULT_ARCH = "oinkoink-resnet"
ARCHS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "archs")
# the kinds of leaf, which ``make_weights`` draws each in its own way
KERNEL, BIAS, BN_SCALE, BN_SHIFT, BN_MEAN, BN_VAR = "kernel", "bias", "bn_scale", "bn_shift", "bn_mean", "bn_var"
STATISTICS = (BN_MEAN, BN_VAR)

Weights = Dict[str, torch.Tensor]


def full_float32() -> None:
    """float32 products and sums on the card as on the CPU (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def arch_name(net: dict) -> str:
    return net.get("arch", DEFAULT_ARCH)


def arch(net: dict):
    """The reference file of ``net``'s architecture, ``ARCHS/<arch>.py``;
    exits where there is none, or where ``net`` has keys the architecture
    does not read or lacks keys it does."""
    name = arch_name(net)
    module = plugins.load(os.path.join(ARCHS, f"{name}.py"), f"reference of architecture {name!r}")
    keys = set(net) - {"arch"}
    if keys != set(module.KEYS):
        raise SystemExit(f"c4bench: architecture {name!r} reads {sorted(module.KEYS)}; the net has {sorted(keys)}")
    return module


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    kind: str


class Leaves(OrderedDict):
    """An architecture's weights and statistics in a fixed order, each name
    with its ``Leaf``: its shape and its kind."""

    def conv(self, name: str, cin: int, cout: int, k: int, bias: bool) -> None:
        self[f"{name}.weight"] = Leaf((cout, cin, k, k), KERNEL)
        if bias:
            self[f"{name}.bias"] = Leaf((cout,), BIAS)

    def dense(self, name: str, cin: int, cout: int) -> None:
        self[f"{name}.weight"] = Leaf((cout, cin), KERNEL)
        self[f"{name}.bias"] = Leaf((cout,), BIAS)

    def bn(self, name: str, ch: int) -> None:
        for leaf, kind in (("weight", BN_SCALE), ("bias", BN_SHIFT), ("running_mean", BN_MEAN),
                           ("running_var", BN_VAR)):
            self[f"{name}.{leaf}"] = Leaf((ch,), kind)


def leaves(net: dict) -> Leaves:
    """Every weight and statistic of the net described by ``net`` (the
    configuration's ``net`` object), in a fixed order, with its kind."""
    return arch(net).leaves(net)


def trainable(net: dict) -> Set[str]:
    """The names of ``net``'s leaves that SGD moves: all but the BatchNorm
    statistics."""
    return {k for k, leaf in leaves(net).items() if leaf.kind not in STATISTICS}


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


class Ops:
    """The layers an architecture's body is written with, over the weights
    ``w`` by name, in ``precision``, with BatchNorm in training or inference."""

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


def forward(w: Weights, net: dict, planes: torch.Tensor, precision: str = "f32", train: bool = False):
    """``(value [N] in [0, 1], prior [N, 7])`` of float32 NCHW ``planes``
    ``[N, 3, 6, 7]``; ``train`` normalises by the batch's statistics."""
    return arch(net).body(Ops(w, precision, train), planes.float(), net)


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
    moved = trainable(net)
    names = [k for k in w0 if k in moved]
    params = {k: w0[k].detach().clone().float() for k in names}
    fixed = {k: v for k, v in w0.items() if k not in moved}
    buf: Weights = {}
    losses, first, grad0 = [], {}, {}
    for i, (planes, values, policies) in enumerate(batches):
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        total = loss({**fixed, **live}, net, planes.float(), values.float(), policies.float(), precision)
        grads = torch.autograd.grad(total, [live[k] for k in names])
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
