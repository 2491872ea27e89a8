"""Training step: SGD + momentum + weight decay on MSE(value) + BCE(policy).

The counterpart of ``connect4_tpu.training.learner``. The optimiser is
``torch.optim.SGD`` with coupled weight decay (the decay joins the gradient
*before* the momentum buffer) on every parameter, BatchNorm scales and
biases included, which is what the JAX package builds from optax; the
MultiStep learning-rate schedule is applied per *generation* through
``ModelConfig.lr_at_generation`` and ``set_learning_rate``.

Where the JAX step maps a state to a new state, the step here updates the
net and the optimiser in place, as PyTorch does: ``TrainState`` names the
two objects that carry everything across steps. The convolutions and Dense
layers of the training path are library calls under autograd, as they are
XLA's in the JAX package; the hand-written tower kernel serves inference.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from connect4_tpu_torch.config import ModelConfig
from connect4_tpu_torch.models.net import Connect4Net, init_net
from connect4_tpu_torch.utils import DeviceLike


class TrainState(NamedTuple):
    """Everything the learner carries across steps: the net (parameters and
    BatchNorm running statistics) and the optimiser (momentum buffers and
    the learning rate). Steps update both in place."""

    net: Connect4Net
    optimizer: torch.optim.SGD


def make_optimizer(config: ModelConfig, net: Connect4Net) -> torch.optim.SGD:
    return torch.optim.SGD(
        net.parameters(),
        lr=config.initial_lr,
        momentum=config.momentum,
        weight_decay=config.weight_decay,
        dampening=0.0,
        nesterov=False,
    )


def init_train_state(
    config: ModelConfig, generator: torch.Generator, device: DeviceLike = None
) -> TrainState:
    """A freshly initialised net (``init_net``) with its optimiser."""
    net = init_net(config.net_config, generator, device=device)
    return TrainState(net, make_optimizer(config, net))


def set_learning_rate(optimizer: torch.optim.SGD, lr: float) -> torch.optim.SGD:
    """Set the learning rate the next step uses."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def bce_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on probabilities, mean-reduced over
    all elements, with torch ``BCELoss``'s -100 clamp of the logarithms.
    Written out as the JAX package writes it, so that the gradient is also
    the same where a logarithm is clamped (zero there, and undefined at a
    probability of exactly 0 or 1, which a softmax reaches only by
    underflow)."""
    log_p = torch.clamp(torch.log(probs), min=-100.0)
    log_1p = torch.clamp(torch.log1p(-probs), min=-100.0)
    return -torch.mean(targets * log_p + (1.0 - targets) * log_1p)


def loss_fn(
    net: Connect4Net,
    planes: torch.Tensor,
    value_targets: torch.Tensor,
    prior_targets: torch.Tensor,
    value_weights: Optional[torch.Tensor] = None,
    nchw: bool = False,
):
    """``(total, (value_loss, prior_loss, value, prior))`` of the net in
    its current mode (in training mode the forward also moves the running
    statistics)."""
    value, prior = net(planes, nchw=nchw)
    sq = (value - value_targets) ** 2
    if value_weights is None:
        value_loss = sq.mean()
    else:
        # weighted mean with per-batch renormalisation so the loss scale
        # (and therefore the LR) is unchanged whatever the batch's draw mix
        value_loss = (value_weights * sq).sum() / value_weights.sum()
    prior_loss = bce_loss(prior, prior_targets)
    return value_loss + prior_loss, (value_loss, prior_loss, value, prior)


def make_train_step(net: Connect4Net, optimizer: torch.optim.SGD, weighted: bool = False):
    """Returns ``(planes, values, priors) -> metrics``, one SGD step on the
    net and optimiser given here. ``planes`` is float NHWC ``[N, 6, 7, 3]``
    or the stored uint8 NCHW ``[N, 3, 6, 7]``, converted inside the step.
    The metrics (``loss``, ``value_loss``, ``prior_loss``) are tensors on
    the net's device; reading one waits for the step.

    With ``weighted=True`` the step takes a per-sample value-loss weight
    array ``(planes, values, priors, weights)``, used by the
    ``draw_loss_weight`` extension; without it a weight array is ignored."""

    def train_step(
        planes: torch.Tensor,
        value_targets: torch.Tensor,
        prior_targets: torch.Tensor,
        value_weights: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        # storage layout: the replay window stays on the device in its
        # on-disk uint8 NCHW form (a quarter of float32); the net takes NCHW
        # as it is, so the values are those of the float NHWC form
        nchw = planes.dtype == torch.uint8
        net.train()
        try:
            optimizer.zero_grad(set_to_none=True)
            total, (v_loss, p_loss, _, _) = loss_fn(
                net, planes.float() if nchw else planes, value_targets, prior_targets,
                value_weights if weighted else None, nchw=nchw,
            )
            total.backward()
            optimizer.step()
        finally:
            net.eval()
        return {
            "loss": total.detach(),
            "value_loss": v_loss.detach(),
            "prior_loss": p_loss.detach(),
        }

    return train_step


def make_batch_gather(batch_size: int):
    """Minibatch gather: ``(arrays, order, start) -> tuple of
    arrays[order[start:start+batch_size]]``, plain indexing of arrays that
    live on the device (the JAX package fuses this into one program to save
    dispatches; here each array is one ``index_select``)."""

    def gather(arrays: Sequence[torch.Tensor], order: torch.Tensor, start: int):
        idx = order[int(start): int(start) + batch_size]
        return tuple(a.index_select(0, idx) for a in arrays)

    return gather


def train_epochs(
    train_step,
    arrays: Sequence[torch.Tensor],
    batch_size: int,
    n_epochs: int,
    generator: Optional[torch.Generator] = None,
    epoch_orders: Optional[Sequence[Sequence[int]]] = None,
) -> torch.Tensor:
    """``n_epochs`` passes of ``train_step`` over ``arrays`` (tensors of
    equal length on one device, in the order the step takes them): full
    batches of ``batch_size`` and then the partial tail, so every row trains
    (torch DataLoader ``drop_last=False``). Each epoch visits the rows in a
    fresh random order from ``generator``, or in ``epoch_orders[epoch]`` when
    orders are given. Returns every step's loss as one tensor on the device:
    nothing is read back while the epochs run."""
    n = len(arrays[0])
    device = arrays[0].device
    batch_size = min(batch_size, n)
    n_full = (n // batch_size) * batch_size
    gather = make_batch_gather(batch_size)
    gather_tail = make_batch_gather(n - n_full) if n > n_full else None
    losses = []
    for epoch in range(n_epochs):
        if epoch_orders is None:
            order = torch.randperm(n, generator=generator, device=device)
        else:
            order = torch.as_tensor(epoch_orders[epoch], device=device).long()
        for i in range(0, n_full, batch_size):
            losses.append(train_step(*gather(arrays, order, i))["loss"])
        if gather_tail is not None:
            losses.append(train_step(*gather_tail(arrays, order, n_full))["loss"])
    return torch.stack(losses)


def make_eval_fn(net: Connect4Net):
    """Inference forward ``planes_nhwc -> (value, prior)`` with the running
    BatchNorm statistics and no autograd."""

    @torch.no_grad()
    def forward(planes_nhwc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if net.training:
            raise RuntimeError("make_eval_fn: the net is in training mode")
        return net(planes_nhwc)

    return forward
