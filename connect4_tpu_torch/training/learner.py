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

With a ``mesh`` (``parallel.mesh.Mesh``) the step is data parallel, the
port's form of the JAX package's sharded step: every rank is given the
whole batch and trains on its own rows, the BatchNorms take the statistics
of the global batch, each loss is normalised by the global count (the
weighted value loss by the global weight sum), the gradients are summed
over the ranks, and every rank takes the same SGD step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from connect4_tpu_torch import launches
from connect4_tpu_torch.config import ModelConfig
from connect4_tpu_torch.models.net import Connect4Net, init_net
from connect4_tpu_torch.parallel.mesh import replicate
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
    mesh=None,
):
    """``(total, (value_loss, prior_loss, value, prior))`` of the net in
    its current mode (in training mode the forward also moves the running
    statistics). With a ``mesh`` the arguments are this rank's rows and the
    losses this rank's share of the global batch's: summed over the ranks
    they are the losses of the whole batch."""
    value, prior = net(planes, nchw=nchw, mesh=mesh)
    sq = (value - value_targets) ** 2
    if value_weights is None:
        value_loss = sq.mean()
    else:
        # weighted mean with per-batch renormalisation so the loss scale
        # (and therefore the LR) is unchanged whatever the batch's draw mix
        total_weight = value_weights.sum()
        if mesh is not None:
            total_weight = mesh.all_reduce(total_weight)
        value_loss = (value_weights * sq).sum() / total_weight
    prior_loss = bce_loss(prior, prior_targets)
    if mesh is not None:
        # equal shares: the global mean is the mean of the ranks' means
        prior_loss = prior_loss / mesh.world_size
        if value_weights is None:
            value_loss = value_loss / mesh.world_size
    return value_loss + prior_loss, (value_loss, prior_loss, value, prior)


def _all_reduce_grads(net: Connect4Net, mesh) -> None:
    """Sum every parameter's gradient over the ranks, as one flat buffer."""
    grads = [p.grad for p in net.parameters()]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(
    net: Connect4Net, optimizer: torch.optim.SGD, weighted: bool = False, mesh=None,
):
    """Returns ``(planes, values, priors) -> metrics``, one SGD step on the
    net and optimiser given here. ``planes`` is float NHWC ``[N, 6, 7, 3]``
    or the stored uint8 NCHW ``[N, 3, 6, 7]``, converted inside the step.
    The metrics (``loss``, ``value_loss``, ``prior_loss``) are tensors on
    the net's device; reading one waits for the step.

    With ``weighted=True`` the step takes a per-sample value-loss weight
    array ``(planes, values, priors, weights)``, used by the
    ``draw_loss_weight`` extension; without it a weight array is ignored.

    With a ``mesh`` every rank calls the step with the same whole batch and
    the same replica. Where the rows divide over the ranks the step trains
    on this rank's rows (``Mesh.rows``), sums the gradients over the ranks
    and returns the metrics of the whole batch: every rank applies the same
    summed gradient to the same parameters. A batch that does not divide
    (an epoch's tail) runs whole on every rank with no all-reduce, as the
    JAX loop runs it replicated; every rank then takes rank 0's replica, so
    the replicas stay equal bit for bit whatever order a card summed in.

    A step is the span ``learner.step`` of ``connect4_tpu_torch.launches``,
    holding the whole of it: ``learner.forward`` (clearing the gradients,
    the cast and the loss), ``learner.backward`` and ``learner.optimizer``
    among the rest."""

    def train_step(
        planes: torch.Tensor,
        value_targets: torch.Tensor,
        prior_targets: torch.Tensor,
        value_weights: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        with launches.span("learner.step", value_targets.device):
            if mesh is None or len(value_targets) % mesh.world_size == 0:
                return _step(planes, value_targets, prior_targets, value_weights, mesh)
            metrics = _step(planes, value_targets, prior_targets, value_weights, None)
            replicate((net, optimizer), mesh)
            return metrics

    def _step(planes, value_targets, prior_targets, value_weights, mesh):
        # storage layout: the replay window stays on the device in its
        # on-disk uint8 NCHW form (a quarter of float32); the net takes NCHW
        # as it is, so the values are those of the float NHWC form
        nchw = planes.dtype == torch.uint8
        if mesh is not None:
            rows = mesh.rows(len(value_targets))
            planes, value_targets, prior_targets = planes[rows], value_targets[rows], prior_targets[rows]
            if value_weights is not None:
                value_weights = value_weights[rows]
        device = value_targets.device
        net.train()
        try:
            with launches.span("learner.forward", device):
                optimizer.zero_grad(set_to_none=True)
                total, (v_loss, p_loss, _, _) = loss_fn(
                    net, planes.float() if nchw else planes, value_targets, prior_targets,
                    value_weights if weighted else None, nchw=nchw, mesh=mesh,
                )
            with launches.span("learner.backward", device):
                total.backward()
            if mesh is not None:
                _all_reduce_grads(net, mesh)
            with launches.span("learner.optimizer", device):
                optimizer.step()
        finally:
            net.eval()
        losses = torch.stack([total.detach(), v_loss.detach(), p_loss.detach()])
        if mesh is not None:
            mesh.all_reduce(losses)
        return dict(zip(("loss", "value_loss", "prior_loss"), losses))

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
