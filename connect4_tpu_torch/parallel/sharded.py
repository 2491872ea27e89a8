"""Data-parallel self-play and training over a ``parallel.mesh.Mesh``.

The counterpart of ``connect4_tpu.parallel.sharded``. Self-play is data
parallel over games: each rank plays its block on its own card and the
blocks are gathered once at the end (``training.self_play``, ``mesh=``).
Training is data parallel over the rows of a batch with replicated
parameters (``training.learner.make_train_step``, ``mesh=``).
"""

from __future__ import annotations

import torch

from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.eval.evaluators import BatchedEvaluator
from connect4_tpu_torch.models.net import Connect4Net
from connect4_tpu_torch.parallel.mesh import Mesh
from connect4_tpu_torch.training.learner import make_train_step
from connect4_tpu_torch.training.self_play import make_stepwise_play_fn


def make_sharded_play_fn(eval_fn: BatchedEvaluator, config: MCTSConfig, batch: int, mesh: Mesh):
    """``make_stepwise_play_fn(..., mesh=mesh)`` under the JAX name: lockstep
    self-play of ``batch`` games, ``batch / world_size`` on each rank (raises
    ``ValueError`` unless they divide), all of them gathered on every rank."""
    return make_stepwise_play_fn(eval_fn, config, batch, mesh=mesh)


def make_sharded_train_step(
    net: Connect4Net, optimizer: torch.optim.SGD, mesh: Mesh, weighted: bool = False,
):
    """``make_train_step(..., mesh=mesh)`` under the JAX name: the data-parallel
    train step, equal to one step on the whole batch in one process."""
    return make_train_step(net, optimizer, weighted=weighted, mesh=mesh)
