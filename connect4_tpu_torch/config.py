"""Configuration of the PyTorch port: copies of ``NetConfig``,
``ModelConfig`` and ``MCTSConfig`` from ``connect4_tpu.config``, kept here
so the port never imports the JAX package. Field names and defaults are
the same, so a config moves between the two packages with
``dataclasses.asdict``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class NetConfig:
    """Architecture of the value+policy net
    (reference defaults: ``oinkoink/neural/config.py:7-16``)."""

    channels: int = 3
    filters: int = 32
    n_fc_layers: int = 4
    n_residuals: int = 3
    # compute dtype of the conv tower. float32 matches the reference;
    # bfloat16 is the fast path and the one the hand-written tower kernel
    # (models/tower.py) runs.
    compute_dtype: str = "float32"


@dataclasses.dataclass
class ModelConfig:
    """Optimiser + training schedule
    (``oinkoink/neural/config.py:19-39``). ``milestones`` are in
    *generations*, matching the reference's per-generation LR step."""

    net_config: NetConfig = dataclasses.field(default_factory=NetConfig)
    weight_decay: float = 1e-4
    momentum: float = 0.9
    initial_lr: float = 0.01
    milestones: Tuple[int, ...] = (100, 300, 600)
    gamma: float = 0.1
    batch_size: int = 4096
    n_training_epochs: int = 5
    draw_loss_weight: float = 1.0
    value_target_mix: float = 0.0

    def lr_at_generation(self, gen: int) -> float:
        """MultiStep schedule: decay by ``gamma`` at each milestone, stepped
        once per generation."""
        passed = sum(1 for m in self.milestones if gen >= m)
        return self.initial_lr * (self.gamma**passed)


@dataclasses.dataclass
class MCTSConfig:
    """Search hyperparameters (``oinkoink/mcts.py:13-26``)."""

    simulations: int = 800
    pb_c_base: float = 19652.0
    pb_c_init: float = 1.25
    root_dirichlet_alpha: float = 0.0
    root_exploration_fraction: float = 0.0
    num_sampling_moves: int = 0
    # tree capacity per game. None => the exact worst case (see
    # tree_capacity) so semantics never degrade.
    max_nodes: Optional[int] = None
    # simulations walked concurrently per game with a virtual-visit overlay
    # (leaf parallelism). 1 = exact reference semantics; simulations must
    # be divisible by parallel_sims.
    parallel_sims: int = 1

    def tree_capacity(self) -> int:
        if self.max_nodes is not None:
            return self.max_nodes
        # One 7-slot child block can be allocated per *search iteration*.
        # Sequential search (K=1) runs one iteration per simulation; the
        # walker-deduplicated parallel search runs simulations/K iterations
        # and expands at most one shared leaf per iteration, so its exact
        # worst case is K-fold smaller.
        iterations = -(-self.simulations // max(self.parallel_sims, 1))
        return 1 + 7 * iterations
