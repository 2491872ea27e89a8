"""Configuration of the PyTorch port: copies of the dataclasses of
``connect4_tpu.config``, kept here so the port never imports the JAX
package. Field names and defaults are the same, so a config moves between
the two packages with ``dataclasses.asdict``; only the default directories
of ``StorageConfig`` are the port's own. Like the JAX package, a user config
is a Python file defining ``config`` (see ``connect4_tpu_torch.cli``)."""

from __future__ import annotations

import dataclasses
import os
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


@dataclasses.dataclass
class StorageConfig:
    """Filesystem layout. ``save_dir/<gen>/`` holds per-generation
    artifacts; ``data_dir`` holds the 7-ply and 8-ply benchmark sets (the
    packaged copies by default)."""

    save_dir: str = dataclasses.field(
        default_factory=lambda: os.path.expanduser("~/connect4_tpu_torch_runs")
    )
    data_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "data"
        )
    )


@dataclasses.dataclass
class AlphaZeroConfig:
    """Top-level training configuration. ``selfplay_batch`` is the number
    of games stepped in lockstep on the device."""

    model_config: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    storage_config: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    simulations: int = 800
    pb_c_base: float = 19652.0
    pb_c_init: float = 1.25
    root_dirichlet_alpha: float = 0.3
    root_exploration_fraction: float = 0.25
    num_sampling_moves: int = 6
    n_eval: int = 1  # run a gating match every n_eval generations
    # Start-position depth of the in-loop gating match: all 49 two-ply
    # starts, both colours (98 games). Set to 1 for the 14-game protocol.
    gating_plies: int = 2
    n_training_games: int = 1200
    selfplay_batch: int = 1200  # games in flight on the device per wave
    max_nodes: Optional[int] = None
    parallel_sims: int = 1  # see MCTSConfig.parallel_sims
    # Split each search into calls of this many simulations (None = the
    # whole search in one call); must divide ``simulations``.
    sims_per_call: Optional[int] = None
    seed: int = 0
    # Device mesh axis sizes of the JAX package. The port runs on one
    # device: the field is kept so that configs carry over, and a value
    # other than None is refused (see require_single_device).
    mesh_shape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        self.require_single_device()

    def require_single_device(self) -> None:
        if self.mesh_shape is not None:
            raise NotImplementedError(
                f"mesh_shape={self.mesh_shape!r}: the PyTorch port runs on one "
                "device; leave mesh_shape=None (multi-device training is only "
                "in the JAX package so far)"
            )

    def search_config(self, training: bool) -> MCTSConfig:
        """Exploration on for self-play, off for evaluation matches."""
        config = MCTSConfig(
            simulations=self.simulations,
            pb_c_base=self.pb_c_base,
            pb_c_init=self.pb_c_init,
            max_nodes=self.max_nodes,
            parallel_sims=self.parallel_sims,
        )
        if training:
            config.root_dirichlet_alpha = self.root_dirichlet_alpha
            config.root_exploration_fraction = self.root_exploration_fraction
            config.num_sampling_moves = self.num_sampling_moves
        return config


def load_config_file(path: str) -> AlphaZeroConfig:
    """Execute a user config file that defines ``config``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("user_config", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    config = module.config
    if not isinstance(config, AlphaZeroConfig):
        raise TypeError(f"{path} must define `config: AlphaZeroConfig`")
    return config
