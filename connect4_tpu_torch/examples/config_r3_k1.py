"""The K=1 arm of the parallel_sims A/B: exact reference search semantics.

The counterpart of the JAX package's ``examples/config_r3_k1.py``: identical
to ``config_r3_k8.py`` in every respect except ``parallel_sims=1``. Training
N generations under each arm with the same seed and comparing the 8-ply
learning curves (``scripts.compare_runs``) and a head-to-head match
(``scripts.matches``, ``cli match``) is the evidence for or against K=8.
The run directory is the port's own, under ``~/connect4_tpu_torch_runs``.
"""

import os

from connect4_tpu_torch.config import (
    AlphaZeroConfig,
    ModelConfig,
    NetConfig,
    StorageConfig,
)

config = AlphaZeroConfig(
    model_config=ModelConfig(
        net_config=NetConfig(
            filters=64,
            n_fc_layers=6,
            n_residuals=6,
            compute_dtype="bfloat16",
        ),
    ),
    storage_config=StorageConfig(save_dir=os.path.expanduser("~/connect4_tpu_torch_runs/r3_k1")),
    simulations=800,
    n_training_games=1200,
    selfplay_batch=256,
    n_eval=5,
    parallel_sims=1,
    sims_per_call=200,
    seed=0,
)
