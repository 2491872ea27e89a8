"""The product training run, and the K=8 arm of the parallel_sims A/B.

The counterpart of the JAX package's ``examples/config_r3_k8.py``: the
published reference workload (filters=64, fc 6, res 6; 1200 games x 800
simulations a generation) with a gating match every 5 generations and K=8
walkers. The JAX run evaluated on a frozen snapshot of its then partly
built 8-ply set; the port's packaged sets are complete, so the run keeps
the default ``data_dir``. The run directory is the port's own, under
``~/connect4_tpu_torch_runs``.
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
    storage_config=StorageConfig(save_dir=os.path.expanduser("~/connect4_tpu_torch_runs/r3_k8")),
    simulations=800,
    n_training_games=1200,
    selfplay_batch=256,
    n_eval=5,
    parallel_sims=8,
    sims_per_call=200,
    seed=0,
)
