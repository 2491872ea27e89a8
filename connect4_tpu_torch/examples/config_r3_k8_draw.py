"""Continuation of the product run with the draw-bucket fix.

The counterpart of the JAX package's ``examples/config_r3_k8_draw.py``:
identical to ``config_r3_k8.py`` except ``value_target_mix=0.5``, so the
value head trains on (z+q)/2, the game result mixed with the search value
of the played move, instead of z alone. It continues in the same
``save_dir``, so the change shows on the learning curves where it began.
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
        value_target_mix=0.5,
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
