"""Example training configuration of the port.

The counterpart of the JAX package's ``examples/config.py``, field for
field: the published run's net (filters=64, fc 6, res 6) in bf16 with the
default AlphaZero search settings, 1200 games x 800 simulations a
generation in a 512-slot refill pool at K=8. Only the default directories
are the port's own (``~/connect4_tpu_torch_runs``, the packaged benchmark
sets). Pass it to the CLI:

    python -m connect4_tpu_torch.cli training -c connect4_tpu_torch/examples/config.py
"""

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
    storage_config=StorageConfig(),  # save_dir defaults to ~/connect4_tpu_torch_runs
    simulations=800,
    n_training_games=1200,
    # a slot pool smaller than the game budget selects compact-and-refill
    # self-play; 512 slots at K=8 evaluate leaves at batch 4096
    selfplay_batch=512,
    n_eval=500,
    parallel_sims=8,
    sims_per_call=200,
)
