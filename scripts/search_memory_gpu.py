"""What a training run keeps on the GPU from one generation to the next.

The search captures CUDA graphs for every pool width it meets, into the
workspaces of its search object (``connect4_tpu_torch.mcts.batched.Search``),
and ``TrainingLoop`` makes new search objects each generation. This runs
one ``TrainingLoop`` for several generations of a small run (128 games in
64 slots, 64 simulations, K=8, one epoch at batch 1024, the 98-game match)
with a fresh bf16 net at each width of ``--filters``, and prints after
each generation the card's allocated and reserved memory and the number of
CUDA graphs and search objects still alive (after a garbage collection);
then the memory once the loop is gone. Flat lines mean the graphs and
their memory pools go with their search objects.

Needs a CUDA card.

    python3 scripts/search_memory_gpu.py [--filters 64 512] [--generations 6 4]
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--filters", type=int, nargs="+", default=[64, 512])
    parser.add_argument("--generations", type=int, nargs="+", default=[6, 4],
                        help="generations at each width of --filters")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("search_memory_gpu: needs a CUDA card", file=sys.stderr)
        return 2
    from connect4_tpu_torch.config import AlphaZeroConfig, ModelConfig, NetConfig, StorageConfig
    from connect4_tpu_torch.mcts.batched import Search
    from connect4_tpu_torch.training.loop import TrainingLoop
    from connect4_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda")

    def live(kind) -> int:
        return sum(1 for o in gc.get_objects() if isinstance(o, kind))

    for f, gens in zip(args.filters, args.generations):
        with tempfile.TemporaryDirectory(prefix="search_memory_") as tmp:
            config = AlphaZeroConfig(
                model_config=ModelConfig(
                    net_config=NetConfig(filters=f, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16"),
                    batch_size=1024, n_training_epochs=1),
                storage_config=StorageConfig(save_dir=tmp), simulations=64, parallel_sims=8,
                n_training_games=128, selfplay_batch=64, n_eval=1, seed=0)
            loop = TrainingLoop(config, device=dev)
            for _ in range(gens):
                t0 = time.perf_counter()
                loop.run(generations=1)
                torch.cuda.synchronize()
                gc.collect()
                print(f"F={f} generation {loop.gen - 1}: {time.perf_counter() - t0:.2f} s, "
                      f"{torch.cuda.memory_allocated() / 2**20:.1f} MB allocated, "
                      f"{torch.cuda.memory_reserved() / 2**20:.1f} MB reserved, live CUDA graphs "
                      f"{live(torch.cuda.CUDAGraph)}, live search objects {live(Search)}", flush=True)
            del loop
            gc.collect()
            print(f"F={f} after the loop: {torch.cuda.memory_allocated() / 2**20:.1f} MB allocated", flush=True)
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
