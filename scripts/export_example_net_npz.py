"""Export the packaged gen-161 example net to a JAX-free ``.npz``.

Restores ``connect4_tpu/data/files/example_net/<gen>/ckpt`` through the JAX
package's ``restore_checkpoint`` (as tests/test_packaged_artifacts.py does)
and writes its Flax ``params`` and ``batch_stats`` as flat float32 arrays,
keyed ``params/<module>/<...>/<leaf>`` and ``batch_stats/...``, plus the
net config as JSON under ``net_config``. The PyTorch port reads the file
with ``connect4_tpu_torch.models.convert.load_example_net`` and so needs no
JAX or Orbax to run the trained net.

    JAX_PLATFORMS=cpu python scripts/export_example_net_npz.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "connect4_tpu_torch", "data", "example_net_161.npz")


def restore_example_net():
    """``(net_config, generation, params, batch_stats)`` of the packaged
    example net, restored with the JAX package."""
    import jax

    from connect4_tpu.config import ModelConfig, NetConfig, StorageConfig
    from connect4_tpu.models import init_net
    from connect4_tpu.training import checkpoint as ckpt
    from connect4_tpu.training.learner import TrainState, make_optimizer

    base = os.path.join(StorageConfig().data_dir, "example_net")
    with open(os.path.join(base, "net_config.json")) as fh:
        nc = NetConfig(**json.load(fh))
    _, variables = init_net(nc, jax.random.key(0))
    opt = make_optimizer(ModelConfig(net_config=nc))
    template = TrainState(
        variables["params"], variables["batch_stats"], opt.init(variables["params"])
    )
    gen = ckpt.latest_generation(base)
    state, _ = ckpt.restore_checkpoint(base, gen, template, jax.random.key(0))
    return nc, gen, state.params, state.batch_stats


def flatten(tree, prefix: str) -> dict:
    out = {}
    for name, value in tree.items():
        key = f"{prefix}/{name}"
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(flatten(value, key))
        else:
            out[key] = np.asarray(value, dtype=np.float32)
    return out


def main(argv=None):
    import dataclasses

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args(argv)

    nc, gen, params, batch_stats = restore_example_net()
    arrays = {**flatten(params, "params"), **flatten(batch_stats, "batch_stats")}
    arrays["net_config"] = np.array(json.dumps(dataclasses.asdict(nc)))
    arrays["generation"] = np.array(gen, dtype=np.int64)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: generation {gen}, {len(arrays) - 2} arrays, "
          f"{os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
