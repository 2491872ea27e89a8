"""Architecture sanity check: supervised training directly on the 8-ply and
7-ply benchmark sets.

The counterpart of the JAX package's ``scripts/verify_supervised.py``:
before trusting the RL loop, check that the net can fit the evaluation
targets when trained on them directly. The 8-ply set's positions (uniform
policy targets) and the 7-ply set's (its policies) train a fresh bf16 net
with the learner's step (``training.learner.make_train_step``) in full
batches, each epoch in the order ``numpy.random.default_rng(0)`` draws, as
the JAX script draws it; after each epoch the value statistics on 8192
sampled positions are printed with the epoch's mean loss.

    python -m connect4_tpu_torch.scripts.verify_supervised [--epochs 10] [--filters 64 ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from connect4_tpu_torch.config import ModelConfig, NetConfig, StorageConfig
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import resolve_device


def load_sets(data_dir: str):
    """``(planes NHWC float32, values, policies)`` of the solved rows of the
    8-ply set (uniform policy targets) and, when present, the 7-ply set."""
    path8 = os.path.join(data_dir, "connect4dataset_8ply.npz")
    path7 = os.path.join(data_dir, "connect4dataset_7ply.npz")
    if not os.path.exists(path8):
        raise SystemExit(f"{path8} missing - build it first: python -m connect4_tpu_torch.data.datasets 8ply")
    with np.load(path8) as d:
        ok = d["solved"] if "solved" in d else np.ones(len(d["values"]), bool)
        if not ok.all():
            print(f"8ply: using {int(ok.sum())}/{len(ok)} solved rows")
        planes = np.moveaxis(d["planes"][ok], 1, -1).astype(np.float32)
        values = d["values"][ok].astype(np.float32)
    policies = np.full((len(values), 7), 1.0 / 7, dtype=np.float32)
    if os.path.exists(path7):
        with np.load(path7) as d:
            ok = d["solved"] if "solved" in d else np.ones(len(d["values"]), bool)
            if not ok.all():
                print(f"7ply: using {int(ok.sum())}/{len(ok)} solved rows")
            planes = np.concatenate([planes, np.moveaxis(d["planes"][ok], 1, -1).astype(np.float32)])
            values = np.concatenate([values, d["values"][ok].astype(np.float32)])
            policies = np.concatenate([policies, d["policies"][ok].astype(np.float32)])
    return planes, values, policies


def verify_supervised(data_dir: str, epochs: int = 10, batch_size: int = 4096, lr: float = 0.01,
                      net_config: Optional[NetConfig] = None, device="cuda", state=None) -> dict:
    """Train for ``epochs`` and return every step's loss and each epoch's
    value statistics. ``state`` (a ``learner.TrainState``) replaces the
    freshly initialised net, for instance one carried over from the JAX
    package; its learning rate is set to ``lr``."""
    from connect4_tpu_torch.training.learner import (
        init_train_state,
        make_eval_fn,
        make_train_step,
        set_learning_rate,
    )
    from connect4_tpu_torch.training.stats import ValueStats

    dev = resolve_device(device)
    net_config = net_config or NetConfig(**_common.FULL_WIDTH)
    model_config = ModelConfig(net_config=net_config, initial_lr=lr, batch_size=batch_size)
    if state is None:
        state = init_train_state(model_config, torch.Generator().manual_seed(0), dev)
    set_learning_rate(state.optimizer, lr)
    step = make_train_step(state.net, state.optimizer)
    forward = make_eval_fn(state.net)

    planes, values, policies = load_sets(data_dir)
    planes_d, values_d, policies_d = (torch.from_numpy(a).to(dev) for a in (planes, values, policies))
    n = len(values)
    rng = np.random.default_rng(0)
    out = {"device": _common.device_name(dev), "positions": n, "batch_size": batch_size,
           "net_config": net_config.__dict__, "epochs": []}
    for epoch in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        _common.sync(dev)
        start = time.perf_counter()
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            metrics = step(planes_d[idx], values_d[idx], policies_d[idx])
            losses.append(metrics["loss"])
        losses = torch.stack(losses).cpu().tolist() if losses else []
        seconds = time.perf_counter() - start  # reading the losses waited for the card
        sample = rng.choice(n, size=min(8192, n), replace=False)
        v_pred, _ = forward(planes_d[torch.from_numpy(sample).to(dev)])
        stats = ValueStats()
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        stats.update(v_pred.float().cpu().numpy(), values[sample], mean_loss)
        print(f"epoch {epoch}: loss {mean_loss:.4f}  {stats!r}", flush=True)
        out["epochs"].append({"epoch": epoch, "steps": len(losses), "seconds": seconds,
                              "loss": mean_loss, "losses": losses, "stats": stats.to_dict()})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--filters", type=int, default=64)
    parser.add_argument("--fc-layers", type=int, default=6)
    parser.add_argument("--residuals", type=int, default=6)
    parser.add_argument("--data-dir", default=None)
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    net_config = NetConfig(filters=args.filters, n_fc_layers=args.fc_layers, n_residuals=args.residuals,
                           compute_dtype="bfloat16")
    r = verify_supervised(args.data_dir or StorageConfig().data_dir, args.epochs, args.batch_size,
                          args.lr, net_config, args.device)
    _common.emit({**r, "epochs": [{k: v for k, v in e.items() if k != "losses"} for e in r["epochs"]]})
    return r


if __name__ == "__main__":
    main()
