"""Offline sweep of the draw-bucket training knobs.

The counterpart of the JAX package's ``scripts/draw_bucket_experiment.py``:
it fine-tunes generation ``--gen`` of the run in ``--run-dir`` on that
run's own replay window (``training.replay.load_window_ex``) once for each
``w:λ`` variant, ``w`` the value-loss weight of drawn games
(``draw_loss_weight``) and ``λ`` the share of the search value in the value
target (``value_target_mix``), and after each epoch scores the net on the
solved 8-ply set: MSE, and the accuracy of each class and of all with the
reference's bucketing ``floor(3p)/2``. No self-play is involved, so each
variant is cheap; it picks the knob values for a fine-tune in the loop.

As in the JAX script:

- every variant starts from the checkpoint as saved, momentum included,
  with the learning rate set to ``--lr``: the net and the optimiser change
  in place here, so each variant restores the checkpoint anew;
- the net is the published architecture in float32
  (``NetConfig(filters=64, n_fc_layers=6, n_residuals=6)``, whose compute
  dtype is float32), whatever the run trained in; on the card it runs
  through cuDNN, not the tower kernel;
- an epoch takes the full batches of ``--batch`` and drops the last
  partial one, unlike ``learner.train_epochs``;
- each variant draws its epoch orders afresh from one seed, 7: here a
  ``torch.Generator``, so the orders match the JAX script's (threefry) in
  distribution only. The plain function takes the orders themselves.

``--run-dir`` is required: the JAX default, a run directory that is not in
the repository, has no counterpart.

    python -m connect4_tpu_torch.scripts.draw_bucket_experiment --run-dir DIR [--gen 146] \\
        [--epochs 4] [--lr 0.001] [--batch 4096] [--variants 1:0,4:0,1:0.5,4:0.5,8:0.5] \\
        [--data-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from connect4_tpu_torch.config import ModelConfig, NetConfig
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import np_load_retry, resolve_device

# the packaged run's architecture, in the compute dtype NetConfig defaults to (float32)
EXPERIMENT_NET = NetConfig(filters=64, n_fc_layers=6, n_residuals=6)
VARIANTS = "1:0,4:0,1:0.5,4:0.5,8:0.5"
ORDER_SEED = 7
EVAL_BATCH = 16384


def parse_variants(spec: str) -> List[Tuple[float, float]]:
    """``"w:λ,w:λ,..."`` -> ``[(w, λ), ...]``."""
    out = []
    for part in spec.split(","):
        w, lam = part.split(":")
        out.append((float(w), float(lam)))
    return out


def scores(preds: np.ndarray, values: np.ndarray) -> dict:
    """MSE and the bucket accuracies (``floor(3p)/2`` against the target),
    unrounded."""
    cats = np.floor(preds * 3.0) / 2.0
    out = {"mse": float(np.mean((preds - values) ** 2))}
    for cls, name in ((0.0, "loss"), (0.5, "draw"), (1.0, "win")):
        sel = values == cls
        out[f"acc_{name}"] = float((cats[sel] == cls).mean())
    out["acc"] = float((cats == values).mean())
    return out


def rounded(s: dict) -> dict:
    """The JAX script's printed form: MSE to 5 places, accuracies to 4."""
    return {k: round(v, 5 if k == "mse" else 4) for k, v in s.items()}


def experiment(run_dir: str, gen: int, data_dir: str, epochs: int = 4, lr: float = 0.001,
               batch: int = 4096, variants: Sequence[Tuple[float, float]] = parse_variants(VARIANTS),
               device="cuda", net_config: NetConfig = EXPERIMENT_NET,
               epoch_orders: Optional[Sequence[Sequence[int]]] = None) -> dict:
    """The baseline's scores and, for each ``(w, λ)`` variant, each epoch's
    scores (unrounded). ``epoch_orders[e]`` replaces the order epoch ``e``
    of every variant draws."""
    from connect4_tpu_torch.training import checkpoint as ckpt
    from connect4_tpu_torch.training import replay
    from connect4_tpu_torch.training.learner import (
        init_train_state,
        make_eval_fn,
        make_train_step,
        set_learning_rate,
    )

    dev = resolve_device(device)
    model_config = ModelConfig(net_config=net_config, batch_size=batch)

    def restored():
        state = init_train_state(model_config, torch.Generator().manual_seed(0), dev)
        return ckpt.restore_checkpoint(run_dir, gen, state)[0]

    with np_load_retry(os.path.join(data_dir, "connect4dataset_8ply.npz")) as d:
        solved = d["solved"] if "solved" in d else np.ones(len(d["values"]), bool)
        planes8 = torch.from_numpy(np.moveaxis(d["planes"][solved], 1, -1).astype(np.float32)).to(dev)
        values8 = d["values"][solved].astype(np.float64)
    print(f"8-ply eval set: {len(values8)} solved positions", flush=True)

    def evaluate(state):
        forward = make_eval_fn(state.net)
        preds = [forward(planes8[i:i + EVAL_BATCH])[0].float().cpu().numpy()
                 for i in range(0, len(values8), EVAL_BATCH)]
        return scores(np.concatenate(preds).astype(np.float64), values8)

    baseline = evaluate(restored())
    print(f"baseline gen-{gen}:", json.dumps(rounded(baseline)), flush=True)

    out = {"device": _common.device_name(dev), "run_dir": run_dir, "gen": gen, "positions8": len(values8),
           "baseline": baseline, "variants": []}
    for w, lam in variants:
        planes, values, policies, weights = replay.load_window_ex(
            run_dir, gen, value_target_mix=lam, draw_loss_weight=w)
        n = len(values)
        arrays = [torch.from_numpy(a).to(dev) for a in (planes, values, policies)]
        if weights is not None:
            arrays.append(torch.from_numpy(weights).to(dev))

        state = restored()  # every variant from the checkpoint as saved
        set_learning_rate(state.optimizer, lr)
        step = make_train_step(state.net, state.optimizer, weighted=weights is not None)
        generator = torch.Generator().manual_seed(ORDER_SEED)
        results = []
        for epoch in range(epochs):
            if epoch_orders is None:
                order = torch.randperm(n, generator=generator)
            else:
                order = torch.as_tensor(np.asarray(epoch_orders[epoch]), dtype=torch.long)
            order = order.to(dev)
            for i in range(0, n - batch + 1, batch):  # the last partial batch is dropped
                idx = order[i:i + batch]
                step(*(a[idx] for a in arrays))
            res = evaluate(state)
            results.append(res)
            print(f"w={w} lam={lam} epoch={epoch + 1}: {json.dumps(rounded(res))}", flush=True)
        out["variants"].append({"w": w, "lam": lam, "positions": n, "weighted": weights is not None,
                                "steps_per_epoch": n // batch, "epochs": results})
    return out


def main(argv=None):
    from connect4_tpu_torch.config import StorageConfig

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--run-dir", required=True, help="the run's save_dir")
    parser.add_argument("--gen", type=int, default=146)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--variants", default=VARIANTS, help="comma list of w:lambda pairs")
    parser.add_argument("--data-dir", default=StorageConfig().data_dir)
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    r = experiment(args.run_dir, args.gen, args.data_dir, args.epochs, args.lr, args.batch,
                   parse_variants(args.variants), args.device)
    _common.emit(r)
    return r


if __name__ == "__main__":
    main()
