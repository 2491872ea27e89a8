"""Diagnose the draw-bucket pathology: where a net's predictions fall by target class.

The counterpart of the JAX package's ``scripts/draw_bucket_diagnosis.py``.
The packaged nets classify drawn 8-ply positions far less often than won or
lost ones; this tool pins down why. On the solved rows of the 8-ply set it
prints, for each target class (0, 0.5, 1), the count, the mean and median
prediction, the share inside the class's third of [0, 1] (the bucket
accuracy) and a 20-bin histogram of the predictions. Then it reports the
best 3-way accuracy that any monotone recalibration of the outputs could
reach (two thresholds swept over the sorted predictions with cumulative
sums), with its draw recall and thresholds: if the prediction order already
separates the draws, calibration suffices; if not, the fix must change
training. Last it prints the packaged run's ``PACKAGED.json`` (a copy of
the JAX package's, in ``connect4_tpu_torch/data/``).

The net is the packaged gen-161 (``data/example_net_161.npz``) unless
``--ckpt-dir`` (and ``--gen``, default the latest readable one) names a
run's checkpoint. It runs through ``training.learner.make_eval_fn``, the
unfolded net, in the compute dtype the net carries (bf16 for gen-161): on
the card that is cuDNN, not the tower kernel.

    python -m connect4_tpu_torch.scripts.draw_bucket_diagnosis [--data-dir DIR] \\
        [--ckpt-dir DIR] [--gen N] [--batch 8192] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import np_load_retry, resolve_device

PACKAGED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "PACKAGED.json")
CLASSES = (0.0, 0.5, 1.0)


def solved_8ply(data_dir: str):
    """``(planes NCHW uint8, values)`` of the solved rows of the 8-ply set."""
    with np_load_retry(os.path.join(data_dir, "connect4dataset_8ply.npz")) as d:
        planes = d["planes"]
        values = d["values"]
        solved = d["solved"] if "solved" in d else np.ones(len(values), bool)
    return planes[solved], values[solved]


def predictions(net, planes: np.ndarray, batch: int, device) -> np.ndarray:
    """The net's value on every position, float64, in batches of ``batch``."""
    from connect4_tpu_torch.training.learner import make_eval_fn

    forward = make_eval_fn(net)
    preds = []
    for i in range(0, len(planes), batch):
        x = torch.from_numpy(np.moveaxis(planes[i:i + batch], 1, -1).astype(np.float32)).to(device)
        v, _ = forward(x)
        preds.append(v.float().cpu().numpy().astype(np.float64))
    return np.concatenate(preds)


def class_stats(preds: np.ndarray, values: np.ndarray) -> dict:
    """For each target class: n, mean and median prediction, bucket
    accuracy and the 20-bin histogram over [0, 1]."""
    edges = np.linspace(0, 1, 21)
    out = {}
    for cls in CLASSES:
        sel = values == cls
        p = preds[sel]
        in_bucket = ((p >= 1 / 3) & (p < 2 / 3)) if cls == 0.5 else (
            (p < 1 / 3) if cls == 0.0 else (p >= 2 / 3)
        )
        hist, _ = np.histogram(p, bins=edges)
        out[cls] = {"n": int(sel.sum()), "mean_pred": float(p.mean()), "median": float(np.median(p)),
                    "bucket_acc": float(in_bucket.mean()), "hist": hist.tolist()}
    return out


def best_recalibration(preds: np.ndarray, values: np.ndarray) -> dict:
    """The best 3-way accuracy over two thresholds ``(t_lo, t_hi)``:
    prediction < t_lo -> 0, < t_hi -> 0.5, else 1. That is the best any
    monotone map of the outputs could score with the buckets applied
    after it. With the positions sorted by prediction and ``c0``, ``c5``,
    ``c1`` the counts of each class among the first k, splitting at
    ``i <= j`` scores ``c0[i] - c5[i] + (c5[j] - c1[j]) + c1[n]``; the best
    ``j`` for each ``i`` is a suffix maximum."""
    order = np.argsort(preds)
    v_sorted = values[order]
    n = len(v_sorted)
    c0, c5, c1 = (np.concatenate([[0], np.cumsum((v_sorted == cls).astype(np.int64))]) for cls in CLASSES)
    f = c5 - c1
    best_f_from = np.maximum.accumulate(f[::-1])[::-1]
    score = c0 - c5 + best_f_from
    i_best = int(score.argmax())
    j_best = i_best + int(f[i_best:].argmax())
    draws_in = int(c5[j_best] - c5[i_best])
    return {"accuracy": float((score.max() + c1[n]) / n), "draws_in": draws_in, "draws": int(c5[n]),
            "draw_recall": draws_in / max(int(c5[n]), 1),
            "thresholds": [float(preds[order][min(i_best, n - 1)]), float(preds[order][min(j_best, n - 1)])]}


def diagnose(net, data_dir: str, batch: int = 8192, device="cuda") -> dict:
    dev = resolve_device(device)
    planes, values = solved_8ply(data_dir)
    preds = predictions(net, planes, batch, dev)
    with open(PACKAGED) as fh:
        packaged = json.load(fh)
    return {"device": _common.device_name(dev), "positions": len(values),
            "classes": class_stats(preds, values), "recalibration": best_recalibration(preds, values),
            "packaged": packaged}


def report(r: dict) -> None:
    """The JAX script's lines."""
    print(f"8-ply solved positions: {r['positions']}")
    for cls, s in r["classes"].items():
        print(
            f"\ntarget={cls}: n={s['n']}  mean_pred={s['mean_pred']:.4f}  "
            f"median={s['median']:.4f}  bucket_acc={s['bucket_acc']:.4f}"
        )
        print("  hist[0..1 by .05]:", " ".join(str(h) for h in s["hist"]))
    rc = r["recalibration"]
    print(f"\nbest monotone-recalibration 3-way accuracy: {rc['accuracy']:.4f}")
    print(
        f"  at that point: draw recall {rc['draws_in']}/{rc['draws']} = {rc['draw_recall']:.4f}; "
        f"thresholds pred≈({rc['thresholds'][0]:.4f}, {rc['thresholds'][1]:.4f})"
    )
    print("\npackaged run:", r["packaged"], flush=True)


def main(argv=None):
    from connect4_tpu_torch.config import StorageConfig

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data-dir", default=StorageConfig().data_dir)
    parser.add_argument("--ckpt-dir", default=None, help="a run's save_dir (default: the packaged gen-161 net)")
    parser.add_argument("--gen", type=int, default=None)
    parser.add_argument("--batch", type=int, default=8192)
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    r = diagnose(_common.load_net(args.ckpt_dir, args.gen, dev)[1], args.data_dir, args.batch, dev)
    report(r)
    _common.emit(r)
    return r


if __name__ == "__main__":
    main()
