"""Evaluation metrics (numpy only; a copy of
``connect4_tpu.training.stats``, so the port imports nothing of the JAX
package).

- ``ValueStats``: average loss, min/max/mean prediction, and 3-way
  classification accuracy obtained by bucketing predictions into
  {0, 0.5, 1} via ``floor(pred * 3) / 2``.
- ``PriorStats``: policy loss and "weak move" accuracy: the predicted
  argmax must be one of the optimal (max-labelled) moves.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def categorise_predictions(preds: np.ndarray) -> np.ndarray:
    return np.floor(preds * 3.0) / 2.0


class ValueStats:
    def __init__(self):
        self.n = 0
        self.sum_predictions = 0.0
        self.total_loss = 0.0
        self.smallest = 1.0
        self.largest = 0.0
        self.correct = {k: 0 for k in (0.0, 0.5, 1.0)}
        self.total = {k: 0 for k in (0.0, 0.5, 1.0)}

    def update(self, outputs: np.ndarray, targets: np.ndarray, loss: float):
        outputs = np.asarray(outputs, dtype=np.float64)
        targets = np.asarray(targets, dtype=np.float64)
        self.n += len(targets)
        self.sum_predictions += outputs.sum()
        self.total_loss += float(loss) * len(targets)
        self.smallest = min(self.smallest, float(outputs.min()))
        self.largest = max(self.largest, float(outputs.max()))
        cats = categorise_predictions(outputs)
        for k in self.correct:
            idx = targets == k
            self.total[k] += int(idx.sum())
            self.correct[k] += int((cats[idx] == k).sum())

    @property
    def loss(self) -> float:
        return self.total_loss / self.n

    @property
    def accuracy(self) -> float:
        return sum(self.correct.values()) / self.n

    @property
    def average(self) -> float:
        return self.sum_predictions / self.n

    def to_dict(self) -> Dict:
        out = {
            "Average loss": self.loss,
            "Accuracy": self.accuracy,
            "Smallest": self.smallest,
            "Largest": self.largest,
            "Average": self.average,
            "correct": {k: (self.total[k], self.correct[k]) for k in self.correct},
        }
        return out

    def __repr__(self):
        parts = [
            "Average loss:  {:.5f}".format(self.loss),
            "Accuracy:  {:.5f}".format(self.accuracy),
            "Smallest:  {:.5f}".format(self.smallest),
            "Largest:  {:.5f}".format(self.largest),
            "Average:  {:.5f}".format(self.average),
        ]
        cats = "  ".join(
            "({}, {}, {})".format(k, self.total[k], self.correct[k])
            for k in self.correct
        )
        return "  ".join(parts) + "\nCategory, # Members, # Correct Predictions:  " + cats


class PriorStats:
    def __init__(self):
        self.n = 0
        self.total_loss = 0.0
        self.correct = 0

    def update(self, outputs: np.ndarray, targets: np.ndarray, loss: float):
        outputs = np.asarray(outputs)
        targets = np.asarray(targets)
        self.n += len(targets)
        self.total_loss += float(loss) * len(targets)
        pred_best = outputs.argmax(axis=1)
        label_max = targets.max(axis=1, keepdims=True)
        is_optimal = targets >= label_max  # argmax set of the label
        self.correct += int(is_optimal[np.arange(len(targets)), pred_best].sum())

    @property
    def loss(self) -> float:
        return self.total_loss / self.n

    @property
    def accuracy(self) -> float:
        return self.correct / self.n

    def to_dict(self) -> Dict:
        return {"Average loss": self.loss, "Accuracy": self.accuracy}

    def __repr__(self):
        return "Average loss:  {:.5f}  Accuracy:  {:.5f}".format(
            self.loss, self.accuracy
        )


class CombinedStats:
    def __init__(self):
        self.value_stats = ValueStats()
        self.prior_stats = PriorStats()

    def update(self, value_out, value_t, value_loss, prior_out, prior_t, prior_loss):
        self.value_stats.update(value_out, value_t, value_loss)
        self.prior_stats.update(prior_out, prior_t, prior_loss)

    @property
    def loss(self) -> float:
        return self.value_stats.loss + self.prior_stats.loss

    def to_dict(self) -> Dict:
        out = {"prior " + k: v for k, v in self.prior_stats.to_dict().items()}
        out.update(self.value_stats.to_dict())
        return out

    def __repr__(self):
        return "{}\n{}".format(self.value_stats, self.prior_stats)
