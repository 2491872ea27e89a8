"""Learning-curve rendering.

The counterpart of ``connect4_tpu.training.plots``: the training loop
re-renders ``8ply.png`` / ``7ply.png`` / ``match_results.png`` in
``save_dir`` after every generation from the metric tables
(``training.tables``), so progress is visible without rerunning a script.
matplotlib is imported inside ``render``: a machine without it trains all
the same and only draws no curves, and ``render`` raises an ``ImportError``
that says so.
"""

from __future__ import annotations

import os

from connect4_tpu_torch.training.tables import load_table


def render(save_dir: str, verbose: bool = True) -> None:
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            f"matplotlib is not installed, so no learning curves were drawn in {save_dir} "
            "(the metric tables are there as JSON)"
        ) from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for name, columns in (
        ("8ply", ["Average loss", "Accuracy"]),
        ("7ply", ["Average loss", "Accuracy", "prior Average loss", "prior Accuracy"]),
        ("match_results", ["return"]),
    ):
        rows = load_table(save_dir, name)
        if not rows:
            continue
        curves = {c: [row.get(c, float("nan")) for row in rows] for c in columns if c in rows[0]}
        if not curves:
            continue
        # Per-bucket accuracies (loss / draw / win) from the `correct`
        # column, {bucket: (n_members, n_correct)} per row: surfaces the
        # draw-bucket pathology directly on the learning curves.
        if "correct" in rows[0]:
            for bucket, label in (("0.0", "acc[loss]"), ("0.5", "acc[draw]"), ("1.0", "acc[win]")):
                try:
                    curves[label] = [
                        (row["correct"][bucket][1] / row["correct"][bucket][0])
                        if row["correct"][bucket][0] else float("nan")
                        for row in rows
                    ]
                except (KeyError, TypeError, IndexError):
                    break
        fig, ax = plt.subplots()
        for label, ys in curves.items():
            ax.plot(range(len(ys)), ys, label=label)
        ax.set_title(name)
        ax.legend()
        # match_results holds one row per gating match (every n_eval
        # generations), not one per generation
        ax.set_xlabel("match" if name == "match_results" else "generation")
        out = os.path.join(save_dir, f"{name}.png")
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close("all")
        if verbose:
            print("wrote", out)
