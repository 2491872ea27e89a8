"""The learner's positions a second over the traced run's whole window, by
the host clock: ``train_positions_per_s`` read per layer, in a cell whose
step the host paces and whose rate therefore swings with the host's speed
from machine to machine. None without a step."""


def read(seg):
    if not seg.get("positions"):
        return None
    return seg.get("wall_positions_per_s")
