"""The benchmark's own count of the net's operations, and the card's peaks.

A frozen copy of the arithmetic of the program's tower bound
(``connect4_tpu_torch.models.tower.tower_bound``): every multiply-add of the
convolutions on the 42 cells of a board counts two operations, at the
configuration's own widths, whatever padding or batching the program uses.
The heads add their 1x1 convolutions and Dense layers. Peaks are NVIDIA's
data sheet for the H100 SXM, dense, at the 700 W limit.
"""

from __future__ import annotations

CELLS = 42
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core operations a second
PEAK_BYTES = 3.35e12  # HBM3 bytes a second


def tower_flops(net: dict) -> int:
    """Operations of the conv tower on one board: the 3x3 input conv and
    two 3x3 convs a residual block."""
    c, f, n = net["channels"], net["filters"], net["n_residuals"]
    return CELLS * 2 * (9 * c * f + 2 * n * 9 * f * f)


def head_flops(net: dict) -> int:
    """Operations of both heads on one board: the value head's 1x1 conv to
    one channel and its Dense layers, the policy head's 1x1 conv to two
    channels and its Dense to 7."""
    f, n_fc = net["filters"], net["n_fc_layers"]
    value = CELLS * 2 * f + n_fc * 2 * CELLS * CELLS + 2 * CELLS
    policy = CELLS * 2 * f * 2 + 2 * (2 * CELLS) * 7
    return value + policy


def net_flops(net: dict) -> int:
    """Operations of one board's forward through the whole net."""
    return tower_flops(net) + head_flops(net)


def evaluations_per_move(search: dict) -> int:
    """Leaf evaluations one searched move needs: the root's, and one for
    each simulation (K walkers evaluate K leaves an iteration)."""
    return 1 + search["simulations"]
