"""The benchmark's own count of the net's operations, and the card's peaks.

The counts are the architecture's: ``tower_flops`` and ``head_flops``
dispatch by the configuration's ``net["arch"]`` to the functions of the
same names in its reference file, ``c4bench/reference/archs/<arch>.py``,
so an architecture that a later change adds brings its counts in that new
file and the metric readers need no edit. Peaks are NVIDIA's data sheet
for the H100 SXM, dense, at the 700 W limit.
"""

from __future__ import annotations

from c4bench.reference import net as ref_net

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core operations a second
PEAK_BYTES = 3.35e12  # HBM3 bytes a second


def tower_flops(net: dict) -> int:
    """Operations of the body (the tower) on one board."""
    return ref_net.arch(net).tower_flops(net)


def head_flops(net: dict) -> int:
    """Operations of the value and policy heads on one board."""
    return ref_net.arch(net).head_flops(net)


def net_flops(net: dict) -> int:
    """Operations of one board's forward through the whole net."""
    return tower_flops(net) + head_flops(net)


def evaluations_per_move(search: dict) -> int:
    """Leaf evaluations one searched move needs: the root's, and one for
    each simulation (K walkers evaluate K leaves an iteration)."""
    return 1 + search["simulations"]
