"""The program's side of each net architecture, one file a name:
``c4bench/builders/<arch>.py`` holds ``net_config(net)``, the port's
``NetConfig`` of the configuration's ``net`` (what ``ModelConfig.net_config``
takes), and ``build(net, weights, device)``, the port's net holding the
benchmark's ``weights`` in inference mode. The kinds then drive what that
returns through the port's own entries (``make_net_evaluator``,
``make_refill_play_fn``, ``make_train_step``). The file is found by the name
``net["arch"]`` (``reference.net.arch_name``), as the reference's is; the
loading every builder shares, ``with_weights``, is here."""

from __future__ import annotations

import os
from typing import Dict

import torch

from c4bench import plugins
from c4bench.reference import net as ref_net

DIR = os.path.dirname(os.path.abspath(__file__))


def find(net: dict):
    """The program-side file of ``net``'s architecture; exits where there is none."""
    name = ref_net.arch_name(net)
    return plugins.load(os.path.join(DIR, f"{name}.py"), f"program side of architecture {name!r}")


def with_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """``model`` holding ``weights`` under its own names (its BatchNorm
    counters kept), in inference mode."""
    state = {k: v.clone() for k, v in weights.items()}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
    model.load_state_dict(state, strict=True)
    return model.eval()
