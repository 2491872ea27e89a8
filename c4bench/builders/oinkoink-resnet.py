"""The program's oinkoink ResNet: ``connect4_tpu_torch``'s ``Connect4Net``
of a ``NetConfig`` with the configuration's widths and compute dtype."""

from __future__ import annotations

import torch

from c4bench import builders


def net_config(net: dict):
    from connect4_tpu_torch.config import NetConfig

    return NetConfig(channels=net["channels"], filters=net["filters"], n_fc_layers=net["n_fc_layers"],
                     n_residuals=net["n_residuals"], compute_dtype=net["compute_dtype"])


def build(net: dict, weights, device):
    """The net on ``device`` (its default initialisation runs there and is
    overwritten) holding ``weights``, in inference mode."""
    from connect4_tpu_torch.models.net import Connect4Net

    with torch.device(device):
        model = Connect4Net(net_config(net))
    return builders.with_weights(model, weights)
