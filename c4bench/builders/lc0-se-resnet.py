"""The program's squeeze-and-excitation body (Leela Chess Zero's):
``connect4_tpu_torch``'s ``Connect4Net`` of an ``SENetConfig`` with the
configuration's widths, ratio and compute dtype. A program without
``SENetConfig`` cannot build it: loading this file then exits at once,
naming the architecture."""

from __future__ import annotations

import torch

from c4bench import builders

try:
    from connect4_tpu_torch.config import SENetConfig
except ImportError:
    raise SystemExit("c4bench: architecture 'lc0-se-resnet': the program has no "
                     "connect4_tpu_torch.config.SENetConfig, so it cannot build this net") from None


def net_config(net: dict):
    return SENetConfig(channels=net["channels"], filters=net["filters"], n_fc_layers=net["n_fc_layers"],
                       n_residuals=net["n_residuals"], compute_dtype=net["compute_dtype"],
                       se_ratio=net["se_ratio"])


def build(net: dict, weights, device):
    """The net on ``device`` (its default initialisation runs there and is
    overwritten) holding ``weights``, in inference mode."""
    from connect4_tpu_torch.models.net import Connect4Net

    with torch.device(device):
        model = Connect4Net(net_config(net))
    return builders.with_weights(model, weights)
