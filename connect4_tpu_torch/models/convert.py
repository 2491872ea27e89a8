"""Carry Flax weights into the port.

``from_flax`` takes the JAX package's ``params`` and ``batch_stats`` trees
(nested dicts of numpy arrays, in the layout of the Flax modules) and
returns a ``Connect4Net`` holding the same numbers in PyTorch layouts:

- conv kernels HWIO ``[kh, kw, Cin, F]`` -> OIHW ``[F, Cin, kh, kw]``;
- Dense kernels ``[in, out]`` -> Linear weights ``[out, in]``. Rows stay in
  Flax's (row, col, channel) flatten order, which the port's heads keep;
- BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``.

``train_state_from_flax`` carries a whole mid-training learner state over
(parameters, running statistics, the SGD momentum trace and the learning
rate), so that both learners can take their next steps from the same point.

``to_flax`` and ``write_example_net`` go the other way: a net's weights as
Flax trees, and an npz of them that ``load_example_net`` reads (how
``scripts.ship_run_artifacts`` ships a run's generation).

``load_example_net`` reads the packaged gen-161 net from
``connect4_tpu_torch/data/example_net_161.npz`` (written from the JAX
checkpoint by ``scripts/export_example_net_npz.py``), so the port runs the
trained net with no JAX or Orbax installed.

The JAX package builds the oinkoink ResNet only: a squeeze-and-excitation
net (``config.SENetConfig``) has no Flax counterpart, so ``from_flax`` and
``to_flax`` raise for one.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from connect4_tpu_torch.config import ModelConfig, NetConfig
from connect4_tpu_torch.models.net import Connect4Net, is_se
from connect4_tpu_torch.utils import DeviceLike, resolve_device

EXAMPLE_NET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data",
    "example_net_161.npz",
)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out = {"weight": _t(tree["kernel"]).permute(3, 2, 0, 1).contiguous()}
    if "bias" in tree:
        out["bias"] = _t(tree["bias"])
    return out


def _dense(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _t(tree["kernel"]).T.contiguous(), "bias": _t(tree["bias"])}


def _bn(params: Mapping[str, Any], stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        "weight": _t(params["scale"]),
        "bias": _t(params["bias"]),
        "running_mean": _t(stats["mean"]),
        "running_var": _t(stats["var"]),
    }


def _prefixed(prefix: str, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in tensors.items()}


def _no_se(config: NetConfig) -> None:
    if is_se(config):
        raise ValueError(f"the JAX package has no squeeze-and-excitation net: no Flax counterpart of {config}")


def from_flax(
    config: NetConfig,
    params: Mapping[str, Any],
    batch_stats: Mapping[str, Any],
    device: DeviceLike = None,
) -> Connect4Net:
    """A ``Connect4Net`` (eval mode) with the weights of the Flax
    ``Connect4Net`` variables ``{'params': params, 'batch_stats': batch_stats}``."""
    _no_se(config)
    sd: Dict[str, torch.Tensor] = {}
    cb, cbs = params["_ConvBlock_0"], batch_stats["_ConvBlock_0"]
    sd.update(_prefixed("conv_block.conv", _conv(cb["Conv_0"])))
    sd.update(_prefixed("conv_block.bn", _bn(cb["BatchNorm_0"], cbs["BatchNorm_0"])))
    for i in range(config.n_residuals):
        rb, rbs = params[f"_ResidualBlock_{i}"], batch_stats[f"_ResidualBlock_{i}"]
        for j in range(2):
            sd.update(_prefixed(f"res_blocks.{i}.conv{j}", _conv(rb[f"Conv_{j}"])))
            sd.update(_prefixed(
                f"res_blocks.{i}.bn{j}", _bn(rb[f"BatchNorm_{j}"], rbs[f"BatchNorm_{j}"])
            ))
    vh, vhs = params["_ValueHead_0"], batch_stats["_ValueHead_0"]
    sd.update(_prefixed("value_head.conv", _conv(vh["Conv_0"])))
    sd.update(_prefixed("value_head.bn", _bn(vh["BatchNorm_0"], vhs["BatchNorm_0"])))
    for i in range(config.n_fc_layers):
        sd.update(_prefixed(f"value_head.fcs.{i}", _dense(vh[f"Dense_{i}"])))
    sd.update(_prefixed("value_head.out", _dense(vh[f"Dense_{config.n_fc_layers}"])))
    ph, phs = params["_PolicyHead_0"], batch_stats["_PolicyHead_0"]
    sd.update(_prefixed("policy_head.conv", _conv(ph["Conv_0"])))
    sd.update(_prefixed("policy_head.bn", _bn(ph["BatchNorm_0"], phs["BatchNorm_0"])))
    sd.update(_prefixed("policy_head.fc", _dense(ph["Dense_0"])))

    net = Connect4Net(config)
    # strict=False only for the BatchNorm step counters, which Flax lacks
    missing, unexpected = net.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"from_flax: missing {missing}, unexpected {unexpected}")
    return net.to(resolve_device(device)).eval()


def train_state_from_flax(
    config: ModelConfig,
    params: Mapping[str, Any],
    batch_stats: Mapping[str, Any],
    momentum: Mapping[str, Any],
    learning_rate: float,
    device: DeviceLike = None,
):
    """The port's ``TrainState`` (net and SGD optimiser) from the leaves of
    a JAX ``TrainState`` as numpy arrays: ``params`` and ``batch_stats`` as
    for ``from_flax``, ``momentum`` the optimiser's momentum trace (a tree
    shaped like ``params``) and the injected learning rate."""
    from connect4_tpu_torch.training.learner import TrainState, make_optimizer, set_learning_rate

    net = from_flax(config.net_config, params, batch_stats, device=device)
    optimizer = set_learning_rate(make_optimizer(config, net), float(learning_rate))
    # the trace has the layout of the params, so the same conversion puts
    # each momentum buffer into its parameter's PyTorch layout
    trace = from_flax(config.net_config, momentum, batch_stats, device=device)
    for p, m in zip(net.parameters(), trace.parameters()):
        optimizer.state[p]["momentum_buffer"] = m.detach().clone()
    return TrainState(net, optimizer)


def unflatten(arrays: Mapping[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """``{'params/a/b/kernel': x, ...}`` -> ``{'a': {'b': {'kernel': x}}}``
    for the keys under ``prefix``."""
    tree: Dict[str, Any] = {}
    for key, value in arrays.items():
        head, _, rest = key.partition("/")
        if head != prefix:
            continue
        *path, leaf = rest.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def read_example_net(path: str = EXAMPLE_NET):
    """``(net_config, generation, params, batch_stats)`` from the npz,
    the Flax trees as nested dicts of numpy arrays."""
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    config = NetConfig(**json.loads(str(arrays.pop("net_config"))))
    generation = int(arrays.pop("generation"))
    return config, generation, unflatten(arrays, "params"), unflatten(arrays, "batch_stats")


def to_flax(net: Connect4Net):
    """``(params, batch_stats)``: the net's weights as the Flax trees
    ``from_flax`` takes (nested dicts of float32 numpy arrays), so that
    ``from_flax(net.config, *to_flax(net))`` is the net bit for bit."""
    _no_se(net.config)
    sd = {k: v.detach().cpu().float().numpy() for k, v in net.state_dict().items()}

    def conv(prefix):
        out = {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0).copy()}
        if f"{prefix}.bias" in sd:
            out["bias"] = sd[f"{prefix}.bias"]
        return out

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T.copy(), "bias": sd[f"{prefix}.bias"]}

    def bn(prefix):
        return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
                {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]})

    config = net.config
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    p, s = bn("conv_block.bn")
    params["_ConvBlock_0"] = {"Conv_0": conv("conv_block.conv"), "BatchNorm_0": p}
    stats["_ConvBlock_0"] = {"BatchNorm_0": s}
    for i in range(config.n_residuals):
        rp, rs = {}, {}
        for j in range(2):
            rp[f"Conv_{j}"] = conv(f"res_blocks.{i}.conv{j}")
            rp[f"BatchNorm_{j}"], rs[f"BatchNorm_{j}"] = bn(f"res_blocks.{i}.bn{j}")
        params[f"_ResidualBlock_{i}"], stats[f"_ResidualBlock_{i}"] = rp, rs
    p, s = bn("value_head.bn")
    vh = {"Conv_0": conv("value_head.conv"), "BatchNorm_0": p}
    for i in range(config.n_fc_layers):
        vh[f"Dense_{i}"] = dense(f"value_head.fcs.{i}")
    vh[f"Dense_{config.n_fc_layers}"] = dense("value_head.out")
    params["_ValueHead_0"], stats["_ValueHead_0"] = vh, {"BatchNorm_0": s}
    p, s = bn("policy_head.bn")
    params["_PolicyHead_0"] = {
        "Conv_0": conv("policy_head.conv"), "BatchNorm_0": p, "Dense_0": dense("policy_head.fc")
    }
    stats["_PolicyHead_0"] = {"BatchNorm_0": s}
    return params, stats


def _flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{prefix}/{name}"))
        else:
            out[f"{prefix}/{name}"] = np.asarray(value, dtype=np.float32)
    return out


def write_example_net(path: str, net: Connect4Net, generation: int) -> str:
    """Write ``net`` as an npz in the layout ``read_example_net`` reads (the
    one ``scripts/export_example_net_npz.py`` writes from the JAX package):
    the Flax trees flattened to ``params/...`` and ``batch_stats/...``, the
    net config as JSON and the generation."""
    import dataclasses

    params, stats = to_flax(net)
    arrays = {**_flatten(params, "params"), **_flatten(stats, "batch_stats")}
    arrays["net_config"] = np.array(json.dumps(dataclasses.asdict(net.config)))
    arrays["generation"] = np.array(int(generation), dtype=np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def load_example_net(path: str = EXAMPLE_NET, device: DeviceLike = None) -> Connect4Net:
    """The packaged trained net (generation 161 by default) as a
    ``Connect4Net``; its config is ``net.config``."""
    config, _, params, batch_stats = read_example_net(path)
    return from_flax(config, params, batch_stats, device=device)
