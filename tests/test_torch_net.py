"""The port's network (``connect4_tpu_torch.models``) against the Flax net:
weights carried over by ``from_flax``, the same float32 inputs, outputs
within 1e-5 (float32 convolutions summed in another order); the folded
parameters and the parameter count as the JAX package computes them; and
the packaged gen-161 net, read without JAX from its npz export."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from connect4_tpu.config import ModelConfig as JModelConfig
from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.config import StorageConfig
from connect4_tpu.env.convert import stack_boards as jstack_boards
from connect4_tpu.eval.evaluators import make_net_evaluator as jmake_net_evaluator
from connect4_tpu.models import init_net as jinit_net
from connect4_tpu.models.net import InferenceNet as JInferenceNet
from connect4_tpu.models.net import count_params as jcount_params
from connect4_tpu.models.net import fold_bn_params as jfold_bn_params
from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.eval.evaluators import make_net_evaluator
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.models.convert import _conv, _dense, from_flax, load_example_net, read_example_net
from connect4_tpu_torch.models.net import (
    InferenceNet,
    count_params,
    fold_bn_params,
    inference_net,
    init_net,
)

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)

CONFIGS = [
    dict(),  # the reference default: filters 32, fc 4, res 3
    dict(filters=16, n_fc_layers=2, n_residuals=2),
]


def _flax_variables(kw, seed=3):
    """A Flax net with random BatchNorm statistics (so folding matters)."""
    net, var = jinit_net(JNetConfig(**kw), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, var["params"])
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.uniform(0.1, 0.5, x.shape).astype(np.float32),
        var["batch_stats"],
    )
    return net, params, stats


def _planes(n, seed):
    return (np.random.default_rng(seed).random((n, 6, 7, 3)) < 0.3).astype(np.float32)


@pytest.mark.parametrize("kw", CONFIGS)
def test_from_flax_forward_matches_flax(kw):
    net, params, stats = _flax_variables(kw)
    x = _planes(33, 0)
    jv, jp = net.apply({"params": params, "batch_stats": stats}, x, train=False)
    tnet = from_flax(NetConfig(**kw), params, stats, device="cpu")
    with torch.no_grad():
        tv, tp = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)

    folded = jfold_bn_params(JNetConfig(**kw), params, stats)
    jv2, jp2 = JInferenceNet(JNetConfig(**kw)).apply({"params": folded}, x)
    with torch.no_grad():
        tv2, tp2 = inference_net(tnet)(torch.from_numpy(x))
    np.testing.assert_allclose(tv2.numpy(), np.asarray(jv2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp2), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fold_bn", [True, False])
def test_net_evaluator_matches_jax_evaluator(fold_bn):
    """``make_net_evaluator`` of a float32 net, folded or not, against the
    JAX evaluator on the same boards (planes, forward and reshapes)."""
    from connect4_tpu.env.host_board import HostBoard

    kw = CONFIGS[1]
    net, params, stats = _flax_variables(kw)
    boards = [HostBoard()]
    for mv in [3, 3, 2, 4, 1, 5, 6, 0]:
        boards.append(boards[-1].copy())
        boards[-1].make_move(mv)
    jv, jp = jax.jit(jmake_net_evaluator(net, params, stats, fold_bn=fold_bn))(jstack_boards(boards))
    tnet = from_flax(NetConfig(**kw), params, stats, device="cpu")
    tv, tp = make_net_evaluator(tnet, fold_bn=fold_bn)(stack_boards(boards, device="cpu"))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


def _inference_from_flax(config, folded):
    """The port's ``InferenceNet`` state dict from a Flax folded tree
    (the JAX ``fold_bn_params`` output)."""
    layers = {"conv0": _conv(folded["_InfConvBlock_0"]["Conv_0"])}
    for i in range(config.n_residuals):
        blk = folded[f"_InfResidualBlock_{i}"]
        layers[f"res.{2 * i}"] = _conv(blk["Conv_0"])
        layers[f"res.{2 * i + 1}"] = _conv(blk["Conv_1"])
    vh, ph = folded["_InfValueHead_0"], folded["_InfPolicyHead_0"]
    layers["vh_conv"] = _conv(vh["Conv_0"])
    for i in range(config.n_fc_layers):
        layers[f"vh_fcs.{i}"] = _dense(vh[f"Dense_{i}"])
    layers["vh_out"] = _dense(vh[f"Dense_{config.n_fc_layers}"])
    layers["ph_conv"] = _conv(ph["Conv_0"])
    layers["ph_fc"] = _dense(ph["Dense_0"])
    net = InferenceNet(config)
    net.load_state_dict({f"{name}.{k}": v for name, d in layers.items() for k, v in d.items()})
    return net.state_dict()


@pytest.mark.parametrize("kw", CONFIGS)
def test_fold_bn_params_matches_jax_fold(kw):
    """The port's fold of the converted net equals the JAX fold, converted
    (within float32 rounding of s = gamma / sqrt(var + eps): 1e-6)."""
    _, params, stats = _flax_variables(kw)
    config = NetConfig(**kw)
    mine = fold_bn_params(from_flax(config, params, stats, device="cpu"))
    theirs = _inference_from_flax(
        config, jax.tree_util.tree_map(np.asarray, jfold_bn_params(JNetConfig(**kw), params, stats))
    )
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", CONFIGS + [dict(filters=64, n_fc_layers=6, n_residuals=6)])
def test_count_params_matches_jax(kw):
    _, params, _ = _flax_variables(kw)
    net = init_net(NetConfig(**kw), torch.Generator().manual_seed(0), device="cpu")
    assert count_params(net) == jcount_params(params)
    if not kw:
        assert count_params(net) == 64575


def test_init_net_follows_flax_init():
    """LeCun-normal kernels truncated at two standard deviations, zero
    biases, BatchNorm at identity; the same seed gives the same net."""
    config = NetConfig()
    a = init_net(config, torch.Generator().manual_seed(5), device="cpu")
    b = init_net(config, torch.Generator().manual_seed(5), device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.res_blocks[0].conv0.weight
    std = np.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    assert w.abs().max() <= 2 * std
    assert abs(w.std().item() - np.sqrt(1.0 / w[0].numel())) < 0.1 * std
    assert (a.value_head.fcs[0].bias == 0).all()
    assert (a.conv_block.bn.weight == 1).all() and (a.conv_block.bn.running_var == 1).all()


def _restore_example_net():
    from connect4_tpu.training import checkpoint as ckpt
    from connect4_tpu.training.learner import TrainState, make_optimizer

    base = os.path.join(StorageConfig().data_dir, "example_net")
    with open(os.path.join(base, "net_config.json")) as fh:
        nc = JNetConfig(**json.load(fh))
    net, variables = jinit_net(nc, jax.random.key(0))
    opt = make_optimizer(JModelConfig(net_config=nc))
    template = TrainState(variables["params"], variables["batch_stats"], opt.init(variables["params"]))
    gen = ckpt.latest_generation(base)
    state, _ = ckpt.restore_checkpoint(base, gen, template, jax.random.key(0))
    return nc, net, gen, state


def test_example_net_npz_matches_checkpoint_and_jax_net():
    """The committed npz holds exactly the restored gen-161 checkpoint, and
    the port's bf16 folded tower + heads on it agree with the JAX
    ``InferenceNet`` on 64 positions within 5e-2 (both round to bf16 at
    every layer, at different points inside a layer)."""
    nc, net, gen, state = _restore_example_net()
    config, npz_gen, params, stats = read_example_net()
    assert npz_gen == gen == 161
    assert config == NetConfig(**vars(nc))
    flat = lambda tree: {  # noqa: E731
        jax.tree_util.keystr(k): np.asarray(v)
        for k, v in jax.tree_util.tree_leaves_with_path(tree)
    }
    for mine, theirs in ((params, state.params), (stats, state.batch_stats)):
        a, b = flat(mine), flat(theirs)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    rng = np.random.default_rng(0)
    boards = []
    from connect4_tpu.env.host_board import HostBoard

    while len(boards) < 64:
        b = HostBoard()
        for _ in range(rng.integers(0, 30)):
            if b.result is not None:
                break
            b.make_move(int(rng.choice(sorted(b.valid_moves))))
        if b.result is None:
            boards.append(b)
    jv, jp = jax.jit(jmake_net_evaluator(net, state.params, state.batch_stats))(jstack_boards(boards))
    tnet = load_example_net(device="cpu")
    tv, tp = make_net_evaluator(tnet)(stack_boards(boards, device="cpu"))
    dv = np.abs(tv.numpy() - np.asarray(jv)).max()
    dp = np.abs(tp.numpy() - np.asarray(jp)).max()
    assert dv <= 5e-2 and dp <= 5e-2, (dv, dp)
    assert tower.run_tower.launches == 0  # CPU states take the plain tower
