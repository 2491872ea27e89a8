"""The port's folded tower (``connect4_tpu_torch.models.tower``) against the
Pallas tower of the JAX package, run in interpret mode on the CPU as
``tests/test_pallas_net.py`` runs it: the same net (16 filters, 2 residual
blocks, fc 2), the same 261 boards, value and prior within 2e-2 (the JAX
test's own tolerance: both round to bf16 at every layer boundary and sum
in different orders). On the CPU the wrapper runs the plain version; the
CUDA kernel itself is held against it on the card by ``chip_smoke.py`` and
by ``tests/test_torch_gpu.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.env.convert import stack_boards as jstack_boards
from connect4_tpu.env.host_board import HostBoard
from connect4_tpu.eval.evaluators import make_pallas_net_evaluator
from connect4_tpu.models import init_net as jinit_net
from connect4_tpu.models.net import fold_bn_params as jfold_bn_params
from connect4_tpu.models.pallas_net import make_pallas_forward
from connect4_tpu.models.pallas_net import pack_weights as jpack_weights
from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.eval.evaluators import make_net_evaluator
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.models.convert import from_flax
from connect4_tpu_torch.models.net import fold_bn_params

SMALL = dict(filters=16, n_fc_layers=2, n_residuals=2, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def small_net():
    config = JNetConfig(**SMALL)
    net, variables = jinit_net(config, jax.random.key(7))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    folded = jfold_bn_params(config, params, stats)
    tnet = from_flax(NetConfig(**SMALL), params, stats, device="cpu")
    return config, net, params, stats, folded, tnet


def _planes(n, seed):
    return (np.random.default_rng(seed).random((n, 6, 7, 3)) < 0.25).astype(np.float32)


def test_plain_tower_matches_pallas_interpret(small_net):
    config, _, _, _, folded, tnet = small_net
    forward = make_pallas_forward(config, jpack_weights(config, folded), interpret=True)
    x = _planes(261, 1)  # two full Pallas tiles + 5: a ragged last tile
    jv, jp = (np.asarray(a) for a in forward(x))
    packed = tower.pack_weights(tnet.config, fold_bn_params(tnet))
    with torch.no_grad():
        tv, tp = tower.forward(packed, torch.from_numpy(x))
    dv, dp = np.abs(tv.numpy() - jv).max(), np.abs(tp.numpy() - jp).max()
    # measured on the CPU: |dv| ~3e-4, |dp| ~1.4e-4
    assert dv <= 2e-2 and dp <= 2e-2, (dv, dp)
    np.testing.assert_allclose(tp.sum(-1).numpy(), 1.0, atol=1e-5)
    assert ((tv >= 0) & (tv <= 1)).all()


def test_pack_weights_matches_jax(small_net):
    """Kernel-shaped weights equal the Pallas tower's: bf16 casts of the
    same folded values, equal or one bf16 step apart where the two float32
    folds straddle a rounding boundary (relative 2**-7)."""
    config, _, params, stats, _, tnet = small_net
    theirs = jpack_weights(config, jfold_bn_params(config, params, stats))
    mine = tower.pack_weights(tnet.config, fold_bn_params(tnet))
    for name, value in theirs.items():
        if name == "mask":  # the Pallas tap mask; the port computes taps in place
            continue
        ours = mine[name]
        pairs = zip(value, ours) if isinstance(value, list) else [(value, ours)]
        for j, t in pairs:
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(j, dtype=np.float32), rtol=2**-7, atol=0, err_msg=name
            )
    # the kernel's layout is the transpose of the im2col matrices
    assert torch.equal(mine["res_wt"], mine["res_w"].transpose(1, 2))


def test_evaluator_matches_pallas_evaluator_on_boards(small_net):
    _, net, params, stats, _, tnet = small_net
    boards = [HostBoard()]
    b = HostBoard()
    for mv in [3, 3, 2, 4, 1, 5, 0]:
        b.make_move(mv)
        boards.append(b.copy())
    jv, jp = jax.jit(make_pallas_net_evaluator(net, params, stats))(jstack_boards(boards))
    tv, tp = make_net_evaluator(tnet)(stack_boards(boards, device="cpu"))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-2)


def test_cpu_path_launches_no_kernel(small_net):
    *_, tnet = small_net
    before = tower.run_tower.launches
    packed = tower.pack_weights(tnet.config, fold_bn_params(tnet))
    x2d = torch.from_numpy(_planes(9, 2)).reshape(9 * 42, 3)
    out = tower.run_tower(packed, x2d)
    assert out.dtype == torch.bfloat16 and out.shape == (9 * 42, 16)
    assert torch.equal(out, tower.tower_plain(packed, x2d))
    assert tower.run_tower.launches == before == 0


def test_wrapper_never_falls_back(small_net):
    """A tensor on a device with no implementation raises; it is not
    quietly computed by the plain version."""
    *_, tnet = small_net
    packed = tower.pack_weights(tnet.config, fold_bn_params(tnet))
    with pytest.raises(ValueError, match="no implementation"):
        tower.run_tower(packed, torch.empty((42, 3), device="meta"))


def test_config_roundtrip_between_packages():
    """The port's NetConfig is a field-for-field copy of the JAX one."""
    assert dataclasses.asdict(NetConfig(**SMALL)) == dataclasses.asdict(JNetConfig(**SMALL))
