"""The port's folded tower (``connect4_tpu_torch.models.tower``) against the
Pallas tower of the JAX package, run in interpret mode on the CPU as
``tests/test_pallas_net.py`` runs it: the same net (16 filters, 2 residual
blocks, fc 2), the same 261 boards, value and prior within 2e-2 (the JAX
test's own tolerance: both round to bf16 at every layer boundary and sum
in different orders). On the CPU the wrapper runs the plain version; the
CUDA kernel itself is held against it on the card by ``chip_smoke.py`` and
by ``tests/test_torch_gpu.py``.

Widths: the fused kernel is instantiated at ``tower.KERNEL_FILTERS`` and
``pack_weights`` pads any other width up to 256 with zeros; above 256, at
any width, the layer kernel runs at the next multiple of
``tower.LAYER_STEP`` that a column tile divides (``tower.kernel_width``).
The width tests hold the padded packing, both forms of the plain version
and the evaluator against the JAX package at F = 4, 24, 128, 256, 264 and
512, and at F = 520 (packed to 576, three column tiles) the evaluator and
the emulated plain version in the layer kernel's summation order (one
residual block, fc 1, a few boards), on the same weights: Flax variables
made from a JAX key with numpy-drawn BatchNorm statistics, carried over
with ``from_flax``."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.env.convert import stack_boards as jstack_boards
from connect4_tpu.env.host_board import HostBoard
from connect4_tpu.eval.evaluators import make_net_evaluator as jmake_net_evaluator
from connect4_tpu.eval.evaluators import make_pallas_net_evaluator
from connect4_tpu.models import init_net as jinit_net
from connect4_tpu.models.net import fold_bn_params as jfold_bn_params
from connect4_tpu.models.pallas_net import make_pallas_forward
from connect4_tpu.models.pallas_net import pack_weights as jpack_weights
from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.eval.evaluators import make_net_evaluator
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.models.convert import from_flax, load_example_net, read_example_net
from connect4_tpu_torch.models.net import fold_bn_params, init_net

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)

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
    # the kernel's shared-memory images hold the same im2col matrices
    f = tnet.config.filters
    assert torch.equal(
        tower.smem_image_inverse(mine["res_img"], f).flatten(1, 2), mine["res_w"]
    )
    assert torch.equal(
        tower.smem_image_inverse(mine["conv1_img"], f)[: mine["conv1_w"].shape[0]], mine["conv1_w"]
    )


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


@pytest.mark.parametrize("filters", sorted({4, 8, 24, 48, 96, *tower.KERNEL_FILTERS}))
def test_packed_weight_image_unpacks_bit_for_bit(filters):
    """``pack_weights``' shared-memory images of the residual and input
    weights invert to the im2col matrices bit for bit, and an element sits
    where the kernel's matrix descriptor expects it. A width the kernel is
    not instantiated at is packed at the next one that is: the net's
    weights in the leading rows and columns of each tap, zeros elsewhere,
    and zero biases in the padded channels."""
    config = NetConfig(filters=filters, n_fc_layers=1, n_residuals=2, compute_dtype="bfloat16")
    net = init_net(config, torch.Generator().manual_seed(filters), device="cpu")
    folded = fold_bn_params(net)
    packed = tower.pack_weights(config, folded)
    fp = tower.kernel_width(filters)
    assert fp in tower.KERNEL_FILTERS and fp >= filters and (fp == filters) == (filters in tower.KERNEL_FILTERS)
    res_w, img = packed["res_w"], packed["res_img"]
    assert img.shape == (4, 9, fp * fp) and img.dtype == torch.bfloat16
    back = tower.smem_image_inverse(img, fp)  # [2n, 9, fp(k), fp(n)]
    assert torch.equal(back.flatten(1, 2), res_w)
    groups = fp // 8
    for layer, tap, k, n in [(0, 0, 0, 0), (1, 4, 9 % filters, filters - 3 % filters), (3, 8, filters - 1, 7 % filters)]:
        at = ((k // 8 * groups + n // 8) * 8 + n % 8) * 8 + k % 8
        assert img[layer, tap, at] == res_w[layer, tap * fp + k, n]
    taps = res_w.unflatten(1, (9, fp))  # [2n, 9, cin, cout]
    want = torch.stack([folded[f"res.{i}.weight"].permute(2, 3, 1, 0).reshape(9, filters, filters)
                        for i in range(4)]).to(torch.bfloat16)
    assert torch.equal(taps[:, :, :filters, :filters], want)
    assert not taps[:, :, filters:].any() and not taps[:, :, :, filters:].any()
    assert not packed["res_b"][:, filters:].any() and not packed["conv1_b"][filters:].any()
    conv1 = tower.smem_image_inverse(packed["conv1_img"], fp)  # [32, fp], 27 rows used
    assert conv1.shape == (32, fp)
    assert torch.equal(conv1[:27], packed["conv1_w"]) and not conv1[27:].any()
    assert not packed["conv1_w"][:, filters:].any()
    # the heads keep the net's own width
    assert packed["vh_conv_w"].shape == (filters, 1) and packed["ph_conv_w"].shape == (filters, 2)


@pytest.mark.parametrize("tensor_core", [False, True])
@pytest.mark.parametrize("chain", tower.CHAINS)
def test_plain_tower_chains_match_pallas_interpret(small_net, chain, tensor_core):
    """Every summation order the kernel can be built with, in both forms of
    the plain version (rounded to nearest, and the tensor core's accumulate
    emulated), stays within the Pallas test's tolerance of the Pallas
    tower."""
    config, _, _, _, folded, tnet = small_net
    forward = make_pallas_forward(config, jpack_weights(config, folded), interpret=True)
    x = _planes(50, 3)
    jv, jp = (np.asarray(a) for a in forward(x))
    packed = tower.pack_weights(tnet.config, fold_bn_params(tnet))
    x2d = torch.from_numpy(x).reshape(-1, 3)
    with torch.no_grad():
        tv, tp = tower.heads(packed, tower.tower_plain(packed, x2d, chain, tensor_core))
    assert np.abs(tv.numpy() - jv).max() <= 2e-2 and np.abs(tp.numpy() - jp).max() <= 2e-2
    if chain == tower.CHAIN and not tensor_core:
        # run_tower on the CPU is the plain version as shipped, rounded to nearest
        assert torch.equal(tower.run_tower(packed, x2d), tower.tower_plain(packed, x2d, chain))


@pytest.mark.parametrize(
    "boards, plan",
    [(1, (3, 1)), (64, (3, 22)), (261, (3, 87)), (512, (3, 171)), (4096, (3, 1366))],
)
def test_tile_plan_matches_the_launcher_rule(boards, plan):
    """The Python mirror of the launcher's tile: 3 boards a block at every
    batch (``kTileBoards`` in ``csrc/tower.cu``), so ceil(B / 3) blocks."""
    assert tower.tile_plan(boards) == plan
    source = open(tower.SOURCE).read()
    assert f"constexpr int kTileBoards = {tower.TILE_BOARDS};" in source
    assert f"constexpr int kShippedChain = kChain{tower.CHAIN.capitalize()};" in source


@pytest.fixture(scope="module")
def gen161_pallas():
    """The packaged gen-161 net (F=64, 6 residual blocks, where the rounding
    inside a conv matters) through the Pallas tower in interpret mode, on 64
    legal positions of random play."""
    config, _, params, stats = read_example_net()
    jconfig = JNetConfig(**vars(config))
    forward = make_pallas_forward(
        jconfig, jpack_weights(jconfig, jfold_bn_params(jconfig, params, stats)), interpret=True
    )
    rng = np.random.default_rng(0)
    boards = []
    while len(boards) < 64:
        b = HostBoard()
        for _ in range(rng.integers(0, 30)):
            if b.result is not None:
                break
            b.make_move(int(rng.choice(sorted(b.valid_moves))))
        if b.result is None:
            boards.append(b)
    x = np.stack([np.moveaxis(b.to_planes().astype(np.float32), 0, -1) for b in boards])
    jv, jp = (np.asarray(a) for a in forward(x))
    tnet = load_example_net(device="cpu")
    return x, jv, jp, tower.pack_weights(tnet.config, fold_bn_params(tnet))


@pytest.mark.parametrize("tensor_core", [False, True])
def test_plain_tower_forms_match_pallas_on_gen161(gen161_pallas, tensor_core):
    """Both forms of the plain version at the shipped chain length (the
    float32 sum rounded to nearest, and the tensor core's accumulate
    emulated) stay within the Pallas test's 2e-2 of the Pallas tower on the
    trained F=64 net. Measured: |dv| 0.0096 / 0.0067, |dp| 0.0022 / 0.0022.
    The two differ from each other by a few bf16 roundings only."""
    x, jv, jp, packed = gen161_pallas
    x2d = torch.from_numpy(x).reshape(-1, 3)
    with torch.no_grad():
        t = tower.tower_plain(packed, x2d, tower.CHAIN, tensor_core)
        tv, tp = tower.heads(packed, t)
        other = tower.tower_plain(packed, x2d, tower.CHAIN, not tensor_core)
    dv, dp = np.abs(tv.numpy() - jv).max(), np.abs(tp.numpy() - jp).max()
    assert dv <= 2e-2 and dp <= 2e-2, (dv, dp)
    assert not torch.equal(t, other)  # the rounding mode is not a no-op at F=64
    assert (t.float() - other.float()).abs().mean() <= 2e-3
    if not tensor_core:  # the CPU path is the form rounded to nearest
        assert torch.equal(tower.run_tower(packed, x2d), t)


def test_tensor_core_step_aligns_and_truncates():
    """``_tensor_core_step`` on inputs where the exact sum (which float32
    holds, so every rounding mode gives it) and the tensor core's result
    differ: addends are cut two bits below the float32 unit of the largest
    exponent before they are summed, and the sum is cut toward zero."""

    def step(a_vals, w_vals, acc=None):
        a, w = torch.zeros((1, 16)), torch.zeros((16, 1))
        a[0, : len(a_vals)] = torch.tensor(a_vals)
        w[: len(w_vals), 0] = torch.tensor(w_vals)
        exact = (a.double() @ w.double()).item() + (0.0 if acc is None else acc)
        got = tower._tensor_core_step(a, w, None if acc is None else torch.tensor([[acc]]))
        assert got.dtype == torch.float32 and got.shape == (1, 1)
        return got.item(), exact

    # unit 2**-25: the 2**-25 terms survive the cut, the 2**-26 terms go,
    # 3 * 2**-26 is cut to 2**-25; 1 + 3 * 2**-25 is then cut to 1
    got, exact = step([1, 1, 1, 1, 1, 3], [1, 2.0**-25, 2.0**-25, 2.0**-26, 2.0**-26, 2.0**-26])
    assert got == 1.0 and exact == 1.0 + 2.0**-23 + 2.0**-26
    # the accumulator takes part in the sum: 1 + (3 + 4) * 2**-25
    got, _ = step([1, 1, 1, 1, 1, 3], [1, 2.0**-25, 2.0**-25, 2.0**-26, 2.0**-26, 2.0**-26], 2.0**-23)
    assert got == 1.0 + 2.0**-23
    # an accumulator that holds the largest exponent sets the unit (2**-15)
    got, exact = step([1] * 8, [2.0**-16] * 8, 2.0**10)
    assert got == 2.0**10 and exact == 2.0**10 + 2.0**-13
    got, exact = step([1] * 4, [2.0**-15] * 4, 2.0**10)
    assert got == exact == 2.0**10 + 2.0**-13
    # a product's exponent is the sum of its factors' exponents: 1.5 * 1.5
    # = 2.25 counts as exponent 0, so the unit is 2**-25 and not 2**-24
    got, exact = step([1.5] + [1] * 8, [1.5] + [2.0**-25] * 8)
    assert got == exact == 2.25 + 2.0**-22
    got, exact = step([2.25] + [1] * 8, [1] + [2.0**-25] * 8)  # exponent 1: all cut
    assert got == 2.25 and exact == 2.25 + 2.0**-22
    # rows are emulated in blocks: a block edge changes nothing
    rows = torch.randn((70, 16), generator=torch.Generator().manual_seed(0)).bfloat16().float()
    cols = torch.randn((16, 8), generator=torch.Generator().manual_seed(1)).bfloat16().float()
    whole = tower._tensor_core_step(rows, cols, None)
    old, tower._STEP_ROWS = tower._STEP_ROWS, 32
    try:
        assert torch.equal(tower._tensor_core_step(rows, cols, None), whole)
    finally:
        tower._STEP_ROWS = old
    assert (whole - rows @ cols).abs().max() <= 1e-5


def test_round_toward_zero_truncates():
    """``_round_toward_zero`` gives the float32 neighbour nearer zero of a
    float64 that no float32 holds, and leaves float32 values alone."""
    one = torch.tensor([1.0, -1.0, 3.0, 0.0], dtype=torch.float64)
    eps = torch.tensor([2.0**-24 * 1.5, -(2.0**-24) * 1.5, 2.0**-30, 0.0], dtype=torch.float64)
    got = tower._round_toward_zero(one + eps)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.tensor([1.0, -1.0, 3.0, 0.0]))
    assert torch.equal((one + eps).float()[:2], torch.tensor([1.0 + 2.0**-23, -1.0 - 2.0**-23]))
    exact = torch.tensor([0.1, -7.25, 1e-30], dtype=torch.float32)
    assert torch.equal(tower._round_toward_zero(exact.double()), exact)


def test_config_roundtrip_between_packages():
    """The port's NetConfig is a field-for-field copy of the JAX one."""
    assert dataclasses.asdict(NetConfig(**SMALL)) == dataclasses.asdict(JNetConfig(**SMALL))


# --- widths the kernel is not instantiated at, and the wide ones -------------

WIDTHS = (4, 24, 128, 256, 264, 512)
WIDE = dict(n_fc_layers=1, n_residuals=1, compute_dtype="bfloat16")


def _boards(n, seed):
    """``n`` positions of seeded random play (the empty board first)."""
    rng = np.random.default_rng(seed)
    boards = [HostBoard()]
    while len(boards) < n:
        b = HostBoard()
        for _ in range(rng.integers(1, 20)):
            if b.result is not None:
                break
            b.make_move(int(rng.choice(sorted(b.valid_moves))))
        if b.result is None:
            boards.append(b)
    return boards


def _torch_folded(jfolded, n_residuals, n_fc):
    """The JAX package's folded parameter tree as the port's
    ``InferenceNet`` state dict, value for value (HWIO -> OIHW)."""
    def conv(t, name):
        return {f"{name}.weight": torch.from_numpy(np.array(t["kernel"], np.float32)).permute(3, 2, 0, 1),
                f"{name}.bias": torch.from_numpy(np.array(t["bias"], np.float32))}

    def dense(t, name):
        return {f"{name}.weight": torch.from_numpy(np.array(t["kernel"], np.float32)).T,
                f"{name}.bias": torch.from_numpy(np.array(t["bias"], np.float32))}

    out = conv(jfolded["_InfConvBlock_0"]["Conv_0"], "conv0")
    for i in range(n_residuals):
        for j in range(2):
            out.update(conv(jfolded[f"_InfResidualBlock_{i}"][f"Conv_{j}"], f"res.{2 * i + j}"))
    vh, ph = jfolded["_InfValueHead_0"], jfolded["_InfPolicyHead_0"]
    out.update(conv(vh["Conv_0"], "vh_conv"))
    for i in range(n_fc):
        out.update(dense(vh[f"Dense_{i}"], f"vh_fcs.{i}"))
    out.update(dense(vh[f"Dense_{n_fc}"], "vh_out"))
    out.update(conv(ph["Conv_0"], "ph_conv"))
    out.update(dense(ph["Dense_0"], "ph_fc"))
    return out


def _both_nets(f):
    """One net of ``f`` filters in both packages: Flax variables from a JAX
    key, with BatchNorm scales, biases and running statistics drawn with
    numpy so that the folds are not the identity."""
    jconfig = JNetConfig(filters=f, **WIDE)
    net, variables = jinit_net(jconfig, jax.random.key(f))
    rng = np.random.default_rng(f)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a).astype(np.float32), variables["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (a - 1.0) * 0.2 if path[-1].key == "mean" else a, stats)

    def bn(path, a):
        if path[-1].key == "scale":
            return rng.uniform(0.6, 1.4, a.shape).astype(np.float32)
        if path[-1].key == "bias" and "BatchNorm" in str(path):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(bn, params)
    jfolded = jax.tree_util.tree_map(np.asarray, jfold_bn_params(jconfig, params, stats))
    tnet = from_flax(NetConfig(filters=f, **WIDE), params, stats, device="cpu")
    boards = _boards(4, f)
    x = np.stack([np.moveaxis(b.to_planes().astype(np.float32), 0, -1) for b in boards])
    return f, jconfig, net, params, stats, jfolded, tnet, boards, x


@pytest.fixture(scope="module", params=WIDTHS, ids=lambda f: f"F{f}")
def wide_net(request):
    return _both_nets(request.param)


@pytest.fixture(scope="module")
def net_above_512():
    """A net of 520 filters, which the layer kernel runs at 576 in three
    column tiles of 192."""
    return _both_nets(520)


def test_padded_packing_equals_jax_bit_for_bit(wide_net):
    """On the JAX package's own folded values, the port's packing holds the
    Pallas tower's im2col matrices and biases bit for bit in its leading
    rows and columns, zeros in the rest, and the heads' weights as they
    are; the shared-memory images invert to the padded matrices."""
    f, jconfig, _, _, _, jfolded, *_ = wide_net
    theirs = jpack_weights(jconfig, jfolded)
    mine = tower.pack_weights(NetConfig(filters=f, **WIDE), _torch_folded(jfolded, 1, 1))
    fp = tower.kernel_width(f)
    real = {
        "conv1_w": mine["conv1_w"][:, :f],
        "conv1_b": mine["conv1_b"][:f],
        "res_w": mine["res_w"].unflatten(1, (9, fp))[:, :, :f, :f].flatten(1, 2),
        "res_b": mine["res_b"][:, :f],
    }
    for name, value in theirs.items():
        if name == "mask":
            continue
        ours = real.get(name, mine[name])
        pairs = zip(value, ours) if isinstance(value, list) else [(value, ours)]
        for j, t in pairs:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, dtype=np.float32), err_msg=name)
    assert mine["conv1_w"][:, f:].abs().sum() == 0 and mine["conv1_b"][f:].abs().sum() == 0
    assert mine["res_b"][:, f:].abs().sum() == 0
    taps = mine["res_w"].unflatten(1, (9, fp))
    assert taps[:, :, f:].abs().sum() == 0 and taps[:, :, :, f:].abs().sum() == 0
    if tower.is_layer_width(fp):
        assert torch.equal(tower.layer_image_inverse(mine["res_img"], fp), mine["res_w"])
        assert torch.equal(tower.layer_image_inverse(mine["conv1_img"], fp)[:27], mine["conv1_w"])
    else:
        assert torch.equal(tower.smem_image_inverse(mine["res_img"], fp).flatten(1, 2), mine["res_w"])
        assert torch.equal(tower.smem_image_inverse(mine["conv1_img"], fp)[:27], mine["conv1_w"])


@pytest.mark.parametrize("tensor_core", [False, True])
def test_plain_tower_at_every_width_matches_pallas(wide_net, tensor_core):
    """Both forms of the plain version on the padded packing against the
    Pallas tower in interpret mode: value and prior within the Pallas
    test's 2e-2 (measured on the CPU: at most 2.0e-4, at F=256 with the
    tensor core's accumulate emulated; 1e-7 elsewhere), and the padded
    channels of the tower output exactly 0."""
    f, jconfig, _, _, _, jfolded, tnet, _, x = wide_net
    jv, jp = (np.asarray(a) for a in make_pallas_forward(
        jconfig, jpack_weights(jconfig, jfolded), interpret=True)(x))
    packed = tower.pack_weights(tnet.config, fold_bn_params(tnet))
    x2d = torch.from_numpy(x).reshape(-1, 3)
    with torch.no_grad():
        t = tower.tower_plain(packed, x2d, tower.CHAIN, tensor_core)
        tv, tp = tower.heads(packed, t)
    assert t.shape == (len(x) * 42, tower.kernel_width(f)) and t.dtype == torch.bfloat16
    assert t[:, f:].abs().sum() == 0
    dv, dp = np.abs(tv.numpy() - jv).max(), np.abs(tp.numpy() - jp).max()
    assert dv <= 2e-2 and dp <= 2e-2, (dv, dp)
    if not tensor_core:  # the CPU path is the form rounded to nearest
        assert torch.equal(tower.run_tower(packed, x2d), t)


def test_evaluator_at_every_width_matches_jax_evaluator(wide_net):
    """The port's ``make_net_evaluator`` (folded, padded tower on the CPU)
    against the JAX package's main-path evaluator (``make_net_evaluator``,
    the folded net in XLA bf16) on the same boards: value and prior within
    2e-2, the tolerance of the port's tower against the Pallas tower
    (measured on the CPU: at most 1.6e-3, at F=128)."""
    _, _, net, params, stats, _, tnet, boards, _ = wide_net
    jv, jp = jax.jit(jmake_net_evaluator(net, params, stats))(jstack_boards(boards))
    tv, tp = make_net_evaluator(tnet)(stack_boards(boards, device="cpu"))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-2)


def test_width_above_512_matches_jax(net_above_512):
    """A bf16 net wider than 512 filters (the layer kernel's limit until it
    staged its input in k-slabs) builds, packs and evaluates: the port's
    ``make_net_evaluator`` on the CPU against the JAX package's on the same
    Flax weights, value and prior within the 2e-2 of
    ``test_evaluator_at_every_width_matches_jax_evaluator``; the packing is
    at 576 filters in three column tiles of 192, its padded channels 0."""
    f, _, net, params, stats, _, tnet, boards, _ = net_above_512
    assert f == 520 and tower.kernel_width(f) == 576 and tower.layer_tile(576) == 192
    packed = tower.pack_weights(tnet.config, fold_bn_params(tnet))
    assert packed["res_img"].shape == (2, 3, 9 * 576 * 192) and packed["conv1_img"].shape == (3, 32 * 192)
    assert not packed["res_w"][:, :, f:].any() and not packed["res_b"][:, f:].any()
    jv, jp = jax.jit(jmake_net_evaluator(net, params, stats))(jstack_boards(boards))
    tv, tp = make_net_evaluator(tnet)(stack_boards(boards, device="cpu"))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-2)


def test_plain_tower_in_slab_order_matches_pallas(net_above_512):
    """The emulated plain version, which sums a residual conv in the layer
    kernel's order (k-slab of 64 channels, tap, channel), against the Pallas
    tower in interpret mode at F=520: value and prior within the 2e-2 that
    ``test_plain_tower_at_every_width_matches_pallas`` holds the layer
    widths to, the padded channels exactly 0."""
    f, jconfig, _, _, _, jfolded, tnet, _, x = net_above_512
    jv, jp = (np.asarray(a) for a in make_pallas_forward(
        jconfig, jpack_weights(jconfig, jfolded), interpret=True)(x))
    packed = tower.pack_weights(tnet.config, fold_bn_params(tnet))
    with torch.no_grad():
        t = tower.tower_plain(packed, torch.from_numpy(x).reshape(-1, 3), tower.CHAIN, True)
        tv, tp = tower.heads(packed, t)
    assert t.shape == (len(x) * 42, 576) and not t[:, f:].any()
    dv, dp = np.abs(tv.numpy() - jv).max(), np.abs(tp.numpy() - jp).max()
    assert dv <= 2e-2 and dp <= 2e-2, (dv, dp)


def test_layer_conv_sums_in_the_kernels_order():
    """At a layer width a residual conv of the emulated plain version is
    one chain of 16-deep tensor-core steps in (k-slab of 64 channels, tap,
    channel) order, the order the layer kernel multiplies its weight slabs
    in: equal bit for bit to the steps taken by hand in that order on the
    (tap, channel) im2col matrix, and not to the (tap, channel) order."""
    fp = 320
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((2, 6, 7, fp), generator=gen) * 0.5).to(torch.bfloat16)
    w = (torch.randn((9 * fp, fp), generator=gen) * 0.05).to(torch.bfloat16)
    b = (torch.randn((fp,), generator=gen) * 0.1).to(torch.bfloat16)
    got = tower._conv3x3_plain(x, w, b, "layer", tensor_core=True)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dr:dr + 6, dc:dc + 7, :] for dr in range(3) for dc in range(3)], -1).flatten(0, 2)
    wf = w.float()

    def chain(starts):
        acc = None
        for k in starts:
            acc = tower._tensor_core_step(patches[:, k:k + 16], wf[k:k + 16], acc)
        return (acc + b.float()).unflatten(0, (2, 6, 7))

    slab_order = [tap * fp + s + kk for s in range(0, fp, 64) for tap in range(9) for kk in range(0, 64, 16)]
    assert torch.equal(got, chain(slab_order))
    assert not torch.equal(got, chain(range(0, 9 * fp, 16)))


@pytest.mark.parametrize("filters, packed", [
    (1, 16), (17, 32), (100, 128), (256, 256), (257, 320), (264, 320), (320, 320), (321, 384), (449, 512),
    (512, 512), (513, 576), (520, 576), (577, 640), (641, 768), (700, 768), (705, 768), (769, 896), (833, 896),
    (1000, 1024), (1024, 1024), (1025, 1152), (2000, 2048),
])
def test_kernel_width_pads_as_documented(filters, packed):
    """``kernel_width`` gives the widths its docstring names: a fused
    instantiation up to 256; above, the next multiple of 64 that a column
    tile of 256, 224, 192 or 160 divides, in at least two tiles. No width
    raises for being too wide."""
    fp = tower.kernel_width(filters)
    assert fp == packed
    if fp > 256:
        n = tower.layer_tile(fp)
        assert fp % tower.LAYER_STEP == 0 and n in tower.LAYER_TILE_WIDTHS and fp // n >= 2


def test_layer_widths_pad_no_more_than_before():
    """From 257 to 512 a width pads to the next multiple of 64, as it did
    before the layer kernel took wider nets; the worst wasted share of the
    residual operations, 1 - (F/Fp)^2, is 35.5% at F=257 and, above 512 (up
    to 4096), 30.3% at F=641, the shares the docstring of ``kernel_width``
    records."""
    assert all(tower.kernel_width(f) == -(-f // 64) * 64 for f in range(257, 513))
    waste = {f: 1 - (f / tower.kernel_width(f)) ** 2 for f in range(257, 4097)}
    assert max(waste, key=waste.get) == 257 and round(waste[257], 3) == 0.355
    above = {f: w for f, w in waste.items() if f > 512}
    assert max(above, key=above.get) == 641 and round(above[641], 3) == 0.303


def _layer_packed(filters):
    config = NetConfig(filters=filters, n_fc_layers=1, n_residuals=1, compute_dtype="bfloat16")
    return tower.pack_weights(config, fold_bn_params(
        init_net(config, torch.Generator().manual_seed(filters), device="cpu")))


@pytest.mark.parametrize("case", ["rows", "width", "layout", "chain"])
def test_cuda_wrapper_refuses_what_the_layer_kernel_does_not_take(case):
    """The CUDA wrapper checks what it hands the layer kernel before it
    builds or launches anything, so these raise here without a card: rows
    that are not whole boards, a packed width the layer kernel does not take
    (704, a multiple of 64 that no column tile divides), a weight image in
    the fused kernel's layout, a chain other than the whole layer."""
    packed = _layer_packed(264)
    x2d = torch.zeros((2 * 42, 3))
    chain = None
    if case == "rows":
        x2d = torch.zeros((2 * 42 + 1, 3))
    elif case == "width":
        packed = dict(packed, conv1_w=torch.zeros((27, 704), dtype=torch.bfloat16))
    elif case == "layout":
        packed = dict(packed, res_img=tower.smem_image(packed["res_w"].unflatten(1, (9, 320))))
    else:
        chain = "tap"
    with pytest.raises(ValueError):
        tower._tower_cuda(packed, x2d, chain)


@pytest.mark.parametrize("filters", [264, 320, 448, 512, 520, 1024])
def test_layer_weight_image_unpacks_bit_for_bit(filters):
    """Above 256 filters ``pack_weights`` lays the weights out for the layer
    kernel: at ``kernel_width``, in column tiles of ``layer_tile``, each
    tile's 16-deep slabs one after another in (k-slab of 64 channels, tap,
    channel) order, each slab as the wgmma descriptor reads it. The images
    invert to the padded im2col matrices bit for bit, and an element sits
    where the kernel reads it."""
    packed = _layer_packed(filters)
    fp = tower.kernel_width(filters)
    n = tower.layer_tile(fp)
    assert fp % tower.LAYER_STEP == 0 and tower.is_layer_width(fp) and n <= 256
    res_w, img = packed["res_w"], packed["res_img"]
    assert img.shape == (2, fp // n, 9 * fp * n) and img.dtype == torch.bfloat16
    assert torch.equal(tower.layer_image_inverse(img, fp), res_w)
    for layer, k, col in [(0, 0, 0), (1, 9 * fp - 1, filters - 1), (0, 4 * fp + 17, n + 5), (1, fp + 3, n - 1),
                          (0, 2 * fp + 64 + 21, fp - 1), (1, 8 * fp + fp - 65, 2 * n + 7 if fp // n > 2 else 9)]:
        tile, c = divmod(col, n)
        tap, ch = divmod(k, fp)  # im2col row: tap, then input channel
        kslab, kin = divmod(ch, 64)
        slab, kk = (kslab * 9 + tap) * 4 + kin // 16, kin % 16  # 16-deep slab in the kernel's order, row in it
        at = slab * 16 * n + ((kk // 8 * n // 8 + c // 8) * 8 + c % 8) * 8 + kk % 8
        assert img[layer, tile, at] == res_w[layer, k, col]
    assert not res_w.unflatten(1, (9, fp))[:, :, filters:].any() and not res_w[:, :, filters:].any()
    conv1 = tower.layer_image_inverse(packed["conv1_img"], fp)
    assert packed["conv1_img"].shape == (fp // n, 32 * n) and conv1.shape == (32, fp)
    assert torch.equal(conv1[:27], packed["conv1_w"]) and not conv1[27:].any()


def test_cli_training_generation_of_a_padded_bf16_net(tmp_path):
    """``cli training --device cpu`` for one generation of a bf16 net of 4
    filters, whose tower runs at the kernel's 16 (before the padding the
    packing raised): every game replays legally on the host board and the
    training loss is finite."""
    from connect4_tpu_torch.env.host_board import HostBoard as THostBoard

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = tmp_path / "run"
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from connect4_tpu_torch.config import *\n"
        "config = AlphaZeroConfig(\n"
        "    model_config=ModelConfig(net_config=NetConfig(filters=4, n_fc_layers=1, n_residuals=1,\n"
        "                                                  compute_dtype='bfloat16'),\n"
        "                             batch_size=64, n_training_epochs=1),\n"
        f"    storage_config=StorageConfig(save_dir={str(run)!r}),\n"
        "    simulations=8, n_training_games=6, selfplay_batch=4, parallel_sims=4,\n"
        "    num_sampling_moves=4, n_eval=0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "connect4_tpu_torch.cli", "training", "-c", str(cfg), "--generations", "1",
         "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    loss = re.search(r"Training loss: (\S+) -> (\S+) over (\d+) steps", proc.stdout)
    assert loss and int(loss.group(3)) > 0, proc.stdout[-2000:]
    assert np.isfinite(float(loss.group(1))) and np.isfinite(float(loss.group(2)))
    with np.load(run / "1" / "games.npz") as games:
        moves, length, result = games["moves"], games["length"], games["result"]
    assert len(result) == 6 and (result != 0).all()
    for g in range(len(result)):
        board = THostBoard()
        for t in range(int(length[g])):
            assert int(moves[g, t]) in board.valid_moves, (g, t)
            board.make_move(int(moves[g, t]))
        assert board.result is not None and board.result.code == int(result[g]), g


def test_cli_training_generation_above_256_filters(tmp_path):
    """``cli training --device cpu`` for one generation of a bf16 net of 264
    filters, whose tower runs at the layer kernel's packed width 320 (before
    the layer kernel ``kernel_width`` raised above 256): every game replays
    legally on the host board and the training loss is finite. The sets
    directory is empty, so the evaluation over them is skipped."""
    from connect4_tpu_torch.env.host_board import HostBoard as THostBoard

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = tmp_path / "run"
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from connect4_tpu_torch.config import *\n"
        "config = AlphaZeroConfig(\n"
        "    model_config=ModelConfig(net_config=NetConfig(filters=264, n_fc_layers=1, n_residuals=1,\n"
        "                                                  compute_dtype='bfloat16'),\n"
        "                             batch_size=64, n_training_epochs=1),\n"
        f"    storage_config=StorageConfig(save_dir={str(run)!r}, data_dir={str(tmp_path / 'nodata')!r}),\n"
        "    simulations=8, n_training_games=4, selfplay_batch=4, parallel_sims=4,\n"
        "    num_sampling_moves=4, n_eval=0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "connect4_tpu_torch.cli", "training", "-c", str(cfg), "--generations", "1",
         "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    loss = re.search(r"Training loss: (\S+) -> (\S+) over (\d+) steps", proc.stdout)
    assert loss and int(loss.group(3)) > 0, proc.stdout[-2000:]
    assert np.isfinite(float(loss.group(1))) and np.isfinite(float(loss.group(2)))
    with np.load(run / "1" / "games.npz") as games:
        moves, length, result = games["moves"], games["length"], games["result"]
    assert len(result) == 4 and (result != 0).all()
    for g in range(len(result)):
        board = THostBoard()
        for t in range(int(length[g])):
            assert int(moves[g, t]) in board.valid_moves, (g, t)
            board.make_move(int(moves[g, t]))
        assert board.result is not None and board.result.code == int(result[g]), g
