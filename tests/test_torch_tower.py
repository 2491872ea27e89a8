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


@pytest.mark.parametrize("filters", tower.KERNEL_FILTERS)
def test_packed_weight_image_unpacks_bit_for_bit(filters):
    """``pack_weights``' shared-memory images of the residual and input
    weights invert to the im2col matrices bit for bit, and an element sits
    where the kernel's matrix descriptor expects it."""
    config = NetConfig(filters=filters, n_fc_layers=1, n_residuals=2, compute_dtype="bfloat16")
    net = init_net(config, torch.Generator().manual_seed(filters), device="cpu")
    packed = tower.pack_weights(config, fold_bn_params(net))
    res_w, img = packed["res_w"], packed["res_img"]
    assert img.shape == (4, 9, filters * filters) and img.dtype == torch.bfloat16
    back = tower.smem_image_inverse(img, filters)  # [2n, 9, F(k), F(n)]
    assert torch.equal(back.flatten(1, 2), res_w)
    groups = filters // 8
    for layer, tap, k, n in [(0, 0, 0, 0), (1, 4, 9, filters - 3), (3, 8, filters - 1, 7)]:
        at = ((k // 8 * groups + n // 8) * 8 + n % 8) * 8 + k % 8
        assert img[layer, tap, at] == res_w[layer, tap * filters + k, n]
    conv1 = tower.smem_image_inverse(packed["conv1_img"], filters)  # [32, F], 27 rows used
    assert conv1.shape == (32, filters)
    assert torch.equal(conv1[:27], packed["conv1_w"]) and not conv1[27:].any()


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
