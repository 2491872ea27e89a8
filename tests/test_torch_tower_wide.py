"""The launch plan of the wide tower kernel (``tower_kernel_wide`` in
``connect4_tpu_torch/models/csrc/tower.cu``, packed widths 128 and 256) as
``connect4_tpu_torch.models.tower`` mirrors it, held on the CPU: the
constants read back from the source, the grid rounded up to whole clusters
with its pad block, a block's shared memory and registers within the
H100's limits, and the weight stages, which must cover every 16-deep slab
of ``res_img`` once, in the order the plain version sums them. The kernel
itself runs on the card only (``tests/test_torch_gpu.py``,
``chip_smoke.py``); the packed weights are held against the JAX package in
``tests/test_torch_tower.py``."""

import re

import pytest
import torch

from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.models.net import fold_bn_params, init_net

torch.set_num_threads(1)

REGISTERS_SM = 65536


def _constant(name: str) -> int:
    with open(tower.SOURCE) as fh:
        return int(re.search(rf"constexpr int {name} = (\d+);", fh.read()).group(1))


def test_wide_constants_mirror_the_source():
    """``tower.py``'s mirror of the launcher holds the source's constants:
    the cluster, the slabs a stage at each width, a block's shared memory."""
    assert tower.WIDE_CLUSTER == {128: _constant("kWideCluster128"), 256: _constant("kWideCluster256")}
    assert tower.WIDE_STAGE_SLABS == {128: _constant("kWideStage128"), 256: _constant("kWideStage256")}
    assert tower.SMEM_BLOCK == _constant("kSmemLimit")


@pytest.mark.parametrize("fp, want", [
    (128, dict(stage_bytes=16384, ring_stages=8, smem=197256)),
    (256, dict(stage_bytes=32768, ring_stages=3, smem=230456)),
])
def test_wide_plan_fits_the_sm(fp, want):
    """One block an SM: two consumer warpgroups and a producer warpgroup,
    whose registers (setmaxnreg: 40 a producer thread, 232 a consumer
    thread) fill the SM's 65,536. A stage is 4 slabs of one tap; the ring
    takes as many stages as fit (at most 8): eight of 16 KB at F=128, three
    of 32 KB at F=256, beside X and Y (126 rows each), a zero row and the
    biases. It holds the stage in use, the one in flight and one ahead, and
    the block asks for no more shared memory than it may have."""
    plan = tower.wide_plan(fp)
    assert {k: plan[k] for k in want} == want
    assert plan["threads"] == 384 and 128 * 40 + 256 * 232 <= REGISTERS_SM
    assert plan["stage_bytes"] == plan["stage_slabs"] * 16 * fp * 2
    assert (fp // 16) % plan["stage_slabs"] == 0
    assert 3 <= plan["ring_stages"] <= 8 and plan["smem"] <= tower.SMEM_BLOCK


@pytest.mark.parametrize("boards, grid", [
    (1, (2, 1)), (49, (18, 1)), (64, (22, 0)), (392, (132, 1)), (512, (172, 1)), (2048, (684, 1)),
    (4096, (1366, 0)),
])
def test_wide_grid_rounds_up_to_whole_clusters(boards, grid):
    """One block a 3-board tile, rounded up to whole clusters: at F=256 an
    odd count of tiles leaves one pad block in the last cluster of two; at
    F=128 a cluster is one block and no block is a pad."""
    blocks, pad = tower.wide_grid(boards, 256)
    assert (blocks, pad) == grid
    assert blocks % tower.WIDE_CLUSTER[256] == 0 and blocks - pad == tower.tile_plan(boards)[1]
    assert tower.wide_grid(boards, 128) == (tower.tile_plan(boards)[1], 0)


@pytest.mark.parametrize("f", [100, 256])
def test_wide_stages_cover_every_slab_in_summation_order(f):
    """The stages the producer issues, unpacked from ``res_img``, give the
    residual convs' im2col matrices row after row: every 16-deep slab once,
    in (tap, channel) order, the order ``tower_plain`` sums in at these
    widths; no stage straddles two taps. F=100 runs at 128."""
    config = NetConfig(filters=f, n_fc_layers=1, n_residuals=1, compute_dtype="bfloat16")
    packed = tower.pack_weights(config, fold_bn_params(init_net(config, torch.Generator().manual_seed(f), device="cpu")))
    fp = tower.kernel_width(f)
    assert fp in tower.WIDE_STAGE_SLABS and not tower.is_layer_width(fp)
    stages = tower.wide_stages(fp, 2)
    assert stages.shape[1] == tower.wide_plan(fp)["stage_slabs"]
    assert torch.equal(stages.flatten(), torch.arange(2 * 9 * fp // 16))
    assert ((stages // (fp // 16)) == (stages[:, :1] // (fp // 16))).all()
    slabs = packed["res_img"].reshape(-1, 16 * fp)[stages.flatten()]
    unpacked = tower.smem_image_inverse(slabs, fp).reshape(2, 9 * fp, fp)
    assert torch.equal(unpacked, packed["res_w"])


@pytest.mark.parametrize("fp", [128, 256])
def test_wide_ring_slots_have_one_filler_each(fp):
    """Stage n lands in ring slot n % stages, which one block of the cluster
    always fills (slot % cluster): each slot's empty barrier lives in that
    block. Over a tower of six residual blocks every block of the cluster
    fills a share of the stages."""
    plan = tower.wide_plan(fp)
    n = torch.arange(tower.wide_stages(fp, 12).shape[0])
    slot = n % plan["ring_stages"]
    filler = slot % plan["cluster"]
    for s in range(plan["ring_stages"]):
        assert len(set(filler[slot == s].tolist())) == 1
    assert set(filler.tolist()) == set(range(plan["cluster"]))
