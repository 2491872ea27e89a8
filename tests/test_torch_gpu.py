"""Tests that need a CUDA card: the hand-written kernels against their
plain PyTorch versions on the card, the train step on the card against the
CPU, the data-parallel step of two ranks sharing the card against one
process, and the solver's build on the machine with the card. They skip
where there is no card. This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import pytest
import torch

from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.env.core import initial_state, legal_moves, step, to_planes
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.models.convert import load_example_net
from connect4_tpu_torch.models.net import fold_bn_params, init_net

SMALL = dict(filters=16, n_fc_layers=2, n_residuals=2, compute_dtype="bfloat16")


def _positions(n, generator):
    """Planes ``[n*42, 3]`` of legal positions after 0..35 random plies,
    rows in (board, r, c) order: the inputs the search feeds the tower."""
    state = initial_state((n,), device="cuda")
    plies = torch.randint(0, 36, (n,), generator=generator, device="cuda")
    for t in range(36):
        legal = legal_moves(state)
        weights = torch.where(legal.any(-1, keepdim=True), legal.float(), 1.0)
        move = torch.multinomial(weights, 1, generator=generator)[:, 0]
        state = step(state, move, t < plies)
    return to_planes(state).permute(0, 2, 3, 1).reshape(n * 42, 3).contiguous()


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version (the tensor core's
    accumulate emulated) on the card, at the main path's shapes, with the
    tolerances chip_smoke.py states: mean |diff| of the bf16 tower output
    <= 2e-3, max |diff| of value and prior <= 2e-2. A block takes 3
    boards: the last block holds 1 board at B=4096, 64 and 1, 2 at B=512
    and 3 at B=261."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    nets = {
        "gen161": load_example_net(device="cuda"),
        "small": init_net(NetConfig(**SMALL), torch.Generator().manual_seed(0), device="cuda"),
    }
    errors = {}
    for name, net in nets.items():
        packed = tower.pack_weights(net.config, fold_bn_params(net))
        for b in (4096, 512, 261, 64, 1):
            x2d = _positions(b, g)
            with torch.no_grad():
                before = tower.run_tower.launches
                tk = tower.run_tower(packed, x2d)
                assert tower.run_tower.launches == before + 1
                tp = tower.tower_plain(packed, x2d, tensor_core=True)
                vk, pk = tower.heads(packed, tk)
                vp, pp = tower.heads(packed, tp)
            torch.cuda.synchronize()
            assert torch.isfinite(tk.float()).all(), (name, b)
            errors[name, b] = (
                (tk.float() - tp.float()).abs().mean().item(),
                (vk - vp).abs().max().item(),
                (pk - pp).abs().max().item(),
            )
    bad = {k: e for k, e in errors.items() if e[0] > 2e-3 or max(e[1:]) > 2e-2}
    assert not bad, f"(tower mean, value max, prior max) over tolerance: {bad}; all: {errors}"


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu():
    """Three SGD steps (uint8 NCHW batches of 256 legal positions, made-up
    targets) on the card against the same steps on the CPU from the same
    weights. float32 means IEEE float32 on the card (``resolve_device``
    turns TF32 off): losses and every parameter and running statistic
    within 1e-4. bf16: losses within 5e-2, state within 5e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy

    from connect4_tpu_torch.config import ModelConfig
    from connect4_tpu_torch.training.learner import init_train_state, make_optimizer, make_train_step
    from connect4_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = []
    for _ in range(3):
        planes = _positions(256, g).reshape(256, 6, 7, 3).permute(0, 3, 1, 2).to(torch.uint8).contiguous()
        values = torch.randint(0, 3, (256,), generator=g, device="cuda").float() / 2
        priors = torch.softmax(torch.randn((256, 7), generator=g, device="cuda"), -1)
        batches.append((planes, values, priors))
    for dtype, tol_loss, tol_state in (("float32", 1e-4, 1e-4), ("bfloat16", 5e-2, 5e-3)):
        config = ModelConfig(net_config=NetConfig(**{**SMALL, "compute_dtype": dtype}))
        on_cpu = init_train_state(config, torch.Generator().manual_seed(3), "cpu")
        net = copy.deepcopy(on_cpu.net).to(dev)
        on_card = type(on_cpu)(net, make_optimizer(config, net))
        steps = [make_train_step(s.net, s.optimizer) for s in (on_cpu, on_card)]
        for batch in batches:
            a = float(steps[0](*(t.cpu() for t in batch))["loss"])
            b = float(steps[1](*batch)["loss"])
            assert abs(a - b) <= tol_loss, (dtype, a, b)
        for (k, v), w in zip(on_cpu.net.state_dict().items(), on_card.net.state_dict().values()):
            if not k.endswith("num_batches_tracked"):
                assert (v - w.cpu()).abs().max().item() <= tol_state, (dtype, k)


def _dp_rank(rank, init_file, out_file, batches):
    """One of two gloo ranks on ``cuda:0``: two data-parallel steps."""
    import torch.distributed as dist

    from connect4_tpu_torch.config import ModelConfig
    from connect4_tpu_torch.parallel import mesh as pmesh
    from connect4_tpu_torch.parallel.sharded import make_sharded_train_step
    from connect4_tpu_torch.training.learner import init_train_state

    pmesh.initialize_distributed("gloo", "cuda:0", init_method=f"file://{init_file}", rank=rank, world_size=2)
    mesh = pmesh.make_mesh((2,), "cuda:0")
    state = init_train_state(ModelConfig(net_config=NetConfig(**{**SMALL, "compute_dtype": "float32"})),
                             torch.Generator().manual_seed(3), mesh.device)
    step = make_sharded_train_step(state.net, state.optimizer, mesh)
    losses = [float(step(*(t.to(mesh.device) for t in batch))["loss"]) for batch in batches]
    torch.save((losses, {k: v.cpu() for k, v in state.net.state_dict().items()}), f"{out_file}.{rank}")
    dist.destroy_process_group()


@pytest.mark.gpu
def test_dp_step_on_card_matches_one_process(tmp_path):
    """Two gloo ranks sharing ``cuda:0`` take two float32 data-parallel
    steps at batch 256 (128 a rank): equal replicas, and within the 1e-4
    of the train step's card-vs-CPU check of one process's steps on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.multiprocessing as tmp

    from connect4_tpu_torch.config import ModelConfig
    from connect4_tpu_torch.training.learner import init_train_state, make_train_step
    from connect4_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda:0")
    g = torch.Generator(device="cuda").manual_seed(2)
    batches = []
    for _ in range(2):
        planes = _positions(256, g).reshape(256, 6, 7, 3).permute(0, 3, 1, 2).to(torch.uint8).contiguous()
        values = torch.randint(0, 3, (256,), generator=g, device="cuda").float() / 2
        priors = torch.softmax(torch.randn((256, 7), generator=g, device="cuda"), -1)
        batches.append((planes.cpu(), values.cpu(), priors.cpu()))
    out = str(tmp_path / "rank")
    tmp.spawn(_dp_rank, args=(str(tmp_path / "init"), out, batches), nprocs=2, join=True, start_method="spawn")
    (l0, s0), (l1, s1) = (torch.load(f"{out}.{r}") for r in range(2))
    assert l0 == l1 and all(torch.equal(s0[k], s1[k]) for k in s0)
    one = init_train_state(ModelConfig(net_config=NetConfig(**{**SMALL, "compute_dtype": "float32"})),
                           torch.Generator().manual_seed(3), dev)
    step = make_train_step(one.net, one.optimizer)
    for batch, got in zip(batches, l0):
        assert abs(float(step(*(t.to(dev) for t in batch))["loss"]) - got) <= 1e-4
    for k, v in one.net.state_dict().items():
        assert (v.cpu().double() - s0[k].double()).abs().max().item() <= 1e-4, k


@pytest.mark.gpu
def test_solver_builds_and_solves_on_this_machine():
    """The exact solver builds with g++ into ``build/native/`` on the
    machine with the card and solves a known position."""
    if not torch.cuda.is_available():
        pytest.skip("needs the machine with the CUDA card")
    import os

    from connect4_tpu_torch import build
    from connect4_tpu_torch.env.host_board import HostBoard
    from connect4_tpu_torch.native import solver

    exact = solver.ExactSolver(1 << 20)
    assert os.path.exists(build.library_path(solver.SOURCE, build.GXX))
    board = HostBoard()
    for m in [0, 2, 0, 3, 6, 4]:  # x holds an open three on the bottom row; o to move loses
        board.make_move(m)
    assert exact.outcome_to_move(board) == -1 and exact.absolute_value(board) == 0.0
