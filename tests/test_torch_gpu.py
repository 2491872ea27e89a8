"""Tests that need a CUDA card: the hand-written kernels against their
plain PyTorch versions on the card, the train step on the card against the
CPU, the data-parallel step of two ranks sharing the card against one
process, the solver's build on the machine with the card,
``scripts.evaluate_posn`` on the card against the CPU, the search
replayed from CUDA graphs against its eager form and against the level
form, the descent kernel against its plain version, and a traced search's
marks and counters. They skip where there is no card. This file imports neither JAX nor the JAX package:

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
def test_kernel_equals_its_emulation_at_every_width():
    """At widths the kernel pads (F=24 runs at 32) and at the wide
    instantiations (F=128, 256), on fresh nets of two residual blocks: the
    kernel equals the plain version with the tensor core's accumulate
    emulated on the same packed weights in every element, and the padded
    channels are 0. A block takes 3 boards, so the last block holds 3, 1
    and 1 boards at B=261, 64 and 1. The wide kernel (F=128, 256) is also
    held at batches whose block count is odd (B=2048, 392, 261, 49 and 1:
    683, 131, 87, 17 and 1 blocks): at F=256 it runs in clusters of two
    blocks, and the last cluster then holds a pad block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(1)
    for f in (24, 128, 256):
        config = NetConfig(filters=f, n_fc_layers=2, n_residuals=2, compute_dtype="bfloat16")
        net = init_net(config, torch.Generator().manual_seed(f), device="cuda")
        packed = tower.pack_weights(config, fold_bn_params(net))
        for b in (261, 64, 1) if f < 128 else (2048, 392, 261, 64, 49, 1):
            if f == 256:
                assert tower.wide_grid(b, 256)[1] == int(b != 64), b  # a pad block but at B=64
            x2d = _positions(b, g)
            with torch.no_grad():
                tk = tower.run_tower(packed, x2d)
                tp = tower.tower_plain(packed, x2d, tensor_core=True)
            torch.cuda.synchronize()
            assert tk.shape == (b * 42, tower.kernel_width(f))
            assert int((tk != tp).sum()) == 0, (f, b)
            assert not tk[:, f:].any(), (f, b)


@pytest.mark.gpu
def test_layer_kernel_equals_its_emulation():
    """Above 256 filters (F=264 runs at 320, F=512 at 512) the tower runs
    through the layer kernel, one launch a conv: on fresh nets of two
    residual blocks it equals the plain version with the tensor core's
    accumulate emulated on the same packed weights in every element, and
    the padded channels are 0. A block takes 3 boards and one of two column
    tiles, so the last row tile holds 1 board at B=64 and 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(2)
    for f in (264, 512):
        config = NetConfig(filters=f, n_fc_layers=2, n_residuals=2, compute_dtype="bfloat16")
        net = init_net(config, torch.Generator().manual_seed(f), device="cuda")
        packed = tower.pack_weights(config, fold_bn_params(net))
        for b in (64, 1):
            x2d = _positions(b, g)
            with torch.no_grad():
                forwards, layers = tower.run_tower.launches, tower.run_tower.layer_launches
                tk = tower.run_tower(packed, x2d)
                assert tower.run_tower.launches == forwards + 1
                assert tower.run_tower.layer_launches == layers + 5  # the input conv and 2 x 2
                tp = tower.tower_plain(packed, x2d, tensor_core=True)
            torch.cuda.synchronize()
            assert tk.shape == (b * 42, tower.kernel_width(f))
            assert int((tk != tp).sum()) == 0, (f, b)
            assert not tk[:, f:].any(), (f, b)


@pytest.mark.gpu
@pytest.mark.parametrize("filters", [520, 1024])
def test_layer_kernel_equals_its_emulation_above_512(filters):
    """Above 512 filters (F=520 runs at 576 in three column tiles of 192,
    F=1024 at 1024 in four of 256) the layer kernel equals the plain version
    with the tensor core's accumulate emulated, in its (k-slab, tap,
    channel) order, in every element, on fresh nets of one residual block,
    and the padded channels are 0. The last row tile holds 1 board at B=64
    and 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(3)
    config = NetConfig(filters=filters, n_fc_layers=1, n_residuals=1, compute_dtype="bfloat16")
    net = init_net(config, torch.Generator().manual_seed(filters), device="cuda")
    packed = tower.pack_weights(config, fold_bn_params(net))
    for b in (64, 1):
        x2d = _positions(b, g)
        with torch.no_grad():
            layers = tower.run_tower.layer_launches
            tk = tower.run_tower(packed, x2d)
            assert tower.run_tower.layer_launches == layers + 3  # the input conv and 2
            tp = tower.tower_plain(packed, x2d, tensor_core=True)
        torch.cuda.synchronize()
        assert tk.shape == (b * 42, tower.kernel_width(filters))
        assert int((tk != tp).sum()) == 0, (filters, b)
        assert not tk[:, filters:].any(), (filters, b)


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


@pytest.mark.gpu
def test_evaluate_posn_on_card_matches_cpu(tmp_path):
    """``scripts.evaluate_posn`` with the packaged gen-161 net on the card
    (the tower kernel) against the CPU (its plain version, rounded to
    nearest): the value within 5e-2 and the prior within 2e-2, the
    tolerances ``chip_smoke.py`` holds the kernel to against that version.
    The search on the card runs through the kernel as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from connect4_tpu_torch.scripts import evaluate_posn

    pos = tmp_path / "position.txt"
    pos.write_text(". . . . . . .\n. . . . . . .\n. . . . . . .\n. . . x . . .\n"
                   ". . o o x . .\n. x o o x o .\n")
    before = tower.run_tower.launches
    card = evaluate_posn.main([str(pos), "--search", "--simulations", "64", "--device", "cuda"])
    assert tower.run_tower.launches > before + 64  # the root and every search iteration
    cpu = evaluate_posn.main([str(pos), "--device", "cpu"])
    assert card["player"] == cpu["player"] == "gen161"
    assert abs(card["value"] - cpu["value"]) <= 5e-2
    assert max(abs(a - b) for a, b in zip(card["prior"], cpu["prior"])) <= 2e-2
    assert sum(card["root_visits"]) == 64


def _search_roots(rows, seed):
    """``rows`` boards after up to 30 random plies on the card, finished
    ones masked inactive."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    state = initial_state((rows,), device="cuda")
    plies = torch.randint(0, 30, (rows,), generator=g, device="cuda")
    for t in range(30):
        legal = legal_moves(state)
        move = torch.multinomial(torch.where(legal.any(-1, keepdim=True), legal.float(), 1.0), 1, generator=g)[:, 0]
        state = step(state, move, t < plies)
    return state, state.result == 0


def _search_results_equal(a, b):
    for name in ("move", "value", "values_policy", "visit_policy", "root_value"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name, x, y in zip(a.tree._fields, a.tree, b.tree):
        assert torch.equal(x, y), f"tree.{name}"


@pytest.mark.gpu
@pytest.mark.parametrize("rows, k, sims", [(512, 8, 64), (49, 1, 32)])
def test_graphed_search_equals_eager_on_card(rows, k, sims):
    """The search replayed from CUDA graphs against its eager form (the
    same ops dispatched one by one) on the card, gen-161 through the tower
    kernel, noise and sampling on, one generator seed: bit for bit in
    moves, policies, values and every tree slab, at the bench's pool (512
    rows, K=8) and the gating match's K=1 side (49 rows). The eager form
    repeats itself; the replayed search makes no host sync (the sync debug
    mode raises on one) and counts as many tower launches as the eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.mcts.batched import Search

    state, active = _search_roots(rows, rows)
    config = MCTSConfig(simulations=sims, parallel_sims=k, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    evaluator = make_net_evaluator(load_example_net(device="cuda"))

    def run(search, mode="default"):
        generator = torch.Generator(device="cuda").manual_seed(1)
        before = tower.run_tower.launches
        torch.cuda.set_sync_debug_mode(mode)
        try:
            res = search(state, generator, active)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return res, tower.run_tower.launches - before

    eager = Search(evaluator, config, graphs=False)
    e1, e_launches = run(eager)
    e2, _ = run(eager)
    _search_results_equal(e1, e2)
    graphed = Search(evaluator, config)
    g1, g1_launches = run(graphed)  # warm-up and capture
    g2, g2_launches = run(graphed, "error")  # replays
    _search_results_equal(e1, g1)
    _search_results_equal(e1, g2)
    assert e_launches == g1_launches == g2_launches == 1 + sims // k
    (ws,) = graphed.workspaces.values()
    assert set(ws.graphs.graph) == {"iteration"}


def _level_form(search, state, generator, active):
    """The search with every iteration's descent as ``min(t - 1, 42)``
    levels (``Search.level_iteration``: with graphs, a level graph and a
    tail graph), as it ran before the descent kernel."""
    with torch.no_grad():
        ws = search.init(state, generator, active)
        for t in range(1, search.config.simulations // search.config.parallel_sims + 1):
            ws.iteration = t
            search.level_iteration(ws)
        return search.finish(ws, generator)


@pytest.mark.gpu
@pytest.mark.parametrize("rows, k, sims", [(512, 8, 64), (49, 1, 32)])
def test_graphed_search_equals_the_level_form_on_card(rows, k, sims):
    """The graphed search, whose iterations launch the descent kernel once
    each, against the level form on the card (the search's descent as
    replays of a one-level graph), gen-161, noise and sampling on: bit for
    bit, with as many tower launches, and the kernel launched once an
    iteration by the one and never by the other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.mcts import batched
    from connect4_tpu_torch.mcts.batched import Search

    state, active = _search_roots(rows, rows + 1)
    config = MCTSConfig(simulations=sims, parallel_sims=k, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    evaluator = make_net_evaluator(load_example_net(device="cuda"))
    out = {}
    for form in ("kernel", "levels"):
        search = Search(evaluator, config)
        for call in range(2):  # the warm-up and captures, then replays
            generator = torch.Generator(device="cuda").manual_seed(1)
            before = tower.run_tower.launches, batched.descend.launches
            res = search(state, generator, active) if form == "kernel" else _level_form(search, state, generator,
                                                                                        active)
            torch.cuda.synchronize()
            out[form, call] = res, tower.run_tower.launches - before[0], batched.descend.launches - before[1]
        (ws,) = search.workspaces.values()
        assert set(ws.graphs.graph) == ({"iteration"} if form == "kernel" else {"level", "tail"})
    for call in range(2):
        (a, a_towers, a_descents), (b, b_towers, b_descents) = out["kernel", call], out["levels", call]
        _search_results_equal(a, b)
        assert a_towers == b_towers == 1 + sims // k
        assert (a_descents, b_descents) == (sims // k, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("rows, k, sims", [(512, 8, 200), (49, 1, 64)])
def test_descent_kernel_equals_plain_on_card(rows, k, sims):
    """On the trees of a search on the card (gen-161, noise on), before
    the descent of every iteration after the first: the descent kernel
    equals ``descend_plain`` until no row descends in every field of the
    descent (leaf, board, flags, path, depth, levels walked), and the
    level form, ``min(t - 1, 42)`` levels, walks the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.mcts import batched

    def clone(d):
        return batched.Descent(d.node.clone(), d.board.map(torch.clone), d.descending.clone(), d.path.clone(),
                               d.depth.clone(), d.level.clone())

    def fields(d):
        return [d.node, *d.board, d.descending, d.path, d.depth, d.level]

    state, active = _search_roots(rows, rows + 2)
    config = MCTSConfig(simulations=sims, parallel_sims=k, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    search = batched.Search(make_net_evaluator(load_example_net(device="cuda")), config, graphs=False)
    kk = k if k > 1 else 0
    deepest = 0
    with torch.no_grad():
        ws = search.init(state, torch.Generator(device="cuda").manual_seed(1), active)
        for t in range(1, sims // k + 1):
            ws.iteration = t
            if t > 1:
                kernel, plain, bounded = clone(ws.descent), clone(ws.descent), clone(ws.descent)
                batched.descend(kernel, ws.tree, ws.rows, config, ws.capacity, kk)
                batched.descend_plain(plain, ws.tree, ws.rows, config, ws.capacity, kk)
                for _ in range(min(t - 1, batched.PATH_MAX - 2)):
                    batched._descend_level(bounded, ws.tree, ws.rows, config, ws.capacity, kk)
                for i, (x, y, z) in enumerate(zip(fields(kernel), fields(plain), fields(bounded))):
                    assert torch.equal(x, y), (t, i)
                    assert i == 8 or torch.equal(x, z), (t, i)  # the bounded form's level is its own
                deepest = max(deepest, int(kernel.depth.max()))
            search.iteration(ws)
    assert deepest >= 3


@pytest.mark.gpu
def test_refill_self_play_graphed_equals_eager_on_card(monkeypatch):
    """A refill self-play of 64 games in 32 slots with gen-161 (K=8, 32
    simulations, noise and sampling on) is the same in both forms of the
    search: every record, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import functools

    import connect4_tpu_torch.training.self_play as sp
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.mcts import batched

    config = MCTSConfig(simulations=32, parallel_sims=8, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    evaluator = make_net_evaluator(load_example_net(device="cuda"))
    outs = {}
    for graphs in (False, True):
        monkeypatch.setattr(sp, "make_search_fn", functools.partial(batched.make_search_fn, graphs=graphs))
        play = sp.make_refill_play_fn(evaluator, config, 32, 64, device="cuda")
        outs[graphs] = play(torch.Generator(device="cuda").manual_seed(0))
        assert all((ws.graphs is not None) == graphs for ws in play.search.workspaces.values())
    assert int((outs[True].result != 0).sum()) == 64
    for name, a, b in zip(outs[False]._fields, outs[False], outs[True]):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_traced_graphed_search_spans_and_counters_on_card(tmp_path):
    """A traced, graphed search at 64 rows of 8 walkers (gen-161, 64
    simulations, noise on): its iteration graph holds the five phases'
    marks, the closing mark and one counter update, where the same search
    untraced holds none, and the marks count at each replay; in a device trace every kernel, copy and set of
    every replay falls in a span, and the phases' card time is the
    replays'; the boards counted by class are the boards the tower kernel
    took; and the results equal the untraced search's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from connect4_tpu_torch import launches
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.mcts.batched import Search
    from connect4_tpu_torch.scripts import _common

    rows, k, sims = 64, 8, 64
    state, active = _search_roots(rows, rows)
    config = MCTSConfig(simulations=sims, parallel_sims=k, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    evaluator = make_net_evaluator(load_example_net(device="cuda"))

    def run(search):
        res = search(state, torch.Generator(device="cuda").manual_seed(1), active)
        torch.cuda.synchronize()
        return res

    def logged(search):
        (ws,) = search.workspaces.values()
        return ws.graphs.launches["iteration"]

    plain = Search(evaluator, config)
    run(plain)  # warm-up and capture
    untraced = run(plain)
    assert not any(record in (launches._record_mark, launches._record_update) for record, _ in logged(plain))
    previous = launches.tracing(True)
    try:
        traced = Search(evaluator, config)
        run(traced)
        assert [args[0] for record, args in logged(traced) if record is launches._record_mark] == [
            *launches.SEARCH_PHASES, "end"]
        assert sum(record is launches._record_update for record, _ in logged(traced)) == 1
        launches.reset_counters()
        marks = dict(launches.MARKS)
        before = {f: dict(per) for f, per in tower.run_tower.by_shape.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = run(traced)
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
        evals = launches.counters()["evals"]
    finally:
        launches.tracing(previous)
    _search_results_equal(untraced, res)
    for name in (*launches.SEARCH_PHASES, "end"):  # counted at each replay
        assert launches.MARKS[name] - marks.get(name, 0) == sims // k, name
    boards = sum(b * (n - before.get(f, {}).get(b, 0)) for f, per in tower.run_tower.by_shape.items()
                 for b, n in per.items())
    assert sum(evals.values()) == boards == rows + sims // k * rows * k
    assert evals["idle"] == int((~active).sum()) * (1 + sims)

    events = _common.trace_events(str(tmp_path))
    times = _common.span_times(events)
    spans = times["spans"]
    assert times["unattributed_replayed"] == 0
    assert [spans[n]["calls"] for n in launches.SEARCH_PHASES] == [sims // k] * 5
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and "GraphLaunch" in e["name"]}
    replayed = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") in _common.DEVICE_CATEGORIES and e["args"].get("correlation") in launched]
    assert len(replayed) > 6 * sims // k
    assert sum(spans[n]["busy_ms"] for n in launches.SEARCH_PHASES) == pytest.approx(
        _common._Busy(replayed).total / 1e3, rel=1e-9)
