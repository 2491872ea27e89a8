"""The search's descent (``connect4_tpu_torch.mcts.descent``) on the CPU.

On the card ``descend`` launches the kernel of ``mcts/csrc/descent.cu``,
which walks every row to its leaf; here, on CPU tensors, it takes its plain
version, ``descend_plain``: ``batched._descend_level`` repeated until no row
descends. Held here:

- ``descend_plain`` against the JAX package's descent, a ``lax.while_loop``
  assembled from the JAX module's own helpers as its two searches write it
  (``_simulate_exact`` and ``_simulate_parallel``), on trees snapshotted
  from real searches (K=1 with the exact score, K=8 with the walkers'
  overlay; fresh boards, 37-ply boards, tactic boards with rows masked
  inactive and leaves that are terminal, and a ``max_nodes`` slab that runs
  out): leaf, board, path, depth and the levels walked equal;
- the search's CPU form, ``min(t - 1, 42)`` levels, walks the same rows to
  the same leaves;
- the wrapper takes the plain path for CPU tensors, raises on what the
  kernel does not take, never falls back when the build fails, and the
  module imports and runs without ``nvcc``;
- a launch captured into a CUDA graph is counted at each replay.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` [graph])."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.env.core import BoardState as JBoardState
from connect4_tpu.mcts import batched as jb
from connect4_tpu_torch import launches
from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
from connect4_tpu_torch.mcts import batched as tb
from connect4_tpu_torch.mcts import descent
from test_torch_mcts import FINISHED, POSITIONS, TACTIC_MOVES, _boards, _gen
from test_torch_search_graph import _late_boards

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clone(d):
    return tb.Descent(d.node.clone(), d.board.map(torch.clone), d.descending.clone(), d.path.clone(),
                      d.depth.clone(), d.level.clone())


def _snapshots(boards, active, config, at):
    """Drive a CPU search of ``boards`` iteration by iteration and keep
    clones of the tree and the descent before the descent of each
    iteration in ``at``: ``[(t, tree, descent)]``."""
    search = tb.Search(centre_evaluator_batched, config)
    state = stack_boards(boards, device="cpu")
    out = []
    with torch.no_grad():
        ws = search.init(state, _gen(3), torch.from_numpy(active))
        for t in range(1, max(at) + 1):
            ws.iteration = t
            if t in at:
                out.append((t, tb.TreeArrays(*(x.clone() for x in ws.tree)), _clone(ws.descent)))
            search.level_iteration(ws)
    return state, out


def _jax_descent(tree, root, active, config, k):
    """The JAX search's descent, ``lax.while_loop`` until no row descends,
    with the depth and the level counter the two loops carry."""
    capacity = tree.children_base.shape[1]
    batch = root.age.shape[0]

    def cond(carry):
        return jnp.any(carry[2])

    def body(carry):
        node, board, descending, path, depth, i = carry
        valid = jb._descend_valid(board)
        if k:
            scores = jb._const_overlay_scores(tree, node, board, config, valid, k)
        else:
            scores = jb._child_scores(tree, node, board, config, valid)
        move = jb._argmax_prefer_large(scores)
        child = jb._take_node(tree.children_base, node) + move
        board = jb._light_step(board, move, descending)
        node = jnp.where(descending, child, node)
        path = jax.lax.dynamic_update_slice(path, jnp.where(descending, node, capacity)[:, None], (0, i + 1))
        depth = depth + descending.astype(jnp.int32)
        has_kids = jb._take_node(tree.children_base, node) >= 0
        return node, board, descending & has_kids, path, depth, i + 1

    node0 = jnp.zeros((batch,), jnp.int32)
    descending0 = active & (jb._take_node(tree.children_base, node0) >= 0)
    path0 = jnp.full((batch, jb.PATH_MAX), capacity, jnp.int32).at[:, 0].set(jnp.where(active, 0, capacity))
    return jax.lax.while_loop(cond, body, (node0, root, descending0, path0, jnp.zeros((batch,), jnp.int32),
                                           jnp.int32(0)))


def _to_jax_tree(tree):
    """The port's slabs without their dump column, as the JAX tree."""
    return jb.TreeArrays(*(jnp.asarray(x[:, :-1].numpy()) for x in tree[:5]), jnp.asarray(tree.next_free.numpy()))


# (boards, rows masked inactive, simulations at K=1 / K=8, max_nodes)
CASES = {
    "fresh": (lambda: _boards([[]] * 3 + POSITIONS), (), (48, 96), None),
    "late": (_late_boards, (), (48, 192), None),
    # tactic boards, a finished game and a live one masked inactive: rows
    # whose walks end at terminal leaves
    "tactic": (lambda: _boards(TACTIC_MOVES + [FINISHED] + POSITIONS[:2]), (5, 6), (40, 80), None),
    # a slab of 22 nodes: the root and three blocks, then the last block reused
    "exhausted": (lambda: _boards([[]] * 2 + POSITIONS[:3]), (), (40, 80), 22),
}


@pytest.mark.parametrize("k", [0, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_descent_equals_the_jax_while_loop(case, k):
    """On trees snapshotted before the descent of every iteration after the
    first of a real search: ``descend_plain`` until no row descends
    equals the JAX ``while_loop`` (leaf, board, path, depth, levels); the
    search's CPU form, ``min(t - 1, 42)`` levels, walks the same; and
    ``descend`` on CPU tensors is ``descend_plain``."""
    make_boards, inactive, sims, max_nodes = CASES[case]
    boards = make_boards()
    active = np.ones(len(boards), bool)
    active[list(inactive)] = False
    kw = dict(simulations=sims[k > 0], parallel_sims=max(k, 1), max_nodes=max_nodes)
    config, jconfig = MCTSConfig(**kw), JMCTSConfig(**kw)
    iterations = kw["simulations"] // kw["parallel_sims"]
    state, snaps = _snapshots(boards, active, config, range(2, iterations + 1))
    capacity = config.tree_capacity()
    rows = torch.arange(len(boards))
    jroot = JBoardState(*(jnp.asarray(x.numpy()) for x in state))
    # op by op, as the port runs its ops: inside one jitted program XLA
    # fuses the score's product and add into one rounding, which can break
    # an exact tie of two children's scores (here at iteration 10 of the
    # fresh K=8 search), so the jitted loop is the same algorithm with
    # other roundings
    def run_jax(tree):
        with jax.disable_jit():
            return _jax_descent(tree, jroot, jnp.asarray(active), jconfig, k)
    terminal_leaves = deepest = 0
    for t, tree, d0 in snaps:
        plain, bounded, wrapped = _clone(d0), _clone(d0), _clone(d0)
        tb.descend_plain(plain, tree, rows, config, capacity, k)
        for _ in range(min(t - 1, tb.PATH_MAX - 2)):
            tb._descend_level(bounded, tree, rows, config, capacity, k)
        launches = tb.descend.launches
        tb.descend(wrapped, tree, rows, config, capacity, k)
        assert tb.descend.launches == launches  # no kernel on the CPU
        node, jboard, _, path, depth, level = run_jax(_to_jax_tree(tree))
        np.testing.assert_array_equal(plain.node.numpy(), np.asarray(node), err_msg=f"leaf, iteration {t}")
        for name, x in zip(jboard._fields, jboard):
            np.testing.assert_array_equal(getattr(plain.board, name).numpy(), np.asarray(x), err_msg=name)
        np.testing.assert_array_equal(plain.path.numpy(), np.asarray(path), err_msg="path")
        np.testing.assert_array_equal(plain.depth.numpy(), np.asarray(depth), err_msg="depth")
        assert not plain.descending.any() and int(plain.level[0]) == int(level)
        for name, x in zip(plain._fields, plain):
            for got, other in ((wrapped, "wrapped"), (bounded, "bounded")):
                if other == "bounded" and name == "level":
                    continue
                y = getattr(got, name)
                assert all(torch.equal(a, b) for a, b in zip(x, y)) if name == "board" else torch.equal(x, y), \
                    (other, name, t)
        assert not plain.depth[torch.from_numpy(~active)].any()  # inactive rows stay at the root
        terminal_leaves += int((tree.stats[rows, plain.node, 3] > 0.5)[plain.depth > 0].sum())
        deepest = max(deepest, int(plain.depth.max()))
    assert int(snaps[-1][2].descending.sum()) > 0 and deepest >= 2
    if case == "tactic":
        assert terminal_leaves > 0
    if case == "exhausted":
        assert bool((snaps[-1][1].next_free == capacity).all())  # every row's slab ran out


def _workspace(batch=3, capacity=22):
    tree = tb._empty_tree(batch, capacity, "cpu")
    d = tb.Descent.empty(batch, capacity, "cpu")
    return tree, d, torch.arange(batch)


BAD = {
    "stats float64": lambda tree, d, rows: (tree._replace(stats=tree.stats.double()), d, rows),
    "path int32": lambda tree, d, rows: (tree, d._replace(path=d.path.int()), rows),
    "path too narrow": lambda tree, d, rows: (tree, d._replace(path=d.path[:, :-1].contiguous()), rows),
    "prior strided": lambda tree, d, rows: (tree._replace(prior=tree.prior.transpose(0, 1).contiguous()
                                                          .transpose(0, 1)), d, rows),
    "descending of another batch": lambda tree, d, rows: (tree, d._replace(descending=d.descending[:-1]), rows),
    "slab of another capacity": lambda tree, d, rows: (tree._replace(children_base=tree.children_base[:, :-1]
                                                                     .contiguous()), d, rows),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The kernel's checks run before anything is built: a dtype, a shape,
    a stride or a batch the kernel does not take raises."""
    tree, d, rows = BAD[bad](*_workspace())
    with pytest.raises(ValueError, match="descent kernel"):
        descent.launch(d, tree, MCTSConfig(), 22, tb.PATH_MAX, 0)


def test_no_fallback_when_the_kernel_cannot_be_built(monkeypatch):
    """A workspace the kernel takes, with a build that fails: the failure
    is raised, and the plain version is not run instead."""
    def no_compiler(source):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(descent, "load_library", no_compiler)
    monkeypatch.setattr(tb, "descend_plain", lambda *a, **k: pytest.fail("fell back to the plain version"))
    tree, d, rows = _workspace()
    with pytest.raises(RuntimeError, match="nvcc"):
        descent.launch(d, tree, MCTSConfig(), 22, tb.PATH_MAX, 0)
    with pytest.raises(ValueError, match="no implementation for device meta"):
        tb.descend(tb.Descent.empty(3, 22, "meta"), tree, rows, MCTSConfig(), 22, 0)


def test_imports_and_searches_without_nvcc():
    """With no ``nvcc`` anywhere, the module imports and a CPU search runs;
    nothing is built."""
    code = (
        "import torch; from connect4_tpu_torch import build; from connect4_tpu_torch.mcts import batched, descent\n"
        "from connect4_tpu_torch.config import MCTSConfig\n"
        "from connect4_tpu_torch.env.core import initial_state\n"
        "from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched\n"
        "from connect4_tpu_torch.mcts.batched import Search\n"
        "res = Search(centre_evaluator_batched, MCTSConfig(simulations=16, parallel_sims=4))("
        "initial_state((2,), device='cpu'), torch.Generator().manual_seed(0))\n"
        "assert not build._LIBS and batched.descend.launches == 0\n"
        "print(res.move.tolist())\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().startswith("[")


def test_captured_launches_count_at_replay(monkeypatch):
    """A descent launch made while a graph is captured is logged, not
    counted; each replay counts the log. The counter is the process's own,
    so it is restored afterwards."""
    monkeypatch.setattr(tb.descend, "launches", 0)
    before = tb.descend.launches
    with launches.captured() as log:
        launches.count(tb._record_descent)
        launches.count(tb._record_descent)
    assert log == [(tb._record_descent, ())] * 2 and tb.descend.launches == before
    for _ in range(3):
        launches.replay(log)
    assert tb.descend.launches == before + 6
    launches.count(tb._record_descent)
    assert tb.descend.launches == before + 7
