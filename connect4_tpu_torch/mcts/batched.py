"""Batched flat-tensor MCTS on torch tensors.

The counterpart of ``connect4_tpu.mcts.batched``: every game in a batch owns
a slab of preallocated tree tensors, and one simulation for *all* games is
a handful of fixed-shape tensor ops: PUCT selection is a masked argmax over
child slots, expansion is an index allocation plus seven vectorised env
steps, leaf evaluation is one batched network forward, and backup is one
scatter-add along the recorded path. Semantics are the JAX package's,
including value-based move selection, value^2 sampling for opening plies,
root-only Dirichlet noise, masked-renormalised priors, "unknown child =
0.0", terminal revisit re-accumulation, largest-move tie-breaks and the
K-walker virtual-visit search (``MCTSConfig.parallel_sims``).

Where the JAX code differs in kind, the port does this:

- **Dropped scatters.** JAX writes to the out-of-range index ``capacity``
  and drops the write (``mode="drop"``); torch has no drop mode and an
  out-of-range index on CUDA is a device-side assert. So every slab has
  one extra column, ``capacity``, a dump row that writes of inactive rows
  go to and that nothing reads: gathers of child blocks clamp to
  ``capacity - 1`` exactly as JAX clamps to its last column, and every
  other gather index is a node index below ``capacity`` by construction.
  ``SearchResults.tree`` is the slab without that column.
- **In place.** JAX arrays are immutable; here each simulation updates the
  tree slabs and the descent's buffers in place (every read of a slab
  happens before the write that would change it, as in the JAX program
  order).
- **Loops.** ``lax.while_loop`` over the descent becomes, on the card, a
  loop inside one hand-written kernel (``descend``): each row walks
  from the root to its leaf in registers, its loop ending where the row's
  does, with no host involved. On the CPU it becomes a loop over a number
  of levels that the host knows, ``min(t - 1, PATH_MAX - 2)`` in
  iteration t (see ``Search``): levels past a row's leaf change nothing,
  so nothing is read back inside a search iteration either.
  ``fori_loop`` over simulations becomes a Python loop over iterations.
- **Jit.** The jitted device program becomes CUDA graphs: on a CUDA state
  an iteration (the descent kernel, the rest of the iteration and the next
  descent's start) is captured once a shape (``Search``, ``Workspace``)
  and replayed; the tree lives in a workspace that every search of the
  shape resets in place. On the CPU, or with ``graphs=False`` (the
  counterpart of ``jax.disable_jit``), the same ops run eagerly.
- **Spans.** ``init``, ``finish`` and each phase of an iteration
  (``launches.SEARCH_PHASES``: the descent and the leaf's expansion, the
  fan-out, the tower, the heads, the backup) are spans of
  ``connect4_tpu_torch.launches``: host ranges and, while tracing is on,
  marks on the card that a CUDA graph replays. Each workspace counts the
  boards it evaluates by class (``EVAL_CLASSES``) on the card while
  tracing is on.
- **Random numbers** come from one ``torch.Generator`` threaded through
  the search, outside the graphs: Dirichlet noise from
  ``torch._standard_gamma``, opening samples as ``torch.multinomial``
  draws them. They are not JAX's bits, so the tests compare searches bit
  for bit with noise and sampling off.

Memory layout per game (N = ``MCTSConfig.tree_capacity()``): child slots
are allocated seven at a time, so a node's children occupy the contiguous
block ``[children_base, children_base + 7)`` and the move that leads to a
child is its offset in the block.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import torch

from connect4_tpu_torch import launches
from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.core import (
    BoardState,
    initial_state,
    legal_moves,
    place_stone,
    result_value,
    step,
)
from connect4_tpu_torch.eval.evaluators import BatchedEvaluator, stages
from connect4_tpu_torch.mcts import descent
from connect4_tpu_torch.types import HEIGHT, ONGOING, WIDTH

NEG_INF = float("-inf")

# longest possible backup path: root + one node per ply of a full board
# + one freshly expanded child
PATH_MAX = 44

# stats slab channels
_VISITS = 0
_VSUM = 1
_TVAL = 2
_TERM = 3

# the classes of the boards a search hands its evaluator, counted on the
# card while tracing is on (``Workspace.evals``): a node's first evaluation;
# a node evaluated before, or by an earlier walker of the row; a terminal
# node, whose net value is thrown away; an inactive row
EVAL_CLASSES = ("useful", "repeat", "terminal", "idle")
_USEFUL, _REPEAT, _TERMINAL, _IDLE = range(len(EVAL_CLASSES))


class TreeArrays(NamedTuple):
    """Struct-of-arrays search tree, batch-major ``[B, N + 1, ...]`` while
    a search runs (column N is the dump row), ``[B, N, ...]`` in
    ``SearchResults``."""

    parent: torch.Tensor  # int32[B, N(+1)], -1 for root
    children_base: torch.Tensor  # int32[B, N(+1)], -1 = unexpanded
    stats: torch.Tensor  # float32[B, N(+1), 4] — visits, value_sum, tval, terminal
    prior: torch.Tensor  # float32[B, N(+1), 7] — node's own masked prior
    evaluated: torch.Tensor  # bool[B, N(+1)]
    next_free: torch.Tensor  # int32[B]

    @property
    def visits(self) -> torch.Tensor:
        return self.stats[..., _VISITS].to(torch.int32)

    @property
    def value_sum(self) -> torch.Tensor:
        return self.stats[..., _VSUM]

    @property
    def tval(self) -> torch.Tensor:
        return self.stats[..., _TVAL]

    @property
    def terminal(self) -> torch.Tensor:
        return self.stats[..., _TERM] > 0.5

    def without_dump(self) -> "TreeArrays":
        """Views of the slabs without their dump column."""
        return TreeArrays(*(x[:, :-1] for x in self[:5]), self.next_free)


class SearchResults(NamedTuple):
    move: torch.Tensor  # int32[B] — chosen move
    value: torch.Tensor  # float32[B] — absolute value of the chosen child
    values_policy: torch.Tensor  # float32[B, 7] — normalised child values (training target)
    visit_policy: torch.Tensor  # float32[B, 7] — normalised child visit counts
    root_value: torch.Tensor  # float32[B] — root mean search value
    tree: TreeArrays


def _empty_tree(batch: int, capacity: int, device) -> TreeArrays:
    n = capacity + 1  # + the dump row
    return TreeArrays(
        parent=torch.full((batch, n), -1, dtype=torch.int32, device=device),
        children_base=torch.full((batch, n), -1, dtype=torch.int32, device=device),
        stats=torch.zeros((batch, n, 4), dtype=torch.float32, device=device),
        prior=torch.zeros((batch, n, WIDTH), dtype=torch.float32, device=device),
        evaluated=torch.zeros((batch, n), dtype=torch.bool, device=device),
        next_free=torch.ones((batch,), dtype=torch.int32, device=device),  # slot 0 is the root
    )


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor made on ``like``'s device, for an indexed
    write: a Python scalar there becomes a copy from host memory, which a
    CUDA graph cannot hold."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _mask_normalise(prior: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero illegal moves and renormalise; uniform over legal moves if the
    masked mass vanishes (guards finished games in lockstep batches)."""
    masked = torch.where(valid, prior, 0.0)
    total = masked.sum(dim=-1, keepdim=True)
    n_valid = valid.sum(dim=-1, keepdim=True).clamp(min=1)
    uniform = valid.float() / n_valid
    return torch.where(total > 0, masked / torch.where(total > 0, total, 1.0), uniform)


def _take_child_block(arr: torch.Tensor, rows: torch.Tensor, base: torch.Tensor,
                      capacity: int) -> torch.Tensor:
    """arr[B, N+1, ...] gathered at the 7-slot block from base[B] ->
    [B, 7, ...], indices clamped into the real slab as JAX clamps them."""
    idx = base[:, None] + torch.arange(WIDTH, device=base.device)
    return arr[rows[:, None], idx.clamp(0, capacity - 1)]


def _value_to_side(abs_value: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    return torch.where(side == 0, abs_value, 1.0 - abs_value)


def _light_step(board: BoardState, move: torch.Tensor, enabled: torch.Tensor) -> BoardState:
    """Descent-only board step: drop the stone, no terminal detection
    (terminality along the descent path is known from the tree).
    ``result`` is left untouched."""
    pieces, height, _ = place_stone(board.pieces, board.height, board.age, move)
    return BoardState(
        pieces=torch.where(enabled[..., None, None, None], pieces, board.pieces),
        height=torch.where(enabled[..., None], height, board.height),
        age=torch.where(enabled, board.age + 1, board.age),
        result=board.result,
    )


def _descend_valid(board: BoardState) -> torch.Tensor:
    """Legal moves during descent: open columns only."""
    return board.height < HEIGHT


def _score_parts(
    node_stats: torch.Tensor,  # [..., 4] — the selecting node's stats row
    child: torch.Tensor,  # [..., 7, 4] — its child block's stats
    prior_row: torch.Tensor,  # [..., 7]
    side: torch.Tensor,  # [...]
    config: MCTSConfig,
    valid: torch.Tensor,
    node_ov=None,
    c_ov: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PUCT scores of the 7 child slots; -inf on illegal moves.

    ``node_ov=None`` is the exact score (``_child_score_parts`` of the JAX
    package). Otherwise the selecting node carries ``node_ov`` virtual
    visits and each child ``c_ov`` of them (none when ``c_ov`` is None),
    counted as losses from the selecting side's perspective: a constant
    ``node_ov = K`` is the score of the K lockstep walkers
    (``_const_overlay_score_parts``), a tensor the per-node overlay of the
    walker form (``_overlay_scores``)."""
    parent_visits = node_stats[..., _VISITS]
    if node_ov is not None:
        parent_visits = parent_visits + (float(node_ov) if isinstance(node_ov, int) else node_ov)
    log_term = torch.log((parent_visits + config.pb_c_base + 1.0) / config.pb_c_base)
    pb_c0 = (log_term + config.pb_c_init) * torch.sqrt(parent_visits)

    c_visits = child[..., _VISITS]
    c_vsum = child[..., _VSUM]
    c_tval = child[..., _TVAL]
    c_term = child[..., _TERM] > 0.5
    known = c_term | (c_visits > 0)

    if node_ov is not None:
        n_eff = c_visits if c_ov is None else c_visits + c_ov
        side_sum = torch.where(side[..., None] == 0, c_vsum, c_visits - c_vsum)
        diluted = side_sum / n_eff.clamp(min=1.0)
        term_val = _value_to_side(c_tval, side[..., None])
        value_score = torch.where(c_term, term_val, torch.where(known, diluted, 0.0))
    else:
        n_eff = c_visits
        mean = c_vsum / c_visits.clamp(min=1.0)
        abs_val = torch.where(c_term, c_tval, torch.where(c_visits > 0, mean, 0.0))
        value_score = torch.where(known, _value_to_side(abs_val, side[..., None]), 0.0)

    pb_c = pb_c0[..., None] / (n_eff + 1.0)
    scores = pb_c * prior_row + value_score
    return torch.where(valid, scores, NEG_INF)


def _node_scores(tree, rows, node, board, config, valid, capacity, k=0):
    """Gather a node's stats row, child block and prior, then score."""
    base = tree.children_base[rows, node].long()
    side = board.age % 2
    child = _take_child_block(tree.stats, rows, base, capacity)
    return _score_parts(
        tree.stats[rows, node], child, tree.prior[rows, node], side, config, valid, k or None
    )


def _argmax_prefer_large(scores: torch.Tensor) -> torch.Tensor:
    """Argmax over the move axis breaking ties toward the larger index
    (``torch.argmax`` returns the first maximum)."""
    return (WIDTH - 1) - torch.argmax(torch.flip(scores, dims=(-1,)), dim=-1)


def _expand_metadata(board: BoardState) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each of the 7 moves from ``board``: (is_terminal[B,7], tval[B,7]),
    from one env step widened over a trailing 7-move axis."""
    bs = board.batch_shape
    nb = len(bs)
    tiled = board.map(
        lambda x: x.unsqueeze(nb).expand(bs + (WIDTH,) + tuple(x.shape[nb:]))
    )
    moves = torch.arange(WIDTH, device=board.device).expand(bs + (WIDTH,))
    child = step(tiled, moves)
    return child.result != ONGOING, result_value(child.result)


class Descent(NamedTuple):
    """One descent of every game from its root, updated in place (by the
    descent kernel, or level by level; a CUDA graph replays either on these
    very buffers): column i of ``path`` holds the node at depth i of a
    row's walk, ``capacity`` elsewhere."""

    node: torch.Tensor  # int64[B] — where each row stands
    board: BoardState  # the board at ``node``
    descending: torch.Tensor  # bool[B] — rows still walking
    path: torch.Tensor  # int64[B, PATH_MAX]
    depth: torch.Tensor  # int64[B]
    level: torch.Tensor  # int64[1] — levels walked

    @classmethod
    def empty(cls, batch: int, capacity: int, device) -> "Descent":
        return cls(
            node=torch.zeros((batch,), dtype=torch.long, device=device),
            board=initial_state((batch,), device=device),
            descending=torch.zeros((batch,), dtype=torch.bool, device=device),
            path=torch.full((batch, PATH_MAX), capacity, dtype=torch.long, device=device),
            depth=torch.zeros((batch,), dtype=torch.long, device=device),
            level=torch.zeros((1,), dtype=torch.long, device=device),
        )


def _descent_start(d: Descent, tree: TreeArrays, root_state: BoardState, active: torch.Tensor,
                   capacity: int) -> None:
    """Put every game of ``d`` at its root, in place."""
    d.node.zero_()
    for dst, src in zip(d.board, root_state):
        dst.copy_(src)
    d.descending.copy_(active & (tree.children_base[:, 0] >= 0))
    d.path.fill_(capacity)
    d.path[:, 0] = torch.where(active, 0, capacity)
    d.depth.zero_()
    d.level.zero_()


def _descend_level(d: Descent, tree: TreeArrays, rows, config, capacity, k) -> None:
    """One level of the descent, in place: each row still descending moves
    to its best child (with K walkers' constant overlay where ``k`` > 0)
    and stops there if that child has no children. A level where no row
    descends changes nothing, so a descent may run more levels than the
    tree is deep."""
    valid = _descend_valid(d.board)
    scores = _node_scores(tree, rows, d.node, d.board, config, valid, capacity, k)
    move = _argmax_prefer_large(scores)
    child = tree.children_base[rows, d.node].long() + move
    board = _light_step(d.board, move, d.descending)
    for dst, src in zip(d.board[:3], board[:3]):  # result is left as it was
        dst.copy_(src)
    node = torch.where(d.descending, child, d.node)
    d.node.copy_(node)
    d.path.scatter_(1, (d.level + 1).expand(rows.shape[0], 1),
                    torch.where(d.descending, node, capacity)[:, None])
    d.depth.add_(d.descending)
    d.descending.logical_and_(tree.children_base[rows, node] >= 0)
    d.level.add_(1)


def descend_plain(d: Descent, tree: TreeArrays, rows, config, capacity, k) -> None:
    """The descent in plain tensor code, in place: ``_descend_level`` level
    by level until no row descends (two host reads a level), at most
    ``PATH_MAX - 2`` levels in all, which is what the descent kernel
    computes; both leave ``level`` at the levels the batch walked."""
    while int(d.level[0]) < PATH_MAX - 2 and bool(d.descending.any()):
        _descend_level(d, tree, rows, config, capacity, k)


def descend(d: Descent, tree: TreeArrays, rows, config, capacity, k) -> None:
    """Walk every row of ``d`` that still descends to its leaf in ``tree``,
    in place (``rows`` is ``arange(B)``): one launch of the descent kernel
    (``descent.launch``) for CUDA tensors, ``descend_plain`` for CPU
    tensors; anything else raises. ``descend.launches`` counts the
    kernel's launches, a launch captured into a CUDA graph at each replay
    (``connect4_tpu_torch.launches``)."""
    if d.node.device.type == "cuda":
        descent.launch(d, tree, config, capacity, PATH_MAX, k)
        launches.count(_record_descent)
    elif d.node.device.type == "cpu":
        descend_plain(d, tree, rows, config, capacity, k)
    else:
        raise ValueError(f"descend: no implementation for device {d.node.device}")


descend.launches = 0


def _record_descent() -> None:
    descend.launches += 1


def _count_evals(evals, active, terminal, fresh) -> None:
    """Tally boards handed to the evaluator into ``evals`` (a
    ``launches.Counter`` of ``EVAL_CLASSES``) while tracing is on: idle
    where the row is inactive, terminal where the node is, useful where it
    is ``fresh`` (its first evaluation), repeat otherwise. ``evals=None``
    counts nothing."""
    if evals is None or not launches.traced():
        return
    launches.tally(evals, torch.where(
        active, torch.where(terminal, _TERMINAL, torch.where(fresh, _USEFUL, _REPEAT)), _IDLE))


def _expand(tree, rows, leaf, leaf_board, need_alloc, capacity) -> None:
    """Allocate a 7-slot child block under ``leaf`` where ``need_alloc``
    and write the children's metadata, in place (``next_free`` too)."""
    base = tree.next_free.clamp(max=capacity - WIDTH)
    tree.children_base[rows, torch.where(need_alloc, leaf, capacity)] = base
    tree.next_free.copy_(torch.where(
        need_alloc, (tree.next_free + WIDTH).clamp(max=capacity), tree.next_free
    ))
    child_term, child_tval = _expand_metadata(leaf_board)
    child_stats = torch.zeros(child_term.shape + (4,), dtype=torch.float32, device=rows.device)
    child_stats[..., _TVAL] = child_tval
    child_stats[..., _TERM] = child_term.float()
    slot_idx = base.long()[:, None] + torch.arange(WIDTH, device=rows.device)
    slots = (rows[:, None], torch.where(need_alloc[:, None], slot_idx, capacity))
    tree.parent[slots] = leaf[:, None].to(torch.int32)
    tree.stats[slots] = child_stats
    tree.evaluated[slots] = _scalar(False, tree.evaluated)
    tree.children_base[slots] = _scalar(-1, tree.children_base)


def _root_init(
    eval_fn: BatchedEvaluator,
    tree: TreeArrays,
    root_state: BoardState,
    generator: torch.Generator,
    config: MCTSConfig,
) -> None:
    """Evaluate the root of the empty ``tree`` and mix in Dirichlet noise
    once, in place."""
    batch = root_state.age.shape[0]
    root_value, root_prior_raw = eval_fn(root_state)
    root_valid = legal_moves(root_state)
    root_prior = _mask_normalise(root_prior_raw, root_valid)
    if config.root_dirichlet_alpha and config.root_exploration_fraction:
        alpha = torch.full(
            (batch, WIDTH), float(config.root_dirichlet_alpha), device=root_state.device
        )
        noise = _mask_normalise(torch._standard_gamma(alpha, generator=generator), root_valid)
        frac = float(config.root_exploration_fraction)
        root_prior = root_prior * (1.0 - frac) + noise * frac

    tree.prior[:, 0] = root_prior
    tree.evaluated[:, 0] = True
    tree.stats[:, 0, _VISITS] = 1.0
    tree.stats[:, 0, _VSUM] = root_value.float()


def _tail_exact(tree: TreeArrays, d: Descent, rows, *, eval_fn, config, active, capacity, evals=None) -> None:
    """The rest of a K=1 iteration after the descent ``d``: expansion,
    evaluation and backup, in place, in the spans ``launches.SEARCH_PHASES``
    after the first (a phase of the caller's partition each); ``evals``
    counts the boards evaluated (``_count_evals``)."""
    batch = rows.shape[0]
    leaf, leaf_board, path, depth = d.node, d.board, d.path, d.depth

    # --- phase 2: expand evaluated non-terminal leaves ----------------
    # (leaf_board.result is accurately ONGOING for expanding games, so the
    # full env step in _expand_metadata computes true child results)
    leaf_term = tree.stats[rows, leaf, _TERM] > 0.5
    need_expand = active & tree.evaluated[rows, leaf] & ~leaf_term
    base = tree.next_free.clamp(max=capacity - WIDTH).long()
    _expand(tree, rows, leaf, leaf_board, need_expand, capacity)

    # select one fresh child where we expanded
    launches.phase("search.fanout")
    scores = _node_scores(tree, rows, leaf, leaf_board, config, _descend_valid(leaf_board), capacity)
    move2 = _argmax_prefer_large(scores)
    cur_board = _light_step(leaf_board, move2, need_expand)
    cur = torch.where(need_expand, base + move2, leaf)

    # --- phase 3: evaluate the leaf -----------------------------------
    launches.phase("search.tower")
    trunk, heads = stages(eval_fn)
    cur_stats = tree.stats[rows, cur]
    features = trunk(cur_board)
    launches.phase("search.heads")
    value_net, prior_net = heads(features)
    cur_term = cur_stats[:, _TERM] > 0.5
    value = torch.where(cur_term, cur_stats[:, _TVAL], value_net.float())
    prior_masked = _mask_normalise(prior_net, _descend_valid(cur_board))
    launches.phase("search.backup")
    fresh = ~tree.evaluated[rows, cur]
    _count_evals(evals, active, cur_term, fresh)
    store_prior = active & ~cur_term & fresh
    safe_cur = torch.where(store_prior, cur, capacity)
    tree.prior[rows, safe_cur] = prior_masked
    tree.evaluated[rows, safe_cur] = _scalar(True, tree.evaluated)

    # --- phase 4: backup along the recorded path ----------------------
    # every node on the root..leaf path plus (if expanded) the fresh child
    # receives (1 visit, value): one scatter-add, indices distinct per row
    path[rows, depth + 1] = torch.where(need_expand, cur, capacity)
    incr = torch.stack(
        [torch.ones_like(value), value, torch.zeros_like(value), torch.zeros_like(value)],
        dim=-1,
    )
    tree.stats.index_put_(
        (rows[:, None], path), incr[:, None, :].expand(batch, PATH_MAX, 4), accumulate=True
    )


def _tail_parallel(tree: TreeArrays, d: Descent, rows, *, eval_fn, config, active, capacity, evals=None) -> None:
    """The rest of a K-walker iteration after the shared descent ``d``:
    one expansion of the shared leaf, K walkers' fan-out over its children
    sequentially from a precomputed [B, K, 7] score table (child c's score
    when it carries j virtual visits), one batched forward of the K fan-out
    boards, and a backup that adds (1, value) to each fan-out child and (K,
    sum of values) once along the shared path; in place, in the spans
    ``launches.SEARCH_PHASES`` after the first (a phase of the caller's
    partition each); ``evals`` counts the boards evaluated
    (``_count_evals``)."""
    K = config.parallel_sims
    batch = rows.shape[0]
    dev = rows.device
    leaf, leaf_board, path = d.node, d.board, d.path

    # --- single expansion of the (shared) leaf ----------------------------
    leaf_term = tree.stats[rows, leaf, _TERM] > 0.5
    expandable = active & tree.evaluated[rows, leaf] & ~leaf_term
    need_alloc = expandable & (tree.children_base[rows, leaf] < 0)
    _expand(tree, rows, leaf, leaf_board, need_alloc, capacity)

    # --- K-way fan-out over the leaf's children, table-driven -------------
    launches.phase("search.fanout")
    cb = tree.children_base[rows, leaf].long()
    score_table = _score_parts(
        tree.stats[rows, leaf][:, None, :],
        _take_child_block(tree.stats, rows, cb, capacity)[:, None],
        tree.prior[rows, leaf][:, None, :],
        (leaf_board.age % 2)[:, None],
        config,
        _descend_valid(leaf_board)[:, None, :],
        K,
        torch.arange(K, dtype=torch.float32, device=dev)[None, :, None],
    )  # [B, K, 7]
    move_iota = torch.arange(WIDTH, device=dev)
    ov_cnt = torch.zeros((batch, WIDTH), dtype=torch.long, device=dev)
    moves_k = []
    for _ in range(K):
        scores = torch.gather(score_table, 1, ov_cnt[:, None, :])[:, 0, :]  # [B, 7]
        move = _argmax_prefer_large(scores)
        ov_cnt += ((move_iota == move[:, None]) & expandable[:, None]).long()
        moves_k.append(move)
    moves = torch.stack(moves_k, dim=1)  # [B, K]
    boards = _light_step(
        leaf_board.map(lambda x: x[:, None].expand((batch, K) + tuple(x.shape[1:]))),
        moves,
        expandable[:, None].expand(batch, K),
    )
    nodes = torch.where(expandable[:, None], cb[:, None] + moves, leaf[:, None])  # [B, K]
    active_k = active[:, None].expand(batch, K)

    # --- lockstep evaluation ----------------------------------------------
    launches.phase("search.tower")
    trunk, heads = stages(eval_fn)
    cur_stats = tree.stats[rows[:, None], nodes]  # [B, K, 4]
    features = trunk(boards.map(lambda x: x.reshape((batch * K,) + x.shape[2:])))
    launches.phase("search.heads")
    value_net, prior_net = heads(features)
    cur_term = cur_stats[..., _TERM] > 0.5
    value = torch.where(cur_term, cur_stats[..., _TVAL], value_net.reshape(batch, K).float())
    prior_masked = _mask_normalise(prior_net.reshape(batch, K, WIDTH), boards.height < HEIGHT)
    launches.phase("search.backup")
    unevaluated = ~tree.evaluated[rows[:, None], nodes]
    if evals is not None and launches.traced():
        # a walker repeats the node of an earlier walker of its row
        walker = torch.arange(K, device=dev)
        earlier = ((nodes[:, :, None] == nodes[:, None, :]) & (walker[:, None] > walker[None, :])).any(-1)
        _count_evals(evals, active_k, cur_term, unevaluated & ~earlier)
    store_prior = active_k & ~cur_term & unevaluated
    safe_nodes = (rows[:, None], torch.where(store_prior, nodes, capacity))
    tree.prior[safe_nodes] = prior_masked
    tree.evaluated[safe_nodes] = _scalar(True, tree.evaluated)

    # --- backup: per-child adds + ONE shared-path scatter-add -------------
    zeros = torch.zeros_like(value)
    child_incr = torch.stack([torch.ones_like(value), value, zeros, zeros], dim=-1)
    fan_mask = expandable[:, None] & active_k
    tree.stats.index_put_(
        (rows[:, None], torch.where(fan_mask, nodes, capacity)), child_incr, accumulate=True
    )
    vsum = torch.where(active_k, value, 0.0).sum(dim=1)
    zeros_b = torch.zeros_like(vsum)
    path_incr = torch.stack(
        [torch.where(active, float(K), 0.0), vsum, zeros_b, zeros_b], dim=-1
    )  # [B, 4]
    tree.stats.index_put_(
        (rows[:, None], path), path_incr[:, None, :].expand(batch, PATH_MAX, 4), accumulate=True
    )


def _simulate_parallel(
    tree: TreeArrays, *, eval_fn, config, root_state, active, capacity
) -> TreeArrays:
    """One iteration = K simulations per game, walker-deduplicated, on
    ``tree``, in place (the tests hold it to the JAX package's and to
    ``_simulate_parallel_reference``). Lockstep walkers share their whole
    descent (they see identical scores with a constant xK overlay on the
    path), so the descent runs once per game and ``_tail_parallel`` does
    the rest."""
    rows = torch.arange(root_state.age.shape[0], device=root_state.device)
    d = Descent.empty(rows.shape[0], capacity, rows.device)
    _descent_start(d, tree, root_state, active, capacity)
    with launches.partition(rows.device):
        launches.phase("search.descend")
        descend(d, tree, rows, config, capacity, config.parallel_sims)
        _tail_parallel(tree, d, rows, eval_fn=eval_fn, config=config, active=active, capacity=capacity)
    return tree


def _overlay_scores(tree, voverlay, node, board, config, valid, capacity):
    """PUCT scores of walkers at ``node`` [B, K] with the per-node virtual
    visit overlay ``voverlay`` [B, N+1] (``_overlay_scores`` of the JAX
    package; with a zero overlay, the exact score)."""
    rows = torch.arange(node.shape[0], device=node.device)[:, None]
    base = tree.children_base[rows, node].long()
    idx = (base[..., None] + torch.arange(WIDTH, device=node.device)).clamp(0, capacity - 1)
    return _score_parts(
        tree.stats[rows, node], tree.stats[rows[..., None], idx], tree.prior[rows, node],
        board.age % 2, config, valid, voverlay[rows, node], voverlay[rows[..., None], idx],
    )


def _add_overlay(voverlay, node, active, capacity) -> None:
    """voverlay[b, node] += 1 where active (node [B, K]), in place."""
    rows = torch.arange(node.shape[0], device=node.device)[:, None]
    voverlay.index_put_(
        (rows, torch.where(active, node, capacity)), torch.ones_like(node, dtype=torch.float32),
        accumulate=True,
    )


def _simulate_parallel_reference(
    tree: TreeArrays, *, eval_fn, config, root_state, active, capacity
) -> TreeArrays:
    """The direct lockstep-walker form of one parallel iteration (K
    simulations per game at once under a virtual-visit overlay), the golden
    reference that ``_simulate_parallel`` is held against (the JAX
    package's function of the same name, on the port's slabs). It walks a
    redundant [B, K] walker axis through the descent, expands and steps one
    walker after another, and backs each walker's value up its own path.
    Only the tests run it."""
    K = config.parallel_sims
    batch = root_state.age.shape[0]
    dev = root_state.device
    rows = torch.arange(batch, device=dev)
    rk = rows[:, None]

    voverlay = torch.zeros((batch, capacity + 1), dtype=torch.float32, device=dev)
    boards = root_state.map(lambda x: x[:, None].expand((batch, K) + tuple(x.shape[1:])))
    nodes = torch.zeros((batch, K), dtype=torch.long, device=dev)
    active_k = active[:, None].expand(batch, K)
    _add_overlay(voverlay, nodes, active_k, capacity)

    # --- lockstep descent over the walker axis ----------------------------
    descending = active_k & (tree.children_base[rk, nodes] >= 0)
    while bool(descending.any()):
        scores = _overlay_scores(tree, voverlay, nodes, boards, config, boards.height < HEIGHT, capacity)
        move = _argmax_prefer_large(scores)
        child = tree.children_base[rk, nodes].long() + move
        boards = _light_step(boards, move, descending)
        nodes = torch.where(descending, child, nodes)
        _add_overlay(voverlay, nodes, descending, capacity)
        descending = descending & (tree.children_base[rk, nodes] >= 0)

    # --- expansion and a fresh-child step, one walker after another -------
    new_nodes, new_boards = [], []
    for k in range(K):
        leaf = nodes[:, k]
        board_k = boards.map(lambda x: x[:, k])
        leaf_term = tree.stats[rows, leaf, _TERM] > 0.5
        expandable = active_k[:, k] & tree.evaluated[rows, leaf] & ~leaf_term
        need_alloc = expandable & (tree.children_base[rows, leaf] < 0)
        _expand(tree, rows, leaf, board_k, need_alloc, capacity)
        scores = _overlay_scores(
            tree, voverlay, leaf[:, None], board_k.map(lambda x: x[:, None]), config,
            (board_k.height < HEIGHT)[:, None], capacity,
        )[:, 0]
        move = _argmax_prefer_large(scores)
        cur = torch.where(expandable, tree.children_base[rows, leaf].long() + move, leaf)
        _add_overlay(voverlay, cur[:, None], expandable[:, None], capacity)
        new_nodes.append(cur)
        new_boards.append(_light_step(board_k, move, expandable))
    nodes = torch.stack(new_nodes, dim=1)
    boards = BoardState(*(torch.stack(xs, dim=1) for xs in zip(*new_boards)))

    # --- lockstep evaluation ----------------------------------------------
    cur_stats = tree.stats[rk, nodes]  # [B, K, 4]
    cur_term = cur_stats[..., _TERM] > 0.5
    value_net, prior_net = eval_fn(boards.map(lambda x: x.reshape((batch * K,) + x.shape[2:])))
    value = torch.where(cur_term, cur_stats[..., _TVAL], value_net.reshape(batch, K).float())
    prior_masked = _mask_normalise(prior_net.reshape(batch, K, WIDTH), boards.height < HEIGHT)
    store_prior = active_k & ~cur_term & ~tree.evaluated[rk, nodes]
    safe_nodes = (rk, torch.where(store_prior, nodes, capacity))
    tree.prior[safe_nodes] = prior_masked
    tree.evaluated[safe_nodes] = True

    # --- lockstep backup over the walker axis, each walker up its path ----
    zeros = torch.zeros_like(value)
    incr = torch.stack([torch.ones_like(value), value, zeros, zeros], dim=-1)  # [B, K, 4]
    idx, alive = nodes, active_k
    while bool(alive.any()):
        tree.stats.index_put_((rk, torch.where(alive, idx, capacity)), incr, accumulate=True)
        idx = torch.where(alive, tree.parent[rk, idx.clamp(min=0)].long(), idx)
        alive = alive & (idx >= 0)
    return tree


def _finish(
    tree: TreeArrays,
    root_state: BoardState,
    generator: torch.Generator,
    config: MCTSConfig,
    root_valid: torch.Tensor,
) -> SearchResults:
    """Move selection and training targets from the finished tree."""
    capacity = tree.parent.shape[1] - 1
    batch = root_state.age.shape[0]
    rows = torch.arange(batch, device=root_state.device)
    side = root_state.age % 2

    child = _take_child_block(tree.stats, rows, tree.children_base[:, 0].long(), capacity)
    c_visits = child[..., _VISITS]
    c_vsum = child[..., _VSUM]
    c_term = child[..., _TERM] > 0.5
    c_tval = child[..., _TVAL]

    mean = c_vsum / c_visits.clamp(min=1.0)
    abs_val = torch.where(c_term, c_tval, torch.where(c_visits > 0, mean, 0.0))
    known = c_term | (c_visits > 0)
    side_val = torch.where(known, _value_to_side(abs_val, side[:, None]), 0.0)
    side_val = torch.where(root_valid, side_val, 0.0)

    # values-policy target with uniform fallback over the legal moves
    total = side_val.sum(dim=-1, keepdim=True)
    n_valid = root_valid.sum(dim=-1, keepdim=True).clamp(min=1)
    uniform = root_valid.float() / n_valid
    values_policy = torch.where(
        total > 0, side_val / torch.where(total > 0, total, 1.0), uniform
    )

    visits = c_visits * root_valid
    visit_policy = visits / visits.sum(dim=-1, keepdim=True).clamp(min=1.0)

    move = _argmax_prefer_large(torch.where(root_valid, side_val, NEG_INF))
    if config.num_sampling_moves:
        # opening-ply sampling proportional to value^2; uniform over legal
        # moves if every child value is exactly zero, and over all columns
        # for rows with no legal move (their output is never used)
        weights = torch.where(root_valid, side_val**2, 0.0)
        wsum = weights.sum(dim=-1, keepdim=True)
        probs = torch.where(wsum > 0, weights / torch.where(wsum > 0, wsum, 1.0), uniform)
        probs = torch.where(probs.sum(dim=-1, keepdim=True) > 0, probs, 1.0 / WIDTH)
        # torch.multinomial(probs, 1, generator=generator)[:, 0], which
        # draws exactly this, but without its two host reads that check
        # the probabilities (valid here by construction)
        sampled = torch.argmax(probs / torch.empty_like(probs).exponential_(1, generator=generator), dim=-1)
        move = torch.where(root_state.age < config.num_sampling_moves, sampled, move)

    chosen_abs = torch.gather(abs_val, 1, move[:, None])[:, 0]
    root_visits = tree.stats[:, 0, _VISITS]
    root_mean = tree.stats[:, 0, _VSUM] / root_visits.clamp(min=1.0)
    return SearchResults(
        move=move.to(torch.int32),
        value=chosen_abs,
        values_policy=values_policy,
        visit_policy=visit_policy,
        root_value=root_mean,
        tree=TreeArrays(*(x.clone() for x in tree.without_dump())),
    )


# one side stream a device for every workspace's warm-ups and captures:
# cuBLAS keeps a workspace for each stream it has run on for the life of
# the process, so a stream a search would hold more memory with every
# search object
_SIDE_STREAMS = {}


def _side_stream(device) -> torch.cuda.Stream:
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


class _Graphs:
    """The CUDA graphs of one workspace's iteration. ``run(name, fn)`` runs
    ``fn`` eagerly the first time, on a side stream (the warm-up: it does
    what the ops set up lazily, such as cuBLAS's workspace and the kernels'
    builds and attributes, outside any capture), captures it the second
    time and replays the capture from then on, on the current stream. The
    graphs share one memory pool: they run one after another and pass
    nothing but the workspace's own buffers. A failed capture raises. The
    kernel launches a graph holds are counted at each replay
    (``connect4_tpu_torch.launches``)."""

    def __init__(self, device):
        self.stream = _side_stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graph = {}
        self.launches = {}  # name -> the log of the kernel launches captured
        self.capture_ms = {}  # name -> ms the capture took
        self.replays = 0
        self._warm = set()

    def run(self, name: str, fn) -> None:
        graph = self.graph.get(name)
        if graph is None:
            current = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(current)
            if name not in self._warm:
                with torch.cuda.stream(self.stream):
                    fn()
                current.wait_stream(self.stream)
                self._warm.add(name)
                return
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with launches.captured() as log, torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                fn()
            self.capture_ms[name] = (time.perf_counter() - t0) * 1e3
            current.wait_stream(self.stream)
            self.graph[name], self.launches[name] = graph, log
        graph.replay()
        self.replays += 1
        launches.replay(self.launches[name])


class Workspace:
    """The buffers of one search shape, reset in place by every search of
    that shape: the tree slabs (with the dump column), static copies of the
    roots and of the active mask, the descent, the host's count of
    iterations since the reset, the count of the boards evaluated by class
    (``evals``, a ``launches.Counter`` of ``EVAL_CLASSES`` that the search
    updates while tracing is on) and, where the search runs graphs, the CUDA
    graphs of an iteration (``graphs``)."""

    def __init__(self, batch: int, capacity: int, device, graphs: bool):
        self.capacity = capacity
        self.tree = _empty_tree(batch, capacity, device)
        self.root = initial_state((batch,), device=device)
        self.active = torch.zeros((batch,), dtype=torch.bool, device=device)
        self.rows = torch.arange(batch, device=device)
        self.descent = Descent.empty(batch, capacity, device)
        self.iteration = 0
        self.evals = launches.Counter("evals", EVAL_CLASSES, device)
        self.graphs = _Graphs(device) if graphs else None

    def reset(self, root_state: BoardState, active: torch.Tensor) -> None:
        for x, fill in zip(self.tree, (-1, -1, 0.0, 0.0, False, 1)):
            x.fill_(fill)  # _empty_tree's values; next_free 1: slot 0 is the root
        for dst, src in zip(self.root, root_state):
            dst.copy_(src)
        self.active.copy_(active)
        self.iteration = 0


class Search:
    """A batched search bound to an evaluator and a config:
    ``search(root_state, generator, active=None) -> SearchResults`` runs
    ``init``, ``simulations / sims_per_call`` calls of ``segment`` and
    ``finish`` (the counterpart of the JAX package's jitted ``run`` and of
    its chunked ``init``, ``segment`` and ``finish``).

    On a CUDA state an iteration is ``iteration``: one launch of the
    descent kernel walks every row to its leaf on the card, then the rest
    of the iteration (expansion, evaluation, backup) and the next
    descent's start. On a CPU state it is ``level_iteration``: iteration t
    (counted from 1 since ``init``) descends ``min(t - 1, PATH_MAX - 2)``
    levels, a count the host knows: an iteration allocates at most one
    child block a game, so before iteration t no expanded node is deeper
    than t - 1, and no board has more than 42 plies left; the levels past a
    row's leaf change nothing. So nothing in an iteration reads the tensors
    from the host, on either device. (A ``max_nodes`` below
    ``tree_capacity()`` can exhaust the slab; blocks allocated after that
    reuse the last one and the bound no longer holds.) Both forms walk the
    same rows to the same leaves.

    ``active`` masks games (finished games in lockstep self-play): inactive
    games' tree updates are suppressed and their outputs are defined but
    meaningless (callers must mask). ``generator`` (on the state's device)
    supplies the Dirichlet noise and the opening-move samples; it is drawn
    from by ``init`` and ``finish`` only, which run eagerly.

    Each (device, batch) gets a ``Workspace`` at first use, kept in
    ``workspaces`` for the life of this object, so a new search object
    frees its predecessor's. With ``graphs`` (the default) a CUDA state's
    iteration is one CUDA graph, captured at its second call in the first
    search of the shape (the first call runs eagerly as its warm-up) and
    replayed once an iteration. ``graphs=False``, which only a caller
    chooses, runs the same ops eagerly, the descent kernel included; so
    does a CPU state. The two forms compute the same ops in the same
    order, so the same results."""

    def __init__(self, eval_fn: BatchedEvaluator, config: MCTSConfig,
                 sims_per_call: Optional[int] = None, graphs: bool = True):
        self.eval_fn, self.config, self.graphs = eval_fn, config, graphs
        self.sims_per_call = sims_per_call or config.simulations
        if config.simulations % self.sims_per_call:
            raise ValueError("simulations must be divisible by sims_per_call")
        self.workspaces = {}

    @torch.no_grad()
    def __call__(self, root_state: BoardState, generator: torch.Generator, active=None) -> SearchResults:
        ws = self.init(root_state, generator, active)
        for _ in range(self.config.simulations // self.sims_per_call):
            self.segment(ws)
        return self.finish(ws, generator)

    @torch.no_grad()
    def init(self, root_state: BoardState, generator: torch.Generator, active=None) -> Workspace:
        """Reset the shape's workspace to these roots and evaluate them."""
        if active is None:
            active = torch.ones(root_state.batch_shape, dtype=torch.bool, device=root_state.device)
        key = (root_state.device, root_state.age.shape[0])
        ws = self.workspaces.get(key)
        if ws is None:
            ws = self.workspaces[key] = Workspace(
                key[1], self.config.tree_capacity(), key[0], self.graphs and key[0].type == "cuda")
        with launches.span("search.init", key[0]):
            ws.reset(root_state, active)
            _root_init(self.eval_fn, ws.tree, ws.root, generator, self.config)
            if launches.traced():  # a root is its node's first evaluation
                launches.tally(ws.evals, torch.where(ws.active, _USEFUL, _IDLE))
            _descent_start(ws.descent, ws.tree, ws.root, ws.active, ws.capacity)
        return ws

    @torch.no_grad()
    def segment(self, ws: Workspace) -> None:
        """Advance the search by ``sims_per_call`` simulations, an
        ``iteration`` at a time on a CUDA workspace, a ``level_iteration``
        on a CPU one."""
        K = self.config.parallel_sims
        if K > 1 and self.sims_per_call % K:
            raise ValueError("simulations must be divisible by parallel_sims")
        step = self.iteration if ws.rows.is_cuda else self.level_iteration
        for _ in range(self.sims_per_call // K):
            ws.iteration += 1
            step(ws)

    def iteration(self, ws: Workspace) -> None:
        """One iteration: the descent kernel walks every row to its leaf,
        then the rest of the iteration and the next descent's start; the
        spans ``launches.SEARCH_PHASES`` partition it."""
        def iteration():
            with launches.partition(ws.rows.device):
                launches.phase("search.descend")
                descend(ws.descent, ws.tree, ws.rows, self.config, ws.capacity, self._k)
                self._tail_and_start(ws)

        self._run(ws, "iteration", iteration)

    def level_iteration(self, ws: Workspace) -> None:
        """One iteration as ``min(t - 1, PATH_MAX - 2)`` descent levels and
        the tail (t = ``ws.iteration``): the CPU's form. On the card, with
        graphs, it replays a level graph and a tail graph: the form the
        descent kernel is held against. The spans
        ``launches.SEARCH_PHASES`` partition it, the levels in the first."""
        with launches.partition(ws.rows.device):
            launches.phase("search.descend")
            for _ in range(min(ws.iteration - 1, PATH_MAX - 2)):
                self.level(ws)
            self.tail(ws)

    def level(self, ws: Workspace) -> None:
        """One level of the descent."""
        self._run(ws, "level", lambda: _descend_level(
            ws.descent, ws.tree, ws.rows, self.config, ws.capacity, self._k))

    def tail(self, ws: Workspace) -> None:
        """The rest of an iteration after its descent, then the next
        descent's start."""
        self._run(ws, "tail", lambda: self._tail_and_start(ws))

    @property
    def _k(self) -> int:
        """The descent's overlay: K walkers, or 0 for the exact score."""
        K = self.config.parallel_sims
        return K if K > 1 else 0

    def _tail_and_start(self, ws: Workspace) -> None:
        tail = _tail_parallel if self.config.parallel_sims > 1 else _tail_exact
        tail(ws.tree, ws.descent, ws.rows, eval_fn=self.eval_fn, config=self.config, active=ws.active,
             capacity=ws.capacity, evals=ws.evals)
        _descent_start(ws.descent, ws.tree, ws.root, ws.active, ws.capacity)

    @staticmethod
    def _run(ws: Workspace, name: str, fn) -> None:
        if ws.graphs is None:
            fn()
        else:
            ws.graphs.run(name, fn)

    @torch.no_grad()
    def finish(self, ws: Workspace, generator: torch.Generator) -> SearchResults:
        """Moves and training targets; the tree is copied out of the
        workspace, which the next search of the shape overwrites."""
        with launches.span("search.finish", ws.rows.device):
            return _finish(ws.tree, ws.root, generator, self.config, legal_moves(ws.root))


def search(
    eval_fn: BatchedEvaluator,
    root_state: BoardState,
    generator: torch.Generator,
    config: MCTSConfig,
    active: Optional[torch.Tensor] = None,
) -> SearchResults:
    """Run ``config.simulations`` PUCT simulations for every game in the
    batch and return chosen moves plus training targets: one call of a
    fresh ``Search``."""
    return Search(eval_fn, config)(root_state, generator, active)


def make_search_fn(eval_fn: BatchedEvaluator, config: MCTSConfig, graphs: bool = True) -> Search:
    """Close over evaluator and config: ``(state, generator[, active])``.
    ``graphs=False`` runs a CUDA state's iterations eagerly (see
    ``Search``)."""
    return Search(eval_fn, config, graphs=graphs)


def make_chunked_search_fn(
    eval_fn: BatchedEvaluator, config: MCTSConfig, sims_per_call: int, graphs: bool = True
) -> Search:
    """A search split into a root init, ``simulations / sims_per_call``
    segments and a finish, with the tree carried between them; the same
    ops in the same order as ``make_search_fn``, so the same results. (On
    the TPU this kept each device call short; here it keeps the same
    contract for callers that pass ``sims_per_call``.)"""
    return Search(eval_fn, config, sims_per_call, graphs)
