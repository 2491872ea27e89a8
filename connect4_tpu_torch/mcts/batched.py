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
  tree slabs in place (every read of a slab happens before the write that
  would change it, as in the JAX program order).
- **Loops.** ``lax.while_loop`` over the descent becomes a Python loop that
  reads ``descending.any()`` each step (one host sync per tree level);
  ``fori_loop`` over simulations becomes a Python loop.
- **Random numbers** come from one ``torch.Generator`` threaded through
  the search: Dirichlet noise from ``torch._standard_gamma``, opening
  sampling from ``torch.multinomial``. They are not JAX's bits, so the
  tests compare searches bit for bit with noise and sampling off.

Memory layout per game (N = ``MCTSConfig.tree_capacity()``): child slots
are allocated seven at a time, so a node's children occupy the contiguous
block ``[children_base, children_base + 7)`` and the move that leads to a
child is its offset in the block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.core import (
    BoardState,
    legal_moves,
    place_stone,
    result_value,
    step,
)
from connect4_tpu_torch.eval.evaluators import BatchedEvaluator
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
    k: int = 0,
    c_ov: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PUCT scores of the 7 child slots; -inf on illegal moves.

    ``k = 0`` and no ``c_ov`` is the exact score (``_child_score_parts``
    of the JAX package). ``k > 0`` is the constant-overlay score of the K
    lockstep walkers (``_const_overlay_score_parts``): the selecting node
    carries ``k`` virtual visits and each child ``c_ov`` of them, counted as
    losses from the selecting side's perspective."""
    parent_visits = node_stats[..., _VISITS]
    if k:
        parent_visits = parent_visits + float(k)
    log_term = torch.log((parent_visits + config.pb_c_base + 1.0) / config.pb_c_base)
    pb_c0 = (log_term + config.pb_c_init) * torch.sqrt(parent_visits)

    c_visits = child[..., _VISITS]
    c_vsum = child[..., _VSUM]
    c_tval = child[..., _TVAL]
    c_term = child[..., _TERM] > 0.5
    known = c_term | (c_visits > 0)

    if k:
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
        tree.stats[rows, node], child, tree.prior[rows, node], side, config, valid, k
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


def _descend(tree, rows, root_state, active, config, capacity, k):
    """Walk every active game from the root to a childless node, recording
    the path (column i holds the node at depth i; ``capacity`` elsewhere).
    Returns (leaf, leaf board, path, depth)."""
    batch = rows.shape[0]
    node = torch.zeros(batch, dtype=torch.long, device=rows.device)
    board = root_state
    descending = active & (tree.children_base[:, 0] >= 0)
    path = torch.full((batch, PATH_MAX), capacity, dtype=torch.long, device=rows.device)
    path[:, 0] = torch.where(active, 0, capacity)
    depth = torch.zeros(batch, dtype=torch.long, device=rows.device)
    i = 0
    while bool(descending.any()):
        valid = _descend_valid(board)
        scores = _node_scores(tree, rows, node, board, config, valid, capacity, k)
        move = _argmax_prefer_large(scores)
        child = tree.children_base[rows, node].long() + move
        board = _light_step(board, move, descending)
        node = torch.where(descending, child, node)
        path[:, i + 1] = torch.where(descending, node, capacity)
        depth += descending.long()
        descending = descending & (tree.children_base[rows, node] >= 0)
        i += 1
    return node, board, path, depth


def _expand(tree, rows, leaf, leaf_board, need_alloc, capacity) -> TreeArrays:
    """Allocate a 7-slot child block under ``leaf`` where ``need_alloc``
    and write the children's metadata. Returns the tree with its new
    ``next_free``; the slabs are updated in place."""
    base = tree.next_free.clamp(max=capacity - WIDTH)
    tree.children_base[rows, torch.where(need_alloc, leaf, capacity)] = base
    next_free = torch.where(
        need_alloc, (tree.next_free + WIDTH).clamp(max=capacity), tree.next_free
    )
    child_term, child_tval = _expand_metadata(leaf_board)
    child_stats = torch.zeros(child_term.shape + (4,), dtype=torch.float32, device=rows.device)
    child_stats[..., _TVAL] = child_tval
    child_stats[..., _TERM] = child_term.float()
    slot_idx = base.long()[:, None] + torch.arange(WIDTH, device=rows.device)
    slots = (rows[:, None], torch.where(need_alloc[:, None], slot_idx, capacity))
    tree.parent[slots] = leaf[:, None].to(torch.int32)
    tree.stats[slots] = child_stats
    tree.evaluated[slots] = False
    tree.children_base[slots] = -1
    return tree._replace(next_free=next_free)


def search(
    eval_fn: BatchedEvaluator,
    root_state: BoardState,
    generator: torch.Generator,
    config: MCTSConfig,
    active: Optional[torch.Tensor] = None,
) -> SearchResults:
    """Run ``config.simulations`` PUCT simulations for every game in the
    batch and return chosen moves plus training targets.

    ``active`` masks games (finished games in lockstep self-play): inactive
    games' tree updates are suppressed and their outputs are defined but
    meaningless (callers must mask). ``generator`` (on the state's device)
    supplies the Dirichlet noise and the opening-move samples."""
    if active is None:
        active = torch.ones(root_state.batch_shape, dtype=torch.bool, device=root_state.device)
    tree = _root_init(eval_fn, root_state, generator, config, active)
    tree = _run_sims(eval_fn, tree, root_state, config, active, config.simulations)
    return _finish(tree, root_state, generator, config, legal_moves(root_state))


def _root_init(
    eval_fn: BatchedEvaluator,
    root_state: BoardState,
    generator: torch.Generator,
    config: MCTSConfig,
    active: torch.Tensor,
) -> TreeArrays:
    """Evaluate the root and mix in Dirichlet noise once."""
    batch = root_state.age.shape[0]
    tree = _empty_tree(batch, config.tree_capacity(), root_state.device)

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
    return tree


def _run_sims(
    eval_fn: BatchedEvaluator,
    tree: TreeArrays,
    root_state: BoardState,
    config: MCTSConfig,
    active: torch.Tensor,
    n_sims: int,
) -> TreeArrays:
    """Advance the search by ``n_sims`` simulations, so a caller can split
    one search into segments."""
    kwargs = dict(
        eval_fn=eval_fn, config=config, root_state=root_state, active=active,
        capacity=config.tree_capacity(),
    )
    if config.parallel_sims > 1:
        if n_sims % config.parallel_sims:
            raise ValueError("simulations must be divisible by parallel_sims")
        for _ in range(n_sims // config.parallel_sims):
            tree = _simulate_parallel(tree, **kwargs)
        return tree
    for _ in range(n_sims):
        tree = _simulate_exact(tree, **kwargs)
    return tree


def _simulate_exact(
    tree: TreeArrays, *, eval_fn, config, root_state, active, capacity
) -> TreeArrays:
    """One simulation per game (K=1, the reference's exact semantics)."""
    batch = root_state.age.shape[0]
    rows = torch.arange(batch, device=root_state.device)

    # --- phase 1: descend to a childless node -------------------------
    leaf, leaf_board, path, depth = _descend(tree, rows, root_state, active, config, capacity, 0)

    # --- phase 2: expand evaluated non-terminal leaves ----------------
    # (leaf_board.result is accurately ONGOING for expanding games, so the
    # full env step in _expand_metadata computes true child results)
    leaf_term = tree.stats[rows, leaf, _TERM] > 0.5
    need_expand = active & tree.evaluated[rows, leaf] & ~leaf_term
    base = tree.next_free.clamp(max=capacity - WIDTH).long()
    tree = _expand(tree, rows, leaf, leaf_board, need_expand, capacity)

    # select one fresh child where we expanded
    scores = _node_scores(tree, rows, leaf, leaf_board, config, _descend_valid(leaf_board), capacity)
    move2 = _argmax_prefer_large(scores)
    cur_board = _light_step(leaf_board, move2, need_expand)
    cur = torch.where(need_expand, base + move2, leaf)

    # --- phase 3: evaluate the leaf -----------------------------------
    cur_stats = tree.stats[rows, cur]
    cur_term = cur_stats[:, _TERM] > 0.5
    value_net, prior_net = eval_fn(cur_board)
    value = torch.where(cur_term, cur_stats[:, _TVAL], value_net.float())
    prior_masked = _mask_normalise(prior_net, _descend_valid(cur_board))
    store_prior = active & ~cur_term & ~tree.evaluated[rows, cur]
    safe_cur = torch.where(store_prior, cur, capacity)
    tree.prior[rows, safe_cur] = prior_masked
    tree.evaluated[rows, safe_cur] = True

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
    return tree


def _simulate_parallel(
    tree: TreeArrays, *, eval_fn, config, root_state, active, capacity
) -> TreeArrays:
    """One iteration = K simulations per game, walker-deduplicated.

    Lockstep walkers share their whole descent (they see identical scores
    with a constant xK overlay on the path), so the descent runs once per
    game, the leaf is expanded once, K walkers fan out over its children
    sequentially from a precomputed [B, K, 7] score table (child c's score
    when it carries j virtual visits), the K fan-out boards are evaluated
    in one batched forward, and the backup adds (1, value) to each fan-out
    child and (K, sum of values) once along the shared path."""
    K = config.parallel_sims
    batch = root_state.age.shape[0]
    dev = root_state.device
    rows = torch.arange(batch, device=dev)

    # --- single descent per game (identical for all K walkers) ------------
    leaf, leaf_board, path, _ = _descend(tree, rows, root_state, active, config, capacity, K)

    # --- single expansion of the (shared) leaf ----------------------------
    leaf_term = tree.stats[rows, leaf, _TERM] > 0.5
    expandable = active & tree.evaluated[rows, leaf] & ~leaf_term
    need_alloc = expandable & (tree.children_base[rows, leaf] < 0)
    tree = _expand(tree, rows, leaf, leaf_board, need_alloc, capacity)

    # --- K-way fan-out over the leaf's children, table-driven -------------
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
    cur_stats = tree.stats[rows[:, None], nodes]  # [B, K, 4]
    cur_term = cur_stats[..., _TERM] > 0.5
    value_net, prior_net = eval_fn(boards.map(lambda x: x.reshape((batch * K,) + x.shape[2:])))
    value = torch.where(cur_term, cur_stats[..., _TVAL], value_net.reshape(batch, K).float())
    prior_masked = _mask_normalise(prior_net.reshape(batch, K, WIDTH), boards.height < HEIGHT)
    store_prior = active_k & ~cur_term & ~tree.evaluated[rows[:, None], nodes]
    safe_nodes = (rows[:, None], torch.where(store_prior, nodes, capacity))
    tree.prior[safe_nodes] = prior_masked
    tree.evaluated[safe_nodes] = True

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
        sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
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
        tree=tree.without_dump(),
    )


def make_search_fn(eval_fn: BatchedEvaluator, config: MCTSConfig):
    """Close over evaluator and config: ``(state, generator[, active])``."""

    @torch.no_grad()
    def run(root_state: BoardState, generator: torch.Generator, active=None):
        return search(eval_fn, root_state, generator, config, active)

    return run


def make_chunked_search_fn(
    eval_fn: BatchedEvaluator, config: MCTSConfig, sims_per_call: int
):
    """A search split into a root init, ``simulations / sims_per_call``
    segments and a finish, with the tree carried between them; the same
    ops in the same order as ``make_search_fn``, so the same results. (On
    the TPU this kept each device call short; here it keeps the same
    contract for callers that pass ``sims_per_call``.)"""
    if config.simulations % sims_per_call:
        raise ValueError("simulations must be divisible by sims_per_call")
    n_segments = config.simulations // sims_per_call

    @torch.no_grad()
    def run(root_state: BoardState, generator: torch.Generator, active=None) -> SearchResults:
        if active is None:
            active = torch.ones(root_state.batch_shape, dtype=torch.bool, device=root_state.device)
        tree = _root_init(eval_fn, root_state, generator, config, active)
        for _ in range(n_segments):
            tree = _run_sims(eval_fn, tree, root_state, config, active, sims_per_call)
        return _finish(tree, root_state, generator, config, legal_moves(root_state))

    return run
