"""Scalar host MCTS: the semantic oracle.

A copy of ``connect4_tpu.mcts.host`` under the port's imports (the port
never imports the JAX package). A minimal pointer-tree PUCT search that
pins down the *behaviour* of the reference's MCTS (``oinkoink/mcts.py:94-203``
and ``oinkoink/tree.py``) so that the batched search can be held against
it. It is not a performance path. Reference semantics reproduced here:

- The root is evaluated before the loop and Dirichlet noise is mixed into
  its masked-renormalised prior exactly once (``mcts.py:100-105``).
- Descent follows PUCT to a childless node; if that node was already
  evaluated it is expanded one ply and one fresh child is selected
  (``mcts.py:110-116``).
- Terminal nodes are never expanded or given a prior; every revisit re-adds
  the terminal value to their running stats (``mcts.py:124-128``).
- A child with no statistics counts as value 0.0 ("assume lost"),
  regardless of perspective (``tree.py:38-44``).
- UCB ties break toward the *largest* move index (``tree.py:10-15``).
- Move choice is by child *value*, not visit count; the first
  ``num_sampling_moves`` plies sample proportionally to value^2
  (``mcts.py:78-88``).

All score arithmetic runs in a configurable ``dtype``: float32 (the
default) matches the batched search bit for bit wherever the operation
order coincides; float64 matches the reference's pure-double Python
arithmetic instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.types import WIDTH, Side

f32 = np.float32


@dataclasses.dataclass
class HostNode:
    board: HostBoard
    parent: Optional["HostNode"] = None
    move: Optional[int] = None
    children: Dict[int, "HostNode"] = dataclasses.field(default_factory=dict)
    prior: Optional[np.ndarray] = None  # own prior over moves, post-mask
    position_value: Optional[float] = None
    visits: int = 0
    value_sum: float = 0.0  # accumulates in ``dtype``
    dtype: type = np.float32

    @property
    def terminal(self) -> bool:
        return self.board.result is not None

    @property
    def evaluated(self) -> bool:
        return self.position_value is not None

    def absolute_value(self) -> Optional[float]:
        if self.terminal:
            return self.board.result.value
        if self.visits > 0:
            return float(self.value_sum / self.dtype(self.visits))
        if self.evaluated:
            return self.position_value
        return None

    def value_for(self, side: Side):
        f = self.dtype
        av = self.absolute_value()
        if av is None:
            return f(0.0)  # unknown => assume lost
        return f(av) if side == Side.o else f(1.0) - f(av)


class HostMCTS:
    """Reference-semantics search over ``HostBoard`` positions."""

    def __init__(
        self,
        config: MCTSConfig,
        evaluate_fn: Callable[[HostBoard], Tuple[float, np.ndarray]],
        rng: Optional[np.random.Generator] = None,
        dtype: type = np.float32,
    ):
        self.config = config
        self.evaluate_fn = evaluate_fn
        self.rng = rng or np.random.default_rng(0)
        self.f = dtype

    # -- public API --------------------------------------------------------

    def search(self, board: HostBoard) -> HostNode:
        root = HostNode(board.copy(), dtype=self.f)
        self._evaluate(root)
        root.prior = self._add_root_noise(root.prior, root.board.valid_moves)
        for _ in range(self.config.simulations):
            node = root
            while node.children:
                node = self._select_child(node)
            if node.evaluated and not node.terminal:
                self._expand(node)
                node = self._select_child(node)
            value = self._evaluate(node)
            # credit the whole path including the leaf itself
            walker = node.parent
            while walker is not None:
                walker.visits += 1
                walker.value_sum += self.f(value)
                walker = walker.parent
        return root

    def make_move(self, board: HostBoard) -> Tuple[int, float, HostNode]:
        """Search, choose, and apply a move; returns (move, value, root)."""
        root = self.search(board)
        side = root.board.player_to_move
        if board.age < self.config.num_sampling_moves:
            child = self._sample_value_sq(root, side)
        else:
            child = self._best_child(root, side)
        board.make_move(child.move)
        return child.move, child.absolute_value(), root

    def values_policy(self, root: HostNode) -> np.ndarray:
        """The value-based policy target
        (``oinkoink/tree.py:104-109,139-147``)."""
        side = root.board.player_to_move
        policy = np.zeros(WIDTH, dtype=self.f)
        for move, child in root.children.items():
            policy[move] = child.value_for(side)
        total = policy.sum()
        if total == 0.0:
            for move in root.children:
                policy[move] = 1.0
            policy /= len(root.children)
        else:
            policy /= total
        return policy

    def visit_policy(self, root: HostNode) -> np.ndarray:
        policy = np.zeros(WIDTH, dtype=np.float32)
        for move, child in root.children.items():
            policy[move] = child.visits
        total = policy.sum()
        if total > 0:
            policy /= total
        return policy

    # -- internals ---------------------------------------------------------

    def _evaluate(self, node: HostNode) -> float:
        if node.terminal:
            value = node.board.result.value
        else:
            value, prior = self.evaluate_fn(node.board)
            prior = _mask_normalise(np.asarray(prior, dtype=self.f),
                                    node.board.valid_moves)
            node.prior = prior
            node.position_value = float(value)
        node.visits += 1
        node.value_sum += self.f(value)
        return value

    def _expand(self, node: HostNode) -> None:
        for move in sorted(node.board.valid_moves):
            child_board = node.board.copy()
            child_board.make_move(move)
            node.children[move] = HostNode(
                child_board, parent=node, move=move, dtype=node.dtype
            )

    def _select_child(self, node: HostNode) -> HostNode:
        cfg = self.config
        f = self.f
        side = node.board.player_to_move
        pv = node.visits
        log_term = f(np.log(f((f(pv) + f(cfg.pb_c_base) + f(1.0)) / f(cfg.pb_c_base))))
        pb_c0 = (log_term + f(cfg.pb_c_init)) * f(np.sqrt(f(pv)))
        best_score, best_move = -np.inf, -1
        for move in sorted(node.children):
            child = node.children[move]
            pb_c = pb_c0 / f(child.visits + 1)
            score = pb_c * node.prior[move] + child.value_for(side)
            if score >= best_score:  # >= biases ties toward the larger move
                best_score, best_move = score, move
        return node.children[best_move]

    def _best_child(self, node: HostNode, side: Side) -> HostNode:
        best_val, best_move = -np.inf, -1
        for move in sorted(node.children):
            val = node.children[move].value_for(side)
            if val >= best_val:
                best_val, best_move = val, move
        return node.children[best_move]

    def _sample_value_sq(self, node: HostNode, side: Side) -> HostNode:
        moves = sorted(node.children)
        weights = np.array(
            [node.children[m].value_for(side) ** 2 for m in moves], dtype=np.float64
        )
        probs = weights / weights.sum()
        idx = self.rng.choice(len(moves), p=probs)
        return node.children[moves[idx]]

    def _add_root_noise(self, prior: np.ndarray, valid_moves) -> np.ndarray:
        cfg = self.config
        if cfg.root_dirichlet_alpha and cfg.root_exploration_fraction:
            noise = self.rng.gamma(cfg.root_dirichlet_alpha, 1.0, WIDTH).astype(
                self.f
            )
            noise = _mask_normalise(noise, valid_moves)
            frac = self.f(cfg.root_exploration_fraction)
            prior = prior * (self.f(1.0) - frac) + noise * frac
        return prior


def _mask_normalise(prior: np.ndarray, valid_moves) -> np.ndarray:
    out = prior.copy()
    for move in range(WIDTH):
        if move not in valid_moves:
            out[move] = 0.0
    return out / out.sum()
