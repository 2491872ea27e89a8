"""Judging self-play: the game records and the search trees it produced.

Everything here reads the program's outputs as plain tensors and judges
them by the rules of ``board`` and the net of ``net``; it imports nothing of
the program.

``judge_records`` replays every recorded game from the empty board: each
recorded plane set must be the position's, each move legal, the game must
end exactly at its last recorded ply with the recorded result, and each
policy target must be a distribution over the legal moves whose largest
entry is the move played (past the sampled opening plies) or that gives the
sampled move weight.

``judge_trees`` takes search trees as the search left them (struct of
arrays, a 7-slot child block a node, ``stats`` = visits, value sum,
terminal value, terminal flag) and their roots. The reference cannot replay
the search itself: the root's Dirichlet noise comes from the program's
generator, and a float32 net would steer PUCT down other branches than the
program's bf16 one. So it follows the program's own tree, node by node, and
checks each step of it: every node's board from the root through the moves
that lead to it; the rules' verdict on every legal child; the visit
conservation of the K-walker search (a visited node holds between 1 and K
visits beyond its children's, the root exactly 1, and 1 + simulations in
all); which nodes were evaluated; and each evaluation (a node's own value,
recovered as its value sum beyond its children's over those visits, and its
stored prior) against the reference net on that board.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from c4bench.reference import board as B
from c4bench.reference import net as ref_net

VISITS, VSUM, TVAL, TERM = 0, 1, 2, 3
# a policy target sums to 1 within float32 rounding of seven terms
SUM_TOL = 1e-5
# the move played holds the largest entry within one rounding of the
# division that made the target
ARGMAX_TOL = 1e-6


def judge_records(planes, moves, move_values, policies, mask, result, length, sampling_moves: int) -> Dict:
    """Replay ``G`` recorded games (``planes`` uint8 [G, 42, 3, 6, 7],
    ``moves`` [G, 42], ``move_values`` [G, 42], ``policies`` [G, 42, 7],
    ``mask`` bool [G, 42], ``result`` [G] codes, ``length`` [G]). Returns
    the number of games with any error and of plies replayed."""
    G = planes.shape[0]
    dev = planes.device
    rows = torch.arange(G, device=dev)
    bad = torch.zeros(G, dtype=torch.bool, device=dev)
    mask = mask.bool()
    n = mask.sum(1)
    bad |= length.long() != n
    prefix = torch.arange(B.CELLS, device=dev)[None, :] < n[:, None]
    bad |= (mask != prefix).any(1) | (n == 0)
    boards = B.empty(G, dev)
    over = torch.zeros(G, dtype=torch.bool, device=dev)
    for t in range(B.CELLS):
        on = mask[:, t]
        bad |= on & over  # a ply recorded after the game ended
        live = on & ~over
        want = B.planes(boards).to(torch.uint8)
        bad |= live & (planes[:, t] != want).flatten(1).any(1)
        legal = B.legal(boards)
        move = moves[:, t].long()
        ok_move = (move >= 0) & (move < B.COLS)
        move = move.clamp(0, B.COLS - 1)
        bad |= live & ~(ok_move & legal[rows, move])
        p = policies[:, t].float()
        p_ok = (p >= 0).all(1) & (p * ~legal).eq(0).all(1) & ((p.sum(1) - 1).abs() <= SUM_TOL)
        if t >= sampling_moves:
            p_ok &= p[rows, move] >= p.max(1).values - ARGMAX_TOL
        else:
            p_ok &= p[rows, move] > 0
        v = move_values[:, t].float()
        p_ok &= (v >= 0) & (v <= 1)
        bad |= live & ~p_ok
        boards, res = B.play(boards, move, live & ok_move & legal[rows, move])
        ended = live & (res != B.ONGOING)
        last = t + 1 >= B.CELLS
        nxt = mask[:, t + 1] if not last else torch.zeros_like(on)
        bad |= ended & (nxt | (res != result.long()))
        bad |= live & ~ended & ~nxt  # the record stops while the game runs
        over |= ended
    return {"games": G, "plies": int(n.sum()), "games_wrong": int(bad.sum())}


class Trees(NamedTuple):
    """Sampled rows of one search's tree slabs (without the dump column)."""

    parent: torch.Tensor  # int [R, N]
    children_base: torch.Tensor  # int [R, N]
    stats: torch.Tensor  # float32 [R, N, 4]
    prior: torch.Tensor  # float32 [R, N, 7]
    evaluated: torch.Tensor  # bool [R, N]
    next_free: torch.Tensor  # int [R]
    roots: B.Boards  # the roots' boards, R


def _node_boards(t: Trees):
    """Every node's board, whether it is a legal child, the rules' result
    on reaching it, and the structural errors met on the way."""
    R, N = t.parent.shape
    dev = t.parent.device
    idx = torch.arange(N, device=dev)[None, :].expand(R, N)
    used = idx < t.next_free[:, None].long()
    parent = t.parent.long()
    is_root = idx == 0
    pbase = torch.gather(t.children_base.long(), 1, parent.clamp(min=0))
    move = idx - pbase
    wrong = used & ~is_root & ((parent < 0) | (parent >= idx) | (pbase < 0) | (move < 0) | (move >= B.COLS))
    wrong |= is_root & (parent != -1)
    move = move.clamp(0, B.COLS - 1)
    parent = torch.where(is_root | wrong, 0, parent)
    flat = lambda x: x.reshape((R * N,) + x.shape[2:])  # noqa: E731
    base = (torch.arange(R, device=dev)[:, None] * N + parent).reshape(-1)
    # every node starts at its row's root and takes one step from its
    # parent's board a round: after 43 rounds each holds its own board
    roots = B.Boards(*(x[:, None].expand((R, N) + x.shape[1:]) for x in t.roots))
    start = B.Boards(*(flat(x).clone() for x in roots))
    boards, result = start, torch.zeros(R * N, dtype=torch.long, device=dev)
    step_on = flat(~is_root & used & ~wrong)
    legal_child = torch.zeros(R * N, dtype=torch.bool, device=dev)
    for _ in range(B.CELLS + 1):
        par = boards.take(base)
        col = flat(move)
        legal_child = B.legal(par)[torch.arange(R * N, device=dev), col]
        nxt, res = B.play(par, col, step_on & legal_child)
        boards = B.Boards(*(torch.where(_bcast(step_on, s), s2, s) for s, s2 in zip(start, nxt)))
        result = torch.where(step_on, res, torch.zeros_like(res))
    legal_child = legal_child.reshape(R, N) & ~is_root
    return boards, legal_child, result.reshape(R, N), wrong, used


def _bcast(m, x):
    return m.reshape(m.shape + (1,) * (x.dim() - 1))


def judge_trees(t: Trees, weights, net: dict, k: int, simulations: int) -> Dict:
    """Errors of structure and rules, and the tree's evaluations beside the
    reference net's on the same boards in float32 and in float8
    (``precision_gaps`` compares them)."""
    R, N = t.parent.shape
    dev = t.parent.device
    boards, legal_child, result, wrong, used = _node_boards(t)
    visits, vsum = t.stats[..., VISITS].double(), t.stats[..., VSUM].double()
    tval, term = t.stats[..., TVAL], t.stats[..., TERM] > 0.5
    cb = t.children_base.long()
    expanded = cb >= 0
    block = (cb.clamp(min=0)[..., None] + torch.arange(B.COLS, device=dev)).clamp(max=N - 1)
    rows = torch.arange(R, device=dev)[:, None, None]
    child_visits = torch.where(expanded, visits[rows, block].sum(-1), 0.0)
    child_vsum = torch.where(expanded, vsum[rows, block].sum(-1), 0.0)
    is_root = torch.arange(N, device=dev)[None, :] == 0
    node = used & (legal_child | is_root)
    ref_term = result != B.ONGOING
    errors = wrong.clone()
    # the root: a legal running game, evaluated once and searched in full
    roots_ok = B.well_formed(t.roots) & (B.status(t.roots) == B.ONGOING)
    errors[:, 0] |= ~roots_ok | term[:, 0] | ~t.evaluated[:, 0] | (visits[:, 0] != 1 + simulations)
    # the rules on every legal child
    errors |= node & ~is_root & (term != ref_term)
    errors |= node & ref_term & (tval != B.result_value(result))
    # children of full columns are never entered
    errors |= used & ~is_root & ~legal_child & ~wrong & ((visits != 0) | expanded)
    own = visits - child_visits  # visits beyond the children's
    visited = node & (visits > 0)
    live = visited & ~ref_term
    errors |= live & ~is_root & ((own < 1) | (own > k) | (own != own.round()))
    errors |= live & is_root & (own != 1)
    errors |= node & ref_term & (expanded | (vsum != visits * tval.double()))
    errors |= node & ~ref_term & (t.evaluated != (visits > 0))
    errors |= node & expanded & ~(live & t.evaluated)
    # evaluations against the reference net on each node's board
    value = ((vsum - child_vsum) / own.clamp(min=1)).float()
    ev = node & ~ref_term & t.evaluated & (visits > 0)
    flat_ev = ev.reshape(-1)
    planes = B.planes(boards.take(flat_ev.nonzero()[:, 0]))
    legal = B.legal(boards.take(flat_ev.nonzero()[:, 0]))
    not_root = ~is_root.expand(R, N).reshape(-1)[flat_ev]
    out = {"tree_rows": R, "nodes_checked": int(ev.sum()), "tree_errors": int(errors.sum()),
           "value": value.reshape(-1)[flat_ev], "prior": t.prior.reshape(-1, B.COLS)[flat_ev][not_root],
           "legal": legal[not_root]}
    for precision in ("f32", "fp8"):
        v_ref, p_ref = ref_net.evaluate(weights, net, planes, precision)
        masked = p_ref * legal
        out[f"value_{precision}"] = v_ref
        out[f"prior_{precision}"] = (masked / masked.sum(1, keepdim=True))[not_root]
    return out


def gap_stats(value, prior, v_ref, p_ref, legal) -> Dict[str, float]:
    """The gaps of evaluations ``value`` [M] and ``prior`` [M', 7] from the
    reference's ``v_ref``, ``p_ref``: the widest and the root mean square,
    of the values and of the legal prior entries."""
    dv = (value - v_ref).double()
    dp = (prior - p_ref).double()[legal]
    return {
        "value_max": float(dv.abs().max()) if dv.numel() else 0.0,
        "value_rms": float(dv.pow(2).mean().sqrt()) if dv.numel() else 0.0,
        "prior_max": float(dp.abs().max()) if dp.numel() else 0.0,
        "prior_rms": float(dp.pow(2).mean().sqrt()) if dp.numel() else 0.0,
    }


def precision_gaps(pooled: Dict[str, torch.Tensor]):
    """The compared numbers of the evaluations in ``pooled`` (the program's
    ``value`` and ``prior``, the reference's in float32 and in float8, and
    the legal moves): each of ``gap_stats``' gaps of the program from the
    float32 reference over the same gap of the float8 reference. A random
    net's sensitivity to rounding changes by an order of magnitude from
    seed to seed, and the program's gap and float8's move together; their
    ratio does not. A bf16 program reads about a tenth, float8 in its place
    reads 1. Returns ``(numbers, the absolute gaps)``."""
    ref = (pooled["value_f32"], pooled["prior_f32"], pooled["legal"])
    prog = gap_stats(pooled["value"], pooled["prior"], *ref)
    low = gap_stats(pooled["value_fp8"], pooled["prior_fp8"], *ref)
    numbers = {f"{k}_vs_fp8": prog[k] / max(low[k], 1e-30) for k in prog}
    return numbers, {**prog, **{f"{k}_fp8": v for k, v in low.items()}}
