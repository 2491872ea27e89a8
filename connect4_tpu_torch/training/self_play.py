"""Self-play generation on torch tensors.

The counterpart of ``connect4_tpu.training.self_play``. A batch of games
plays in lockstep: each ply runs one batched MCTS for every live game and
steps them together; finished games are masked and ride along. Per
recorded move we keep the pre-move planes, the chosen move, the chosen
child's value and the values-policy target; the value *training target*
is the final game result for every position.

``make_refill_play_fn`` is the main path (the self-play half of the
benchmark workload): a fixed pool of slots plays a budget of games,
refilling each slot the moment its game ends and narrowing the pool as it
drains. Random numbers come from one ``torch.Generator`` on the device the
games run on.

With a ``mesh`` (``parallel.mesh.Mesh``) each rank plays its block of the
games as an ordinary pool on its own device, with no collective inside a
wave, and the blocks are gathered once at the end: every rank returns the
whole output, in the layout of the same pool played in one process.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from connect4_tpu_torch import launches
from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.core import (
    BoardState,
    initial_state,
    result_value,
    step,
    to_planes,
)
from connect4_tpu_torch.eval.evaluators import BatchedEvaluator
from connect4_tpu_torch.mcts.batched import make_chunked_search_fn, make_search_fn
from connect4_tpu_torch.types import AREA, HEIGHT, ONGOING, WIDTH
from connect4_tpu_torch.utils import DeviceLike, resolve_device


class SelfPlayOutput(NamedTuple):
    """Per-game records, batch-major. ``mask[b, t]`` marks plies actually
    played; slots past the end of a game are zero-filled."""

    planes: torch.Tensor  # uint8[B, 42, 3, 6, 7] — pre-move board planes
    moves: torch.Tensor  # int32[B, 42]
    move_values: torch.Tensor  # float32[B, 42] — chosen child's absolute value
    policies: torch.Tensor  # float32[B, 42, 7] — values-policy targets
    mask: torch.Tensor  # bool[B, 42]
    result: torch.Tensor  # int8[B] — final result code
    length: torch.Tensor  # int32[B]


def _empty_buffers(n: int, device):
    """Game-major per-ply record buffers."""
    return (
        torch.zeros((n, AREA, 3, HEIGHT, WIDTH), dtype=torch.uint8, device=device),
        torch.zeros((n, AREA), dtype=torch.int32, device=device),
        torch.zeros((n, AREA), dtype=torch.float32, device=device),
        torch.zeros((n, AREA, WIDTH), dtype=torch.float32, device=device),
        torch.zeros((n, AREA), dtype=torch.bool, device=device),
    )


def _search_fn(eval_fn, config, sims_per_call):
    if sims_per_call is None:
        return make_search_fn(eval_fn, config)
    return make_chunked_search_fn(eval_fn, config, sims_per_call)


def _finalize(final_state: BoardState, bufs) -> SelfPlayOutput:
    planes, moves, values, policies, mask = bufs

    def zero(x):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 2)), x, torch.zeros_like(x))

    return SelfPlayOutput(
        planes=zero(planes),
        moves=torch.where(mask, moves, 0),
        move_values=torch.where(mask, values, 0.0),
        policies=zero(policies),
        mask=mask,
        result=final_state.result,
        length=mask.sum(dim=1).to(torch.int32),
    )


def make_stepwise_play_fn(
    eval_fn: BatchedEvaluator,
    config: MCTSConfig,
    batch: int,
    sims_per_call: Optional[int] = None,
    device: DeviceLike = None,
    mesh=None,
):
    """Lockstep generation of ``batch`` games, one host-driven search per
    ply; the loop exits as soon as every game is finished. Returns
    ``run(generator, progress=None) -> SelfPlayOutput``; ``progress(t,
    ongoing)`` is called after each ply. ``sims_per_call`` splits each
    search into segments (``make_chunked_search_fn``), with identical
    results.

    With a ``mesh`` rank r plays games ``[r B/W, (r+1) B/W)`` on the mesh's
    device and every rank returns all ``B`` games (``progress`` counts this
    rank's); ``batch`` must divide by the world size ``W``. Lockstep games
    are independent rows, so with noise off the output equals the one of a
    single process."""
    if mesh is not None:
        from connect4_tpu_torch.parallel.mesh import gather_output

        if batch % mesh.world_size:
            raise ValueError(f"batch {batch} must divide over {mesh.world_size} ranks")
        local = make_stepwise_play_fn(
            eval_fn, config, batch // mesh.world_size, sims_per_call, device=mesh.device,
        )
        return lambda generator, progress=None: gather_output(local(generator, progress), mesh)
    dev = resolve_device(device)
    search = _search_fn(eval_fn, config, sims_per_call)

    @torch.no_grad()
    def run(generator: torch.Generator, progress=None) -> SelfPlayOutput:
        state = initial_state((batch,), device=dev)
        planes_b, moves_b, values_b, policies_b, mask_b = bufs = _empty_buffers(batch, dev)
        for t in range(AREA):
            active = state.result == ONGOING
            res = search(state, generator, active)
            planes_b[:, t] = to_planes(state, dtype=torch.uint8)
            moves_b[:, t] = res.move
            values_b[:, t] = res.value
            policies_b[:, t] = res.values_policy
            mask_b[:, t] = active
            state = step(state, res.move, active)
            ongoing = int((state.result == ONGOING).sum())
            if progress is not None:
                progress(t, ongoing)
            if not ongoing:
                break
        return _finalize(state, bufs)

    run.search = search
    return run


def make_play_fn(
    eval_fn: BatchedEvaluator, config: MCTSConfig, batch: int, device: DeviceLike = None
):
    """``generator -> SelfPlayOutput`` for ``batch`` complete games in
    lockstep (the JAX package runs this as one device program; here it is
    the stepwise loop)."""
    return make_stepwise_play_fn(eval_fn, config, batch, device=device)


def play_games(
    eval_fn: BatchedEvaluator,
    config: MCTSConfig,
    batch: int,
    generator: torch.Generator,
    device: DeviceLike = None,
) -> SelfPlayOutput:
    """Play ``batch`` complete games in lockstep."""
    return make_play_fn(eval_fn, config, batch, device=device)(generator)


def make_refill_play_fn(
    eval_fn: BatchedEvaluator,
    config: MCTSConfig,
    slots: int,
    total_games: int,
    sims_per_call: Optional[int] = None,
    n_blocks: Optional[int] = None,
    device: DeviceLike = None,
    mesh=None,
):
    """Compact-and-refill generation: a fixed pool of ``slots`` board slots
    plays ``total_games`` complete games, resetting each slot to a fresh
    game the moment its current one ends, so almost every search row is
    useful work. Returns ``run(generator, progress=None) -> SelfPlayOutput``
    with ``progress(wave, live)`` called once per wave.

    Record buffers are game-indexed ``[total_games, 42, ...]`` and written
    by scatter at ``(game_id, age)``; finished slots with no game budget
    left idle out (``game_id = -1``).

    ``n_blocks`` partitions the pool into independent blocks of
    ``slots/n_blocks`` slots, each owning a contiguous budget of
    ``total_games/n_blocks`` game ids; refill bookkeeping stays within a
    block (the contract a multi-device pool relies on). Once the game
    budget is spent and the live rows fit in half the pool, a single-block
    pool compacts them into a pool of half the width, down to 64 rows.

    With a ``mesh`` of W ranks (``n_blocks`` defaults to W and must divide
    by it), rank r plays blocks ``[r n/W, (r+1) n/W)``: ``slots/W`` slots and
    game ids ``[r G/W, (r+1) G/W)``, as a pool of its own on the mesh's
    device (narrowing as it drains when it holds one block), and every rank
    returns all ``G`` games. With noise off and an evaluator that is exact
    per row, the output equals the single-process pool's with the same
    ``n_blocks`` bit for bit: blocks share nothing, and narrowing keeps every
    live row's search.
    """
    if slots > total_games:
        raise ValueError("slots must be <= total_games")
    G, S = total_games, slots
    if n_blocks is None:
        n_blocks = 1 if mesh is None else mesh.world_size
    if S % n_blocks or G % n_blocks:
        raise ValueError(f"slots {S} and total_games {G} must divide into {n_blocks} blocks")
    Sb, Gb = S // n_blocks, G // n_blocks
    if Sb > Gb:
        raise ValueError("slots per block must be <= games per block")
    if mesh is not None:
        from connect4_tpu_torch.parallel.mesh import gather_output

        W = mesh.world_size
        if n_blocks % W:
            raise ValueError(f"{n_blocks} blocks do not divide over {W} ranks")
        local = make_refill_play_fn(
            eval_fn, config, S // W, G // W, sims_per_call, n_blocks // W, device=mesh.device,
        )
        return lambda generator, progress=None: gather_output(local(generator, progress), mesh)
    dev = resolve_device(device)
    search = _search_fn(eval_fn, config, sims_per_call)
    can_narrow = n_blocks == 1
    MIN_WIDTH = 64

    def record_step_refill(state, game_ids, bufs, results, next_game, res, active):
        # Width-polymorphic: the drain phase calls this at narrower pool
        # widths, so row counts come from the inputs.
        Sw = active.shape[0]
        Sbw = Sw // n_blocks
        planes_b, moves_b, values_b, policies_b, mask_b = bufs
        # Inactive rows write to the dump game row G of each buffer (torch
        # has no dropped scatter); their ply index is clamped into range.
        gid = torch.where(active, game_ids, G).long()
        t = torch.where(active, state.age, 0).long()  # pre-move ply within the game
        planes_b[gid, t] = to_planes(state, dtype=torch.uint8)
        moves_b[gid, t] = res.move
        values_b[gid, t] = res.value
        policies_b[gid, t] = res.values_policy
        mask_b[gid, t] = torch.ones((), dtype=torch.bool, device=dev)  # not a host scalar: no copy, no sync
        state = step(state, res.move, active)

        # slots whose game just ended: record the result, then either start
        # the next unplayed game or go idle (game_id = -1), per block
        done = active & (state.result != ONGOING)
        results[torch.where(done, game_ids, G).long()] = state.result
        done_blk = done.reshape(n_blocks, Sbw)
        rank = torch.cumsum(done_blk.int(), dim=1) - 1  # rank among done
        new_id = (next_game[:, None] + rank).reshape(Sw)
        block_end = (torch.arange(n_blocks, device=dev, dtype=torch.int32) + 1) * Gb
        can_start = done & (new_id < torch.repeat_interleave(block_end, Sbw))
        fresh = initial_state((Sw,), device=dev)
        state = BoardState(*(
            torch.where(can_start.reshape((Sw,) + (1,) * (cur.dim() - 1)), f, cur)
            for cur, f in zip(state, fresh)
        ))
        game_ids = torch.where(can_start, new_id, torch.where(done, -1, game_ids)).to(torch.int32)
        next_game = torch.minimum(next_game + done_blk.sum(dim=1, dtype=torch.int32), block_end)
        active_next = (game_ids >= 0) & (state.result == ONGOING)
        return state, game_ids, results, next_game, active_next, active_next.sum()

    def compact(state, game_ids, active, width: int):
        """Keep the ``width`` rows that are live (plus idle filler), live
        rows first, original order preserved. Callers guarantee live <=
        width; dropped rows are idle, their games already recorded."""
        Sw = active.shape[0]
        keys = torch.where(active, 0, Sw + 1) * Sw + torch.arange(Sw, device=dev)
        perm = torch.argsort(keys)[:width]
        return state.map(lambda x: x[perm]), game_ids[perm], active[perm]

    @torch.no_grad()
    def run(generator: torch.Generator, progress=None) -> SelfPlayOutput:
        rows = torch.arange(S, device=dev, dtype=torch.int32)
        state = initial_state((S,), device=dev)
        game_ids = (rows // Sb) * Gb + rows % Sb  # block-contiguous
        bufs = _empty_buffers(G + 1, dev)  # + the dump game row
        results = torch.zeros((G + 1,), dtype=torch.int8, device=dev)
        next_game = torch.arange(n_blocks, device=dev, dtype=torch.int32) * Gb + Sb
        active = torch.ones((S,), dtype=torch.bool, device=dev)
        width = S
        pending_live = None  # previous wave's live count, still on the device
        for wave in range(G * AREA):  # safety bound; exits when the pool drains
            with launches.span(launches.WAVE_PARTS["search"], dev):
                res = search(state, generator, active)
            with launches.span(launches.WAVE_PARTS["record"], dev):
                state, game_ids, results, next_game, active, live_dev = record_step_refill(
                    state, game_ids, bufs, results, next_game, res, active
                )
            # One-wave-lagged termination check, as in the JAX package: the
            # host reads wave N's live count after enqueuing wave N+1. It
            # costs one all-inactive wave at the end (its writes all go to
            # the dump row).
            if pending_live is not None:
                with launches.span(launches.WAVE_PARTS["transfer"], dev):
                    live = int(pending_live)
                if progress is not None:
                    progress(wave - 1, live)
                if not live:
                    break
                # the lagged count only ever overstates the current live
                # count once the budget is gone, so fitting is guaranteed
                if can_narrow and live <= width // 2 and width // 2 >= MIN_WIDTH:
                    while live <= width // 2 and width // 2 >= MIN_WIDTH:
                        width //= 2
                    with launches.span(launches.WAVE_PARTS["gather"], dev):
                        state, game_ids, active = compact(state, game_ids, active, width)
            pending_live = live_dev
        else:
            if pending_live is not None and progress is not None:
                progress(wave, int(pending_live))
        planes, moves, values, policies, mask = (x[:G] for x in bufs)
        return SelfPlayOutput(
            planes=planes,
            moves=moves,
            move_values=values,
            policies=policies,
            mask=mask,
            result=results[:G],
            length=mask.sum(dim=1).to(torch.int32),
        )

    run.search = search  # its workspaces, one a pool width, hold the graphs
    return run


def training_arrays(output: SelfPlayOutput) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a generation into (planes, value_targets, policy_targets)
    with left-right mirror augmentation doubling the data. The value target
    of every position of a game is that game's final result."""
    mask = output.mask.cpu().numpy()
    planes = output.planes.cpu().numpy()
    policies = output.policies.cpu().numpy()
    results = result_value(output.result).cpu().numpy()

    b_idx, t_idx = np.nonzero(mask)
    sel_planes = planes[b_idx, t_idx].astype(np.uint8)  # [M, 3, 6, 7]
    sel_policies = policies[b_idx, t_idx].astype(np.float32)
    sel_values = results[b_idx].astype(np.float32)
    return (
        np.concatenate([sel_planes, sel_planes[:, :, :, ::-1]]),
        np.concatenate([sel_values, sel_values]),
        np.concatenate([sel_policies, sel_policies[:, ::-1]]),
    )
