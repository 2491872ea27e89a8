"""Position evaluators.

The counterpart of ``connect4_tpu.eval.evaluators``. A batched evaluator
maps a ``BoardState`` with batch shape ``[...]`` to ``(value [...],
prior [..., 7])`` float32 tensors on the state's device; a host evaluator
maps one ``HostBoard`` to ``(value, prior [7])`` in numpy, for the
sequential reference search (``mcts.host``) and ``eval.grid_search``.

- ``centre_evaluator_batched`` and ``centre_evaluator_host``: the
  deterministic centre-weighted heuristic (each stone scores its
  distance-from-edge weight, value = 0.5 + (o_score - x_score) / 96, prior
  uniform), in float32 as in the JAX package, so search trees can be
  compared across the two packages and between the host and batched search.
- ``make_net_evaluator``: a network forward on the planes of the leaf
  boards, in two stages (``stages``): the planes and the tower, then the
  heads. With ``fold_bn=True`` and a bf16 net it runs the folded tower
  of ``models.tower``: on a CUDA state that is a hand-written kernel, the
  fused one (every layer in one launch) for a net of up to 256 filters,
  the layer kernel (one launch a conv) above, at any width. On a CPU state
  it is the tower's plain version at every width.

``stages(eval_fn)`` gives ``(trunk, heads)`` with ``eval_fn(state) ==
heads(trunk(state))``, so that the search can mark where each begins; an
evaluator without stages is all trunk.

On a CUDA state the search captures its evaluator into CUDA graphs
(``mcts.batched.Search``), so a batched evaluator reads nothing back to
the host and copies nothing from it: every constant is made on the device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from connect4_tpu_torch.env.core import BoardState, to_planes
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.models.net import Connect4Net, fold_bn_params, inference_net
from connect4_tpu_torch.types import HEIGHT, WIDTH


def _make_centre_grid() -> np.ndarray:
    col_w = np.minimum(np.arange(WIDTH), np.arange(WIDTH)[::-1]).astype(np.float32)
    row_w = np.minimum(np.arange(HEIGHT), np.arange(HEIGHT)[::-1]).astype(np.float32)
    return row_w[:, None] + col_w[None, :]


CENTRE_GRID = _make_centre_grid()  # [6, 7], symmetric both ways
CENTRE_GRID_SUM = float(CENTRE_GRID.sum())  # 96.0
UNIFORM_PRIOR = np.full((WIDTH,), 1.0 / WIDTH, dtype=np.float32)

BatchedEvaluator = Callable[[BoardState], Tuple[torch.Tensor, torch.Tensor]]


def centre_value_host(board: HostBoard) -> float:
    """Scalar heuristic value in float32 (the grid is symmetric, so the
    bottom-up planes score as the reference's top-down ones)."""
    o = board.pieces[0].astype(np.float32)
    x = board.pieces[1].astype(np.float32)
    diff = np.float32((o * CENTRE_GRID).sum()) - np.float32((x * CENTRE_GRID).sum())
    return float(np.float32(0.5) + diff / np.float32(CENTRE_GRID_SUM))


def centre_evaluator_host(board: HostBoard) -> Tuple[float, np.ndarray]:
    return centre_value_host(board), UNIFORM_PRIOR.copy()


def _centre_grid(device) -> torch.Tensor:
    """``CENTRE_GRID`` made on ``device`` by tensor ops: a search captured
    into a CUDA graph evaluates with it, and a graph cannot hold a copy
    from pageable host memory."""
    col = torch.arange(WIDTH, device=device)
    row = torch.arange(HEIGHT, device=device)
    col_w = torch.minimum(col, WIDTH - 1 - col)
    row_w = torch.minimum(row, HEIGHT - 1 - row)
    return (row_w[:, None] + col_w[None, :]).float()


def centre_evaluator_batched(state: BoardState) -> Tuple[torch.Tensor, torch.Tensor]:
    grid = _centre_grid(state.device)
    o = state.pieces[..., 0, :, :].float()
    x = state.pieces[..., 1, :, :].float()
    diff = (o * grid).sum(dim=(-2, -1)) - (x * grid).sum(dim=(-2, -1))
    value = 0.5 + diff / CENTRE_GRID_SUM
    prior = torch.full(state.age.shape + (WIDTH,), 1.0 / WIDTH, device=state.device)
    return value, prior


def make_net_evaluator(net: Connect4Net, fold_bn: bool = True) -> BatchedEvaluator:
    """Wrap a ``Connect4Net`` into the batched evaluator interface. Leaf
    boards are encoded on their device and evaluated in one forward.

    ``fold_bn=True`` (default) folds the frozen BatchNorms into the convs
    once, here. A bf16 net then runs the folded tower of ``models.tower``
    (a CUDA kernel on a CUDA state: the fused kernel up to 256 filters, the
    layer kernel above; its plain version on a CPU state); a float32 net
    runs the folded ``InferenceNet``. ``fold_bn=False`` runs the net as it
    is. The evaluator's ``stages`` are the planes and the folded tower, then
    the heads; an unfolded net or a float32 one is all trunk."""
    config = net.config
    head = None
    if not fold_bn:
        body = net.eval()
    elif config.compute_dtype == "bfloat16":
        packed = tower.pack_weights(config, fold_bn_params(net))
        body = lambda nhwc: tower.run_tower(packed, tower.input_rows(nhwc))  # noqa: E731
        head = lambda t: tower.heads(packed, t)  # noqa: E731
    else:
        body = inference_net(net)

    @torch.no_grad()
    def trunk(state: BoardState):
        nhwc = to_planes(state).reshape((-1, 3, HEIGHT, WIDTH)).permute(0, 2, 3, 1)
        return body(nhwc), state.age.shape

    @torch.no_grad()
    def heads(features):
        out, lead = features
        value, prior = out if head is None else head(out)
        return value.float().reshape(lead), prior.float().reshape(lead + (WIDTH,))

    def evaluate(state: BoardState):
        return heads(trunk(state))

    evaluate.stages = (trunk, heads)
    return evaluate


def _whole(out):
    return out


def stages(eval_fn: BatchedEvaluator):
    """``(trunk, heads)`` of a batched evaluator, ``eval_fn(state) ==
    heads(trunk(state))``: ``eval_fn.stages`` where it has them, else
    ``eval_fn`` and nothing after it."""
    return getattr(eval_fn, "stages", (eval_fn, _whole))
