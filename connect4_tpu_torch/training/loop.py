"""Training orchestrator.

The counterpart of ``connect4_tpu.training.loop``: per generation, generate
self-play games, train on the replay window, evaluate on the 8/7-ply
benchmark sets, and run a gating match every ``n_eval`` generations (vs the
centre heuristic for gen <= 10, else vs the net from 10 generations
earlier). Host Python orchestrates; the games, the search and the learner
run on ``device``.

With ``config.mesh_shape = (W,)`` the loop runs data parallel on the W
ranks of a ``torch.distributed`` group (``parallel.mesh``), every rank
running this loop in a process of its own, on one node or several
(``torchrun --nnodes N --nproc_per_node W/N --rdzv_backend c10d
--rdzv_endpoint HOST:PORT -m connect4_tpu_torch.cli training``): each
rank plays its block of the games (its own noise and openings), rank 0
writes the gathered generation, checkpoint and tables in the
single-device layout, every rank trains on the window with the
data-parallel step, and rank 0 alone evaluates and plays the gating
match. The ranks share ``save_dir``: on several nodes it must be one
directory that every node sees, since every rank reads the window and
resumes from rank 0's files (a rank that resumes at another generation
than rank 0 raises).

Differences from the JAX package, by design:
- Checkpoints are torch state dicts (net + optimiser + generator state).
- One ``torch.Generator`` on the device takes the place of the key chain,
  so noisy runs match the JAX package in distribution only.
- The metric tables (``8ply``, ``7ply``, ``match_results``) keep their
  names and columns but are JSON files (``training.tables``): the loop
  needs neither pandas nor matplotlib.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from connect4_tpu_torch.config import AlphaZeroConfig, MCTSConfig
from connect4_tpu_torch.eval.evaluators import (
    centre_evaluator_batched,
    make_net_evaluator,
)
from connect4_tpu_torch.eval.match import MatchPlayer, play_match
from connect4_tpu_torch.parallel.mesh import make_mesh, replicate
from connect4_tpu_torch.training import checkpoint as ckpt
from connect4_tpu_torch.training import replay
from connect4_tpu_torch.training.learner import (
    bce_loss,
    init_train_state,
    make_eval_fn,
    make_train_step,
    set_learning_rate,
    train_epochs,
)
from connect4_tpu_torch.training.self_play import (
    make_refill_play_fn,
    make_stepwise_play_fn,
)
from connect4_tpu_torch.training.stats import CombinedStats, ValueStats
from connect4_tpu_torch.training.tables import load_table, save_table
from connect4_tpu_torch.types import DRAW, O_WIN, X_WIN
from connect4_tpu_torch.utils import (
    DeviceLike,
    PhaseTimer,
    make_generator,
    np_load_retry,
    resolve_device,
)


class TrainingLoop:
    def __init__(self, config: AlphaZeroConfig, device: DeviceLike = None):
        self.config = config
        self.save_dir = config.storage_config.save_dir
        self.data_dir = config.storage_config.data_dir
        # make_mesh raises unless a process group of exactly mesh_shape's
        # size exists: a mesh never runs on one device quietly
        self.mesh = None if config.mesh_shape is None else make_mesh(config.mesh_shape, device)
        if self.mesh is None:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
                raise RuntimeError(
                    f"{dist.get_world_size()} ranks but config.mesh_shape is None: set "
                    f"mesh_shape=({dist.get_world_size()},) to train data parallel"
                )
        self.device = resolve_device(device) if self.mesh is None else self.mesh.device
        # rank 0 writes the run's files; every rank reads them
        self.writer = self.mesh is None or self.mesh.rank == 0
        self._log = print if self.writer else (lambda *args, **kwargs: None)
        if self.writer:
            os.makedirs(self.save_dir, exist_ok=True)
        if self.mesh is not None:
            self.mesh.barrier()

        self.state = init_train_state(
            config.model_config, torch.Generator().manual_seed(config.seed), self.device
        )
        self.generator = make_generator(config.seed + 1, self.device)

        restored = ckpt.restore_latest(self.save_dir, self.state, self.generator, self.device)
        if restored is not None:
            latest, self.state, self.generator = restored
            self._log(f"Resuming from generation {latest}")
            self.gen = latest + 1
        else:
            self.gen = 1
        if self.mesh is not None:
            # every rank restored from the shared save_dir; hold them to
            # rank 0's generation and make every replica rank 0's
            gen0 = int(self.mesh.broadcast(torch.tensor([self.gen], device=self.device)).item())
            if gen0 != self.gen:
                raise RuntimeError(
                    f"rank {self.mesh.rank} resumes at generation {self.gen}, rank 0 at {gen0}: "
                    "the ranks must share save_dir"
                )
            replicate(self.state, self.mesh)

        weighted = config.model_config.draw_loss_weight != 1.0
        self.train_step = make_train_step(
            self.state.net, self.state.optimizer, weighted=weighted, mesh=self.mesh
        )
        self.forward = make_eval_fn(self.state.net)

        self.stats_8ply = load_table(self.save_dir, "8ply")
        self.stats_7ply = load_table(self.save_dir, "7ply")
        self.match_results = load_table(self.save_dir, "match_results")
        # of the generation run last: seconds per phase and every batch's loss
        self.timer = PhaseTimer()
        self.train_losses: List[float] = []

    # -- public ------------------------------------------------------------

    def run(
        self, generations: Optional[int] = None, until: Optional[int] = None
    ) -> None:
        """Run ``generations`` iterations (forever when None), or up to the
        *absolute* generation ``until``, the restart-safe form: a run
        relaunched mid-way still stops at the same target. Touching
        ``<save_dir>/STOP`` stops the loop cleanly at the next generation
        boundary (checkpoints are per-generation, so a stopped run resumes
        exactly where it left off)."""
        end = None if generations is None else self.gen + generations
        if until is not None:
            end = until + 1 if end is None else min(end, until + 1)
        stop_file = os.path.join(self.save_dir, "STOP")
        while end is None or self.gen < end:
            stop = os.path.exists(stop_file)
            if self.mesh is not None:
                stop = self.mesh.agree(stop)
            if stop:
                self._log(f"STOP file present; stopping before generation {self.gen}")
                break
            self._log("Loop: ", self.gen)
            self.timer = PhaseTimer()
            self._loop()
            if self.writer:
                with self.timer.phase("evaluate"):
                    self._evaluate()
                if self.config.n_eval > 0 and self.gen % self.config.n_eval == 0:
                    with self.timer.phase("match"):
                        self._match()
                self._render_plots()
            self.gen += 1
        if self.mesh is not None:
            self.mesh.barrier()  # every rank leaves with rank 0's files complete

    def _render_plots(self) -> None:
        """Refresh the learning-curve PNGs in ``save_dir`` every
        generation; a plotting error (matplotlib missing included) never
        stops training."""
        try:
            from connect4_tpu_torch.training.plots import render

            render(self.save_dir, verbose=False)
        except Exception as exc:
            print(f"plot rendering failed: {exc}")

    # -- internals ---------------------------------------------------------

    def _loop(self) -> None:
        timer = self.timer
        self._log("Time now: {}".format(time.asctime(time.localtime())))
        with timer.phase("generate"):
            moves = self._generate_games()
        with timer.phase("train"):
            self._train()
        self._log(
            timer.summary({"generate": ("moves", moves)})
            + "  ({:,.0f} sims/s)".format(
                moves * self.config.simulations / max(timer.seconds["generate"], 1e-9)
            )
        )

    def _evaluator(self):
        # folds the BatchNorms and packs the tower's weights once, here: the
        # evaluator holds the weights as they are now
        return make_net_evaluator(self.state.net)

    def _generate_games(self) -> int:
        cfg = self.config.search_config(training=True)
        batch = min(self.config.selfplay_batch, self.config.n_training_games)
        if batch < self.config.n_training_games:
            # compact-and-refill: keep every slot busy until the game
            # budget is exhausted (one pass, no padded lockstep waves)
            play = make_refill_play_fn(
                self._evaluator(), cfg, batch,
                self.config.n_training_games, self.config.sims_per_call,
                device=self.device, mesh=self.mesh,
            )
        else:
            play = make_stepwise_play_fn(
                self._evaluator(), cfg, batch, self.config.sims_per_call,
                device=self.device, mesh=self.mesh,
            )
        # each rank draws its own noise and openings from a generator forked
        # off the shared one
        generator = self.generator if self.mesh is None else self.mesh.fork_generator(self.generator)
        outputs = [play(generator)]

        if self.writer:
            n_positions = replay.append_generation(self.save_dir, self.gen, outputs)
        if self.mesh is not None:
            self.mesh.barrier()  # the generation is on disk before any rank reads the window

        results = np.concatenate([o.result.cpu().numpy() for o in outputs])
        self._log(
            "Player one: wins, draws, losses:  {}, {}, {}".format(
                int((results == O_WIN).sum()),
                int((results == DRAW).sum()),
                int((results == X_WIN).sum()),
            )
        )
        if self.writer:
            self._log("{} positions created for training".format(n_positions))
        return int(sum(int(o.mask.sum()) for o in outputs))

    def _train(self, epoch_orders: Optional[Sequence[Sequence[int]]] = None) -> None:
        """Train on the replay window and save the checkpoint. Each epoch
        visits the rows in a fresh random order from the loop's generator
        (under a mesh, rank 0's order on every rank), or in
        ``epoch_orders[epoch]`` when orders are given."""
        mc = self.config.model_config
        use_ext = mc.draw_loss_weight != 1.0 or mc.value_target_mix > 0.0
        if use_ext:
            planes, values, policies, weights = replay.load_window_ex(
                self.save_dir, self.gen, mc.value_target_mix, mc.draw_loss_weight
            )
        else:
            planes, values, policies = replay.load_window(self.save_dir, self.gen)
            weights = None

        set_learning_rate(self.state.optimizer, mc.lr_at_generation(self.gen))

        # Epoch arrays stay on the device in the stored uint8 NCHW form
        # (126 B a row against 504 B as float32); the step converts each
        # batch, so the training math is unchanged.
        arrays = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (planes, values, policies) + ((weights,) if weights is not None else ())
        )
        if self.mesh is not None and epoch_orders is None:
            n = len(arrays[0])
            epoch_orders = [
                self.mesh.broadcast(torch.randperm(n, generator=self.generator, device=self.device))
                for _ in range(mc.n_training_epochs)
            ]
        # the losses stay on the device until the last epoch ends: one read
        self.train_losses = train_epochs(
            self.train_step, arrays, mc.batch_size, mc.n_training_epochs,
            self.generator, epoch_orders,
        ).cpu().tolist()
        self._log(
            "Training loss: {:.5f} -> {:.5f} over {} steps".format(
                self.train_losses[0], self.train_losses[-1], len(self.train_losses)
            )
        )
        if self.writer:
            ckpt.save_checkpoint(self.save_dir, self.gen, self.state, self.generator)

    def _benchmark_path(self, name: str) -> Optional[str]:
        path = os.path.join(self.data_dir, name)
        return path if os.path.exists(path) else None

    def _evaluate(self) -> None:
        """8-ply value and 7-ply value+policy benchmarks; a set that is
        absent is skipped, and of a partially built one only the solved
        rows are used."""
        path8 = self._benchmark_path("connect4dataset_8ply.npz")
        if path8:
            with np_load_retry(path8) as d:
                planes8, values8 = d["planes"], d["values"]
                if "solved" in d:
                    planes8, values8 = _solved_rows(d["solved"], "8-ply", planes8, values8)
            stats = value_stats(self.forward, planes8, values8, self.device)
            print("8 Ply Test Stats:  ", stats)
            self.stats_8ply.append(stats.to_dict())
            save_table(self.save_dir, "8ply", self.stats_8ply)

        path7 = self._benchmark_path("connect4dataset_7ply.npz")
        if path7:
            with np_load_retry(path7) as d:
                planes7, values7, policies7 = d["planes"], d["values"], d["policies"]
                if "solved" in d:
                    planes7, values7, policies7 = _solved_rows(
                        d["solved"], "7-ply", planes7, values7, policies7
                    )
            stats = combined_stats(self.forward, planes7, values7, policies7, self.device)
            print("7 Ply Test Stats:  ", stats)
            self.stats_7ply.append(stats.to_dict())
            save_table(self.save_dir, "7ply", self.stats_7ply)

    def _match(self) -> None:
        """Gating match: vs the centre heuristic until gen 10, then vs the
        checkpoint from 10 generations ago. The default plays all 49
        two-ply starts both colours (98 games, ``config.gating_plies``)."""
        az = MatchPlayer(
            "AlphaZero",
            self._evaluator(),
            self.config.search_config(training=False),
        )
        opponent_cfg = MCTSConfig(
            simulations=self.config.simulations, max_nodes=self.config.max_nodes
        )
        if self.gen <= 10:
            opponent = MatchPlayer(
                "Evaluate_centre_with_prior", centre_evaluator_batched, opponent_cfg
            )
        else:
            # Opponent is the checkpoint from 10 generations ago when it
            # exists; a run continued from a packaged checkpoint has no
            # such history, so fall back to the nearest available older
            # generation (else the oldest on disk) rather than crash.
            old_gen = self.gen - 10
            available = [
                g for g in ckpt.checkpoint_generations(self.save_dir)
                if g < self.gen
            ]
            older = [g for g in available if g <= old_gen]
            fallback = max(older) if older else min(available)
            if fallback != old_gen:
                print(
                    f"gating: no checkpoint for generation {old_gen}; "
                    f"using generation {fallback} instead",
                    flush=True,
                )
                old_gen = fallback
            old_state, _ = ckpt.restore_checkpoint(self.save_dir, old_gen, device=self.device)
            opponent = MatchPlayer(
                "Older net", make_net_evaluator(old_state.net), opponent_cfg
            )

        results = play_match(
            az, opponent,
            plies=self.config.gating_plies, switch=True, seed=self.gen,
            device=self.device,
        )
        self.match_results.append(results)
        save_table(self.save_dir, "match_results", self.match_results)


def _forward_batches(forward, planes: np.ndarray, device, batch_size: int = 4096):
    """``(slice, value, prior)`` of ``forward`` (``learner.make_eval_fn``)
    over stored NCHW planes, as numpy."""
    for i in range(0, len(planes), batch_size):
        sl = slice(i, min(i + batch_size, len(planes)))
        nchw = torch.from_numpy(np.ascontiguousarray(planes[sl])).to(device).float()
        value, prior = forward(nchw.permute(0, 2, 3, 1))
        yield sl, value.cpu().numpy(), prior.cpu().numpy()


def value_stats(forward, planes: np.ndarray, values: np.ndarray, device) -> ValueStats:
    """The 8-ply benchmark's statistics of a net: value MSE and bucketed
    accuracy over stored NCHW planes, in batches of 4096."""
    stats = ValueStats()
    for sl, value, _ in _forward_batches(forward, planes, device):
        vals = values[sl]
        stats.update(value, vals, float(np.mean((value - vals) ** 2)))
    return stats


def combined_stats(
    forward, planes: np.ndarray, values: np.ndarray, policies: np.ndarray, device
) -> CombinedStats:
    """The 7-ply benchmark's statistics of a net: the value's as for
    ``value_stats`` and the prior's binary cross-entropy and accuracy."""
    stats = CombinedStats()
    for sl, value, prior in _forward_batches(forward, planes, device):
        vals, priors = values[sl], policies[sl]
        prior_loss = bce_loss(torch.from_numpy(prior), torch.from_numpy(priors.astype(np.float32)))
        stats.update(
            value, vals, float(np.mean((value - vals) ** 2)),
            prior, priors, float(prior_loss),
        )
    return stats


def _solved_rows(solved: np.ndarray, name: str, *arrays: np.ndarray):
    """The rows of a partially built benchmark set that are solved."""
    n_solved, n_total = int(solved.sum()), len(solved)
    if n_solved < n_total:
        print(
            f"WARNING: {name} benchmark is partially built "
            f"({n_solved}/{n_total} positions solved); stats are measured on "
            f"that subset only and are NOT comparable to full-set numbers",
            flush=True,
        )
    return tuple(a[solved] for a in arrays)
