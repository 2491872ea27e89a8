"""The reference against the program's CPU path, and the judgement against
planted faults, at small sizes on the CPU.

    python3 -m pytest c4bench/tests -q -p no:cacheprovider

Each fault test drives the rest of a run (set-up, window, judgement) with
the timed path broken underneath and sees ``correct`` come out false under
the cell's own limits; the sound run beside them comes out true.
"""

from __future__ import annotations

import copy
import json
import os
import time

import pytest
import torch

from c4bench import run
from c4bench.kinds import common, selfplay, train
from c4bench.reference import board as B
from c4bench.reference import net as ref_net

torch.set_num_threads(2)
SEED = 2**40 + 12345  # more than 32 bits, as the driver's seeds are


def _load(*parts):
    with open(os.path.join(run.ROOT, "c4bench", *parts)) as fh:
        return json.load(fh)


def tiny(dtype="float32"):
    cfg = _load("configs", "oinkoink-f64.json")
    cfg["net"].update(filters=8, n_residuals=1, n_fc_layers=2, compute_dtype=dtype)
    cfg["search"].update(simulations=16, parallel_sims=4, slots=8, sims_per_call=8)
    cfg["train"].update(batch_size=64)
    sp = _load("traffic", "selfplay.json")
    sp.update(games_per_call=16, check_rows=4)
    tr = _load("traffic", "train.json")
    tr.update(window_positions=1024, chunk_steps=2)
    return cfg, sp, tr


def _random_planes(n, seed):
    g = torch.Generator().manual_seed(seed)
    boards = B.empty(n, "cpu")
    for _ in range(12):
        legal = B.legal(boards).float()
        col = torch.multinomial(legal, 1, generator=g)[:, 0]
        boards, _ = B.play(boards, col, B.status(boards) == B.ONGOING)
    return B.planes(boards)


@pytest.mark.parametrize("train_mode", [False, True])
def test_reference_forward_equals_the_program(train_mode):
    cfg, _, _ = tiny()
    w = common.make_weights(cfg["net"], SEED, "cpu")
    net = common.program_net(cfg["net"], w, "cpu").train(train_mode)
    planes = _random_planes(64, 1)
    with torch.no_grad():
        v_prog, p_prog = net(planes, nchw=True)
        v_ref, p_ref = ref_net.forward(w, cfg["net"], planes, train=train_mode)
    assert torch.allclose(v_prog, v_ref, atol=1e-5) and torch.allclose(p_prog, p_ref, atol=1e-5)


def test_reference_train_steps_equal_the_program():
    from connect4_tpu_torch.training.learner import TrainState, make_optimizer, make_train_step

    cfg, _, tr = tiny()
    w = common.make_weights(cfg["net"], SEED, "cpu")
    data = train.make_window(512, SEED, "cpu")
    batches = [tuple(a[i * 64:(i + 1) * 64] for a in data) for i in range(3)]
    net = common.program_net(cfg["net"], w, "cpu")
    state = TrainState(net, make_optimizer(train._model_config(cfg), net))
    step = make_train_step(state.net, state.optimizer)
    losses = [float(step(*b)["loss"]) for b in batches]
    t = cfg["train"]
    r_losses, _, _, r_after = ref_net.sgd_steps(w, cfg["net"], batches, t["lr"], t["momentum"], t["weight_decay"])
    assert max(abs(a - b) for a, b in zip(losses, r_losses)) < 1e-5
    for k, p in net.named_parameters():
        assert torch.allclose(p.detach(), r_after[k], atol=1e-6), k


def test_window_is_running_positions_mirrored_in_pairs():
    planes, values, policies = train.make_window(2048, SEED, "cpu")
    half = 1024
    assert torch.equal(planes[half:], torch.flip(planes[:half], dims=(3,)))
    boards = B.from_planes(planes.float())
    assert bool(B.well_formed(boards).all()) and bool((B.status(boards) == B.ONGOING).all())
    assert torch.equal(boards.age % 2 == 0, planes[:, 0, 0, 0] == 1)
    assert bool(((policies * ~B.legal(boards)) == 0).all())
    assert torch.allclose(policies.sum(1), torch.ones(2048))
    assert set(values.tolist()) <= {0.0, 0.5, 1.0}
    again = train.make_window(2048, SEED, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((planes, values, policies), again))


def _limits(cell):
    return _load("limits", f"{cell}.json")


def _selfplay(cfg, sp, seconds=3.0, control=False):
    return selfplay.run(cfg, sp, SEED, seconds, False, "cpu", time.perf_counter(), control=control)


def _train(cfg, tr, seconds=2.0, control=False):
    return train.run(cfg, tr, SEED, seconds, False, "cpu", time.perf_counter(), control=control)


def test_self_play_sound_run_is_correct():
    cfg, sp, _ = tiny()
    out = _selfplay(cfg, sp)
    assert out["counts"]["calls_finished"] >= 1 and out["counts"]["nodes_judged"] > 0
    assert all(v == 0 for v in out["exact"].values())
    assert max(out["gaps"].values()) < 1e-3  # a float32 program against float8's gaps
    assert run.judge(out, _limits("f64-selfplay"))[0]


def test_train_sound_run_is_correct():
    cfg, _, tr = tiny()
    out = _train(cfg, tr)
    assert out["counts"]["steps"] > 0 and out["exact"]["losses_nonfinite"] == 0
    assert max(out["gaps"].values()) < 1e-4
    assert run.judge(out, _limits("f64-train"))[0]


def test_fault_an_answer_altered_where_it_is_produced(monkeypatch):
    """The evaluator's value raised by 0.2 on every fifth board."""
    from connect4_tpu_torch.eval import evaluators

    real = evaluators.make_net_evaluator

    def altered(net, *args, **kwargs):
        evaluate = real(net, *args, **kwargs)

        def wrong(state):
            value, prior = evaluate(state)
            bump = (torch.arange(value.numel(), device=value.device) % 5 == 0).reshape(value.shape)
            return torch.where(bump, (value + 0.2).clamp(max=1.0), value), prior
        return wrong

    monkeypatch.setattr(evaluators, "make_net_evaluator", altered)
    cfg, sp, _ = tiny()
    assert not run.judge(_selfplay(cfg, sp), _limits("f64-selfplay"))[0]


def test_fault_a_move_altered_where_it_is_produced(monkeypatch):
    """The search's chosen move replaced by its least-valued legal move."""
    from connect4_tpu_torch.env.core import legal_moves
    from connect4_tpu_torch.mcts import batched

    real = batched.Search.finish

    def altered(self, ws, generator):
        res = real(self, ws, generator)
        worst = torch.where(legal_moves(ws.root), res.values_policy, 2.0).argmin(-1).to(res.move.dtype)
        return res._replace(move=worst)

    monkeypatch.setattr(batched.Search, "finish", altered)
    cfg, sp, _ = tiny()
    out = _selfplay(cfg, sp, seconds=6.0)
    assert out["counts"]["calls_finished"] >= 1, out["counts"]
    assert out["exact"]["games_wrong"] > 0, out["counts"]
    assert not run.judge(out, _limits("f64-selfplay"))[0]


def _broken_step(monkeypatch, kind):
    from connect4_tpu_torch.training import learner

    real = learner.make_train_step

    def broken(net, optimizer, *args, **kwargs):
        step = real(net, optimizer, *args, **kwargs)

        def unchanged(planes, values, priors, weights=None):
            saved = copy.deepcopy(net.state_dict())
            metrics = step(planes, values, priors)
            net.load_state_dict(saved)
            optimizer.state.clear()
            return metrics

        def half(planes, values, priors, weights=None):
            n = values.shape[0] // 2
            return step(planes[:n], values[:n], priors[:n])
        return {"unchanged": unchanged, "half": half}[kind]

    monkeypatch.setattr(learner, "make_train_step", broken)


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_fault_a_broken_train_step(monkeypatch, kind):
    """A step that returns its state unchanged, and one that leaves half of
    the batch out and takes the mean over the rest."""
    _broken_step(monkeypatch, kind)
    cfg, _, tr = tiny()
    assert not run.judge(_train(cfg, tr), _limits("f64-train"))[0]


@pytest.mark.parametrize("kind, cell", [("selfplay", "f64-selfplay"), ("train", "f64-train")])
def test_the_control_is_not_correct(kind, cell):
    """The reference in float8 put in the program's place, and for training
    the two faults planted in the reference, each fail one of the cell's
    numbers under its limits, while the program's own readings pass."""
    cfg, sp, tr = tiny("bfloat16")
    out = _selfplay(cfg, sp, control=True) if kind == "selfplay" else _train(cfg, tr, control=True)
    limits = _limits(cell)
    assert all(out["gaps"][k] <= v for k, v in limits.items())
    stand_ins = ("fp8",) if kind == "selfplay" else ("fp8", "half", "still")
    for stand_in in stand_ins:
        assert any(out["gaps"][f"{k}_{stand_in}"] > v for k, v in limits.items()), stand_in
