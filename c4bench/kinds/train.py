"""Training traffic: the learner at a full replay window, timed.

Set-up makes the configuration's weights and a replay window of
``window_positions`` positions on the card from the seed (``make_window``),
builds the program's train step (``make_train_step`` on the program's net
and its SGD optimizer, ``make_optimizer``) and drives it through its first
three steps, the warm-up, by the window's own call (``train_epochs``) and
feed: the first rows of a seeded permutation of the window, 4,096 a step,
each batch's rows in the order of their losses under the first weights
(so that a step that leaves rows out moves its loss). It
keeps the optimizer's momentum after the first step and the weights after
the third. The window goes on from the fourth step through the permutation,
``chunk_steps`` steps a call of ``train_epochs`` (a fresh permutation each
time the window's rows are used up, as an epoch), and closes at the first
chunk boundary after ``seconds``.

Then the card's time a step (``card_ms_per_step``): ``CARD_STEPS`` more
steps, one at a time, each queued by the host while a spin kernel holds the
card, and timed by CUDA events around the step alone, so that the card runs
it without waiting for the host. Where the host paces the window (the card
idle most of it), this is what the step costs the card.

Judged once the window has closed, the memory peak has been read and the
program's state is freed: the first three steps, which the reference
follows from the same weights on the same rows in float32 (``sgd_steps``):
each step's loss, the first gradient as the optimizer took it, and each
leaf's change over the three steps; and that every loss of the window is
finite.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from c4bench import builders
from c4bench import trace as tr
from c4bench.kinds import common
from c4bench.reference import board as B
from c4bench.reference import net as ref_net

# leaves whose reference gradient is below this share of the median leaf's
# gradient norm move by rounding alone (a conv's bias under BatchNorm)
DEAD_LEAF = 1e-3
WARM_STEPS = (1, 2)  # the first three steps, in the calls that take them
# the compared numbers (``_numbers``)
GAPS = ("loss_gap", "grad_gap", "change_gap")
# the numbers whose ratios to float8's make ``precision_vs_fp8``
PRECISION = ("grad_gap", "change_gap", "grad_median", "change_median")


# ``card_ms_per_step``: the steps timed, and the spin (clock cycles of the
# card) that holds the card while the host queues one; doubled after a step
# whose start the card reached before the host had queued all of it
CARD_STEPS = 24
SPIN_CYCLES = 3 * 10**8


# the shares of value targets 1, 0.5 and 0 in the replay window
VALUE_SHARES = (0.45, 0.1, 0.45)


@torch.no_grad()
def make_window(n: int, seed: int, device):
    """``n`` positions (``n`` even) as the replay window stores them: uint8
    planes [n, 3, 6, 7], float32 value targets [n] and policy targets [n, 7].
    The first half are the running positions of random games, every move
    uniform over the legal ones, in a seeded order; the second half their
    mirror images, with the mirrored policies. A value target is 1, 0.5 or 0
    with the probabilities ``VALUE_SHARES``; a policy target is a normalised
    draw of exponentials over the legal moves."""
    g = common.generator(seed, device, "window")
    half = n // 2
    games = half // 12 + 64  # random games run about 20 plies
    boards = B.empty(games, device)
    over = torch.zeros(games, dtype=torch.bool, device=device)
    kept = []
    for _ in range(B.CELLS):
        live = ~over
        kept.append(boards.take(live.nonzero()[:, 0]))
        legal = B.legal(boards).float()
        col = torch.multinomial(legal + (legal.sum(1, keepdim=True) == 0).float(), 1, generator=g)[:, 0]
        boards, res = B.play(boards, col, live)
        over |= res != B.ONGOING
    pool = B.Boards(*(torch.cat(xs) for xs in zip(*kept)))
    if pool.age.shape[0] < half:
        raise RuntimeError(f"{pool.age.shape[0]} positions made, {half} asked for")
    pick = torch.randperm(pool.age.shape[0], generator=g, device=device)[:half]
    pos = pool.take(pick)
    planes = B.planes(pos).to(torch.uint8)
    legal = B.legal(pos)
    w = torch.empty((half, B.COLS), device=device).exponential_(1.0, generator=g) * legal
    policy = w / w.sum(1, keepdim=True)
    probs = torch.tensor(VALUE_SHARES, device=device)
    value = torch.tensor((1.0, 0.5, 0.0), device=device)[torch.multinomial(probs, half, True, generator=g)]
    return (torch.cat([planes, torch.flip(planes, dims=(3,))]),
            torch.cat([value, value]),
            torch.cat([policy, torch.flip(policy, dims=(1,))]))


def _model_config(cfg: dict):
    from connect4_tpu_torch.config import ModelConfig

    t = cfg["train"]
    return ModelConfig(net_config=builders.find(cfg["net"]).net_config(cfg["net"]),
                       weight_decay=t["weight_decay"], momentum=t["momentum"], initial_lr=t["lr"],
                       batch_size=t["batch_size"], n_training_epochs=t["n_training_epochs"])


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
        control: bool = False) -> Dict:
    """One run: set-up, the window, then the judgement. ``control`` also
    reads, on the same three steps, the numbers of the reference in float8
    in the program's place and of two faults planted in the reference."""
    from connect4_tpu_torch.training.learner import (
        TrainState, make_optimizer, make_train_step, set_learning_rate, train_epochs,
    )

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t = cfg["train"]
    batch = t["batch_size"]
    clock = common.SetupClock(dev)
    clock.parts["import"] = time.perf_counter() - t_start

    weights = common.make_weights(cfg["net"], seed, dev)
    clock.mark("weights")
    data = make_window(traffic["window_positions"], seed, dev)
    clock.mark("data")
    n = data[1].shape[0]
    perm_gen = common.generator(seed, dev, "order")
    order = torch.randperm(n, generator=perm_gen, device=dev)
    model_config = _model_config(cfg)
    net = common.program_net(cfg["net"], weights, dev)
    state = TrainState(net, make_optimizer(model_config, net))
    set_learning_rate(state.optimizer, t["lr"])
    step = make_train_step(state.net, state.optimizer)
    clock.mark("program")

    pos = 0

    def chunk(steps: int) -> torch.Tensor:
        """``steps`` steps through the next rows of the permutation, by one
        call of ``train_epochs``; a fresh permutation once it is used up."""
        nonlocal pos, order
        if pos + steps * batch > n:
            order = torch.randperm(n, generator=perm_gen, device=dev)
            pos = 0
        rows = order[pos: pos + steps * batch]
        pos += steps * batch
        arrays = tuple(a.index_select(0, rows) for a in data)
        return train_epochs(step, arrays, batch, 1, epoch_orders=[torch.arange(steps * batch, device=dev)])

    # the first three batches, each in the order of its rows' losses under
    # the first weights (the reference's), so that a step that leaves part
    # of its batch out moves its loss
    if cuda:
        torch.cuda._sleep(1000)  # the spin kernel of ``card_ms_per_step``, loaded
    ref_net.full_float32()
    with torch.no_grad():
        for i in range(sum(WARM_STEPS)):
            rows = order[i * batch:(i + 1) * batch]
            key = ref_net.sample_losses(weights, cfg["net"], *(a.index_select(0, rows).float() for a in data))
            order[i * batch:(i + 1) * batch] = rows[torch.argsort(key)]
    first_rows = order[: sum(WARM_STEPS) * batch].clone()
    losses = [chunk(WARM_STEPS[0])]
    params = dict(state.net.named_parameters())
    # a step that left no momentum took no gradient: read it as zero
    momentum1 = {k: state.optimizer.state[p].get("momentum_buffer", torch.zeros_like(p)).detach().clone()
                 for k, p in params.items()}
    losses.append(chunk(WARM_STEPS[1]))
    after3 = {k: p.detach().clone() for k, p in params.items()}
    warm_losses = torch.cat(losses)
    clock.mark("warm-up")

    # ---- the window -------------------------------------------------------
    segment = tr.Segment(dev) if traced else None
    seg = {"steps": 0}
    window_losses, steps, prev = [], 0, None
    if cuda:
        torch.cuda.synchronize(dev)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    while True:
        now = time.perf_counter() - t_window
        if segment is not None and not seg["steps"] and now >= seconds * traffic["trace_from"]:
            segment.start()
            for _ in range(traffic["trace_steps"] // traffic["chunk_steps"]):
                window_losses.append(chunk(traffic["chunk_steps"]))
                steps += traffic["chunk_steps"]
                seg["steps"] += traffic["chunk_steps"]
            seg["events"] = segment.stop()
            prev = None
        window_losses.append(chunk(traffic["chunk_steps"]))
        steps += traffic["chunk_steps"]
        done = torch.cuda.Event() if cuda else None
        if cuda:
            done.record()
        if prev is not None:
            prev.synchronize()  # the chunk before this one is done: the host stays one ahead
        prev = done
        if time.perf_counter() - t_window >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_window
    if traced and not seg["steps"]:
        raise RuntimeError("the window closed before its traced steps began")
    card = card_ms_per_step(chunk, window_losses) if cuda else None
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    nonfinite = int((~torch.isfinite(torch.cat(window_losses))).sum())
    warm_losses = warm_losses.tolist()
    batches = [tuple(a.index_select(0, first_rows[i * batch:(i + 1) * batch]) for a in data)
               for i in range(sum(WARM_STEPS))]
    del state, step, net, params, data, order, window_losses
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference follows the first three steps ----------------------
    ref_net.full_float32()
    hp = (t["lr"], t["momentum"], t["weight_decay"])
    ref = ref_net.sgd_steps(weights, cfg["net"], batches, *hp)
    low = ref_net.sgd_steps(weights, cfg["net"], batches, *hp, precision="fp8")
    low_diag = _gaps((low[0], low[1], low[3]), ref, weights)
    diag = _gaps((warm_losses, momentum1, after3), ref, weights)
    gaps = _numbers(diag, low_diag)
    diag.update({f"{k}_fp8": v for k, v in low_diag.items()})
    if control:  # float8 in the program's place, and two faults, for the record
        gaps.update({f"{k}_fp8": v for k, v in _numbers(low_diag, low_diag).items()})
        half = [tuple(a[: batch // 2] for a in b) for b in batches]  # half of each batch left out
        r = ref_net.sgd_steps(weights, cfg["net"], half, *hp)
        gaps.update({f"{k}_half": v for k, v in _numbers(_gaps((r[0], r[1], r[3]), ref, weights), low_diag).items()})
        moved = ref_net.trainable(cfg["net"])
        trainable = {k: v for k, v in weights.items() if k in moved}
        with torch.no_grad():  # the state left unchanged: every loss at the first weights
            still = [float(ref_net.loss(weights, cfg["net"], *(a.float() for a in b))) for b in batches]
        zero = {k: torch.zeros_like(v) for k, v in trainable.items()}
        gaps.update({f"{k}_still": v for k, v in _numbers(_gaps((still, zero, trainable), ref, weights),
                                                           low_diag).items()})
    steps_total = steps
    out = {
        "setup_s": setup_s,
        "setup_parts": clock.parts,
        "window_s": window_s,
        "e2e": {"train_positions_per_s": steps_total * batch / window_s},
        "memory_peak_bytes": memory_peak,
        "exact": {"losses_nonfinite": nonfinite},
        "gaps": gaps,
        "diag": diag,
        "attempted": sum(WARM_STEPS) + steps_total + (CARD_STEPS if cuda else 0),
        "counts": {"steps": steps_total, "positions": steps_total * batch, "window_rows": n,
                   "losses": warm_losses, "reference_losses": ref[0]},
    }
    if card is not None:
        out["e2e"]["train_card_ms_per_step"] = card.pop("ms_per_step")
        out["counts"]["card_steps"] = card
    if traced:
        summary = tr.summary(seg["events"])
        summary.update(steps=seg["steps"], positions=seg["steps"] * batch, net=cfg["net"],
                       wall_positions_per_s=steps_total * batch / window_s)
        out["trace"] = summary
    return out


def card_ms_per_step(chunk, losses: list) -> Dict:
    """The card's milliseconds a step over ``CARD_STEPS`` steps, each
    queued by the host while a spin kernel holds the card and timed by CUDA
    events around that step alone (``ms_per_step``, the sum over the steps
    over their number). A step whose start event the card had reached before
    the host had queued all of it may have waited for the host: it is not
    timed (``starved``) and the spin doubles. ``spin_ms``: the last spin as
    the card ran it. Each step's loss goes to ``losses``."""
    spin, timed, starved = SPIN_CYCLES, [], 0
    while len(timed) < CARD_STEPS:
        if starved > CARD_STEPS:
            raise RuntimeError(f"{starved} steps ran before the host had queued them, "
                               f"{len(timed)} of {CARD_STEPS} timed")
        held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        held.record()
        torch.cuda._sleep(spin)
        start.record()
        losses.append(chunk(1))
        end.record()
        if start.query():
            starved += 1
            spin *= 2
        else:
            timed.append((held, start, end))
    torch.cuda.synchronize()
    total = sum(a.elapsed_time(b) for _, a, b in timed)
    return {"ms_per_step": total / len(timed), "starved": starved,
            "spin_ms": timed[-1][0].elapsed_time(timed[-1][1])}


def _numbers(diag: Dict, low: Dict) -> Dict[str, float]:
    """The compared numbers: ``GAPS`` as they are, and ``precision_vs_fp8``,
    the geometric mean over ``PRECISION`` of each gap over the same gap of
    the float8 reference's three steps (``low``). A random net's
    sensitivity to rounding changes by an order of magnitude from seed to
    seed, and the program's gaps and float8's move together; their ratio
    does not. A bf16 program reads about a tenth, float8 in its place 1."""
    ratios = [math.log(max(diag[k], 1e-30) / max(low[k], 1e-30)) for k in PRECISION]
    return {**{k: diag[k] for k in GAPS}, "precision_vs_fp8": math.exp(sum(ratios) / len(ratios))}


def _gaps(prog, ref, w0) -> Dict[str, float]:
    """The numbers of ``prog`` = (the three losses, the first momentum, the
    leaves after three steps) against the reference's ``sgd_steps``: the
    widest relative loss gap of the three steps and the first step's; and,
    by the worst leaf and by the median leaf, the gap of the first
    gradient's norm (as the optimizer took it) and of the norm of the
    change over the three steps, each against the reference's norm of that
    leaf or of the median leaf, whichever is larger. Leaves the reference's
    gradient leaves at rounding are left out (``DEAD_LEAF``)."""
    losses, first, after = prog
    r_losses, r_first, r_grad, r_after = ref
    norms = {k: float(v.double().norm()) for k, v in r_grad.items()}
    median = float(torch.tensor(sorted(norms.values()), dtype=torch.float64).median())
    leaves = [k for k, v in norms.items() if v >= DEAD_LEAF * median]

    def per_leaf(prog_norm, ref_norm) -> Dict[str, float]:
        floor = float(torch.tensor([ref_norm[k] for k in leaves], dtype=torch.float64).median())
        return {k: abs(prog_norm[k] - ref_norm[k]) / max(ref_norm[k], floor) for k in leaves}

    g = per_leaf({k: float(first[k].double().norm()) for k in leaves},
                 {k: float(r_first[k].double().norm()) for k in leaves})
    c = per_leaf({k: float((after[k].double() - w0[k].double()).norm()) for k in leaves},
                 {k: float((r_after[k].double() - w0[k].double()).norm()) for k in leaves})
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]

    def med(d):
        return float(torch.tensor(list(d.values()), dtype=torch.float64).median())

    return {"loss_gap": max(rel), "loss_gap_first": rel[0],
            "grad_gap": max(g.values()), "change_gap": max(c.values()),
            "grad_median": med(g), "change_median": med(c),
            "grad_worst": max(g, key=g.get), "change_worst": max(c, key=c.get), "leaves": len(leaves)}
