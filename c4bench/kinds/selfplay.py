"""Self-play traffic: the refill pool of a training generation, timed.

Set-up makes the configuration's weights from the mix's ``weights_seed``
(one net for every run: how long its games last sets how many drains a
window holds, so a net of each seed's own would change the work; the
run's seed draws each call's noise and openings), builds the
program's net and evaluator (``make_net_evaluator``, which folds and packs
them) and its refill pool (``make_refill_play_fn``) with the training search
(noise and opening samples on), then warms the pool's search at every width
the pool narrows to: one segment of a search at each, which builds the
kernels and captures the width's CUDA graph.

The window plays calls of ``games_per_call`` games, each with a generator of
its own from the seed. Moves are counted at each wave through the pool's
``progress`` callback, which the pool calls once it has read the previous
wave's live count back from the card: at that point every wave before the
current one is done. The window closes at the first such callback after
``seconds`` (the callback that ends a drained call lets it return first),
and the call in flight is ended there (the callback raises); its finished
games are not judged.

Judged once the window has closed, the card's memory peak has been read and
the program's state is freed: every game of every call that finished in the
window (``judge_records``), and a seeded sample of the rows of the last
search at each pool width the window ran (``judge_trees``, on the trees the
program's search keeps in its workspaces).
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from c4bench import trace as tr
from c4bench.kinds import common
from c4bench.reference import board as B
from c4bench.reference import net as ref_net
from c4bench.reference import selfplay_judge as judge


class _WindowClosed(Exception):
    pass


def _search_config(cfg: dict):
    from connect4_tpu_torch.config import MCTSConfig

    s = cfg["search"]
    return MCTSConfig(
        simulations=s["simulations"], pb_c_base=s["pb_c_base"], pb_c_init=s["pb_c_init"],
        root_dirichlet_alpha=s["root_dirichlet_alpha"],
        root_exploration_fraction=s["root_exploration_fraction"],
        num_sampling_moves=s["num_sampling_moves"], parallel_sims=s["parallel_sims"],
    )


def _widths(slots: int):
    """The pool widths a draining pool runs at: halving down to 64."""
    out = [slots]
    while out[-1] // 2 >= 64:
        out.append(out[-1] // 2)
    return out


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
        control: bool = False) -> Dict:
    """One run: set-up, the window, then the judgement. ``control`` also
    reads the control's gaps (the reference in float8 in the program's
    place) on the same trees."""
    from connect4_tpu_torch.env.core import initial_state
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.training.self_play import make_refill_play_fn

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    s = cfg["search"]
    clock = common.SetupClock(dev)
    clock.parts["import"] = time.perf_counter() - t_start

    # one net for every seed: the net sets how long games last, so a net of
    # the seed's own would change the work; the seed orders the games
    weights = common.make_weights(cfg["net"], traffic["weights_seed"], dev)
    net = common.program_net(cfg["net"], weights, dev)
    evaluator = make_net_evaluator(net)
    clock.mark("weights")
    evaluator(initial_state((1,), device=dev))  # the tower kernel's build or load
    clock.mark("kernels")

    slots, games = s["slots"], traffic["games_per_call"]
    play = make_refill_play_fn(evaluator, _search_config(cfg), slots, games, s["sims_per_call"], device=dev)
    search = play.search
    warm = common.generator(seed, dev, "warm")
    for width in _widths(slots):
        ws = search.init(initial_state((width,), device=dev), warm)
        search.segment(ws)
        search.finish(ws, warm)
    clock.mark("warm-up")
    captured = sum(sum(ws.graphs.capture_ms.values()) for ws in search.workspaces.values()
                   if ws.graphs is not None) / 1e3
    clock.parts["captures"] = captured
    clock.parts["warm-up"] -= captured

    # ---- the window -------------------------------------------------------
    st = {"moves": 0, "waves": 0, "closed": None, "segment": None, "seg_moves": 0, "seg_waves": 0}
    segment = tr.Segment(dev) if traced else None
    trace_from = seconds * traffic["trace_from"]

    def progress(wave, live):
        # live = the moves of the wave just enqueued; every wave before it is done
        now = time.perf_counter() - t_window
        st["moves"] += st["pending"]
        st["waves"] += 1
        if st["segment"] == "on":
            st["seg_moves"] += live
            st["seg_waves"] += 1
            if st["seg_waves"] >= traffic["trace_waves"]:
                st["events"] = segment.stop()  # waits for the wave just enqueued
                st["segment"] = "done"
        elif segment is not None and st["segment"] is None and now >= trace_from:
            segment.start()  # waits for the wave just enqueued: traced from the next
            st["segment"] = "on"
        if now >= seconds and live:  # a call that has just drained ends first
            st["closed"] = now
            raise _WindowClosed
        st["pending"] = live

    finished = []
    if cuda:
        torch.cuda.synchronize(dev)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    call = 0
    while st["closed"] is None:
        st["pending"] = slots  # the first wave of a call plays every slot
        if st["segment"] == "on":
            st["seg_moves"] += slots
            st["seg_waves"] += 1
        counted = st["moves"]
        try:
            out = play(common.generator(seed, dev, "call", call), progress)
        except _WindowClosed:
            break
        st["moves"] += st["pending"]  # the last wave's live count is 0
        finished.append((out, st["moves"] - counted))
        call += 1
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = st["closed"]
    if traced and st["segment"] != "done":
        raise RuntimeError(f"the window closed before the {traffic['trace_waves']} traced waves ended")
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # ---- what is judged, then the program's state is freed -----------------
    g = torch.Generator().manual_seed(common.derive_seed(seed, "check"))
    trees = []
    for (_, width), ws in sorted(search.workspaces.items(), key=lambda kv: -kv[0][1]):
        if not bool(ws.root.age.any()):
            continue  # this width's last search was the warm-up's, from empty boards
        live = ws.active.nonzero()[:, 0].cpu()
        if not len(live):
            continue  # the all-idle wave that ends a call
        pick = live[torch.randperm(len(live), generator=g)[: traffic["check_rows"]]].to(dev)
        tree = ws.tree
        pieces = ws.root.pieces[pick]
        grid = (pieces[:, 0].to(torch.int8) + 2 * pieces[:, 1].to(torch.int8))
        height = (grid != 0).sum(1).long()
        trees.append(judge.Trees(
            tree.parent[pick, :-1].clone(), tree.children_base[pick, :-1].clone(),
            tree.stats[pick, :-1].clone(), tree.prior[pick, :-1].clone(),
            tree.evaluated[pick, :-1].clone(), tree.next_free[pick].clone(),
            B.Boards(grid, height, height.sum(1)),
        ))
    records = [(tuple(x for x in out), n) for out, n in finished]
    del play, search, evaluator, net, finished
    if cuda:
        torch.cuda.empty_cache()

    ref_net.full_float32()
    checks = {"moves_miscounted": 0, "games_wrong": 0, "tree_errors": 0}
    games_judged = plies = nodes = 0
    for (planes, moves, values, policies, mask, result, length), counted in records:
        r = judge.judge_records(planes, moves, values, policies, mask, result, length, s["num_sampling_moves"])
        checks["games_wrong"] += r["games_wrong"]
        checks["moves_miscounted"] += abs(int(mask.sum()) - counted)
        games_judged += r["games"]
        plies += r["plies"]
    if not trees:
        raise RuntimeError("no search of the window was left to judge")
    judged = [judge.judge_trees(t, weights, cfg["net"], s["parallel_sims"], s["simulations"]) for t in trees]
    for r in judged:
        checks["tree_errors"] += r["tree_errors"]
        nodes += r["nodes_checked"]
    pooled = {k: torch.cat([r[k] for r in judged]) for k in judged[0] if torch.is_tensor(judged[0][k])}
    gaps, diag = judge.precision_gaps(pooled)
    if control:  # the float8 evaluations in the program's place
        low, _ = judge.precision_gaps(dict(pooled, value=pooled["value_fp8"], prior=pooled["prior_fp8"]))
        gaps.update({f"{k}_fp8": v for k, v in low.items()})

    out = {
        "setup_s": setup_s,
        "setup_parts": clock.parts,
        "window_s": window_s,
        "e2e": {"selfplay_moves_per_s": st["moves"] / window_s},
        "memory_peak_bytes": memory_peak,
        "exact": checks,
        "gaps": gaps,
        "diag": diag,
        "attempted": games_judged + nodes,
        "counts": {"moves": st["moves"], "waves": st["waves"], "calls_finished": call,
                   "games_judged": games_judged, "plies_judged": plies, "nodes_judged": nodes,
                   "trees_judged": len(trees)},
    }
    if traced:
        seg = tr.summary(st["events"])
        evals = st["seg_moves"] * (1 + s["simulations"])
        seg.update(moves=st["seg_moves"], waves=st["seg_waves"], evaluations=evals,
                   iterations=st["seg_waves"] * s["simulations"] // s["parallel_sims"],
                   net=cfg["net"], search=s)
        out["trace"] = seg
    return out
