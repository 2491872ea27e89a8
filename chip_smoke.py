"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit; imports nothing of JAX or of the JAX package. Phases, each
fatal on failure:

1. build every CUDA kernel of the main path from the sources in the
   checkout (``nvcc``, printed with its ptxas report);
2. hold each kernel against its plain PyTorch version on the card, on
   legal board positions at the main path's batch shapes (B=4096, a search
   iteration of 512 slots x K=8; B=512, the root batch of every wave and
   the drain phase's leaves; B=261, as the JAX package's tests take it;
   B=64, a drain-phase root batch; B=1), with the packaged gen-161 net
   (F=64, fc 6, res 6, bf16). A block takes 3 boards, so the last block
   holds 1 board at B=4096, 64 and 1, 2 boards at B=512 and 3 at B=261.
   The tolerances are held against the plain version that emulates the
   tensor core's accumulate (and reproduces the kernel bit for bit); the
   errors against the plain version rounded to nearest, an independent
   reference, are printed beside them and held to limits of their own. The tile and block count of each shape
   are printed; at B=4096 and B=261 the kernel's other chain lengths are
   printed beside the shipped one, each against both plain versions summed
   in the same order;
3. time each kernel, its plain version and the cuDNN tower (a yardstick
   only: the port never calls it) at B=4096, B=512 and B=64, beside the
   bound;
4. check the search and self-play on the card against the same code on
   the CPU with the deterministic centre evaluator;
5. drive the main path: a self-play generation through
   ``make_net_evaluator`` + ``make_refill_play_fn`` with gen-161, 512 slots,
   K=8, 64 simulations, 1024 games, noise and sampling on. Every game must
   finish and replay legally on the host board; the kernel launch counts
   are read from this run alone;
6. print the ``kernels`` JSON line, the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable or the
package is not beside this script. A copy of every number goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# stated tolerances, kernel vs plain version (same rounding points and the
# same order of summation; with the tensor core's accumulate emulated the
# plain version has so far equalled the kernel bit for bit)
TOL_VALUE_PRIOR = 2e-2  # max |diff| of value and of prior
TOL_TOWER_MEAN = 2e-3  # mean |diff| of the bf16 tower output
# The plain version rounded to nearest owes nothing to a model of the tensor
# core. It differs from the kernel inside a chain's float32 sum, which flips
# an occasional bf16 rounding that then propagates through the following
# layers. Against it the tower's mean and the prior keep the tolerances
# above; the value head, which amplifies single bf16 flips of the tower
# (its maximum over a batch moves between 0.012 and 0.027 with the draw of
# positions, whatever the chain), is held to the 5e-2 that the port's net is
# held to against the JAX package's (tests/test_torch_net.py).
TOL_VALUE_NEAREST = 5e-2

SMOKE = dict(slots=512, games=1024, simulations=64, parallel_sims=8, seed=0)


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def random_positions(n: int, generator, device):
    """``n`` legal positions reached by uniformly random play of 0..35
    plies (finished games stay as they ended)."""
    import torch

    from connect4_tpu_torch.env.core import initial_state, legal_moves, step

    state = initial_state((n,), device=device)
    plies = torch.randint(0, 36, (n,), generator=generator, device=device)
    for t in range(36):
        legal = legal_moves(state)
        weights = torch.where(legal.any(-1, keepdim=True), legal.float(), 1.0)
        move = torch.multinomial(weights, 1, generator=generator)[:, 0]
        state = step(state, move, t < plies)
    return state


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cudnn_tower(folded, config):
    """The folded tower as cuDNN bf16 convolutions (channels_last), the
    yardstick for ``library_ms``. Not used by the port."""
    import torch
    import torch.nn.functional as F

    from connect4_tpu_torch.models.net import lrelu

    w = {k: v.to(torch.bfloat16) for k, v in folded.items()}

    def run(nhwc):
        x = nhwc.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x = lrelu(F.conv2d(x, w["conv0.weight"], w["conv0.bias"], padding=1))
        for i in range(config.n_residuals):
            y = lrelu(F.conv2d(x, w[f"res.{2 * i}.weight"], w[f"res.{2 * i}.bias"], padding=1))
            y = F.conv2d(y, w[f"res.{2 * i + 1}.weight"], w[f"res.{2 * i + 1}.bias"], padding=1)
            x = lrelu(y + x)
        return x

    return run


def tower_bound(config, boards: int):
    """(bound_ms, bound_by, flops, bytes) of the tower on ``boards`` boards:
    every MAC of the 13 convs on 42 rows per board, and each input, weight
    and output byte moved once."""
    f, c, n = config.filters, config.channels, config.n_residuals
    flops = boards * 42 * 2 * (9 * c * f + 2 * n * 9 * f * f)
    weight_bytes = 2 * (9 * c * f + f + 2 * n * (9 * f * f + f))
    nbytes = boards * 42 * c * 4 + weight_bytes + boards * 42 * f * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def replay_games(out) -> int:
    """Replay every recorded game on the host board: legal moves, the
    recorded pre-move planes, the recorded result. Returns the move count."""
    import numpy as np

    from connect4_tpu_torch.env.host_board import HostBoard

    moves, planes = out.moves.cpu().numpy(), out.planes.cpu().numpy()
    length, result = out.length.cpu().numpy(), out.result.cpu().numpy()
    mask = out.mask.cpu().numpy()
    total = 0
    for g in range(moves.shape[0]):
        if not np.array_equal(mask[g], np.arange(42) < length[g]):
            fail(f"game {g}: ply mask is not a prefix")
        board = HostBoard()
        for t in range(int(length[g])):
            if not np.array_equal(planes[g, t], board.to_planes().astype(np.uint8)):
                fail(f"game {g} ply {t}: recorded planes differ from the replay")
            mv = int(moves[g, t])
            if mv not in board.valid_moves:
                fail(f"game {g} ply {t}: illegal move {mv}")
            board.make_move(mv)
        if board.result is None or board.result.code != int(result[g]):
            fail(f"game {g}: replay ends {board.result}, recorded result {int(result[g])}")
        total += int(length[g])
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from connect4_tpu_torch import build
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
    from connect4_tpu_torch.mcts.batched import make_search_fn
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.models.net import fold_bn_params
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.training.self_play import make_refill_play_fn, training_arrays
    from connect4_tpu_torch.utils import make_generator

    # float32 references on the card in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {report['device']}")

    # --- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    tower._library()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] tower kernel ready in {report['build_s']:.1f} s")
    log(build.BUILD_LOGS.get(tower.SOURCE, "(already built)").strip())

    net = load_example_net(device=dev)
    config = net.config
    folded = fold_bn_params(net)
    packed = tower.pack_weights(config, folded)
    gen = make_generator(SMOKE["seed"], dev)

    # --- 2. kernel vs plain -------------------------------------------------
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {b: tower.tile_plan(b) for b in (4096, 512, 261, 64, 1)}
    for b, (tb, blocks) in plans.items():
        log(f"[tile] B={b}: {tb} boards a block, {blocks} blocks on {n_sms} SMs (chain={tower.CHAIN})")
    report["tiles"] = plans

    def compare(x2d, chain):
        """Error sets of the kernel at ``chain`` against the plain version
        summed in the same order: ``model`` with the tensor core's
        accumulate emulated, ``nearest`` rounded to nearest."""
        with torch.no_grad():
            tk = tower.run_tower(packed, x2d, chain=chain)
            torch.cuda.synchronize()
            vk, pk = tower.heads(packed, tk)
            sets = {"finite": bool(torch.isfinite(tk.float()).all())}
            for name, tensor_core in (("model", True), ("nearest", False)):
                tp = tower.tower_plain(packed, x2d, chain or tower.CHAIN, tensor_core)
                vp, pp = tower.heads(packed, tp)
                d = (tk.float() - tp.float()).abs()
                sets[name] = {
                    "differ": int((tk != tp).sum()), "tower_max": d.max().item(), "tower_mean": d.mean().item(),
                    "value_max": (vk - vp).abs().max().item(),
                    "prior_max": (pk - pp).abs().max().item(),
                }
        return sets

    def show(sets):
        return "; ".join(
            f"vs {name}: {e['differ']} differ, |tower| max {e['tower_max']:.6g} mean {e['tower_mean']:.3g}"
            f" |value| max {e['value_max']:.6g} |prior| max {e['prior_max']:.6g}"
            for name, e in ((n, sets[n]) for n in ("model", "nearest")))

    errs, chain_errs = {}, {}
    for b in (4096, 512, 261, 64, 1):
        nhwc = to_planes(random_positions(b, gen, dev)).permute(0, 2, 3, 1)
        x2d = nhwc.reshape(b * 42, config.channels).float().contiguous()
        e = errs[b] = compare(x2d, None)  # the shipped kernel, as the main path calls it
        log(f"[compare] tower B={b}: {show(e)}")
        if not e["finite"]:
            fail(f"kernel output not finite at B={b}")
        m, n = e["model"], e["nearest"]
        if max(m["value_max"], m["prior_max"]) > TOL_VALUE_PRIOR or m["tower_mean"] > TOL_TOWER_MEAN:
            fail(f"kernel disagrees with the plain tower at B={b}: {m} "
                 f"(tolerance value/prior {TOL_VALUE_PRIOR}, tower mean {TOL_TOWER_MEAN})")
        if (n["value_max"] > TOL_VALUE_NEAREST or n["prior_max"] > TOL_VALUE_PRIOR
                or n["tower_mean"] > TOL_TOWER_MEAN):
            fail(f"kernel disagrees with the plain tower rounded to nearest at B={b}: {n} "
                 f"(tolerance value {TOL_VALUE_NEAREST}, prior {TOL_VALUE_PRIOR}, "
                 f"tower mean {TOL_TOWER_MEAN})")
        if b in (4096, 261):
            # the chain lengths that were not shipped, for the record only
            for chain in tower.CHAINS:
                ce = e if chain == tower.CHAIN else compare(x2d, chain)
                chain_errs[f"{chain}@{b}"] = ce
                log(f"[compare] chain={chain}{' (shipped)' if chain == tower.CHAIN else ''} B={b}: {show(ce)}")
    report["compare"] = errs
    report["compare_chains"] = chain_errs

    # --- 3. times -----------------------------------------------------------
    lib_tower = cudnn_tower(folded, config)
    times = {}
    with torch.no_grad():
        for b in (4096, 512, 64):
            x2d = (to_planes(random_positions(b, gen, dev)).permute(0, 2, 3, 1)
                   .reshape(b * 42, config.channels).float().contiguous())
            nhwc = x2d.reshape(b, 6, 7, config.channels)
            bound_ms, bound_by, flops, nbytes = tower_bound(config, b)
            t = {
                "ms": timed_ms(lambda: tower.run_tower(packed, x2d)),
                "plain_ms": timed_ms(lambda: tower.tower_plain(packed, x2d), iters=5),
                "plain_model_ms": timed_ms(
                    lambda: tower.tower_plain(packed, x2d, tensor_core=True), iters=2, warmup=1),
                "library_ms": timed_ms(lambda: lib_tower(nhwc)),
                "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            }
            t["ms_again"] = timed_ms(lambda: tower.run_tower(packed, x2d))
            times[b] = t
            log(f"[time] tower B={b}: kernel {t['ms']:.4f} ms (again {t['ms_again']:.4f}), "
                f"plain {t['plain_ms']:.4f} ms (tensor core emulated {t['plain_model_ms']:.1f}), cuDNN {t['library_ms']:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB), "
                f"{flops / t['ms'] / 1e9:.1f} TFLOP/s")
    report["times"] = times

    # --- 4. search and self-play on the card against the CPU -----------------
    cpu = torch.device("cpu")
    for k in (1, 8):
        cfg = MCTSConfig(simulations=48, parallel_sims=k)
        roots = random_positions(64, make_generator(1, cpu), cpu)
        ongoing = roots.result == 0
        r_cpu = make_search_fn(centre_evaluator_batched, cfg)(roots, make_generator(0, cpu), ongoing)
        r_gpu = make_search_fn(centre_evaluator_batched, cfg)(
            roots.map(lambda x: x.to(dev)), make_generator(0, dev), ongoing.to(dev))
        sd = (r_cpu.tree.stats - r_gpu.tree.stats.cpu()).abs().max().item()
        same = bool((r_cpu.move == r_gpu.move.cpu())[ongoing].all())
        log(f"[check] search K={k} on 64 positions, card vs CPU: moves equal {same}, |stats| max {sd:.3g}")
        if not same or sd > 1e-4:
            fail(f"search on the card differs from the CPU (K={k})")
    cfg = MCTSConfig(simulations=16, parallel_sims=8)
    outs = [
        make_refill_play_fn(centre_evaluator_batched, cfg, 8, 20, device=d)(make_generator(0, d))
        for d in (cpu, dev)
    ]
    same = all(bool((a.cpu() == b.cpu()).all()) for a, b in zip(outs[0], outs[1]) if a.dtype != torch.float32)
    pd = (outs[0].policies - outs[1].policies.cpu()).abs().max().item()
    log(f"[check] refill self-play 20 games, card vs CPU: records equal {same}, |policy| max {pd:.3g}")
    if not same or pd > 1e-5:
        fail("refill self-play on the card differs from the CPU")

    # --- 5. the main path ----------------------------------------------------
    search_cfg = MCTSConfig(
        simulations=SMOKE["simulations"], root_dirichlet_alpha=0.3,
        root_exploration_fraction=0.25, num_sampling_moves=6,
        parallel_sims=SMOKE["parallel_sims"],
    )
    evaluator = make_net_evaluator(net)
    play = make_refill_play_fn(evaluator, search_cfg, SMOKE["slots"], SMOKE["games"], device=dev)
    waves = []
    torch.cuda.synchronize()
    tower.run_tower.launches = 0
    t0 = time.perf_counter()
    out = play(make_generator(SMOKE["seed"], dev), progress=lambda w, n: waves.append(n))
    torch.cuda.synchronize()
    t_play = time.perf_counter() - t0
    launches = tower.run_tower.launches
    planes, values, policies = training_arrays(out)
    n_moves = replay_games(out)
    if int(out.mask.sum()) != n_moves or not (out.result.cpu() != 0).all():
        fail("not every game finished")
    pol_sums = out.policies.sum(-1)[out.mask]
    if not torch.allclose(pol_sums, torch.ones_like(pol_sums), atol=1e-5):
        fail("policy targets are not distributions")
    if planes.shape != (2 * n_moves, 3, 6, 7) or values.shape != (2 * n_moves,):
        fail(f"training_arrays shapes {planes.shape} {values.shape}")
    if launches == 0:
        fail("the main path never launched the tower kernel")
    res = out.result.cpu()
    selfplay = {
        **SMOKE, "seconds": t_play, "moves": n_moves, "waves": len(waves),
        "moves_per_s": n_moves / t_play, "sims_per_s": n_moves * SMOKE["simulations"] / t_play,
        "tower_launches": launches,
        "o_wins": int((res == 1).sum()), "x_wins": int((res == 2).sum()), "draws": int((res == 3).sum()),
        "positions": int(values.shape[0]),
    }
    report["selfplay"] = selfplay
    log(f"[selfplay] {SMOKE['games']} games ({selfplay['o_wins']} o / {selfplay['draws']} draw / "
        f"{selfplay['x_wins']} x), {n_moves} moves in {t_play:.2f} s over {len(waves)} waves: "
        f"{selfplay['moves_per_s']:.1f} moves/s, {selfplay['sims_per_s']:.0f} sims/s, "
        f"tower kernel launches {launches}; all games replay on the host board")

    # --- 6. result lines -----------------------------------------------------
    t4096 = times[4096]
    kernels = [{
        "name": "tower",
        "route": "cuda",
        "source": "connect4_tpu_torch/models/csrc/tower.cu",
        "replaces": "connect4_tpu/models/pallas_net.py:153",
        "launches": launches,
        "max_abs_err": errs[4096]["model"]["tower_max"],
        "ms": t4096["ms"],
        "plain_ms": t4096["plain_ms"],
        "bound_ms": t4096["bound_ms"],
        "bound_by": t4096["bound_by"],
        "library_ms": t4096["library_ms"],
    }]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    report["nvidia_smi"] = smi
    report["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
