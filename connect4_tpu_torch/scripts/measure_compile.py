"""Break a fresh process's cold costs into phases, up to its first useful work.

The counterpart of the JAX package's ``scripts/measure_compile.py``. That
script times trace, lowering and XLA compilation of the search programs
(``_root_init``, one ``_run_sims`` segment of ``--sims-per-call``
simulations, ``_finish``) at ``--slots`` rows, ``--sims`` simulations and
``--parallel-sims`` walkers with a fresh F=64 / fc 6 / res 6 bf16 net, then
one whole refill generation of 4 x ``--slots`` games. The port compiles
its kernels and, on the card, captures the CUDA graph of a search
iteration once a shape (``mcts.batched.Search``), so this tool times what
a fresh process pays instead, phase by phase:

1. the interpreter's start and ``import torch``;
2. the CUDA context (the first allocation on the card);
3. importing the port's modules;
4. a cold ``nvcc`` build of the kernels (the tower's
   ``models/csrc/tower.cu`` and the descent's ``mcts/csrc/descent.cu``,
   one after the other) into a throwaway directory, so ``build/kernels/``
   is neither read nor written, with the ptxas report;
5. loading those libraries with ``ctypes``; the programs below launch
   them;
6. the first call of each of the three parts of a search
   (``Search.init``, ``segment``, ``finish``) against a warm call (the
   first launches load the kernels' modules, initialise cuBLAS for the
   heads and fill PyTorch's caching allocator; the first segment also
   warms and captures the iteration's graph, whose capture time is
   reported for the shape);
7. the whole refill generation, its first call against a second one,
   with the capture times of every pool width it met (its search's
   workspaces).

All of it runs in a child process that this tool spawns, so the phases
are cold whoever calls the tool: the child checks that ``torch`` was not
loaded when it started, and reports its numbers and its tower kernel
launches by batch back to this process, which prints them. So this module
imports nothing of torch until the child has timed it. With
``--device cpu`` phases 2, 4 and 5 do not run (``null``, with a line that
says the caller asked for the CPU). The JAX script's
``MEASURE_CLEAR_CACHE`` has no counterpart: the port keeps no compilation
cache, and the build here is always cold.

    python -m connect4_tpu_torch.scripts.measure_compile [--slots 256] [--sims 800] \\
        [--parallel-sims 8] [--sims-per-call 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# what the child runs: its clock starts before anything is imported
CHILD_CODE = (
    "import sys, time; t0 = time.time(); "
    "from connect4_tpu_torch.scripts.measure_compile import child; child(sys.argv[1], t0)"
)
PROGRAMS = ("root_init", "segment", "finish")
CHILD_TIMEOUT_S = 3000  # a child that hangs fails the tool instead of holding it
CPU_REASON = "not run: the caller asked for the CPU (no card context, no kernel build or load)"


def measure(slots: int = 256, sims: int = 800, parallel_sims: int = 8, sims_per_call: int = 200,
            device="cuda", filters: int = 64, n_fc_layers: int = 6, n_residuals: int = 6,
            games_dir: Optional[str] = None) -> dict:
    """Run the phases in a fresh child process on ``device`` and return its
    numbers beside both pids. The net's widths are the JAX script's unless
    given (the CLI keeps them). With ``games_dir`` the child also writes
    the games of the generation's second call there
    (``replay.save_generation``, as generation 1)."""
    from connect4_tpu_torch.utils import resolve_device

    dev = resolve_device(device)  # no card: raise here, before spawning
    params = dict(slots=slots, sims=sims, parallel_sims=parallel_sims, sims_per_call=sims_per_call,
                  device=str(dev), filters=filters, n_fc_layers=n_fc_layers, n_residuals=n_residuals,
                  games_dir=games_dir)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    spawned = time.time()
    proc = subprocess.run([sys.executable, "-c", CHILD_CODE, json.dumps(params)], env=env,
                          capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"measure_compile: the child process failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    r = json.loads(proc.stdout.strip().split("\n")[-1])
    if r["torch_loaded_at_start"]:
        raise RuntimeError("measure_compile: torch was already loaded when the child started")
    r["interpreter_start_s"] = r.pop("started_at") - spawned
    r["launches_by_boards"] = {int(b): n for b, n in r["launches_by_boards"].items()}
    return {"parent_pid": os.getpid(), **params, **r}


def child(params_json: str, started_at: float) -> None:
    """The child's side: every phase in order, one JSON line on stdout."""
    torch_at_start = "torch" in sys.modules
    p = json.loads(params_json)
    out = {"child_pid": os.getpid(), "torch_loaded_at_start": torch_at_start, "started_at": started_at}

    t = time.perf_counter()
    import torch

    out["import_torch_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from connect4_tpu_torch import build
    from connect4_tpu_torch.config import MCTSConfig, NetConfig
    from connect4_tpu_torch.env.core import initial_state
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.mcts import descent
    from connect4_tpu_torch.mcts.batched import Search
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.net import init_net
    from connect4_tpu_torch.scripts import _common
    from connect4_tpu_torch.training import replay
    from connect4_tpu_torch.training.self_play import make_refill_play_fn
    from connect4_tpu_torch.utils import make_generator, resolve_device

    out["import_port_s"] = time.perf_counter() - t

    dev = resolve_device(p["device"])
    out["device"] = _common.device_name(dev)
    if dev.type == "cuda":
        t = time.perf_counter()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        out["cuda_context_s"] = time.perf_counter() - t
        with tempfile.TemporaryDirectory(prefix="measure_compile_") as tmp:
            toolchain = build.NVCC._replace(build_dir=tmp)
            sources = (tower.SOURCE, descent.SOURCE)
            t = time.perf_counter()
            for source in sources:
                build.build(source, toolchain)
            out["nvcc_build_s"] = time.perf_counter() - t
            out["ptxas"] = [line.strip() for source in sources for line in build.BUILD_LOGS[source].splitlines()
                            if "ptxas" in line]
            t = time.perf_counter()
            for source in sources:  # what tower._library() and descent._library() return from now on
                build.load_library(source, toolchain)
            tower._library()
            descent._library()
            out["library_load_s"] = time.perf_counter() - t
        out["not_run"] = None
    else:
        out.update(cuda_context_s=None, nvcc_build_s=None, ptxas=None, library_load_s=None, not_run=CPU_REASON)

    # the tower kernel's launches, counted where they are made (or replayed)
    tower.run_tower.launches = 0
    tower.run_tower.by_shape = {}

    S = p["slots"]
    t = time.perf_counter()
    net = init_net(NetConfig(filters=p["filters"], n_fc_layers=p["n_fc_layers"], n_residuals=p["n_residuals"],
                             compute_dtype="bfloat16"), torch.Generator().manual_seed(0), device=dev)
    ev = make_net_evaluator(net)
    config = MCTSConfig(simulations=p["sims"], root_dirichlet_alpha=0.3, root_exploration_fraction=0.25,
                        num_sampling_moves=6, parallel_sims=p["parallel_sims"])
    state = initial_state((S,), device=dev)
    generator = make_generator(0, dev)
    search = Search(ev, config, p["sims_per_call"])
    _common.sync(dev)
    out["net_s"] = time.perf_counter() - t

    programs = {}
    for name in PROGRAMS:
        times = []
        for _ in range(2):  # the first call, then a warm one
            if name == "root_init":
                _, dt = _common.timed(lambda: search.init(state, generator), dev)
            elif name == "segment":
                ws = search.init(state, generator)
                _, dt = _common.timed(lambda: search.segment(ws), dev)
            else:
                ws = search.init(state, generator)
                search.segment(ws)
                _, dt = _common.timed(lambda: search.finish(ws, generator), dev)
            times.append(dt)
        programs[name] = {"first_s": times[0], "warm_s": times[1]}
    out["programs"] = programs
    out["capture_ms"] = _captures(search)

    play = make_refill_play_fn(ev, config, S, 4 * S, p["sims_per_call"], device=dev)
    runs = []
    for seed in (1, 2):
        games, dt = _common.timed(lambda: play(make_generator(seed, dev)), dev)
        runs.append(dt)
    out["generation"] = {"games": 4 * S, "first_s": runs[0], "second_s": runs[1],
                         "finished": int((games.result != 0).sum()), "moves": int(games.mask.sum()),
                         "capture_ms": _captures(play.search)}
    if p["games_dir"]:
        replay.save_generation(p["games_dir"], 1, games)
    out["launches"] = tower.run_tower.launches
    by_boards = {}
    for per in tower.run_tower.by_shape.values():
        for b, n in per.items():
            by_boards[b] = by_boards.get(b, 0) + n
    out["launches_by_boards"] = by_boards
    print(json.dumps(out), flush=True)


def _captures(search) -> dict:
    """``{rows: {graph: capture ms}}`` of a search's workspaces (empty
    where it runs no graphs: on the CPU)."""
    return {str(rows): dict(ws.graphs.capture_ms) for (_, rows), ws in search.workspaces.items()
            if ws.graphs is not None}


def report(r: dict) -> None:
    print(f"child process {r['child_pid']} (this process {r['parent_pid']}), {r['device']}: "
          f"torch {'already' if r['torch_loaded_at_start'] else 'not'} loaded at its start", flush=True)

    def phase(name, seconds):
        print(f"{name:24s} " + ("not run" if seconds is None else f"{seconds:8.3f}s"))

    phase("interpreter start", r["interpreter_start_s"])
    phase("import torch", r["import_torch_s"])
    phase("import the port", r["import_port_s"])
    phase("cuda context", r["cuda_context_s"])
    phase("nvcc build (cold)", r["nvcc_build_s"])
    phase("library load (ctypes)", r["library_load_s"])
    if r["not_run"]:
        print(f"cuda context, nvcc build, library load: {r['not_run']}")
    for line in r["ptxas"] or []:
        print(f"  {line}")
    phase("fresh net", r["net_s"])
    for name, t in r["programs"].items():
        label = f"segment[{r['sims_per_call']}]" if name == "segment" else name
        print(f"{label:24s} first {t['first_s']:8.3f}s  warm {t['warm_s']:8.3f}s")
    print(f"graph captures (ms) by rows: {r['capture_ms'] or 'none (no CUDA graphs on the CPU)'}")
    g = r["generation"]
    print(f"full refill generation ({r['slots']} slots, {g['games']} games): first {g['first_s']:.1f}s, "
          f"second {g['second_s']:.1f}s ({g['finished']} games finished, {g['moves']} moves); graph captures "
          f"(ms) by pool width {g['capture_ms'] or 'none'}")
    print(f"tower kernel launches in the child: {r['launches']} by batch {r['launches_by_boards']}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--slots", type=int, default=256)
    parser.add_argument("--sims", type=int, default=800)
    parser.add_argument("--parallel-sims", type=int, default=8)
    parser.add_argument("--sims-per-call", type=int, default=200)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    r = measure(args.slots, args.sims, args.parallel_sims, args.sims_per_call, args.device)
    report(r)
    from connect4_tpu_torch.scripts import _common

    _common.emit(r)
    return r


if __name__ == "__main__":
    main()
