"""The two hooks of ``__graft_entry__.py``, in PyTorch.

- ``entry(device=None)``: the eval-mode forward of the flagship net (the
  reference's published example-net architecture: filters 64, fc 6, res 6,
  float32) as a pure function of its weights and its input, with example
  arguments: ``forward, args = entry(); value, prior = forward(*args)``.
- ``dryrun_multichip(n, device=None)``: one real ``TrainingLoop``
  generation on an ``n``-rank data mesh with the JAX hook's tiny
  configuration (``dryrun_config``): sharded refill self-play, the
  data-parallel train pass with its tail batch, the checkpoint and rank 0's
  gating match, checked as the JAX hook checks them.

Every rank of ``dryrun_multichip`` is a fresh process (``python -m
connect4_tpu_torch.entry N --rank SAVE_DIR ...``) that joins an ``env://``
group on a free local port. A process joins a group once
(``parallel.mesh``), so the caller never joins one and may run the hook
again. Rank r runs on ``cuda:<r % cards>``; the backend is NCCL when every
rank has a card of its own and gloo where ranks share one, which NCCL
refuses; ``device="cpu"`` runs gloo ranks on the CPU. Nothing falls back to
fewer ranks or to the CPU.

    python -m connect4_tpu_torch.entry [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence, Tuple

import torch

from connect4_tpu_torch.config import AlphaZeroConfig, ModelConfig, NetConfig, StorageConfig
from connect4_tpu_torch.models.net import init_net
from connect4_tpu_torch.parallel.mesh import BACKENDS
from connect4_tpu_torch.training.tables import load_table
from connect4_tpu_torch.utils import DeviceLike, resolve_device

EXAMPLE_BATCH = 256
# seconds a dryrun launch may take, every rank's start included; a rank
# that dies leaves the others waiting in a collective for the group's own
# timeout of two hours (parallel.mesh.TIMEOUT), so the launch kills them
TIMEOUT = 600.0
RANK_LINE = "dryrun rank"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # holds this package


def entry(device: DeviceLike = None):
    """``(forward, (variables, example_planes))``, on ``device`` (the card
    by default). ``forward(variables, planes_nhwc)`` is the eval-mode
    forward of a freshly initialised (seed 0) float32 net of 64 filters,
    fc 6 and res 6, returning ``(value [N], prior [N, 7])``; it reads the
    weights from ``variables`` only and changes nothing. ``variables``
    holds the net's parameters and BatchNorm buffers by state-dict name,
    the counterpart of Flax's ``{'params', 'batch_stats'}``;
    ``example_planes`` is zero ``[256, 6, 7, 3]`` float32 planes."""
    dev = resolve_device(device)
    net = init_net(
        NetConfig(filters=64, n_fc_layers=6, n_residuals=6), torch.Generator().manual_seed(0), dev
    )
    variables = {name: t.detach().clone() for name, t in net.state_dict().items()}

    @torch.no_grad()
    def forward(variables, planes_nhwc):
        return torch.func.functional_call(net, variables, (planes_nhwc,), strict=True)

    example_planes = torch.zeros(EXAMPLE_BATCH, 6, 7, 3, dtype=torch.float32, device=dev)
    return forward, (variables, example_planes)


def dryrun_config(n: int, save_dir: str) -> AlphaZeroConfig:
    """The JAX hook's configuration for ``n`` ranks: a net of 8 filters, fc
    1, res 1; batch 8n, one epoch; 4 simulations in calls of 2; 2n games in
    a pool of n slots (so the pool refills); 2 sampling moves; a gating
    match every generation; the benchmark sets read from a directory that
    does not exist, so the evaluation is skipped."""
    return AlphaZeroConfig(
        model_config=ModelConfig(
            net_config=NetConfig(filters=8, n_fc_layers=1, n_residuals=1),
            batch_size=8 * n,
            n_training_epochs=1,
        ),
        storage_config=StorageConfig(save_dir=save_dir, data_dir=os.path.join(save_dir, "nodata")),
        simulations=4,
        sims_per_call=2,
        n_training_games=2 * n,
        selfplay_batch=n,
        num_sampling_moves=2,
        n_eval=1,
        mesh_shape=(n,),
    )


def _rank_plan(n: int, device: DeviceLike = None) -> Tuple[List[str], str]:
    """``(devices, backend)`` of an ``n``-rank dryrun: rank r on
    ``cuda:<r % cards>`` (``device`` None or ``"cuda"``), NCCL when every
    rank has a card of its own, else gloo; or gloo ranks on the CPU. Raises
    ``RuntimeError`` when the card is asked for and there is none."""
    if n < 1:
        raise ValueError(f"{n} ranks: need at least one")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * n, "gloo"
    if dev.type != "cuda" or dev.index is not None:
        raise ValueError(f"device {device!r}: name 'cuda' (rank r on cuda:<r % cards>) or 'cpu'")
    cards = torch.cuda.device_count()
    return [f"cuda:{r % cards}" for r in range(n)], ("nccl" if n <= cards else "gloo")


def dryrun_multichip(n: int, device: DeviceLike = None, timeout: float = TIMEOUT) -> None:
    """One ``TrainingLoop`` generation on an ``n``-rank mesh, one fresh
    process a rank (``_rank_plan`` says where each runs), in a temporary
    directory that is removed afterwards. Prints each rank's line (rank,
    device, backend), rank 0's match result and the OK line. Raises when a
    rank fails or the launch outlasts ``timeout`` seconds, after killing
    every rank."""
    devices, backend = _rank_plan(n, device)
    save_dir = tempfile.mkdtemp(prefix="c4_dryrun_")
    try:
        commands = [
            [sys.executable, "-m", "connect4_tpu_torch.entry", str(n), "--rank", save_dir,
             "--device", dev, "--backend", backend]
            for dev in devices
        ]
        logs = run_ranks(commands, save_dir, timeout)
        matches = load_table(save_dir, "match_results")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    if len(matches) != 1:
        raise RuntimeError(f"dryrun_multichip({n}): {len(matches)} match results, not 1")
    for text in logs:
        print(next(line for line in text.splitlines() if line.startswith(RANK_LINE)))
    print(f"dryrun_multichip({n}): gating match {json.dumps(matches[0])}")
    print(f"dryrun_multichip({n}): TrainingLoop generation on {n}-rank mesh "
          f"({','.join(dict.fromkeys(devices))}, {backend}) — OK")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(commands: Sequence[Sequence[str]], log_dir: str, timeout: float) -> List[str]:
    """Run ``commands[r]`` as rank r of ``len(commands)``, all at once, each
    in a session of its own with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` (127.0.0.1) and a free ``MASTER_PORT`` set, the
    directory that holds this package in front of ``PYTHONPATH``, and its
    output in ``<log_dir>/rank<r>.log``; wait until every rank exits. When
    a rank exits non-zero or the ranks outlast ``timeout`` seconds, kill
    every rank still running and raise ``RuntimeError`` with each failed
    rank's exit code and the end of its log. Returns the ranks' logs."""
    port = _free_port()
    procs, paths = [], []
    timed_out = False
    try:
        for rank, cmd in enumerate(commands):
            env = dict(
                os.environ, RANK=str(rank), WORLD_SIZE=str(len(commands)), LOCAL_RANK=str(rank),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p),
            )
            paths.append(os.path.join(log_dir, f"rank{rank}.log"))
            with open(paths[-1], "w") as fh:
                procs.append(subprocess.Popen(list(cmd), stdout=fh, stderr=subprocess.STDOUT, env=env,
                                              start_new_session=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and not any(p.returncode for p in procs):
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:  # it exited since the poll
                    pass
                p.wait()
    logs = []
    for path in paths:
        with open(path) as fh:
            logs.append(fh.read())
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        why = f"outlasted {timeout} s" if timed_out else "a rank failed"
        ends = "".join(f"\n--- rank {r} (exit {procs[r].returncode}), the end of its log:\n{logs[r][-3000:]}"
                       for r in failed)
        raise RuntimeError(f"{len(commands)} ranks: {why}; every rank still running was killed "
                           f"(exit -{int(signal.SIGKILL)}){ends}")
    return logs


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {what}")


def _rank_main(n: int, save_dir: str, device: str, backend: str) -> None:
    """One rank of ``dryrun_multichip``: join the group from the
    environment, run one generation, check it. Rank 0 alone evaluates,
    plays the match and writes; every rank checks the checkpoint after the
    loop's final barrier."""
    import torch.distributed as dist

    from connect4_tpu_torch.parallel.mesh import initialize_distributed
    from connect4_tpu_torch.training.loop import TrainingLoop

    if torch.device(device).type == "cpu":
        # the ranks share the CPU's cores and the net is 8 filters wide:
        # more intra-op threads a rank only contend (2 ranks: 19 s against 9)
        torch.set_num_threads(1)
    initialize_distributed(backend, device)
    loop = TrainingLoop(dryrun_config(n, save_dir), device)
    mesh = loop.mesh
    _check(mesh is not None and mesh.world_size == n and loop.train_step is not None,
           f"the loop has no mesh of {n} ranks")
    print(f"{RANK_LINE} {mesh.rank} of {n}: {mesh.device}, {mesh.backend}", flush=True)
    loop.run(generations=1)
    _check(loop.gen == 2, "one generation must have completed")
    _check(os.path.isdir(os.path.join(save_dir, "1", "ckpt")), "no checkpoint of generation 1")
    if mesh.rank == 0:
        _check(len(loop.match_results) == 1, f"{len(loop.match_results)} match results, not 1")
    dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m connect4_tpu_torch.entry",
        description="One TrainingLoop generation on an n-rank data mesh (dryrun_multichip).",
    )
    parser.add_argument("n", nargs="?", type=int, default=8, help="ranks (default 8)")
    parser.add_argument("--device", default=None,
                        help="'cpu' for gloo ranks on the CPU (default: the card, rank r on cuda:<r %% cards>)")
    # one rank of a launch: its save directory, its device with its index, its backend
    parser.add_argument("--rank", metavar="SAVE_DIR", help=argparse.SUPPRESS)
    parser.add_argument("--backend", choices=BACKENDS, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.n, args.rank, args.device, args.backend)
    else:
        dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
