"""Training-run supervisor: failure detection and automatic restart.

The port's copy of ``connect4_tpu.training.supervisor``. A long run can
fail two ways: the trainer raises (a CUDA or NCCL error, a lost card) and
exits, or a call never completes and the trainer blocks forever (a hung
collective, a wedged device). The training loop checkpoints every
generation and resumes exactly (``training.loop``), so the recovery for
both is the same: kill the process, let the device settle, relaunch.

This module is that watchdog. It launches the ``training`` CLI mode as a
child, treats *log growth* as a heartbeat, and restarts the child
(SIGTERM, then SIGKILL after a grace period, always the exact child PID)
when the heartbeat flatlines. It exits when the child completes, when the
run's STOP file appears, or after ``--max-restarts`` consecutive dead
starts.

Usage:
    python -m connect4_tpu_torch.training.supervisor -c config.py \
        [--generations N | --until-generation G] [--device cuda] \
        [--stall-minutes 20] [--log train.log]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def _log(msg: str) -> None:
    print(f"[supervisor {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _terminate(proc: subprocess.Popen, grace_seconds: float = 30.0) -> None:
    """SIGTERM then SIGKILL the exact child PID (never a pattern match)."""
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=grace_seconds)
    except subprocess.TimeoutExpired:
        _log(f"child {proc.pid} ignored SIGTERM; sending SIGKILL")
        proc.kill()
        proc.wait()


def supervise(
    config_path: str,
    log_path: str,
    generations: int | None = None,
    stall_seconds: float = 20 * 60,
    poll_seconds: float = 30.0,
    settle_seconds: float = 120.0,
    max_restarts: int = 50,
    extra_env: dict | None = None,
    command: list | None = None,
    until_generation: int | None = None,
    device: str = "cuda",
) -> int:
    """Run the training CLI under stall supervision; returns its final
    exit code (0 also when stopped via the STOP file). The child runs on
    ``device``; ``command`` overrides the child command line (tests use a
    scripted child)."""
    # the STOP file lives in the run's save_dir; read it from the config
    namespace: dict = {}
    with open(config_path) as fh:
        exec(compile(fh.read(), config_path, "exec"), namespace)
    save_dir = namespace["config"].storage_config.save_dir
    stop_file = os.path.join(save_dir, "STOP")

    cmd = command or [
        sys.executable, "-m", "connect4_tpu_torch.cli", "training", "-c", config_path,
    ]
    if command is None and generations is not None:
        cmd += ["--generations", str(generations)]
    if command is None and until_generation is not None:
        # absolute target: restart-safe (a relative --generations budget
        # would overshoot when a wedged child is relaunched mid-run)
        cmd += ["--until-generation", str(until_generation)]
    if command is None:
        cmd += ["--device", device]

    env = dict(os.environ)
    if extra_env:
        env.update(extra_env)

    restarts = 0
    while True:
        log_fh = open(log_path, "ab", buffering=0)
        _log(f"launching: {' '.join(cmd)} (log: {log_path})")
        proc = subprocess.Popen(
            cmd, stdout=log_fh, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL, env=env,
        )
        last_size = os.path.getsize(log_path)
        last_progress = time.time()
        made_progress = False
        try:
            while True:
                time.sleep(poll_seconds)
                code = proc.poll()
                size = os.path.getsize(log_path)
                if size != last_size:
                    last_size, last_progress = size, time.time()
                    made_progress = True
                if code is not None:
                    break
                if os.path.exists(stop_file):
                    # let the loop notice the STOP file itself at the next
                    # generation boundary unless it is already stalled
                    pass
                if time.time() - last_progress > stall_seconds:
                    _log(
                        f"no log growth for {stall_seconds / 60:.0f} min — "
                        f"killing wedged child {proc.pid} and restarting"
                    )
                    _terminate(proc)
                    code = None
                    break
        finally:
            log_fh.close()

        if code == 0:
            _log("training completed")
            return 0
        if os.path.exists(stop_file):
            _log("STOP file present; not restarting")
            return 0 if code in (0, None) else int(code)
        if code is not None:
            _log(f"child exited with code {code}")

        # a child that made progress resets the dead-start budget
        restarts = 0 if made_progress else restarts + 1
        if restarts >= max_restarts:
            _log(f"{max_restarts} consecutive restarts without progress; giving up")
            return 1
        _log(f"waiting {settle_seconds:.0f}s for the device to settle, then resuming")
        time.sleep(settle_seconds)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--generations", type=int, default=None)
    parser.add_argument("--until-generation", type=int, default=None)
    parser.add_argument("--log", default="train.log")
    parser.add_argument("--stall-minutes", type=float, default=20.0)
    parser.add_argument("--poll-seconds", type=float, default=30.0)
    parser.add_argument("--settle-seconds", type=float, default=120.0)
    parser.add_argument("--max-restarts", type=int, default=50)
    parser.add_argument("--device", default="cuda", help="torch device of the child (default: cuda)")
    args = parser.parse_args(argv)
    return supervise(
        args.config,
        args.log,
        generations=args.generations,
        until_generation=args.until_generation,
        stall_seconds=args.stall_minutes * 60,
        poll_seconds=args.poll_seconds,
        settle_seconds=args.settle_seconds,
        max_restarts=args.max_restarts,
        device=args.device,
    )


if __name__ == "__main__":
    raise SystemExit(main())
