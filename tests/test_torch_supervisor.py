"""The port's supervisor (``connect4_tpu_torch.training.supervisor``): the
four scripted-child cases of tests/test_supervisor.py (clean exit, a wedged
child killed and the dead-start budget, the STOP file, a crash then a
resumed finish), and the default child command line with its device."""

import subprocess
import sys
import textwrap

import pytest
import torch

from connect4_tpu_torch.training import supervisor
from connect4_tpu_torch.training.supervisor import supervise

torch.set_num_threads(1)


@pytest.fixture()
def run_dir(tmp_path):
    (tmp_path / "run").mkdir()
    (tmp_path / "config.py").write_text(textwrap.dedent(f"""
        from connect4_tpu_torch.config import AlphaZeroConfig, StorageConfig
        config = AlphaZeroConfig(
            storage_config=StorageConfig(
                save_dir={str(tmp_path / 'run')!r},
                data_dir={str(tmp_path / 'nodata')!r},
            ),
        )
        """))
    return tmp_path


def _child(body: str) -> list:
    return [sys.executable, "-c", textwrap.dedent(body)]


def _supervise(run_dir, **kw):
    kw = {"poll_seconds": 0.1, "stall_seconds": 30, "settle_seconds": 0, **kw}
    return supervise(str(run_dir / "config.py"), str(run_dir / "train.log"), **kw)


def test_clean_exit_passes_through(run_dir):
    assert _supervise(run_dir, command=_child("print('gen done', flush=True)")) == 0
    assert b"gen done" in (run_dir / "train.log").read_bytes()


def test_wedged_child_is_killed_and_dead_starts_are_counted(run_dir):
    # no log heartbeat: killed; with max_restarts=2 the supervisor gives up
    code = _supervise(run_dir, stall_seconds=0.5, max_restarts=2,
                      command=_child("import time; time.sleep(600)"))
    assert code == 1


def test_stop_file_stops_instead_of_restarting(run_dir):
    stop = run_dir / "run" / "STOP"
    code = _supervise(run_dir, command=_child(f"""
        import pathlib, sys
        print('working', flush=True)
        pathlib.Path({str(stop)!r}).touch()
        sys.exit(3)
        """))
    assert code == 3


def test_crashed_child_is_restarted_until_it_succeeds(run_dir, tmp_path):
    marker = tmp_path / "crashed_once"
    code = _supervise(run_dir, command=_child(f"""
        import pathlib
        m = pathlib.Path({str(marker)!r})
        print('attempt', flush=True)
        if not m.exists():
            m.touch()
            raise SystemExit(1)
        print('resumed and finished', flush=True)
        """))
    assert code == 0
    assert b"resumed and finished" in (run_dir / "train.log").read_bytes()


@pytest.mark.parametrize("kw,tail", [
    ({}, ["--device", "cuda"]),
    ({"generations": 3}, ["--generations", "3", "--device", "cuda"]),
    ({"until_generation": 7, "device": "cpu"}, ["--until-generation", "7", "--device", "cpu"]),
])
def test_default_child_command_line(run_dir, monkeypatch, kw, tail):
    launched = []
    real_popen = subprocess.Popen

    def popen(cmd, **popen_kw):
        launched.append(cmd)
        return real_popen([sys.executable, "-c", "pass"], **popen_kw)

    monkeypatch.setattr(supervisor.subprocess, "Popen", popen)
    assert _supervise(run_dir, **kw) == 0
    config = str(run_dir / "config.py")
    assert launched == [[sys.executable, "-m", "connect4_tpu_torch.cli", "training", "-c", config] + tail]


def test_main_passes_the_device_through(monkeypatch):
    seen = {}
    monkeypatch.setattr(supervisor, "supervise", lambda *a, **kw: seen.update(kw) or 0)
    assert supervisor.main(["-c", "cfg.py"]) == 0 and seen["device"] == "cuda"
    assert supervisor.main(["-c", "cfg.py", "--device", "cpu", "--generations", "2"]) == 0
    assert seen["device"] == "cpu" and seen["generations"] == 2
