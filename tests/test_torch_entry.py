"""The port's hooks (``connect4_tpu_torch.entry``) against the JAX hooks of
``__graft_entry__.py``, on the CPU:

- ``entry()``: the port's forward, given the JAX ``entry()``'s own initial
  weights (``from_flax``), equals the Flax forward within 1e-5 (float32
  convolutions summed in another order, the limit of
  ``tests/test_torch_net.py``) on the zero example planes and on 96 legal
  positions; the example arguments have the JAX hook's shapes and dtype;
  the forward is a pure function of its arguments;
- ``dryrun_multichip(n)``: the port's configuration equals the one the JAX
  hook builds, field by field, at n = 1, 2 and 8 (the JAX hook run with its
  ``TrainingLoop`` replaced by a recorder; 8 virtual devices, so its
  fallback to virtual CPU devices never runs); the port's hook runs one
  generation at one and two gloo ranks, each a fresh process, through the
  function and through ``python -m connect4_tpu_torch.entry``, and leaves
  no directory behind; without a card it raises before any rank starts;
  a launch past its timeout, or one whose rank fails, raises and leaves no
  rank running."""

import dataclasses
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from connect4_tpu_torch import entry as tentry
from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.models.convert import from_flax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_NET = NetConfig(filters=64, n_fc_layers=6, n_residuals=6)
# Fields of the dryrun configuration that only one package has, with the
# reason. None: the port's config.py copies every field of the JAX one.
ONLY_IN_ONE_PACKAGE = {}


def _graft():
    spec = importlib.util.spec_from_file_location("__graft_entry__", os.path.join(REPO, "__graft_entry__.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _positions(n, seed):
    """``n`` legal positions of uniformly random play, 0 to 35 plies, as
    NHWC float32 planes."""
    rng = np.random.default_rng(seed)
    planes = []
    for _ in range(n):
        board = HostBoard()
        for _ in range(int(rng.integers(0, 36))):
            if board.result is not None:
                break
            board.make_move(int(rng.choice(sorted(board.valid_moves))))
        planes.append(board.to_planes().transpose(1, 2, 0))
    return np.stack(planes).astype(np.float32)


@pytest.fixture(scope="module")
def hooks():
    """Both hooks' results, and the JAX hook's initial weights as the
    port's variables."""
    jforward, (jvariables, jplanes) = _graft().entry()
    forward, (variables, planes) = tentry.entry(device="cpu")
    weights = from_flax(ENTRY_NET, jvariables["params"], jvariables["batch_stats"], device="cpu").state_dict()
    return dict(jforward=jforward, jvariables=jvariables, jplanes=jplanes,
                forward=forward, variables=variables, planes=planes, weights=weights)


@pytest.mark.parametrize("inputs", ["example", "positions"])
def test_entry_forward_matches_the_jax_entry(hooks, inputs):
    x = np.array(hooks["jplanes"]) if inputs == "example" else _positions(96, 0)
    jv, jp = hooks["jforward"](hooks["jvariables"], x)
    tv, tp = hooks["forward"](hooks["weights"], torch.from_numpy(x))
    assert tv.shape == (len(x),) and tp.shape == (len(x), 7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


def test_entry_example_arguments(hooks):
    """Zero float32 planes of the JAX hook's shape on the CPU, and the
    variables of a float32 net of the flagship's architecture: the same
    names and shapes as the JAX weights carried over."""
    planes, jplanes = hooks["planes"], hooks["jplanes"]
    assert planes.shape == tuple(jplanes.shape) == (256, 6, 7, 3)
    assert planes.dtype == torch.float32 and jplanes.dtype == np.float32
    assert planes.device.type == "cpu" and not planes.any()
    variables, weights = hooks["variables"], hooks["weights"]
    assert {k: tuple(v.shape) for k, v in variables.items()} == {k: tuple(v.shape) for k, v in weights.items()}
    assert all(v.dtype == torch.float32 for k, v in variables.items() if not k.endswith("num_batches_tracked"))


def test_entry_forward_is_a_pure_function(hooks):
    """Two calls give the same output bit for bit, the variables stay as
    they were, and the output follows the variables passed, not the last
    ones used."""
    forward, variables, planes = hooks["forward"], hooks["variables"], hooks["planes"]
    x = torch.from_numpy(_positions(64, 1))
    before = {k: v.clone() for k, v in variables.items()}
    first = forward(variables, x)
    other = forward(hooks["weights"], x)
    second = forward(variables, x)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert not torch.equal(first[1], other[1])
    assert variables.keys() == before.keys() and all(torch.equal(variables[k], before[k]) for k in before)
    value, prior = forward(variables, planes)
    assert not value.requires_grad and torch.isfinite(value).all() and torch.isfinite(prior).all()


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_config_matches_the_jax_hook(n, monkeypatch, tmp_path):
    """The JAX hook's ``AlphaZeroConfig`` (recorded by a stand-in for its
    ``TrainingLoop`` that does what the hook checks) against the port's
    ``dryrun_config``, field by field; the directories by their layout."""
    import connect4_tpu.training.loop as jloop

    seen = []

    class Recorder:
        def __init__(self, config):
            seen.append(config)
            self.config = config
            self.mesh, self.sharded_train_step = object(), object()
            self.gen, self.match_results = 1, []

        def run(self, generations):
            os.makedirs(os.path.join(self.config.storage_config.save_dir, "1", "ckpt"))
            self.gen += generations
            self.match_results.append({"return": 0.5})

    monkeypatch.setattr(jloop, "TrainingLoop", Recorder)
    assert len(jax.devices()) >= n
    _graft().dryrun_multichip(n)
    jc = _flat(dataclasses.asdict(seen[0]))
    tc = _flat(dataclasses.asdict(tentry.dryrun_config(n, str(tmp_path))))
    for c in (jc, tc):
        assert c["storage_config.data_dir"] == os.path.join(c["storage_config.save_dir"], "nodata")
        del c["storage_config.save_dir"], c["storage_config.data_dir"]
    assert set(jc) ^ set(tc) == set(ONLY_IN_ONE_PACKAGE)
    shared = sorted(set(jc) & set(tc))
    assert {k: jc[k] for k in shared} == {k: tc[k] for k in shared}
    assert tc["mesh_shape"] == (n,) and tc["model_config.batch_size"] == 8 * n


def _recording_popen(monkeypatch):
    """The processes the launcher starts, recorded as it starts them."""
    started = []

    class Popen(subprocess.Popen):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            started.append(self)

    monkeypatch.setattr(tentry.subprocess, "Popen", Popen)
    return started


def _recording_mkdtemp(monkeypatch):
    made = []
    mkdtemp = tentry.tempfile.mkdtemp

    def recorded(*args, **kwargs):
        made.append(mkdtemp(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tentry.tempfile, "mkdtemp", recorded)
    return made


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_runs_a_generation_on_cpu_ranks(n, monkeypatch, capsys):
    started, made = _recording_popen(monkeypatch), _recording_mkdtemp(monkeypatch)
    tentry.dryrun_multichip(n, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[:n] == [f"dryrun rank {r} of {n}: cpu, gloo" for r in range(n)]
    assert lines[n].startswith(f"dryrun_multichip({n}): gating match {{")
    assert lines[-1] == f"dryrun_multichip({n}): TrainingLoop generation on {n}-rank mesh (cpu, gloo) — OK"
    assert len(started) == n and all(p.returncode == 0 for p in started)
    assert len(made) == 1 and not os.path.exists(made[0])


def test_dryrun_module_runs_on_the_cpu(tmp_path):
    """``python -m connect4_tpu_torch.entry 2 --device cpu`` exits 0 with
    the OK line, and leaves no run directory in its temporary directory."""
    env = dict(os.environ, TMPDIR=str(tmp_path))
    done = subprocess.run([sys.executable, "-m", "connect4_tpu_torch.entry", "2", "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    assert done.stdout.splitlines()[-1] == (
        "dryrun_multichip(2): TrainingLoop generation on 2-rank mesh (cpu, gloo) — OK")
    assert [d for d in os.listdir(tmp_path) if d.startswith("c4_dryrun_")] == []


@pytest.mark.parametrize("hook", ["entry", "dryrun_multichip"])
def test_hooks_refuse_a_missing_card(hook, monkeypatch):
    """With no card and no ``device`` both hooks raise, and no rank
    process is started."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    started = _recording_popen(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry() if hook == "entry" else tentry.dryrun_multichip(2)
    assert started == []


def test_dryrun_past_its_timeout_kills_every_rank(monkeypatch):
    started, made = _recording_popen(monkeypatch), _recording_mkdtemp(monkeypatch)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="outlasted 1.0 s"):
        tentry.dryrun_multichip(2, device="cpu", timeout=1.0)
    assert time.monotonic() - t0 < 30
    assert len(started) == 2 and all(p.poll() is not None for p in started)
    assert not os.path.exists(made[0])


def test_a_failing_rank_fails_the_launch_and_kills_the_others(monkeypatch, tmp_path):
    """One rank exits 3 while the other waits: the launch raises at once
    with each rank's exit code and the end of its log, and the waiting rank
    is killed. Each rank sees its rank and the world size."""
    started = _recording_popen(monkeypatch)
    said = tmp_path / "rank1_said"
    say = "import os, time\nprint('rank', os.environ['RANK'], 'of', os.environ['WORLD_SIZE'], flush=True)\n"
    commands = [  # rank 0 fails once rank 1 has printed its line
        [sys.executable, "-c", say + f"while not os.path.exists({str(said)!r}):\n    time.sleep(0.05)\nraise SystemExit(3)"],
        [sys.executable, "-c", say + f"open({str(said)!r}, 'w').close()\ntime.sleep(300)"],
    ]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a rank failed") as failure:
        tentry.run_ranks(commands, str(tmp_path), timeout=120)
    assert time.monotonic() - t0 < 60
    assert all(p.poll() is not None for p in started) and [p.returncode for p in started] == [3, -9]
    message = str(failure.value)
    assert "rank 0 (exit 3)" in message and "rank 0 of 2" in message
    assert "rank 1 (exit -9)" in message and "rank 1 of 2" in message
