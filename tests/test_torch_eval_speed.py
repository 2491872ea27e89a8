"""``connect4_tpu_torch.scripts.pallas_eval_speed`` on the CPU against the
quantities of the JAX package's ``scripts/pallas_eval_speed.py``.

The JAX script sets the folded bf16 ``InferenceNet`` in XLA (``xla_fwd``)
against the fused Pallas tower (``pallas_fwd``) on the packaged gen-161
net and prints the largest |dv| and |dp| between them. The test computes
those on the tool's own boards, with the Pallas tower in interpret mode as
``tests/test_pallas_net.py`` runs it, and holds the tool's |dv| and |dp|
(the folded net through the library's convolutions against the port's
tower, here its plain version) to them within 2e-2 each: the two routes of
either package round to bf16 at every layer and sum in different orders.
At the tool's default batches it pins the JAX script's quantities that
``chip_smoke.py`` holds the card to (``EVAL_SPEED_JAX``)."""

import dataclasses
import json

import numpy as np
import torch

import jax

from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.models.net import InferenceNet as JInferenceNet
from connect4_tpu.models.net import fold_bn_params as jfold_bn_params
from connect4_tpu.models.pallas_net import make_pallas_forward
from connect4_tpu.models.pallas_net import pack_weights as jpack_weights
from chip_smoke import EVAL_SPEED_JAX
from connect4_tpu_torch.models.convert import read_example_net
from connect4_tpu_torch.scripts import pallas_eval_speed

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these nets from contending
# for the cores (the results do not depend on it).
torch.set_num_threads(1)

BOARDS = 24


def _jax_differences(b):
    """max |dv| and |dp| of the JAX script's two routes on the tool's
    ``b`` boards."""
    config, _, params, stats = read_example_net()
    jconfig = JNetConfig(**dataclasses.asdict(config))
    folded = jfold_bn_params(jconfig, params, stats)
    x = pallas_eval_speed.boards(b)
    vx, px = jax.jit(lambda x: JInferenceNet(jconfig).apply({"params": folded}, x))(x)
    vp, pp = make_pallas_forward(jconfig, jpack_weights(jconfig, folded), interpret=True)(x)
    return (float(np.abs(np.asarray(vp, np.float32) - np.asarray(vx, np.float32)).max()),
            float(np.abs(np.asarray(pp, np.float32) - np.asarray(px, np.float32)).max()))


def test_eval_speed_on_the_cpu_matches_the_jax_scripts_differences(capsys):
    """``--device cpu`` at a small batch and one iteration: one row with
    both routes' times, and |dv|, |dp| within 2e-2 of the JAX script's on
    the same boards (measured on the CPU: the port's 0.0181 and 0.0064
    against JAX's 0.0170 and 0.0106); the last line is the JSON result."""
    pallas_eval_speed.main(["--device", "cpu", "--batches", str(BOARDS), "--iters", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["device"] == "cpu" and line["net"] == "gen161" and line["iters"] == 1
    (row,) = line["rows"]
    assert row["batch"] == BOARDS
    for key in ("first_s", "library_ms", "kernel_ms", "library_tflops", "kernel_tflops"):
        assert np.isfinite(row[key]) and row[key] > 0, key
    assert any(s.startswith(f"B={BOARDS}: kernel first call") for s in out)
    jdv, jdp = _jax_differences(BOARDS)
    assert abs(row["max_dv"] - jdv) <= 2e-2 and abs(row["max_dp"] - jdp) <= 2e-2, (row, jdv, jdp)


def test_boards_are_the_jax_scripts_kind():
    """Each plane cell set with probability 1/4, the same boards for the
    same batch size: what the JAX script draws with its key."""
    a, b = pallas_eval_speed.boards(4096), pallas_eval_speed.boards(4096)
    assert a.shape == (4096, 6, 7, 3) and a.dtype == np.float32
    assert np.array_equal(a, b) and set(np.unique(a)) <= {0.0, 1.0}
    assert abs(a.mean() - 0.25) < 0.01


def test_the_jax_scripts_differences_at_its_default_batches():
    """The JAX script's max |dv| and |dp| at B=2048 and 4096 on the tool's
    boards, as ``chip_smoke.py`` records them (within 5e-3: they are maxima
    over thousands of boards, which another build of XLA may move a little)
    to hold the card's routes against: two bf16 routes that round at other
    points differ by several hundredths on some board of thousands."""
    for b, (dv, dp) in EVAL_SPEED_JAX.items():
        jdv, jdp = _jax_differences(b)
        assert abs(jdv - dv) <= 5e-3 and abs(jdp - dp) <= 5e-3, (b, jdv, jdp)
