"""Leela Chess Zero's squeeze-and-excitation body as the harness finds it
by name (``lc0-se-resnet``), on the CPU: its leaves, its operation counts
by hand, its reference body against the program's own plain reference
(``connect4_tpu_torch/reference/lc0_se_resnet.py``), the builder against
the reference at a small size, the new cells' limits against the float8
control and two planted faults, and the parent's clean exit.

    python3 -m pytest c4bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
import types

import pytest
import torch

from c4bench import builders, flops, run
from c4bench.kinds import common, selfplay, train
from c4bench.reference import net as ref_net

torch.set_num_threads(2)
SEED = 2**40 + 777  # more than 32 bits, as a benchmark run's seed may be
CONFIG = "lc0-t40-se-f256-r20"


def _load(*parts):
    with open(os.path.join(run.ROOT, "c4bench", *parts)) as fh:
        return json.load(fh)


def tiny(dtype="float32"):
    """The configuration at 16 filters, one block, a squeeze of 2, with the
    small search, batch and window of ``test_c4bench_judge.tiny``."""
    cfg = _load("configs", f"{CONFIG}.json")
    cfg["net"].update(filters=16, n_residuals=1, n_fc_layers=2, compute_dtype=dtype)
    cfg["search"].update(simulations=16, parallel_sims=4, slots=8, sims_per_call=8)
    cfg["train"].update(batch_size=64)
    sp = _load("traffic", "selfplay.json")
    sp.update(games_per_call=16, check_rows=4)
    tr = _load("traffic", "train.json")
    tr.update(window_positions=1024, chunk_steps=2)
    return cfg, sp, tr


def _planes(n, seed):
    return train.make_window(2 * n, seed, "cpu")[0][:n].float()


def test_configuration_names_its_architecture_and_cells():
    bench = run.manifest()
    cfg = _load("configs", f"{CONFIG}.json")
    assert cfg["net"] == {"arch": "lc0-se-resnet", "channels": 3, "filters": 256, "n_residuals": 20,
                          "n_fc_layers": 6, "compute_dtype": "bfloat16", "se_ratio": 8}
    assert cfg["reduced"] == [] and cfg["search"] == _load("configs", "alphazero-f256-r19.json")["search"]
    assert cfg["train"] == _load("configs", "alphazero-f256-r19.json")["train"]
    cells = {w["name"]: w for w in bench["workloads"] if w["config"] == CONFIG}
    assert {n: (w["traffic"], w["chips"]) for n, w in cells.items()} == {
        "lc0t40-selfplay": ("selfplay", 1), "lc0t40-train": ("train", 1)}
    reported = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
                if "lc0t40-train" in m.get("workloads", [])}
    assert reported == {"train_positions_per_s", "train_card_ms_per_step", "mfu.train", "batchnorm_share.train",
                        "device_idle_pct.train", "se_roofline.train"}
    reported = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
                if "lc0t40-selfplay" in m.get("workloads", [])}
    assert reported == {"selfplay_moves_per_s", "tower_roofline", "iteration_ms.selfplay", "mfu.selfplay",
                        "device_idle_pct.selfplay"}


def test_leaves_in_order():
    """The gate's two Dense layers follow each block's second BatchNorm,
    under the program's names; the heads are the oinkoink net's."""
    net = dict(_load("configs", f"{CONFIG}.json")["net"], filters=16, n_residuals=2, n_fc_layers=1)

    def bn(name, ch):
        return [(f"{name}.{leaf}", (ch,)) for leaf in ("weight", "bias", "running_mean", "running_var")]

    want = [("conv_block.conv.weight", (16, 3, 3, 3))] + bn("conv_block.bn", 16)
    for i in range(2):
        want += [(f"res_blocks.{i}.conv0.weight", (16, 16, 3, 3))] + bn(f"res_blocks.{i}.bn0", 16)
        want += [(f"res_blocks.{i}.conv1.weight", (16, 16, 3, 3))] + bn(f"res_blocks.{i}.bn1", 16)
        want += [(f"res_blocks.{i}.se.fc1.weight", (2, 16)), (f"res_blocks.{i}.se.fc1.bias", (2,)),
                 (f"res_blocks.{i}.se.fc2.weight", (32, 2)), (f"res_blocks.{i}.se.fc2.bias", (32,))]
    want += [("value_head.conv.weight", (1, 16, 1, 1)), ("value_head.conv.bias", (1,))] + bn("value_head.bn", 1)
    want += [("value_head.fcs.0.weight", (42, 42)), ("value_head.fcs.0.bias", (42,))]
    want += [("value_head.out.weight", (1, 42)), ("value_head.out.bias", (1,))]
    want += [("policy_head.conv.weight", (2, 16, 1, 1)), ("policy_head.conv.bias", (2,))] + bn("policy_head.bn", 2)
    want += [("policy_head.fc.weight", (7, 84)), ("policy_head.fc.bias", (7,))]
    got = [(k, tuple(leaf.shape)) for k, leaf in ref_net.leaves(net).items()]
    assert got == want
    kinds = ref_net.leaves(net)
    assert kinds["res_blocks.1.se.fc2.weight"].kind == ref_net.KERNEL
    assert kinds["res_blocks.1.se.fc2.bias"].kind == ref_net.BIAS


def test_operation_counts_by_hand():
    """At 256 filters, 20 blocks, a squeeze of 32: the convs on 42 cells,
    1.982 GFLOP a board, and each block's gate once a board (256 x 32 and
    32 x 512 multiply-adds), 983,040 operations; the heads as the oinkoink
    net's at 256 filters."""
    net = _load("configs", f"{CONFIG}.json")["net"]
    convs = 42 * 2 * (9 * 3 * 256 + 2 * 20 * 9 * 256 * 256)
    gates = 20 * 2 * (256 * 32 + 32 * 512)
    assert (convs, gates) == (1_982_389_248, 983_040)
    assert flops.tower_flops(net) == convs + gates == 1_983_372_288
    value = 42 * 2 * 256 + 6 * 2 * 42 * 42 + 2 * 42
    policy = 42 * 2 * 256 * 2 + 2 * 84 * 7
    assert flops.head_flops(net) == value + policy == 86_940


def test_gate_bytes_by_hand_and_the_reader():
    """The learner's gate at 256 filters and 20 blocks moves 36 bytes a cell
    and channel a block (forward 14, backward 22), 4 fewer in the last
    block; ``se_roofline.train`` is those bytes over 3.35 TB/s over the
    gate kernels' time, and reads nothing without them or for a net with
    no gate."""
    net = _load("configs", f"{CONFIG}.json")["net"]
    arch = ref_net.arch(net)
    assert arch.se_gate_bytes(net) == 42 * 256 * (20 * 36 - 4) == 7_698_432
    read = run.reader("se_roofline.train")
    seg = {"kernel_s": {"void (anonymous namespace)::se_gate_fwd(...)": 0.003, "se_gate_bwd": 0.006, "other": 1.0},
           "positions": 4096, "net": net}
    assert abs(read(seg) - 100 * 4096 * 7_698_432 / 3.35e12 / 0.009) < 1e-9
    assert read(dict(seg, kernel_s={"other": 1.0})) is None
    assert read(dict(seg, net=_load("configs", "alphazero-f256-r19.json")["net"])) is None


def test_reference_body_equals_the_program_side_reference():
    """The harness's frozen reference and the program's own plain reference
    of lc0's body agree in eval and in training (equal but for float32
    sums in another order), and step for step over three SGD steps."""
    from connect4_tpu_torch.reference import lc0_se_resnet as R

    cfg, _, _ = tiny()
    net = cfg["net"]
    w = common.make_weights(net, SEED, "cpu")
    planes = _planes(64, 3)
    ref_net.full_float32()
    for train_mode in (False, True):
        a = ref_net.forward(w, net, planes, train=train_mode)
        b = R.forward(w, planes, net["n_residuals"], net["n_fc_layers"], train=train_mode)
        assert all(torch.allclose(x, y, rtol=0, atol=1e-6) for x, y in zip(a, b))
    data = train.make_window(512, SEED, "cpu")
    batches = [tuple(x[i * 64:(i + 1) * 64].float() for x in data) for i in range(3)]
    t = cfg["train"]
    hp = (t["lr"], t["momentum"], t["weight_decay"])
    losses, _, _, after = ref_net.sgd_steps(w, net, batches, *hp)
    r_losses, r_after = R.sgd_steps(w, batches, net["n_residuals"], net["n_fc_layers"], *hp)
    assert max(abs(x - y) for x, y in zip(losses, r_losses)) <= 1e-6
    for k, v in after.items():
        assert torch.allclose(v, r_after[k], rtol=0, atol=1e-6), k


def test_builder_equals_the_reference():
    """The builder's net (the program's ``SENetConfig`` net) holding the
    benchmark's weights: its forward in eval and in training within 1e-5
    of the reference's, and three of its train steps within 1e-5 in loss
    and 1e-6 in every weight."""
    from connect4_tpu_torch.config import SENetConfig
    from connect4_tpu_torch.training.learner import TrainState, make_optimizer, make_train_step

    cfg, _, _ = tiny()
    net = cfg["net"]
    assert isinstance(builders.find(net).net_config(net), SENetConfig)
    w = common.make_weights(net, SEED, "cpu")
    model = common.program_net(net, w, "cpu")
    planes = _planes(64, 4)
    ref_net.full_float32()
    for train_mode in (False, True):
        with torch.no_grad():
            got = model.train(train_mode)(planes, nchw=True)
        want = ref_net.forward(w, net, planes, train=train_mode)
        assert all(torch.allclose(x, y, rtol=0, atol=1e-5) for x, y in zip(got, want))
    model = common.program_net(net, w, "cpu")
    state = TrainState(model, make_optimizer(train._model_config(cfg), model))
    step = make_train_step(state.net, state.optimizer)
    data = train.make_window(512, SEED, "cpu")
    batches = [tuple(x[i * 64:(i + 1) * 64] for x in data) for i in range(3)]
    losses = [float(step(*b)["loss"]) for b in batches]
    t = cfg["train"]
    r_losses, _, _, r_after = ref_net.sgd_steps(w, net, batches, t["lr"], t["momentum"], t["weight_decay"])
    assert max(abs(a - b) for a, b in zip(losses, r_losses)) < 1e-5
    for k, p in model.named_parameters():
        assert torch.allclose(p.detach(), r_after[k], atol=1e-6), k


def _limits(cell):
    return _load("limits", f"{cell}.json")


def test_self_play_control_and_a_gate_forced_open_fail_the_limits(monkeypatch):
    """In ``lc0t40-selfplay``'s judgement a sound bf16 run is within every
    limit; the reference in float8 in the program's place fails one; and a
    program whose gate is forced to 1 (``sigmoid(gamma)`` replaced by 1 in
    the tower's plain version, what the CPU evaluator runs) is not correct."""
    from connect4_tpu_torch.models import tower

    cfg, sp, _ = tiny("bfloat16")
    limits = _limits("lc0t40-selfplay")
    out = selfplay.run(cfg, sp, SEED, 3.0, False, "cpu", time.perf_counter(), control=True)
    assert out["counts"]["nodes_judged"] > 0
    assert run.judge(out, limits)[0], out["gaps"]
    assert any(out["gaps"][f"{k}_fp8"] > v for k, v in limits.items()), out["gaps"]

    def open_gate(y, skip, w1, b1, w2, b2, dtype=torch.float32):
        shift = torch.nn.functional.linear(
            torch.relu(torch.nn.functional.linear(y.float().mean(dim=(2, 3)), w1.float(), b1.float())),
            w2.float(), b2.float()).split(y.shape[1], dim=1)[1]
        out = torch.relu(y.float() + shift[:, :, None, None] + skip.float())
        return out, out.to(dtype)

    monkeypatch.setattr(tower, "se_gate_plain", open_gate)
    out = selfplay.run(cfg, sp, SEED, 3.0, False, "cpu", time.perf_counter())
    assert not run.judge(out, limits)[0], out["gaps"]


def _unchanged_step(monkeypatch):
    import copy

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
        return unchanged

    monkeypatch.setattr(learner, "make_train_step", broken)


def test_train_control_and_an_unchanged_state_fail_the_limits(monkeypatch):
    """In ``lc0t40-train``'s judgement a sound bf16 run is within every
    limit; the float8 reference, half of each batch left out and the state
    left unchanged (the reference's stand-ins) each fail one; and a program
    step that leaves its state unchanged is not correct."""
    cfg, _, tr = tiny("bfloat16")
    limits = _limits("lc0t40-train")
    out = train.run(cfg, tr, SEED, 2.0, False, "cpu", time.perf_counter(), control=True)
    assert run.judge(out, limits)[0], out["gaps"]
    for stand_in in ("fp8", "half", "still"):
        assert any(out["gaps"][f"{k}_{stand_in}"] > v for k, v in limits.items()), (stand_in, out["gaps"])
    _unchanged_step(monkeypatch)
    out = train.run(cfg, tr, SEED, 2.0, False, "cpu", time.perf_counter())
    assert not run.judge(out, limits)[0], out["gaps"]


def test_a_program_without_the_architecture_exits_at_once(monkeypatch):
    """The parent commit's program has no ``SENetConfig``: the builder's
    file then exits as it loads, naming the architecture, before anything
    touches a card."""
    fake = types.ModuleType("connect4_tpu_torch.config")
    monkeypatch.setitem(sys.modules, "connect4_tpu_torch.config", fake)
    path = os.path.join(builders.DIR, "lc0-se-resnet.py")
    spec = importlib.util.spec_from_file_location("c4bench_parent_lc0_builder", path)
    with pytest.raises(SystemExit, match="lc0-se-resnet"):
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
