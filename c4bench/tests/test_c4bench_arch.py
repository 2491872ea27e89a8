"""The net architectures the harness finds by name, on the CPU.

    python3 -m pytest c4bench/tests -q -p no:cacheprovider

The identity tests pin what the benchmark's two configurations make (their
leaves, their weights from a seed, the reference's forward and SGD steps),
so that moving an architecture behind its name changes no number. The
plug-in test adds an architecture as its two files alone, in a directory of
its own, and drives the harness through its name.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil

import pytest
import torch

from c4bench import builders, flops, run
from c4bench.kinds import common, train
from c4bench.reference import net as ref_net

torch.set_num_threads(2)


def _config(name):
    with open(os.path.join(run.ROOT, "c4bench", "configs", f"{name}.json")) as fh:
        return json.load(fh)


def _oinkoink_shapes(c, f, n_residuals, n_fc_layers):
    """The oinkoink ResNet's leaves, written out: names, shapes, order."""

    def bn(name, ch):
        return [(f"{name}.{leaf}", (ch,)) for leaf in ("weight", "bias", "running_mean", "running_var")]

    out = [("conv_block.conv.weight", (f, c, 3, 3))] + bn("conv_block.bn", f)
    for i in range(n_residuals):
        out += [(f"res_blocks.{i}.conv0.weight", (f, f, 3, 3))] + bn(f"res_blocks.{i}.bn0", f)
        out += [(f"res_blocks.{i}.conv1.weight", (f, f, 3, 3))] + bn(f"res_blocks.{i}.bn1", f)
    out += [("value_head.conv.weight", (1, f, 1, 1)), ("value_head.conv.bias", (1,))] + bn("value_head.bn", 1)
    for i in range(n_fc_layers):
        out += [(f"value_head.fcs.{i}.weight", (42, 42)), (f"value_head.fcs.{i}.bias", (42,))]
    out += [("value_head.out.weight", (1, 42)), ("value_head.out.bias", (1,))]
    out += [("policy_head.conv.weight", (2, f, 1, 1)), ("policy_head.conv.bias", (2,))] + bn("policy_head.bn", 2)
    out += [("policy_head.fc.weight", (7, 84)), ("policy_head.fc.bias", (7,))]
    return out


# pinned on the harness before architectures were found by name: make_weights'
# checksum at seed 0; on 64 boards of make_window(512, 7), the reference's
# forward (sum of values, sum of priors weighted by column) and the losses of
# its three SGD steps
PINNED = {
    "oinkoink-f64": {
        "shapes": _oinkoink_shapes(3, 64, 6, 6), "checksum": 94907.49849726395,
        "forward": (31.82579666376114, 192.78898656368256),
        "losses": (0.6580976843833923, 0.6807274222373962, 0.6894849538803101),
    },
    "alphazero-f256-r19": {
        "shapes": _oinkoink_shapes(3, 256, 19, 6), "checksum": 3331119.8552907617,
        "forward": (25.982887148857117, 95.19383596137777),
        "losses": (0.6667088270187378, 0.6637036800384521, 0.6723360419273376),
    },
}
CONFIGS = sorted(PINNED)


def _checksum(weights):
    total = 0.0
    for i, v in enumerate(weights.values()):
        v = v.double().flatten()
        total += (i + 1) * float((v * torch.linspace(1.0, 2.0, v.numel(), dtype=torch.float64)).sum())
    return total


def _batches():
    data = train.make_window(512, 7, "cpu")
    return [tuple(a[i * 64:(i + 1) * 64].float() for a in data) for i in range(3)]


@pytest.mark.parametrize("name", CONFIGS)
def test_leaf_shapes_are_pinned(name):
    shapes = [(k, tuple(leaf.shape)) for k, leaf in ref_net.leaves(_config(name)["net"]).items()]
    assert shapes == PINNED[name]["shapes"]


@pytest.mark.parametrize("name", CONFIGS)
def test_make_weights_checksum_is_pinned(name):
    net = _config(name)["net"]
    weights = common.make_weights(net, 0, "cpu")
    assert list(weights) == list(ref_net.leaves(net))
    assert all(v.dtype == torch.float32 for v in weights.values())
    assert math.isclose(_checksum(weights), PINNED[name]["checksum"], rel_tol=1e-9)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_and_steps_are_pinned(name):
    cfg = _config(name)
    net, t = cfg["net"], cfg["train"]
    weights = common.make_weights(net, 0, "cpu")
    batches = _batches()
    ref_net.full_float32()
    value, prior = ref_net.forward(weights, net, batches[0][0])
    got = (float(value.double().sum()), float((prior.double() * torch.arange(7, dtype=torch.float64)).sum()))
    for a, b in zip(got, PINNED[name]["forward"]):
        assert math.isclose(a, b, rel_tol=1e-6), (got, PINNED[name]["forward"])
    losses = ref_net.sgd_steps(weights, net, batches, t["lr"], t["momentum"], t["weight_decay"])[0]
    for a, b in zip(losses, PINNED[name]["losses"]):
        assert math.isclose(a, b, rel_tol=1e-6), (losses, PINNED[name]["losses"])


COPY = "oinkoink-resnet-copy"


@pytest.fixture
def copy_arch(tmp_path, monkeypatch):
    """The architecture directories copied to ``tmp_path`` with a second
    architecture added, the oinkoink ResNet's two files under the name
    ``COPY``, and the harness pointed at the copies."""
    ref_dir, prog_dir = tmp_path / "archs", tmp_path / "builders"
    shutil.copytree(ref_net.ARCHS, ref_dir)
    shutil.copytree(builders.DIR, prog_dir)
    shutil.copy(ref_dir / f"{ref_net.DEFAULT_ARCH}.py", ref_dir / f"{COPY}.py")
    shutil.copy(prog_dir / f"{ref_net.DEFAULT_ARCH}.py", prog_dir / f"{COPY}.py")
    monkeypatch.setattr(ref_net, "ARCHS", str(ref_dir))
    monkeypatch.setattr(builders, "DIR", str(prog_dir))
    return tmp_path


def test_an_architecture_is_added_by_its_files_alone(copy_arch):
    cfg = _config("oinkoink-f64")
    cfg["net"]["arch"] = COPY
    path = copy_arch / "copy.json"
    path.write_text(json.dumps(cfg))
    bench = copy.deepcopy(run.manifest())
    next(c for c in bench["configs"] if c["name"] == "oinkoink-f64")["file"] = str(path)
    _, found, traffic, _ = run.cell_parts(bench, "f64-selfplay")
    assert found["net"]["arch"] == COPY and traffic["kind"] == "selfplay"
    for module in (ref_net.arch(found["net"]), builders.find(found["net"])):
        assert module.__file__.startswith(str(copy_arch)) and os.path.basename(module.__file__) == f"{COPY}.py"
    assert flops.net_flops(found["net"]) == flops.net_flops(_config("oinkoink-f64")["net"])
    assert train._model_config(found) == train._model_config(_config("oinkoink-f64"))

    base = dict(cfg["net"], filters=8, n_residuals=1, n_fc_layers=2, compute_dtype="float32")
    del base["arch"]
    net = dict(base, arch=COPY)
    weights = common.make_weights(net, 3, "cpu")
    same = common.make_weights(base, 3, "cpu")
    assert list(weights) == list(same) and all(torch.equal(weights[k], same[k]) for k in same)
    batches = _batches()
    planes = batches[0][0]
    ref_net.full_float32()
    for a, b in zip(ref_net.evaluate(weights, net, planes), ref_net.evaluate(weights, base, planes)):
        assert torch.equal(a, b)
    t = cfg["train"]
    hp = (t["lr"], t["momentum"], t["weight_decay"])
    assert ref_net.sgd_steps(weights, net, batches, *hp)[0] == ref_net.sgd_steps(weights, base, batches, *hp)[0]
    with torch.no_grad():
        v_prog, p_prog = common.program_net(net, weights, "cpu")(planes, nchw=True)
    v_ref, p_ref = ref_net.evaluate(weights, net, planes)
    assert torch.allclose(v_prog, v_ref, atol=1e-5) and torch.allclose(p_prog, p_ref, atol=1e-5)


def test_an_unknown_or_misdescribed_architecture_exits(copy_arch):
    """An ``arch`` without files, or a ``net`` whose keys are not those its
    architecture reads, exits naming it: nothing falls back to the ResNet."""
    cfg = _config("oinkoink-f64")
    unknown = dict(cfg["net"], arch="no-such-arch")
    calls = (lambda: ref_net.leaves(unknown), lambda: common.make_weights(unknown, 0, "cpu"),
             lambda: flops.net_flops(unknown), lambda: builders.find(unknown),
             lambda: common.program_net(unknown, {}, "cpu"))
    for call in calls:
        with pytest.raises(SystemExit, match="no-such-arch"):
            call()
    path = copy_arch / "unknown.json"
    path.write_text(json.dumps(dict(cfg, net=unknown)))
    bench = copy.deepcopy(run.manifest())
    next(c for c in bench["configs"] if c["name"] == "oinkoink-f64")["file"] = str(path)
    with pytest.raises(SystemExit, match="no-such-arch"):
        run.cell_parts(bench, "f64-selfplay")
    with pytest.raises(SystemExit, match="se_ratio"):
        ref_net.leaves(dict(cfg["net"], se_ratio=4))
    with pytest.raises(SystemExit, match=COPY):
        ref_net.leaves({"arch": COPY, "filters": 64})
