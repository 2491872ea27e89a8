"""The benchmark's manifest, its operation counts and its imports, on the CPU.

    python3 -m pytest c4bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import ast
import json
import math
import os
import re

import pytest

from c4bench import flops, run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "connect4_tpu"}


@pytest.fixture(scope="module")
def bench():
    return run.manifest()


def _config(name):
    with open(os.path.join(ROOT, "c4bench", "configs", f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name, expect", [
    ("oinkoink-f64", 37_304_064),  # 37.3 MFLOP a board at 64 filters, 6 blocks
    ("alphazero-f256-r19", 1_883_298_816),  # 1.883 GFLOP at 256 filters, 19 blocks
])
def test_tower_flops_by_hand(name, expect):
    assert flops.tower_flops(_config(name)["net"]) == expect


def test_head_flops_by_hand():
    net = _config("oinkoink-f64")["net"]
    value = 42 * 2 * 64 + 6 * 2 * 42 * 42 + 2 * 42
    policy = 42 * 2 * 64 * 2 + 2 * 84 * 7
    assert flops.head_flops(net) == value + policy
    assert flops.evaluations_per_move(_config("oinkoink-f64")["search"]) == 801


def test_manifest_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["c4bench"] and 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("c4bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert _config(c["name"])["name"] == c["name"] and c["reduced"] == []
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    for text in [c["why"] for c in bench["configs"] + bench["workloads"]] + [c["source"] for c in bench["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_configuration_has_a_cell(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_setup_bound_and_budget(bench):
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    # a full check of 24 cells fits the driver's time
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_each_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for n, m in e2e.items() if n != "setup_s")
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell), (m["name"], cell)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") or "_roofline." in m["name"]


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell, cfg, traffic, limits = run.cell_parts(bench, w["name"])
        assert os.path.exists(os.path.join(ROOT, "c4bench", "kinds", f"{traffic['kind']}.py"))
        assert all(isinstance(v, float) and v > 0 for v in limits.values())
    for m in bench["per_layer"]:
        assert callable(run.reader(m["name"]))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for base, _, files in os.walk(os.path.join(ROOT, "c4bench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_jax_anywhere():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "c4bench", "reference")
    for path in _sources():
        if path.startswith(ref):
            assert "connect4_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "connect4_tpu_torch_fake", types.ModuleType("connect4_tpu_torch_fake"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_readers_return_nothing_without_work():
    seg = {"kernel_s": {}, "kernels": 0, "moves": 0, "iterations": 0, "positions": 0, "window_s": 1.0,
           "busy_s": 0.0, "net": _config("oinkoink-f64")["net"], "search": _config("oinkoink-f64")["search"]}
    bench = run.manifest()
    for m in bench["per_layer"]:
        assert run.reader(m["name"])(seg) is None, m["name"]


def test_roofline_and_mfu_arithmetic():
    cfg = _config("alphazero-f256-r19")
    seg = {"kernel_s": {"void tower_kernel_wide<256>(...)": 2.0, "other": 1.0}, "kernels": 3, "moves": 512,
           "iterations": 100, "window_s": 1.5, "busy_s": 1.4, "net": cfg["net"], "search": cfg["search"]}
    bound = 512 * 801 * flops.tower_flops(cfg["net"]) / 989e12
    assert math.isclose(run.reader("tower_roofline")(seg), 100 * bound / 2.0)
    assert math.isclose(run.reader("iteration_ms.selfplay")(seg), 15.0)
    assert math.isclose(run.reader("device_idle_pct.selfplay")(seg), 100 * (1 - 1.4 / 1.5))
    work = 512 * 801 * flops.net_flops(cfg["net"])
    assert math.isclose(run.reader("mfu.selfplay")(seg), 100 * work / (1.5 * 989e12))


class _Event:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, start, dur, device=False, annotation=False):
        import torch

        self._n, self._s, self._d, self._a = name, start, dur, annotation
        self._t = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_trace_summary_busy_idle_and_gaps():
    from c4bench import trace

    events = [
        _Event(trace.SEGMENT, 0, 1000, annotation=True),
        _Event("selfplay.search", 0, 600, annotation=True),
        _Event("selfplay.search", 0, 1000, device=True, annotation=True),  # its span on the card
        _Event("cudaGraphLaunch", 100, 50),
        _Event("aten::item", 650, 300),
        _Event("k1", 100, 200, device=True),
        _Event("k2", 250, 100, device=True),  # overlaps k1: counted once
        _Event("k1", 700, 100, device=True),
        _Event("k0", -50, 100, device=True),  # clipped to the segment
    ]
    s = trace.summary(events)
    assert s["window_s"] == 1000e-9
    assert abs(s["busy_s"] - (50 + 250 + 100) * 1e-9) < 1e-15
    assert abs(s["kernel_s"]["k1"] - 300e-9) < 1e-15 and s["kernels"] == 4
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert abs(sum(gaps.values()) - 600e-9) < 1e-15
    assert abs(gaps["host: - / aten::item"] - 200e-9) < 1e-15  # 450..650 and 800..1000 lie in aten::item or none
