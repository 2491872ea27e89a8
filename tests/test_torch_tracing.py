"""Tests of the port's tracing layer (``connect4_tpu_torch.launches``) on
the CPU: the search's and the learner's spans, the search's evaluations
counted by class, the switch, the counters' registry, and the card's time
by span read from a trace (``scripts._common.span_times``) on a synthetic
one. Marks on the card and CUDA graphs are held in ``test_torch_gpu.py``."""

import importlib.util
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from connect4_tpu_torch import launches
from connect4_tpu_torch.config import MCTSConfig, ModelConfig, NetConfig
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
from connect4_tpu_torch.mcts import batched
from connect4_tpu_torch.models.net import init_net
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.training.learner import init_train_state, make_train_step

ROWS = 6
# (K, simulations): four iterations of eight walkers, and twelve of one
SEARCHES = [(8, 32), (1, 12)]


@pytest.fixture
def tracing_on():
    previous = launches.tracing(True)
    yield
    launches.tracing(previous)


def _roots():
    """Live mid-game boards: their trees reach terminal nodes."""
    return _common.live_boards_at_ply(16, ROWS, torch.Generator().manual_seed(3), "cpu")


def _host_spans(fn):
    """``(name, start, end)`` of every span's host range that ``fn()`` opens,
    in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.start, e.time_range.end) for e in events if e.name in launches.SPANS]


@pytest.mark.parametrize("tracing", [False, True])
@pytest.mark.parametrize("k, sims", SEARCHES)
def test_search_spans_partition_each_iteration(k, sims, tracing):
    """``search.init``, then the phases of every iteration in partition
    order, each ending before the next begins, then ``search.finish``: host
    ranges, whatever the switch says."""
    search = batched.Search(centre_evaluator_batched, MCTSConfig(simulations=sims, parallel_sims=k), graphs=False)
    roots = _roots()
    previous = launches.tracing(tracing)
    try:
        spans = _host_spans(lambda: search(roots, torch.Generator().manual_seed(0)))
    finally:
        launches.tracing(previous)
    assert [n for n, _, _ in spans] == ["search.init", *launches.SEARCH_PHASES * (sims // k), "search.finish"]
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start


@pytest.mark.parametrize("idle_rows", [0, 2])
@pytest.mark.parametrize("k, sims", SEARCHES)
def test_eval_counters_classify_every_board(tracing_on, k, sims, idle_rows):
    """The boards handed to the evaluator are the roots and K a row an
    iteration, each in one class; inactive rows are idle, and the useful
    ones are exactly the nodes the search marked evaluated (less the
    inactive roots, which the root's evaluation marks too)."""
    search = batched.Search(centre_evaluator_batched, MCTSConfig(simulations=sims, parallel_sims=k), graphs=False)
    active = torch.arange(ROWS) >= idle_rows
    launches.reset_counters()
    res = search(_roots(), torch.Generator().manual_seed(0), active)
    evals = launches.counters()["evals"]
    iterations = sims // k
    assert set(evals) == set(batched.EVAL_CLASSES)
    assert sum(evals.values()) == ROWS + iterations * ROWS * k
    assert evals["idle"] == idle_rows * (1 + iterations * k)
    assert evals["useful"] == int(res.tree.evaluated.sum()) - idle_rows
    assert evals["terminal"] > 0
    assert (evals["repeat"] > 0) == (k > 1)


@pytest.mark.parametrize("k, sims", SEARCHES)
def test_tracing_off_counts_nothing(k, sims):
    """With tracing off the search updates no counter and launches no
    mark; the same search with it on updates once a search and once an
    iteration."""
    search = batched.Search(centre_evaluator_batched, MCTSConfig(simulations=sims, parallel_sims=k), graphs=False)
    assert not launches.traced()
    launches.reset_counters()
    marks, updates = dict(launches.MARKS), dict(launches.UPDATES)
    search(_roots(), torch.Generator().manual_seed(0))
    assert launches.counters()["evals"] == dict.fromkeys(batched.EVAL_CLASSES, 0)
    assert launches.MARKS == marks and launches.UPDATES == updates
    previous = launches.tracing(True)
    try:
        search(_roots(), torch.Generator().manual_seed(0))
    finally:
        launches.tracing(previous)
    assert launches.UPDATES.get("evals", 0) == updates.get("evals", 0) + 1 + sims // k
    assert launches.MARKS == marks  # no mark on the CPU


def test_net_evaluator_stages_compose_to_the_evaluator():
    """The search marks where the heads begin: the net evaluator's two
    stages give what the evaluator gives, bit for bit."""
    net = init_net(NetConfig(filters=16, n_fc_layers=2, n_residuals=2, compute_dtype="bfloat16"),
                   torch.Generator().manual_seed(0), device="cpu")
    evaluate = make_net_evaluator(net)
    trunk, heads = evaluate.stages
    roots = _roots()
    for got, want in zip(heads(trunk(roots)), evaluate(roots)):
        assert torch.equal(got, want)


def test_learner_step_holds_forward_backward_optimizer():
    """A train step is ``learner.step`` holding its three parts in order."""
    config = ModelConfig(net_config=NetConfig(filters=8, n_fc_layers=1, n_residuals=1))
    state = init_train_state(config, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(state.net, state.optimizer)
    g = torch.Generator().manual_seed(1)
    planes = torch.randint(0, 2, (16, 3, 6, 7), generator=g, dtype=torch.uint8)
    values = torch.rand(16, generator=g)
    priors = torch.softmax(torch.randn(16, 7, generator=g), -1)
    spans = _host_spans(lambda: step(planes, values, priors))
    assert [n for n, _, _ in spans] == list(launches.LEARNER_PARTS)
    (_, lo, hi), *parts = spans
    for (_, a, b), (_, c, _) in zip(parts, parts[1:] + [("", hi, hi)]):
        assert lo <= a <= b <= c <= hi


def test_counters_sum_by_name_reset_and_forget_the_dead(tracing_on):
    a = launches.Counter("test.pair", ("x", "y"), "cpu")
    b = launches.Counter("test.pair", ("x", "y"), "cpu")
    launches.tally(a, torch.tensor([0, 1, 1]))
    launches.tally(b, torch.tensor([[1]]))
    assert launches.counters()["test.pair"] == {"x": 1, "y": 3}
    del b
    assert launches.counters()["test.pair"] == {"x": 1, "y": 2}
    launches.reset_counters()
    assert launches.counters()["test.pair"] == {"x": 0, "y": 0}
    launches.tracing(False)
    launches.tally(a, torch.tensor([0]))
    assert launches.counters()["test.pair"] == {"x": 0, "y": 0}


def test_phases_are_spans_inside_a_partition_only():
    """A phase ends the one before it and the partition ends the last; a
    phase outside a partition (a part of an iteration run on its own) is no
    span; a name outside ``SPANS`` raises."""
    for bad in (lambda: launches.phase("no.such.span"), lambda: launches.span("no.such.span", "cpu").__enter__()):
        with pytest.raises(KeyError):
            bad()

    def run():
        launches.phase("search.backup")
        with launches.partition("cpu"):
            launches.phase("search.descend")
            launches.phase("search.fanout")

    assert [n for n, _, _ in _host_spans(run)] == ["search.descend", "search.fanout"]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_span_times_attributes_replays_by_mark_and_the_rest_by_host_range():
    """A graph replay's kernels go to the span of the mark before them (the
    closing mark to the span it closes), those of a replay before any mark
    to none; eager kernels go to the innermost span whose host range holds
    their launch, on whatever thread the launch was."""
    kernel = "kernel"
    events = [
        _x("user_annotation", "selfplay.search", 0, 100),
        _x("cuda_runtime", "cudaGraphLaunch", 10, 5, correlation=1),
        _x(kernel, "void span_mark<1>()", 20, 1, stream=7, correlation=1),
        _x(kernel, "descent_kernel", 21, 4, stream=7, correlation=1),
        _x(kernel, "void span_mark<2>()", 26, 1, stream=7, correlation=1),
        _x(kernel, "argmax", 28, 2, stream=7, correlation=1),
        _x(kernel, "void span_mark<0>()", 31, 1, stream=7, correlation=1),
        _x("cuda_runtime", "cudaGraphLaunch", 50, 5, correlation=2),
        _x(kernel, "orphan", 60, 1, stream=7, correlation=2),
        _x("user_annotation", "learner.step", 200, 100),
        _x("user_annotation", "learner.backward", 220, 60),
        _x("cuda_runtime", "cudaLaunchKernel", 230, 2, tid=2, correlation=10),  # autograd's thread
        _x(kernel, "conv_bw", 240, 10, stream=7, correlation=10),
        _x("cuda_runtime", "cudaLaunchKernel", 290, 2, correlation=11),
        _x(kernel, "stack", 291, 4, stream=7, correlation=11),
        _x("cuda_runtime", "cudaLaunchKernel", 350, 2, correlation=12),
        _x("gpu_memset", "Memset", 352, 1, stream=7, correlation=12),
    ]
    got = _common.span_times(events)
    s = got["spans"]
    assert s["search.descend"] == pytest.approx(
        {"calls": 1, "busy_ms": 0.005, "marked_ms": 0.006, "gap_ms": 0.0, "host_ms": 0.0, "wait_ms": 0.0})
    assert s["search.fanout"] == pytest.approx(
        {"calls": 1, "busy_ms": 0.004, "marked_ms": 0.005, "gap_ms": 0.002, "host_ms": 0.0, "wait_ms": 0.0})
    assert s["learner.backward"]["busy_ms"] == pytest.approx(0.010)
    assert s["learner.step"] == pytest.approx(
        {"calls": 1, "busy_ms": 0.004, "marked_ms": 0.0, "gap_ms": 0.0, "host_ms": 0.1, "wait_ms": 0.086})
    assert s["selfplay.search"]["busy_ms"] == 0.0 and s["selfplay.search"]["calls"] == 1
    assert got["unattributed_replayed"] == 1
    assert got["busy_ms"] == pytest.approx(0.025) and got["attributed_ms"] == pytest.approx(0.023)
    # the same trace cut to a window: what lies outside is left out
    cut = _common.span_times(events, (0.0, 100.0))
    assert cut["busy_ms"] == pytest.approx(0.010) and cut["spans"]["learner.step"]["calls"] == 0


def _trace_cells_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "trace_cells_gpu.py")
    spec = importlib.util.spec_from_file_location("trace_cells_gpu", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_trace_cells_tool_reads_raw_profiler_events():
    """``scripts/trace_cells_gpu.py`` turns the raw events of the
    benchmark's profiled segment into the trace ``span_times`` reads: on a
    CPU search, every iteration's phases with their host times; without a
    card the tool itself refuses to run."""
    from torch.autograd import profiler

    tool = _trace_cells_tool()
    search = batched.Search(centre_evaluator_batched, MCTSConfig(simulations=32, parallel_sims=8), graphs=False)
    prof = profiler.profile(use_kineto=True)
    prof._prepare_trace()
    prof._start_trace()
    search(_roots(), torch.Generator().manual_seed(0))
    events = torch.autograd._disable_profiler().events()
    times = _common.span_times(tool.chrome_events(events))
    assert [times["spans"][n]["calls"] for n in launches.SEARCH_PHASES] == [4] * 5
    assert times["spans"]["search.init"]["calls"] == 1 and times["spans"]["search.tower"]["host_ms"] > 0
    assert times["busy_ms"] is None  # no card
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            tool.main(["--workload", "f64-selfplay"])
