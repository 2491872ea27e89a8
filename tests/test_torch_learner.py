"""The port's train-mode net and learner (``connect4_tpu_torch.models.net``,
``connect4_tpu_torch.training.learner``) against the JAX package's: the same
weights (carried over by ``from_flax`` / ``train_state_from_flax``), the
same momentum and the same batches, made from a seed with numpy.

Tolerances: float32 outputs, parameters and running statistics within 1e-5
(the two sum convolutions and batch moments in different orders), losses
within 1e-6; bf16 within 2e-2 on outputs and 2e-3 on parameters after three
steps (each layer rounds to bf16, and the two round inside a layer at
different points)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from connect4_tpu.config import ModelConfig as JModelConfig
from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.models import init_net as jinit_net
from connect4_tpu.training import learner as jlearner
from connect4_tpu_torch.config import ModelConfig, NetConfig
from connect4_tpu_torch.models.convert import from_flax, train_state_from_flax
from connect4_tpu_torch.training import learner

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)

SMALL = dict(filters=8, n_fc_layers=2, n_residuals=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_INITS = {}  # initialised Flax nets by architecture: the jitted init takes seconds


def _jax_state(kw, seed=0, momentum_scale=0.0, lr=None, **model_kw):
    """A JAX learner with random BatchNorm statistics and, with
    ``momentum_scale``, a random momentum trace: a mid-training state."""
    cfg = JModelConfig(net_config=JNetConfig(**kw), **model_kw)
    if repr(cfg.net_config) not in _INITS:
        _INITS[repr(cfg.net_config)] = jinit_net(cfg.net_config, jax.random.key(0))
    net, var = _INITS[repr(cfg.net_config)]
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: x + rng.uniform(0.1, 0.5, x.shape).astype(np.float32), var["batch_stats"]
    )
    opt = jlearner.make_optimizer(cfg)
    opt_state = opt.init(var["params"])
    if momentum_scale:
        trace = jax.tree_util.tree_map(
            lambda x: jnp.asarray(momentum_scale * rng.standard_normal(x.shape).astype(np.float32)),
            var["params"],
        )
        inner = opt_state[1].inner_state
        inner = (inner[0]._replace(trace=trace),) + tuple(inner[1:])
        opt_state = (opt_state[0], opt_state[1]._replace(inner_state=inner))
    if lr is not None:
        opt_state = jlearner.set_learning_rate(opt_state, lr)
    return cfg, net, opt, jlearner.TrainState(var["params"], stats, opt_state)


def _port_state(cfg, jstate):
    """The port's TrainState from the JAX state's leaves."""
    tcfg = ModelConfig(
        net_config=NetConfig(**vars(cfg.net_config)),
        weight_decay=cfg.weight_decay, momentum=cfg.momentum, initial_lr=cfg.initial_lr,
    )
    hyper = jstate.opt_state[1]
    return train_state_from_flax(
        tcfg, _np_tree(jstate.params), _np_tree(jstate.batch_stats),
        _np_tree(hyper.inner_state[0].trace), float(hyper.hyperparams["learning_rate"]),
        device="cpu",
    )


def _flax_train_forward(net, jstate, x):
    """``((value, prior), new batch_stats)`` of the Flax net in train mode."""
    apply = jax.jit(lambda p, b, x: net.apply(
        {"params": p, "batch_stats": b}, x, train=True, mutable=["batch_stats"]))
    out, mutated = apply(jstate.params, jstate.batch_stats, x)
    return out, mutated["batch_stats"]


def _batch(n, seed, uint8=False):
    rng = np.random.default_rng(seed)
    planes = (rng.random((n, 3, 6, 7)) < 0.3).astype(np.uint8)
    values = rng.choice([0.0, 0.5, 1.0], n).astype(np.float32)
    priors = rng.dirichlet(np.ones(7), n).astype(np.float32)
    weights = np.where(values == 0.5, 4.0, 1.0).astype(np.float32)
    if not uint8:
        planes = np.moveaxis(planes, 1, -1).astype(np.float32)
    return planes, values, priors, weights


def _assert_state_close(tstate, cfg, jstate, atol):
    """Every parameter and running statistic of the port's net against the
    JAX state's, carried over by ``from_flax``."""
    want = from_flax(
        NetConfig(**vars(cfg.net_config)), _np_tree(jstate.params), _np_tree(jstate.batch_stats),
        device="cpu",
    ).state_dict()
    got = tstate.net.state_dict()
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_train_mode_forward_matches_flax(dtype, atol):
    """Value, prior and every new running statistic of one train-mode
    forward against ``net.apply(..., train=True, mutable=['batch_stats'])``:
    float32 within 1e-5; bf16 within 2e-2."""
    kw = dict(SMALL, compute_dtype=dtype)
    cfg, net, _, jstate = _jax_state(kw, seed=1)
    x = _batch(48, 0)[0]
    (jv, jp), new_stats = _flax_train_forward(net, jstate, x)
    tstate = _port_state(cfg, jstate)
    tstate.net.train()
    tv, tp = tstate.net(torch.from_numpy(x))
    tstate.net.eval()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0, atol=atol)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=atol)
    new = jlearner.TrainState(jstate.params, new_stats, jstate.opt_state)
    _assert_state_close(tstate, cfg, new, atol)
    # the statistics moved, and by the biased variance: the unbiased one
    # would leave running_var higher by 0.1 * var / (n - 1), n = 48 * 42
    before = _port_state(cfg, jstate).net.conv_block.bn.running_var
    assert not torch.equal(tstate.net.conv_block.bn.running_var, before)
    # the NCHW entry gives the same numbers as the NHWC one
    tstate.net.eval()
    with torch.no_grad():
        a = tstate.net(torch.from_numpy(x))
        b = tstate.net(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), nchw=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_running_variance_is_the_biased_one():
    """A batch small enough to tell the biased variance (Flax) from the
    unbiased one (``nn.BatchNorm2d``): n = 2 * 42 samples a channel, so the
    two updates differ by 0.1 * var / 83."""
    kw = dict(filters=4, n_fc_layers=1, n_residuals=1)
    cfg, net, _, jstate = _jax_state(kw, seed=2)
    x = _batch(2, 3)[0]
    _, new_stats = _flax_train_forward(net, jstate, x)
    tstate = _port_state(cfg, jstate)
    tstate.net.train()
    tstate.net(torch.from_numpy(x))
    got = tstate.net.conv_block.bn.running_var.numpy()
    want = np.asarray(new_stats["_ConvBlock_0"]["BatchNorm_0"]["var"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    y = torch.nn.functional.conv2d(
        torch.from_numpy(np.moveaxis(x, -1, 1).copy()), tstate.net.conv_block.conv.weight, padding=1)
    unbiased = 0.9 * np.asarray(jstate.batch_stats["_ConvBlock_0"]["BatchNorm_0"]["var"]) \
        + 0.1 * y.var(dim=(0, 2, 3), unbiased=True).detach().numpy()
    assert np.abs(unbiased - want).max() > 1e-5  # the test can tell them apart


_JSTEPS = {}  # jitted JAX steps by configuration: a compilation takes seconds


def _jitted_step(cfg, net, opt, weighted):
    key = (repr(cfg), weighted)
    if key not in _JSTEPS:
        _JSTEPS[key] = jax.jit(jlearner.make_train_step(net, opt, weighted=weighted))
    return _JSTEPS[key]


def _run_steps(cfg, net, opt, jstate, batches, weighted=False):
    """The jitted JAX step and the port's step over ``batches`` from the
    same state; returns both final states and both lists of metrics."""
    jstep = _jitted_step(cfg, net, opt, weighted)
    tstate = _port_state(cfg, jstate)
    tstep = learner.make_train_step(tstate.net, tstate.optimizer, weighted=weighted)
    jm, tm = [], []
    for planes, values, priors, weights in batches:
        extra = (weights,) if weighted else ()
        jstate, m = jstep(jstate, *(jnp.asarray(a) for a in (planes, values, priors) + extra))
        jm.append({k: float(v) for k, v in m.items()})
        m = tstep(*(torch.from_numpy(a) for a in (planes, values, priors) + extra))
        tm.append({k: float(v) for k, v in m.items()})
    return jstate, tstate, jm, tm


@pytest.mark.parametrize("form", ["plain", "weighted", "uint8_nchw"])
@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(form, steps):
    """One and three consecutive SGD steps from equal weights, equal
    (non-zero) momentum and equal batches: losses within 1e-6, every
    parameter and running statistic within 1e-5."""
    cfg, net, opt, jstate = _jax_state(SMALL, seed=3, momentum_scale=0.01)
    batches = [_batch(32, 10 + i, uint8=form == "uint8_nchw") for i in range(steps)]
    jstate, tstate, jm, tm = _run_steps(cfg, net, opt, jstate, batches, weighted=form == "weighted")
    for a, b in zip(jm, tm):
        for k in ("loss", "value_loss", "prior_loss"):
            assert abs(a[k] - b[k]) <= 1e-6, (k, a, b)
    _assert_state_close(tstate, cfg, jstate, 1e-5)
    assert not tstate.net.training  # the step leaves the net in eval mode
    # the momentum buffers too (optax's trace), through the same conversion
    trace = _np_tree(jstate.opt_state[1].inner_state[0].trace)
    want = from_flax(NetConfig(**vars(cfg.net_config)), trace, _np_tree(jstate.batch_stats), device="cpu")
    for p, m in zip(tstate.net.parameters(), want.parameters()):
        buf = tstate.optimizer.state[p]["momentum_buffer"]
        np.testing.assert_allclose(buf.numpy(), m.detach().numpy(), rtol=0, atol=1e-5)


def test_train_steps_match_jax_bf16():
    """Three steps of a bf16 net: losses within 2e-2, parameters and
    running statistics within 2e-3 (the learning rate of 0.01 scales the
    gradients' bf16 differences down)."""
    kw = dict(SMALL, compute_dtype="bfloat16")
    cfg, net, opt, jstate = _jax_state(kw, seed=4, momentum_scale=0.01)
    batches = [_batch(32, 20 + i) for i in range(3)]
    jstate, tstate, jm, tm = _run_steps(cfg, net, opt, jstate, batches)
    for a, b in zip(jm, tm):
        assert abs(a["loss"] - b["loss"]) <= 2e-2, (a, b)
    _assert_state_close(tstate, cfg, jstate, 2e-3)


def test_weighted_ones_and_uint8_forms_are_the_plain_step():
    """As in the JAX package: all-ones weights reproduce the unweighted
    step and uint8 NCHW batches the float NHWC step, bit for bit; a
    non-uniform weighting changes the value loss only."""
    cfg, _, _, jstate = _jax_state(dict(filters=4, n_fc_layers=1, n_residuals=1), seed=5)
    planes_u8, values, priors, weights = (torch.from_numpy(a) for a in _batch(16, 1, uint8=True))
    planes = planes_u8.permute(0, 2, 3, 1).float()
    results = []
    for args, weighted in (
        ((planes, values, priors), False),
        ((planes, values, priors, torch.ones(16)), True),
        ((planes_u8, values, priors), False),
        ((planes, values, priors, weights), True),
    ):
        st = _port_state(cfg, jstate)
        m = learner.make_train_step(st.net, st.optimizer, weighted=weighted)(*args)
        results.append((st.net.state_dict(), m))
    base_sd, base_m = results[0]
    for sd, m in results[1:3]:
        assert all(torch.equal(sd[k], base_sd[k]) for k in base_sd)
        assert float(m["loss"]) == float(base_m["loss"])
    _, m3 = results[3]
    assert float(m3["prior_loss"]) == float(base_m["prior_loss"])
    assert float(m3["value_loss"]) != float(base_m["value_loss"])


def test_bce_loss_matches_jax_with_exact_zero_and_one():
    """Forward values including probabilities of exactly 0 and 1, where the
    logarithm is clamped at -100: within 1e-6 of the JAX loss."""
    rng = np.random.default_rng(0)
    probs = rng.random((16, 7)).astype(np.float32)
    targets = rng.dirichlet(np.ones(7), 16).astype(np.float32)
    probs[0, 0], probs[1, 1], probs[2, 2] = 0.0, 1.0, 1e-30
    targets[0, 0], targets[1, 1] = 0.3, 0.6
    want = float(jlearner.bce_loss(jnp.asarray(probs), jnp.asarray(targets)))
    got = float(learner.bce_loss(torch.from_numpy(probs), torch.from_numpy(targets)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    assert got > 1.0  # the clamped terms are in the mean: 100 * 0.3 / 112 at least


def test_learning_rate_schedule_and_set_learning_rate():
    """``lr_at_generation`` equals the JAX schedule, and
    ``set_learning_rate`` changes the next step: from equal states a step at
    a tenth of the rate moves every parameter a tenth as far."""
    tcfg, jcfg = ModelConfig(milestones=(3, 5)), JModelConfig(milestones=(3, 5))
    for gen in range(1, 8):
        assert tcfg.lr_at_generation(gen) == jcfg.lr_at_generation(gen)
    cfg, net, opt, jstate = _jax_state(SMALL, seed=6)
    batch = tuple(torch.from_numpy(a) for a in _batch(32, 2)[:3])
    moved = []
    for lr in (0.01, 0.001):
        st = _port_state(cfg, jstate)
        before = [p.detach().clone() for p in st.net.parameters()]
        learner.set_learning_rate(st.optimizer, lr)
        learner.make_train_step(st.net, st.optimizer)(*batch)
        moved.append([p.detach() - b for p, b in zip(st.net.parameters(), before)])
    for a, b in zip(*moved):
        # a move is a difference of two float32 parameters of size ~0.5: 6e-8 a unit
        np.testing.assert_allclose(b.numpy(), 0.1 * a.numpy(), rtol=1e-4, atol=1e-7)
    # and against the JAX step at the changed rate
    jstate2 = jstate._replace(opt_state=jlearner.set_learning_rate(jstate.opt_state, 0.001))
    jstate2, tstate, _, _ = _run_steps(cfg, net, opt, jstate2, [_batch(32, 2)])
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(0.001)
    _assert_state_close(tstate, cfg, jstate2, 1e-5)


def test_epoch_pass_with_tail_batch_matches_jax():
    """A whole ``_train``-style pass, two epochs over 150 rows at batch 64
    (two full batches and a tail of 22, ``drop_last=False``), with the
    epoch orders injected: the port's gather and step against the JAX
    gather and step, every parameter and running statistic within 1e-5."""
    cfg, net, opt, jstate = _jax_state(SMALL, seed=7)
    n, bs = 150, 64
    planes, values, priors, _ = _batch(n, 30, uint8=True)
    rng = np.random.default_rng(8)
    orders = [rng.permutation(n).astype(np.int32) for _ in range(2)]
    n_full = (n // bs) * bs

    jstep = _jitted_step(cfg, net, opt, False)
    jarrays = tuple(jnp.asarray(a) for a in (planes, values, priors))
    jgather, jtail = jlearner.make_batch_gather(bs), jlearner.make_batch_gather(n - n_full)
    tstate = _port_state(cfg, jstate)
    tstep = learner.make_train_step(tstate.net, tstate.optimizer)
    tarrays = tuple(torch.from_numpy(a) for a in (planes, values, priors))
    tgather, ttail = learner.make_batch_gather(bs), learner.make_batch_gather(n - n_full)
    jl, tl = [], []
    for order in orders:
        jo, to = jnp.asarray(order), torch.from_numpy(order).long()
        for i in range(0, n_full, bs):
            jstate, m = jstep(jstate, *jgather(jarrays, jo, np.int32(i)))
            jl.append(float(m["loss"]))
            tl.append(float(tstep(*tgather(tarrays, to, i))["loss"]))
        jstate, m = jstep(jstate, *jtail(jarrays, jo, np.int32(n_full)))
        jl.append(float(m["loss"]))
        batch = ttail(tarrays, to, n_full)
        assert len(batch[1]) == n - n_full
        tl.append(float(tstep(*batch)["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    _assert_state_close(tstate, cfg, jstate, 1e-5)


def test_model_can_overfit_a_tiny_batch():
    """As the JAX package's overfit test: a few hundred steps on 8 fixed
    positions drive the loss far below where it began."""
    cfg = ModelConfig(net_config=NetConfig(filters=8, n_fc_layers=1, n_residuals=1), initial_lr=0.05)
    state = learner.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = learner.make_train_step(state.net, state.optimizer)
    planes, values, _, _ = (torch.from_numpy(a) for a in _batch(8, 40))
    priors = torch.nn.functional.one_hot(torch.arange(8) % 7, 7).float()
    first = float(step(planes, values, priors)["loss"])
    for _ in range(300):
        last = step(planes, values, priors)
    assert float(last["loss"]) < 0.25 * first
    value, prior = learner.make_eval_fn(state.net)(planes)
    assert (prior.argmax(-1) == torch.arange(8) % 7).all()
