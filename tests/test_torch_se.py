"""The squeeze-and-excitation body (``config.SENetConfig``: Leela Chess
Zero's, lczero-training ``tf/tfprocess.py``) held on the CPU to its plain
float32 reference, ``connect4_tpu_torch/reference/lc0_se_resnet.py``, at a
small size (32 filters, two blocks, a squeeze of 4): the evaluator's folded
bf16 tower and the float32 paths, the learner's loss, gradients and SGD
step, the fused BatchNorm wiring through the pair's plain version, two
gloo ranks against one process; the kernel's order of the gate's sums as
the plain version emulates it; and what must raise. The JAX package has no
such net, so nothing here imports it."""

import copy
import dataclasses
import os
import re
import time

import pytest
import torch
import torch.multiprocessing as tmp

from connect4_tpu_torch.config import ModelConfig, NetConfig, SENetConfig, net_config_from_dict
from connect4_tpu_torch.env.core import initial_state, legal_moves, step, to_planes
from connect4_tpu_torch.eval.evaluators import make_net_evaluator
from connect4_tpu_torch.models import batch_norm as B
from connect4_tpu_torch.models import net as netmod
from connect4_tpu_torch.models import se_gate as G
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.models.convert import from_flax, to_flax
from connect4_tpu_torch.models.net import fold_bn_params, inference_net, init_net, se_gate
from connect4_tpu_torch.reference import lc0_se_resnet as R
from connect4_tpu_torch.training.learner import init_train_state, make_optimizer, make_train_step

torch.set_num_threads(1)

SMALL = dict(filters=32, n_fc_layers=2, n_residuals=2, se_ratio=8)


def _states(n, seed):
    """``n`` positions of seeded random play, 0..29 plies each."""
    g = torch.Generator().manual_seed(seed)
    state = initial_state((n,), device="cpu")
    plies = torch.randint(0, 30, (n,), generator=g)
    for t in range(30):
        legal = legal_moves(state)
        weights = torch.where(legal.any(-1, keepdim=True), legal.float(), 1.0)
        state = step(state, torch.multinomial(weights, 1, generator=g)[:, 0], t < plies)
    return state


def _net(seed, dtype="float32", **kw):
    """A seeded SE net with its BatchNorm statistics, shifts and biases
    moved off their initial values (so that no gate is symmetric)."""
    net = init_net(SENetConfig(**{**SMALL, **kw}, compute_dtype=dtype), torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith(("bias", "running_mean")):
                t.add_(0.1 * torch.randn(t.shape, generator=g))
            elif name.endswith("running_var"):
                t.mul_(1.0 + 0.5 * torch.rand(t.shape, generator=g))
    return net


def _weights(net):
    return {k: v.detach().float().clone() for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}


def _fp8(w):
    """Every conv and Dense kernel rounded to float8 e4m3, a per-tensor
    scale mapping its largest magnitude to 448: the control each tolerance
    must refuse."""
    out = dict(w)
    for k, v in w.items():
        if k.endswith("weight") and v.dim() >= 2:
            s = 448.0 / v.abs().amax()
            out[k] = (v * s).to(torch.float8_e4m3fn).float() / s
    return out


def _batch(n, seed):
    state = _states(n, seed)
    g = torch.Generator().manual_seed(seed + 7)
    values = torch.randint(0, 3, (n,), generator=g).float() / 2
    priors = torch.softmax(torch.randn((n, 7), generator=g), -1)
    return to_planes(state).to(torch.uint8), values, priors


def test_config_is_a_subclass_and_round_trips():
    """``SENetConfig`` adds ``se_ratio`` to ``NetConfig`` without touching
    its fields (which the tests against the JAX package hold); a stored
    config comes back as the class it was; a ratio must divide the width."""
    se = SENetConfig(**SMALL)
    assert isinstance(se, NetConfig) and netmod.is_se(se) and not netmod.is_se(NetConfig())
    assert [f.name for f in dataclasses.fields(NetConfig)] == [
        "channels", "filters", "n_fc_layers", "n_residuals", "compute_dtype"]
    assert net_config_from_dict(dataclasses.asdict(se)) == se
    assert type(net_config_from_dict(dataclasses.asdict(NetConfig()))) is NetConfig
    with pytest.raises(ValueError, match="se_ratio"):
        SENetConfig(filters=30, se_ratio=8)


def test_checkpoint_of_an_se_net_loads_as_one(tmp_path):
    from connect4_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint

    state = init_train_state(ModelConfig(net_config=SENetConfig(**SMALL)), torch.Generator().manual_seed(0), "cpu")
    save_checkpoint(str(tmp_path), 1, state, torch.Generator().manual_seed(1))
    loaded, _ = restore_checkpoint(str(tmp_path), 1, None, device="cpu")
    assert loaded.net.config == state.net.config
    for (k, v), w in zip(state.net.state_dict().items(), loaded.net.state_dict().values()):
        assert torch.equal(v, w), k


def test_leaves_are_the_port_state_dict():
    """The reference's leaves are the port's state-dict entries, in order:
    each block holds its gate's two Dense layers (32 -> 4 -> 64)."""
    net = _net(0)
    got = [(k, tuple(v.shape)) for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")]
    assert got == list(R.leaves(3, 32, 2, 2, 8).items())
    assert dict(got)["res_blocks.1.se.fc1.weight"] == (4, 32) and dict(got)["res_blocks.1.se.fc2.weight"] == (64, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_paths_equal_the_reference(seed):
    """The eval-mode net, the folded ``InferenceNet`` and the evaluator's
    float32 route within 2e-6 of the reference's forward (float32 sums
    in other orders), and training mode's batch statistics too."""
    net = _net(seed)
    state = _states(64, seed)
    planes = to_planes(state).float()
    vr, pr = R.forward(_weights(net), planes, 2, 2)
    with torch.no_grad():
        outs = [net.eval()(planes, nchw=True), inference_net(net)(planes.permute(0, 2, 3, 1)),
                make_net_evaluator(net)(state)]
    for v, p in outs:
        assert (v - vr).abs().max().item() <= 2e-6 and (p - pr).abs().max().item() <= 2e-6
    vt, pt = R.forward(_weights(net), planes, 2, 2, train=True)
    with torch.no_grad():
        v, p = copy.deepcopy(net).train()(planes, nchw=True)
    assert (v - vt).abs().max().item() <= 2e-6 and (p - pt).abs().max().item() <= 2e-6


def test_folded_bf16_tower_against_the_reference():
    """The evaluator of a bf16 net runs the folded tower's plain version
    (``tower_plain``, what the card's kernel is held to) with the gate in
    float32. Against the float32 reference its value is within 3e-3 and
    its prior within 2e-3 at 256 positions: a bf16 tower of two blocks
    reads up to 1.4e-3 and 1.1e-3 over four seeds. The reference with its
    kernels in float8 e4m3 reads 7e-3 to 1e-2 in the value, and fails. The
    emulation of the kernel's order (``tensor_core=True``) agrees with it."""
    net = _net(0, "bfloat16")
    w = _weights(net)
    state = _states(256, 100)
    planes = to_planes(state).float()
    v, p = make_net_evaluator(net)(state)
    vr, pr = R.forward(w, planes, 2, 2)
    assert (v - vr).abs().max().item() <= 3e-3 and (p - pr).abs().max().item() <= 2e-3
    v8, p8 = R.forward(_fp8(w), planes, 2, 2)
    assert (v8 - vr).abs().max().item() > 3e-3 or (p8 - pr).abs().max().item() > 2e-3
    packed = tower.pack_weights(net.config, fold_bn_params(net))
    x2d = tower.input_rows(planes.permute(0, 2, 3, 1)[:32])
    vt, pt = tower.heads(packed, tower.tower_plain(packed, x2d, tensor_core=True))
    assert (vt - vr[:32]).abs().max().item() <= 3e-3 and (pt - pr[:32]).abs().max().item() <= 2e-3


def test_train_loss_gradients_and_sgd_steps_equal_the_reference():
    """The learner's step on the CPU (float32) against the reference's
    autograd: the first loss within 1e-6 and every gradient within 1e-5 of
    the largest of its leaf, or 1e-7 where a leaf's gradient is rounding
    alone (a conv bias before a BatchNorm; read from the momentum buffer
    after one step, which holds the gradient plus the weight decay), and
    three SGD steps' losses within 1e-5 and weights within 1e-5. Float8 kernels move the
    first loss by more than 1e-4."""
    net = _net(2)
    w0 = _weights(net)
    batches = [_batch(128, 30 + i) for i in range(3)]
    config = ModelConfig(net_config=net.config)
    state = type(init_train_state(config, torch.Generator().manual_seed(0), "cpu"))(net, make_optimizer(config, net))
    step = make_train_step(state.net, state.optimizer)
    loss0, grads = R.gradients(w0, *(t.float() for t in batches[0]), 2, 2)
    losses = [float(step(*batches[0])["loss"])]
    assert abs(losses[0] - loss0) <= 1e-6
    for k, p in state.net.named_parameters():
        got = state.optimizer.state[p]["momentum_buffer"] - config.weight_decay * w0[k]
        assert (got - grads[k]).abs().max().item() <= max(1e-5 * grads[k].abs().max().item(), 1e-7), k
    losses += [float(step(*b)["loss"]) for b in batches[1:]]
    r_losses, r_after = R.sgd_steps(w0, [tuple(t.float() for t in b) for b in batches], 2, 2,
                                    config.initial_lr, config.momentum, config.weight_decay)
    assert max(abs(a - b) for a, b in zip(losses, r_losses)) <= 1e-5
    for k, p in state.net.named_parameters():
        assert (p.detach() - r_after[k]).abs().max().item() <= 1e-5, k
    assert abs(R.gradients(_fp8(w0), *(t.float() for t in batches[0]), 2, 2)[0] - loss0) > 1e-4


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_wiring_of_the_se_net_equals_the_plain_net(monkeypatch, compute_dtype):
    """The train-mode SE net wired as on the card (every BatchNorm through
    ``batch_norm_act``, here its plain version: ReLU, and no activation
    before the gate, whose float32 output it takes) against the same net
    through ``_bn`` and ``torch.relu``: outputs and gradients within 1e-5
    in float32 (2e-2 in bf16, whose rounding points differ); the
    arguments the net hands the unchecked entry pass the checks."""
    planes, values, priors = _batch(64, 5)
    out = {}
    for fused in (False, True):
        net = _net(4, compute_dtype).train()
        with monkeypatch.context() as m:
            if fused:
                m.setattr(netmod, "_fused", lambda planes, training, mesh: training)
                unchecked = B.batch_norm_act_unchecked

                def checked(x, bn, skip=None, stream=False, act="leaky"):
                    assert act in ("relu", "none", "leaky")
                    B._check(x, skip, bn.weight, bn.bias, bn.running_mean, bn.running_var)
                    return unchecked(x, bn, skip, stream, act)
                m.setattr(B, "batch_norm_act_unchecked", checked)
            v, p = net(planes.float(), nchw=True)
            ((v - values) ** 2).mean().add(-(priors * torch.log(p)).mean()).backward()
        out[fused] = (v.detach(), p.detach(), {k: q.grad.clone() for k, q in net.named_parameters()})
    tol = 1e-5 if compute_dtype == "float32" else 2e-2
    for a, b in zip(out[False][:2], out[True][:2]):
        assert (a - b).abs().max().item() <= tol
    for k, g in out[False][2].items():
        assert (g - out[True][2][k]).abs().max().item() <= tol * max(g.abs().max().item(), 1.0), k


@pytest.mark.parametrize("act", ["relu", "none"])
def test_batch_norm_act_plain_at_relu_and_none(act):
    """The pair's plain version at ReLU and at no activation against
    autograd through ``F.batch_norm`` and the activation, float32: outputs,
    the gradients of x, scale, bias and skip within 1e-5, and the running
    statistics moved as the net's ``_bn`` moves them (relative to the
    largest magnitude where it is above 1: a scale's gradient sums 2,688
    rows). Another name raises."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 8, 6, 7, generator=g).contiguous(memory_format=torch.channels_last)
    skip = torch.randn(64, 8, 6, 7, generator=g).contiguous(memory_format=torch.channels_last)
    gy = torch.randn(64, 8, 6, 7, generator=g)
    bn = torch.nn.BatchNorm2d(8).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0, 0.2, generator=g)
    ref_bn = copy.deepcopy(bn)
    xa, sa = x.clone().requires_grad_(True), skip.clone().requires_grad_(True)
    y, _ = B.batch_norm_act(xa, bn, sa, act=act)
    (y * gy).sum().backward()
    xb, sb = x.clone().requires_grad_(True), skip.clone().requires_grad_(True)
    pre = netmod._bn(xb, ref_bn) + sb
    yb = torch.relu(pre) if act == "relu" else pre
    (yb * gy).sum().backward()
    assert (y - yb).abs().max().item() <= 1e-5
    for a, b in ((xa.grad, xb.grad), (sa.grad, sb.grad), (bn.weight.grad, ref_bn.weight.grad),
                 (bn.bias.grad, ref_bn.bias.grad), (bn.running_mean, ref_bn.running_mean),
                 (bn.running_var, ref_bn.running_var)):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())
    with pytest.raises(ValueError, match="act"):
        B.batch_norm_act(x, bn, act="gelu")


def _dp_rank(rank, init_file, out_file, batches):
    torch.set_num_threads(1)
    from connect4_tpu_torch.parallel import mesh as pmesh
    from connect4_tpu_torch.parallel.sharded import make_sharded_train_step

    pmesh.initialize_distributed("gloo", "cpu", init_method=f"file://{init_file}", rank=rank, world_size=2)
    mesh = pmesh.make_mesh((2,), "cpu")
    net = _net(6)
    config = ModelConfig(net_config=net.config)
    optimizer = make_optimizer(config, net)
    step = make_sharded_train_step(net, optimizer, mesh)
    losses = [float(step(*b)["loss"]) for b in batches]
    torch.save((losses, {k: v.clone() for k, v in net.state_dict().items()}), f"{out_file}.{rank}")
    torch.distributed.destroy_process_group()


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """Two data-parallel SGD steps of the SE net on two gloo ranks (each
    BatchNorm over the global batch by all-reduce; the gate is per board
    and needs none) against the same steps in one process: the ranks'
    states equal each other bit for bit, and losses and state are within
    1e-5 of one process's (the all-reduced sums add in another order)."""
    batches = [_batch(64, 50 + i) for i in range(2)]
    out = str(tmp_path / "out")
    ranks = tmp.spawn(_dp_rank, args=(str(tmp_path / "init"), out, batches), nprocs=2, join=False,
                      start_method="spawn")
    net = _net(6)
    config = ModelConfig(net_config=net.config)
    step = make_train_step(net, make_optimizer(config, net))
    want = [float(step(*b)["loss"]) for b in batches]
    deadline = time.monotonic() + 300
    while not ranks.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ranks.processes:
                p.kill()
            pytest.fail("the ranks did not finish within 300 s")
    (l0, s0), (l1, s1) = (torch.load(f"{out}.{r}") for r in range(2))
    assert l0 == l1 and max(abs(a - b) for a, b in zip(l0, want)) <= 1e-5
    for k, v in net.state_dict().items():
        assert torch.equal(s0[k], s1[k]), k
        assert (s0[k].float() - v.float()).abs().max().item() <= 1e-5, k


def test_the_kernel_order_of_the_gate_sums_what_se_gate_sums():
    """The plain version's emulation of the kernel's gate: the pool in the
    kernel's tree (``_pool_kernel_order``, boards in tiles of three over
    eight warps) is each board's sum over its 42 cells within float32
    rounding, whatever the batch (a last tile of 1, 2 or 3 boards), and the
    whole gate (``_se_kernel_order``) is ``se_gate`` within 1e-5; the
    padded squeeze and channels add nothing."""
    g = torch.Generator().manual_seed(9)
    for b in (1, 2, 3, 7):
        y = torch.randn(b, 42, 256, generator=g)
        got = tower._pool_kernel_order(y)
        assert got.shape == (b, 256)
        assert torch.allclose(got, y.double().sum(1).float(), rtol=0, atol=1e-4)
    net = _net(8, "bfloat16", filters=40, se_ratio=8)  # 40 filters -> 64 packed, a squeeze of 5 -> 8
    packed = tower.pack_weights(net.config, fold_bn_params(net))
    assert packed["se_w1"].shape == (2, 8, 64) and packed["se_w2"].shape == (2, 128, 8)
    y = torch.randn(5, 42, 64, generator=g)
    x = torch.relu(torch.randn(5, 42, 64, generator=g)).to(torch.bfloat16)
    y[..., 40:] = 0
    x[..., 40:] = 0
    gate = tuple(packed[k][1] for k in ("se_w1", "se_b1", "se_w2", "se_b2"))
    got = tower._se_kernel_order(y, x, *gate)
    want = se_gate(y.permute(0, 2, 1).reshape(5, 64, 6, 7), x.permute(0, 2, 1).reshape(5, 64, 6, 7), *gate)[0]
    assert (got - want.reshape(5, 64, 42).permute(0, 2, 1)).abs().max().item() <= 1e-5
    assert not got[..., 40:].any()


def test_gate_backward_is_its_forwards_gradient():
    """The gate's plain version's written-out backward (``_GatePlain``) against
    numerical gradients in float64, and the gradient of its copy in another
    type added to the output's."""
    g = torch.Generator().manual_seed(4)

    def leaf(*shape, nhwc=False):
        t = torch.randn(*shape, generator=g, dtype=torch.float64)
        return (t.contiguous(memory_format=torch.channels_last) if nhwc else t).requires_grad_(True)

    inputs = (leaf(3, 8, 6, 7, nhwc=True), leaf(3, 8, 6, 7, nhwc=True), leaf(2, 8), leaf(2), leaf(16, 2), leaf(16))
    assert torch.autograd.gradcheck(lambda *a: G._GatePlain.apply(*a, torch.float64), inputs)
    assert torch.autograd.gradcheck(lambda *a: G._GatePlain.apply(*a, torch.float32)[0], inputs)
    out, copy_ = G._GatePlain.apply(*inputs, torch.float32)
    assert out.dtype == torch.float64 and copy_.dtype == torch.float32
    (out.sum() + 2 * copy_.sum()).backward()  # the copy's gradient joins the output's
    grads = [t.grad.clone() for t in inputs]
    for t in inputs:
        t.grad = None
    (3 * G._GatePlain.apply(*inputs, torch.float64)).sum().backward()
    assert all(torch.allclose(a, t.grad) for a, t in zip(grads, inputs))


def test_se_scratch_fits_the_wide_kernels_tile():
    """The gate's scratch (``tower.se_scratch``, ``SeScratch`` in the
    source) fits the odd layer's Y tile at both wide widths, at the squeeze
    the kernel is built for; ``SE_CHUNKS`` and ``SE_WIDTH`` are the
    source's."""
    with open(tower.SOURCE) as fh:
        src = fh.read()
    assert tower.SE_CHUNKS == int(re.search(r"constexpr int kSeChunks = (\d+);", src).group(1))
    assert tower.SE_WIDTH == {128: int(re.search(r"constexpr int kSeWidth128 = (\d+);", src).group(1)),
                              256: int(re.search(r"constexpr int kSeWidth256 = (\d+);", src).group(1))}
    for fp, want in ((128, 18624), (256, 37248)):
        plan = tower.se_scratch(fp)
        assert plan["bytes"] == want and plan["bytes"] <= plan["y_bytes"] == 126 * 2 * fp
        assert plan["part"] < plan["mean"] < plan["chunk"] < plan["z"] < plan["gate"] < plan["bytes"]


@pytest.mark.parametrize("filters", [64, 320])
def test_se_tower_at_a_width_without_a_gate_raises(filters):
    """On the card the gate runs in the wide kernel (packed widths 128 and
    256) only: the launcher refuses an SE net packed to 64 or 320 before it
    touches the card, naming the width."""
    net = _net(1, "bfloat16", filters=filters, n_residuals=1)
    packed = tower.pack_weights(net.config, fold_bn_params(net))
    x2d = tower.input_rows(to_planes(_states(3, 0)).float().permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match=f"F {tower.kernel_width(filters)}"):
        tower._tower_cuda(packed, x2d)


def test_flax_conversion_raises_for_an_se_net():
    net = _net(0)
    with pytest.raises(ValueError, match="squeeze-and-excitation"):
        to_flax(net)
    with pytest.raises(ValueError, match="squeeze-and-excitation"):
        from_flax(net.config, {}, {})


def test_reference_imports_nothing_of_the_port_or_jax():
    """The reference file imports torch and the standard library only."""
    import ast

    tree = ast.parse(open(R.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert names <= {"__future__", "collections", "typing", "torch"}, names
    assert os.path.dirname(R.__file__).endswith(os.path.join("connect4_tpu_torch", "reference"))
