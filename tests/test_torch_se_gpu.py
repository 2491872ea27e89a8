"""The squeeze-and-excitation body (``config.SENetConfig``, Leela Chess
Zero's) on a CUDA card: the wide tower kernel with the gate in its
epilogue against its plain version with the kernel's sums emulated, its
counters, the learner's BatchNorm pair at ReLU and at no activation
against its plain version, and a train step on the card against the CPU.
They skip where there is no card. This file imports neither JAX nor the
JAX package:

    python -m pytest tests/test_torch_se_gpu.py -q -m gpu
"""

import copy

import pytest
import torch
from torch import nn

from connect4_tpu_torch.config import ModelConfig, SENetConfig
from connect4_tpu_torch.env.core import initial_state, legal_moves, step, to_planes
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.models.net import fold_bn_params, init_net, se_gate


def _positions(n, generator):
    """Planes ``[n*42, 3]`` of legal positions after 0..35 random plies."""
    state = initial_state((n,), device="cuda")
    plies = torch.randint(0, 36, (n,), generator=generator, device="cuda")
    for t in range(36):
        legal = legal_moves(state)
        weights = torch.where(legal.any(-1, keepdim=True), legal.float(), 1.0)
        move = torch.multinomial(weights, 1, generator=generator)[:, 0]
        state = step(state, move, t < plies)
    return to_planes(state).permute(0, 2, 3, 1).reshape(n * 42, 3).contiguous()


def _se_net(f, n_residuals, seed, device="cuda", dtype="bfloat16"):
    """A fresh SE net with BatchNorm statistics, shifts and the gate's
    biases moved off their initial values, so that no gate is symmetric."""
    config = SENetConfig(filters=f, n_fc_layers=2, n_residuals=n_residuals, compute_dtype=dtype, se_ratio=8)
    net = init_net(config, torch.Generator().manual_seed(seed), device=device)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith(("bias", "running_mean")):
                t.add_((0.1 * torch.randn(t.shape, generator=g)).to(t.device))
            elif name.endswith("running_var"):
                t.mul_((1.0 + 0.5 * torch.rand(t.shape, generator=g)).to(t.device))
    return net


@pytest.mark.gpu
@pytest.mark.parametrize("f, batches", [(256, (4096, 2048, 512, 64, 49, 1)), (128, (2048, 261, 64))])
def test_se_kernel_equals_its_emulation(f, batches):
    """The SE instantiation of the wide kernel equals ``tower_plain`` with
    the tensor core's accumulate and the gate's sums in the kernel's order
    (``tensor_core=True``) in every element, at the main path's batches
    (B=49 and 1 leave a pad block in the last cluster at F=256), and the
    padded channels are 0. The sigmoid is taken in float64 on both sides,
    and rounded to float32: the two float64 exponentials may differ in
    their last bit, which moves a float32 gate only at a rounding tie, far
    rarer than once in these runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(f)
    net = _se_net(f, 2, seed=f)
    packed = tower.pack_weights(net.config, fold_bn_params(net))
    for b in batches:
        x2d = _positions(b, g)
        with torch.no_grad():
            before = (tower.run_tower.launches, tower.run_tower.se_blocks)
            tk = tower.run_tower(packed, x2d)
            assert (tower.run_tower.launches, tower.run_tower.se_blocks) == (before[0] + 1, before[1] + 2)
            tp = tower.tower_plain(packed, x2d, tensor_core=True)
        torch.cuda.synchronize()
        assert tk.shape == (b * 42, tower.kernel_width(f))
        assert int((tk != tp).sum()) == 0, (f, b, int((tk != tp).sum()), (tk.float() - tp.float()).abs().max().item())


@pytest.mark.gpu
def test_se_kernel_at_a_padded_width_and_its_heads():
    """F=200 runs at 256 with a squeeze of 25 packed to 32: the padded
    channels stay 0, the kernel equals its emulation, and its value and
    prior are within 2e-2 of those of the plain version rounded to nearest
    with the gate as ``se_gate`` writes it (the tolerance the ResNet's
    kernel is held to against its plain version: a float32 sum taken in
    another order moves some bf16 roundings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(5)
    net = _se_net(200, 2, seed=7)
    assert tower.se_width(net.config) == 32 and tower.kernel_width(200) == 256
    packed = tower.pack_weights(net.config, fold_bn_params(net))
    x2d = _positions(512, g)
    with torch.no_grad():
        tk = tower.run_tower(packed, x2d)
        tp = tower.tower_plain(packed, x2d, tensor_core=True)
        v, p = tower.heads(packed, tk)
        vn, pn = tower.heads(packed, tower.tower_plain(packed, x2d))
    assert int((tk != tp).sum()) == 0
    assert not tk[:, 200:].any()
    assert (v - vn).abs().max().item() <= 2e-2 and (p - pn).abs().max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("filters", [64, 320])
def test_se_tower_at_another_width_raises_on_card(filters):
    """The fused kernel (F <= 64) and the layer kernel (F > 256) take no
    gate: an SE net there raises on the card, naming the width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    net = _se_net(filters, 1, seed=1)
    packed = tower.pack_weights(net.config, fold_bn_params(net))
    with pytest.raises(ValueError, match=f"F {tower.kernel_width(filters)}"):
        tower.run_tower(packed, _positions(3, torch.Generator(device="cuda").manual_seed(0)))


def _bf16_ulp(r):
    """One bf16 unit in the last place of each element of ``r`` (0 at 0)."""
    _, e = torch.frexp(r.float())
    return torch.where(r == 0, 0.0, torch.ldexp(torch.ones_like(r, dtype=torch.float32), e - 8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 256])
@pytest.mark.parametrize("act, stream", [("relu", False), ("relu", True), ("none", True)])
def test_batch_norm_act_at_relu_and_none_matches_plain_on_card(act, stream, c, dtype):
    """The fused pair with ReLU (the SE body's first BatchNorm and its input
    block's) and with no activation (the second, which feeds the gate)
    against its plain version on the same card tensors at 4,096 boards, as
    ``tests/test_torch_gpu.py`` holds the LeakyReLU pair: float32 tensors
    within 1e-5 of the plain version's largest magnitude, bf16 ones within
    one bf16 ulp of each element more; the statistics within 1e-5; the
    same inputs bit-equal on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from connect4_tpu_torch.models import batch_norm as B

    g = torch.Generator(device="cuda").manual_seed(c)
    shape = (4096, c, 6, 7)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + torch.randn((c, 1, 1), generator=g, device="cuda")
         ).to(dtype).contiguous(memory_format=torch.channels_last)
    g_c = (torch.randn(shape, generator=g, device="cuda") + 0.5).to(dtype).contiguous(memory_format=torch.channels_last)
    g_f = (torch.randn(shape, generator=g, device="cuda") + 0.5).contiguous(memory_format=torch.channels_last)
    bn = nn.BatchNorm2d(c).cuda().train()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn((c,), generator=g, device="cuda"))
        bn.bias.copy_(0.2 * torch.randn((c,), generator=g, device="cuda"))

    def run():
        m = copy.deepcopy(bn)
        xr = x.detach().requires_grad_(True)
        y_c, y_f = B.batch_norm_act(xr, m, None, stream=stream, act=act)
        stats = y_c.grad_fn.saved_tensors[2].clone()
        two = y_f is not None and y_f is not y_c
        torch.autograd.backward([y_c, y_f] if two else [y_c], [g_c, g_f] if two else [g_c])
        torch.cuda.synchronize()
        return dict(y_c=y_c, y_f=y_f if two else None, dx=xr.grad, dgamma=m.weight.grad, dbeta=m.bias.grad,
                    mean=m.running_mean, var=m.running_var, stats=stats), two

    before = (B.batch_norm_act.launches, B.batch_norm_act.backward_launches)
    got, two = run()
    assert (B.batch_norm_act.launches, B.batch_norm_act.backward_launches) == (before[0] + 1, before[1] + 1)
    again, _ = run()
    for k, v in got.items():
        assert v is None or torch.equal(v, again[k]), k
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    y_c, y_f, stats = B._forward_plain(x, bn.weight.detach(), bn.bias.detach(), rm, rv, None, True, act)
    dx, dgamma, dbeta, _ = B._backward_plain(x, None, got["stats"], g_c, g_f if two else None, act)
    ref = dict(y_c=y_c, y_f=y_f if two else None, dx=dx, dgamma=dgamma, dbeta=dbeta, mean=rm, var=rv, stats=stats)
    for k, r in ref.items():
        if r is None:
            assert got[k] is None, k
            continue
        diff = (got[k].float() - r.float()).abs()
        if k in ("mean", "var", "stats"):
            assert diff.max().item() <= 1e-5, k
            continue
        tol = 1e-5 * r.float().abs().max() + (_bf16_ulp(r) if r.dtype == torch.bfloat16 else 0.0)
        assert bool((diff <= tol).all()), (k, (diff - tol).max().item())


@pytest.mark.gpu
def test_se_train_step_on_card_matches_cpu():
    """Three SGD steps of a 64-filter, two-block SE net at 256 positions on
    the card (the fused BatchNorm pair at ReLU and none, the gate in
    float32) against the same steps on the CPU, as the ResNet's are held:
    float32 losses and state within 1e-4 (TF32 off), bf16 losses within
    5e-2 and state within 5e-3; each step runs the gate once a block
    (``se_gate.launches`` and ``.backward_launches``) and the pair 1 + 2 x 2
    times each way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from connect4_tpu_torch.models import batch_norm as B
    from connect4_tpu_torch.training.learner import init_train_state, make_optimizer, make_train_step
    from connect4_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    batches = []
    for _ in range(3):
        planes = _positions(256, g).reshape(256, 6, 7, 3).permute(0, 3, 1, 2).to(torch.uint8).contiguous()
        values = torch.randint(0, 3, (256,), generator=g, device="cuda").float() / 2
        priors = torch.softmax(torch.randn((256, 7), generator=g, device="cuda"), -1)
        batches.append((planes, values, priors))
    for dtype, tol_loss, tol_state in (("float32", 1e-4, 1e-4), ("bfloat16", 5e-2, 5e-3)):
        config = ModelConfig(net_config=SENetConfig(filters=64, n_fc_layers=2, n_residuals=2, compute_dtype=dtype))
        on_cpu = init_train_state(config, torch.Generator().manual_seed(3), "cpu")
        net = copy.deepcopy(on_cpu.net).to(dev)
        on_card = type(on_cpu)(net, make_optimizer(config, net))
        steps = [make_train_step(s.net, s.optimizer) for s in (on_cpu, on_card)]
        for batch in batches:
            a = float(steps[0](*(t.cpu() for t in batch))["loss"])
            before = (se_gate.launches, se_gate.backward_launches, B.batch_norm_act.launches,
                      B.batch_norm_act.backward_launches)
            b = float(steps[1](*batch)["loss"])
            after = (se_gate.launches, se_gate.backward_launches, B.batch_norm_act.launches,
                     B.batch_norm_act.backward_launches)
            assert tuple(y - x for x, y in zip(before, after)) == (2, 2, 1 + 2 * 2 + 2, 1 + 2 * 2 + 2)
            assert abs(a - b) <= tol_loss, (dtype, a, b)
        for (k, v), w in zip(on_cpu.net.state_dict().items(), on_card.net.state_dict().values()):
            if not k.endswith("num_batches_tracked"):
                assert (v - w.cpu()).abs().max().item() <= tol_state, (dtype, k)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [64, 256])
def test_se_gate_kernels_match_plain_on_card(c):
    """The learner's gate kernels (``se_gate_fwd``, ``se_gate_bwd``) against
    the plain version on the same card tensors at 4,096 boards: both
    outputs against the plain forward, and every gradient, from weighted
    gradients of both outputs, against the plain backward given what the
    kernel's forward kept (so that both take each output on the same side
    of the ReLU's kink: the two forwards round differently, and an output
    within a rounding of 0 takes its gradient in one and not the other).
    Each within 1e-5 of the largest magnitude of the plain version's tensor
    (float32 sums in another order; ``expf`` beside PyTorch's sigmoid), the
    bf16 copy within one bf16 ulp more; the same inputs bit-equal on a
    second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from connect4_tpu_torch.models import se_gate as G

    g = torch.Generator(device="cuda").manual_seed(c)

    def rand(*shape, nhwc=False, scale=1.0):
        t = torch.randn(*shape, generator=g, device="cuda") * scale
        return t.contiguous(memory_format=torch.channels_last) if nhwc else t

    n, sq = 4096, c // 8
    args = [rand(n, c, 6, 7, nhwc=True), rand(n, c, 6, 7, nhwc=True), rand(sq, c, scale=c ** -0.5), rand(sq),
            rand(2 * c, sq, scale=sq ** -0.5), rand(2 * c)]
    d_out, d_copy = rand(n, c, 6, 7, nhwc=True), rand(n, c, 6, 7, nhwc=True).to(torch.bfloat16)

    def run():
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        before = (G.se_gate.launches, G.se_gate.backward_launches)
        out, copy_ = G.se_gate(*leaves, torch.bfloat16)
        kept = out.grad_fn.saved_tensors  # (y, out, s, z, g, w1, w2)
        torch.autograd.backward([out, copy_], [d_out, d_copy])
        torch.cuda.synchronize()
        assert (G.se_gate.launches, G.se_gate.backward_launches) == (before[0] + 1, before[1] + 1)
        return [out, copy_] + [t.grad for t in leaves], kept

    got, kept = run()
    again, _ = run()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    y, out, s, z, gate, w1, w2 = kept
    with torch.no_grad():
        want = list(G.se_gate_plain(*args, torch.bfloat16))
        want += list(G.backward_plain(d_out, d_copy, y, s, z, gate, out, w1, w2))
    names = ("out", "copy", "d_y", "d_skip", "d_w1", "d_b1", "d_w2", "d_b2")
    for name, a, b in zip(names, got, want):
        tol = 1e-5 * b.float().abs().max() + (_bf16_ulp(b) if b.dtype == torch.bfloat16 else 0.0)
        diff = (a.float() - b.float()).abs()
        assert bool((diff <= tol).all()), (name, (diff - tol).max().item())
