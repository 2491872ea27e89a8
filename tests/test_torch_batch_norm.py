"""The fused train-mode BatchNorm, LeakyReLU and skip add
(``connect4_tpu_torch.models.batch_norm``) on the CPU: its plain version,
forward and backward, against the net's own formulation
(``net._bn`` + ``net.lrelu`` + the skip, under autograd), and the net's
fused wiring (``channels_last`` activations, the compute-dtype copy and
the float32 stream) against the net as the CPU runs it. The kernels
themselves run on the card only (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

Tolerances: float32 within 1e-5 relative to each quantity's largest
magnitude (the two sum the batch moments in different orders and normalise
as ``x * scale + shift`` against ``(x - mean) * invstd * gamma + beta``);
a bf16 output within one bf16 rounding of it (2**-8 relative), since a
float32 difference of one unit can move the rounding."""

from types import SimpleNamespace

import pytest
import torch
from torch import nn

from connect4_tpu_torch.config import ModelConfig, NetConfig
from connect4_tpu_torch.models import batch_norm as B
from connect4_tpu_torch.models import net as netmod
from connect4_tpu_torch.models.batch_norm import batch_norm_act
from connect4_tpu_torch.training.learner import init_train_state, make_train_step

torch.set_num_threads(1)


def _bn_module(c: int, seed: int) -> nn.BatchNorm2d:
    g = torch.Generator().manual_seed(seed)
    bn = nn.BatchNorm2d(c, eps=netmod.BN_EPS).train()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.2 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(1 + 0.1 * torch.rand(c, generator=g))
    return bn


def _checked(unchecked):
    """``unchecked`` (``batch_norm_act_unchecked``) behind
    ``batch_norm_act``'s checks of its arguments."""

    def run(x, bn, skip=None, stream=False, **kwargs):
        B._check(x, skip, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        return unchecked(x, bn, skip, stream, **kwargs)

    return run


def _inputs(n, c, dtype, skip, seed):
    """A conv output [n, c, 6, 7] channels_last in ``dtype`` (channels with
    means away from 0), a float32 skip and the two upstream gradients."""
    g = torch.Generator().manual_seed(seed)
    shape = (n, c, 6, 7)
    x = (torch.randn(shape, generator=g) * (1 + torch.rand(c, 1, 1, generator=g))
         + torch.randn(c, 1, 1, generator=g)).to(dtype).contiguous(memory_format=torch.channels_last)
    s = torch.randn(shape, generator=g).contiguous(memory_format=torch.channels_last) if skip else None
    g_c = torch.randn(shape, generator=g).to(dtype)
    g_f = torch.randn(shape, generator=g)
    return x, s, g_c, g_f


def _close(a, b, rel):
    scale = max(b.abs().max().item(), 1e-30)
    assert (a.float() - b.float()).abs().max().item() <= rel * scale, (a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 2, 8, 64])
@pytest.mark.parametrize("skip", [False, True])
def test_plain_version_equals_bn_lrelu_skip(skip, c, dtype):
    """Outputs, running statistics and the gradients of x, scale, bias and
    skip (both outputs used, each with its own upstream gradient)."""
    x, s, g_c, g_f = _inputs(16, c, dtype, skip, seed=c)
    results = []
    for fused in (False, True):
        bn = _bn_module(c, seed=1)
        xr = x.clone().requires_grad_(True)
        sr = None if s is None else s.clone().requires_grad_(True)
        if fused:
            y_c, y_f = batch_norm_act(xr, bn, sr, stream=True)
        else:
            y_f = netmod.lrelu(netmod._bn(xr, bn) + (0 if sr is None else sr))
            y_c = y_f.to(dtype)
        ((y_c.float() * g_c.float()).sum() + (y_f * g_f).sum()).backward()
        results.append(dict(y_c=y_c, y_f=y_f, mean=bn.running_mean, var=bn.running_var, dx=xr.grad,
                            dgamma=bn.weight.grad, dbeta=bn.bias.grad, dskip=None if sr is None else sr.grad))
    ref, got = results
    assert got["y_c"].dtype == dtype and got["y_f"].dtype == torch.float32
    assert got["y_c"].is_contiguous(memory_format=torch.channels_last)
    for k in ref:
        if ref[k] is None:
            assert got[k] is None, k
            continue
        rounded = dtype == torch.bfloat16 and k in ("y_c", "dx")
        _close(got[k], ref[k], 2 ** -8 if rounded else 1e-5)


@pytest.mark.parametrize("stream", [False, True])
def test_plain_version_on_ragged_rows(stream):
    """A [R, C] matrix of 1,001 rows (no whole board): the same as the
    same rows as an [R, C, 1, 1] tensor through ``_bn``; a float32 input's
    stream is its output itself."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1001, 24, generator=g) + 3
    bn_a, bn_b = _bn_module(24, 2), _bn_module(24, 2)
    y, y_f = batch_norm_act(x, bn_a, stream=stream)
    ref = netmod.lrelu(netmod._bn(x[:, :, None, None], bn_b))[:, :, 0, 0]
    _close(y, ref, 1e-5)
    _close(bn_a.running_var, bn_b.running_var, 1e-5)
    assert (y_f is y) if stream else y_f is None


def test_fused_op_checks_its_inputs():
    bn = _bn_module(8, 0)
    with pytest.raises(ValueError, match="channels_last"):
        batch_norm_act(torch.randn(2, 8, 6, 7).to(torch.bfloat16), bn)  # NCHW
    with pytest.raises(ValueError, match="skip"):
        x = torch.randn(2, 8, 6, 7).contiguous(memory_format=torch.channels_last)
        batch_norm_act(x, bn, skip=torch.randn(2, 8, 6, 7).double())
    with pytest.raises(ValueError, match=r"weight must be a contiguous float32 \[4\]"):
        batch_norm_act(torch.randn(10, 4), bn)  # 4 channels, a BatchNorm of 8
    before = (batch_norm_act.launches, batch_norm_act.backward_launches)
    batch_norm_act(torch.randn(10, 8, requires_grad=True), bn)[0].sum().backward()
    assert (batch_norm_act.launches, batch_norm_act.backward_launches) == before  # the card's count only


def test_fused_only_on_the_card_in_training_on_one_rank():
    """The net's choice of path: the fused pair on a CUDA tensor in training
    mode with no mesh or a one-rank mesh; ``_bn`` everywhere else."""
    cpu, card = SimpleNamespace(device=torch.device("cpu")), SimpleNamespace(device=torch.device("cuda", 0))
    one, two = SimpleNamespace(world_size=1), SimpleNamespace(world_size=2)
    assert netmod._fused(card, True, None) and netmod._fused(card, True, one)
    assert not netmod._fused(card, False, None)
    assert not netmod._fused(card, True, two)
    assert not netmod._fused(cpu, True, None)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_residuals", [0, 2])
def test_fused_wiring_of_the_net_equals_the_plain_net(monkeypatch, compute_dtype, n_residuals):
    """Two train steps of a small net on the CPU with the fused path forced
    on (``_fused`` true: ``channels_last`` planes and weights, every
    BatchNorm through ``batch_norm_act``'s plain version, the compute-dtype
    copies and float32 streams handed between blocks) against the same
    steps as the CPU runs them: losses, parameters and running statistics
    (float32 within 1e-5; bf16 within 2e-3, each conv input rounded at the
    same point but the moments summed in another order). Every argument the
    net hands the unchecked entry passes ``batch_norm_act``'s checks."""
    cfg = ModelConfig(net_config=NetConfig(filters=8, n_fc_layers=1, n_residuals=n_residuals,
                                           compute_dtype=compute_dtype), batch_size=32)
    g = torch.Generator().manual_seed(3)
    batches = [(torch.randint(0, 2, (32, 3, 6, 7), generator=g).to(torch.uint8),
                torch.randint(0, 3, (32,), generator=g).float() / 2,
                torch.softmax(torch.randn(32, 7, generator=g), -1)) for _ in range(2)]
    runs = []
    for fused in (False, True):
        if fused:
            monkeypatch.setattr(netmod, "_fused", lambda planes, training, mesh: training)
            monkeypatch.setattr(B, "batch_norm_act_unchecked", _checked(B.batch_norm_act_unchecked))
        state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(state.net, state.optimizer)
        losses = [float(step(*b)["loss"]) for b in batches]
        runs.append((losses, {k: v.clone() for k, v in state.net.state_dict().items()}))
    (l0, s0), (l1, s1) = runs
    tol = 1e-5 if compute_dtype == "float32" else 2e-3
    assert max(abs(a - b) for a, b in zip(l0, l1)) <= tol
    for k in s0:
        if not k.endswith("num_batches_tracked"):
            assert (s0[k] - s1[k]).abs().max().item() <= tol, k
