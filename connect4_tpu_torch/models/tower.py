"""Folded-BN inference tower: the hand-written CUDA kernel, its plain
PyTorch version, and the head epilogue.

The counterpart of ``connect4_tpu.models.pallas_net``. ``pack_weights``
flattens a folded parameter set (``models.net.fold_bn_params``) into
kernel-shaped bf16 tensors; ``run_tower`` computes the 13-conv tower (at the
shipped net) on ``[B*42, channels]`` rows; ``heads`` runs the value and
policy heads on its output; ``forward`` chains them.

``run_tower`` launches the CUDA kernel of ``csrc/tower.cu`` for a CUDA
tensor, and takes the plain version ``tower_plain`` only for a CPU tensor.
It never falls back: a CUDA input that the kernel does not take raises.
``run_tower.launches`` counts kernel launches, ``run_tower.by_shape`` the
same by packed width and batch. A forward captured into a CUDA graph is
counted where the graph replays it, not where it is captured
(``connect4_tpu_torch.launches``).

The kernel (see the header of ``csrc/tower.cu``) keeps a tile of 3 boards
resident in shared memory across all layers and runs every conv as 9
shifted products on the tensor cores with ``wgmma``: the activations are
the register operand, filled by ``ldmatrix`` from addresses that carry the
tap's shift and mask; a tap's weights are the shared-memory operand,
streamed by asynchronous bulk copies through a ring of ``mbarrier``s.
``pack_weights`` therefore also lays the weights out as the exact
shared-memory images the kernel's matrix descriptors read (``conv1_img``,
``res_img``), and ``tile_plan`` mirrors the launcher's choice of tile
(``wide_grid``, ``wide_plan`` and ``wide_stages`` the grid, block and
weight stages of the kernel at 128 and 256 filters).

Widths. The kernel is instantiated at ``KERNEL_FILTERS``; a net of any
other width up to 256 runs at the next instantiated one (``kernel_width``).
A wider net, of any width, runs through the layer kernel of
``csrc/tower.cu``, one conv a launch (13 launches at six residual blocks),
with the activations in device memory between layers, at the next multiple
of ``LAYER_STEP`` that one of ``LAYER_TILE_WIDTHS`` divides (that column
tile, ``layer_tile``); ``run_tower.layer_launches`` counts its launches.
``pack_weights`` pads the conv weights and biases with zeros, so the padded
channels stay exactly 0 through every layer and add nothing to the real
ones, and ``heads`` reads the real channels only. The plain version
computes on the same padded tensors, so the CPU and the card compute one
function.

Numerics (both versions, as in the Pallas kernel): inputs rounded to bf16,
bf16 weights, float32 accumulation, float32 bias add, LeakyReLU, a round
to bf16 at every layer boundary, the residual add in float32. Both sum a
conv in the same order: (tap, channel) at the fused widths, and at the
layer kernel's (k-slab of ``LAYER_STEP`` channels, tap, channel), the
order ``layer_k_order`` gives. ``CHAIN`` says how many products chain
inside the tensor core before an ordinary float32 add (as shipped, the
whole layer).
Inside a chain the tensor core does not round to nearest, so ``tower_plain``
comes in two forms. ``tensor_core=False`` (the default, and what
``run_tower`` computes on the CPU) is the float32 matrix product rounded to
nearest, as tensor code is naturally written: the reference that owes
nothing to a model of the hardware. ``tensor_core=True`` emulates the
H100's accumulate (``_tensor_core_step``) and reproduces the kernel bit for
bit; it is slow (every product is formed on its own) and exists to hold the
kernel against. The heads take the bf16
tower output through float32 products and round to bf16 where the Pallas
epilogue does; tanh and softmax run in float32.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from connect4_tpu_torch import launches
from connect4_tpu_torch.build import load_library
from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.models.net import lrelu
from connect4_tpu_torch.types import AREA, HEIGHT, WIDTH

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "tower.cu")
KERNEL_FILTERS = (16, 32, 64, 128, 256)  # widths the fused kernel is instantiated for
# 256 is the widest tower a block can hold (wgmma's N is at most 256; the two
# [128 rows, F] bf16 activation tiles, 128 KB at F=256, and the weight ring
# fill the 227 KB of shared memory a block may use). Above it the layer
# kernel takes one conv a launch. It stages its input in k-slabs of
# LAYER_STEP channels, so the packed width Fp is a multiple of LAYER_STEP,
# and cuts the output channels into Fp / N column tiles of N, the widest of
# LAYER_TILE_WIDTHS that divides Fp (wgmma's N is at most 256). Its shared
# memory does not grow with Fp: no width is too wide.
LAYER_STEP = 64
LAYER_TILE_WIDTHS = (256, 224, 192, 160)
MAX_CHANNELS = 4
# The wide kernel (F = 128 and 256), as the kWide* constants of csrc/tower.cu
# set them: at F=256 the two blocks of a cluster share each weight stage by
# multicast (at F=128 a cluster is one block); a stage is 4 slabs (64 input
# channels of one tap: 16 KB at F=128, 32 KB at 256). wide_plan mirrors the
# rest.
WIDE_CLUSTER = {128: 1, 256: 2}
WIDE_STAGE_SLABS = {128: 4, 256: 4}
SMEM_BLOCK = 232448  # shared memory a block may use on an H100
# How many terms of a residual conv's 9*Cin-deep sum form one product before
# a float32 add: "step" 16 (one tensor-core step), "tap" Cin (one tap),
# "layer" all. The kernel ships CHAIN at every width; the others exist (at
# F=64) to be measured against it. The order matches csrc/tower.cu's kChain*
# constants.
CHAINS = ("step", "tap", "layer")
CHAIN = "layer"
TILE_BOARDS = 3  # boards per block: two 64-row tiles, one per warpgroup

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

_BF16 = torch.bfloat16


def layer_tile(fp: int) -> int:
    """The column tile N the layer kernel cuts a packed width ``fp`` into:
    the widest of ``LAYER_TILE_WIDTHS`` that divides it; 0 where ``fp`` is
    not a width the layer kernel takes (at most 256, or not a multiple of
    ``LAYER_STEP``, or none divides it)."""
    if not is_layer_width(fp) or fp % LAYER_STEP:
        return 0
    return next((n for n in LAYER_TILE_WIDTHS if fp % n == 0), 0)


def kernel_width(filters: int) -> int:
    """The width the tower runs at for a net of ``filters``: the narrowest
    of ``KERNEL_FILTERS`` that holds it, or above 256 the next multiple of
    ``LAYER_STEP`` that the layer kernel takes (``layer_tile``): from 257 to
    512 that is the next multiple of 64 (320, 384, 448 or 512, two column
    tiles); above, 576, 640, 768, 896, 960, 1024, ... (704 and 832, multiples
    of 64 with no column tile, go on to 768 and 896). The worst wasted share
    of the residual operations, 1 - (F/Fp)^2, is 35.5% at F=257 and above
    512 30.3% at F=641 (packed to 768)."""
    if filters < 1:
        raise ValueError(f"tower: filters {filters} must be at least 1")
    if filters <= KERNEL_FILTERS[-1]:
        return next(w for w in KERNEL_FILTERS if w >= filters)
    fp = -(-filters // LAYER_STEP) * LAYER_STEP
    while not layer_tile(fp):
        fp += LAYER_STEP
    return fp


def is_layer_width(fp: int) -> bool:
    """Whether the packed width ``fp`` runs through the layer kernel."""
    return fp > KERNEL_FILTERS[-1]


def tower_bound(config: NetConfig, boards: int):
    """``(bound_ms, bound_by, flops, bytes)`` of the tower on ``boards``
    boards on an H100: every MAC of the convs on 42 rows a board (37.3
    MFLOP a board at F=64, 6 residual blocks; 595 MFLOP at F=256), and each
    input, weight and output byte moved once. The bound is the larger of
    the operations over the bf16 peak and the bytes over the memory rate.
    It counts the net's own width, so the zero channels a padded width
    computes show as lost efficiency."""
    f, c, n = config.filters, config.channels, config.n_residuals
    flops = boards * AREA * 2 * (9 * c * f + 2 * n * 9 * f * f)
    weight_bytes = 2 * (9 * c * f + f + 2 * n * (9 * f * f + f))
    nbytes = boards * AREA * c * 4 + weight_bytes + boards * AREA * f * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def pack_weights(config: NetConfig, folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Kernel-shaped tensors from an ``InferenceNet`` state dict, on its
    device. 3x3 kernels become im2col matrices ``[9*Cin, F]`` with rows in
    (dr, dc, cin) order, as ``pack_weights`` of the Pallas tower makes them.
    ``conv1_img`` and ``res_img`` hold the same values as the shared-memory
    images the CUDA kernel copies in and multiplies from: ``smem_image`` at
    a fused width, ``layer_image`` (column tiles) at a layer width. Biases
    are rounded to bf16, as there.

    The tower's tensors are at ``kernel_width(config.filters)``: conv output
    channels, residual input channels and biases padded with zeros. The
    heads' tensors keep the net's own width."""

    f = config.filters
    fp = kernel_width(f)

    def im2col(w, cin):  # OIHW [F, Cin, 3, 3] -> [9*cin, fp], zero-padded
        w = F.pad(w.detach(), (0, 0, 0, 0, 0, cin - w.shape[1], 0, fp - w.shape[0]))
        return w.permute(2, 3, 1, 0).reshape(-1, fp).to(_BF16)

    def bf(name):
        return folded[name].detach().to(_BF16)

    def bias(name):  # [F] -> [fp], zero-padded
        return F.pad(bf(name), (0, fp - f))

    res_w = [im2col(folded[f"res.{i}.weight"], fp) for i in range(2 * config.n_residuals)]
    res_b = [bias(f"res.{i}.bias") for i in range(2 * config.n_residuals)]
    dev = folded["conv0.weight"].device
    res_w = torch.stack(res_w) if res_w else torch.zeros((0, 9 * fp, fp), dtype=_BF16, device=dev)
    res_b = torch.stack(res_b) if res_b else torch.zeros((0, fp), dtype=_BF16, device=dev)
    n_fc = config.n_fc_layers

    def dense(name):  # Linear [out, in] -> Dense kernel [in, out]
        return folded[name].detach().T.contiguous().to(_BF16)

    conv1_w = im2col(folded["conv0.weight"], config.channels).contiguous()
    depth0 = conv1_w.shape[0]
    conv1_pad = F.pad(conv1_w, (0, 0, 0, -depth0 % 16))  # depth up to a multiple of 16
    if is_layer_width(fp):
        conv1_img = layer_image(conv1_pad)  # [T, 16*ceil(9*channels/16) * N], T = fp / N column tiles
        res_img = layer_image(res_w)  # [2n, T, 9*fp * N], slabs in layer_k_order
    else:
        conv1_img = smem_image(conv1_pad)  # [16*ceil(9*channels/16) * fp]
        res_img = smem_image(res_w.unflatten(1, (9, fp)))  # [2n, 9, fp*fp], one tap each
    return {
        "conv1_w": conv1_w,  # [9*channels, fp]
        "conv1_img": conv1_img,
        "conv1_b": bias("conv0.bias"),  # [fp]
        "res_w": res_w.contiguous(),  # [2n, 9*fp, fp]
        "res_img": res_img,
        "res_b": res_b.contiguous(),  # [2n, fp]
        "vh_conv_w": folded["vh_conv.weight"].detach().reshape(1, f).T.contiguous().to(_BF16),
        "vh_conv_b": bf("vh_conv.bias"),
        "vh_fc_w": [dense(f"vh_fcs.{i}.weight") for i in range(n_fc)],
        "vh_fc_b": [bf(f"vh_fcs.{i}.bias") for i in range(n_fc)],
        "vh_out_w": dense("vh_out.weight"),
        "vh_out_b": bf("vh_out.bias"),
        "ph_conv_w": folded["ph_conv.weight"].detach().reshape(2, f).T.contiguous().to(_BF16),
        "ph_conv_b": bf("ph_conv.bias"),
        "ph_fc_w": dense("ph_fc.weight"),  # [84, 7], rows in (r, c, ch) order
        "ph_fc_b": bf("ph_fc.bias"),
    }


def smem_image(w: torch.Tensor) -> torch.Tensor:
    """``[..., K, N]`` matrices (K, N multiples of 8) -> ``[..., K*N]``, each
    in the order the kernel's ``wgmma`` descriptor reads a K-major B operand
    from shared memory without swizzle: 8x8 core matrices of 128 contiguous
    bytes, n down a core matrix and k along its rows; core matrices adjacent
    in n follow each other, those adjacent in k lie N/8 core matrices apart.
    Element (k, n) lands at ``((k//8 * N//8 + n//8) * 8 + n%8) * 8 + k%8``."""
    k, n = w.shape[-2:]
    v = w.unflatten(-2, (k // 8, 8)).unflatten(-1, (n // 8, 8))  # [..., kc, e, ng, r]
    return v.permute(*range(v.dim() - 4), -4, -2, -1, -3).flatten(-4).contiguous()


def smem_image_inverse(img: torch.Tensor, n: int) -> torch.Tensor:
    """``smem_image`` undone: ``[..., K*N]`` -> ``[..., K, N]``."""
    k = img.shape[-1] // n
    v = img.unflatten(-1, (k // 8, n // 8, 8, 8))  # [..., kc, ng, r, e]
    return v.permute(*range(v.dim() - 4), -4, -1, -3, -2).flatten(-4, -3).flatten(-2).contiguous()


def layer_k_order(fp: int) -> torch.Tensor:
    """The im2col rows of a residual conv at a layer width ``fp`` (rows in
    (tap, channel) order) in the order the layer kernel multiplies them:
    k-slab of ``LAYER_STEP`` input channels, then tap, then channel."""
    return torch.arange(9 * fp).reshape(9, fp // LAYER_STEP, LAYER_STEP).transpose(0, 1).flatten()


def layer_image(w: torch.Tensor) -> torch.Tensor:
    """``[..., K, Fp]`` -> ``[..., T, K*N]``, the image the layer kernel
    streams: the columns cut into ``T = Fp / N`` tiles of ``N =
    layer_tile(Fp)``, each tile's ``[K, N]`` as ``smem_image`` lays it out,
    so that its 16-deep slabs (``16*N`` elements each) follow one another in
    the order the kernel multiplies them: for a residual conv (``K =
    9*Fp``) in ``layer_k_order``, for the input conv as they are."""
    k, fp = w.shape[-2:]
    n = layer_tile(fp)
    if k == 9 * fp:
        w = w[..., layer_k_order(fp).to(w.device), :]
    return smem_image(w.unflatten(-1, (fp // n, n)).movedim(-2, -3))


def layer_image_inverse(img: torch.Tensor, fp: int) -> torch.Tensor:
    """``layer_image`` undone: ``[..., T, K*N]`` -> ``[..., K, fp]``."""
    tiles = smem_image_inverse(img, layer_tile(fp))  # [..., T, K, N]
    w = tiles.movedim(-3, -2).flatten(-2)
    if w.shape[-2] == 9 * fp:
        w = w[..., torch.argsort(layer_k_order(fp)).to(w.device), :]
    return w.contiguous()


def tile_plan(n_boards: int) -> Tuple[int, int]:
    """``(boards per block, blocks)`` as the fused kernel's launcher takes
    them: 3 boards, two 64-row tiles, one per warpgroup, at every batch, so
    that small batches spread over the card. The layer kernel takes the
    same row tiles, each once for every column tile."""
    return TILE_BOARDS, -(-n_boards // TILE_BOARDS)


def wide_grid(n_boards: int, fp: int) -> Tuple[int, int]:
    """``(blocks, pad blocks)`` of the wide kernel (``tower_kernel_wide``)
    at packed width ``fp`` (128 or 256) as ``launch_wide`` launches it: one
    block a 3-board tile (``tile_plan``), rounded up to whole clusters of
    ``WIDE_CLUSTER[fp]``. A pad block takes part in its cluster's
    handshakes and writes nothing."""
    tiles = tile_plan(n_boards)[1]
    cluster = WIDE_CLUSTER[fp]
    blocks = -(-tiles // cluster) * cluster
    return blocks, blocks - tiles


def wide_plan(fp: int) -> Dict[str, int]:
    """The wide kernel's block at packed width ``fp`` (128 or 256), as
    ``WideCfg`` in ``csrc/tower.cu`` computes it: one block an SM, of two
    consumer warpgroups and a producer warpgroup; the slabs a weight stage
    holds (16 input channels of one tap each, ``32 * fp`` bytes), its
    bytes, the ring's stages (as many as fit, at most 8), and the shared
    memory the block asks for: X and Y (the 126 rows of 3 boards each), a
    zero row, the biases (float32, two layers), the ring, the barriers and
    the slack that aligns the base to a row."""
    row = 2 * fp
    stage_slabs = WIDE_STAGE_SLABS[fp]
    stage_bytes = stage_slabs * 32 * fp
    ring_off = 2 * TILE_BOARDS * AREA * row + row + 2 * fp * 4
    stages = min(8, (SMEM_BLOCK - ring_off - 17 * 8 - row) // stage_bytes)
    return {
        "threads": 384, "cluster": WIDE_CLUSTER[fp], "stage_slabs": stage_slabs, "stage_bytes": stage_bytes,
        "ring_stages": stages, "smem": ring_off + stages * stage_bytes + (2 * stages + 1) * 8 + row,
    }


def wide_stages(fp: int, n_layers: int) -> torch.Tensor:
    """``[stages, slabs a stage]``: the 16-deep slabs of ``res_img`` (counted
    over the whole image, ``9 * fp / 16`` a layer) that each weight stage of
    the wide kernel holds, in the order its producer issues them and its
    consumers multiply them. Stage ``n`` lands in ring slot ``n % ring
    stages``, which block ``slot % WIDE_CLUSTER[fp]`` of a cluster copies
    for all of them."""
    per = wide_plan(fp)["stage_slabs"]
    return torch.arange(n_layers * 9 * fp // 16).reshape(-1, per)


# ---------------------------------------------------------------------------
# plain PyTorch version


def _round_toward_zero(t: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, truncating as the tensor core does where it
    writes a sum (``Tensor.float`` rounds to nearest)."""
    f = t.float()
    return torch.where(f.double().abs() > t.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _exponent(t: torch.Tensor) -> torch.Tensor:
    """floor(log2 |t|) of a float64 tensor; far below every real exponent
    where t is zero."""
    _, e = torch.frexp(t)
    return torch.where(t == 0, torch.full_like(e, -1000), e - 1)


_STEP_ROWS = 1 << 15  # rows a tensor-core step is emulated on at a time (memory)


def _tensor_core_step(a: torch.Tensor, w: torch.Tensor, acc) -> torch.Tensor:
    """``acc + a @ w`` for bf16-valued ``a [R, k<=16]``, ``w [k, N]`` and a
    float32 ``acc [R, N]`` (or None for zero), as one H100 ``wgmma`` k16
    step computes it, bit for bit on every input tried (gen-161, legal
    positions, all three chain lengths: ``scripts/check_tower_gpu.py``).

    The k products are exact. Each has the exponent of its factors'
    exponents added (not that of the product itself, which may be one
    more). Products and accumulator are aligned to the largest exponent
    among them and cut, toward zero, two bits below the float32 unit of
    that exponent; the cut addends are summed exactly and the sum is cut
    toward zero to float32."""
    out = []
    w64 = w.double()
    ew = _exponent(w64)
    for r0 in range(0, a.shape[0], _STEP_ROWS):
        a64 = a[r0:r0 + _STEP_ROWS].double()
        e = (_exponent(a64)[:, :, None] + ew[None]).amax(1)  # [R, N]
        c64 = None if acc is None else acc[r0:r0 + _STEP_ROWS].double()
        if c64 is not None:
            e = torch.maximum(e, _exponent(c64))
        unit = torch.ldexp(torch.ones_like(c64 if c64 is not None else e, dtype=torch.float64),
                           e.clamp_min(-100) - 25)
        s = torch.trunc(a64[:, :, None] * w64[None] / unit[:, None, :]).sum(1)
        if c64 is not None:
            s = s + torch.trunc(c64 / unit)
        out.append(_round_toward_zero(s * unit))
    return torch.cat(out)


def _conv3x3_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, chain: str, tensor_core: bool
) -> torch.Tensor:
    """One folded conv + bias on bf16 boards ``[B, 6, 7, Cin]`` -> float32
    ``[B, 6, 7, F]``: im2col over the zero-padded board, bf16 values
    multiplied and summed in the CUDA kernel's order.

    The im2col depth is in (dr, dc, cin) order, as ``w``'s rows; a
    residual conv at a layer width (Cin above 256) takes it in the layer
    kernel's order instead (``layer_k_order``: k-slab, tap, channel). A
    residual conv (Cin a multiple of 16) is cut into chains of ``chain``
    terms (``"step"`` 16, ``"tap"`` Cin, ``"layer"`` all of them); the
    chains' sums are added in turn with ordinary float32 adds, as the kernel
    adds them. The input conv is one chain. A chain is one float32 matrix
    product rounded to nearest, or with ``tensor_core`` the tensor core's
    16-term steps emulated one after the other (``_tensor_core_step``)."""
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dr:dr + HEIGHT, dc:dc + WIDTH, :] for dr in range(3) for dc in range(3)]
    if is_layer_width(x.shape[-1]):
        cin = x.shape[-1]
        taps = [t[..., s:s + LAYER_STEP] for s in range(0, cin, LAYER_STEP) for t in taps]
        w = w[layer_k_order(cin).to(w.device)]
    patches = torch.cat(taps, dim=-1)  # [B, 6, 7, 9*Cin]
    board_shape = patches.shape[:-1]
    patches = patches.flatten(0, -2)
    depth = patches.shape[-1]
    cin = depth // 9
    chunk = {"step": 16, "tap": cin, "layer": depth}[chain] if cin % 16 == 0 else depth
    wf = w.float()
    acc = None
    for c0 in range(0, depth, chunk):
        c1 = min(c0 + chunk, depth)
        if tensor_core:
            part = None
            for k in range(c0, c1, 16):
                part = _tensor_core_step(patches[:, k:min(k + 16, c1)], wf[k:min(k + 16, c1)], part)
        else:
            part = patches[:, c0:c1] @ wf[c0:c1]
        acc = part if acc is None else acc + part
    return (acc + b.float()).unflatten(0, board_shape)


def tower_plain(
    packed: Dict[str, torch.Tensor], x2d: torch.Tensor, chain: str = CHAIN, tensor_core: bool = False
) -> torch.Tensor:
    """The tower in plain tensor code: ``[B*42, C]`` -> ``[B*42, fp]`` bf16
    (``fp`` the packed, padded width), summed in the kernel's order at
    chain length ``chain``; a chain's inner sum rounded to nearest, or as
    the tensor core computes it."""
    b = x2d.shape[0] // AREA
    x = x2d.to(_BF16).reshape(b, HEIGHT, WIDTH, -1)
    x = lrelu(_conv3x3_plain(x, packed["conv1_w"], packed["conv1_b"], chain, tensor_core)).to(_BF16)
    res_w, res_b = packed["res_w"], packed["res_b"]
    for i in range(res_w.shape[0] // 2):
        y = lrelu(_conv3x3_plain(x, res_w[2 * i], res_b[2 * i], chain, tensor_core)).to(_BF16)
        y2 = _conv3x3_plain(y, res_w[2 * i + 1], res_b[2 * i + 1], chain, tensor_core)
        x = lrelu(y2 + x.float()).to(_BF16)
    return x.reshape(b * AREA, -1)


# ---------------------------------------------------------------------------
# the CUDA kernel


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.c4_tower_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.c4_tower_forward_chain.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.c4_tower_layer.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.c4_tower_forward, lib.c4_tower_forward_chain, lib.c4_tower_layer):
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...], device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"tower kernel: {name} must be a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f" ({'contiguous' if t.is_contiguous() else 'strided'})"
        )


def _tower_cuda(packed: Dict[str, torch.Tensor], x2d: torch.Tensor, chain=None) -> torch.Tensor:
    rows, cin = x2d.shape
    f = packed["conv1_w"].shape[1]
    n_layers = packed["res_img"].shape[0]
    layered = is_layer_width(f)
    if rows % AREA or not 1 <= cin <= MAX_CHANNELS or not (f in KERNEL_FILTERS or layer_tile(f)):
        raise ValueError(
            f"tower kernel takes [B*42, C<= {MAX_CHANNELS}] rows and packed widths F in "
            f"{KERNEL_FILTERS} or, above 256, multiples of {LAYER_STEP} that one of {LAYER_TILE_WIDTHS} "
            f"divides (pack_weights pads a net to one of them); got rows {rows}, C {cin}, F {f}"
        )
    if layered and chain not in (None, CHAIN):
        raise ValueError(f"the layer kernel (F {f}) sums a layer as one chain; got chain {chain}")
    dev = x2d.device
    depth0 = -(-9 * cin // 16) * 16
    if layered:
        n = layer_tile(f)
        img_shapes = (f // n, depth0 * n), (n_layers, f // n, 9 * f * n)
    else:
        img_shapes = (depth0 * f,), (n_layers, 9, f * f)
    _check(x2d, "x", torch.float32, (rows, cin), dev)
    _check(packed["conv1_img"], "conv1_img", _BF16, img_shapes[0], dev)
    _check(packed["conv1_b"], "conv1_b", _BF16, (f,), dev)
    _check(packed["res_img"], "res_img", _BF16, img_shapes[1], dev)
    _check(packed["res_b"], "res_b", _BF16, (n_layers, f), dev)
    out = torch.empty((rows, f), dtype=_BF16, device=dev)
    lib = _library()
    layer_launches = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if layered:
            layer_launches = _tower_layers(lib, packed, x2d, out, stream)
        else:
            args = (
                x2d.data_ptr(), packed["conv1_img"].data_ptr(), packed["conv1_b"].data_ptr(),
                packed["res_img"].data_ptr(), packed["res_b"].data_ptr(), out.data_ptr(),
                rows // AREA, cin, f, n_layers,
            )
            if chain is None:
                err = lib.c4_tower_forward(*args, stream)
            else:
                err = lib.c4_tower_forward_chain(*args, CHAINS.index(chain), stream)
            if err != 0:
                raise RuntimeError(f"tower kernel launch failed with cudaError {err} (F {f}, chain {chain})")
    launches.count(_record, f, rows // AREA, layer_launches)
    return out


def _tower_layers(lib, packed: Dict[str, torch.Tensor], x2d: torch.Tensor, out: torch.Tensor, stream) -> int:
    """The tower at a layer width into ``out``: one launch of the layer
    kernel a conv, on ``stream``; returns the number of launches. ``out``
    holds a residual block's input and then, the skip added in place, its
    output; ``y`` (allocated here, on the caller's stream) the block's
    middle layer."""
    rows, cin = x2d.shape
    f = out.shape[1]
    y = torch.empty_like(out)

    def layer(first, src, img, bias, skip, dst):
        err = lib.c4_tower_layer(
            src.data_ptr(), img.data_ptr(), bias.data_ptr(), None if skip is None else skip.data_ptr(),
            dst.data_ptr(), rows // AREA, cin if first else f, f, int(first), stream)
        if err != 0:
            raise RuntimeError(f"tower layer kernel launch failed with cudaError {err} (F {f})")

    res_img, res_b = packed["res_img"], packed["res_b"]
    layer(True, x2d, packed["conv1_img"], packed["conv1_b"], None, out)
    for i in range(res_img.shape[0] // 2):
        layer(False, out, res_img[2 * i], res_b[2 * i], None, y)
        layer(False, y, res_img[2 * i + 1], res_b[2 * i + 1], out, out)
    return 1 + res_img.shape[0]


def run_tower(packed: Dict[str, torch.Tensor], x2d: torch.Tensor, chain=None) -> torch.Tensor:
    """``[B*42, C]`` float32 rows of ``(board, r, c)`` -> ``[B*42, fp]`` bf16
    tower output at the packed width. The CUDA kernel for a CUDA tensor (the
    fused kernel up to 256 filters, the layer kernel above); the plain
    version for a CPU tensor; anything else raises. ``chain`` (one of
    ``CHAINS``) overrides the shipped chain length of the fused kernel, for
    measurements. ``run_tower.launches`` counts tower forwards on the card,
    ``run_tower.layer_launches`` the layer kernel's launches among them,
    ``run_tower.by_shape`` the forwards as ``{packed width: {boards: n}}``."""
    if x2d.device.type == "cuda":
        return _tower_cuda(packed, x2d, chain)
    if x2d.device.type == "cpu":
        return tower_plain(packed, x2d, chain or CHAIN)
    raise ValueError(f"tower: no implementation for device {x2d.device}")


run_tower.launches = 0
run_tower.layer_launches = 0
run_tower.by_shape = {}

def _record(f: int, boards: int, layer_launches: int) -> None:
    """Count one tower forward on the card at packed width ``f``, with the
    layer kernel's launches in it (through ``launches.count``, so a
    forward captured into a CUDA graph counts at each replay)."""
    run_tower.launches += 1
    run_tower.layer_launches += layer_launches
    per = run_tower.by_shape.setdefault(f, {})
    per[boards] = per.get(boards, 0) + 1


# ---------------------------------------------------------------------------
# heads and the whole forward


def _dot(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 products accumulated in float32, plus the bias."""
    return x.float() @ w.float() + b.float()


def heads(packed: Dict[str, torch.Tensor], t: torch.Tensor):
    """Value and policy heads on the bf16 tower output ``[B*42, fp]``
    -> ``(value [B] f32, prior [B, 7] f32)``. They read the net's own F
    channels; the padded ones (all 0) are sliced off."""
    b = t.shape[0] // AREA
    t = t[:, : packed["vh_conv_w"].shape[0]]
    v = lrelu(_dot(t, packed["vh_conv_w"], packed["vh_conv_b"])).to(_BF16)
    v = v.reshape(b, AREA)
    for wi, bi in zip(packed["vh_fc_w"], packed["vh_fc_b"]):
        v = _dot(v, wi, bi).to(_BF16)
    v = lrelu(v.float()).to(_BF16)
    v = _dot(v, packed["vh_out_w"], packed["vh_out_b"])
    value = ((torch.tanh(v) + 1.0) * 0.5).reshape(b)

    p = lrelu(_dot(t, packed["ph_conv_w"], packed["ph_conv_b"])).to(_BF16)
    p = p.reshape(b, AREA * 2)  # (r, c, ch) flatten order
    prior = torch.softmax(_dot(p, packed["ph_fc_w"], packed["ph_fc_b"]), dim=-1)
    return value, prior


def input_rows(nhwc: torch.Tensor) -> torch.Tensor:
    """``nhwc [B, 6, 7, channels]`` -> the tower's input, ``[B*42,
    channels]`` contiguous float32 rows."""
    return nhwc.reshape(nhwc.shape[0] * AREA, nhwc.shape[-1]).float().contiguous()


def forward(packed: Dict[str, torch.Tensor], nhwc: torch.Tensor):
    """``nhwc [B, 6, 7, channels] -> (value [B] f32, prior [B, 7] f32)``:
    the tower at the packed width, then the heads on the net's own F
    channels of it."""
    return heads(packed, run_tower(packed, input_rows(nhwc)))
