"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit; imports nothing of JAX or of the JAX package. Phases, each
fatal on failure:

1. build every CUDA kernel of the main path from the sources in the
   checkout, one ``nvcc`` a source, all started together, each printed
   with its ptxas report: the fused tower kernels and the layer kernel
   ``tower_layer`` (``models/csrc/tower.cu``), and the search's descent
   kernel (``mcts/csrc/descent.cu``);
2. hold each kernel against its plain PyTorch version on the card, on
   legal board positions at every batch shape the driven paths launch it
   at (``COMPARE_BOARDS``: a pool of S slots evaluates S roots and S x K=8
   leaves, and halves S down to 64 while it drains, so 4096 ... 64 for the
   512-slot and 256-slot pools; the 49 boards of a match, 49 roots and 392
   leaves, and 784 leaves for its K=16 player; B=261, as the JAX package's
   tests take it; B=1), with the
   packaged gen-161 net (F=64, fc 6, res 6, bf16). A block takes 3 boards,
   so the last block holds 1, 2 or 3 boards over these shapes. Then, at
   every width (``WIDTHS``: 4, 24, 48, 96, 128, 256, packed to 16, 32, 64,
   128, 128, 256), a fresh net at full depth (fc 6, res 6) at B=4096, 512,
   64 and 1, and at F=256 also at every shape of phase 8's generations
   (``WIDE_BOARDS``); above 256 filters (``LAYER_WIDTHS``: 264, 384, 512,
   520, 1024, packed to 320, 384, 512, 576, 1024, the layer kernel) at
   B=64 and 1, at 264 and 384 also at B=512, at F=512 also at every shape
   of [wider] (``WIDER_BOARDS``) and at F=1024 at every shape of [widest]
   (``WIDEST_BOARDS``): 0 elements may differ from
   the emulated plain version on the same packed weights, and the padded
   channels must be exactly 0. The script records the packed width and
   batch of every launch the paths make and fails if a pair was not among
   those compared.
   The tolerances are held against the plain version that emulates the
   tensor core's accumulate (and reproduces the kernel bit for bit); the
   errors against the plain version rounded to nearest, an independent
   reference, are printed beside them and held to limits of their own. The tile and block count of each shape
   are printed; at B=4096 and B=261 the kernel's other chain lengths are
   printed beside the shipped one, each against both plain versions summed
   in the same order;
3. time each kernel, its plain version and the cuDNN tower (a yardstick
   only: the port never calls it) at B=4096, 2048, 512, 392 and 64, beside
   the bound of each (the ``kernels`` line reports the batch that most
   launches of the training generations have, B=2048, their leaf batch),
   and with fresh nets at F=16, 32, 128, 256 and (the layer kernel) 320,
   384, 512, 520, 1024 at B=4096, 2048, 512 and 64 (the plain version
   rounded to nearest only: its emulated form takes tens of seconds at
   F=256);
4. check the search and self-play on the card against the same code on
   the CPU with the deterministic centre evaluator; then [graph]: the
   search replayed from CUDA graphs (every search on the card runs so,
   in every phase: an iteration is one graph, whose descent is one launch
   of the descent kernel) against its eager form with one generator seed,
   at the bench's pool (512 rows, K=8, 800 simulations in calls of 200)
   and at the gating match's K=1 side (its 49 two-ply starts, 64
   simulations, gen-161 and the centre heuristic), and with fresh nets of
   256 and 512 filters at 64 rows, K=8, ``GRAPH_SHAPES``: the eager form
   twice, then the graphed form twice, the second call replaying the
   graph under ``torch.cuda.set_sync_debug_mode("error")``, then the level
   form (the descent as ``min(t - 1, 42)`` replays of a one-level graph, as
   the search ran before the descent kernel) twice; equal bit for bit in
   moves, policies, values and every tree slab, the same tower launches
   (counted at replay), the descent kernel launched once an iteration; the
   search and iteration ms of every form and each graph's capture ms are
   printed. On the trees of each shape before an early, a middle and the
   last iteration's descent, the descent kernel must differ in 0 elements
   from ``descend_plain`` (the level loop until no row descends) and from
   ``min(t - 1, 42)`` levels; at the bench and match shapes it is timed
   (device time from a profiler trace) beside its bound and the level
   graphs' replays. Then a refill pool (``GRAPH_SYNC_POOL``) plays under
   the ``"warn"`` mode and its host syncs are counted by the line that
   made them;
5. drive the self-play path: a generation through
   ``make_net_evaluator`` + ``make_refill_play_fn`` with gen-161, 512 slots,
   K=8, 64 simulations, 512 games, noise and sampling on. Every game must
   finish and replay legally on the host board; the kernel launch counts
   are read from this run alone, and the descent kernel must have been
   launched once a search iteration;
6. check the learner on the card against the CPU: three SGD steps of the
   full-width net (F=64, fc 6, res 6) on 512 legal positions with made-up
   targets from the same weights, in float32 (IEEE float32 on the card, as
   ``utils.full_float32`` sets it) and in bf16, each with its stated limit;
7. time a train step (forward, backward, update) at batch 4096 in bf16 and
   float32;
8. drive the training path at full width: a ``TrainingLoop`` in a temporary
   directory with a freshly initialised F=64 / fc 6 / res 6 bf16 net, 512
   training games in 256 slots (the refill path), K=8, 64 simulations (cut
   from 800 for the time limit), 5 epochs at batch 4096, the packaged 7-ply
   and 8-ply sets and the 98-game gating match against the centre
   heuristic; then a new ``TrainingLoop`` on the same directory resumes at
   generation 2 and runs it. Losses must be finite, parameters and running
   statistics must change, generation 2's replay window and checkpoint must
   exist, the resumed state must equal the saved one bit for bit, and the
   tower kernel must have been launched by the self-play and by the match
   of each generation while its plain version was never entered;
9. play gen-161 against the centre heuristic (64 simulations, 2-ply starts,
   both colours): a return under 0.5 is a fault;
10. [wide] phase 8's two generations (the second resumed in a new loop)
    with a fresh net of 256 filters (``WIDE_NET``: fc 6, res 6, bf16), in a
    directory of their own, with phase 8's checks; every launch must be at
    F=256 and compared, and the plain tower is never entered;
11. [wider] the same two generations with a fresh net of 512 filters
    (``WIDER_NET``), the layer kernel, cut to 128 games in 64 slots and 5
    epochs at batch 1024 (``WIDER_DEPTH``), with phase 8's checks; every
    launch must be at F=512 and compared, every forward 13 launches of the
    layer kernel, and the plain tower is never entered; then [widest]:
    self-play through ``make_net_evaluator`` + ``make_refill_play_fn`` with
    a fresh net of 1024 filters (``WIDEST_NET``, the layer kernel in four
    column tiles), 64 games in 64 slots, K=8, 64 simulations, noise on
    (``WIDEST``): every game must finish and replay legally on the host
    board, every launch must be at F=1024 and compared, every forward 13
    launches of the layer kernel, and the plain tower is never entered;
12. [scripts] the run and measurement tools of ``connect4_tpu_torch.scripts``
    at full width (``SCRIPTS``): ``reevaluate_run`` over phase 8's two
    generations, each row equal to the one the loop wrote within
    ``TOL_REEVALUATE``, and generation 2's rows on a cut of the sets equal
    to the tool's on the CPU within ``TOL_REEVALUATE_CPU``; ``matches`` between them; ``evaluate_posn --search``
    with gen-161 at 800 simulations; ``selfplay_breakdown`` at its defaults
    (256 slots, 800 simulations, K=8) for two waves, with the card's busy
    share; ``profile_search`` with its trace; ``sweep_search_batch``;
    ``descent_depth_profile``; one epoch of ``verify_supervised``;
    ``ship_run_artifacts``; ``measure_compile`` at 64 slots, 64 simulations
    and one 64-simulation segment, its cold phases (``import torch``, the
    CUDA context, a cold ``nvcc`` build of the tower and descent kernels,
    the libraries' load, the first and warm calls of the search programs,
    two refill generations of 256 games) in the child process it spawns, whose
    launches it reports and this script checks with its own;
    ``k_head_to_head`` with gen-161, K=8 against K=16 at 256 simulations
    (cut from 800), 2-ply starts in both colours; ``draw_bucket_diagnosis``
    at its defaults; ``draw_bucket_experiment`` on phase 8's generation 2,
    one epoch of each of the five default variants; ``finalize_fullset`` on
    phase 8's run and the full sets (``verify_supervised`` at 10 epochs);
    ``pallas_eval_speed`` at its defaults (gen-161 at B=2048 and 4096, its
    |dv| and |dp| between the library's convolutions and the kernel held to
    the JAX script's own on the same boards, ``EVAL_SPEED_JAX``, plus
    ``TOL_VALUE_PRIOR``).
    The tools of a folded bf16 net (``matches``, ``evaluate_posn``, the
    measurement tools, ``measure_compile``, ``k_head_to_head``) must launch
    the kernel and the others must not, every batch they launch must have
    been compared, the plain tower is never entered;
13. [dp] data parallelism with four ranks from two torchrun agents (two
    nodes of two ranks, ``--rdzv_backend c10d`` on a local port; each rank
    is this script re-entered as ``chip_smoke.py --dp-rank DIR``), all on
    ``cuda:0`` through gloo (NCCL refuses ranks that share a card); a rank
    or an agent that fails, or a launch that outlasts ``DP['timeout']``,
    fails the run, and nothing retries with fewer ranks. One line a rank
    says where it runs (rank, local rank, node, device, backend). Sharded
    refill self-play of 256 games in 256 slots (64 a rank) with gen-161
    (K=8, 64 simulations, noise on), whose games must finish, replay legally
    and open differently on every pair of ranks; the same pool with noise
    off, once with the centre evaluator, whose gathered games must equal
    one process's 4-block pool on the card game for game and move for move
    (policies and move values within 1e-5, as phase 4 holds the card to the
    CPU), and once with gen-161 through the tower kernel, whose count of
    games that differ from one process's pool is printed; three
    data-parallel train steps at full width and batch 4096 (1024 a rank),
    float32 and bf16, held against the single-process step with the limits
    of phase 6 (and the momentum buffers with ``TOL_DP_MOMENTUM``, which a
    planted fault must exceed), the replicas equal bit for bit after each,
    timed beside the single-process step with the share of the
    all-reduces; one ``TrainingLoop`` generation with ``mesh_shape=(4,)``
    at the depth of phase 8 (no match), then a resumed one, every rank
    starting at the same generation. Each rank's launches by batch go
    through the [shapes] check, and no rank may enter the plain tower;
14. a one-rank NCCL group takes one data-parallel step, bit for bit the
    single-process step;
15. [host] ``HostMCTS`` and ``GridSearch`` choose the tactic table's moves,
    and the batched search on the card agrees with ``HostMCTS``; the exact
    solver builds with g++ and agrees with exhaustive minimax on 300
    late-game positions of seeded random playouts;
16. [supervisor] the supervisor runs ``cli training --device cuda
    --generations 1`` on a tiny config; the child exits 0 with a checkpoint;
17. [entry] ``forward(*args)`` of ``connect4_tpu_torch.entry.entry()``
    (the flagship net, F=64 / fc 6 / res 6, float32, unfolded; the
    counterpart of ``__graft_entry__.entry``) on the card, held within
    ``TOL_ENTRY`` (1e-4, phase 6's float32 limit) of the same forward on
    the CPU with the same variables, on the zero example planes and on 256
    legal positions; the output shapes and the warm forward's ms at B=256
    (beside the same net called as a module) are printed with the card's
    name and power limit; it launches no tower kernel;
18. [dryrun] ``connect4_tpu_torch.entry.dryrun_multichip(8)``, eight gloo
    ranks sharing ``cuda:0``, then ``dryrun_multichip(1)``, one NCCL rank:
    each one ``TrainingLoop`` generation of the JAX hook's tiny
    configuration in fresh rank processes (sharded self-play, the
    data-parallel train pass, the checkpoint, rank 0's gating match), which
    must end with its OK line; the ranks' lines (rank, device, backend) and
    the seconds of each launch are printed, and a launch that fails fails
    the run;
19. print the ``kernels`` JSON line (``tower``: the fused kernel up to 64
    filters, at F=64; ``tower_wide``: the fused kernel at 128 and 256
    filters, ``tower_kernel_wide``, at F=256 and the batch most of [wide]'s
    forwards have; ``tower_layer`` at F=512; ``descent``: the descent
    kernel, its launches on the counted paths, each read just after its
    path with the count set to 0 just before it, its time, bound and the
    level graphs' time before the last iteration of [graph]'s bench shape,
    and its largest difference from its plain version over every snapshot;
    no single PyTorch call computes a descent, so its ``library_ms`` is
    null), the card's name and power limit, and last ``{"ok": true,
    "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable or the
package is not beside this script. A copy of every number goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

# stated tolerances, kernel vs plain version (same rounding points and the
# same order of summation; with the tensor core's accumulate emulated the
# plain version has so far equalled the kernel bit for bit)
TOL_VALUE_PRIOR = 2e-2  # max |diff| of value and of prior
TOL_TOWER_MEAN = 2e-3  # mean |diff| of the bf16 tower output
# The plain version rounded to nearest owes nothing to a model of the tensor
# core. It differs from the kernel inside a chain's float32 sum, which flips
# an occasional bf16 rounding that then propagates through the following
# layers. Against it the tower's mean and the prior keep the tolerances
# above; the value head, which amplifies single bf16 flips of the tower
# (its maximum over a batch moves between 0.012 and 0.027 with the draw of
# positions, whatever the chain), is held to the 5e-2 that the port's net is
# held to against the JAX package's (tests/test_torch_net.py).
TOL_VALUE_NEAREST = 5e-2
# [compare] at every width holds the tower's mean against the form rounded
# to nearest to TOL_TOWER_MEAN or, where that is larger, TOL_NEAREST_SPREAD
# times the mean distance between two forms that both round to nearest (the
# plain version summed as one chain a layer and as one chain a tap) on the
# same boards. In a random net of 256 filters and six residual blocks one
# flipped bf16 rounding spreads to about one unit in the last place of most
# later outputs, so a change of summation order alone moves a single
# board's mean by about TOL_TOWER_MEAN (the [compare] lines print it as
# "spread"); the kernel is held to no more than twice that.
TOL_NEAREST_SPREAD = 2.0

SMOKE = dict(slots=512, games=512, simulations=64, parallel_sims=8, seed=0)

# Batch shapes (boards) the kernel is held against its plain version at:
# every shape the driven paths launch it at, and two more. A pool of S slots
# evaluates S roots and S x 8 leaves and halves S down to 64 as it drains:
# 4096 ... 64 covers the 512-slot self-play of phase 5 and the 256-slot
# self-play of the generations. A match plays 49 boards: 49 roots, 392
# leaves at K=8 and 784 at K=16 (``k_head_to_head``'s K=8 against K=16;
# 784 = 3 x 261 + 1 leaves a last block of one board). 261 is the shape of
# the JAX package's tests, 1 a single board.
COMPARE_BOARDS = (4096, 2048, 1024, 784, 512, 392, 261, 256, 128, 64, 49, 1)
# The shapes timed. The kernels line reports the one that most launches of
# the path it counts have: the leaf batch of the generations' self-play, 2048.
TIME_BOARDS = (4096, 2048, 512, 392, 64)

# the training generation of phase 8 (depth cut from 800 simulations and
# 1200 games; widths and batch size are the bench workload's)
GENERATION = dict(
    net=dict(filters=64, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16"),
    games=512, slots=256, simulations=64, parallel_sims=8, batch_size=4096, epochs=5,
)

# [compare] at every width: a fresh net at full depth (fc 6, res 6) of each
# of these widths, which ``tower.pack_weights`` pads to 16, 32, 64, 128, 128
# and 256 filters; held at WIDTH_BOARDS, and the [wide] phase's width also at
# every batch phase 8's generations launch (a 256-slot pool at K=8 draining
# to 64 slots, and the match's 49 roots and 392 leaves).
WIDTHS = (4, 24, 48, 96, 128, 256)
WIDTH_BOARDS = (4096, 512, 64, 1)
WIDE_BOARDS = (4096, 2048, 1024, 512, 392, 256, 128, 64, 49, 1)
# ... and above 256 filters, where the layer kernel runs one conv a launch
# (packed to 320, 384, 512, 576 and 1024), at LAYER_BOARDS, except where
# COMPARE_AT says: the [wider] phase's width at every batch its generations
# launch (a 64-slot pool at K=8: 64 roots and 512 leaves; the match's 49
# and 392), 520 (the first width above the layer kernel's old limit of
# 512) at two, the [widest] phase's width at every batch its self-play
# launches (64 roots, 512 leaves). The emulated plain version costs about
# 4x F=256's a board at F=512 and 4x that again at 1024, so the lists stay
# short.
LAYER_WIDTHS = (264, 384, 512, 520, 1024)
LAYER_BOARDS = (512, 64, 1)
WIDER_BOARDS = (512, 392, 64, 49, 1)
WIDEST_BOARDS = (512, 64, 1)
# [time] of the other instantiations (F=64 is gen-161's, phase 3) and of the
# layer kernel, each with a fresh net at full depth
TIME_WIDTHS = (16, 32, 128, 256, 320, 384, 512, 520, 1024)
WIDE_TIME_BOARDS = (4096, 2048, 512, 64)
# [wide]: two training generations of phase 8's depth with a fresh net of
# 256 filters, the width of AlphaGo Zero's and AlphaZero's towers
WIDE_NET = dict(filters=256, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16")
# [wider]: the same with 512 filters (the layer kernel's widest), cut to 128
# games in 64 slots and 5 epochs at batch 1024 (128 games give about 3,200
# positions), so that its batches are few and the emulation can hold them
WIDER_NET = dict(WIDE_NET, filters=512)
WIDER_DEPTH = dict(games=128, slots=64, batch_size=1024)
# [widest]: self-play with a fresh net of 1024 filters (a width the layer
# kernel takes since it stages its input in k-slabs), 64 games in 64 slots
WIDEST_NET = dict(WIDE_NET, filters=1024)
WIDEST = dict(games=64, slots=64, simulations=64, parallel_sims=8, seed=0)
# the widths [compare] holds at batches of their own (see WIDE_BOARDS and LAYER_BOARDS)
COMPARE_AT = {WIDE_NET["filters"]: WIDE_BOARDS, WIDER_NET["filters"]: WIDER_BOARDS, 520: (64, 1),
              WIDEST_NET["filters"]: WIDEST_BOARDS}

# Stated limits of the learner on the card against the CPU after three steps
# at batch 512 (phase 6). float32: IEEE float32 on both, summed in different
# orders. bf16: both round every conv output to bf16, cuDNN and the CPU sum
# in different orders, so single roundings flip and spread.
TOL_TRAIN_F32 = dict(loss=1e-4, state=1e-4)
TOL_TRAIN_BF16 = dict(loss=5e-2, state=5e-3)
# The [dp] steps' momentum buffers against one process's after three steps
# at batch 4096: the largest sound readings on the H100 were 1.19e-4 in
# float32 and 1.70e-3 in bf16, each in value_head.conv.weight; the limit
# sits above them and below what a planted fault (the gradients averaged
# over the ranks, not summed) gives, which the [dp] phase reads every run.
TOL_DP_MOMENTUM = dict(float32=5e-4, bfloat16=5e-3)


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# (packed width, batch) pairs the kernel was held against its plain version
# at; filled by [compare], read by every [shapes] check
COMPARED = set()


class LaunchShapes:
    """Reads the tower kernel's launches by packed width and batch (boards)
    while a path is driven, from ``tower.run_tower.by_shape``, which the
    wrapper counts where it launches and where a CUDA graph replays a
    launch. ``take`` fails when a path launched a (width, batch) that was
    not compared with the plain version."""

    def __init__(self, tower):
        self.tower = tower
        tower.run_tower.by_shape = {}

    def drain(self) -> dict:
        """The launches ``{width: {batch: n}}`` since the last call."""
        seen, self.tower.run_tower.by_shape = self.tower.run_tower.by_shape, {}
        return seen

    def take(self, path: str):
        """The launches since the last call, checked."""
        return check_shapes(path, self.drain())


def check_shapes(path: str, seen: dict) -> dict:
    """Print a path's tower launches by packed width and batch; fail on a
    pair that was not held against the plain version."""
    seen = {int(f): dict(sorted(((int(b), n) for b, n in per.items()), reverse=True))
            for f, per in sorted(seen.items(), key=lambda kv: int(kv[0]))}
    log(f"[shapes] {path}: tower kernel launches by width and batch {seen}")
    missing = sorted((f, b) for f, per in seen.items() for b in per if (f, b) not in COMPARED)
    if missing:
        fail(f"{path} launched the tower kernel at (F, B) = {missing}, "
             f"which was not held against the plain version")
    return seen


def add_launches(total: dict, seen: dict) -> dict:
    """``seen`` ({width: {batch: n}}) added into ``total``, which is returned."""
    for f, per in seen.items():
        into = total.setdefault(f, {})
        for b, n in per.items():
            into[b] = into.get(b, 0) + n
    return total


def by_batch(seen: dict) -> dict:
    """Launches by batch, summed over the widths."""
    out = {}
    for per in seen.values():
        for b, n in per.items():
            out[b] = out.get(b, 0) + n
    return dict(sorted(out.items(), reverse=True))


def random_positions(n: int, generator, device):
    """``n`` legal positions reached by uniformly random play of 0..35
    plies (finished games stay as they ended)."""
    import torch

    from connect4_tpu_torch.env.core import initial_state, legal_moves, step

    state = initial_state((n,), device=device)
    plies = torch.randint(0, 36, (n,), generator=generator, device=device)
    for t in range(36):
        legal = legal_moves(state)
        weights = torch.where(legal.any(-1, keepdim=True), legal.float(), 1.0)
        move = torch.multinomial(weights, 1, generator=generator)[:, 0]
        state = step(state, move, t < plies)
    return state


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cudnn_tower(folded, config):
    """The folded tower as cuDNN bf16 convolutions (channels_last), the
    yardstick for ``library_ms``. Not used by the port."""
    import torch
    import torch.nn.functional as F

    from connect4_tpu_torch.models.net import lrelu

    w = {k: v.to(torch.bfloat16) for k, v in folded.items()}

    def run(nhwc):
        x = nhwc.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x = lrelu(F.conv2d(x, w["conv0.weight"], w["conv0.bias"], padding=1))
        for i in range(config.n_residuals):
            y = lrelu(F.conv2d(x, w[f"res.{2 * i}.weight"], w[f"res.{2 * i}.bias"], padding=1))
            y = F.conv2d(y, w[f"res.{2 * i + 1}.weight"], w[f"res.{2 * i + 1}.bias"], padding=1)
            x = lrelu(y + x)
        return x

    return run


def board_rows(n: int, generator, device):
    """``[n*42, 3]`` float32 tower input rows of ``n`` random positions."""
    from connect4_tpu_torch.env.core import to_planes

    return (to_planes(random_positions(n, generator, device)).permute(0, 2, 3, 1)
            .reshape(n * 42, 3).float().contiguous())


def compare_kernel(tower, packed, x2d, chain=None) -> dict:
    """Error sets of the kernel at ``chain`` against the plain version
    summed in the same order on the same packed weights: ``model`` with the
    tensor core's accumulate emulated, ``nearest`` rounded to nearest;
    ``padded_zero``: the channels the packing added are all 0; ``spread``:
    the mean and largest distance between the form rounded to nearest and
    the same form summed as one chain a tap."""
    import torch

    with torch.no_grad():
        tk = tower.run_tower(packed, x2d, chain=chain)
        torch.cuda.synchronize()
        vk, pk = tower.heads(packed, tk)
        sets = {"finite": bool(torch.isfinite(tk.float()).all()),
                "padded_zero": bool((tk[:, packed["vh_conv_w"].shape[0]:] == 0).all())}
        for name, tensor_core in (("model", True), ("nearest", False)):
            tp = tower.tower_plain(packed, x2d, chain or tower.CHAIN, tensor_core)
            vp, pp = tower.heads(packed, tp)
            d = (tk.float() - tp.float()).abs()
            sets[name] = {
                "differ": int((tk != tp).sum()), "tower_max": d.max().item(), "tower_mean": d.mean().item(),
                "value_max": (vk - vp).abs().max().item(),
                "prior_max": (pk - pp).abs().max().item(),
            }
        d = (tp.float() - tower.tower_plain(packed, x2d, "tap").float()).abs()
        sets["spread"] = {"tower_max": d.max().item(), "tower_mean": d.mean().item()}
    return sets


def show(sets: dict) -> str:
    return "; ".join(
        f"vs {name}: {e['differ']} differ, |tower| max {e['tower_max']:.6g} mean {e['tower_mean']:.3g}"
        f" |value| max {e['value_max']:.6g} |prior| max {e['prior_max']:.6g}"
        for name, e in ((n, sets[n]) for n in ("model", "nearest")))


def check_compare(where: str, e: dict, tower_mean_nearest: float = TOL_TOWER_MEAN):
    """Fail unless the kernel's output is finite, its padded channels are 0,
    it equals the emulated plain version in every element, and both plain
    versions are within the stated tolerances (the tower's mean against the
    form rounded to nearest within ``tower_mean_nearest``)."""
    if not e["finite"]:
        fail(f"kernel output not finite at {where}")
    if not e["padded_zero"]:
        fail(f"a padded channel of the kernel's output is not 0 at {where}")
    m, n = e["model"], e["nearest"]
    if m["differ"] or max(m["value_max"], m["prior_max"]) > TOL_VALUE_PRIOR or m["tower_mean"] > TOL_TOWER_MEAN:
        fail(f"kernel disagrees with the plain tower at {where}: {m} (0 elements may differ; "
             f"tolerance value/prior {TOL_VALUE_PRIOR}, tower mean {TOL_TOWER_MEAN})")
    if (n["value_max"] > TOL_VALUE_NEAREST or n["prior_max"] > TOL_VALUE_PRIOR
            or n["tower_mean"] > tower_mean_nearest):
        fail(f"kernel disagrees with the plain tower rounded to nearest at {where}: {n} "
             f"(tolerance value {TOL_VALUE_NEAREST}, prior {TOL_VALUE_PRIOR}, "
             f"tower mean {tower_mean_nearest:.6g})")


def fresh_folded(f: int, dev):
    """``(config, folded, packed)`` of a fresh net of ``f`` filters at
    ``WIDE_NET``'s depth, seeded by its width."""
    import torch

    from connect4_tpu_torch.config import NetConfig
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.net import fold_bn_params, init_net

    config = NetConfig(**{**WIDE_NET, "filters": f})
    folded = fold_bn_params(init_net(config, torch.Generator().manual_seed(f), device=dev))
    return config, folded, tower.pack_weights(config, folded)


def compare_boards(f: int):
    """The batches [compare] holds a fresh net of ``f`` filters at."""
    return COMPARE_AT.get(f, LAYER_BOARDS if f in LAYER_WIDTHS else WIDTH_BOARDS)


def compare_widths(dev, generator):
    """[compare] at every width of ``WIDTHS`` and ``LAYER_WIDTHS``: a fresh
    folded net at full depth, its packed (padded) weights through the
    kernel (the fused one, or above 256 the layer kernel) and both plain
    versions. Returns the error sets ``{F: {B: sets}}``."""
    from connect4_tpu_torch.models import tower

    errs = {}
    for f in WIDTHS + LAYER_WIDTHS:
        t0 = time.perf_counter()
        _, _, packed = fresh_folded(f, dev)
        fp = packed["conv1_w"].shape[1]
        errs[f] = {}
        for b in compare_boards(f):
            e = errs[f][b] = compare_kernel(tower, packed, board_rows(b, generator, dev))
            limit = max(TOL_TOWER_MEAN, TOL_NEAREST_SPREAD * e["spread"]["tower_mean"])
            log(f"[compare] F={f} (packed {fp}) B={b}: padded channels all 0 {e['padded_zero']}; {show(e)}; "
                f"spread of the nearest form: |tower| max {e['spread']['tower_max']:.6g} "
                f"mean {e['spread']['tower_mean']:.3g} (tower mean limit {limit:.3g})")
            check_compare(f"F={f} B={b}", e, limit)
            COMPARED.add((fp, b))
        log(f"[compare] F={f}: {time.perf_counter() - t0:.1f} s")
    return errs


def time_widths(dev, generator):
    """[time] at the widths of ``TIME_WIDTHS``: the kernel, the plain
    version (rounded to nearest) and the cuDNN tower (the yardstick; the
    port never calls it) at ``WIDE_TIME_BOARDS``, each beside the bound."""
    import torch

    from connect4_tpu_torch.models import tower

    out = {}
    for f in TIME_WIDTHS:
        config, folded, packed = fresh_folded(f, dev)
        lib_tower = cudnn_tower(folded, config)
        out[f] = {}
        with torch.no_grad():
            for b in WIDE_TIME_BOARDS:
                x2d = board_rows(b, generator, dev)
                nhwc = x2d.reshape(b, 6, 7, config.channels)
                bound_ms, bound_by, flops, nbytes = tower.tower_bound(config, b)
                t = out[f][b] = {
                    "ms": timed_ms(lambda: tower.run_tower(packed, x2d)),
                    "plain_ms": timed_ms(lambda: tower.tower_plain(packed, x2d), iters=3, warmup=1),
                    "library_ms": timed_ms(lambda: lib_tower(nhwc)),
                    "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                }
                t["ms_again"] = timed_ms(lambda: tower.run_tower(packed, x2d))
                log(f"[time] tower F={f} B={b}: kernel {t['ms']:.4f} ms (again {t['ms_again']:.4f}), "
                    f"plain {t['plain_ms']:.4f} ms, cuDNN {t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                    f"by {bound_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB), "
                    f"{flops / t['ms'] / 1e9:.1f} TFLOP/s, {100 * bound_ms / t['ms']:.1f}% of the bound")
    return out


def replay_games(out) -> int:
    """Replay every recorded game on the host board: legal moves, the
    recorded pre-move planes (where ``out`` has them), the recorded result.
    Returns the move count."""
    import numpy as np

    from connect4_tpu_torch.env.host_board import HostBoard

    moves = out.moves.cpu().numpy()
    planes = out.planes.cpu().numpy() if hasattr(out, "planes") else None
    length, result = out.length.cpu().numpy(), out.result.cpu().numpy()
    mask = out.mask.cpu().numpy()
    total = 0
    for g in range(moves.shape[0]):
        if not np.array_equal(mask[g], np.arange(42) < length[g]):
            fail(f"game {g}: ply mask is not a prefix")
        board = HostBoard()
        for t in range(int(length[g])):
            if planes is not None and not np.array_equal(planes[g, t], board.to_planes().astype(np.uint8)):
                fail(f"game {g} ply {t}: recorded planes differ from the replay")
            mv = int(moves[g, t])
            if mv not in board.valid_moves:
                fail(f"game {g} ply {t}: illegal move {mv}")
            board.make_move(mv)
        if board.result is None or board.result.code != int(result[g]):
            fail(f"game {g}: replay ends {board.result}, recorded result {int(result[g])}")
        total += int(length[g])
    return total


def check_train_step(dev, generator):
    """Phase 6: three SGD steps on the card against the same steps on the
    CPU, float32 and bf16, from the same weights and batches."""
    import copy

    import torch

    from connect4_tpu_torch.config import ModelConfig, NetConfig
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.training.learner import init_train_state, make_optimizer, make_train_step

    n = 512
    batches = []
    for _ in range(3):
        planes = to_planes(random_positions(n, generator, dev), dtype=torch.uint8)
        values = torch.randint(0, 3, (n,), generator=generator, device=dev).float() / 2
        priors = torch.softmax(2 * torch.randn((n, 7), generator=generator, device=dev), -1)
        batches.append((planes, values, priors))
    out = {}
    for dtype, tol in (("float32", TOL_TRAIN_F32), ("bfloat16", TOL_TRAIN_BF16)):
        config = ModelConfig(net_config=NetConfig(
            filters=64, n_fc_layers=6, n_residuals=6, compute_dtype=dtype))
        on_cpu = init_train_state(config, torch.Generator().manual_seed(7), "cpu")
        net = copy.deepcopy(on_cpu.net).to(dev)
        on_card = type(on_cpu)(net, make_optimizer(config, net))
        losses = {}
        for name, state, where in (("cpu", on_cpu, "cpu"), ("card", on_card, dev)):
            step = make_train_step(state.net, state.optimizer)
            losses[name] = [
                float(step(*(t.to(where) for t in batch))["loss"]) for batch in batches]
        d_loss = max(abs(a - b) for a, b in zip(losses["cpu"], losses["card"]))
        sd_cpu, sd_card = on_cpu.net.state_dict(), on_card.net.state_dict()
        d_state, worst = max(
            ((sd_cpu[k] - sd_card[k].cpu()).abs().max().item(), k)
            for k in sd_cpu if not k.endswith("num_batches_tracked"))
        finite = all(bool(torch.isfinite(v).all()) for v in sd_card.values())
        out[dtype] = {"losses_cpu": losses["cpu"], "losses_card": losses["card"],
                      "loss_max_diff": d_loss, "state_max_diff": d_state, "state_max_at": worst,
                      "tolerance": tol}
        log(f"[check] train step {dtype}, 3 steps at batch {n}, card vs CPU: losses "
            f"{['%.6f' % x for x in losses['card']]} vs {['%.6f' % x for x in losses['cpu']]}, "
            f"|loss| max {d_loss:.3g} (limit {tol['loss']}), |parameter or statistic| max "
            f"{d_state:.3g} at {worst} (limit {tol['state']})")
        if not finite or not d_loss <= tol["loss"] or not d_state <= tol["state"]:
            fail(f"the {dtype} train step on the card differs from the CPU: {out[dtype]}")
    return out


def time_train_step(dev, generator):
    """Phase 7: ms per train step (forward, backward, update) at batch 4096
    by CUDA events, on stored uint8 NCHW planes as the loop feeds them."""
    import torch

    from connect4_tpu_torch.config import ModelConfig, NetConfig
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.training.learner import init_train_state, make_train_step

    n = 4096
    planes = to_planes(random_positions(n, generator, dev), dtype=torch.uint8)
    values = torch.randint(0, 3, (n,), generator=generator, device=dev).float() / 2
    priors = torch.softmax(2 * torch.randn((n, 7), generator=generator, device=dev), -1)
    out = {}
    for dtype in ("bfloat16", "float32"):
        config = ModelConfig(net_config=NetConfig(
            filters=64, n_fc_layers=6, n_residuals=6, compute_dtype=dtype))
        state = init_train_state(config, torch.Generator().manual_seed(0), dev)
        step = make_train_step(state.net, state.optimizer)
        ms = timed_ms(lambda: step(planes, values, priors), iters=20, warmup=5)
        ms_again = timed_ms(lambda: step(planes, values, priors), iters=20, warmup=0)
        out[dtype] = {"batch": n, "ms": ms, "ms_again": ms_again, "positions_per_s": n / ms * 1e3}
        log(f"[train] {dtype} step at batch {n}: {ms:.3f} ms (again {ms_again:.3f}), "
            f"{n / ms * 1e3:,.0f} positions/s")
    return out


def drive_generations(dev, shapes, save_dir, net=GENERATION["net"], label="generation", depth=None):
    """Phase 8 (and [wide] with ``net=WIDE_NET``, [wider] with
    ``net=WIDER_NET`` and ``depth=WIDER_DEPTH``): two generations of
    ``TrainingLoop`` at ``GENERATION``'s depth (with ``depth``'s entries in
    place of its own) with a fresh net of widths ``net`` in ``save_dir``,
    the second in a new loop that resumes from the first one's checkpoint.
    Phase 8's run stays for the [scripts] phase."""
    import numpy as np
    import torch

    from connect4_tpu_torch.config import AlphaZeroConfig, ModelConfig, NetConfig, StorageConfig
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.training import checkpoint as ckpt
    from connect4_tpu_torch.training import replay
    from connect4_tpu_torch.training.loop import TrainingLoop
    from connect4_tpu_torch.training.tables import load_table

    G = {**GENERATION, **(depth or {})}

    def counting(method, counts, name):
        def run(*args, **kwargs):
            before = tower.run_tower.launches
            result = method(*args, **kwargs)
            counts[name] = tower.run_tower.launches - before
            return result
        return run

    generations = []
    with watching_plain(tower) as plain_calls:
        config = AlphaZeroConfig(
            model_config=ModelConfig(
                net_config=NetConfig(**net),
                batch_size=G["batch_size"], n_training_epochs=G["epochs"],
            ),
            storage_config=StorageConfig(save_dir=save_dir),
            simulations=G["simulations"], parallel_sims=G["parallel_sims"],
            n_training_games=G["games"], selfplay_batch=G["slots"], n_eval=1, seed=0,
        )
        previous = None
        for gen in (1, 2):
            loop = TrainingLoop(config, device=dev)  # generation 2: a new loop, resumed
            if loop.gen != gen:
                fail(f"[{label}] the loop starts at generation {loop.gen}, expected {gen}")
            before = {k: v.clone() for k, v in loop.state.net.state_dict().items()}
            if previous is not None:
                for k, v in previous.items():
                    if not torch.equal(v, before[k]):
                        fail(f"[{label}] resumed {k} differs from the saved one")
            counts = {"selfplay": 0, "match": 0}
            loop._generate_games = counting(loop._generate_games, counts, "selfplay")
            loop._match = counting(loop._match, counts, "match")
            tower.run_tower.launches = tower.run_tower.layer_launches = 0
            t0 = time.perf_counter()
            loop.run(generations=1)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            # what the card holds after the generation: the search graphs of
            # its self-play and match go with their search objects (the
            # collector first: the counting wrappers above tie the last
            # generation's loop into a cycle)
            gc.collect()
            allocated_mb = torch.cuda.memory_allocated() / 2**20
            reserved_mb = torch.cuda.memory_reserved() / 2**20
            previous = {k: v.clone() for k, v in loop.state.net.state_dict().items()}
            changed = [k for k in before if not torch.equal(before[k], previous[k])]
            unchanged = [k for k in before if k not in changed and not k.endswith("num_batches_tracked")]
            losses = loop.train_losses
            if not losses or not all(np.isfinite(losses)):
                fail(f"[{label} {gen}] training losses not finite: {losses}")
            if unchanged:
                fail(f"[{label} {gen}] training left these unchanged: {unchanged}")
            if not all(bool(torch.isfinite(v).all()) for v in previous.values()):
                fail(f"[{label} {gen}] a parameter or statistic is not finite")
            if counts["selfplay"] == 0 or counts["match"] == 0:
                fail(f"[{label} {gen}] tower kernel launches {counts}: a phase never launched it")
            if plain_calls:
                fail(f"[{label} {gen}] the plain tower was entered {len(plain_calls)} times on the card")
            planes, values, _ = replay.load_window(save_dir, gen)
            if ckpt.latest_generation(save_dir) != gen or not os.path.exists(
                    os.path.join(save_dir, str(gen), "ckpt", ckpt.FILE_NAME)):
                fail(f"[{label} {gen}] no checkpoint")
            match = load_table(save_dir, "match_results")[-1]
            rows8, rows7 = load_table(save_dir, "8ply"), load_table(save_dir, "7ply")
            if len(rows8) != gen or len(rows7) != gen:
                fail(f"[{label} {gen}] benchmark tables hold {len(rows8)} and {len(rows7)} rows")
            with np.load(os.path.join(save_dir, str(gen), "games.npz")) as games:
                moves = int(games["mask"].sum())
                if not (games["result"] != 0).all() or games["result"].shape[0] != G["games"]:
                    fail(f"[{label} {gen}] not every game finished")
                records = SimpleNamespace(**{k: torch.from_numpy(games[k]) for k in ("moves", "length", "result", "mask")})
            if replay_games(records) != moves:
                fail(f"[{label} {gen}] the games' lengths do not add up to their moves")
            phases = dict(loop.timer.seconds)
            info = {
                "generation": gen, "seconds": seconds, "phases": phases, "moves": moves,
                "allocated_mb": allocated_mb, "reserved_mb": reserved_mb,
                "layer_launches": tower.run_tower.layer_launches,
                "moves_per_s": moves / phases["generate"], "positions": int(len(values)),
                "train_steps": len(losses), "first_loss": losses[0], "last_loss": losses[-1],
                "match": match, "launches": dict(counts),
                "launches_by_width": shapes.take(f"{label} {gen}"),
                "8ply": {k: rows8[-1][k] for k in ("Average loss", "Accuracy")},
                "7ply": {k: rows7[-1][k] for k in ("Average loss", "Accuracy", "prior Accuracy")},
            }
            width = tower.kernel_width(net["filters"])
            if set(info["launches_by_width"]) != {width}:
                fail(f"[{label} {gen}] launches by width {info['launches_by_width']}: expected F={width} only")
            # above 256 filters every conv of every forward is a launch of the layer kernel
            per_forward = 1 + 2 * net["n_residuals"] if tower.is_layer_width(width) else 0
            if info["layer_launches"] != per_forward * (counts["selfplay"] + counts["match"]):
                fail(f"[{label} {gen}] {info['layer_launches']} layer kernel launches for "
                     f"{counts['selfplay'] + counts['match']} tower forwards at F={width}")
            generations.append(info)
            log(f"[{label}] {gen}{' (resumed in a new loop)' if gen == 2 else ''}: {seconds:.2f} s = "
                + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
                + f"; {moves} moves, {info['moves_per_s']:.1f} moves/s; {len(values)} positions, "
                f"{len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; every game replays on the "
                f"host board; match vs centre "
                f"{match['wins']}-{match['draws']}-{match['losses']} (return {match['return']:.3f}); "
                f"tower kernel launches: self-play {counts['selfplay']}, match {counts['match']}"
                + (f" (layer kernel launches {info['layer_launches']})" if per_forward else "")
                + f"; plain tower entered {len(plain_calls)} times; {allocated_mb:.1f} MB allocated on the card after it ({reserved_mb:.1f} MB reserved)")
    return {"config": {**G, "net": net}, "generations": generations}


@contextlib.contextmanager
def watching_plain(tower):
    """Count the entries into the plain tower while the block runs, by
    standing in front of ``tower.tower_plain``: on the card the paths must
    never enter it. Yields the list that grows by one an entry."""
    calls = []
    plain = tower.tower_plain

    def watched(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    tower.tower_plain = watched
    try:
        yield calls
    finally:
        tower.tower_plain = plain


def wide_phase(dev, shapes, net=WIDE_NET, label="wide", depth=None):
    """[wide]: phase 8's two generations with a fresh net of ``WIDE_NET``'s
    widths (256 filters) in a directory of their own; [wider] the same with
    ``WIDER_NET`` (512 filters, the layer kernel) at ``WIDER_DEPTH``."""
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{label}_") as save_dir:
        return drive_generations(dev, shapes, save_dir, net=net, label=label, depth=depth)


def widest_phase(dev, shapes):
    """[widest]: refill self-play with a fresh net of ``WIDEST_NET``'s
    widths (1024 filters) through ``make_net_evaluator``, at ``WIDEST``."""
    import torch

    from connect4_tpu_torch.config import MCTSConfig, NetConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.net import init_net
    from connect4_tpu_torch.training.self_play import make_refill_play_fn
    from connect4_tpu_torch.utils import make_generator

    net = init_net(NetConfig(**WIDEST_NET), torch.Generator().manual_seed(WIDEST["seed"]), device=dev)
    cfg = MCTSConfig(simulations=WIDEST["simulations"], root_dirichlet_alpha=0.3, root_exploration_fraction=0.25,
                     num_sampling_moves=6, parallel_sims=WIDEST["parallel_sims"])
    width = tower.kernel_width(WIDEST_NET["filters"])
    with watching_plain(tower) as plain_calls:
        play = make_refill_play_fn(make_net_evaluator(net), cfg, WIDEST["slots"], WIDEST["games"], device=dev)
        torch.cuda.synchronize()
        tower.run_tower.launches = tower.run_tower.layer_launches = 0
        t0 = time.perf_counter()
        out = play(make_generator(WIDEST["seed"], dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        forwards, layer_launches = tower.run_tower.launches, tower.run_tower.layer_launches
    launches_by_width = shapes.take("widest")
    n_moves = replay_games(out)
    if int(out.mask.sum()) != n_moves or not (out.result.cpu() != 0).all() or out.result.shape[0] != WIDEST["games"]:
        fail("[widest] not every game finished")
    if plain_calls:
        fail(f"[widest] the plain tower was entered {len(plain_calls)} times on the card")
    if set(launches_by_width) != {width} or sum(by_batch(launches_by_width).values()) != forwards:
        fail(f"[widest] launches by width {launches_by_width}: expected {forwards} forwards, all at F={width}")
    per_forward = 1 + 2 * WIDEST_NET["n_residuals"]
    if forwards == 0 or layer_launches != per_forward * forwards:
        fail(f"[widest] {layer_launches} layer kernel launches for {forwards} tower forwards at F={width}")
    log(f"[widest] {WIDEST['games']} games at F={WIDEST_NET['filters']} (packed {width}), {n_moves} moves in "
        f"{seconds:.2f} s, {n_moves / seconds:.1f} moves/s; every game replays on the host board; tower "
        f"forwards {forwards}, layer kernel launches {layer_launches}; plain tower entered {len(plain_calls)} times")
    return {"config": {**WIDEST, "net": WIDEST_NET}, "seconds": seconds, "moves": n_moves,
            "forwards": forwards, "layer_launches": layer_launches, "launches_by_width": launches_by_width}


def gen161_match(net, dev, shapes):
    """Phase 9: the packaged net against the centre heuristic."""
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
    from connect4_tpu_torch.eval.match import MatchPlayer, play_match
    from connect4_tpu_torch.models import tower

    cfg = MCTSConfig(simulations=64, parallel_sims=8)
    before = tower.run_tower.launches
    t0 = time.perf_counter()
    result = play_match(
        MatchPlayer("gen161", make_net_evaluator(net), cfg),
        MatchPlayer("centre", centre_evaluator_batched, cfg),
        plies=2, switch=True, seed=0, display=False, device=dev,
    )
    result = {**result, "seconds": time.perf_counter() - t0,
              "launches": tower.run_tower.launches - before,
              "launches_by_width": shapes.take("match")}
    log(f"[match] gen161 vs centre, 64 simulations, 98 games: {result['wins']} wins, {result['draws']} draws, "
        f"{result['losses']} losses, return {result['return']:.3f} in {result['seconds']:.1f} s, "
        f"tower kernel launches {result['launches']}")
    if result["return"] < 0.5 or result["launches"] == 0:
        fail(f"gen-161 does not beat the centre heuristic through the kernel: {result}")
    return result


# ---------------------------------------------------------------------------
# [scripts]: the run and measurement tools of ``connect4_tpu_torch.scripts``

# Their sizes on the card. Every batch the tools launch the tower at is in
# COMPARE_BOARDS: a match of 49 two-ply starts at K=8 (49, 392) and at K=16
# (784), one board (1), 256 slots at K=8 (256, 2048), a batch of 512 at K=8
# (512, 4096), and pools of 64 ... 256 rows at K=8 (measure_compile's 64
# slots: 64, 512).
SCRIPTS = dict(
    match_sims=64, match_k=8, posn_sims=800, breakdown_waves=2,
    search=dict(batch=512, sims=64, k=8),
    sweep=dict(batches=(64, 128), sims=64, k=8, sims_per_call=64),
    descent=dict(sims=400, k=8, sims_per_call=200, rows=256, pool_rows=(64, 128, 256)),
    supervised_epochs=1,
    measure_compile=dict(slots=64, sims=64, sims_per_call=64),
    k_head_to_head=dict(ka=8, kb=16, sims=256, plies=2),  # sims cut from 800
    draw_bucket_experiment=dict(gen=2, epochs=1),
)
# ``pallas_eval_speed`` at its defaults: the JAX script's own two routes
# (the folded net in XLA bf16 against the Pallas tower) differ on its boards
# by these max |dv| and |dp| at B=2048 and 4096, computed on the CPU by
# tests/test_torch_eval_speed.py, which pins them: two bf16 routes of
# gen-161 that round at other points differ by several hundredths on some
# board of thousands of random planes. The port's routes on the card are
# held to these plus TOL_VALUE_PRIOR.
EVAL_SPEED_JAX = {2048: (0.0648, 0.0250), 4096: (0.0595, 0.0216)}
POSITION = ". . . . . . .\n. . . . . . .\n. . . . . . .\n. . . x . . .\n. . o o x . .\n. x o o x o .\n"
TOL_REEVALUATE = 1e-5  # a re-evaluated row against the one the loop wrote
# ``reevaluate_run`` of generation 2 on the card against the same tool on
# the CPU, over the first REEVALUATE_CPU_ROWS positions of each set: the
# bf16 net rounds each conv output on both, cuDNN and the CPU sum in
# different orders. Held: every number of a row but the ``correct`` counts
# (which the accuracies carry), and the counts' totals exactly. The first
# reading on the H100 was 1.62e-3 (the 8ply accuracies 2 positions apart).
REEVALUATE_CPU_ROWS = 8192
TOL_REEVALUATE_CPU = 1e-2


def rows_max_diff(a: dict, b: dict) -> float:
    """The largest difference between two metric rows' numbers (the
    ``correct`` column's counts included); inf when their columns differ."""
    keys = set(a) - {"generation"}
    if keys != set(b) - {"generation"}:
        return float("inf")
    worst = 0.0
    for k in keys:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            if set(x) != set(y):
                return float("inf")
            worst = max([worst] + [abs(p - q) for key in x for p, q in zip(x[key], y[key])])
        else:
            worst = max(worst, abs(x - y))
    return worst


def stats_max_diff(a: dict, b: dict) -> float:
    """The largest difference between two metric rows' numbers, leaving
    out the ``correct`` counts; inf when the columns or the counts' totals
    differ."""
    if set(a) != set(b):
        return float("inf")
    if "correct" in a and {k: v[0] for k, v in a["correct"].items()} != {k: v[0] for k, v in b["correct"].items()}:
        return float("inf")
    return max(abs(a[k] - b[k]) for k in a if k not in ("correct", "generation"))


def reevaluate_card_and_cpu(reevaluate_run, run_dir, data_dir, tmp, dev):
    """``reevaluate_run`` of the last generation (stride 2 of two) on the
    card and on the CPU, over a cut of each set; returns the largest
    difference between their rows and the rows."""
    import numpy as np

    cut = os.path.join(tmp, "sets_cut")
    os.makedirs(cut)
    for name in ("connect4dataset_8ply.npz", "connect4dataset_7ply.npz"):
        with np.load(os.path.join(data_dir, name)) as full:
            np.savez(os.path.join(cut, name), **{k: full[k][:REEVALUATE_CPU_ROWS] for k in full.files})
    rows = {where: reevaluate_run.reevaluate(run_dir, cut, os.path.join(tmp, f"cut_{where}"), stride=2,
                                             device=device)
            for where, device in (("card", dev), ("cpu", "cpu"))}
    diff = max(stats_max_diff(a, b) for table in ("8ply", "7ply")
               for a, b in zip(rows["card"][table], rows["cpu"][table]))
    return diff, rows


def scripts_phase(dev, shapes, run_dir):
    """Phase 12, [scripts]: every tool at full width on the card through
    its plain function: ``reevaluate_run`` over the two phase-8
    generations (each row equal to the loop's own within TOL_REEVALUATE, and
    generation 2's rows on a cut of the sets equal to the CPU's within
    TOL_REEVALUATE_CPU), ``matches`` between them, ``evaluate_posn --search`` with gen-161 at 800
    simulations, ``selfplay_breakdown`` at its defaults, ``profile_search``
    with its trace, ``sweep_search_batch``, ``descent_depth_profile``,
    ``verify_supervised`` (one epoch), ``ship_run_artifacts``,
    ``measure_compile`` (its cold phases in a child process),
    ``k_head_to_head``, ``draw_bucket_diagnosis``,
    ``draw_bucket_experiment``, ``finalize_fullset`` and
    ``pallas_eval_speed``. Each tool is driven
    with the kernel's count set to 0 and read after it (``measure_compile``
    adds its child's launches, which the child counts by batch); a tool of
    a folded bf16 net must launch the kernel, the others (the learner's
    unfolded net, through cuDNN) must not, the plain tower is never entered
    and every batch launched must have been compared."""
    import numpy as np
    import torch

    from connect4_tpu_torch.config import MCTSConfig, StorageConfig
    from connect4_tpu_torch.env.core import initial_state
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.scripts import (
        _common,
        descent_depth_profile,
        draw_bucket_diagnosis,
        draw_bucket_experiment,
        evaluate_posn,
        finalize_fullset,
        k_head_to_head,
        matches,
        measure_compile,
        pallas_eval_speed,
        profile_search,
        reevaluate_run,
        selfplay_breakdown,
        ship_run_artifacts,
        sweep_search_batch,
        verify_supervised,
    )
    from connect4_tpu_torch.training import checkpoint as ckpt
    from connect4_tpu_torch.training.tables import load_table

    P = SCRIPTS
    data_dir = StorageConfig().data_dir
    out, launches, by_width = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scripts_") as tmp, watching_plain(tower) as plain_calls:
        position = os.path.join(tmp, "position.txt")
        with open(position, "w") as fh:
            fh.write(POSITION)
        fresh = make_net_evaluator(_common.fresh_net(dev))
        gen161 = make_net_evaluator(load_example_net(device=dev))
        tools = [
            ("reevaluate_run", False, lambda: reevaluate_run.reevaluate(
                run_dir, data_dir, os.path.join(tmp, "reevaluated"), device=dev)),
            ("matches", True, lambda: matches.matches(
                run_dir, [1, 2], P["match_sims"], plies=2, parallel_sims=P["match_k"], device=dev)),
            ("evaluate_posn", True, lambda: evaluate_posn.evaluate_posn(
                evaluate_posn.parse_position(position), evaluate_posn.load_player(None, None, P["posn_sims"], dev),
                True, dev)),
            ("selfplay_breakdown", True, lambda: selfplay_breakdown.run(waves=P["breakdown_waves"], device=dev)),
            ("profile_search", True, lambda: profile_search.profile_search(
                fresh, initial_state((P["search"]["batch"],), device=dev),
                MCTSConfig(simulations=P["search"]["sims"], parallel_sims=P["search"]["k"]),
                os.path.join(tmp, "trace"))),
            ("sweep_search_batch", True, lambda: sweep_search_batch.sweep(
                fresh, MCTSConfig(simulations=P["sweep"]["sims"], root_dirichlet_alpha=0.3,
                                  root_exploration_fraction=0.25, num_sampling_moves=6),
                P["sweep"]["batches"], [P["sweep"]["k"]], P["sweep"]["sims_per_call"], dev)),
            ("descent_depth_profile", True, lambda: descent_depth_profile.run(
                gen161, MCTSConfig(simulations=P["descent"]["sims"], root_dirichlet_alpha=0.3,
                                   root_exploration_fraction=0.25, num_sampling_moves=6,
                                   parallel_sims=P["descent"]["k"]),
                P["descent"]["sims_per_call"], P["descent"]["rows"], dev, P["descent"]["pool_rows"])),
            ("verify_supervised", False, lambda: verify_supervised.verify_supervised(
                data_dir, epochs=P["supervised_epochs"], device=dev)),
        ]
        config_file = os.path.join(tmp, "config.py")
        with open(config_file, "w") as fh:
            fh.write("from connect4_tpu_torch.config import *\n"
                     f"config = AlphaZeroConfig(storage_config=StorageConfig(save_dir={run_dir!r}))\n")
        mc, kh, dx = P["measure_compile"], P["k_head_to_head"], P["draw_bucket_experiment"]
        tools += [
            ("ship_run_artifacts", False, lambda: ship_run_artifacts.ship(config_file, os.path.join(tmp, "shipped"))),
            ("measure_compile", True, lambda: measure_compile.measure(
                mc["slots"], mc["sims"], sims_per_call=mc["sims_per_call"], device=dev)),
            ("k_head_to_head", True, lambda: k_head_to_head.k_head_to_head(
                make_net_evaluator(k_head_to_head.load_net(None, None, dev)[1]), kh["ka"], kh["kb"], kh["sims"],
                kh["plies"], dev)),
            ("draw_bucket_diagnosis", False, lambda: draw_bucket_diagnosis.diagnose(
                load_example_net(device=dev), data_dir, device=dev)),
            ("draw_bucket_experiment", False, lambda: draw_bucket_experiment.experiment(
                run_dir, dx["gen"], data_dir, epochs=dx["epochs"], device=dev)),
            ("finalize_fullset", False, lambda: finalize_fullset.finalize(
                config_file, os.path.join(tmp, "finalized"), device=dev)),
            ("pallas_eval_speed", True, lambda: pallas_eval_speed.eval_speed(
                load_example_net(device=dev), device=dev)),
        ]
        seconds = {}
        for name, launches_kernel, drive in tools:
            torch.cuda.synchronize()
            tower.run_tower.launches = 0
            t0 = time.perf_counter()
            out[name] = drive()
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launches[name] = tower.run_tower.launches
            add_launches(by_width, shapes.take(f"scripts {name}"))
            if name == "measure_compile":
                # the cold phases ran in a child process, which counted its
                # own launches by batch where the kernel was launched, all
                # at the packed width of the net it made
                launches[name] += out[name]["launches"]
                child = {tower.kernel_width(out[name]["filters"]): out[name]["launches_by_boards"]}
                add_launches(by_width, check_shapes("scripts measure_compile (child process)", child))
            if launches_kernel != (launches[name] > 0):
                fail(f"[scripts] {name} launched the tower kernel {launches[name]} times")
            if plain_calls:
                fail(f"[scripts] {name}: the plain tower was entered {len(plain_calls)} times on the card")
        # the tool's tables as written (JSON), against the loop's
        reeval_diff = max(rows_max_diff(mine, loop)
                          for table in ("8ply", "7ply")
                          for mine, loop in zip(load_table(os.path.join(tmp, "reevaluated"), table),
                                                load_table(run_dir, table)))
        t0 = time.perf_counter()
        cpu_diff, cpu_rows = reevaluate_card_and_cpu(reevaluate_run, run_dir, data_dir, tmp, dev)
        cpu_s = time.perf_counter() - t0
        shipped = load_example_net(out["ship_run_artifacts"]["npz"], device=dev)
        saved = ckpt.restore_checkpoint(run_dir, 2, device=dev)[0].net
        shipped_equal = all(torch.equal(v, shipped.state_dict()[k]) for k, v in saved.state_dict().items()
                            if not k.endswith("num_batches_tracked"))

    # --- checks and lines ----------------------------------------------------
    problems = []
    reeval = out["reevaluate_run"]
    log(f"[scripts] reevaluate_run: {seconds['reevaluate_run']:.1f} s, generations {reeval['generations']} on "
        f"{reeval['sets']} positions; 8ply MSE {[round(r['Average loss'], 5) for r in reeval['8ply']]}, 7ply "
        f"prior accuracy {[round(r['prior Accuracy'], 5) for r in reeval['7ply']]}; largest difference from the "
        f"loop's own rows {reeval_diff:.3g} (limit {TOL_REEVALUATE}); curves drawn: {reeval['curves']}")
    if len(reeval["8ply"]) != 2 or not reeval_diff <= TOL_REEVALUATE:
        problems.append(f"reevaluate_run differs from the loop's rows by {reeval_diff}")
    log(f"[scripts] reevaluate_run card against CPU: {cpu_s:.1f} s, generation {cpu_rows['cpu']['generations']} on "
        f"{cpu_rows['cpu']['sets']} positions; 8ply MSE card {cpu_rows['card']['8ply'][0]['Average loss']:.6f} "
        f"CPU {cpu_rows['cpu']['8ply'][0]['Average loss']:.6f}, 8ply accuracy card "
        f"{cpu_rows['card']['8ply'][0]['Accuracy']:.6f} CPU {cpu_rows['cpu']['8ply'][0]['Accuracy']:.6f}; largest "
        f"difference {cpu_diff:.3g} (limit {TOL_REEVALUATE_CPU})")
    if not cpu_diff <= TOL_REEVALUATE_CPU:
        problems.append(f"reevaluate_run on the card differs from the CPU's rows by {cpu_diff}")
    m = out["matches"]
    log(f"[scripts] matches: {seconds['matches']:.1f} s, generation 1 vs 2 at {m['simulations']} sims, K="
        f"{m['parallel_sims']}, 2-ply starts both colours: return {m['returns']['1-2']:.3f}; launches "
        f"{launches['matches']}")
    posn = out["evaluate_posn"]
    log(f"[scripts] evaluate_posn --search: {seconds['evaluate_posn']:.1f} s, gen-161 at {posn['simulations']} "
        f"sims: value {posn['value']:.4f}, move {posn['move']}, search value {posn['search_value']:.4f}, root "
        f"visits {posn['root_visits']}; launches {launches['evaluate_posn']}")
    if sum(posn["root_visits"]) != posn["simulations"] or not 0.0 <= posn["value"] <= 1.0:
        problems.append(f"evaluate_posn: {posn}")
    b = out["selfplay_breakdown"]
    log(f"[scripts] selfplay_breakdown: {seconds['selfplay_breakdown']:.1f} s, {b['slots']} slots ({b['live_rows']} "
        f"live), {b['simulations']} sims, K={b['parallel_sims']}: blocking wave {b['blocking_wave_ms']:.1f} ms = "
        f"init {b['init_ms']:.1f} + segments {b['segments_ms']:.1f} ({[round(t, 1) for t in b['segment_ms']]}) + "
        f"finish {b['finish_ms']:.1f}; without per-part syncs {b['unsynced_wave_ms']:.1f} ms; bare forward at "
        f"B={b['eval_batch']} {b['eval_ms']:.3f} ms (est. eval share {b['eval_share']:.1%}); card busy "
        f"{b['device_busy_ms']:.1f} ms of a traced segment of {b['traced_segment_ms']:.1f} ms = "
        f"{b['device_busy_share']:.1%} ({b['device_busy_share_of_untraced']:.1%} of an untraced segment); "
        f"{b['sims_per_s']:,.0f} sims/s = {b['achieved_tflops']:.3f} TFLOP/s, {b['mfu']:.3%} of the bf16 peak; "
        f"bare forward {b['eval_tflops']:.1f} TFLOP/s ({b['eval_mfu']:.1%}); an iteration {b['iteration_ms']:.2f} ms, "
        f"the descent kernel {b['descent_ms'] * 1e3:.2f} us (device time, {b['descent_launches_traced']} launches "
        f"traced), a tail {b['tail_ms']:.3f} ms; launches {launches['selfplay_breakdown']}")
    g = b["graphed"]
    log(f"[scripts] selfplay_breakdown, graphed: warm-up and captures {g['warm_s']:.2f} s (captures "
        f"{', '.join(f'{k} {v:.1f} ms' for k, v in g['capture_ms'].items())}); blocking wave "
        f"{g['blocking_wave_ms']:.1f} ms = init {g['init_ms']:.1f} + segments {g['segments_ms']:.1f} + finish "
        f"{g['finish_ms']:.1f}; without per-part syncs {g['unsynced_wave_ms']:.1f} ms; an iteration "
        f"{g['iteration_ms']:.3f} ms, the descent kernel {g['descent_ms'] * 1e3:.2f} us (device time, "
        f"{g['descent_launches_traced']} launches traced), a tail {g['tail_ms']:.4f} ms; card busy "
        f"{g['device_busy_ms']} ms of a traced segment of {g['traced_segment_ms']:.1f} ms = "
        f"{g['device_busy_share']} ({g['device_busy_share_of_untraced']} of an untraced segment); "
        f"{g['sims_per_s']:,.0f} sims/s, {g['mfu']:.3%} of the bf16 peak")
    ps = out["profile_search"]
    log(f"[scripts] profile_search: {seconds['profile_search']:.1f} s (trace read in {ps['read_s']:.1f} s, "
        f"{ps['events']} events), batch {ps['batch']}, {ps['simulations']} sims, K={ps['parallel_sims']}: "
        f"{ps['steady_s']:.3f} s traced, {ps['sims_per_s']:,.0f} sims/s, card busy {ps['device_busy_ms']} ms; "
        f"top {ps['top_ops_of']} ops: " + "; ".join(f"{o['name'][:60]} {o['ms']:.2f} ms x{o['count']}"
                                                     for o in ps["top_ops"][:5]))
    if ps["top_ops_of"] != "device" or not os.path.basename(ps["trace"]):
        problems.append("profile_search: the trace holds no work of the card")
    for r in out["sweep_search_batch"]:
        log(f"[scripts] sweep_search_batch: batch {r['batch']} K={r['parallel_sims']}, "
            f"{P['sweep']['sims']} sims: first {r['first_s']:.2f} s, steady {r['steady_s']:.3f} s, "
            f"{r['sims_per_s']:,.0f} sims/s")
    d = out["descent_depth_profile"]
    log(f"[scripts] descent_depth_profile: {seconds['descent_depth_profile']:.1f} s, gen-161, {d['simulations']} "
        f"sims, K={d['parallel_sims']}: depth (mean/p95/max) by ply after the last segment "
        + ", ".join(f"{r['ply']}: {r['final'][0]:.1f}/{r['final'][1]:.0f}/{r['final'][2]}" for r in d["depth_by_age"])
        + "; segment ms by rows " + ", ".join(f"{r['rows']}: {r['ms']:.1f}" for r in d["segment_by_rows"]))
    v = out["verify_supervised"]
    e = v["epochs"][-1]
    log(f"[scripts] verify_supervised: {seconds['verify_supervised']:.1f} s, {v['positions']} positions, "
        f"{e['steps']} steps at batch {v['batch_size']} in {e['seconds']:.2f} s, losses {e['losses'][:1]} -> "
        f"{e['losses'][-1:]}, sample accuracy {e['stats']['Accuracy']:.4f}")
    if not e["losses"] or not np.isfinite(e["losses"]).all():
        problems.append(f"verify_supervised: losses not finite {e['losses']}")
    log(f"[scripts] ship_run_artifacts: {seconds['ship_run_artifacts']:.1f} s, generation "
        f"{out['ship_run_artifacts']['generation']} shipped, loads bit for bit: {shipped_equal}")
    if not shipped_equal:
        problems.append("ship_run_artifacts: the shipped net differs from the checkpoint")
    mcr = out["measure_compile"]
    log(f"[scripts] measure_compile: {seconds['measure_compile']:.1f} s, child process {mcr['child_pid']} (this "
        f"process {mcr['parent_pid']}; torch loaded at its start: {mcr['torch_loaded_at_start']}), "
        f"{mcr['slots']} slots, {mcr['sims']} sims, K={mcr['parallel_sims']}: interpreter start "
        f"{mcr['interpreter_start_s']:.2f} s, import torch {mcr['import_torch_s']:.2f} s, import the port "
        f"{mcr['import_port_s']:.2f} s, CUDA context {mcr['cuda_context_s']:.2f} s, cold nvcc build of the tower and "
        f"the descent {mcr['nvcc_build_s']:.2f} s, library load {mcr['library_load_s']:.3f} s; first / warm call: "
        + ", ".join(f"{k} {t['first_s']:.3f} / {t['warm_s']:.3f} s" for k, t in mcr["programs"].items())
        + f"; graph captures at {mcr['slots']} rows {mcr['capture_ms']} ms; refill generation of "
        f"{mcr['generation']['games']} games first {mcr['generation']['first_s']:.2f} s, second "
        f"{mcr['generation']['second_s']:.2f} s, its captures by pool width {mcr['generation']['capture_ms']} ms; "
        f"launches in the child {mcr['launches']}")
    for line in mcr["ptxas"]:
        if "registers" in line or "Compiling entry" in line:  # the full report is in chip_smoke.json
            log(f"[scripts] measure_compile ptxas: {line}")
    if (mcr["child_pid"] == os.getpid() or mcr["torch_loaded_at_start"] or not mcr["ptxas"]
            or mcr["generation"]["finished"] != mcr["generation"]["games"] or not mcr["capture_ms"]
            or not mcr["generation"]["capture_ms"]):
        problems.append(f"measure_compile: not a cold child process, no build report or unfinished games: "
                        f"{ {k: mcr[k] for k in ('child_pid', 'torch_loaded_at_start', 'generation')} }")
    khr = out["k_head_to_head"]
    log(f"[scripts] k_head_to_head: {seconds['k_head_to_head']:.1f} s, gen-161, K={khr['ka']} against "
        f"K={khr['kb']} at {kh['sims']} sims, {kh['plies']}-ply starts both colours: {json.dumps(khr)}; launches "
        f"{launches['k_head_to_head']}")
    if khr["wins"] + khr["draws"] + khr["losses"] != 98:
        problems.append(f"k_head_to_head: {khr}")
    dg = out["draw_bucket_diagnosis"]
    log(f"[scripts] draw_bucket_diagnosis: {seconds['draw_bucket_diagnosis']:.1f} s, gen-161 on {dg['positions']} "
        f"solved 8-ply positions: " + "; ".join(
            f"target {c}: n {v['n']}, mean {v['mean_pred']:.4f}, median {v['median']:.4f}, bucket accuracy "
            f"{v['bucket_acc']:.4f}" for c, v in dg["classes"].items())
        + f"; best monotone recalibration {dg['recalibration']['accuracy']:.4f} (draw recall "
        f"{dg['recalibration']['draw_recall']:.4f}, thresholds {[round(t, 4) for t in dg['recalibration']['thresholds']]})")
    if sum(v["n"] for v in dg["classes"].values()) != dg["positions"]:
        problems.append("draw_bucket_diagnosis: the classes do not add up to the positions")
    ex = out["draw_bucket_experiment"]
    log(f"[scripts] draw_bucket_experiment: {seconds['draw_bucket_experiment']:.1f} s, generation {ex['gen']} of "
        f"phase 8's run, {dx['epochs']} epoch a variant: baseline MSE {ex['baseline']['mse']:.5f} acc "
        f"{ex['baseline']['acc']:.4f}; " + "; ".join(
            f"w={v['w']} lam={v['lam']} ({v['positions']} positions, {v['steps_per_epoch']} steps): MSE "
            f"{v['epochs'][-1]['mse']:.5f} acc {v['epochs'][-1]['acc']:.4f} draw {v['epochs'][-1]['acc_draw']:.4f}"
            for v in ex["variants"]))
    if not np.isfinite([v["epochs"][-1]["mse"] for v in ex["variants"]]).all():
        problems.append("draw_bucket_experiment: an MSE is not finite")
    fz = out["finalize_fullset"]
    fz_losses = [e["loss"] for e in fz["verify_supervised"]["epochs"]]
    log(f"[scripts] finalize_fullset: {seconds['finalize_fullset']:.1f} s, solved {fz['solved']}, generations "
        f"{fz['reevaluate_run']['generations']} re-evaluated, verify_supervised {len(fz_losses)} epochs, loss "
        f"{fz_losses[0]:.4f} -> {fz_losses[-1]:.4f}")
    if len(fz_losses) != 10 or not np.isfinite(fz_losses).all():
        problems.append(f"finalize_fullset: verify_supervised losses {fz_losses}")
    es = out["pallas_eval_speed"]
    if [row["batch"] for row in es["rows"]] != sorted(EVAL_SPEED_JAX):
        problems.append(f"pallas_eval_speed: batches {[row['batch'] for row in es['rows']]}, not its defaults")
    for row in es["rows"]:
        jdv, jdp = EVAL_SPEED_JAX.get(row["batch"], (0.0, 0.0))
        log(f"[scripts] pallas_eval_speed: gen-161 at B={row['batch']}: kernel first call "
            f"{row['first_s']:.3f} s; max |dv| {row['max_dv']:.4f}, max |dp| {row['max_dp']:.4f} (the JAX "
            f"script's {jdv} and {jdp}, limit those + {TOL_VALUE_PRIOR}); library (cuDNN) "
            f"{row['library_ms']:.3f} ms ({row['library_tflops']:.1f} TFLOP/s), kernel {row['kernel_ms']:.3f} ms "
            f"({row['kernel_tflops']:.1f} TFLOP/s), {es['iters']} calls each")
        if not (row["max_dv"] <= jdv + TOL_VALUE_PRIOR and row["max_dp"] <= jdp + TOL_VALUE_PRIOR):
            problems.append(f"pallas_eval_speed: the routes differ by more than the JAX script's {jdv}, {jdp} "
                            f"+ {TOL_VALUE_PRIOR}: {row}")
    finite = [b["blocking_wave_ms"], b["unsynced_wave_ms"], b["eval_ms"], b["device_busy_share"], ps["sims_per_s"],
              g["unsynced_wave_ms"], g["iteration_ms"], b["descent_ms"], g["descent_ms"]]
    if not np.isfinite(finite).all() or not 0 < b["device_busy_share"] <= 1:
        problems.append(f"selfplay_breakdown or profile_search: {finite}")
    if problems:
        fail("[scripts] " + "; ".join(problems))
    return {"config": SCRIPTS, "seconds": seconds, "launches": launches, "launches_by_width": by_width,
            "reevaluate_max_diff": reeval_diff, "reevaluate_cpu_max_diff": cpu_diff, "results": {
                k: r for k, r in out.items() if k not in ("reevaluate_run", "finalize_fullset")} | {
                "reevaluate_run": {k: reeval[k] for k in ("generations", "sets", "curves")},
                "finalize_fullset": {"solved": fz["solved"], "generations": fz["reevaluate_run"]["generations"],
                                     "supervised_losses": fz_losses}}}


# ---------------------------------------------------------------------------
# [dp]: data parallelism, four ranks from two torchrun agents (two nodes of
# two ranks) sharing the one card through gloo

DP = dict(
    nodes=2, per_node=2, world=4, device="cuda:0", backend="gloo",
    selfplay=dict(slots=256, games=256, simulations=64, parallel_sims=8, seed=0),
    batch=4096, steps=3, time_steps=5, seed=3, timeout=900,
)


def state_tensors(state) -> dict:
    """Every parameter, running statistic and momentum buffer of a
    ``TrainState`` by name."""
    out = {k: t.detach() for k, t in state.net.state_dict().items()}
    for name, p in state.net.named_parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum {name}"] = buf
    return out


def state_vector(state):
    """``state_tensors`` as one float64 vector (float32 and int64 convert
    exactly), to compare replicas bit for bit."""
    import torch

    return torch.cat([t.reshape(-1).double() for t in state_tensors(state).values()])


def state_max_diff(a, b, momentum: bool = False):
    """(largest |difference|, the entry it is in) between two states: of the
    net's parameters and running statistics, as the [check] train step
    compares them, or with ``momentum`` of the optimisers' momentum buffers."""
    ta, tb = state_tensors(a), state_tensors(b)
    keys = [k for k in ta if k.startswith("momentum ") == momentum and not k.endswith("num_batches_tracked")]
    return max(((ta[k].double() - tb[k].double()).abs().max().item(), k) for k in keys)


def train_batches(n, count, generator, dev):
    """``count`` training batches of ``n`` legal positions with made-up
    targets, in the stored uint8 NCHW form."""
    import torch

    from connect4_tpu_torch.env.core import to_planes

    out = []
    for _ in range(count):
        planes = to_planes(random_positions(n, generator, dev), dtype=torch.uint8)
        values = torch.randint(0, 3, (n,), generator=generator, device=dev).float() / 2
        priors = torch.softmax(2 * torch.randn((n, 7), generator=generator, device=dev), -1)
        out.append((planes, values, priors))
    return out


def quiet_config():
    """The [dp] self-play's search with noise and sampling off: every game
    is then a function of the evaluator alone, so the ranks' gathered pool
    can be held against one process's pool of the same blocks."""
    from connect4_tpu_torch.config import MCTSConfig

    sp = DP["selfplay"]
    return MCTSConfig(simulations=sp["simulations"], parallel_sims=sp["parallel_sims"])


def dp_rank(out_dir):
    """One rank of the [dp] phase, started by a torchrun agent as
    ``chip_smoke.py --dp-rank DIR`` on ``DP['device']``: sharded refill
    self-play (noise on, then noise off with the centre evaluator and with
    gen-161), data-parallel train steps against the single-process step
    (rank 0 runs that), and two ``TrainingLoop`` generations with
    ``mesh_shape=(4,)``, the second resumed. Its numbers go to
    ``<out_dir>/rank<r>.pt``; an exception fails the rank, its agent and
    the phase."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from connect4_tpu_torch.config import AlphaZeroConfig, MCTSConfig, ModelConfig, NetConfig, StorageConfig
    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.parallel import mesh as pmesh
    from connect4_tpu_torch.parallel.sharded import make_sharded_train_step
    from connect4_tpu_torch.training import learner
    from connect4_tpu_torch.training.learner import init_train_state, make_train_step
    from connect4_tpu_torch.training.loop import TrainingLoop
    from connect4_tpu_torch.training.self_play import make_refill_play_fn
    from connect4_tpu_torch.utils import make_generator, resolve_device

    dev = resolve_device(DP["device"])
    pmesh.initialize_distributed(DP["backend"], dev)  # torchrun's rendezvous (env://)
    mesh = pmesh.make_mesh((DP["world"],), dev)
    rank = mesh.rank
    out = {"mesh": {"rank": rank, "local_rank": mesh.local_rank, "node": int(os.environ["GROUP_RANK"]),
                    "world": mesh.world_size, "device": str(mesh.device), "backend": mesh.backend}}
    shapes = LaunchShapes(tower)
    plain_calls = []
    tower_plain = tower.tower_plain

    def watched_plain(*args, **kwargs):
        plain_calls.append(1)
        return tower_plain(*args, **kwargs)

    tower.tower_plain = watched_plain

    def replicas_equal(state):
        every = pmesh.all_gather_rows(state_vector(state)[None], mesh)
        return all(bool(torch.equal(every[0], every[r])) for r in range(1, DP["world"]))

    # --- sharded refill self-play: noise on, then noise off ------------------
    sp = DP["selfplay"]
    net_evaluator = make_net_evaluator(load_example_net(device=dev))
    cfg = MCTSConfig(simulations=sp["simulations"], parallel_sims=sp["parallel_sims"],
                     root_dirichlet_alpha=0.3, root_exploration_fraction=0.25, num_sampling_moves=6)
    runs = (("selfplay", net_evaluator, cfg, True), ("quiet_centre", centre_evaluator_batched, quiet_config(), False),
            ("quiet_gen161", net_evaluator, quiet_config(), False))
    for name, evaluator, config, fork in runs:
        play = make_refill_play_fn(evaluator, config, sp["slots"], sp["games"], mesh=mesh)
        generator = make_generator(sp["seed"], dev)
        if fork:  # each rank its own noise and openings
            generator = mesh.fork_generator(generator)
        mesh.barrier()
        torch.cuda.synchronize()
        tower.run_tower.launches = 0
        t0 = time.perf_counter()
        games = play(generator)
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0, "launches": tower.run_tower.launches,
                     "by_width": shapes.drain()}
        if rank == 0:
            torch.save(type(games)(*(x.cpu() for x in games)), os.path.join(out_dir, f"{name}.pt"))

    # --- data-parallel train steps against the single-process step -----------
    sound_all_reduce_grads = learner._all_reduce_grads

    def averaged_grads(net, mesh):  # the planted fault: averaged, not summed
        sound_all_reduce_grads(net, mesh)
        for p in net.parameters():
            p.grad.div_(mesh.world_size)

    t_train = time.perf_counter()
    batches = train_batches(DP["batch"], DP["steps"], make_generator(DP["seed"], dev), dev)
    out["train"] = {}
    for dtype in ("float32", "bfloat16"):
        config = ModelConfig(net_config=NetConfig(filters=64, n_fc_layers=6, n_residuals=6, compute_dtype=dtype))
        state = init_train_state(config, torch.Generator().manual_seed(7), dev)
        dp_step = make_sharded_train_step(state.net, state.optimizer, mesh)
        one = init_train_state(config, torch.Generator().manual_seed(7), dev)
        one_step = make_train_step(one.net, one.optimizer)
        faulty = init_train_state(config, torch.Generator().manual_seed(7), dev)
        faulty_step = make_train_step(faulty.net, faulty.optimizer, mesh=mesh)
        rec = {"loss_dp": [], "loss_one": [], "loss_max_diff": 0.0, "state_max_diff": (0.0, ""),
               "momentum_max_diff": (0.0, ""), "fault_momentum_max_diff": (0.0, ""), "replicas_equal": []}
        for batch in batches:
            rec["loss_dp"].append(float(dp_step(*batch)["loss"]))
            rec["replicas_equal"].append(replicas_equal(state))
            learner._all_reduce_grads = averaged_grads
            try:
                faulty_step(*batch)
            finally:
                learner._all_reduce_grads = sound_all_reduce_grads
            if rank == 0:
                rec["loss_one"].append(float(one_step(*batch)["loss"]))
                rec["loss_max_diff"] = max(rec["loss_max_diff"], abs(rec["loss_dp"][-1] - rec["loss_one"][-1]))
                rec["state_max_diff"] = max(rec["state_max_diff"], state_max_diff(state, one))
                rec["momentum_max_diff"] = max(rec["momentum_max_diff"], state_max_diff(state, one, True))
                rec["fault_momentum_max_diff"] = max(rec["fault_momentum_max_diff"],
                                                     state_max_diff(faulty, one, True))
        del faulty, faulty_step
        # time: every rank steps together, each all-reduce timed with the
        # card synchronised before and after it (a gloo all-reduce of a CUDA
        # tensor waits for the card anyway); rank 0 then times the plain
        # step on the whole batch while the other ranks wait
        mesh.barrier()
        spent = [0.0, 0]
        all_reduce = pmesh.Mesh.all_reduce

        def timed(self, tensor):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = all_reduce(self, tensor)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            spent[1] += 1
            return result

        pmesh.Mesh.all_reduce = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP["time_steps"]):
                dp_step(*batches[0])
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            pmesh.Mesh.all_reduce = all_reduce
        rec["dp_ms"] = total / DP["time_steps"] * 1e3
        rec["all_reduce_share"] = spent[0] / total
        rec["all_reduces_per_step"] = spent[1] / DP["time_steps"]
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP["time_steps"]):
                one_step(*batches[0])
            torch.cuda.synchronize()
            rec["one_ms"] = (time.perf_counter() - t0) / DP["time_steps"] * 1e3
        mesh.barrier()
        out["train"][dtype] = rec
    out["train_seconds"] = time.perf_counter() - t_train

    # --- the training generation on the mesh, then resumed -------------------
    G = GENERATION
    config = AlphaZeroConfig(
        model_config=ModelConfig(net_config=NetConfig(**G["net"]), batch_size=G["batch_size"],
                                 n_training_epochs=G["epochs"]),
        storage_config=StorageConfig(save_dir=os.path.join(out_dir, "run")),
        simulations=G["simulations"], parallel_sims=G["parallel_sims"], n_training_games=G["games"],
        selfplay_batch=G["slots"], n_eval=0, seed=0, mesh_shape=(DP["world"],),
    )
    out["generations"] = []
    for gen in (1, 2):
        loop = TrainingLoop(config, device=dev)  # generation 2: a new loop, resumed
        start = loop.gen
        tower.run_tower.launches = 0
        t0 = time.perf_counter()
        loop.run(generations=1)
        torch.cuda.synchronize()
        out["generations"].append({
            "generation": gen, "started_at": start, "seconds": time.perf_counter() - t0,
            "phases": dict(loop.timer.seconds), "launches": tower.run_tower.launches,
            "by_width": shapes.drain(), "steps": len(loop.train_losses),
            "first_loss": loop.train_losses[0], "last_loss": loop.train_losses[-1],
            "replicas_equal": replicas_equal(loop.state),
        })
    out["plain_calls"] = len(plain_calls)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_dp_agents(out_dir):
    """Start the two torchrun agents of [dp], each a node of ``per_node``
    ranks running ``chip_smoke.py --dp-rank out_dir``, meeting through the
    c10d rendezvous on a free local port, and wait for both. Fails, after
    killing both agents and their ranks, when either exits non-zero or they
    outlast ``DP['timeout']``: nothing retries with fewer ranks."""
    import signal
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    agents, logs = [], []
    for node in range(DP["nodes"]):
        logs.append(os.path.join(out_dir, f"agent{node}.log"))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(DP["nodes"]),
               "--nproc_per_node", str(DP["per_node"]), "--rdzv_backend", "c10d",
               "--rdzv_endpoint", f"127.0.0.1:{port}", os.path.abspath(__file__), "--dp-rank", out_dir]
        with open(logs[-1], "w") as fh:  # each agent in a session of its own: a kill takes its ranks
            agents.append(subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT,
                                           start_new_session=True))
    deadline = time.monotonic() + DP["timeout"]
    try:  # until both exit, one fails or the time is up
        while (any(agent.poll() is None for agent in agents) and not any(agent.returncode for agent in agents)
               and time.monotonic() < deadline):
            time.sleep(0.5)
    finally:
        for agent in agents:
            if agent.poll() is None:
                os.killpg(agent.pid, signal.SIGKILL)
                agent.wait()
    codes = [agent.returncode for agent in agents]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    for node, path in enumerate(logs):
        with open(path) as fh:
            text = fh.read()
        with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_dp_agent{node}.log"), "w") as fh:
            fh.write(text)
        if any(codes):
            log(f"[dp] agent {node} (exit {codes[node]}), the end of its log:\n{text[-3000:]}")
    if any(codes):
        fail(f"[dp] the agents exited with {codes} (killed after {DP['timeout']} s if negative)")


def drive_dp(dev, net, shapes):
    """Phase 13, [dp]: four ranks from two torchrun agents on the one card
    (gloo), checked; first, one process's pools of as many blocks as
    ranks, with noise off, to hold the ranks' gathered pools against."""
    import numpy as np
    import torch

    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
    from connect4_tpu_torch.training import checkpoint as ckpt
    from connect4_tpu_torch.training.self_play import make_refill_play_fn
    from connect4_tpu_torch.utils import make_generator

    sp = DP["selfplay"]
    one = {}
    for name, evaluator in (("quiet_centre", centre_evaluator_batched), ("quiet_gen161", make_net_evaluator(net))):
        play = make_refill_play_fn(evaluator, quiet_config(), sp["slots"], sp["games"], n_blocks=DP["world"],
                                   device=dev)
        out = play(make_generator(sp["seed"], dev))
        one[name] = type(out)(*(x.cpu() for x in out))
    shapes.take(f"dp reference, one process's {DP['world']}-block pool (not counted)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out_dir:
        t0 = time.perf_counter()
        run_dp_agents(out_dir)
        seconds = time.perf_counter() - t0
        res = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(DP["world"])]
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_dp.json"), "w") as fh:
            json.dump(res, fh, indent=1, default=str)
        games = {name: torch.load(os.path.join(out_dir, f"{name}.pt"), weights_only=False)
                 for name in ("selfplay", "quiet_centre", "quiet_gen161")}
        run = os.path.join(out_dir, "run")
        if ckpt.latest_generation(run) != 2:
            fail(f"[dp] the mesh generations left checkpoint {ckpt.latest_generation(run)}, expected 2")
        for gen in (1, 2):
            with np.load(os.path.join(run, str(gen), "games.npz")) as g:
                if g["result"].shape[0] != GENERATION["games"] or not (g["result"] != 0).all():
                    fail(f"[dp] generation {gen}: not every game finished")
    # print every line first, then fail on what is wrong
    problems = []
    log(f"[dp] {DP['world']} ranks from {DP['nodes']} torchrun agents on {DP['device']} ({DP['backend']}), "
        f"{seconds:.1f} s from launch to exit (rank 0: self-play {res[0]['selfplay']['seconds']:.1f} s, "
        f"noise off {res[0]['quiet_centre']['seconds']:.1f} + {res[0]['quiet_gen161']['seconds']:.1f} s, "
        f"train-step checks {res[0]['train_seconds']:.1f} s, generations "
        f"{sum(g['seconds'] for g in res[0]['generations']):.1f} s)")
    for r, rr in enumerate(res):
        m = rr["mesh"]
        log(f"[dp] rank {m['rank']}: local rank {m['local_rank']}, node {m['node']}, world {m['world']}, "
            f"device {m['device']}, backend {m['backend']}")
    # torchrun numbers a node's ranks contiguously: rank = node * per_node + local rank
    where = [tuple(rr["mesh"][k] for k in ("rank", "local_rank", "node", "world", "device", "backend"))
             for rr in res]
    if where != [(r, r % DP["per_node"], r // DP["per_node"], DP["world"], DP["device"], DP["backend"])
                 for r in range(DP["world"])]:
        problems.append(f"the ranks do not form {DP['nodes']} nodes of {DP['per_node']}: "
                        f"{[rr['mesh'] for rr in res]}")
    moves = replay_games(games["selfplay"])
    if games["selfplay"].result.shape[0] != sp["games"] or not bool((games["selfplay"].result != 0).all()):
        problems.append("sharded self-play: not every game finished")
    per = sp["games"] // DP["world"]
    openings = [games["selfplay"].moves[r * per:(r + 1) * per, :6] for r in range(DP["world"])]
    same = [(a, b) for a in range(DP["world"]) for b in range(a + 1, DP["world"])
            if torch.equal(openings[a], openings[b])]
    if same:
        problems.append(f"ranks {same} played the same openings")
    launches = {"selfplay": 0, "generation": 0}
    by_width = {}
    for r, rr in enumerate(res):
        if rr["plain_calls"]:
            problems.append(f"rank {r} entered the plain tower {rr['plain_calls']} times on the card")
        paths = ([("selfplay", "selfplay", rr["selfplay"]), ("selfplay noise off", "selfplay", rr["quiet_gen161"])]
                 + [("generation", "generation", g) for g in rr["generations"]])
        for name, key, p in paths:
            if p["launches"] == 0:
                problems.append(f"rank {r} never launched the tower kernel in {name}")
            launches[key] += p["launches"]
            add_launches(by_width, check_shapes(f"dp rank {r} {name}", p["by_width"]))
        if rr["quiet_centre"]["launches"]:
            problems.append(f"rank {r} launched the tower kernel with the centre evaluator")
    log(f"[dp] sharded refill self-play, {sp['games']} games in {sp['slots']} slots (gen-161, K=8, "
        f"{sp['simulations']} sims, noise on): {moves} moves replay on the host board, the {DP['world']} ranks' "
        f"openings differ pairwise; " + ", ".join(
            f"rank {r} {rr['selfplay']['seconds']:.2f} s, {rr['selfplay']['launches']} tower launches"
            for r, rr in enumerate(res)))
    compared = {}
    for name, label in (("quiet_centre", "the centre evaluator"), ("quiet_gen161", "gen-161 through the tower kernel")):
        got, want = games[name], one[name]
        replay_games(got)
        differ = int((~((got.moves == want.moves).all(1) & (got.length == want.length)
                        & (got.result == want.result) & (got.planes == want.planes).flatten(1).all(1))).sum())
        policy = (got.policies - want.policies).abs().max().item()
        value = (got.move_values - want.move_values).abs().max().item()
        # every game starts from the empty board: with noise off the pool may hold few distinct games
        distinct = len({tuple(m[:n].tolist()) for m, n in zip(got.moves, got.length)})
        compared[name] = {"games_differ": differ, "distinct_games": distinct, "policy_max_diff": policy,
                          "move_value_max_diff": value}
        log(f"[dp] noise off, {label}: the {DP['world']} ranks' gathered {sp['games']} games ({distinct} distinct) "
            f"against one process's {DP['world']}-block pool on the card: {differ} games differ; |policy| max {policy:.3g}, "
            f"|move value| max {value:.3g}" + (f"; tower launches by rank {[rr[name]['launches'] for rr in res]}"
                                               if name == "quiet_gen161" else ""))
        if name == "quiet_centre" and (differ or not bool((got.mask == want.mask).all()) or policy > 1e-5
                                       or value > 1e-5):
            problems.append(f"noise off, centre evaluator: the gathered pool differs from one process's "
                            f"({differ} games, |policy| {policy:.3g}, |move value| {value:.3g}; limit 1e-5)")
    for dtype, tol in (("float32", TOL_TRAIN_F32), ("bfloat16", TOL_TRAIN_BF16)):
        tol = {**tol, "momentum": TOL_DP_MOMENTUM[dtype]}
        recs = [rr["train"][dtype] for rr in res]
        r0 = recs[0]
        log(f"[dp] train step {dtype}, {DP['steps']} steps at batch {DP['batch']} "
            f"({DP['batch'] // DP['world']} a rank) vs one process on the card: losses "
            f"{['%.6f' % x for x in r0['loss_dp']]} vs {['%.6f' % x for x in r0['loss_one']]}, |loss| max "
            f"{r0['loss_max_diff']:.3g} (limit {tol['loss']}), |parameter or statistic| max "
            f"{r0['state_max_diff'][0]:.3g} at {r0['state_max_diff'][1]} (limit {tol['state']}), "
            f"|momentum| max {r0['momentum_max_diff'][0]:.3g} at {r0['momentum_max_diff'][1]} (limit "
            f"{tol['momentum']}; planted fault, gradients averaged over the ranks: "
            f"{r0['fault_momentum_max_diff'][0]:.3g} at {r0['fault_momentum_max_diff'][1]}); "
            f"replicas equal after each step {r0['replicas_equal']}")
        log(f"[dp] train step {dtype} time: data parallel {r0['dp_ms']:.2f} ms a step, one process "
            f"{r0['one_ms']:.2f} ms; all-reduces {r0['all_reduces_per_step']:.0f} a step, "
            f"{100 * r0['all_reduce_share']:.1f}% of a step (each timed with a sync around it)")
        if not all(r["replicas_equal"] == [True] * DP["steps"] for r in recs):
            problems.append(f"{dtype}: the replicas differ after a step")
        if (not r0["loss_max_diff"] <= tol["loss"] or not r0["state_max_diff"][0] <= tol["state"]
                or not r0["momentum_max_diff"][0] <= tol["momentum"]):
            problems.append(f"{dtype}: the data-parallel step differs from one process beyond {tol}")
        if not r0["fault_momentum_max_diff"][0] > tol["momentum"]:
            problems.append(f"{dtype}: the momentum check does not catch the planted fault")
    gens = [rr["generations"] for rr in res]
    for i, g in enumerate(gens[0]):
        log(f"[dp] generation {g['generation']}{' (resumed)' if i else ''} on the mesh: "
            f"{g['seconds']:.2f} s = " + ", ".join(f"{k} {v:.2f}" for k, v in g["phases"].items())
            + f"; {g['steps']} steps, loss {g['first_loss']:.4f} -> {g['last_loss']:.4f}; tower launches "
            + ", ".join(f"rank {r} {gr[i]['launches']}" for r, gr in enumerate(gens)))
        if [gr[i]["started_at"] for gr in gens] != [i + 1] * DP["world"]:
            problems.append(f"generation {i + 1}: the ranks started at {[gr[i]['started_at'] for gr in gens]}")
        if not all(gr[i]["replicas_equal"] for gr in gens):
            problems.append(f"generation {i + 1}: the replicas differ")
        if not (np.isfinite(g["first_loss"]) and np.isfinite(g["last_loss"])):
            problems.append(f"generation {i + 1}: losses not finite")
    if problems:
        fail("[dp] " + "; ".join(problems))
    return {"config": DP, "seconds": seconds, "ranks": res, "moves": moves, "noise_off": compared,
            "launches": launches, "launches_by_width": by_width}


def nccl_one_rank(dev):
    """Phase 14: a one-rank NCCL group takes one data-parallel step, which
    must equal the single-process step bit for bit (with cuDNN's
    deterministic algorithms, so that two runs of one step agree)."""
    import torch
    import torch.distributed as dist

    from connect4_tpu_torch.config import ModelConfig, NetConfig
    from connect4_tpu_torch.parallel import mesh as pmesh
    from connect4_tpu_torch.parallel.sharded import make_sharded_train_step
    from connect4_tpu_torch.training.learner import init_train_state, make_train_step
    from connect4_tpu_torch.utils import make_generator

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        pmesh.initialize_distributed("nccl", dev, init_method=f"file://{d}/init", rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh((1,), dev)
            batch = train_batches(512, 1, make_generator(DP["seed"], dev), dev)[0]
            config = ModelConfig(net_config=NetConfig(filters=64, n_fc_layers=6, n_residuals=6))
            states = [init_train_state(config, torch.Generator().manual_seed(7), dev) for _ in range(3)]
            losses = [float(make_sharded_train_step(states[0].net, states[0].optimizer, mesh)(*batch)["loss"])]
            losses += [float(make_train_step(s.net, s.optimizer)(*batch)["loss"]) for s in states[1:]]
            vecs = [state_vector(s) for s in states]
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = deterministic
    out = {"backend": mesh.backend, "losses": losses,
           "dp_equals_one": losses[0] == losses[1] and bool(torch.equal(vecs[0], vecs[1])),
           "one_equals_one": losses[1] == losses[2] and bool(torch.equal(vecs[1], vecs[2]))}
    log(f"[dp] one-rank {mesh.backend} group, one float32 step at batch 512: data parallel equals the "
        f"single-process step bit for bit: {out['dp_equals_one']} (two single-process steps: "
        f"{out['one_equals_one']}); loss {losses[0]!r}")
    if not out["dp_equals_one"]:
        fail(f"[dp] the one-rank NCCL step differs from the single-process step: {out}")
    return out


# tests/test_mcts.py's tactic table: (moves, plies, acceptable best moves)
TACTICS = [
    ([1, 1, 2, 2, 3, 3], 1, {0, 4}),
    ([6, 0, 6, 1, 5, 2], 2, {3}),
    ([5, 0, 5, 1, 5, 2], 1, {5}),
    ([], 1, {3}),
    ([0, 6, 1, 6, 0, 6], 2, {6}),
]


def host_phase(dev):
    """Phase 15, [host]: the reference searches choose the tactic table's
    moves and the batched search on the card agrees with the host MCTS;
    the solver builds with g++ and agrees with exhaustive minimax on
    late-game positions of seeded random playouts."""
    import numpy as np
    import torch

    from connect4_tpu_torch import build
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.env.convert import stack_boards
    from connect4_tpu_torch.env.host_board import HostBoard
    from connect4_tpu_torch.eval.evaluators import (
        centre_evaluator_batched,
        centre_evaluator_host,
        centre_value_host,
    )
    from connect4_tpu_torch.eval.grid_search import GridSearch, minimax_value
    from connect4_tpu_torch.mcts.batched import make_search_fn
    from connect4_tpu_torch.mcts.host import HostMCTS
    from connect4_tpu_torch.native import solver
    from connect4_tpu_torch.utils import make_generator

    for moves, plies, best in TACTICS:
        board = HostBoard()
        for m in moves:
            board.make_move(m)
        grid, _ = GridSearch(plies, centre_value_host).choose(board)
        config = MCTSConfig(simulations=7**plies + 1, pb_c_init=9999.0)
        host = HostMCTS(config, centre_evaluator_host)
        root = host.search(board.copy())
        host_move = host._best_child(root, board.player_to_move).move
        res = make_search_fn(centre_evaluator_batched, config)(stack_boards([board], device=dev),
                                                              make_generator(0, dev))
        base = int(res.tree.children_base[0, 0])
        visits = res.tree.visits[0, base:base + 7].cpu().numpy()
        host_visits = np.array([root.children[m].visits if m in root.children else 0 for m in range(7)])
        log(f"[host] {moves}: GridSearch {grid}, HostMCTS {host_move}, batched on the card "
            f"{int(res.move[0])} (expected {sorted(best)}); root visits equal {bool((visits == host_visits).all())}")
        if grid not in best or host_move not in best or int(res.move[0]) != host_move \
                or not (visits == host_visits).all():
            fail(f"[host] the searches disagree on {moves}")

    t0 = time.perf_counter()
    exact = solver.ExactSolver(1 << 22)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    boards = []
    while len(boards) < 300:
        board, target = HostBoard(), int(rng.integers(34, 40))
        while board.result is None and board.age < target:
            board.make_move(int(rng.choice(sorted(board.valid_moves))))
        if board.result is None:
            boards.append(board)

    def no_leaf(board):
        raise AssertionError("an exhaustive search evaluates no leaf")

    t0 = time.perf_counter()
    values = exact.absolute_values(boards)
    solve_s = time.perf_counter() - t0
    # minimax nudges a terminal value by the game's age/10000; the nearest
    # half is the game-theoretic value
    want = np.array([np.round(2 * minimax_value(b, 42 - b.age, no_leaf)) / 2 for b in boards])
    agree = int((values == want).sum())
    log(f"[host] solver (g++, {os.path.basename(build.library_path(solver.SOURCE, build.GXX))}) "
        f"ready in {build_s:.1f} s; {len(boards)} positions at ages 34-39: {agree} agree with exhaustive "
        f"minimax, solved in {solve_s:.3f} s ({exact.nodes:,} nodes)")
    if agree != len(boards):
        fail("[host] the solver disagrees with exhaustive minimax")
    return {"positions": len(boards), "agree": agree, "build_s": build_s, "solve_s": solve_s}


def supervisor_phase():
    """Phase 16, [supervisor]: the watchdog runs one generation of the
    training CLI on the card (a tiny float32 net, 8 games, no match) and the
    child's checkpoint exists."""
    from connect4_tpu_torch.training import checkpoint as ckpt
    from connect4_tpu_torch.training.supervisor import supervise

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sup_") as d:
        config = os.path.join(d, "config.py")
        with open(config, "w") as fh:
            fh.write(
                "from connect4_tpu_torch.config import *\n"
                "config = AlphaZeroConfig(\n"
                "    model_config=ModelConfig(net_config=NetConfig(filters=8, n_fc_layers=1, n_residuals=1),\n"
                "                             batch_size=64, n_training_epochs=1),\n"
                f"    storage_config=StorageConfig(save_dir={os.path.join(d, 'run')!r},\n"
                f"                                 data_dir={os.path.join(d, 'nodata')!r}),\n"
                "    simulations=8, parallel_sims=4, n_training_games=8, selfplay_batch=8, n_eval=0)\n")
        t0, launched = time.perf_counter(), time.time()
        code = supervise(config, os.path.join(d, "train.log"), generations=1, poll_seconds=0.5,
                         stall_seconds=300, settle_seconds=0, max_restarts=1, device="cuda",
                         extra_env={"PYTHONPATH": os.pathsep.join(filter(None, (ROOT, os.environ.get("PYTHONPATH"))))})
        seconds = time.perf_counter() - t0
        with open(os.path.join(d, "train.log")) as fh:
            tail = fh.read()[-2000:]
        saved = os.path.exists(os.path.join(d, "run", "1", "ckpt", ckpt.FILE_NAME))
    phases = [line.strip() for line in tail.splitlines() if line.startswith("generate:")]
    # the loop logs "Time now: <asctime>" as its generation starts: the
    # child's start on the card (interpreter, imports, CUDA) comes before it
    started = [time.mktime(time.strptime(line.split("Time now: ")[1].strip()))
               for line in tail.splitlines() if line.startswith("Time now: ")]
    startup = f"{started[0] - launched:.0f} s" if started else "not read"
    log(f"[supervisor] cli training --device cuda --generations 1 under the supervisor: exit {code}, "
        f"checkpoint {'written' if saved else 'MISSING'}, {seconds:.1f} s (the child's start to its "
        f"generation {startup}, to the second; the generation: {phases[-1] if phases else 'no phase line'})")
    if code != 0 or not saved:
        fail(f"[supervisor] the supervised run failed (exit {code}); its log ends:\n{tail}")
    return {"exit": code, "checkpoint": saved, "seconds": seconds}


# [graph]: the search as CUDA graphs against its eager form (the same ops
# dispatched one by one), with one generator seed: the bench's pool and
# search (512 rows, K=8, 800 simulations in calls of 200, gen-161) and the
# gating match's K=1 side at its 49 two-ply starts (64 simulations), with
# gen-161 and with the centre heuristic the loop's match plays it with;
# and fresh nets at 256 and 512 filters
GRAPH_SHAPES = (
    dict(name="bench 512x8", rows=512, parallel_sims=8, simulations=800, sims_per_call=200, evaluator="gen161"),
    dict(name="match 49x1", rows=49, parallel_sims=1, simulations=64, sims_per_call=None, evaluator="gen161"),
    dict(name="match 49x1 centre", rows=49, parallel_sims=1, simulations=64, sims_per_call=None,
         evaluator="centre"),
    # fresh nets at 256 filters (the wide kernel's cluster launch) and 512
    # (the layer kernel, whose tensor maps hold the graph pool's addresses)
    dict(name="wide 64x8", rows=64, parallel_sims=8, simulations=64, sims_per_call=None, evaluator="f256"),
    dict(name="wider 64x8", rows=64, parallel_sims=8, simulations=64, sims_per_call=None, evaluator="f512"),
)
# the shapes at which [graph] times the descent kernel: the bench's and
# the gating match's K=1 side
DESCENT_TIMED = ("bench 512x8", "match 49x1")
# the refill pool whose host syncs [graph] counts, a wave at a time
GRAPH_SYNC_POOL = dict(slots=64, games=128, simulations=64, parallel_sims=8)


def search_fields_differ(a, b) -> dict:
    """Elements that differ between two ``SearchResults``, by field (the
    tree's slabs by name); ``{}`` when they are equal bit for bit."""
    fields = {k: (getattr(a, k), getattr(b, k)) for k in ("move", "value", "values_policy", "visit_policy",
                                                           "root_value")}
    fields.update({f"tree.{k}": (x, y) for k, x, y in zip(a.tree._fields, a.tree, b.tree)})
    return {k: int((x != y).sum()) for k, (x, y) in fields.items() if not (x.shape == y.shape and bool((x == y).all()))}


def search_max_diff(a, b) -> float:
    """The largest |difference| over the floating fields of two results."""
    return max(float((x.float() - y.float()).abs().max()) for x, y in (
        (a.value, b.value), (a.values_policy, b.values_policy), (a.visit_policy, b.visit_policy),
        (a.root_value, b.root_value), (a.tree.stats, b.tree.stats), (a.tree.prior, b.tree.prior)))


# [graph]'s check of the descent kernel (``mcts/csrc/descent.cu``) on the
# trees of a real search: launches a snapshot's descent is timed over, and
# the level graph's replay timings (the parent's form of a descent)
DESCENT_TIME_REPS = 20
LEVEL_GRAPH_REPS = 5
# what one descent needs to move and compute, for its bound, each byte
# once: every row's flag is read (1 B); a row that descends reads its node,
# heights, age, depth, its root's block base and its root's visits (8 + 28
# + 4 + 8 + 4 + 4 B) and writes node, heights, age, flag and depth back (49
# B); a level reads the node's child block's stats (7 x 16 B: the node's
# own visits below the root are the chosen child's, read a level before),
# the node's prior row (28 B) and the chosen child's block base (4 B), and
# writes a path entry and a stone (8 + 1 B); the batch writes its level
# count once (8 B). The kernel reads more than that: all seven children's
# block bases a level (24 B more, its prefetch of the next level's base,
# so that a level waits for one L2 round trip and not two), and each
# node's visits again. A child's score is 14 float32 operations of
# ``batched._score_parts`` (log and sqrt counted as one)
DESCENT_ROW_BYTES = 56 + 49
DESCENT_LEVEL_BYTES = 144 + 9
DESCENT_BATCH_BYTES = 8
DESCENT_SCORE_OPS = 14
# the descent's latency floor: before its first level a row waits for two
# dependent reads (its node, then that node's block base), then for one a
# level (the child block, read beside its seven block bases), each an L2
# round trip (``scripts.l2_latency``'s pointer chase over a buffer the size
# of the bench shape's slabs), besides what an empty kernel takes
DESCENT_START_READS = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (the same)


def descent_fields(d) -> dict:
    """The tensors of a ``batched.Descent``, by name."""
    return {"node": d.node, "pieces": d.board.pieces, "height": d.board.height, "age": d.board.age,
            "result": d.board.result, "descending": d.descending, "path": d.path, "depth": d.depth,
            "level": d.level}


def clone_descent(d):
    import torch

    from connect4_tpu_torch.mcts.batched import Descent

    return Descent(d.node.clone(), d.board.map(torch.clone), d.descending.clone(), d.path.clone(),
                   d.depth.clone(), d.level.clone())


def restore_descent(d, d0) -> None:
    for name, x in descent_fields(d).items():
        x.copy_(descent_fields(d0)[name])


def descent_snapshots(search, roots, generator, active) -> dict:
    """Drive ``search`` through ``init`` and its iterations one by one and
    keep clones of the tree and the descent before the descent of
    iterations 2, T // 2 and T: ``{t: (tree, descent)}``."""
    import torch

    iterations = search.config.simulations // search.config.parallel_sims
    keep = sorted({2, iterations // 2, iterations})
    ws = search.init(roots, generator, active)
    snaps = {}
    for t in range(1, iterations + 1):
        ws.iteration = t
        if t in keep:
            snaps[t] = (type(ws.tree)(*(x.clone() for x in ws.tree)), clone_descent(ws.descent))
        search.iteration(ws)
    torch.cuda.synchronize()
    return snaps


def check_descent(tree, d0, t: int, config, k: int) -> dict:
    """From the descent ``d0`` on ``tree`` (before iteration ``t``'s
    walk): the kernel against ``descent_plain`` until no row descends, in
    elements that differ by field, and against ``min(t - 1, 42)`` levels of
    ``_descend_level`` (the level form; every field but ``level``). The kernel's
    launch is a comparison, so it is not counted. Also returns what the
    walk needed: rows that descended, levels walked, the deepest row's."""
    import torch

    from connect4_tpu_torch.mcts import batched
    from connect4_tpu_torch.mcts.batched import PATH_MAX, _descend_level

    rows = torch.arange(d0.node.shape[0], device=d0.node.device)
    capacity = tree.parent.shape[1] - 1
    kernel, plain, bounded = clone_descent(d0), clone_descent(d0), clone_descent(d0)
    before = batched.descend.launches
    batched.descend(kernel, tree, rows, config, capacity, k)
    batched.descend.launches = before
    batched.descend_plain(plain, tree, rows, config, capacity, k)
    for _ in range(min(t - 1, PATH_MAX - 2)):
        _descend_level(bounded, tree, rows, config, capacity, k)
    torch.cuda.synchronize()
    fk, fp, fb = descent_fields(kernel), descent_fields(plain), descent_fields(bounded)
    differ = {n: int((fk[n] != fp[n]).sum()) for n in fk}
    differ_bounded = {n: int((fk[n] != fb[n]).sum()) for n in fk if n != "level"}
    err = max(float((fk[n].double() - fp[n].double()).abs().max()) for n in fk)
    walked = kernel.depth - d0.depth
    return {"t": t, "differ": differ, "differ_bounded": differ_bounded, "max_abs_err": err,
            "rows": int(d0.node.shape[0]), "descending": int(d0.descending.sum()),
            "levels": int(walked.sum()), "deepest": int(walked.max()), "level": int(kernel.level[0])}


def descent_bound(c: dict) -> tuple:
    """The least time the card could take for one descent's bytes and
    operations: ``(ms, "bytes" or "operations", bytes, operations)``."""
    nbytes = (c["descending"] * DESCENT_ROW_BYTES + c["levels"] * DESCENT_LEVEL_BYTES + c["rows"]
              + DESCENT_BATCH_BYTES)
    ops = c["levels"] * 7 * DESCENT_SCORE_OPS
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes", nbytes, ops) if by_bytes >= by_ops else (by_ops, "operations", nbytes, ops)


def time_descents(snaps: dict, config, k: int) -> dict:
    """For each snapshot ``t -> (tree, descent)``: the descent kernel's
    device time (the median of ``DESCENT_TIME_REPS`` launches in one
    profiler trace, each from the snapshot), and the plain form the search
    ran before it, ``min(t - 1, 42)`` replays of a CUDA graph of one level
    (the median of ``LEVEL_GRAPH_REPS`` timings with CUDA events)."""
    import statistics

    import torch

    from connect4_tpu_torch.mcts import batched
    from connect4_tpu_torch.mcts.batched import PATH_MAX, _descend_level
    from connect4_tpu_torch.scripts._common import trace_events
    from connect4_tpu_torch.utils import trace

    before = batched.descend.launches
    work = {t: clone_descent(d0) for t, (_, d0) in snaps.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_descent_") as log_dir:
        with trace(log_dir):
            for t, (tree, d0) in snaps.items():
                rows = torch.arange(d0.node.shape[0], device=d0.node.device)
                for _ in range(DESCENT_TIME_REPS):
                    restore_descent(work[t], d0)
                    batched.descend(work[t], tree, rows, config, tree.parent.shape[1] - 1, k)
            torch.cuda.synchronize()
        events = trace_events(log_dir)
    batched.descend.launches = before
    durs = [e["dur"] for e in sorted(events, key=lambda e: e["ts"])
            if e.get("cat") == "kernel" and "descent_kernel" in e["name"]]
    if len(durs) != DESCENT_TIME_REPS * len(snaps):
        fail(f"[graph] the trace holds {len(durs)} descent kernels, not {DESCENT_TIME_REPS * len(snaps)}")
    out = {}
    for i, (t, (tree, d0)) in enumerate(snaps.items()):
        us = statistics.median(durs[i * DESCENT_TIME_REPS:(i + 1) * DESCENT_TIME_REPS])
        rows = torch.arange(d0.node.shape[0], device=d0.node.device)
        capacity = tree.parent.shape[1] - 1
        levels = min(t - 1, PATH_MAX - 2)
        plain = clone_descent(d0)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the warm-up, outside the capture
            _descend_level(plain, tree, rows, config, capacity, k)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _descend_level(plain, tree, rows, config, capacity, k)
        times = []
        for _ in range(LEVEL_GRAPH_REPS):
            restore_descent(plain, d0)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(levels):
                graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        # the replayed levels walk what the kernel walked
        same = all(bool((descent_fields(plain)[n] == descent_fields(work[t])[n]).all())
                   for n in descent_fields(plain) if n != "level")
        del graph
        out[t] = {"ms": us / 1e3, "plain_ms": statistics.median(times), "plain_levels": levels,
                  "plain_equal": same}
    return out


def level_form(search, roots, generator, active):
    """The search as it ran before the descent kernel, on ``search``'s
    workspace: every iteration ``min(t - 1, 42)`` levels and a tail
    (``Search.level_iteration``; with graphs, a level graph and a tail
    graph)."""
    import torch

    with torch.no_grad():
        ws = search.init(roots, generator, active)
        for t in range(1, search.config.simulations // search.config.parallel_sims + 1):
            ws.iteration = t
            search.level_iteration(ws)
        return search.finish(ws, generator)


def graph_phase(net, dev):
    """[graph]: at each of ``GRAPH_SHAPES``, the eager search twice (does it
    repeat itself?), then the graphed search twice with the same generator
    seed: the first call warms and captures the graph of an iteration
    (the descent kernel, the tail, the next descent's start), the second
    replays it under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises on any operation that waits for the card. The graphed search
    must equal the eager one bit for bit in moves, policies, values and
    every tree slab (or, if the eager form does not repeat itself, stay
    within its own spread), and also the level form (``level_form``: the
    parent's search, a level graph replayed ``min(t - 1, 42)`` times an
    iteration, then a tail graph); its tower launches, counted at replay,
    must equal the eager call's, and each form must launch the descent
    kernel once an iteration. On the trees of a search of the shape, before
    the descents of an early, a middle and the last iteration
    (``descent_snapshots``), the kernel must equal ``descend_plain`` until
    no row descends in every element (``check_descent``); at the bench and
    match shapes it is timed beside the level graphs (``time_descents``). A
    replayed search of the bench shape at 64 simulations is traced for the
    tower kernel's time inside the graph. Before the shapes, a pointer chase
    (``scripts.l2_latency``) measures one dependent L2 load and an empty
    kernel, the terms of the descent's latency floor. Then a refill pool
    (``GRAPH_SYNC_POOL``) plays twice with one play function, the second
    time under the ``"warn"`` mode: its host syncs are counted by the line
    that made them."""
    import warnings

    import torch

    from connect4_tpu_torch.config import MCTSConfig, NetConfig
    from connect4_tpu_torch.env.convert import stack_boards
    from connect4_tpu_torch.env.host_board import enumerate_start_positions
    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
    from connect4_tpu_torch.mcts import batched
    from connect4_tpu_torch.mcts.batched import Search
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.net import init_net
    from connect4_tpu_torch.scripts import l2_latency
    from connect4_tpu_torch.scripts._common import trace_events
    from connect4_tpu_torch.training.self_play import make_refill_play_fn
    from connect4_tpu_torch.utils import make_generator, trace

    # the two terms of the descent kernel's latency floor
    l2 = l2_latency.measure(dev)
    log(f"[graph] one dependent L2 load (a pointer chase over {l2['mib']} MiB, {l2['steps']} loads, median of "
        f"{l2['reps']}): {l2['round_trip_ms'] * 1e6:.1f} ns; an empty kernel {l2['empty_ms'] * 1e3:.2f} us "
        f"(device time)")
    if not (0 < l2["round_trip_ms"] < 1e-2 and 0 < l2["empty_ms"] < 1):
        fail(f"[graph] the L2 round trip measured {l2}")
    evaluators = {"gen161": make_net_evaluator(net), "centre": centre_evaluator_batched}
    out = {"l2": l2}
    for f, widths in ((256, WIDE_NET), (512, WIDER_NET)):
        fresh = init_net(NetConfig(**widths), torch.Generator().manual_seed(0), device=dev)
        evaluators[f"f{f}"] = make_net_evaluator(fresh)
    for shape in GRAPH_SHAPES:
        cfg = MCTSConfig(simulations=shape["simulations"], parallel_sims=shape["parallel_sims"],
                         root_dirichlet_alpha=0.3, root_exploration_fraction=0.25, num_sampling_moves=6)
        if shape["rows"] == 49:
            roots = stack_boards(enumerate_start_positions(2), device=dev)
        else:
            roots = random_positions(shape["rows"], make_generator(7, dev), dev)
        if roots.age.shape[0] != shape["rows"]:
            fail(f"[graph] {shape['name']}: {roots.age.shape[0]} roots")
        active = roots.result == 0
        iterations = shape["simulations"] // shape["parallel_sims"]
        k = shape["parallel_sims"] if shape["parallel_sims"] > 1 else 0

        def run(search, sync_mode=None, levels=False):
            generator = make_generator(11, dev)
            torch.cuda.synchronize()
            before = tower.run_tower.launches, batched.descend.launches
            t0 = time.perf_counter()
            if sync_mode:
                torch.cuda.set_sync_debug_mode(sync_mode)
            try:
                res = level_form(search, roots, generator, active) if levels else search(roots, generator, active)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            return (res, time.perf_counter() - t0, tower.run_tower.launches - before[0],
                    batched.descend.launches - before[1])

        evaluator = evaluators[shape["evaluator"]]
        eager = Search(evaluator, cfg, shape["sims_per_call"], graphs=False)
        e1, e1_s, e_launches, e_descents = run(eager)
        e2, e2_s, _, _ = run(eager)
        graphed = Search(evaluator, cfg, shape["sims_per_call"])
        g1, g1_s, g1_launches, _ = run(graphed)  # the warm-up and the capture
        g2, g2_s, g_launches, g_descents = run(graphed, "error")  # replays only
        (ws,) = graphed.workspaces.values()
        by_levels = Search(evaluator, cfg, shape["sims_per_call"])
        run(by_levels, levels=True)  # the warm-up and the captures of the level form
        lv, lv_s, lv_launches, lv_descents = run(by_levels, levels=True)
        (lv_ws,) = by_levels.workspaces.values()
        eager_repeats = not search_fields_differ(e1, e2)
        differ = {k_: search_fields_differ(e1, g) for k_, g in (("first", g1), ("replayed", g2))}
        differ_levels = search_fields_differ(g2, lv)
        spread = search_max_diff(e1, e2)

        # the descent kernel against its plain version on this shape's trees
        with torch.no_grad():
            snaps = descent_snapshots(Search(evaluator, cfg, graphs=False), roots, make_generator(11, dev),
                                      active)
        checks = [check_descent(tree, d0, t, cfg, k) for t, (tree, d0) in snaps.items()]
        times = time_descents(snaps, cfg, k) if shape["name"] in DESCENT_TIMED else {}
        for c in checks:
            c.update(times.get(c["t"], {}))
            c["bound_ms"], c["bound_by"], c["bytes"], c["operations"] = descent_bound(c)
            c["latency_floor_ms"] = (c["deepest"] + DESCENT_START_READS) * l2["round_trip_ms"] + l2["empty_ms"]
            c["binds"] = "latency" if c["latency_floor_ms"] > c["bound_ms"] else c["bound_by"]
        r = {
            **shape, "eager_repeats": eager_repeats, "eager_spread": spread,
            "differ_first": differ["first"], "differ_replayed": differ["replayed"],
            "differ_level_form": differ_levels,
            "max_diff_replayed": search_max_diff(e1, g2),
            "eager_s": [e1_s, e2_s], "graphed_first_s": g1_s, "graphed_s": g2_s, "level_form_s": lv_s,
            "eager_iteration_ms": e2_s / iterations * 1e3, "graphed_iteration_ms": g2_s / iterations * 1e3,
            "level_form_iteration_ms": lv_s / iterations * 1e3,
            "capture_ms": dict(ws.graphs.capture_ms), "level_form_capture_ms": dict(lv_ws.graphs.capture_ms),
            "replays": ws.graphs.replays,
            "tower_launches": {"eager": e_launches, "graphed_first": g1_launches, "graphed": g_launches,
                               "level_form": lv_launches},
            "descent_launches": {"eager": e_descents, "graphed": g_descents, "level_form": lv_descents},
            "descent_checks": checks,
        }
        out[shape["name"]] = r
        log(f"[graph] {shape['name']} ({shape['evaluator']}, {shape['simulations']} sims, K={shape['parallel_sims']}, "
            f"{int(active.sum())} live roots): eager repeats itself {eager_repeats} (spread {spread:.3g}); graphed "
            f"against eager: first call differs in {differ['first'] or 'nothing'}, replayed call (sync debug "
            f"mode error) differs in {differ['replayed'] or 'nothing'}; against the level form: differs in "
            f"{differ_levels or 'nothing'}; a search eager {e1_s * 1e3:.1f} / {e2_s * 1e3:.1f} ms, graphed "
            f"first {g1_s * 1e3:.1f} ms, replayed {g2_s * 1e3:.1f} ms, level form {lv_s * 1e3:.1f} ms; an "
            f"iteration eager {r['eager_iteration_ms']:.3f} ms, graphed {r['graphed_iteration_ms']:.3f} ms, level "
            f"form {r['level_form_iteration_ms']:.3f} ms; captures "
            f"{', '.join(f'{k_} {v:.1f} ms' for k_, v in r['capture_ms'].items())} (level form "
            f"{', '.join(f'{k_} {v:.1f} ms' for k_, v in r['level_form_capture_ms'].items())}); graph replays "
            f"{ws.graphs.replays}; tower launches eager {e_launches}, graphed {g1_launches} / {g_launches}, level "
            f"form {lv_launches}; descent kernel launches eager {e_descents}, graphed {g_descents}, level form "
            f"{lv_descents}")
        for c in checks:
            timing = (f"; kernel {c['ms'] * 1e3:.2f} us (device time, median of {DESCENT_TIME_REPS}), "
                      f"{c['ms'] * 1e3 / max(c['deepest'], 1):.2f} us a level of the deepest row; the level form "
                      f"{c['plain_levels']} level graph replays {c['plain_ms'] * 1e3:.1f} us (walks the same: "
                      f"{c['plain_equal']})" if "ms" in c else "")
            log(f"[graph] {shape['name']} descent before iteration {c['t']}: kernel against descend_plain "
                f"until no row descends, elements that differ {c['differ']} (max |diff| {c['max_abs_err']:g}); "
                f"against min(t-1, 42) levels {c['differ_bounded']}; {c['descending']} of {c['rows']} rows "
                f"descend, {c['levels']} levels in all, the deepest {c['deepest']} (level {c['level']}); bound "
                f"{c['bound_ms'] * 1e3:.4f} us by {c['bound_by']} ({c['bytes']} B, {c['operations']} "
                f"operations), latency floor {c['latency_floor_ms'] * 1e3:.3f} us ({c['deepest']} + "
                f"{DESCENT_START_READS} L2 round trips and an empty kernel), {c['binds']} binds{timing}")
        if eager_repeats and (differ["first"] or differ["replayed"]):
            fail(f"[graph] {shape['name']}: the graphed search differs from the eager one: {differ}")
        if not eager_repeats and not r["max_diff_replayed"] <= spread:
            fail(f"[graph] {shape['name']}: the graphed search differs from the eager one by "
                 f"{r['max_diff_replayed']}, beyond the eager form's own spread {spread}")
        if differ_levels:
            fail(f"[graph] {shape['name']}: the search with the descent kernel differs from the level form: "
                 f"{differ_levels}")
        if not (e_launches == g1_launches == g_launches == lv_launches) or set(ws.graphs.capture_ms) != {
                "iteration"} or set(lv_ws.graphs.capture_ms) != {"level", "tail"}:
            fail(f"[graph] {shape['name']}: tower launches {r['tower_launches']}, captures {r['capture_ms']}, "
                 f"level form captures {r['level_form_capture_ms']}")
        if not (e_descents == g_descents == iterations and lv_descents == 0):
            fail(f"[graph] {shape['name']}: descent kernel launches {r['descent_launches']}, expected "
                 f"{iterations} a search and none in the level form")
        for c in checks:
            if any(c["differ"].values()) or any(c["differ_bounded"].values()) or c["max_abs_err"] != 0:
                fail(f"[graph] {shape['name']}: the descent kernel differs from its plain version before "
                     f"iteration {c['t']}: {c['differ']}, {c['differ_bounded']}")
            if "ms" in c and not c["plain_equal"]:
                fail(f"[graph] {shape['name']}: the level graphs walked elsewhere than the kernel before "
                     f"iteration {c['t']}")

    deepest = max(c["deepest"] for s in GRAPH_SHAPES for c in out[s["name"]]["descent_checks"])
    if deepest < 3:
        fail(f"[graph] no descent the kernel was held on went deeper than {deepest} levels")

    # the tower kernel inside the replayed graph, at the bench path's fan-out
    # batch (512 x 8 boards): a traced 64-simulation search of the bench
    # shape, replayed (its root forward, at 512 boards, runs eagerly)
    shape = GRAPH_SHAPES[0]
    cfg = MCTSConfig(simulations=64, parallel_sims=shape["parallel_sims"])
    roots = random_positions(shape["rows"], make_generator(7, dev), dev)
    traced = Search(evaluators["gen161"], cfg)
    for seed in (0, 1):  # warm-up, capture
        traced(roots, make_generator(seed, dev))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as log_dir:
        with trace(log_dir):
            traced(roots, make_generator(2, dev))
            torch.cuda.synchronize()
        events = trace_events(log_dir)
    tower_us = sorted(e["dur"] for e in events if e.get("cat") == "kernel" and "tower_kernel" in e["name"])
    in_graph = tower_us[1:]  # the root forward is the shortest
    out["tower_in_graph"] = {"boards": shape["rows"] * shape["parallel_sims"], "launches": len(in_graph),
                             "ms": sorted(in_graph)[len(in_graph) // 2] / 1e3 if in_graph else None,
                             "root_ms": tower_us[0] / 1e3 if tower_us else None}
    log(f"[graph] the tower kernel in a traced replayed search of {shape['rows']} rows, K={shape['parallel_sims']}: "
        f"{len(in_graph)} launches at {out['tower_in_graph']['boards']} boards, median {out['tower_in_graph']['ms']} "
        f"ms (the root's eager launch at {shape['rows']} boards {out['tower_in_graph']['root_ms']} ms)")
    if len(in_graph) != cfg.simulations // cfg.parallel_sims:
        fail(f"[graph] the trace holds {len(tower_us)} tower kernels, not {1 + cfg.simulations // cfg.parallel_sims}")

    # the sync-free sampling draws what torch.multinomial draws
    probs = torch.rand((512, 7), generator=make_generator(3, dev), device=dev)
    a = torch.multinomial(probs, 1, generator=make_generator(5, dev))[:, 0]
    q = torch.empty_like(probs).exponential_(1, generator=make_generator(5, dev))
    sampling_equal = bool((a == torch.argmax(probs / q, dim=-1)).all())
    log(f"[graph] opening samples: the search's sync-free draw equals torch.multinomial's: {sampling_equal}")
    if not sampling_equal:
        fail("[graph] the search's sampling differs from torch.multinomial on the card")

    # the host syncs of a refill pool's waves, by the line that made them
    P = GRAPH_SYNC_POOL
    cfg = MCTSConfig(simulations=P["simulations"], parallel_sims=P["parallel_sims"], root_dirichlet_alpha=0.3,
                     root_exploration_fraction=0.25, num_sampling_moves=6)
    play = make_refill_play_fn(evaluators["gen161"], cfg, P["slots"], P["games"], device=dev)
    play(make_generator(1, dev))  # the warm-up and the captures
    waves = []
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            games = play(make_generator(2, dev), progress=lambda w, n: waves.append(n))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            syncs[where] = syncs.get(where, 0) + 1
    n_syncs = sum(syncs.values())
    finished = int((games.result != 0).sum())
    log(f"[graph] refill pool of {P['slots']} slots, {P['games']} games, {P['simulations']} sims, K="
        f"{P['parallel_sims']}: {len(waves)} waves, {n_syncs} host syncs ({n_syncs / max(len(waves), 1):.2f} a "
        f"wave) by line {syncs}; {finished} games finished")
    if finished != P["games"]:
        fail(f"[graph] the refill pool finished {finished} of {P['games']} games")
    out["refill_syncs"] = {**P, "waves": len(waves), "syncs": syncs}
    return out


# [entry]: the port's entry() forward on the card against the CPU, on the
# example planes and on ENTRY_POSITIONS legal positions, held to phase 6's
# float32 limit: IEEE float32 on both (no TF32), summed in different orders
ENTRY_POSITIONS = 256
TOL_ENTRY = TOL_TRAIN_F32["state"]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def entry_phase(dev):
    """Phase 17, [entry]: ``forward(*args)`` of the port's ``entry()`` on
    the card, held within ``TOL_ENTRY`` of the same forward on the CPU with
    the same variables, on the zero example planes and on 256 legal
    positions; its warm ms at B=256, beside the same net called as a
    module. The forward is the unfolded float32 net, so it launches no
    tower kernel."""
    import torch

    from connect4_tpu_torch.config import NetConfig
    from connect4_tpu_torch.entry import entry
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.net import init_net
    from connect4_tpu_torch.utils import make_generator

    forward, args = entry()
    variables, planes = args
    cpu_forward, _ = entry(device="cpu")
    cpu_variables = {k: v.cpu() for k, v in variables.items()}
    positions = (to_planes(random_positions(ENTRY_POSITIONS, make_generator(5, dev), dev))
                 .permute(0, 2, 3, 1).float().contiguous())
    tower.run_tower.launches = 0
    errs, shapes = {}, {}
    for name, x in (("example", planes), ("positions", positions)):
        value, prior = forward(variables, x)
        cpu_value, cpu_prior = cpu_forward(cpu_variables, x.cpu())
        if (value.shape, prior.shape) != ((len(x),), (len(x), 7)) or value.device.type != "cuda":
            fail(f"[entry] {name}: value {tuple(value.shape)} and prior {tuple(prior.shape)} on {value.device}")
        if not (torch.isfinite(value).all() and torch.isfinite(prior).all()):
            fail(f"[entry] {name}: the forward is not finite")
        shapes[name] = [list(value.shape), list(prior.shape)]
        errs[name] = {"value": (value.cpu() - cpu_value).abs().max().item(),
                      "prior": (prior.cpu() - cpu_prior).abs().max().item()}
    ms = timed_ms(lambda: forward(*args))
    launches = tower.run_tower.launches
    # a yardstick: the same net called as a module, without functional_call
    # swapping its 80 tensors in and out on every call
    net = init_net(NetConfig(filters=64, n_fc_layers=6, n_residuals=6), torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        module_ms = timed_ms(lambda: net(planes))
    smi = card()
    log(f"[entry] forward(*entry()) F=64 fc 6 res 6 float32 on {dev}: value {shapes['example'][0]}, prior "
        f"{shapes['example'][1]}; against the CPU, |value| |prior| max: example planes "
        f"{errs['example']['value']:.3g} {errs['example']['prior']:.3g}, {ENTRY_POSITIONS} positions "
        f"{errs['positions']['value']:.3g} {errs['positions']['prior']:.3g} (limit {TOL_ENTRY:g}); warm forward "
        f"at B={len(planes)} {ms:.4f} ms (the net called as a module {module_ms:.4f} ms); tower kernel launches "
        f"{launches}; {smi}")
    if max(max(e.values()) for e in errs.values()) > TOL_ENTRY:
        fail(f"[entry] the card differs from the CPU beyond {TOL_ENTRY:g}: {errs}")
    if launches:
        fail(f"[entry] the float32 forward launched the tower kernel {launches} times")
    return {"shapes": shapes, "max_abs_err": errs, "ms": ms, "module_ms": module_ms, "boards": len(planes),
            "tower_launches": launches, "card": smi}


def dryrun_phase():
    """Phase 18, [dryrun]: ``dryrun_multichip(8)``, eight gloo ranks sharing
    the card, then ``dryrun_multichip(1)``, one NCCL rank; each one
    ``TrainingLoop`` generation in fresh rank processes, which must end with
    its OK line. Prints the ranks' lines and the seconds of each launch; a
    launch that fails raises, which fails the run."""
    import io

    import torch

    from connect4_tpu_torch.entry import dryrun_multichip

    cards = torch.cuda.device_count()
    out = {}
    for n in (8, 1):
        where = ",".join(dict.fromkeys(f"cuda:{r % cards}" for r in range(n)))
        backend = "nccl" if n <= cards else "gloo"
        printed = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                dryrun_multichip(n)
        finally:
            lines = printed.getvalue().splitlines()
            for line in lines:
                log(f"[dryrun] {line}")
        seconds = time.perf_counter() - t0
        ok = f"dryrun_multichip({n}): TrainingLoop generation on {n}-rank mesh ({where}, {backend}) — OK"
        log(f"[dryrun] {n} rank{'s' if n > 1 else ''} ({backend} on {where}): {seconds:.1f} s from launch to exit")
        if not lines or lines[-1] != ok:
            fail(f"[dryrun] dryrun_multichip({n}) did not end with {ok!r}")
        out[n] = {"seconds": seconds, "backend": backend, "devices": where,
                  "ranks": [line for line in lines if line.startswith("dryrun rank")], "lines": lines}
    return out


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of [dp], started by a torchrun agent
        dp_rank(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from connect4_tpu_torch import build
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
    from connect4_tpu_torch.mcts import batched, descent
    from connect4_tpu_torch.mcts.batched import make_search_fn
    from connect4_tpu_torch.scripts import l2_latency
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.models.net import fold_bn_params
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.training.self_play import make_refill_play_fn, training_arrays
    from connect4_tpu_torch.utils import make_generator, resolve_device

    # resolve_device sets what float32 means in the port (utils.full_float32:
    # no TF32), for the float32 references below as for every entry point
    dev = resolve_device("cuda")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("resolve_device left TF32 on")
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {report['device']}")

    # --- 1. build: one nvcc a source, all started together ------------------
    t0 = time.perf_counter()
    sources = (tower.SOURCE, descent.SOURCE, l2_latency.SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for built in [pool.submit(build.build, src) for src in sources]:
            built.result()
    tower._library()
    descent._library()
    l2_latency._library()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] tower kernels (fused and layer, one source), the descent kernel and the L2 chase ready in "
        f"{report['build_s']:.1f} s")
    for src in sources:
        log(build.BUILD_LOGS.get(src, f"{src}: (already built)").strip())

    net = load_example_net(device=dev)
    config = net.config
    folded = fold_bn_params(net)
    packed = tower.pack_weights(config, folded)
    gen = make_generator(SMOKE["seed"], dev)

    # --- 2. kernel vs plain -------------------------------------------------
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {b: tower.tile_plan(b) for b in COMPARE_BOARDS}
    for b, (tb, blocks) in plans.items():
        log(f"[tile] B={b}: {tb} boards a block, {blocks} blocks on {n_sms} SMs (chain={tower.CHAIN})")
    report["tiles"] = plans

    errs, chain_errs = {}, {}
    for b in COMPARE_BOARDS:
        x2d = board_rows(b, gen, dev)
        e = errs[b] = compare_kernel(tower, packed, x2d)  # the shipped kernel, as the main path calls it
        log(f"[compare] tower B={b}: {show(e)}")
        check_compare(f"B={b}", e)
        COMPARED.add((tower.kernel_width(config.filters), b))
        if b in (4096, 261):
            # the chain lengths that were not shipped, for the record only
            for chain in tower.CHAINS:
                ce = e if chain == tower.CHAIN else compare_kernel(tower, packed, x2d, chain)
                chain_errs[f"{chain}@{b}"] = ce
                log(f"[compare] chain={chain}{' (shipped)' if chain == tower.CHAIN else ''} B={b}: {show(ce)}")
    report["compare"] = errs
    report["compare_chains"] = chain_errs
    t0 = time.perf_counter()
    width_errs = compare_widths(dev, gen)
    report["compare_widths"] = width_errs
    log(f"[compare] every width: {time.perf_counter() - t0:.1f} s")

    # --- 3. times -----------------------------------------------------------
    lib_tower = cudnn_tower(folded, config)
    times = {}
    with torch.no_grad():
        for b in TIME_BOARDS:
            x2d = (to_planes(random_positions(b, gen, dev)).permute(0, 2, 3, 1)
                   .reshape(b * 42, config.channels).float().contiguous())
            nhwc = x2d.reshape(b, 6, 7, config.channels)
            bound_ms, bound_by, flops, nbytes = tower.tower_bound(config, b)
            t = {
                "ms": timed_ms(lambda: tower.run_tower(packed, x2d)),
                "plain_ms": timed_ms(lambda: tower.tower_plain(packed, x2d), iters=5),
                # one call: it takes seconds, so a warm-up or a second call
                # would only spend the script's time
                "plain_model_ms": timed_ms(
                    lambda: tower.tower_plain(packed, x2d, tensor_core=True), iters=1, warmup=0),
                "library_ms": timed_ms(lambda: lib_tower(nhwc)),
                "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            }
            t["ms_again"] = timed_ms(lambda: tower.run_tower(packed, x2d))
            times[b] = t
            log(f"[time] tower B={b}: kernel {t['ms']:.4f} ms (again {t['ms_again']:.4f}), "
                f"plain {t['plain_ms']:.4f} ms (tensor core emulated {t['plain_model_ms']:.1f}), cuDNN {t['library_ms']:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB), "
                f"{flops / t['ms'] / 1e9:.1f} TFLOP/s")
    report["times"] = times
    report["times_widths"] = time_widths(dev, gen)

    # --- 4. search and self-play on the card against the CPU -----------------
    cpu = torch.device("cpu")
    for k in (1, 8):
        cfg = MCTSConfig(simulations=48, parallel_sims=k)
        roots = random_positions(64, make_generator(1, cpu), cpu)
        ongoing = roots.result == 0
        r_cpu = make_search_fn(centre_evaluator_batched, cfg)(roots, make_generator(0, cpu), ongoing)
        r_gpu = make_search_fn(centre_evaluator_batched, cfg)(
            roots.map(lambda x: x.to(dev)), make_generator(0, dev), ongoing.to(dev))
        sd = (r_cpu.tree.stats - r_gpu.tree.stats.cpu()).abs().max().item()
        same = bool((r_cpu.move == r_gpu.move.cpu())[ongoing].all())
        log(f"[check] search K={k} on 64 positions, card vs CPU: moves equal {same}, |stats| max {sd:.3g}")
        if not same or sd > 1e-4:
            fail(f"search on the card differs from the CPU (K={k})")
    cfg = MCTSConfig(simulations=16, parallel_sims=8)
    outs = [
        make_refill_play_fn(centre_evaluator_batched, cfg, 8, 20, device=d)(make_generator(0, d))
        for d in (cpu, dev)
    ]
    same = all(bool((a.cpu() == b.cpu()).all()) for a, b in zip(outs[0], outs[1]) if a.dtype != torch.float32)
    pd = (outs[0].policies - outs[1].policies.cpu()).abs().max().item()
    log(f"[check] refill self-play 20 games, card vs CPU: records equal {same}, |policy| max {pd:.3g}")
    if not same or pd > 1e-5:
        fail("refill self-play on the card differs from the CPU")
    t0 = time.perf_counter()
    report["graph"] = graph_phase(net, dev)
    report["graph"]["seconds"] = time.perf_counter() - t0
    log(f"[graph] {report['graph']['seconds']:.1f} s")

    # --- 5. the self-play path -------------------------------------------------
    search_cfg = MCTSConfig(
        simulations=SMOKE["simulations"], root_dirichlet_alpha=0.3,
        root_exploration_fraction=0.25, num_sampling_moves=6,
        parallel_sims=SMOKE["parallel_sims"],
    )
    shapes = LaunchShapes(tower)
    evaluator = make_net_evaluator(net)
    play = make_refill_play_fn(evaluator, search_cfg, SMOKE["slots"], SMOKE["games"], device=dev)
    waves = []
    torch.cuda.synchronize()
    tower.run_tower.launches = 0
    batched.descend.launches = 0
    t0 = time.perf_counter()
    out = play(make_generator(SMOKE["seed"], dev), progress=lambda w, n: waves.append(n))
    torch.cuda.synchronize()
    t_play = time.perf_counter() - t0
    launches = tower.run_tower.launches
    # the descent kernel's launches on the main path, by path (each read
    # just after the path and set to 0 just before it)
    descents = {"selfplay": batched.descend.launches}
    planes, values, policies = training_arrays(out)
    n_moves = replay_games(out)
    if int(out.mask.sum()) != n_moves or not (out.result.cpu() != 0).all():
        fail("not every game finished")
    pol_sums = out.policies.sum(-1)[out.mask]
    if not torch.allclose(pol_sums, torch.ones_like(pol_sums), atol=1e-5):
        fail("policy targets are not distributions")
    if planes.shape != (2 * n_moves, 3, 6, 7) or values.shape != (2 * n_moves,):
        fail(f"training_arrays shapes {planes.shape} {values.shape}")
    if launches == 0:
        fail("the main path never launched the tower kernel")
    # a wave is one search: a root forward, then an iteration's forward and
    # descent each
    iters = SMOKE["simulations"] // SMOKE["parallel_sims"]
    if descents["selfplay"] == 0 or descents["selfplay"] * (iters + 1) != launches * iters:
        fail(f"self-play launched the descent kernel {descents['selfplay']} times beside {launches} tower "
             f"forwards: not once an iteration")
    res = out.result.cpu()
    selfplay = {
        **SMOKE, "seconds": t_play, "moves": n_moves, "waves": len(waves),
        "moves_per_s": n_moves / t_play, "sims_per_s": n_moves * SMOKE["simulations"] / t_play,
        "tower_launches": launches, "descent_launches": descents["selfplay"],
        "launches_by_width": shapes.take("self-play"),
        "o_wins": int((res == 1).sum()), "x_wins": int((res == 2).sum()), "draws": int((res == 3).sum()),
        "positions": int(values.shape[0]),
    }
    report["selfplay"] = selfplay
    log(f"[selfplay] {SMOKE['games']} games ({selfplay['o_wins']} o / {selfplay['draws']} draw / "
        f"{selfplay['x_wins']} x), {n_moves} moves in {t_play:.2f} s over {len(waves)} waves: "
        f"{selfplay['moves_per_s']:.1f} moves/s, {selfplay['sims_per_s']:.0f} sims/s, "
        f"tower kernel launches {launches}, descent kernel launches {descents['selfplay']}; all games replay "
        f"on the host board")

    # --- 6.-9. the learner, the training generation, a match -------------------
    # a generator of their own: the learner's batches do not depend on how
    # many positions the phases above drew
    train_gen = make_generator(SMOKE["seed"] + 1, dev)
    report["train_check"] = check_train_step(dev, train_gen)
    report["train_times"] = time_train_step(dev, train_gen)
    # the phase-8 run stays for the [scripts] phase, which re-evaluates it
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as run_dir:
        batched.descend.launches = 0
        report["generation"] = drive_generations(dev, shapes, run_dir)
        descents["generation"] = batched.descend.launches
        generation_launches = sum(
            g["launches"]["selfplay"] + g["launches"]["match"] for g in report["generation"]["generations"])
        generation_shapes = {}
        for g in report["generation"]["generations"]:
            add_launches(generation_shapes, g["launches_by_width"])
        if sum(by_batch(generation_shapes).values()) != generation_launches:
            fail(f"launches by width and batch {generation_shapes} do not add up to {generation_launches}")
        at_width = generation_shapes[tower.kernel_width(config.filters)]
        report_boards = max(at_width, key=at_width.get)
        if report_boards not in times:
            fail(f"most launches of the generations are at B={report_boards}, which was not timed: "
                 f"{generation_shapes}")
        batched.descend.launches = 0
        report["match"] = gen161_match(net, dev, shapes)
        descents["match"] = batched.descend.launches

        # --- 10.-18. [wide] and [wider]: the generations at 256 and 512
        # filters, [widest] self-play at 1024; the tools, data parallelism,
        # the host search and solver, the supervisor, the two hooks --------------
        seconds = {}
        for name, phase in (("wide", lambda: wide_phase(dev, shapes)),
                            ("wider", lambda: wide_phase(dev, shapes, WIDER_NET, "wider", WIDER_DEPTH)),
                            ("widest", lambda: widest_phase(dev, shapes)),
                            ("scripts", lambda: scripts_phase(dev, shapes, run_dir)),
                            ("dp", lambda: drive_dp(dev, net, shapes)), ("nccl", lambda: nccl_one_rank(dev)),
                            ("host", lambda: host_phase(dev)), ("supervisor", supervisor_phase),
                            ("entry", lambda: entry_phase(dev)), ("dryrun", dryrun_phase)):
            t0 = time.perf_counter()
            batched.descend.launches = 0
            report[name] = phase()
            descents[name] = batched.descend.launches
            seconds[name] = time.perf_counter() - t0
    report["phase_seconds"] = seconds
    log("[phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
        + f"; together {sum(seconds.values()):.1f} s")
    dp_launches = sum(report["dp"]["launches"].values())
    scripts_launches = sum(report["scripts"]["launches"].values())
    wide_launches = sum(g["launches"]["selfplay"] + g["launches"]["match"] for g in report["wide"]["generations"])
    counted_shapes = add_launches({}, generation_shapes)
    for g in report["wide"]["generations"]:
        add_launches(counted_shapes, g["launches_by_width"])
    for part in ("dp", "scripts"):
        add_launches(counted_shapes, report[part]["launches_by_width"])
    counted = generation_launches + wide_launches + dp_launches + scripts_launches
    if sum(by_batch(counted_shapes).values()) != counted:
        fail(f"launches by width and batch {counted_shapes} do not add up to the paths' launches")
    # the largest error of the kernel against the emulated plain version and
    # against the one rounded to nearest, over every (width, batch) launched
    compared_at = {}
    for b, e in errs.items():
        compared_at.setdefault((tower.kernel_width(config.filters), b), []).append(e)
    for f, per in width_errs.items():
        for b, e in per.items():
            compared_at.setdefault((tower.kernel_width(f), b), []).append(e)
    # the wide kernel (tower_kernel_wide, packed widths 128 and 256) has an
    # entry of its own; the tower entry keeps the narrower widths
    wide_widths = set(tower.WIDE_STAGE_SLABS)
    narrow_shapes = {f: per for f, per in counted_shapes.items() if f not in wide_widths}
    wide_shapes = {f: per for f, per in counted_shapes.items() if f in wide_widths}
    launched = [e for f, per in narrow_shapes.items() for b in per for e in compared_at[f, b]]
    wide_launched = [e for f, per in wide_shapes.items() for b in per for e in compared_at[f, b]]
    wide_count = sum(by_batch(wide_shapes).values())
    wide_width = tower.kernel_width(WIDE_NET["filters"])
    at_wide = {}
    for g in report["wide"]["generations"]:
        add_launches(at_wide, g["launches_by_width"])
    at_wide = at_wide.get(wide_width, {})
    if wide_count == 0 or not at_wide:
        fail(f"the wide kernel was not launched on the main path: {counted_shapes}")
    wide_boards = max(at_wide, key=at_wide.get)
    # the layer kernel's main path: the [wider] generations (every forward at
    # F=512) and the [widest] self-play (at F=1024), 13 launches of the layer
    # kernel a forward
    wider_shapes = {}
    for g in report["wider"]["generations"]:
        add_launches(wider_shapes, g["launches_by_width"])
    wider_forwards = sum(g["launches"]["selfplay"] + g["launches"]["match"] for g in report["wider"]["generations"])
    layer_launches = sum(g["layer_launches"] for g in report["wider"]["generations"])
    if layer_launches == 0 or sum(by_batch(wider_shapes).values()) != wider_forwards:
        fail(f"[wider] launched the layer kernel {layer_launches} times, its forwards by batch {wider_shapes} "
             f"against {wider_forwards}")
    layer_shapes = add_launches(add_launches({}, wider_shapes), report["widest"]["launches_by_width"])
    layer_launched = [e for f, per in layer_shapes.items() for b in per for e in compared_at[f, b]]
    wider_width = tower.kernel_width(WIDER_NET["filters"])
    at_wider = wider_shapes[wider_width]
    wider_boards = max(at_wider, key=at_wider.get)
    fused_times = {f: per for f, per in report["times_widths"].items() if not tower.is_layer_width(f)}
    if wide_boards not in fused_times[WIDE_NET["filters"]]:
        fail(f"most launches of [wide] are at B={wide_boards}, which was not timed: {at_wide}")
    layer_times = {f: per for f, per in report["times_widths"].items() if tower.is_layer_width(f)}
    if wider_boards not in layer_times[wider_width]:
        fail(f"most launches of [wider] are at B={wider_boards}, which was not timed: {wider_shapes}")

    # --- 19. result lines ------------------------------------------------------
    # time, bound and library time at the batch most launches of phase 8's
    # generations have (their self-play's leaves; F=64); the error is the
    # largest over every width up to 64 and shape the generations, the
    # tools and the [dp] ranks launched; the times at F=16 and 32 beside
    # them
    t_report = times[report_boards]
    kernels = [{
        "name": "tower",
        "route": "cuda",
        "source": "connect4_tpu_torch/models/csrc/tower.cu",
        "replaces": "connect4_tpu/models/pallas_net.py:153",
        # at widths up to 64, of the training generations of phase 8
        # (self-play and gating match of each), of the tools of [scripts]
        # and of the [dp] ranks (sharded self-play and two mesh
        # generations); the self-play path of phase 5 is counted beside it
        "launches": counted - wide_count,
        "launches_by_path": {"selfplay": launches, "generation": generation_launches,
                             "scripts": scripts_launches,
                             "dp_selfplay": report["dp"]["launches"]["selfplay"],
                             "dp_generation": report["dp"]["launches"]["generation"]},
        "launches_by_tool": report["scripts"]["launches"],
        "launches_by_boards": by_batch(narrow_shapes),
        "launches_by_width": narrow_shapes,
        "boards": report_boards,
        "max_abs_err": max(e["model"]["tower_max"] for e in launched),
        "max_abs_err_nearest": max(e["nearest"]["tower_max"] for e in launched),
        "ms": t_report["ms"],
        "plain_ms": t_report["plain_ms"],
        "bound_ms": t_report["bound_ms"],
        "bound_by": t_report["bound_by"],
        "library_ms": t_report["library_ms"],
        "by_boards": {b: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                      for b, t in times.items()},
        "by_width": {f: {b: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                         for b, t in per.items()}
                     for f, per in fused_times.items() if tower.kernel_width(f) not in wide_widths},
    }]
    # the wide kernel: time, bound and library time at F=256 and the batch
    # most of [wide]'s forwards have; its launches are those of the counted
    # paths at widths 128 and 256 ([wide]'s generations); the error is the
    # largest over every (width, batch) they launched
    t_wide = fused_times[WIDE_NET["filters"]][wide_boards]
    kernels.append({
        "name": "tower_wide",
        "route": "cuda",
        "source": "connect4_tpu_torch/models/csrc/tower.cu",
        "replaces": "connect4_tpu/models/pallas_net.py:153",
        "launches": wide_count,
        "launches_by_path": {"wide": wide_launches},
        "launches_by_boards": by_batch(wide_shapes),
        "launches_by_width": wide_shapes,
        "filters": wide_width,
        "boards": wide_boards,
        "max_abs_err": max(e["model"]["tower_max"] for e in wide_launched),
        "max_abs_err_nearest": max(e["nearest"]["tower_max"] for e in wide_launched),
        "ms": t_wide["ms"],
        "plain_ms": t_wide["plain_ms"],
        "bound_ms": t_wide["bound_ms"],
        "bound_by": t_wide["bound_by"],
        "library_ms": t_wide["library_ms"],
        "by_width": {f: {b: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                         for b, t in per.items()}
                     for f, per in fused_times.items() if tower.kernel_width(f) in wide_widths},
    })
    # the layer kernel (towers above 256 filters): time, bound and library
    # time at F=512 and the batch most of [wider]'s forwards have; its
    # launches are the layer kernel's own (13 a forward), in [wider] and
    # [widest]; the error is the largest over every (width, batch) they
    # launched
    t_wider = layer_times[wider_width][wider_boards]
    kernels.append({
        "name": "tower_layer",
        "route": "cuda",
        "source": "connect4_tpu_torch/models/csrc/tower.cu",
        "replaces": "connect4_tpu/models/pallas_net.py:153",
        "launches": layer_launches + report["widest"]["layer_launches"],
        "launches_by_path": {"wider": layer_launches, "widest": report["widest"]["layer_launches"]},
        "forwards": wider_forwards + report["widest"]["forwards"],
        "launches_by_width": layer_shapes,
        "filters": wider_width,
        "boards": wider_boards,
        "max_abs_err": max(e["model"]["tower_max"] for e in layer_launched),
        "max_abs_err_nearest": max(e["nearest"]["tower_max"] for e in layer_launched),
        "ms": t_wider["ms"],
        "plain_ms": t_wider["plain_ms"],
        "bound_ms": t_wider["bound_ms"],
        "bound_by": t_wider["bound_by"],
        "library_ms": t_wider["library_ms"],
        "by_width": {f: {b: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                         for b, t in per.items()}
                     for f, per in layer_times.items()},
    })
    # the descent kernel: its launches on the counted paths (self-play, the
    # generations with their matches, [match], [wide], [wider], [widest],
    # the tools and the host phase; [graph]'s comparisons are not counted),
    # its time, bound and plain form's time on the bench shape's trees
    # before its last iteration, and its largest difference from the plain
    # version over every snapshot of every [graph] shape
    for path in ("selfplay", "generation", "match"):
        if descents[path] == 0:
            fail(f"the {path} path never launched the descent kernel: {descents}")
    checks = {f"{name} t={c['t']}": c for name, r in report["graph"].items()
              if isinstance(r, dict) and "descent_checks" in r for c in r["descent_checks"]}
    t_descent = report["graph"]["bench 512x8"]["descent_checks"][-1]
    kernels.append({
        "name": "descent",
        "route": "cuda",
        "source": "connect4_tpu_torch/mcts/csrc/descent.cu",
        # lax.while_loop (XLA) of the K-walker search, and of the K=1 search
        # at :393; no Pallas counterpart
        "replaces": "connect4_tpu/mcts/batched.py:874",
        "replaces_also": "connect4_tpu/mcts/batched.py:393",
        "launches": sum(descents.values()),
        "launches_by_path": descents,
        "rows": t_descent["rows"],
        "iteration": t_descent["t"],
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "differ": sum(sum(c["differ"].values()) + sum(c["differ_bounded"].values()) for c in checks.values()),
        "ms": t_descent["ms"],
        # the parent's form: min(t - 1, 42) replays of a one-level CUDA graph
        "plain_ms": t_descent["plain_ms"],
        "bound_ms": t_descent["bound_ms"],
        "bound_by": t_descent["bound_by"],
        # the chain of dependent L2 reads, which binds: (deepest row's
        # levels + 2) L2 round trips and an empty kernel's time
        "latency_floor_ms": t_descent["latency_floor_ms"],
        "binds": t_descent["binds"],
        "l2_round_trip_ms": report["graph"]["l2"]["round_trip_ms"],
        "empty_kernel_ms": report["graph"]["l2"]["empty_ms"],
        "library_ms": None,  # no single PyTorch call computes a descent
        "by_snapshot": {k: {f: c[f] for f in ("ms", "plain_ms", "plain_levels", "bound_ms", "bound_by",
                                              "latency_floor_ms", "binds", "rows", "descending", "levels",
                                              "deepest") if f in c}
                        for k, c in checks.items()},
    })
    smi = card()
    report["nvidia_smi"] = smi
    report["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
