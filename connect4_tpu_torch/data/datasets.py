"""Benchmark dataset builders: 8-ply values and 7-ply values and policies.

The port's copy of ``connect4_tpu.data.datasets``: it writes the npz files
that ``training.loop`` evaluates on, in the layout of the packaged copies
under ``connect4_tpu_torch/data/``. The reference took its evaluation sets
from the external UCI "connect-4" dataset (67,557 8-ply positions labelled
with the game-theoretic outcome for the first player) plus a derived 7-ply
set (``oinkoink/scripts/generate_8ply.py``, ``generate_7ply.py``); here the
exact solver (``native.solver``) labels them from first principles.

The UCI position set is reproduced *exactly*: it is the set of
non-terminal 8-ply positions in which neither side has a playable
immediate winning move, deduplicated under mirror symmetry; enumerating
with that filter yields exactly 67,557 positions.

The 7-ply set follows the reference recipe (``generate_7ply.py:51-91``):
every distinct non-terminal 7-ply position (54,131 of them); value = the
best child value for the side to move; policy = uniform over the optimal
(weakly winning) moves.

Builds are resumable: positions are solved in DFS enumeration order (high
transposition-table locality) in chunks, with progress checkpointed to
``<out>.partial.npz`` after every chunk, and every npz is written to a
temporary file and renamed into place.

    python -m connect4_tpu_torch.data.datasets {8ply,7ply,both} [--out-dir DIR]
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from connect4_tpu_torch.types import HEIGHT, WIDTH

_H1 = HEIGHT + 1
_COL_BASE = [1 << (c * _H1) for c in range(WIDTH)]
_COL_FULL = [((1 << HEIGHT) - 1) << (c * _H1) for c in range(WIDTH)]
_BOARD = sum(_COL_FULL)


def _wins(p: int) -> bool:
    m = p & (p >> _H1)
    if m & (m >> (2 * _H1)):
        return True
    m = p & (p >> HEIGHT)
    if m & (m >> (2 * HEIGHT)):
        return True
    m = p & (p >> (_H1 + 1))
    if m & (m >> (2 * (_H1 + 1))):
        return True
    m = p & (p >> 1)
    return bool(m & (m >> 2))


def _mirror(b: int) -> int:
    r = 0
    for c in range(WIDTH):
        r |= ((b >> (c * _H1)) & 0x7F) << ((WIDTH - 1 - c) * _H1)
    return r


def _playable_cells(mask: int) -> int:
    out = 0
    for c in range(WIDTH):
        out |= (mask + _COL_BASE[c]) & _COL_FULL[c]
    return out


def _winning_cells(p: int) -> int:
    r = (p << 1) & (p << 2) & (p << 3)
    for s in (_H1, HEIGHT, _H1 + 1):
        q = (p << s) & (p << 2 * s)
        r |= q & (p << 3 * s)
        r |= q & (p >> s)
        q = (p >> s) & (p >> 2 * s)
        r |= q & (p << s)
        r |= q & (p >> 3 * s)
    return r & _BOARD


def enumerate_positions(plies: int) -> List[Tuple[int, int]]:
    """All distinct non-terminal positions at exactly ``plies`` moves, as
    (o_bits, x_bits), in DFS order (deduplicated, first occurrence kept).

    The JAX package walks every move sequence depth first. Here each ply is
    expanded from the previous ply's distinct positions, in their order and
    moves 0..6: a position's first occurrence is then its lexicographically
    smallest move sequence, which is the first occurrence of the depth-first
    walk too, so the list is the same at a fraction of the work."""
    level: Dict[Tuple[int, int], None] = {(0, 0): None}  # (side to move, other)
    for _ in range(plies):
        nxt: Dict[Tuple[int, int], None] = {}
        for cur, other in level:
            mask = cur | other
            for c in range(WIDTH):
                cell = (mask + _COL_BASE[c]) & _COL_FULL[c]
                if cell and not _wins(cur | cell):  # terminal positions are excluded
                    nxt.setdefault((other, cur | cell))
        level = nxt
    # (o, x): o moved first, so after an even number of plies o is to move
    return [(cur, other) if plies % 2 == 0 else (other, cur) for cur, other in level]


def enumerate_8ply_uci() -> List[Tuple[int, int]]:
    """The exact UCI connect-4 position set: 8-ply, non-terminal, neither
    side has a playable immediate win, mirror-canonical. 67,557 entries."""
    out = []
    for o, x in enumerate_positions(8):
        mask = o | x
        pc = _playable_cells(mask)
        if _winning_cells(o) & pc:
            continue
        if _winning_cells(x) & pc:
            continue
        if (o, x) > (_mirror(o), _mirror(x)):
            continue
        out.append((o, x))
    assert len(out) == 67557, f"UCI filter drift: {len(out)}"
    return out


def bits_to_planes(o_bits: np.ndarray, x_bits: np.ndarray, age_parity_o: bool = True) -> np.ndarray:
    """Vectorised bitboard -> [N, 3, 6, 7] uint8 planes in the reference
    encoding (row 0 = top; channel 0 = all-ones when o is to move)."""
    n = len(o_bits)
    planes = np.zeros((n, 3, HEIGHT, WIDTH), dtype=np.uint8)
    planes[:, 0] = 1 if age_parity_o else 0
    o = np.asarray(o_bits, dtype=np.uint64)
    x = np.asarray(x_bits, dtype=np.uint64)
    for c in range(WIDTH):
        for r in range(HEIGHT):
            bit = np.uint64(c * _H1 + r)
            planes[:, 1, HEIGHT - 1 - r, c] = (o >> bit) & np.uint64(1)
            planes[:, 2, HEIGHT - 1 - r, c] = (x >> bit) & np.uint64(1)
    return planes


ABORTED = -128


def _remove_stale_tmps(out_path: str) -> None:
    """Drop leftover ``<out_path>.tmp-<pid>.npz`` siblings from writer
    processes that died between ``savez`` and ``os.replace``. Harmless to
    correctness (readers only open the final path) but they accumulate;
    live writers are not affected because each uses its own pid suffix."""
    import glob

    for stale in glob.glob(f"{out_path}.tmp-*.npz"):
        if stale != f"{out_path}.tmp-{os.getpid()}.npz":
            try:
                os.remove(stale)
            except OSError:
                pass


def _atomic_savez(path: str, compressed: bool, **arrays) -> None:
    """Write an npz atomically: savez to a same-directory temp file, then
    ``os.replace`` onto the final path. Concurrent readers (the 7-ply
    ``--follow`` poller, the training loop's evaluator) therefore always
    see a complete zip, never a truncated in-progress write."""
    tmp = f"{path}.tmp-{os.getpid()}.npz"
    try:
        if compressed:
            np.savez_compressed(tmp, **arrays)
        else:
            np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _solve_bits(
    solver,
    positions: List[Tuple[int, int]],
    to_move_is_o: bool,
    n_threads: int,
    budget: int = 0,
) -> np.ndarray:
    """Absolute values for (o, x) bit pairs via the native batch solver.
    Entries whose proof exceeded ``budget`` nodes come back as NaN."""
    o = np.array([p[0] for p in positions], dtype=np.uint64)
    x = np.array([p[1] for p in positions], dtype=np.uint64)
    out = np.zeros(len(positions), dtype=np.int8)
    if to_move_is_o:
        solver._lib.solver_solve_batch(
            solver._handle, o, x, len(positions), out, n_threads, budget)
        vals = (out.astype(np.float32) + 1.0) / 2.0
    else:
        solver._lib.solver_solve_batch(
            solver._handle, x, o, len(positions), out, n_threads, budget)
        vals = 1.0 - (out.astype(np.float32) + 1.0) / 2.0
    return np.where(out == ABORTED, np.nan, vals)


def build_8ply(
    out_path: str,
    limit: Optional[int] = None,
    chunk: int = 500,
    n_threads: int = 0,
    tt_size: int = 1 << 31,
    verbose: bool = True,
) -> str:
    """Solve the UCI 8-ply set and write ``connect4dataset_8ply.npz``
    {planes, values, o_bits, x_bits}. Resumable: progress is checkpointed
    to ``<out_path>.partial.npz`` after every chunk."""
    from connect4_tpu_torch.native.solver import ExactSolver

    if n_threads == 0:
        n_threads = os.cpu_count() or 1
    positions = enumerate_8ply_uci()
    if limit is not None:
        positions = positions[:limit]

    partial = out_path + ".partial.npz"
    _remove_stale_tmps(out_path)
    _remove_stale_tmps(partial)
    values = np.full(len(positions), np.nan, dtype=np.float32)
    # highest node budget that failed to solve each position, so a
    # restarted build never re-runs a budget pass a previous process
    # already exhausted (the hard tail is re-attempted only by passes
    # with a strictly larger budget)
    tried = np.zeros(len(positions), dtype=np.int64)
    if os.path.exists(partial):
        with np.load(partial) as d:
            prev = d["values"]
            if len(prev) == len(values):
                values = prev
                if "tried" in d:
                    tried = d["tried"]

    o_bits = np.array([p[0] for p in positions], dtype=np.uint64)
    x_bits = np.array([p[1] for p in positions], dtype=np.uint64)
    planes = bits_to_planes(o_bits, x_bits, age_parity_o=True)

    def emit() -> None:
        """Write the dataset with whatever is solved so far. Consumers
        filter on ``solved``; once complete it has no effect."""
        _atomic_savez(
            out_path,
            compressed=True,
            planes=planes,
            values=np.nan_to_num(values, nan=0.5),
            solved=~np.isnan(values),
            o_bits=o_bits,
            x_bits=x_bits,
        )

    solver = ExactSolver(tt_size)
    # Escalating node budgets. The first (cheap) pass runs in a
    # seeded-shuffled order so the emitted ``solved`` mask covers the set
    # uniformly rather than clustering in DFS order; the expensive passes
    # run in DFS enumeration order, where consecutive positions are
    # near-identical and the shared transposition table carries most of
    # each proof into the next (measured ~2.5x vs random order).
    rng = np.random.default_rng(12345)
    shuffled = rng.permutation(len(positions))
    passes = [
        (1_000_000, shuffled, chunk),
        (20_000_000, np.arange(len(positions)), max(chunk // 5, 4)),
        (200_000_000, np.arange(len(positions)), max(chunk // 25, 4)),
        (0, np.arange(len(positions)), max(chunk // 50, 2)),
    ]
    for budget, base_order, step in passes:
        unsolved = np.isnan(values[base_order])
        skip_tried = (budget != 0) & (tried[base_order] >= (budget or 0))
        order = base_order[unsolved & ~skip_tried]
        if len(order) == 0:
            continue
        t0 = time.time()
        for i in range(0, len(order), step):
            idx = order[i : i + step]
            sl = [positions[j] for j in idx]
            values[idx] = _solve_bits(solver, sl, True, n_threads, budget=budget)
            if budget:
                failed = idx[np.isnan(values[idx])]
                tried[failed] = np.maximum(tried[failed], budget)
            _atomic_savez(partial, compressed=False, values=values, tried=tried, done=np.int64(0))
            if verbose:
                done = i + len(idx)
                rate = done / max(time.time() - t0, 1e-9)
                print(
                    f"8ply budget={budget or 'inf'}: {done}/{len(order)} "
                    f"({rate:.2f} pos/s, unsolved "
                    f"{int(np.isnan(values).sum())}, {solver.nodes:,} nodes)",
                    flush=True,
                )
            if (i // step) % 20 == 19:
                emit()
        emit()

    assert not np.isnan(values).any()
    emit()
    if os.path.exists(partial):
        os.remove(partial)
    return out_path


def _load_8ply_status(table_path: str) -> Tuple[dict, set]:
    """Child-value lookup table from a build_8ply output (mirror-expanded),
    plus the set of keys the 8-ply build knows about but has NOT yet solved.

    A partially-built 8-ply set stores placeholder 0.5 values for unsolved
    rows; only genuinely solved entries may seed 7-ply labels, so rows are
    filtered on the ``solved`` mask when present. The pending set lets the
    7-ply builder avoid re-solving positions the (usually concurrent)
    8-ply build will deliver anyway."""
    import zipfile

    table: dict = {}
    pending: set = set()
    if not os.path.exists(table_path):
        return table, pending
    # A concurrent build_8ply may be mid-write (its emit() is atomic from
    # this round on, but an older process or a non-atomic writer can still
    # leave a truncated zip visible); retry briefly before giving up.
    for attempt in range(5):
        try:
            with np.load(table_path) as d:
                ok = d["solved"] if "solved" in d else np.ones(len(d["values"]), bool)
                for o_b, x_b, v, good in zip(d["o_bits"], d["x_bits"], d["values"], ok):
                    o_b, x_b = int(o_b), int(x_b)
                    if good:
                        table[(o_b, x_b)] = float(v)
                        table[(_mirror(o_b), _mirror(x_b))] = float(v)
                    else:
                        pending.add((o_b, x_b))
                        pending.add((_mirror(o_b), _mirror(x_b)))
            return table, pending
        except FileNotFoundError:
            raise  # a vanished table file is not transient
        except (zipfile.BadZipFile, EOFError, OSError, ValueError):
            if attempt == 4:
                raise
            table.clear()
            pending.clear()
            time.sleep(2.0 * (attempt + 1))
    return table, pending


def build_7ply(
    out_path: str,
    limit: Optional[int] = None,
    chunk: int = 200,
    n_threads: int = 0,
    tt_size: int = 1 << 31,
    verbose: bool = True,
    follow: bool = False,
    poll_seconds: float = 60.0,
) -> str:
    """Build the 7-ply value+policy benchmark per the reference recipe
    (``generate_7ply.py``): for each distinct non-terminal 7-ply position,
    child values are exact outcomes; value = best child for the side to
    move (at 7 plies, x); policy = uniform over optimal moves.

    Children that belong to the UCI 8-ply set but are still unsolved in
    the 8-ply table are never solved here — the (typically concurrent)
    ``build_8ply`` job owns them, and solving them twice in separate
    transposition tables would waste the machine. With ``follow=True``
    the builder instead polls the 8-ply npz and re-resolves whenever the
    table grows, so 7-ply coverage rides the 8-ply build for free; the
    loop ends when every position is resolved. Without ``follow``, a
    final unlimited pass solves whatever the table never delivered
    (standalone completeness, e.g. in tests)."""
    from connect4_tpu_torch.native.solver import ExactSolver

    if n_threads == 0:
        n_threads = os.cpu_count() or 1
    ips = enumerate_positions(7)  # x to move (age 7)
    if limit is not None:
        ips = ips[:limit]

    partial = out_path + ".partial.npz"
    _remove_stale_tmps(out_path)
    _remove_stale_tmps(partial)
    values = np.full(len(ips), np.nan, dtype=np.float32)
    policies = np.zeros((len(ips), WIDTH), dtype=np.float32)
    start = 0
    if os.path.exists(partial):
        with np.load(partial) as d:
            if len(d["values"]) == len(ips):
                values = d["values"]
                policies = d["policies"]
                start = int(d["done"])

    # 8-ply value table from a prior build_8ply run accelerates child
    # lookups enormously (the reference used the UCI table the same way,
    # ``generate_7ply.py:59-83``); children outside the table are solved
    # directly.
    table_path = os.path.join(os.path.dirname(out_path), "connect4dataset_8ply.npz")
    table, pending_uci = _load_8ply_status(table_path)
    table_mtime = os.path.getmtime(table_path) if os.path.exists(table_path) else 0.0
    if table and verbose:
        print(
            f"7ply: loaded {len(table)} 8-ply table entries "
            f"({len(pending_uci)} pending upstream)",
            flush=True,
        )
    # direct solves of non-UCI children are cached across retry sweeps
    extra: Dict[Tuple[int, int], float] = {}

    o_bits = np.array([p[0] for p in ips], dtype=np.uint64)
    x_bits = np.array([p[1] for p in ips], dtype=np.uint64)
    planes = bits_to_planes(o_bits, x_bits, age_parity_o=False)

    def emit() -> None:
        """Write the dataset with whatever is resolved so far; consumers
        filter on ``solved`` (mirrors build_8ply's partial emission)."""
        _atomic_savez(
            out_path,
            compressed=True,
            planes=planes,
            values=np.nan_to_num(values, nan=0.5),
            solved=~np.isnan(values),
            policies=policies,
            o_bits=o_bits,
            x_bits=x_bits,
        )

    # the transposition table is a multi-GB allocation; skip it entirely
    # when every child resolves from the 8-ply table (common in tests and
    # in reruns over an already-complete table)
    solver_box = []

    def get_solver():
        if not solver_box:
            solver_box.append(ExactSolver(tt_size))
        return solver_box[0]

    t0 = time.time()
    pass1_budget = 2_000_000

    def resolve_ip(i, budget, defer_pending_uci=True):
        """Returns True when fully resolved; fills values/policies[i]."""
        o, x = ips[i]
        mask = o | x
        child_vals = np.full(WIDTH, np.nan, dtype=np.float32)
        exists = np.zeros(WIDTH, dtype=bool)
        pending, cols = [], []
        blocked = False
        for c in range(WIDTH):
            cell = (mask + _COL_BASE[c]) & _COL_FULL[c]
            if not cell:
                continue
            exists[c] = True
            nx = x | cell  # x moves at ply 7
            if _wins(nx):
                child_vals[c] = 0.0  # x win
                continue
            if (mask | cell) == _BOARD:
                child_vals[c] = 0.5
                continue
            hit = table.get((o, nx))
            if hit is None:
                hit = extra.get((o, nx))
            if hit is not None:
                child_vals[c] = hit
            elif _winning_cells(o) & _playable_cells(mask | cell):
                # o to move with a playable completing cell: o just wins
                child_vals[c] = 1.0
            elif defer_pending_uci and (o, nx) in pending_uci:
                # the 8-ply build owns this child; wait for its table
                blocked = True
            else:
                pending.append((o, nx))
                cols.append(c)
        # Blocked positions (some child pending upstream) skip their local
        # children on budgeted passes — the next table sweep retries them
        # anyway — but DO solve them on unlimited-budget attempts, so a
        # position waiting on the 8-ply build overlaps its own hard local
        # work instead of serialising it after the table completes.
        if pending and (not blocked or budget == 0):
            vals = _solve_bits(get_solver(), pending, True, n_threads, budget=budget)
            for c, (po, px), v in zip(cols, pending, vals):
                child_vals[c] = v
                if not np.isnan(v):
                    extra[(po, px)] = float(v)
        if blocked or np.isnan(child_vals[exists]).any():
            return False
        best = np.min(child_vals[exists])  # x (minimiser) to move
        values[i] = best
        optimal = exists & (np.abs(child_vals - best) < 1e-9)
        policies[i] = optimal / optimal.sum()
        return True

    deferred = []
    for i in range(start, len(ips), chunk):
        for j in range(i, min(i + chunk, len(ips))):
            if not resolve_ip(j, pass1_budget):
                deferred.append(j)
        done = min(i + chunk, len(ips))
        _atomic_savez(
            partial, compressed=False,
            values=values, policies=policies, done=np.int64(done),
        )
        if (i // chunk) % 20 == 19:
            emit()
        if verbose:
            rate = (done - start) / max(time.time() - t0, 1e-9)
            print(
                f"7ply pass1: {done}/{len(ips)} ({rate:.1f} pos/s, "
                f"deferred {len(deferred)})",
                flush=True,
            )

    # everything still unresolved (incl. positions before a resumed `start`
    # whose deferral happened in an earlier process) moves to the next stage
    deferred = [int(i) for i in np.nonzero(np.isnan(values))[0]]

    emit()

    def save_partial():
        _atomic_savez(
            partial, compressed=False,
            values=values, policies=policies, done=np.int64(len(ips)),
        )

    if follow:
        # Ride the concurrent 8-ply build: whenever its npz grows, re-run
        # the cheap table/static resolution over what is still unresolved.
        # The loop exits to the local finishing pass as soon as the table
        # is complete (no pending upstream keys) or absent — checked
        # *before* sleeping, so an already-complete or missing table never
        # parks the builder forever waiting for an mtime change.
        #
        # Idle poll windows are spent solving, not sleeping: positions
        # whose unresolved children are all OUTSIDE the UCI set (the
        # upstream build will never deliver them) are finished locally at
        # unlimited budget while waiting — otherwise that hard-tail work
        # would serialise after the 8-ply build instead of overlapping it.
        # Blocked positions solve their local children too on these
        # unlimited-budget attempts (cached in ``extra``); re-attempts
        # after a sleep are then near-free dictionary hits.
        budget = pass1_budget
        local_i = 0
        since_flush = 0
        while deferred:
            if not pending_uci or not os.path.exists(table_path):
                # table complete (or no upstream build at all); anything
                # left is ours to finish locally
                break
            nonlocal_mtime = os.path.getmtime(table_path)
            if nonlocal_mtime != table_mtime:
                table_mtime = nonlocal_mtime
                table, pending_uci = _load_8ply_status(table_path)
                t0 = time.time()
                deferred = [i for i in deferred if not resolve_ip(i, budget)]
                save_partial()
                emit()
                local_i = 0
                if verbose:
                    print(
                        f"7ply follow: {len(ips) - len(deferred)}/{len(ips)} "
                        f"resolved ({len(table) // 2} table entries, "
                        f"sweep {time.time() - t0:.0f}s)",
                        flush=True,
                    )
                continue
            if local_i < len(deferred):
                i = deferred[local_i]
                t0 = time.time()
                if resolve_ip(i, 0, defer_pending_uci=True):
                    deferred.pop(local_i)
                    since_flush += 1
                    if since_flush >= 10:
                        since_flush = 0
                        save_partial()
                        emit()
                    if verbose:
                        print(
                            f"7ply local: {len(ips) - len(deferred)}/{len(ips)} "
                            f"resolved ({time.time() - t0:.0f}s)",
                            flush=True,
                        )
                else:
                    local_i += 1
            else:
                # every remaining position waits on the upstream build
                if since_flush:
                    since_flush = 0
                    save_partial()
                    emit()
                time.sleep(poll_seconds)
                local_i = 0
        for k, i in enumerate(list(deferred)):
            if resolve_ip(i, 0, defer_pending_uci=False):
                deferred.remove(i)
            if (k + 1) % 10 == 0 or not deferred:
                save_partial()
    else:
        t0 = time.time()
        for k, i in enumerate(deferred):
            resolve_ip(i, 0, defer_pending_uci=False)
            if (k + 1) % 10 == 0 or k + 1 == len(deferred):
                save_partial()
                if (k + 1) % 100 == 0:
                    emit()
                if verbose:
                    rate = (k + 1) / max(time.time() - t0, 1e-9)
                    print(
                        f"7ply pass2: {k + 1}/{len(deferred)} ({rate:.2f} pos/s)",
                        flush=True,
                    )
    assert not np.isnan(values).any()
    emit()
    if os.path.exists(partial):
        os.remove(partial)
    return out_path


def main():
    import argparse

    parser = argparse.ArgumentParser(description="Generate benchmark datasets")
    parser.add_argument("which", choices=["8ply", "7ply", "both"])
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--threads", type=int, default=0)
    parser.add_argument(
        "--follow", action="store_true",
        help="7ply: poll the 8-ply npz and resolve as its table grows "
             "instead of solving UCI children locally",
    )
    parser.add_argument(
        "--tt-bits", type=int, default=31,
        help="log2 of transposition-table entries (8 bytes each; 31 = 16 GB;"
             " the unlimited-budget passes benefit from 32-33 when RAM allows)",
    )
    args = parser.parse_args()

    out_dir = args.out_dir
    if out_dir is None:
        from connect4_tpu_torch.config import StorageConfig

        out_dir = StorageConfig().data_dir
    os.makedirs(out_dir, exist_ok=True)

    if args.which in ("8ply", "both"):
        build_8ply(
            os.path.join(out_dir, "connect4dataset_8ply.npz"),
            limit=args.limit,
            n_threads=args.threads,
            tt_size=1 << args.tt_bits,
        )
    if args.which in ("7ply", "both"):
        build_7ply(
            os.path.join(out_dir, "connect4dataset_7ply.npz"),
            limit=args.limit,
            n_threads=args.threads,
            tt_size=1 << args.tt_bits,
            follow=args.follow,
        )


if __name__ == "__main__":
    main()
