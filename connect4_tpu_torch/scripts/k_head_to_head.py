"""Same-net head-to-head between two parallel_sims settings.

The counterpart of the JAX package's ``scripts/k_head_to_head.py``: it
measures the search-quality cost of deeper virtual-loss parallelism
directly. Both players share one net and differ only in K, the walkers a
search iteration (``MCTSConfig.parallel_sims``); they play every distinct
``--plies``-ply start in both colours (``eval.match.play_match``, seed 0).
A return near 0.5 means the K-walker approximation does not change move
quality at this simulation budget. ``--simulations`` must be a multiple of
both K (the search refuses one that K does not divide).

The net is the packaged gen-161 (``models.convert.load_example_net``) unless
``--checkpoint-dir`` (and ``--generation``, default the latest) names a
run's checkpoint: the JAX default, a generation of a run directory that is
not in the repository, has no counterpart. As in the JAX script the net
computes in bf16 whatever it was trained in, through the folded evaluator,
so on the card every search iteration launches the tower kernel.

    python -m connect4_tpu_torch.scripts.k_head_to_head [--ka 8] [--kb 16] [--simulations 800] \\
        [--plies 2] [--checkpoint-dir DIR] [--generation N] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import resolve_device


def load_net(checkpoint_dir, generation, device):
    """``(name, net)`` as ``_common.load_net`` gives it, set to compute in
    bf16."""
    name, net = _common.load_net(checkpoint_dir, generation, device)
    net.config = dataclasses.replace(net.config, compute_dtype="bfloat16")
    return name, net


def k_head_to_head(evaluator, ka: int = 8, kb: int = 16, simulations: int = 800, plies: int = 2,
                   device="cuda") -> dict:
    """``{"ka", "kb", wins, draws, losses, return}`` of K=``ka`` against
    K=``kb``, both searching with ``evaluator``."""
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.match import MatchPlayer, play_match

    dev = resolve_device(device)
    for k in (ka, kb):
        if simulations % k:
            raise ValueError(f"--simulations {simulations} is not a multiple of K={k}")
    pa = MatchPlayer(f"K{ka}", evaluator, MCTSConfig(simulations=simulations, parallel_sims=ka))
    pb = MatchPlayer(f"K{kb}", evaluator, MCTSConfig(simulations=simulations, parallel_sims=kb))
    res = play_match(pa, pb, plies=plies, switch=True, device=dev)
    return {"ka": ka, "kb": kb, **res}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ka", type=int, default=8)
    parser.add_argument("--kb", type=int, default=16)
    parser.add_argument("--checkpoint-dir", default=None,
                        help="a run's save_dir (default: the packaged gen-161 net)")
    parser.add_argument("--generation", type=int, default=None)
    parser.add_argument("--simulations", type=int, default=800)
    parser.add_argument("--plies", type=int, default=2)
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    from connect4_tpu_torch.eval.evaluators import make_net_evaluator

    dev = resolve_device(args.device)
    name, net = load_net(args.checkpoint_dir, args.generation, dev)
    r = k_head_to_head(make_net_evaluator(net), args.ka, args.kb, args.simulations, args.plies, dev)
    _common.emit({**r, "net": name, "simulations": args.simulations, "plies": args.plies,
                  "device": _common.device_name(dev)})
    return r


if __name__ == "__main__":
    main()
