"""The port's dataset builders (``connect4_tpu_torch.data.datasets``)
against the JAX package's: the same position enumerations and planes, the same
7-ply set, array for array, built from one small made-up 8-ply table (the
recipe of tests/test_datasets_7ply.py: every child resolves from the table,
so no solver runs); the port's training loop then evaluates on that set."""

import os

import numpy as np
import torch

from connect4_tpu.data import datasets as jds
from connect4_tpu_torch.config import AlphaZeroConfig, ModelConfig, NetConfig, StorageConfig
from connect4_tpu_torch.data import datasets as tds
from connect4_tpu_torch.training.loop import TrainingLoop

torch.set_num_threads(1)

N_POS = 40


def test_enumerations_match_jax():
    """The port expands ply by ply where the JAX package walks every move
    sequence: the same positions in the same order. The UCI 8-ply set is
    held against the one the JAX builder wrote into the packaged npz (its
    enumeration takes ~15 s; tests/test_solver.py counts it)."""
    for plies in range(8):
        assert tds.enumerate_positions(plies) == jds.enumerate_positions(plies), plies
    with np.load(os.path.join(StorageConfig().data_dir, "connect4dataset_8ply.npz")) as f:
        packaged = list(zip(f["o_bits"].tolist(), f["x_bits"].tolist()))
    assert tds.enumerate_8ply_uci() == packaged


def test_bits_to_planes_matches_jax():
    ips = jds.enumerate_positions(5)[:200]
    o = np.array([p[0] for p in ips], np.uint64)
    x = np.array([p[1] for p in ips], np.uint64)
    for parity in (True, False):
        np.testing.assert_array_equal(tds.bits_to_planes(o, x, parity), jds.bits_to_planes(o, x, parity))


def _fake_8ply_table(path, ips):
    """Every non-terminal child of ``ips``, solved, with a seeded value
    (the layout build_8ply writes)."""
    rng = np.random.default_rng(0)
    o_list, x_list = [], []
    for o, x in ips:
        mask = o | x
        for c in range(7):
            cell = (mask + jds._COL_BASE[c]) & jds._COL_FULL[c]
            if not cell or jds._wins(x | cell) or (mask | cell) == jds._BOARD:
                continue
            o_list.append(o)
            x_list.append(x | cell)
    n = len(o_list)
    np.savez_compressed(
        path, planes=np.zeros((n, 3, 6, 7), np.uint8),
        values=rng.choice([0.0, 0.5, 1.0], n).astype(np.float32),
        solved=np.ones(n, bool),
        o_bits=np.array(o_list, np.uint64), x_bits=np.array(x_list, np.uint64),
    )


def test_7ply_set_from_a_table_matches_jax_and_feeds_the_loop(tmp_path):
    ips = jds.enumerate_positions(7)[:N_POS]
    out = {}
    for name, module in (("port", tds), ("jax", jds)):
        d = tmp_path / name
        d.mkdir()
        _fake_8ply_table(d / "connect4dataset_8ply.npz", ips)
        module.build_7ply(str(d / "connect4dataset_7ply.npz"), limit=N_POS, chunk=16, verbose=False)
        assert not os.path.exists(d / "connect4dataset_7ply.npz.partial.npz")
        with np.load(d / "connect4dataset_7ply.npz") as f:
            out[name] = dict(f)
    assert sorted(out["port"]) == sorted(out["jax"]) == [
        "o_bits", "planes", "policies", "solved", "values", "x_bits"]
    for key in out["port"]:
        np.testing.assert_array_equal(out["port"][key], out["jax"][key], err_msg=key)
    assert out["port"]["solved"].all()

    with np.load(os.path.join(StorageConfig().data_dir, "connect4dataset_7ply.npz")) as packaged:
        for key in out["port"]:
            assert out["port"][key].dtype == packaged[key].dtype, key
            assert out["port"][key].shape[1:] == packaged[key].shape[1:], key

    config = AlphaZeroConfig(
        model_config=ModelConfig(net_config=NetConfig(filters=4, n_fc_layers=1, n_residuals=1)),
        storage_config=StorageConfig(save_dir=str(tmp_path / "run"), data_dir=str(tmp_path / "port")),
    )
    loop = TrainingLoop(config, device="cpu")
    loop._evaluate()
    assert len(loop.stats_7ply) == 1 and len(loop.stats_8ply) == 1
    assert np.isfinite(loop.stats_7ply[0]["Average loss"])
