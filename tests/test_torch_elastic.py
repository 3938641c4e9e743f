"""Elastic restore (tests/test_elastic.py's case on torch.distributed):
a state saved from a 4-rank (2, 2) mesh with "w" sharded P("data",
"model") restores onto a 2-rank (1, 2) mesh with P(None, "model"):
equal values in the asked placements. The files rank 0 wrote (manifest
and leaves) are byte-identical to a one-process save of the same full
state, so the format stays the reference's.
"""
import os

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_ranks
from repro_torch.checkpoint import CheckpointManager

STEP = 5


def _state():
    rng = np.random.default_rng(3)
    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.from_numpy(rng.standard_normal((4, 6)).astype(
                np.float32)).to(torch.bfloat16),
            "step": torch.tensor(STEP, dtype=torch.int32)}


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    state = _state()
    _torch_ranks.run_ranks(_torch_ranks.elastic_save_body, 4, tmp, state,
                           STEP)
    like = {k: torch.zeros_like(v) for k, v in state.items()}
    _torch_ranks.run_ranks(_torch_ranks.elastic_restore_body, 2, tmp, like)
    return tmp, state, [_torch_ranks.load(tmp / f"restore_{r}.pt")
                        for r in range(2)]


def test_elastic_restore_onto_a_smaller_mesh(elastic):
    _, state, ranks = elastic
    for r, got in enumerate(ranks):
        assert torch.equal(got["full"], state["w"])
        assert got["placements"] == got["want"] == [Replicate(), Shard(1)]
        # P(None, "model") on (1, 2): rank r holds columns 4r..4r+3
        assert torch.equal(got["local"], state["w"][:, 4 * r:4 * r + 4])
        assert int(got["step"]) == STEP
        assert got["step_placements"] == [Replicate(), Replicate()]
        assert got["b"].dtype == torch.bfloat16
        assert torch.equal(got["b"], state["b"])


def test_sharded_save_is_byte_identical_to_one_process(elastic, tmp_path):
    tmp, state, _ = elastic
    CheckpointManager(str(tmp_path)).save(STEP, state, blocking=True)
    a = tmp / "ckpt" / f"step_{STEP:010d}"
    b = tmp_path / f"step_{STEP:010d}"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) == [
        "leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
        "manifest.json"]
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert not [n for n in os.listdir(tmp / "ckpt") if ".tmp-" in n]
