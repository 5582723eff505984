"""The port's CheckpointManager against the JAX package's on-disk format:
a training state (gemma3-1b smoke, 2 layers, AdamW state) written by
JAX's ``CheckpointManager`` restores in the port bit for bit, and the
port's restores in JAX bit for bit; the integrity check, shape and path
errors, keep-N garbage collection and async saves.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JMgr
from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs import get_config as j_get_config
from repro.train.optimizer import Optimizer as JOpt
from repro.train.optimizer import OptimizerConfig as JOC
from repro.train.step import init_state as j_init_state
from repro_torch.ckpt.checkpoint import CheckpointManager as TMgr
from repro_torch.configs import get_config as t_get_config
from repro_torch.train.optimizer import Optimizer as TOpt
from repro_torch.train.optimizer import OptimizerConfig as TOC
from repro_torch.train.step import init_state as t_init_state
from repro_torch.utils.pytrees import flatten_with_paths


@pytest.fixture(scope="module")
def states():
    """(JAX state, port state): the same tree, different values (each
    package's own init), AdamW moments made nonzero, step 5."""
    cj = j_get_config("gemma3-1b", smoke=True).replace(num_layers=2)
    ct = t_get_config("gemma3-1b", smoke=True).replace(num_layers=2)
    sj = j_init_state(cj, JOpt(JOC()), jax.random.PRNGKey(1))
    sj["opt"] = jax.tree.map(lambda x: x + 0.25, sj["opt"])
    sj["step"] = sj["step"] + 5
    st = t_init_state(ct, TOpt(TOC()), 2, device="cpu")
    with torch.no_grad():
        for _, v in flatten_with_paths(st["opt"]):
            v.add_(0.5)
    st["step"] = st["step"] + 5
    return sj, st


def _assert_same(t_state, j_state):
    jflat = _tree_to_arrays(j_state)
    tflat = flatten_with_paths(t_state)
    assert sorted(jflat) == [p for p, _ in tflat]
    for path, t in tflat:
        a = t.detach().cpu().numpy()
        assert a.dtype == jflat[path].dtype, path
        np.testing.assert_array_equal(a, jflat[path], err_msg=path)


def test_jax_written_state_restores_in_the_port(states, tmp_path):
    sj, st = states
    JMgr(str(tmp_path), async_save=False).save(5, sj, extra={"who": "jax"})
    restored, meta = TMgr(str(tmp_path)).restore_latest(st)
    assert meta["step"] == 5 and meta["extra"] == {"who": "jax"}
    _assert_same(restored, sj)
    assert all(p.requires_grad for _, p in flatten_with_paths(
        restored["params"]))
    assert restored["step"].dtype == torch.int32


def test_port_written_state_restores_in_jax(states, tmp_path):
    sj, st = states
    mgr = TMgr(str(tmp_path))
    mgr.save(5, st)                        # async
    mgr.wait()
    restored, meta = JMgr(str(tmp_path)).restore(5, sj)
    assert meta["step"] == 5
    _assert_same(st, restored)
    # the same format: the key separator and the payload's sha256
    path = tmp_path / "step_000000005"
    with open(path / "meta.json") as f:
        assert len(json.load(f)["sha256"]) == 64
    keys = np.load(path / "state.npz").files
    assert "params\x1fembed\x1ftable" in keys and "step" in keys


def test_integrity_and_template_errors(states, tmp_path):
    _, st = states
    mgr = TMgr(str(tmp_path), async_save=False)
    mgr.save(1, st)
    npz = tmp_path / "step_000000001" / "state.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF
    npz.write_bytes(bytes(data))
    with pytest.raises(IOError, match="integrity"):
        mgr.restore(1, st)
    mgr.save(2, {"step": torch.zeros((), dtype=torch.int32)})
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(2, {"step": torch.zeros((), dtype=torch.int32),
                        "w": torch.zeros(3)})
    mgr.save(3, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(3, {"w": torch.zeros(5)})


def test_keep_n_garbage_collection_and_async_saves(tmp_path):
    mgr = TMgr(str(tmp_path), keep=2)
    for step in range(1, 6):
        mgr.save(step, {"w": torch.full((3,), float(step))})
    mgr.wait()
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    w, _ = mgr.restore_latest({"w": torch.zeros(3)})
    assert torch.equal(w["w"], torch.full((3,), 5.0))
    assert TMgr(str(tmp_path / "empty")).restore_latest({}) == (None, None)
