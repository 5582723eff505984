"""Port parity of the optimizers, the clip and the schedules against
:mod:`repro.train.optimizer`, on identical seeded numpy gradients.

Tolerances: parameters and state after two updates within 1e-6 of each
tensor's largest |value| (float32 elementwise arithmetic; XLA and torch
may differ in the last ulp of ``pow``, ``sqrt`` and the means, and an
element that cancels near zero keeps that ulp); the global norm within
1e-6 relative; schedule values within 1e-6 relative (float32 ``cos``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt
from repro_torch.utils.pytrees import flatten_with_paths

SHAPES = {"a": {"w": (130, 140), "b": (140,)}, "c": {"rho_raw": ()},
          "d": {"w": (3, 200)}}


def _tree(rng, scale=1.0):
    return {k: {n: (rng.normal(size=s) * scale).astype(np.float32)
                for n, s in v.items()} for k, v in SHAPES.items()}


def _torch(tree):
    return {k: {n: torch.tensor(a) for n, a in v.items()}
            for k, v in tree.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees(t_tree, j_tree, rtol):
    jflat = _tree_to_arrays(j_tree)
    tflat = flatten_with_paths(t_tree)
    assert sorted(jflat) == [p for p, _ in tflat]
    for path, t in tflat:
        a, b = t.detach().numpy(), np.asarray(jflat[path])
        assert np.abs(a - b).max(initial=0) <= rtol * np.abs(b).max(
            initial=0), path


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_two_updates_match_jax(name, wd):
    """Two steps (0 and 1: the bias corrections and Adafactor's beta2
    move) on identical gradients; the state carries JAX's keys, factored
    (vr, vc) for Adafactor's 130 x 140 leaf."""
    rng = np.random.default_rng(0)
    params, g0, g1 = _tree(rng), _tree(rng, 0.1), _tree(rng, 0.1)
    cfg_j = jopt.OptimizerConfig(name=name, weight_decay=wd)
    cfg_t = topt.OptimizerConfig(name=name, weight_decay=wd)
    oj, ot = jopt.Optimizer(cfg_j), topt.Optimizer(cfg_t)
    pj, sj = _jax(params), oj.init(_jax(params))
    pt = _torch(params)
    st = ot.init(pt)
    _assert_trees(st, sj, 0)
    if name == "adafactor":
        assert set(st["a"]["w"]) == {"vr", "vc"} and set(st["d"]["w"]) == {"v"}
    for step, (g, lr) in enumerate(((g0, 3e-3), (g1, 2e-3))):
        pj, sj = oj.update(_jax(g), sj, pj, jnp.float32(lr), jnp.int32(step))
        pt, st = ot.update(_torch(g), st, pt, float(np.float32(lr)), step)
    _assert_trees(pt, pj, 1e-6)
    _assert_trees(st, sj, 1e-6)
    assert all(p.requires_grad is False for _, p in flatten_with_paths(pt))


def test_new_params_keep_requires_grad():
    ot = topt.Optimizer(topt.OptimizerConfig())
    p = {"w": torch.ones(3, requires_grad=True)}
    new, _ = ot.update({"w": torch.ones(3)}, ot.init(p), p, 0.1, 0)
    assert new["w"].requires_grad and new["w"].is_leaf
    assert torch.equal(p["w"], torch.ones(3))          # the old one unchanged


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    g = _tree(np.random.default_rng(1))
    gj, nj = jopt.clip_by_global_norm(_jax(g), max_norm)
    gt, nt = topt.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    np.testing.assert_allclose(float(topt.global_norm(_torch(g))),
                               float(jopt.global_norm(_jax(g))), rtol=1e-6)
    _assert_trees(gt, gj, 1e-6)
    if max_norm > float(nj):
        _assert_trees(gt, _jax(g), 0)        # scale 1: unchanged


def test_schedules_match_jax():
    warmup, total = 10, 100
    lj = jopt.cosine_schedule(3e-4, warmup, total)
    lt = topt.cosine_schedule(3e-4, warmup, total)
    for s in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 140):
        np.testing.assert_allclose(lt(s), float(lj(jnp.int32(s))),
                                   rtol=1e-6, err_msg=str(s))
    assert topt.constant_schedule(1e-3)(7) == float(
        jopt.constant_schedule(1e-3)(jnp.int32(7)))
    with pytest.raises(ValueError):
        topt.Optimizer(topt.OptimizerConfig(name="lion"))
