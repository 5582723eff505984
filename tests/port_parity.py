"""Helpers of the parity tests that hold whole stacks of the port to the
JAX package: the same seeded weights in both, and DAC levels recorded from
JAX's jitted steps and replayed in the port's, so that a float32 tie at an
8-bit DAC level cannot make the two differ by a whole level."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.models import lm as tlm
from repro_torch.utils.pytrees import flatten_with_paths, unflatten_paths


def shared_weights(cfg_t, seed: int = 0):
    """(JAX's parameter tree, the port's) holding the same seeded numpy
    weights, by path: the port's seeded init (no JAX compile), loaded
    through the bridge ``lm.load_jax_arrays``; JAX's tree built from the
    same arrays (a path JAX's model lacks fails its step)."""
    arrays = {path: t.numpy() for path, t in
              flatten_with_paths(tlm.init_model_params(cfg_t, seed,
                                                       device="cpu"))}
    params_t = tlm.load_jax_arrays(arrays, cfg_t, device="cpu")
    params_j = unflatten_paths([(k, jnp.asarray(v))
                                for k, v in arrays.items()])
    return params_j, params_t


@contextlib.contextmanager
def jax_levels(mod, out):
    """Record every projection's DAC (levels, scale) of JAX's jitted steps
    in `out`, in program order (`mod` is ``repro.core.emt_linear``; ordered
    host callbacks, which the block waits for on exit).  A step must be
    traced inside the block."""
    orig = mod.quant_levels

    def quant(x, bits, axis=None):
        lv, sc = orig(x, bits, axis=axis)
        jax.debug.callback(
            lambda a, b: out.append((np.asarray(a), np.asarray(b))), lv, sc,
            ordered=True)
        return lv, sc

    mod.quant_levels = quant
    try:
        yield
        jax.effects_barrier()
    finally:
        mod.quant_levels = orig


@contextlib.contextmanager
def port_levels(mod, out, replay=None):
    """Record every projection's DAC (levels, scale) of the port in `out`
    (`mod` is ``repro_torch.core.emt_linear``); with `replay` (a list in
    call order), return those instead, popping them."""
    orig = mod.quant_levels

    def quant(x, bits, axis=None):
        if replay is None:
            lv, sc = orig(x, bits, axis=axis)
        else:
            lv, sc = (torch.tensor(a) for a in replay.pop(0))
            assert tuple(lv.shape) == tuple(x.shape)
        out.append((np.asarray(lv), np.asarray(sc)))
        return lv, sc

    mod.quant_levels = quant
    try:
        yield
    finally:
        mod.quant_levels = orig


@contextlib.contextmanager
def port_levels_ste(mod, replay):
    """The port's projections read JAX's DAC (levels, scale) from `replay`
    (a list in call order, popped) with the straight-through gradient kept
    (`mod` is ``repro_torch.core.emt_linear``): levels = x / scale +
    detach(recorded - x / scale), as quant_levels builds its own, so a
    training step's gradients flow to the DAC's input as JAX's do."""
    orig = mod.quant_levels

    def quant(x, bits, axis=None):
        lv, sc = (torch.tensor(a) for a in replay.pop(0))
        assert tuple(lv.shape) == tuple(x.shape)
        xs = x / sc
        return xs + (lv - xs).detach(), sc

    mod.quant_levels = quant
    try:
        yield
    finally:
        mod.quant_levels = orig
