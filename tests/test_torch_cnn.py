"""Port parity of the paper's CNN family (``models/cnn.py``,
``configs/paper_cnn.py``) against :mod:`repro.models.cnn`: the im2col
patch order, and forward, aux and every gradient of ``loss_fn`` for
``vgg_small`` and ``resnet_small`` under the paper's regimes
(traditional = ideal, A+B = analog, A+B+C = bit-serial), JAX's weights
carried across by the bridge.

Tolerances: patches bit for bit (a gather, no arithmetic); logits within
2e-5 of their largest |value| and the loss within 1e-6 relative; energy
and reg within rtol 1e-5 (weight-sized float32 sums in other orders);
every gradient leaf within 2e-5 of its largest |value| (float32 order
differences through 2-4 conv layers and their im2col sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs import paper_cnn as jcfgs
from repro.core.emt_linear import EMTConfig as JEMT
from repro.core.quant import QuantConfig as JQC
from repro.configs.common import emt_preset as j_emt_preset
from repro.models import cnn as jcnn
from repro.models.context import Ctx as JCtx
from repro.nn.param import init_params
from repro_torch.configs import paper_cnn as tcfgs
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.models import cnn as tcnn
from repro_torch.models.context import Ctx as TCtx
from repro_torch.nn.param import load_arrays
from repro_torch.train.step import make_grad_fn
from repro_torch.utils.pytrees import flatten_with_paths


def _close(a, b, tol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), what


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)])
def test_patches_match_jax_order_and_padding(k, stride):
    """F.unfold's (C, kh, kw) order with "same" zero padding is JAX's
    conv_general_dilated_patches' on the padded image."""
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 3)).astype(np.float32)
    pj = np.asarray(jcnn._patches(jnp.asarray(x), k, stride))
    pt = tcnn._patches(torch.tensor(x), k, stride).numpy()
    assert pt.shape == pj.shape
    np.testing.assert_array_equal(pt, pj)


def test_paper_configs_mirror_jax():
    for name in ("vgg16_cifar", "resnet18_cifar", "vgg_small",
                 "resnet_small"):
        cj, ct = getattr(jcfgs, name)(), getattr(tcfgs, name)()
        for f in ("name", "arch", "channels", "blocks_per_stage",
                  "num_classes", "image_size", "in_channels"):
            assert getattr(ct, f) == getattr(cj, f), (name, f)
        jshapes = {p: tuple(s.shape) for p, s in
                   _tree_to_arrays(jax.tree.map(
                       lambda s: np.zeros(s.shape), jcnn.specs(cj),
                       is_leaf=lambda s: hasattr(s, "init"))).items()}
        tshapes = {p: tuple(s.shape)
                   for p, s in flatten_with_paths(tcnn.specs(ct))}
        assert tshapes == jshapes, name


def _regime_j(name):
    mode, trainable = tcfgs.REGIMES[name]
    if mode == "ideal":
        return JEMT(mode="ideal", quant=JQC(8, 8, True))
    return j_emt_preset(mode).replace(trainable_rho=trainable)


@pytest.mark.parametrize("regime", ["traditional", "A+B", "A+B+C"])
@pytest.mark.parametrize("arch", ["vgg_small", "resnet_small"])
def test_forward_aux_and_gradients_match_jax(arch, regime):
    cj = getattr(jcfgs, arch)(_regime_j(regime))
    ct = getattr(tcfgs, arch)(tcfgs.regime(regime))
    params_j = init_params(jcnn.specs(cj), jax.random.PRNGKey(0))
    params_t = load_arrays(tcnn.specs(ct), _tree_to_arrays(params_j),
                           device="cpu")
    for _, p in flatten_with_paths(params_t):
        p.requires_grad_(True)
    data = SyntheticImages(num_classes=ct.num_classes,
                           image_size=ct.image_size, device="cpu")
    batch = data.arrays(4, step=2)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    lam = 1e-4

    @jax.jit
    def jax_side(params, batch, seed):
        logits, _ = jcnn.forward(params, batch["images"], cj, JCtx(seed=seed))
        return logits, jax.value_and_grad(jcnn.loss_fn, has_aux=True)(
            params, batch, cj, JCtx(seed=seed), lam=lam)
    lj, ((jloss, jm), jgrads) = jax_side(params_j, bj, jnp.uint32(2))
    lt, aux = tcnn.forward(params_t, bt["images"], ct, TCtx(seed=2))
    _close(lt.detach(), lj, 2e-5, "logits")
    loss, metrics, grads = make_grad_fn(ct, lam)(params_t, bt, 2)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for k in ("ce", "acc", "energy_uj", "reg", "rho_mean"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    jflat = _tree_to_arrays(jgrads)
    tflat = flatten_with_paths(grads)
    assert sorted(jflat) == [p for p, _ in tflat]
    for path, g in tflat:
        _close(g.numpy(), jflat[path], 2e-5, path)
    if regime != "traditional":
        assert np.abs(jflat["head/rho_raw"]) > 0        # technique B
