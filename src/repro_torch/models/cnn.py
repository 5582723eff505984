"""The paper's own model family: small VGG/ResNet-style CNNs on EMT
crossbars (port of :mod:`repro.models.cnn`).

Convolutions run as im2col + ``emt_dense``: each patch is the analog
input-line vector and the (k*k*Cin, Cout) kernel matrix the crossbar, the
mapping of the paper's Fig. 1(c).  Patches are ``F.unfold``'s, ordered
(C, kh, kw) as JAX's ``conv_general_dilated_patches`` orders them, with
"same" zero padding.  Normalization is LayerNorm over channels (stateless;
the reference's documented deviation from BatchNorm).  Images are
(B, H, W, C), JAX's layout, at the public functions.  Layer tags
``s{i}b{j}/c1|c2|proj`` and ``head`` seed the noise planes as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.emt_linear import (EMTConfig, add_aux, dense_specs,
                                         emt_dense, new_aux)
from repro_torch.core.placement import DevicePlacement, as_placement
from repro_torch.models.context import Ctx
from repro_torch.nn.param import ParamSpec, constant_init, ones_init


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "vgg_s"
    arch: str = "vgg"                # vgg | resnet
    channels: Tuple[int, ...] = (32, 64, 128)
    blocks_per_stage: int = 1
    num_classes: int = 10
    image_size: int = 32
    in_channels: int = 3
    # one global EMTConfig or a DevicePlacement over paths s{i}b{j}/{c1,c2,
    # proj} and "head"
    emt: Union[EMTConfig, DevicePlacement] = EMTConfig()
    dtype: Any = torch.float32

    @property
    def placement(self) -> DevicePlacement:
        return as_placement(self.emt)

    def emt_at(self, path: str) -> EMTConfig:
        return self.placement.resolve(path)

    def replace(self, **kw) -> "CNNConfig":
        return dataclasses.replace(self, **kw)


def _patches(x, k: int, stride: int = 1):
    """x (B, H, W, C) -> (B, H', W', C*k*k) patches, (C, kh, kw) order,
    "same" zero padding (im2col)."""
    B, H, W, C = x.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), (k, k), padding=k // 2,
                    stride=stride)                      # (B, C*k*k, L)
    Ho = (H + 2 * (k // 2) - k) // stride + 1
    Wo = (W + 2 * (k // 2) - k) // stride + 1
    return cols.transpose(1, 2).reshape(B, Ho, Wo, C * k * k)


def conv_specs(cin, cout, emt: EMTConfig, k=3, dtype=torch.float32):
    return dense_specs(k * k * cin, cout, emt, dtype=dtype, bias=True)


def emt_conv(params, x, emt: EMTConfig, *, k=3, stride=1, tag, ctx: Ctx):
    return emt_dense(params, _patches(x, k, stride), emt, tag=tag,
                     seed=ctx.seed)


def layernorm_specs(c):
    return {"scale": ParamSpec((c,), torch.float32, ones_init),
            "bias": ParamSpec((c,), torch.float32, constant_init(0.0))}


def layernorm(params, x, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * params["scale"]
            + params["bias"]).to(x.dtype)


def specs(cfg: CNNConfig) -> dict:
    s = {}
    cin = cfg.in_channels
    for si, c in enumerate(cfg.channels):
        for bi in range(cfg.blocks_per_stage):
            name = f"s{si}b{bi}"
            s[name] = {"conv1": conv_specs(cin if bi == 0 else c, c,
                                           cfg.emt_at(f"{name}/c1")),
                       "ln1": layernorm_specs(c),
                       "conv2": conv_specs(c, c, cfg.emt_at(f"{name}/c2")),
                       "ln2": layernorm_specs(c)}
            if cfg.arch == "resnet" and bi == 0 and cin != c:
                s[name]["proj"] = conv_specs(cin, c,
                                             cfg.emt_at(f"{name}/proj"), k=1)
            cin = c
    s["head"] = dense_specs(cfg.channels[-1], cfg.num_classes,
                            cfg.emt_at("head"), bias=True)
    return s


def forward(params, x, cfg: CNNConfig, ctx: Ctx):
    """x: (B, H, W, C) in [0, 1].  Returns (logits (B, classes), aux)."""
    aux = new_aux()
    h = x.to(cfg.dtype)
    for si, c in enumerate(cfg.channels):
        for bi in range(cfg.blocks_per_stage):
            name = f"s{si}b{bi}"
            p = params[name]
            y, a = emt_conv(p["conv1"], h, cfg.emt_at(f"{name}/c1"),
                            tag=f"{name}/c1", ctx=ctx)
            aux = add_aux(aux, a)
            y = F.relu(layernorm(p["ln1"], y))
            y2, a = emt_conv(p["conv2"], y, cfg.emt_at(f"{name}/c2"),
                             tag=f"{name}/c2", ctx=ctx)
            aux = add_aux(aux, a)
            y2 = layernorm(p["ln2"], y2)
            if cfg.arch == "resnet":
                skip = h
                if "proj" in p:
                    skip, a = emt_conv(p["proj"], h,
                                       cfg.emt_at(f"{name}/proj"), k=1,
                                       tag=f"{name}/proj", ctx=ctx)
                    aux = add_aux(aux, a)
                if skip.shape == y2.shape:
                    y2 = y2 + skip
            h = F.relu(y2)
        # 2x2 mean-pool between stages
        B, H, W, C = h.shape
        h = h.reshape(B, H // 2, 2, W // 2, 2, C).mean((2, 4))
    h = h.mean((1, 2))                                   # global average pool
    logits, a = emt_dense(params["head"], h, cfg.emt_at("head"), tag="head",
                          seed=ctx.seed)
    aux = add_aux(aux, a)
    return logits.to(torch.float32), aux


def loss_fn(params, batch, cfg: CNNConfig, ctx: Ctx, lam: float = 0.0):
    """Cross-entropy of ``batch`` (``images`` (B, H, W, C), ``labels`` (B,))
    + ``lam * aux["reg"]``.  Returns (loss, metrics), the metrics detached:
    loss, ce, acc, energy_uj, reg, rho_mean."""
    logits, aux = forward(params, batch["images"], cfg, ctx)
    logp = torch.log_softmax(logits, -1)
    labels = batch["labels"].long()
    ce = -torch.mean(torch.gather(logp, -1, labels[:, None]))
    loss = ce + lam * aux["reg"]
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))

    def d(v):
        return v.detach() if isinstance(v, torch.Tensor) else v

    return loss, {"loss": d(loss), "ce": d(ce), "acc": acc,
                  "energy_uj": d(aux["energy_pj"]) * 1e-6,
                  "reg": d(aux["reg"]),
                  "rho_mean": d(aux["rho_sum"]) / max(1, aux["rho_layers"])}
