"""Shared model substrate: norms, RoPE, activations, parameter init.

Counterpart of `repro/models/common.py`. Parameters live in
`nn.ParameterDict`s keyed by the reference's leaf names ("wq", "w_in",
"scale", ...), so the functional layers below take either a
ParameterDict or a plain dict of tensors. Every init helper draws from an
explicit `torch.Generator`; `jax.random` cannot be reproduced in torch,
so parity with the reference goes through `convert.lm_params_to_torch`.
Parameters are trainable (`requires_grad`); the serving entry points
(`DecoderLM.prefill` / `decode_step`, `train.serve_step.generate`) run
under `torch.no_grad`, so serving builds no autograd graph.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def dense_init(shape, in_axis_size: int, dtype,
               generator: torch.Generator | None, device) -> nn.Parameter:
    """normal · 1/√fan_in drawn in float32 on the generator's device, then
    cast (the reference's `dense_init`); the scaling is in place, so a
    leaf's draw holds one copy of it (a 15 GB expert leaf of deepseek-v3).
    Without a generator the tensor is left uninitialised, for a caller
    that loads its values (`convert.lm_params_to_torch`)."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    v = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    v.mul_(1.0 / math.sqrt(max(in_axis_size, 1)))   # in place: one copy
    return nn.Parameter(v.to(device=device, dtype=dtype))


def _fill(shape, value: float, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# ---------------------------------------------------------------- norms ----
def rms_norm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def nonparam_layer_norm(x, eps=1e-5):
    """OLMo-style non-parametric LayerNorm (no scale/bias)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def init_norm(cfg, d: int, device) -> nn.ParameterDict:
    """layernorm: scale 1, bias 0; nonparam_ln: nothing; rmsnorm: scale 0
    (the `1 + scale` form)."""
    dt = cfg.param_dtype
    if cfg.norm_type == "layernorm":
        return nn.ParameterDict({"scale": _fill((d,), 1.0, dt, device),
                                 "bias": _fill((d,), 0.0, dt, device)})
    if cfg.norm_type == "nonparam_ln":
        return nn.ParameterDict()
    return nn.ParameterDict({"scale": _fill((d,), 0.0, dt, device)})


def apply_norm(cfg, p, x):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    if cfg.norm_type == "nonparam_ln":
        return nonparam_layer_norm(x)
    return rms_norm(x, p["scale"])


# ----------------------------------------------------------------- rope ----
def rope_freqs(dim: int, theta: float, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x [..., S, H, dh] (dh even), positions [..., S] integer. Half-split
    rotation, angles in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # [dh/2]
    ang = positions[..., None].to(torch.float32) * freqs     # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                       # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
