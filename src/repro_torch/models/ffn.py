"""Feed-forward layers: the gated SiLU MLP and the GELU MLP.

Counterpart of `repro/models/ffn.py:17-38`. The reference's sort-based
dropping MoE (`ffn.py:41-`) is not ported yet (ROADMAP.md Queue 1,
item 5b).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import dense_init, gelu, silu


def init_mlp(cfg, generator: torch.Generator, device, d_in=None, d_ff=None
             ) -> nn.ParameterDict:
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    prm = {"w_in": dense_init((d, f), d, dt, generator, device),
           "w_out": dense_init((f, d), f, dt, generator, device)}
    if cfg.act == "silu":  # gated (llama-style)
        prm["w_gate"] = dense_init((d, f), d, dt, generator, device)
    return nn.ParameterDict(prm)


def mlp_forward(cfg, p, x):
    cd = cfg.compute_dtype
    h = x @ p["w_in"].to(cd)
    if "w_gate" in p:
        h = silu(x @ p["w_gate"].to(cd)) * h
    else:
        h = gelu(h)
    return h @ p["w_out"].to(cd)
