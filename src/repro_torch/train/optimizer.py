"""AdamW with float32, bfloat16 or block-quantized int8 moments.

Counterpart of `repro/train/optimizer.py`, in its arithmetic and order:
a global-norm clip `min(1, clip / sqrt(sum g² + 1e-12))`, bias
corrections `1 − b ** count` in float32, `upd = m̂ / (√v̂ + eps) + wd·p`
on every leaf (decay included), `p − lr·upd`. `torch.optim.AdamW` and
`clip_grad_norm_` place the decay, eps and the clip's epsilon elsewhere
and have no int8 moments, so they are not used.

int8 moments are symmetric per block of QBLOCK along the last dim (the
last dim padded to a multiple of it), with a float32 scale a block; the
second moment is stored in the sqrt domain, which keeps its relative
error bounded (8-bit Adam). The optimizer state is a dict of tensors:
{"m": {name: moment}, "v": {name: moment}, "count": int32 0-d}, a moment
being a tensor or, under int8, {"q", "scale"}. Parameters and moments
are updated in place, in the parameters' order, with no host sync. A
leaf of more than CHUNK elements is updated in slices of whole rows
along its first axis: the update is elementwise (int8 blocks lie along
the last axis), so the bits are the same, and the float32 temporaries of
a step (≈ 9 of the slice's size) stay ≈ 1.2 GB where deepseek-v3's
embedding and head, 0.93 B elements each, would need ≈ 33 GB.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

QBLOCK = 128
CHUNK = 1 << 25   # elements of a leaf's slice in `adamw_update`


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8
    grad_clip: float = 1.0


def quantize(x: torch.Tensor) -> dict:
    """{"q": int8 [..., padded last dim], "scale": float32 [..., blocks]}:
    per block scale = max |x| · (1/127) — XLA compiles the reference's
    division by the constant 127 into that product, so the bits match its
    jitted step —, q = round(x / max(scale, 1e-20)) (a division; half to
    even) clipped to ±127."""
    x = x.to(torch.float32)
    pad = (-x.shape[-1]) % QBLOCK
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], x.shape[-1] // QBLOCK, QBLOCK)
    scale = blocks.abs().amax(dim=-1) * (1.0 / 127.0)
    q = torch.round(blocks / torch.clamp(scale[..., None], min=1e-20))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale}


def dequantize(qt: dict, shape) -> torch.Tensor:
    """float32 `shape` from quantize's {"q", "scale"}."""
    q = qt["q"]
    blocks = q.reshape(*q.shape[:-1], q.shape[-1] // QBLOCK, QBLOCK)
    x = (blocks.to(torch.float32) * qt["scale"][..., None]).reshape(q.shape)
    return x[..., :shape[-1]].reshape(shape)


def _moment_init(p: torch.Tensor, cfg: AdamWConfig):
    if cfg.moment_dtype == "int8":
        padded = p.shape[-1] + (-p.shape[-1]) % QBLOCK
        return {"q": torch.zeros(p.shape[:-1] + (padded,), dtype=torch.int8,
                                 device=p.device),
                "scale": torch.zeros(p.shape[:-1] + (padded // QBLOCK,),
                                     dtype=torch.float32, device=p.device)}
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def init_opt_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments for {name: parameter}, and a zero int32 count."""
    if cfg.moment_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r}")
    dev = next(iter(params.values())).device
    return {"m": {k: _moment_init(p, cfg) for k, p in params.items()},
            "v": {k: _moment_init(p, cfg) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _read_moment(m, shape, cfg: AdamWConfig, second: bool = False):
    if cfg.moment_dtype == "int8":
        x = dequantize(m, shape)
        return x * x if second else x
    return m.to(torch.float32)


def _write_moment(dst, x, cfg: AdamWConfig, second: bool = False) -> None:
    if cfg.moment_dtype == "int8":
        if second:
            x = torch.sqrt(torch.clamp(x, min=0.0))
        qt = quantize(x)
        dst["q"].copy_(qt["q"])
        dst["scale"].copy_(qt["scale"])
    else:
        dst.copy_(x)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt: dict,
                 cfg: AdamWConfig) -> None:
    """One AdamW step, in place: `params` and `opt`'s moments and count
    are written; `grads` ({name: gradient}, float32 or the parameter's
    dtype) is read. Everything stays on the parameters' device."""
    opt["count"].add_(1)
    count = opt["count"].to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=count.device)
    b1c = 1.0 - (one * cfg.b1) ** count
    b2c = 1.0 - (one * cfg.b2) ** count
    if cfg.grad_clip > 0:
        sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                 for g in grads.values())
        gn = torch.sqrt(sq + 1e-12)
        cscale = torch.clamp(cfg.grad_clip / gn, max=1.0)
    else:
        cscale = 1.0
    for k, p in params.items():
        for rows in _row_slices(p):
            _update(p[rows], grads[k][rows], _rows(opt["m"][k], rows),
                    _rows(opt["v"][k], rows), cscale, b1c, b2c, cfg)


def _row_slices(p: torch.Tensor) -> list:
    """Slices of whole rows of p along its first axis, each of at most
    CHUNK elements where a row fits (a leaf of at most CHUNK elements, or
    of one axis, is one slice)."""
    if p.dim() < 2 or p.numel() <= CHUNK:
        return [slice(None)]
    per = max(1, CHUNK // (p.numel() // p.shape[0]))
    return [slice(i, i + per) for i in range(0, p.shape[0], per)]


def _rows(m, rows: slice):
    """Rows `rows` of a moment (a view; an int8 moment's q and scale)."""
    if isinstance(m, dict):
        return {n: t[rows] for n, t in m.items()}
    return m[rows]


def _update(p, g, m, v, cscale, b1c, b2c, cfg: AdamWConfig) -> None:
    """One AdamW step of a parameter (or a slice of its rows), in place."""
    g32 = g.to(torch.float32) * cscale
    m32 = _read_moment(m, p.shape, cfg)
    v32 = _read_moment(v, p.shape, cfg, second=True)
    m32 = cfg.b1 * m32 + (1 - cfg.b1) * g32
    v32 = cfg.b2 * v32 + (1 - cfg.b2) * g32 * g32
    mhat = m32 / b1c
    vhat = v32 / b2c
    p32 = p.to(torch.float32)
    upd = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
    p.copy_(p32 - cfg.lr * upd)
    _write_moment(m, m32, cfg)
    _write_moment(v, v32, cfg, second=True)
