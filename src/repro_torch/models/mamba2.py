"""Mamba2's SSD (state-space duality) mixer, chunked.

Counterpart of `repro/models/mamba2.py` (jnp in the reference, compiled
by XLA outside any Pallas kernel, so torch ops here). Train and prefill
run the sequence in chunks of `cfg.ssm_chunk`: each chunk adds the
quadratic intra-chunk term (attention-like [B, Q, Q, H] products) to the
inter-chunk term read from the carried state, and updates that state;
a Python loop over chunks carries it. Decode is the O(1) recurrence
h[t] = e^{aΔ} h[t − 1] + Δ·(B ⊗ x), y = C·h + D·x.

One B / C group (n_groups = 1, the 2.7b default): B, C ∈ [B, S, N].

`_ssd_chunked` departs from the reference in two ways, neither of which
changes an output the reference gives (SSD does not depend on the chunk
length, which the tests use to hold each departure to the reference):
  (a) the decay exponent a_cs[q] − a_cs[k] is masked to −inf above the
      diagonal before `exp`. The reference exponentiates the whole
      [Q, Q] square and zeroes the upper triangle afterwards; the
      exponent there is a positive sum of up to Q steps, which overflows
      to inf (past ≈127 steps at init), and the backward multiplies the
      zero cotangent by it: NaN gradients of `a_log`, `dt_bias`, `wdt` at
      the published chunk of 256. Here exp(−inf) = 0: the same forward,
      finite gradients.
  (b) a sequence longer than the chunk and not a multiple of it is
      padded to the next multiple with a = 0 and x·dt = 0, which leaves
      every real output and the final state unchanged; the reference
      asserts there (an 18-token RAG prompt at the tiny configs' chunk
      of 16).

The recurrent cache is {"h": [B, H, P, N] float32, "conv": [B, k − 1,
d_inner + 2N]} (the last k − 1 raw x, B, C projections): it has no
sequence axis, and `mamba2_decode` writes it in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import _fill, dense_init, rms_norm, silu


def init_mamba2(cfg, generator, device) -> nn.ParameterDict:
    """The reference's 13 leaves, in its key order: the projections wz,
    wx [d, d_inner], wB, wC [d, N], wdt [d, H] and wo [d_inner, d] drawn
    normal · 1/√fan_in; the depthwise convolutions conv_x, conv_B, conv_C
    [k, ·], a_log and dt_bias [H] and the gated norm's scale [d_inner]
    zero; the skip d_skip [H] one."""
    d, dt = cfg.d_model, cfg.param_dtype
    di = cfg.ssm_expand * d
    n, k = cfg.ssm_state, cfg.ssm_conv
    h = di // cfg.ssm_head_dim

    def w(shape, fan_in):
        return dense_init(shape, fan_in, dt, generator, device)

    def const(shape, value):
        return _fill(shape, value, dt, device)

    p = {"wz": w((d, di), d), "wx": w((d, di), d), "wB": w((d, n), d),
         "wC": w((d, n), d), "wdt": w((d, h), d),
         "conv_x": const((k, di), 0.0), "conv_B": const((k, n), 0.0),
         "conv_C": const((k, n), 0.0), "a_log": const((h,), 0.0),
         "d_skip": const((h,), 1.0), "dt_bias": const((h,), 0.0),
         "norm": const((di,), 0.0), "wo": w((di, d), di)}
    return nn.ParameterDict(p)


def _causal_conv(x, w):
    """Depthwise causal convolution as the reference's k shifted adds, in
    its order: x [B, S, C], w [k, C]."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    acc = torch.zeros_like(x)
    for i in range(k):
        acc = acc + xp[:, i:i + s, :] * w[i]
    return acc


def _ssd_chunked(xdt, a, bb, cc, chunk: int):
    """SSD over chunks of min(chunk, S) positions.

    xdt [B, S, H, P]  inputs pre-scaled by dt
    a   [B, S, H]     per-step log decay (dt · A, negative)
    bb  [B, S, N]     input projection (shared across heads)
    cc  [B, S, N]     output projection
    returns y [B, S, H, P] and the final state [B, H, P, N], float32.
    Departures (a) and (b) of the module docstring."""
    b, s, h, p = xdt.shape
    n = bb.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:   # departure (b): a = 0 and x·dt = 0 leave y[:s] and h alone
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, pad))
    upper = ~torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xdt.device))
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32,
                         device=xdt.device)
    ys = []
    for j in range(nc):
        sl = slice(j * q, (j + 1) * q)
        xq, aq, bq, cq = xdt[:, sl], a[:, sl], bb[:, sl], cc[:, sl]
        a_cs = torch.cumsum(aq, dim=1)                      # inclusive [B,Q,H]
        # intra-chunk (quadratic, attention-like)
        cb = torch.einsum("bqn,bkn->bqk", cq, bq)           # [B, Q, Q]
        seg = a_cs[:, :, None, :] - a_cs[:, None, :, :]     # [B, Q, K, H]
        seg = seg.masked_fill(upper[None, :, :, None], float("-inf"))
        ldec = torch.exp(seg)                               # departure (a)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", cb[..., None] * ldec, xq)
        # inter-chunk from the carried state
        y_inter = torch.einsum("bqn,bhpn->bqhp", cq, hstate)
        y_inter = y_inter * torch.exp(a_cs)[..., None]
        # state update
        a_sum = a_cs[:, -1, :]                              # [B, H]
        w = torch.exp(a_sum[:, None, :] - a_cs)             # [B, Q, H]
        hstate = hstate * torch.exp(a_sum)[..., None, None] + torch.einsum(
            "bqhp,bqn->bhpn", xq * w[..., None], bq)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :s], hstate


def _dt(cfg, prm, x):
    """softplus(x · wdt + dt_bias) in float32."""
    cd = cfg.compute_dtype
    return F.softplus((x @ prm["wdt"].to(cd)).to(torch.float32)
                      + prm["dt_bias"].to(torch.float32))


def mamba2_forward(cfg, prm, x, return_state: bool = False):
    """The full-sequence mixer: x [B, S, d] → [B, S, d]; with
    `return_state`, also the prefill's cache {"h": the final state,
    "conv": the raw x, B, C projections of the last k − 1 positions}."""
    b, s, d = x.shape
    di = cfg.ssm_expand * d
    hd = cfg.ssm_head_dim
    h = di // hd
    cd = cfg.compute_dtype
    f32 = torch.float32

    z = x @ prm["wz"].to(cd)
    raw = [x @ prm[n].to(cd) for n in ("wx", "wB", "wC")]
    xi, bi, ci = (silu(_causal_conv(r, prm[n].to(cd)))
                  for r, n in zip(raw, ("conv_x", "conv_B", "conv_C")))
    dt = _dt(cfg, prm, x)                                   # [B, S, H]
    a = -torch.exp(prm["a_log"].to(f32))                    # [H]
    alog = dt * a[None, None, :]

    xh = xi.reshape(b, s, h, hd)
    xdt = xh.to(f32) * dt[..., None]
    y, hfin = _ssd_chunked(xdt, alog, bi.to(f32), ci.to(f32), cfg.ssm_chunk)
    y = y + xh.to(f32) * prm["d_skip"].to(f32)[None, None, :, None]
    y = y.reshape(b, s, di).to(cd)
    y = rms_norm(y * silu(z), prm["norm"])
    out = y @ prm["wo"].to(cd)
    if return_state:
        tail = torch.cat([r[:, -(cfg.ssm_conv - 1):, :] for r in raw],
                         dim=-1)
        return out, {"h": hfin, "conv": tail}
    return out


def mamba2_decode(cfg, prm, x, cache: dict):
    """One recurrent step: x [B, 1, d]; cache {"h": [B, H, P, N], "conv":
    [B, k − 1, d_inner + 2N]}, written in place and returned. The state
    has no positions: the reference's `pos` argument, which it does not
    read, is not taken."""
    b = x.shape[0]
    di = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    h = di // hd
    cd = cfg.compute_dtype
    f32 = torch.float32

    x0 = x[:, 0, :]
    z = x0 @ prm["wz"].to(cd)
    raw = torch.cat([x0 @ prm[nm].to(cd) for nm in ("wx", "wB", "wC")],
                    dim=-1)                                 # [B, di + 2N]
    win = torch.cat([cache["conv"], raw[:, None, :]], dim=1)  # [B, k, C]
    wfull = torch.cat([prm[nm].to(cd) for nm in
                       ("conv_x", "conv_B", "conv_C")], dim=-1)  # [k, C]
    conv_out = torch.einsum("bkc,kc->bc", win, wfull)
    xi = silu(conv_out[:, :di])
    bi = silu(conv_out[:, di:di + n]).to(f32)
    ci = silu(conv_out[:, di + n:]).to(f32)

    dt = _dt(cfg, prm, x0)                                  # [B, H]
    a = -torch.exp(prm["a_log"].to(f32))
    decay = torch.exp(dt * a[None, :])

    xh = xi.reshape(b, h, hd).to(f32)
    hnew = cache["h"] * decay[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, bi, xh)
    y = torch.einsum("bn,bhpn->bhp", ci, hnew)
    y = y + xh * prm["d_skip"].to(f32)[None, :, None]
    y = y.reshape(b, di).to(cd)
    y = rms_norm(y * silu(z), prm["norm"])
    out = (y @ prm["wo"].to(cd))[:, None, :]
    cache["h"].copy_(hnew)
    cache["conv"].copy_(win[:, 1:, :])
    return out, cache
