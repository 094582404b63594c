"""Attention: GQA flash (chunked online softmax), sliding-window and
local/global patterns, and the decode path over a KV cache.

Counterpart of `repro/models/attention.py`. The reference's
`flash_attention` is jnp code compiled by XLA (no Pallas kernel), so it
stays torch ops here, with the reference's KV chunking, padding of the
last chunk, masks and summation structure, so that the rounding follows
the reference's. MLA (`attention.py:177-266` of the reference) is not
ported yet (ROADMAP.md Queue 1, item 5c).

KV caches are written in place: `attention_decode` updates the cache
tensors it is given and returns the same dict.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import apply_rope, dense_init

NEG_INF = -1e30


# ------------------------------------------------------------------ flash ----
def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, kv_chunk: int = 1024):
    """q [B, Sq, H, dh], k [B, Skv, KV, dh], v [B, Skv, KV, dhv] →
    [B, Sq, H, dhv]. KV is scanned in chunks of `kv_chunk` (the last one
    padded and masked) with an online softmax, so no Sq × Skv matrix is
    held. `window` > 0 keeps keys with k_pos > q_pos − window; `q_offset`
    is the absolute position of q[:, 0]."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    dhv = v.shape[-1]
    c = min(kv_chunk, skv)
    nc = -(-skv // c)
    pad = nc * c - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))

    scale = dh ** -0.5
    qq = (q * scale).reshape(b, sq, kv, g, dh)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, sq, kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, kv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kv, g, dhv), dtype=torch.float32,
                      device=q.device)
    for j in range(nc):
        kj = k[:, j * c:(j + 1) * c]
        vj = v[:, j * c:(j + 1) * c]
        s = torch.einsum("bqkgd,bckd->bqkgc", qq, kj).to(torch.float32)
        k_pos = j * c + torch.arange(c, device=q.device)
        mask = (k_pos[None, :] < skv).expand(sq, c)            # kv padding
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(vj.dtype), vj).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, dhv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_len):
    """q [B, 1, H, dh] over the first `valid_len[b]` slots of a cache
    [B, S, KV, dh]. Slots are masked by the valid count only, never by
    key position (the reference's rule)."""
    b, _, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qq = (q * dh ** -0.5).reshape(b, kv, g, dh)
    sc = torch.einsum("bkgd,bskd->bkgs", qq, k_cache).to(torch.float32)
    mask = (torch.arange(s, device=q.device)[None, :]
            < valid_len[:, None])                              # [B, S]
    sc = sc.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype),
                       v_cache).to(torch.float32)
    return out.reshape(b, 1, h, -1).to(q.dtype)


# ----------------------------------------------------------- standard GQA ----
def init_attention(cfg, generator: torch.Generator, device
                   ) -> nn.ParameterDict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    return nn.ParameterDict({
        "wq": dense_init((d, h * hd), d, dt, generator, device),
        "wk": dense_init((d, kv * hd), d, dt, generator, device),
        "wv": dense_init((d, kv * hd), d, dt, generator, device),
        "wo": dense_init((h * hd, d), h * hd, dt, generator, device),
    })


def attention_forward(cfg, p, x, *, positions, window=0):
    """Full-sequence causal self-attention (prefill). x [B, S, d], positions
    [B, S]. Returns (out [B, S, d], (k, v)) with k, v roped/projected
    [B, S, KV, hd]."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, s, h, hd)
    kk = (x @ p["wk"].to(cd)).reshape(b, s, kv, hd)
    vv = (x @ p["wv"].to(cd)).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    kk = apply_rope(kk, positions, cfg.rope_theta)
    out = flash_attention(q, kk, vv, causal=True, window=window)
    return out.reshape(b, s, h * hd) @ p["wo"].to(cd), (kk, vv)


def attention_decode(cfg, p, x, cache, *, pos, window=0):
    """One token. x [B, 1, d]; cache {"k", "v"} [B, S, KV, hd], written in
    place at slot `pos` (global) or `pos % S` (sliding window: a rolling
    buffer); pos [B] must lie inside a global cache (`DecoderLM.
    decode_step` checks an int position). Returns (out [B, 1, d], cache)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, 1, h, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    knew = (x @ p["wk"].to(cd)).reshape(b, 1, kv, hd)
    vnew = (x @ p["wv"].to(cd)).reshape(b, 1, kv, hd)
    knew = apply_rope(knew, pos[:, None], cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    s_max = kc.shape[1]
    slot = (pos % s_max) if window > 0 else pos
    rows = torch.arange(b, device=x.device)
    kc[rows, slot.long()] = knew[:, 0].to(kc.dtype)
    vc[rows, slot.long()] = vnew[:, 0].to(vc.dtype)
    valid = torch.clamp(pos + 1, max=s_max)
    out = decode_attention(q, kc, vc, valid)
    return out.reshape(b, 1, h * hd) @ p["wo"].to(cd), cache
