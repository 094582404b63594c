"""Attention: GQA flash (chunked online softmax), sliding-window and
local/global patterns, bidirectional (encoder) and cross-attention over a
memory, DeepSeek's multi-head latent attention (MLA), and the decode
paths over a KV, static cross K/V or latent cache.

Counterpart of `repro/models/attention.py`. The reference's
`flash_attention` and MLA are jnp code compiled by XLA (no Pallas
kernel), so they stay torch ops here, with the reference's KV chunking,
padding of the last chunk, masks, einsum order and summation structure,
so that the rounding follows the reference's.

Caches are written in place: `attention_decode` and `mla_decode` update
the cache tensors they are given and return the same dict.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import _fill, apply_rope, dense_init, rms_norm

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


def attention_forward(cfg, p, x, *, positions, causal=True, window=0,
                      kv_override=None):
    """Full-sequence attention (train / prefill). x [B, S, d], positions
    [B, S]. Self-attention by default: q and K/V projected from x and
    roped at `positions`, causal unless `causal=False` (an encoder's
    bidirectional layer). With a memory `kv_override` [B, Se, d] it is
    cross-attention: K/V are projected from the memory, neither they nor
    q are roped, and every query sees every memory row (no mask, no
    window). Returns (out [B, S, d], (k, v) [B, S or Se, KV, hd])."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, s, h, hd)
    if kv_override is None:
        kk = (x @ p["wk"].to(cd)).reshape(b, s, kv, hd)
        vv = (x @ p["wv"].to(cd)).reshape(b, s, kv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        kk = apply_rope(kk, positions, cfg.rope_theta)
    else:
        enc = kv_override
        se = enc.shape[1]
        kk = (enc @ p["wk"].to(cd)).reshape(b, se, kv, hd)
        vv = (enc @ p["wv"].to(cd)).reshape(b, se, kv, hd)
        causal, window = False, 0
    out = flash_attention(q, kk, vv, causal=causal, window=window)
    return out.reshape(b, s, h * hd) @ p["wo"].to(cd), (kk, vv)


def attention_decode(cfg, p, x, cache, *, pos, window=0, cross_kv=None):
    """One token. x [B, 1, d]; cache {"k", "v"} [B, S, KV, hd], written in
    place at slot `pos` (global) or `pos % S` (sliding window: a rolling
    buffer); pos [B] must lie inside a global cache (`DecoderLM.
    decode_step` checks an int position). With `cross_kv` (ck, cv) [B,
    Se, KV, hd], the static cache of a cross-attention layer, q is
    projected but not roped, every one of the Se slots is valid, and
    `cache` is returned untouched. Returns (out [B, 1, d], cache)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, 1, h, hd)
    if cross_kv is not None:
        kk, vv = cross_kv
        valid = torch.full((b,), kk.shape[1], dtype=torch.int32,
                           device=x.device)
        out = decode_attention(q, kk, vv, valid)
        return out.reshape(b, 1, h * hd) @ p["wo"].to(cd), cache
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


# -------------------------------------------------------------------- MLA ----
def init_mla(cfg, generator: torch.Generator, device) -> nn.ParameterDict:
    """The reference's MLA leaves: the query's low-rank pair wq_a [d,
    q_lora] / wq_b [q_lora, H·(nope + rope)] around q_norm, the joint KV
    down-projection wkv_a [d, kv_lora + rope] (the latent and the shared
    roped key), kv_norm, the up-projection wkv_b [kv_lora, H·(nope + v)]
    and wo [H·v, d]; the norms' scales zero (the `1 + scale` form)."""
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.param_dtype
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    return nn.ParameterDict({
        "wq_a": dense_init((d, ql), d, dt, generator, device),
        "q_norm": _fill((ql,), 0.0, dt, device),
        "wq_b": dense_init((ql, h * qk), ql, dt, generator, device),
        "wkv_a": dense_init((d, kl + cfg.qk_rope_dim), d, dt, generator,
                            device),
        "kv_norm": _fill((kl,), 0.0, dt, device),
        "wkv_b": dense_init((kl, h * (cfg.qk_nope_dim + cfg.v_head_dim)), kl,
                            dt, generator, device),
        "wo": dense_init((h * cfg.v_head_dim, d), h * cfg.v_head_dim, dt,
                         generator, device),
    })


def _mla_query(cfg, p, x):
    """[..., H, nope + rope]: the query through its low-rank pair."""
    cd = cfg.compute_dtype
    q = rms_norm(x @ p["wq_a"].to(cd), p["q_norm"]) @ p["wq_b"].to(cd)
    return q.reshape(*x.shape[:-1], cfg.n_heads,
                     cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_forward(cfg, p, x, *, positions):
    """Train / prefill MLA over x [B, S, d]: per-head K/V materialised from
    the latent, then causal `flash_attention` at a q·k width of nope +
    rope and a v width of v_head_dim. Returns (out [B, S, d], (c_kv
    [B, S, kv_lora], k_rope [B, S, rope])), the latent cache."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lr, cd = cfg.kv_lora_rank, cfg.compute_dtype
    q = _mla_query(cfg, p, x)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"].to(cd)                              # [B, S, lr+rd]
    c_kv = rms_norm(kv_a[..., :lr], p["kv_norm"])
    k_rope = apply_rope(kv_a[..., lr:][:, :, None, :], positions,
                        cfg.rope_theta)                       # [B, S, 1, rd]
    kv = (c_kv @ p["wkv_b"].to(cd)).reshape(b, s, h, nd + vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rd)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(qf, k, v, causal=True)
    return (out.reshape(b, s, h * vd) @ p["wo"].to(cd),
            (c_kv, k_rope[:, :, 0, :]))


def mla_decode(cfg, p, x, cache, *, pos):
    """Absorbed MLA decode of one token x [B, 1, d] at positions pos [B]:
    W_uk is folded into the query and the scores are taken against the
    latent cache {"c_kv" [B, S, kv_lora], "k_rope" [B, S, rope]} (kv_lora
    + rope values a token instead of 2·H·dh), written in place at `pos`
    and masked to slots ≤ pos; the value side leaves the latent through
    W_uv after the softmax. Returns (out [B, 1, d], cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lr, cd = cfg.kv_lora_rank, cfg.compute_dtype
    q = _mla_query(cfg, p, x).reshape(b, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    kv_a = x[:, 0, :] @ p["wkv_a"].to(cd)
    c_new = rms_norm(kv_a[..., :lr], p["kv_norm"])
    kr_new = apply_rope(kv_a[:, None, None, lr:], pos[:, None],
                        cfg.rope_theta)[:, 0, 0]
    ckv, krc = cache["c_kv"], cache["k_rope"]
    rows, slot = torch.arange(b, device=x.device), pos.long()
    ckv[rows, slot] = c_new.to(ckv.dtype)
    krc[rows, slot] = kr_new.to(krc.dtype)
    wkv_b = p["wkv_b"].to(cd).reshape(lr, h, nd + vd)
    w_uk, w_uv = wkv_b[..., :nd], wkv_b[..., nd:]   # [lr, H, nd], [lr, H, vd]
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope, w_uk)
    s_lat = torch.einsum("bhl,bsl->bhs", q_lat, ckv)
    s_rope = torch.einsum("bhr,bsr->bhs", q_rope, krc)
    sc = (s_lat + s_rope) * (nd + rd) ** -0.5
    mask = (torch.arange(ckv.shape[1], device=x.device)[None, :]
            <= pos[:, None])                                  # [B, S]
    sc = sc.to(torch.float32).masked_fill(~mask[:, None, :], NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(cd)
    o_lat = torch.einsum("bhs,bsl->bhl", pr, ckv)
    out = torch.einsum("bhl,lhv->bhv", o_lat, w_uv).reshape(b, 1, h * vd)
    return out @ p["wo"].to(cd), cache
