"""DecoderLM — the decoder LM of every family (gqa or MLA attention, with
deepseek-v3's MTP head; Mamba2's SSD mixer; zamba2's shared attention
block; cross-attention over a memory, the VLM's and the enc-dec's
decoder): training loss, prefill and cached decode.

Counterpart of `repro/models/transformer.py`. The reference plans a model
as an unrolled prefix of blocks, then segments, each a scanned stack of
groups applying a static period of block types:

  olmo/granite          period = (gqa-global+mlp,)            x L groups
  h2o-danube3 (SWA)     period = (gqa-local+mlp,)             x L
  gemma3 (5:1)          period = (local x5, global)           x L/6
  phi3.5-moe            period = (gqa-global+moe,)            x L
  deepseek-v3           prefix = 3 (mla+dense), then
                        period = (mla+moe,)                   x 58
  mamba2                period = (ssm,)                       x L
  zamba2                period = (ssm x6, shared-attn+mlp)    x L/6
  llama-3.2-vision      period = (gqa x4, gqa+cross)          x L/5
  whisper (decoder)     period = (gqa+cross,)                 x L

Here the same plan unrolls into an `nn.ModuleList` of layers: the prefix
first, then layer g·len(period) + i of a segment applying period
position i of group g, with no scan. An SSM block is {norm1, mixer} (the
Mamba2 mixer, `models/mamba2.py`, and no FFN). The hybrid's attention and
MLP live once, in the top-level `shared` ModuleDict {attn, norm2, ffn},
which every `shared_attn` position applies (zamba2: 9 times); such a
position's own {norm1, norm2, ffn} are drawn as the reference draws them
(its block type has a dense FFN), but only norm1 is read: the trees, the
converters, the checkpoints and AdamW stay one to one with the
reference's, and those never-read leaves get zero gradients. In training
(`loss`) with `cfg.remat`, each prefix block and each group's layers are
checkpointed and recomputed on backward, as the reference checkpoints
them; the MoE load-balance loss of every MoE block is summed through
them in layer order, as the reference's scan carries it, and the loss is
ce + router_aux_weight · aux. With `cfg.mtp` (deepseek-v3's multi-token
prediction, depth 1) the loss adds 0.3 · the cross-entropy of one more
block, of the last segment's period type, predicting token t + 2 from
the backbone's normed h_t and the embedding of token t + 1, and its aux
(`DecoderLM.loss`); prefill and decode never read the MTP leaves. The
cross-entropy runs over sequence chunks, each recomputed on backward, so
no [B, S, V] logits tensor is held. The sharding constraints of the
reference's backbone are no-ops on one device and are dropped; they come
back with the mesh.

A cross block ({norm1, attn, norm_cross, cross, norm2, ffn}) adds, after
its self-attention's residual, a non-causal attention of norm_cross(x)
over a memory `enc` [B, Se, d] (the VLM's stubbed patch embeddings, the
enc-dec's encoder output, `models/encdec.py`), neither side roped.
`loss` reads the memory from `batch["enc"]` and `prefill` takes it as
`enc`; both raise ValueError for a model with cross blocks when it is
missing (a stated departure: the reference runs such a block as causal
self-attention over the text, ROADMAP.md Queue 3).

A cache is a list with one dict per layer: {"k", "v"} [B, S, KV, hd]
for a gqa or shared-attention layer (S = min(window, capacity) for a
sliding-window layer, a rolling buffer), the latent {"c_kv" [B, S,
kv_lora], "k_rope" [B, S, rope]} for an MLA layer, the recurrent {"h"
[B, H, P, N] float32, "conv" [B, k − 1, d_inner + 2N]} for an SSM layer
(no sequence axis: its size does not grow with the length), and for a
cross block also the static {"ck", "cv"} [B, Se, KV, hd]: the memory's
K/V, which prefill writes and decode reads (Se is not a capacity: every
slot is valid). Decode writes the rest in place. Prefill and decode run
the MoE without its aux loss, as the reference does; a decode step
routes one token a row, so its capacity (8) is never reached and it
drops nothing, while a prefill may drop (ROADMAP.md Queue 3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba2 as ssm_mod
from repro_torch.models.common import apply_norm, dense_init, init_norm


class BlockType(NamedTuple):
    mixer: str = "gqa"      # gqa | mla | ssm | shared_attn
    window: int = 0         # 0 = global attention
    ffn: str = "dense"      # dense | moe | none
    cross: bool = False     # + cross-attention sub-block (vlm / encdec decoder)
    bidir: bool = False     # non-causal self-attention (encoder stacks)


class Segment(NamedTuple):
    period: tuple           # tuple[BlockType]
    n_groups: int


class Ctx(NamedTuple):
    mode: str                              # train | prefill | decode
    positions: torch.Tensor | None = None  # [B, S] for train / prefill
    pos: torch.Tensor | None = None        # [B] decode position
    drops: list | None = None              # receives MoE drops a row
    enc: torch.Tensor | None = None        # [B, Se, d] cross-attn memory


def layer_plan(cfg: ArchConfig) -> tuple[list[Segment], list[BlockType]]:
    """(segments, unrolled prefix block types) of a config. The `ssm`
    family: (ssm, no FFN) × L; the hybrid: (ssm × hybrid_period, then
    shared_attn + dense) × L / hybrid_period. The dense and MoE families:
    the mixer MLA where `cfg.use_mla` is set, else gqa: global, `local`
    (every layer a window) or `local_global` (period − 1 local layers,
    then a global one); the FFN an MoE where `cfg.n_experts` is set; with
    global attention, the first `first_dense_layers` blocks a dense
    prefix. The VLM: (gqa × (cross_attn_period − 1), then gqa + cross) ×
    L / cross_attn_period; the enc-dec's decoder: (gqa + cross) × L (its
    encoder is `EncDecLM`'s)."""
    if cfg.family == "vlm":
        per = ((BlockType("gqa"),) * (cfg.cross_attn_period - 1)
               + (BlockType("gqa", cross=True),))
        return [Segment(per, cfg.n_layers // cfg.cross_attn_period)], []
    if cfg.family == "encdec":
        return [Segment((BlockType("gqa", cross=True),), cfg.n_layers)], []
    if cfg.family == "ssm":
        return [Segment((BlockType("ssm", ffn="none"),), cfg.n_layers)], []
    if cfg.family == "hybrid":
        per = ((BlockType("ssm", ffn="none"),) * cfg.hybrid_period
               + (BlockType("shared_attn"),))
        return [Segment(per, cfg.n_layers // cfg.hybrid_period)], []
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: no layer plan for family {cfg.family!r}")
    mixer = "mla" if cfg.use_mla else "gqa"
    ffn = "moe" if cfg.n_experts else "dense"
    if cfg.attn_kind == "local":
        return [Segment((BlockType(mixer, cfg.local_window, ffn),),
                        cfg.n_layers)], []
    if cfg.attn_kind == "local_global":
        p = cfg.local_global_period
        per = ((BlockType(mixer, cfg.local_window, ffn),) * (p - 1)
               + (BlockType(mixer, ffn=ffn),))
        return [Segment(per, cfg.n_layers // p)], []
    n = cfg.first_dense_layers
    return ([Segment((BlockType(mixer, ffn=ffn),), cfg.n_layers - n)],
            [BlockType(mixer)] * n)


def _init_block(cfg: ArchConfig, bt: BlockType, generator, device
                ) -> nn.ModuleDict:
    """One block's leaves, as the reference's `_init_block` draws them:
    norm1; the mixer's ("attn", or "mixer" for an SSM block; none for a
    shared_attn position, whose attention is the model's `shared` one);
    norm_cross and the cross-attention "cross" of a cross block; norm2
    and the FFN unless its type is "none" (a shared_attn position keeps
    its own, never read: `DecoderLM` applies the shared ones)."""
    p = {"norm1": init_norm(cfg, cfg.d_model, device)}
    if bt.mixer == "ssm":
        p["mixer"] = ssm_mod.init_mamba2(cfg, generator, device)
    elif bt.mixer != "shared_attn":
        init_attn = attn.init_mla if bt.mixer == "mla" else attn.init_attention
        p["attn"] = init_attn(cfg, generator, device)
    if bt.cross:
        p["norm_cross"] = init_norm(cfg, cfg.d_model, device)
        p["cross"] = attn.init_attention(cfg, generator, device)
    if bt.ffn != "none":
        init_ffn = ffn_mod.init_moe if bt.ffn == "moe" else ffn_mod.init_mlp
        p["norm2"] = init_norm(cfg, cfg.d_model, device)
        p["ffn"] = init_ffn(cfg, generator, device)
    return nn.ModuleDict(p)


def _init_block_cache(cfg: ArchConfig, bt: BlockType, b: int, s_max: int,
                      device) -> dict:
    """A zero cache for one block: the recurrent {"h" float32, "conv"} of
    an SSM block, whatever s_max; the latent {"c_kv", "k_rope"} of an MLA
    block, capacity s_max; K/V of a gqa or shared-attention block,
    capacity s_max, or min(window, s_max) for a sliding-window block; and
    a cross block's static {"ck", "cv"} of `cross_len(cfg)` rows."""
    def zeros(*shape, dtype=cfg.compute_dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if bt.cross:
        se = cross_len(cfg)
        return {**_init_block_cache(cfg, bt._replace(cross=False), b, s_max,
                                    device),
                "ck": zeros(b, se, cfg.n_kv_heads, cfg.hd),
                "cv": zeros(b, se, cfg.n_kv_heads, cfg.hd)}

    if bt.mixer == "ssm":
        di = cfg.ssm_expand * cfg.d_model
        return {"h": zeros(b, di // cfg.ssm_head_dim, cfg.ssm_head_dim,
                           cfg.ssm_state, dtype=torch.float32),
                "conv": zeros(b, cfg.ssm_conv - 1, di + 2 * cfg.ssm_state)}
    if bt.mixer == "mla":
        return {"c_kv": zeros(b, s_max, cfg.kv_lora_rank),
                "k_rope": zeros(b, s_max, cfg.qk_rope_dim)}
    s = min(bt.window, s_max) if bt.window else s_max
    return {"k": zeros(b, s, cfg.n_kv_heads, cfg.hd),
            "v": zeros(b, s, cfg.n_kv_heads, cfg.hd)}


def cross_len(cfg: ArchConfig) -> int:
    """The rows of a cross block's memory: the VLM's patch embeddings, the
    enc-dec's encoder frames."""
    return cfg.vision_seq if cfg.family == "vlm" else cfg.encoder_seq


def _pad_cache_seq(full, part):
    """Place a prefill-length cache `part` into the capacity-sized `full`
    at t = 0, in place; returns `full`. An SSM layer's state fills its
    leaf whole; its conv tail, shorter than k − 1 after a shorter
    prompt, lands at slot 0, as the reference places it (ROADMAP.md Queue
    3)."""
    for f, p in zip(full, part):
        for name, t in p.items():
            f[name][:, :t.shape[1]] = t.to(f[name].dtype)
    return full


class BlockApplier:
    """Applies one block (gqa, MLA, SSM or shared-attention mixer, causal
    or bidirectional; a cross-attention sub-block over `ctx.enc`; dense,
    MoE or no FFN) in train, prefill or decode mode: (x, cache, aux).
    Train builds no cache and returns None for it; aux is the MoE
    load-balance loss of an MoE block in train mode, else None. A
    shared_attn block reads `shared` {attn, norm2, ffn} in place of its
    own attention, norm2 and FFN, as the reference's does. A cross block's
    prefill caches the memory's K/V ("ck", "cv"); its decode reads them
    and writes nothing."""

    def __init__(self, cfg: ArchConfig, shared=None):
        self.cfg = cfg
        self.shared = shared

    def __call__(self, bt: BlockType, bp, x, ctx: Ctx, cache=None):
        cfg = self.cfg
        h = apply_norm(cfg, bp["norm1"], x)
        own = self.shared if bt.mixer == "shared_attn" else bp
        if bt.mixer == "ssm":
            if ctx.mode == "decode":
                out, new_cache = ssm_mod.mamba2_decode(cfg, bp["mixer"], h,
                                                       cache)
            elif ctx.mode == "prefill":
                out, new_cache = ssm_mod.mamba2_forward(
                    cfg, bp["mixer"], h, return_state=True)
            else:
                out, new_cache = ssm_mod.mamba2_forward(cfg, bp["mixer"],
                                                        h), None
        elif bt.mixer == "mla":
            if ctx.mode == "decode":
                out, new_cache = attn.mla_decode(cfg, bp["attn"], h, cache,
                                                 pos=ctx.pos)
            else:
                out, (ckv, krope) = attn.mla_forward(
                    cfg, bp["attn"], h, positions=ctx.positions)
                new_cache = (None if ctx.mode == "train"
                             else {"c_kv": ckv, "k_rope": krope})
        elif ctx.mode == "decode":
            out, new_cache = attn.attention_decode(
                cfg, own["attn"], h, cache, pos=ctx.pos, window=bt.window)
        else:
            out, (kk, vv) = attn.attention_forward(
                cfg, own["attn"], h, positions=ctx.positions,
                causal=not bt.bidir, window=bt.window)
            if ctx.mode == "train":
                new_cache = None
            elif bt.window:  # rolling window cache: the last W roped keys
                w = min(bt.window, kk.shape[1])
                new_cache = {"k": kk[:, -w:], "v": vv[:, -w:]}
            else:
                new_cache = {"k": kk, "v": vv}
        x = x + out
        if bt.cross:
            hc = apply_norm(cfg, bp["norm_cross"], x)
            if ctx.mode == "decode":
                out, _ = attn.attention_decode(
                    cfg, bp["cross"], hc, None, pos=ctx.pos,
                    cross_kv=(cache["ck"], cache["cv"]))
            else:
                out, (ck, cv) = attn.attention_forward(
                    cfg, bp["cross"], hc, positions=ctx.positions,
                    kv_override=ctx.enc)
                if ctx.mode == "prefill":
                    new_cache.update(ck=ck, cv=cv)
            x = x + out
        aux = None
        if bt.ffn == "none":
            return x, new_cache, aux
        h2 = apply_norm(cfg, own["norm2"], x)
        if bt.ffn == "dense":
            out = ffn_mod.mlp_forward(cfg, own["ffn"], h2)
        elif ctx.mode == "train":
            out, aux = ffn_mod.moe_forward(cfg, own["ffn"], h2,
                                           return_aux=True)
        else:
            out = ffn_mod.moe_forward(cfg, own["ffn"], h2, drops=ctx.drops)
        return x + out, new_cache, aux


class DecoderLM(nn.Module):
    """The decoder LM of `cfg` on `device` (the card by default): dense,
    MoE, SSM or hybrid, or the VLM's with its cross blocks (the enc-dec's
    adds its encoder: `EncDecLM`).

    With a `generator`, every weight is drawn from it as the reference's
    `init_params` draws (normal · 1/√fan_in; norms and the SSM's
    convolutions, decays and skips at their constants), the hybrid's
    `shared` block {attn, norm2, ffn} before the layers, the MTP head's
    (`cfg.mtp`: mtp_proj [2d, d], mtp_block, mtp_norm) after them; without
    one the weights are left uninitialised for a caller that loads them
    (`convert.lm_params_to_torch`)."""

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.segments, self.prefix = layer_plan(cfg)
        dev = resolve_device(device)
        self.block_types = self.prefix + [
            bt for seg in self.segments for _ in range(seg.n_groups)
            for bt in seg.period]
        d, dt = cfg.d_model, cfg.param_dtype
        self.embed = dense_init((cfg.vocab_size, d), d, dt, generator, dev)
        self.final_norm = init_norm(cfg, d, dev)
        self.head = (None if cfg.tie_embeddings else
                     dense_init((d, cfg.vocab_size), d, dt, generator, dev))
        self.shared = None
        if cfg.family == "hybrid":   # registered once: one leaf a weight
            self.shared = nn.ModuleDict({
                "attn": attn.init_attention(cfg, generator, dev),
                "norm2": init_norm(cfg, d, dev),
                "ffn": ffn_mod.init_mlp(cfg, generator, dev)})
        self.layers = nn.ModuleList(_init_block(cfg, bt, generator, dev)
                                    for bt in self.block_types)
        if cfg.mtp:
            self.mtp_proj = dense_init((2 * d, d), 2 * d, dt, generator, dev)
            self.mtp_block = _init_block(cfg, self.mtp_type, generator, dev)
            self.mtp_norm = init_norm(cfg, d, dev)
        self._applier = BlockApplier(cfg, self.shared)

    @property
    def mtp_type(self) -> BlockType:
        """The MTP block's type: the last segment's last period type."""
        return self.segments[-1].period[-1]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, b: int, s_max: int) -> list:
        return [_init_block_cache(self.cfg, bt, b, s_max, self.device)
                for bt in self.block_types]

    # ---------- forward ----------
    def _backbone(self, x, ctx: Ctx, cache=None):
        new_cache = []
        for li, (bt, bp) in enumerate(zip(self.block_types, self.layers)):
            x, nc, _ = self._applier(bt, bp, x, ctx,
                                     None if cache is None else cache[li])
            new_cache.append(nc)
        return x, new_cache

    def _train_backbone(self, x, ctx: Ctx):
        """The backbone in train mode: each prefix block, then each group
        (one period of layers); with `cfg.remat` each is checkpointed,
        keeping only its input for backward. Returns (x, the MoE aux
        losses summed in layer order, float32 0-d)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        groups = [range(i, i + 1) for i in range(len(self.prefix))]
        start = len(self.prefix)
        for seg in self.segments:
            per = len(seg.period)
            for _ in range(seg.n_groups):
                groups.append(range(start, start + per))
                start += per
        for group in groups:
            if self.cfg.remat:
                x, aux = checkpoint(self._group, x, aux, group, ctx,
                                    use_reentrant=False)
            else:
                x, aux = self._group(x, aux, group, ctx)
        return x, aux

    def _group(self, x, aux, layers, ctx: Ctx):
        for li in layers:
            x, _, a = self._applier(self.block_types[li], self.layers[li],
                                    x, ctx)
            if a is not None:
                aux = aux + a
        return x, aux

    @property
    def has_cross(self) -> bool:
        """Whether a layer cross-attends to a memory (the VLM, the enc-dec's
        decoder)."""
        return any(bt.cross for bt in self.block_types)

    def _memory(self, enc, what: str):
        """`enc` for a model with cross blocks, which cannot run without
        it (ValueError); None for one without."""
        if not self.has_cross:
            return None
        if enc is None:
            raise ValueError(
                f"{self.cfg.name}: {what} needs the cross-attention memory "
                f"[B, {cross_len(self.cfg)}, {self.cfg.d_model}] "
                "(batch['enc'] / enc=), got none")
        return enc.to(self.cfg.compute_dtype)

    def _embed(self, tokens):
        return torch.nn.functional.embedding(
            tokens.long(), self.embed).to(self.cfg.compute_dtype)

    def _logits(self, x):
        x = apply_norm(self.cfg, self.final_norm, x)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return x @ head.to(self.cfg.compute_dtype)

    def loss(self, batch):
        """Next-token cross-entropy over tokens [B, S] (`batch["tokens"]`):
        labels shifted by one, the last position masked. Returns (loss,
        metrics), 0-d float32 tensors; metrics["aux"], the MoE
        load-balance loss summed over the backbone's MoE blocks, is 0 in
        the dense family, and loss = ce + router_aux_weight·aux. With
        `cfg.mtp`, metrics["mtp_ce"] is the MTP head's cross-entropy
        (`_mtp`) and loss += 0.3·mtp_ce + router_aux_weight·(its aux).
        A model with cross blocks attends over `batch["enc"]` [B, Se, d]
        and raises ValueError without it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        ctx = Ctx(mode="train", positions=positions,
                  enc=self._memory(batch.get("enc"), "loss"))
        h, aux = self._train_backbone(self._embed(tokens), ctx)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
        mask[:, -1] = 0.0
        ce = _xent_chunked(self._logits, h, labels, mask)
        loss = ce + cfg.router_aux_weight * aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp:
            mtp_ce, aux2 = self._mtp(h, tokens, labels, ctx)
            loss = loss + 0.3 * mtp_ce + cfg.router_aux_weight * aux2
            metrics["mtp_ce"] = mtp_ce
        return loss, metrics

    def _mtp(self, h, tokens, labels, ctx: Ctx):
        """(mtp_ce, aux) of the MTP head: [mtp_norm(h_t), emb(t + 1)] through
        mtp_proj, then the MTP block in train mode (checkpointed under
        `cfg.remat`), predicting token t + 2; the last two positions
        masked."""
        cfg = self.cfg
        b, s = tokens.shape
        cat = torch.cat([apply_norm(cfg, self.mtp_norm, h),
                         self._embed(labels)], dim=-1)
        hm = cat @ self.mtp_proj.to(cfg.compute_dtype)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if cfg.remat:
            hm, aux = checkpoint(self._mtp_block, hm, aux, ctx,
                                 use_reentrant=False)
        else:
            hm, aux = self._mtp_block(hm, aux, ctx)
        labels2 = torch.cat([tokens[:, 2:], tokens[:, :2]], dim=1)
        mask2 = torch.ones((b, s), dtype=torch.float32, device=h.device)
        mask2[:, -2:] = 0.0
        return _xent_chunked(self._logits, hm, labels2, mask2), aux

    def _mtp_block(self, x, aux, ctx: Ctx):
        x, _, a = self._applier(self.mtp_type, self.mtp_block, x, ctx)
        return x, aux if a is None else aux + a

    @torch.no_grad()
    def prefill(self, tokens, drops: list | None = None, enc=None):
        """Full-sequence forward over tokens [B, S]; returns (last-position
        logits [B, 1, V], a prefill-length cache: `train.serve_step.
        generate` places it in a capacity cache before decoding). `drops`,
        a list, receives each MoE block's dropped assignments a dispatch
        row (`ffn.moe_forward`), in layer order. A model with cross blocks
        attends over the memory `enc` [B, Se, d] and caches its K/V; it
        raises ValueError without one."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        ctx = Ctx(mode="prefill", positions=positions, drops=drops,
                  enc=self._memory(enc, "prefill"))
        h, cache = self._backbone(self._embed(tokens), ctx)
        return self._logits(h[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One token: tokens [B, 1] at position `pos`, a Python int (every
        row there) or an int tensor [B]. Writes the cache in place;
        returns (logits [B, 1, V], cache). An int position beyond a global
        attention layer's capacity (its K/V or latent cache's sequence
        axis) raises here, on the host, without waiting for the card (the
        reference's `dynamic_update_slice` would clamp it onto the last
        slot); an SSM layer's state has no capacity, so a model of SSM
        layers alone decodes at any position. A tensor's positions are
        the caller's to keep inside the capacity, as
        `train.serve_step.generate` does by sizing the cache."""
        if isinstance(pos, int):
            caps = [c[n].shape[1]
                    for bt, c in zip(self.block_types, cache)
                    if not bt.window for n in ("k", "c_kv") if n in c]
            if caps and pos >= min(caps):
                raise ValueError(
                    f"decode position {pos} is beyond the cache's "
                    f"capacity of {min(caps)} slots")
            pos = torch.full((tokens.shape[0],), pos, dtype=torch.int32,
                             device=tokens.device)
        ctx = Ctx(mode="decode", pos=pos)
        h, cache = self._backbone(self._embed(tokens), ctx, cache)
        return self._logits(h), cache


def _xent(logits, labels):
    """Mean cross-entropy of logits [..., V] against labels [...], in
    float32."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


def _xent_chunk(head_fn, hh, ll, mm):
    """(masked cross-entropy sum, mask sum) of one sequence chunk."""
    logits = head_fn(hh).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ll[..., None].long())[..., 0]
    return ((lse - gold) * mm).sum(), mm.sum()


def _xent_chunked(head_fn, h, labels, mask, chunk: int = 512):
    """Masked mean cross-entropy of head_fn(h) over sequence chunks of
    `chunk` positions (the last one padded and masked), float32 sums
    carried in chunk order. Each chunk is recomputed on backward, so at
    most one chunk's [B, chunk, V] logits is live."""
    b, s, _ = h.shape
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(nc):
        sl = slice(j * c, (j + 1) * c)
        ce, n = checkpoint(_xent_chunk, head_fn, h[:, sl], labels[:, sl],
                           mask[:, sl], use_reentrant=False)
        tot, cnt = tot + ce, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
