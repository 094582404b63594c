"""Feed-forward layers: the gated SiLU MLP, the GELU MLP and the
sort-based dropping MoE.

Counterpart of `repro/models/ffn.py`. The MoE is the reference's sorted
("dropping") dispatch: each token's top-k experts by router probability
(the lower expert id first on equal probabilities, as `jax.lax.top_k`),
gates renormalised by max(sum, 1e-9); the assignments sorted by expert id
(a stable sort, so within an expert in (token, slot) order) and ranked
within their expert; an assignment ranked at or past the capacity C is
dropped (GShard). `moe_forward` dispatches per batch row (C =
int(cf·k·S/E) + 1 rounded up to a multiple of 8) or, under
`REPRO_MOE_GLOBAL`, over all B·S tokens at once (rounded up to 16): the
switch changes which tokens drop, as in the reference. Its
`REPRO_MOE_SHMAP`, `REPRO_MOE_ZERO3` and `REPRO_MOE_CONSTRAIN_OUT` only
place shardings on a mesh and come with it (ROADMAP.md Queue 1, items 3
and 5h).

Both dispatches run one routing helper, `route`, and gathers only:
slot c of expert e in the [R, E, C, d] buffer reads the token of the c-th
assignment of e (zero where e has fewer than c + 1), so a dropped
assignment is never written — the buffer is the one the reference's
scatter with `mode="drop"` makes —; each assignment then reads its slot
back, times its gate (0 where dropped), and a token's k results are
summed in slot order (`_combine`). For k ≤ 2 that sum, a + b into zero,
is the reference's scatter-add bit for bit (addition commutes); for
larger k (deepseek-v3's top-8) the reference's scatter-add sums in an
order XLA picks, so the two agree within a rounding of the k terms, the
tolerance `tests/test_torch_mla.py` states. The backward of the dispatch
(`_Dispatch`) is the same gather-and-sum: a token's gradient is the sum
of its kept slots' gradients in slot order, with no scatter and so no
atomics on the card. Every step of the forward and the backward sums a
fixed set of terms in a fixed order, so the layer is deterministic on
the card at any k. The expert products are `torch.einsum` over the
expert axis, as the reference's `jnp.einsum` outside any Pallas kernel.
"""
from __future__ import annotations

import os
from typing import NamedTuple

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


# ------------------------------------------------------------------- MoE ----
def init_moe(cfg, generator: torch.Generator, device) -> nn.ParameterDict:
    """router [d, E], w_in / w_gate [E, d, f], w_out [E, f, d] (normal ·
    1/√fan_in, fan-in d, f for w_out) and, with `n_shared_experts`, a
    gated MLP of width moe_d_ff · n_shared as "shared"."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = cfg.param_dtype
    prm = {"router": dense_init((d, e), d, dt, generator, device),
           "w_in": dense_init((e, d, f), d, dt, generator, device),
           "w_gate": dense_init((e, d, f), d, dt, generator, device),
           "w_out": dense_init((e, f, d), f, dt, generator, device)}
    if cfg.n_shared_experts:
        prm["shared"] = init_mlp(cfg, generator, device,
                                 d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return nn.ParameterDict(prm)


def capacity(cfg, tokens: int, multiple: int) -> int:
    """Slots an expert: int(cf·k·tokens/E) + 1 rounded up to `multiple`
    (the reference's Python float arithmetic)."""
    cap = int(cfg.capacity_factor * cfg.top_k * tokens / cfg.n_experts) + 1
    return -(-cap // multiple) * multiple


class Routing(NamedTuple):
    """The routing of R dispatch rows of S tokens each. Assignment j of a
    row is token j // k's (j % k)-th expert."""
    probs: torch.Tensor    # [R, S, E] float32 router softmax
    expert: torch.Tensor   # [R, S·k] int64, descending probability
    gate: torch.Tensor     # [R, S·k] renormalised gate
    order: torch.Tensor    # [R, S·k] assignments stably sorted by expert
    starts: torch.Tensor   # [R, E] first sorted position of each expert
    counts: torch.Tensor   # [R, E] assignments of each expert, dropped too
    rank: torch.Tensor     # [R, S·k] place among its expert's assignments
    keep: torch.Tensor     # [R, S·k] bool: rank < cap
    cap: int

    @property
    def drops(self) -> torch.Tensor:
        """[R] int64: dropped assignments a row."""
        return (~self.keep).sum(dim=1)


def route(cfg, p, x, cap: int) -> Routing:
    """Routing of x [R, S, d] with `cap` slots an expert in each row."""
    rows, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = (x @ p["router"].to(cfg.compute_dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    top = top[..., :k]
    gate = torch.gather(probs, -1, top)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    expert = top.reshape(rows, s * k)
    order = torch.argsort(expert, dim=1, stable=True)
    ids = torch.arange(e, device=x.device).expand(rows, e).contiguous()
    sorted_e = torch.gather(expert, 1, order)
    starts = torch.searchsorted(sorted_e, ids)
    counts = torch.searchsorted(sorted_e, ids, right=True) - starts
    at = torch.arange(s * k, device=x.device).expand(rows, s * k)
    pos = torch.empty_like(order).scatter_(1, order, at)   # sorted position
    rank = pos - torch.gather(starts, 1, expert)
    return Routing(probs, expert, gate.reshape(rows, s * k), order, starts,
                   counts, rank, rank < cap, cap)


def _dispatch(x, r: Routing, k: int):
    """[R, E, C, d]: slot c of expert e holds the token of e's c-th
    assignment in sorted order, zero where e has no such assignment."""
    return _Dispatch.apply(x, r, k)


def _slots(yb, expert, rank):
    """[R, S·k, d]: each assignment's slot of yb [R, E, C, d], by its
    expert and rank (a dropped one reads its expert's last slot; the
    callers mask it)."""
    rows, e, cap, d = yb.shape
    slot = expert * cap + rank.clamp(max=cap - 1)
    return torch.gather(yb.reshape(rows, e * cap, d), 1,
                        slot[..., None].expand(-1, -1, d))


class _Dispatch(torch.autograd.Function):
    """`_dispatch` with a deterministic backward. Autograd's backward of
    the forward's gather scatter-adds the buffer's gradient into x, which
    on the card is atomics adding up to k nonzero terms to an element in
    a varying order; here a token's gradient is the sum of its kept
    slots' gradients gathered through the (expert · C + rank) map and
    added in slot order, the same gather-and-sum as `_combine`."""

    @staticmethod
    def forward(ctx, x, r: Routing, k: int):
        rows, _, d = x.shape
        e, cap = r.starts.shape[1], r.cap
        slot = torch.arange(cap, device=x.device)
        filled = (slot < r.counts[..., None]).reshape(rows, e * cap, 1)
        pos = (r.starts[..., None] + slot).clamp(max=r.order.shape[1] - 1)
        tok = torch.gather(r.order, 1, pos.reshape(rows, e * cap)) // k
        xt = torch.gather(x, 1, tok[..., None].expand(-1, -1, d))
        ctx.save_for_backward(r.expert, r.rank, r.keep)
        ctx.k = k
        return torch.where(filled, xt, 0.0).reshape(rows, e, cap, d)

    @staticmethod
    def backward(ctx, grad):
        expert, rank, keep = ctx.saved_tensors
        k = ctx.k
        rows, _, _, d = grad.shape
        g = torch.where(keep[..., None], _slots(grad, expert, rank), 0.0)
        g = g.reshape(rows, -1, k, d)
        dx = g[:, :, 0]
        for j in range(1, k):
            dx = dx + g[:, :, j]
        return dx, None, None


def _combine(yb, r: Routing, k: int):
    """[R, S, d]: each token's k expert outputs times their gates (0 where
    dropped), summed in slot order."""
    rows, _, _, d = yb.shape
    y = _slots(yb, r.expert, r.rank) * torch.where(
        r.keep, r.gate, 0.0)[..., None].to(yb.dtype)
    return y.reshape(rows, -1, k, d).sum(dim=2)


def _moe(cfg, p, x, cap: int, return_aux: bool, drops: list | None):
    """The MoE over dispatch rows x [R, S, d]; appends the routing's
    per-row drops to `drops` when given."""
    k, cd = cfg.top_k, cfg.compute_dtype
    r = route(cfg, p, x, cap)
    if drops is not None:
        drops.append(r.drops)
    buf = _dispatch(x.to(cd), r, k)
    h = torch.einsum("recd,edf->recf", buf, p["w_in"].to(cd))
    g = torch.einsum("recd,edf->recf", buf, p["w_gate"].to(cd))
    yb = torch.einsum("recf,efd->recd", silu(g) * h, p["w_out"].to(cd))
    out = _combine(yb, r, k)
    if "shared" in p:
        rows, s, d = x.shape
        out = out + mlp_forward(cfg, p["shared"], x.reshape(rows * s, d)
                                ).reshape(rows, s, d)
    if not return_aux:
        return out
    # GShard load-balance loss: E · Σ_e mean(probs)_e · count_e / (T·k),
    # the counts (dropped assignments too) carrying no gradient
    me = r.probs.mean(dim=(0, 1))
    ce = r.counts.sum(0).to(torch.float32) / (x.shape[0] * x.shape[1] * k)
    return out, cfg.n_experts * torch.sum(me * ce)


def _moe_forward_rowwise(cfg, p, x, return_aux=False, drops=None):
    """x [B, S, d] -> [B, S, d] (+ aux): each batch row sorts its own S·k
    assignments into a [B, E, C_row, d] buffer."""
    return _moe(cfg, p, x, capacity(cfg, x.shape[1], 8), return_aux, drops)


def moe_forward_global(cfg, p, x, return_aux=False, drops=None):
    """x [B, S, d] -> [B, S, d] (+ aux): one sort over all B·S tokens into
    an [E, C, d] buffer (one dispatch row)."""
    b, s, d = x.shape
    res = _moe(cfg, p, x.reshape(1, b * s, d), capacity(cfg, b * s, 16),
               return_aux, drops)
    if return_aux:
        return res[0].reshape(b, s, d), res[1]
    return res.reshape(b, s, d)


def moe_forward(cfg, p, x, return_aux=False, drops=None):
    """The sort-based dropping MoE of x [B, S, d]: per row, or over all
    tokens under `REPRO_MOE_GLOBAL`. Returns out [B, S, d], and the
    load-balance aux loss with `return_aux`. `drops`, a list, receives the
    routing's dropped assignments a dispatch row ([B], or [1] under the
    global dispatch)."""
    if os.environ.get("REPRO_MOE_GLOBAL"):
        return moe_forward_global(cfg, p, x, return_aux, drops)
    return _moe_forward_rowwise(cfg, p, x, return_aux, drops)
