"""Serving steps: prefill, single-token greedy decode, and the generation
loop that joins them.

Counterpart of `repro/train/serve_step.py`. The weights live in the
model, so the steps take no parameter tree."""
from __future__ import annotations

import time

import torch

from repro_torch.models.transformer import _pad_cache_seq


def greedy(logits):
    """The next token of each row: the first maximum of the last
    position's logits (as `jnp.argmax` picks), int32 [B]."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


def make_prefill(model):
    """prefill(tokens, enc=None): the model's prefill, over the memory
    `enc` where the model cross-attends."""
    def prefill(tokens, enc=None):
        return model.prefill(tokens, enc=enc)

    return prefill


def make_decode_step(model):
    """One greedy step: (logits, next token ids [B] int32, cache)."""
    def decode_step(cache, tokens, pos):
        logits, cache = model.decode_step(cache, tokens, pos)
        return logits, greedy(logits), cache

    return decode_step


def _sync(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.no_grad()
def generate(model, tokens, n: int, forced=None, enc=None) -> dict:
    """Prefill tokens [B, S] (over the memory `enc` [B, Se, d] of a model
    that cross-attends: the VLM's patch embeddings, the enc-dec's frames),
    then `n` KV-cache decode steps, each fed the previous step's greedy
    id (or `forced[:, t]`, teacher-forced). The cache holds S + n
    positions, so every step's position, a host int, lies inside it. Returns "logits" [B, n + 1, V] (the prefill's last
    position, then every step's), "ids" [B, n + 1] int32 (their greedy
    ids), "fed" [B, n] (the ids the steps were fed), and "prefill_ms" (the
    prefill and the cache's sizing) and "decode_ms" (the n steps) on the
    host clock, the card synchronised at both ends of each."""
    b, s = tokens.shape
    prefill, step = make_prefill(model), make_decode_step(model)
    t0 = _sync(tokens.device)
    logits, part = prefill(tokens, enc=enc)
    cache = _pad_cache_seq(model.init_cache(b, s + n), part)
    t1 = _sync(tokens.device)
    outs, ids, fed = [logits[:, -1]], [greedy(logits)], []
    for t in range(n):
        cur = ids[-1][:, None] if forced is None else forced[:, t:t + 1]
        fed.append(cur)
        logits, nxt, cache = step(cache, cur, s + t)
        outs.append(logits[:, -1])
        ids.append(nxt)
    t2 = _sync(tokens.device)
    return {"logits": torch.stack(outs, dim=1), "ids": torch.stack(ids, 1),
            "fed": (torch.cat(fed, dim=1) if fed
                    else tokens.new_zeros((b, 0))),
            "prefill_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3}
