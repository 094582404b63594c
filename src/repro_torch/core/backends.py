"""Traversal-backend layer: pluggable implementations of the per-step hot path.

Counterpart of `repro/core/backends.py`. A backend evaluates the filter
program and the neighbor distances and merges both sorted buffers; the
rest of the step is shared in `core.step`.

Registered backends:
  dense       plain PyTorch: shared program evaluation + `sqdist_bdrd`
              (compressed: `quant.codecs.quant_dist`) + two stable argsort
              merges (`repro`'s DenseBackend); with `cfg.use_pallas` its
              float32 distances go through kernel K6
              (`kernels.distance.sqdist_masked`).
  fused       kernel K1 (`kernels.fused_step`; K3 under int8, K4 under pq)
              through packed payloads (`repro`'s PallasBackend); also
              registered as "pallas" so reference configurations carry over.
  persistent  the fused per-step merge, with `persistent = True`: the
              engine runs it through `core.search.run_search_persistent`,
              whose launches are kernel K5 (`kernels.persistent_step`) in
              post mode and groups of fused steps in pre and widen mode;
              also registered as "pallas_persistent".

In pre mode the backends score only predicate-valid new nodes (the
distance mask is `valid`, K1 with `pre=True`); post and widen score every
new node. Pre and widen hand them the widened frontier [B, R'], R' = R +
R·⌈R / two_hop_stride⌉ (160 at R=32, stride 8).
"""
from __future__ import annotations

from typing import Protocol

import torch

from repro_torch.core.state import INF, SearchConfig
from repro_torch.filters.compile import clause_counts, eval_program_gathered
from repro_torch.kernels.distance import sqdist_bdrd, sqdist_masked
from repro_torch.kernels.fused_step import fused_step
from repro_torch.kernels.topk import merge_stable, pack_payload, unpack_payload
from repro_torch.quant.codecs import quant_dist


class TraversalBackend(Protocol):
    """Per-step hot path: filter program + distances + queue/result merges."""

    name: str

    def merge_step(self, cfg: SearchConfig, queries, xv, nb, is_new, prog,
                   labels_g, values_g, cand_dist, cand_idx, cand_exp,
                   cand_valid, res_dist, res_idx, quant=None):
        """queries [B,d], xv [B,R,d] (None in compressed mode), nb/is_new
        [B,R], prog FilterProgram, labels_g [B,R,W] i32, values_g [B,R,V]
        f32, cand_* [B,M], res_* [B,K], quant QuantGather or None →
        (cand_dist, cand_idx, cand_exp, cand_valid, res_dist, res_idx,
        valid [B,R], clause_add [B,4])."""
        ...


_BACKENDS: dict[str, TraversalBackend] = {}


def register_backend(*names: str):
    """Class decorator: instantiate and register a backend under `names`."""

    def deco(cls):
        inst = cls()
        inst.name = names[0]
        for name in names:
            _BACKENDS[name] = inst
        return cls

    return deco


def get_backend(name: str) -> TraversalBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown traversal backend {name!r}; "
            f"registered: {sorted(_BACKENDS)}") from None


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


@register_backend("dense")
class DenseBackend:
    """Plain PyTorch: program eval + distances + stable argsort merges."""

    def merge_step(self, cfg, queries, xv, nb, is_new, prog, labels_g,
                   values_g, cand_dist, cand_idx, cand_exp, cand_valid,
                   res_dist, res_idx, quant=None):
        m, k = cfg.queue_size, cfg.k
        pvalid, clause_sat = eval_program_gathered(prog, labels_g, values_g)
        valid = pvalid & is_new
        clause_add = clause_counts(clause_sat, is_new)
        dist_mask = valid if cfg.mode == "pre" else is_new
        if quant is not None:
            dd = torch.where(dist_mask, quant_dist(cfg.precision, quant), INF)
        elif cfg.use_pallas:
            dd = sqdist_masked(queries, xv, dist_mask)
        else:
            dd = torch.where(dist_mask, sqdist_bdrd(queries, xv), INF)
        fin = torch.isfinite(dd)

        cand_dist, (cand_idx, cand_exp, cand_valid) = merge_stable(
            cand_dist, (cand_idx, cand_exp, cand_valid), dd,
            (torch.where(fin, nb, -1), torch.zeros_like(fin), valid), m)

        res_in = torch.where(valid & fin, dd, INF)
        res_dist, (res_idx,) = merge_stable(
            res_dist, (res_idx,), res_in,
            (torch.where(torch.isfinite(res_in), nb, -1),), k)
        return (cand_dist, cand_idx, cand_exp, cand_valid, res_dist, res_idx,
                valid, clause_add)


@register_backend("fused", "pallas")
class FusedBackend:
    """Kernel K1: program + distances + both merges in one launch.

    The candidate queue rides as (dist, packed payload): node id plus the
    expanded/valid flags in one int32 (`kernels.topk.pack_payload`).
    """

    def merge_step(self, cfg, queries, xv, nb, is_new, prog, labels_g,
                   values_g, cand_dist, cand_idx, cand_exp, cand_valid,
                   res_dist, res_idx, quant=None):
        cand_pay = pack_payload(cand_idx, cand_exp, cand_valid)
        (cand_dist, cand_pay, res_dist, res_idx, valid,
         clause_add) = fused_step(
            queries, xv, nb, is_new, prog, labels_g, values_g, cand_dist,
            cand_pay, res_dist, res_idx, pre=cfg.mode == "pre", quant=quant,
            precision=cfg.precision or "float32")
        cand_idx, cand_exp, cand_valid = unpack_payload(cand_pay)
        return (cand_dist, cand_idx, cand_exp, cand_valid, res_dist, res_idx,
                valid, clause_add)


@register_backend("persistent", "pallas_persistent")
class PersistentBackend(FusedBackend):
    """Multi-step launches over the fused per-step merge (`repro`'s
    PallasPersistentBackend): the search layer keys on `persistent` to
    run up to `cfg.steps_per_launch` steps per launch of kernel K5, whose
    steps equal this per-step merge's bit for bit."""

    persistent = True
