"""The kernel dispatch module: one name per kernel, the reference's names.

Counterpart of `repro/kernels/ops.py`. Each function hands a CUDA tensor
to its hand-written kernel (which launches or raises) and a CPU tensor to
the kernel's plain PyTorch version; the wrappers in this package make that
choice, so these are thin aliases with the reference's signatures.

  batched_sqdist        K6, masked squared L2 over a gathered block
  masked_scan_dist      K6's row-id variant, the pre-filter scan's distance
  masked_scan_dist_quant  K6q rows, the compressed scan's and the
                        compressed oracle's distance
  queue_merge           K7, sorted [B, M] buffer + raw [B, R] entries
  fused_traversal_step  K1 (K3 / K4 under a codec), one traversal step
  estimator_predict     K2, GBDT inference
"""
from __future__ import annotations

import torch

from repro_torch.kernels.distance import sqdist_masked, sqdist_rows
from repro_torch.kernels.fused_step import fused_step
from repro_torch.kernels.gbdt import gbdt_predict
from repro_torch.kernels.quant_rows import sqdist_rows_quant
from repro_torch.kernels.topk import topm_merge


def batched_sqdist(q: torch.Tensor, x: torch.Tensor, mask=None):
    """q [B, d], x [B, R, d] -> [B, R] squared L2 (+inf where ~mask)."""
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    return sqdist_masked(q, x, mask)


def masked_scan_dist(q: torch.Tensor, base: torch.Tensor, ids: torch.Tensor,
                     mask: torch.Tensor):
    """Pre-filter scan distance block: q [B, d], the row store base [N, d],
    row ids [B, V] of the gathered valid rows (V a multiple of
    `distance.SCAN_ALIGN`), mask [B, V] -> [B, V] f32, +inf on masked pad
    entries.

    The reference takes the gathered block x [B, V, d]; the port takes the
    ids, because at N=1M that block would not fit the card. Every
    (query, row) pair gives the same bits in any batch shape, on the card
    (K6's row-id variant) and on the CPU (the per-lane plain path).
    """
    return sqdist_rows(q, base, ids, mask)


def masked_scan_dist_quant(prep, quant, ids: torch.Tensor,
                           mask: torch.Tensor):
    """Compressed counterpart of `masked_scan_dist`: the prepared queries
    (`Int8Prep` | `PQPrep`, [B] lanes), the quant index (`Int8Index` |
    `PQIndex`: its codes and norms are read), row ids [B, V] and mask
    [B, V] -> [B, V] f32 ADC distances, +inf on masked entries. The one
    distance source of the quantized scan and of the compressed oracle
    (`index.bruteforce.compressed_filtered_topk`), so the two agree bit for bit
    (K6q rows on the card, its plain version on the CPU)."""
    return sqdist_rows_quant(prep, quant.codes, quant.norms, ids, mask)


def queue_merge(dist, payload, new_dist, new_payload):
    """Merge a **sorted-ascending** [B, M] buffer with raw [B, R] entries
    into the best M, ties in stable order over `[old | new]` (K7). K7
    merges by rank and relies on the buffer being sorted."""
    return topm_merge(dist, payload, new_dist, new_payload)


def fused_traversal_step(q, x, nb, is_new, prog, labels_g, values_g,
                         cand_dist, cand_pay, res_dist, res_idx, *,
                         pre: bool = False, quant=None,
                         precision: str = "float32"):
    """Fused filter program + distance + queue/result merge (one step);
    see `kernels.fused_step.fused_step`."""
    return fused_step(q, x, nb, is_new, prog, labels_g, values_g, cand_dist,
                      cand_pay, res_dist, res_idx, pre=pre, quant=quant,
                      precision=precision)


def estimator_predict(feats, packed_model, depth: int):
    """GBDT inference (K2) on a packed forest (feat, thresh, leaf, base)."""
    feat_idx, thresh, leaf, base = packed_model
    return gbdt_predict(feats, feat_idx, thresh, leaf, base, depth)
