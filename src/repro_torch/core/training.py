"""Ground-truth W_q generation for estimator training (paper §4.3).

Counterpart of `repro/core/training.py::generate_training_data`: for
each training query run the probe and snapshot the features, then
continue the same traversal with an effectively unlimited budget while
tracking `conv_cnt` — the NDC at which the result set first covers the
exact filtered top-k. That NDC is the regression target W_q; queries
that never converge take the NDC at search exhaustion.

On a quantized engine convergence is judged against the compressed-domain
filtered top-k (`quant.compressed_filtered_topk`): the traversal's result
distances are compressed, so they would never cover the exact float32
ground truth. The returned gt_idx/gt_dist stay the exact ones (what
recall after the rerank is measured against).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import BIG_BUDGET, SearchEngine
from repro_torch.core.state import SearchConfig
from repro_torch.data.synthetic import AttributedDataset, QueryWorkload
from repro_torch.index.bruteforce import (compressed_filtered_topk,
                                         filtered_knn_exact, valid_mask)


def oracle_vectors(engine, ds: AttributedDataset):
    """The float32 rows the exact oracle scores: the device tier's tensor,
    a plain engine's vectors, or else the dataset's rows (a host tier or
    a sharded engine)."""
    store = getattr(engine, "vector_store", None)
    if store is not None and store.kind == "device":
        return store.vectors
    if (not getattr(engine, "is_sharded", False)
            and engine.base_vectors.shape[1] > 0):
        return engine.base_vectors
    return ds.vectors


def oracle_quant(engine):
    """The codes the compressed oracle scores: a sharded engine's shards
    concatenated in row order (`quant_concat`), else the engine's."""
    return getattr(engine, "quant_concat", None) or engine.quant


@dataclasses.dataclass
class TrainingData:
    features: np.ndarray   # [n, F]
    w_q: np.ndarray        # [n]
    converged: np.ndarray  # [n] bool
    gt_idx: np.ndarray     # [n, k]
    gt_dist: np.ndarray    # [n, k]


def generate_training_data(
    engine: SearchEngine,
    ds: AttributedDataset,
    workload: QueryWorkload,
    cfg: SearchConfig,
    probe_budget: int = 64,
    chunk: int = 64,
    n_probes: int = 2,
) -> TrainingData:
    from repro_torch.core.e2e import probe_and_features

    precision = engine.effective_precision(cfg)
    n = workload.batch
    feats, wq, conv, gti, gtd = [], [], [], [], []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        q = workload.queries[s:e]
        filt = workload.filter_slice(s, e)
        gt_idx, gt_dist = filtered_knn_exact(
            q, oracle_vectors(engine, ds), filt,
            np.asarray(ds.labels_packed), np.asarray(ds.value_matrix), cfg.k,
            device=engine.device)
        if precision != "float32":
            # convergence in the metric the traversal searches in
            ok = valid_mask(filt, np.asarray(ds.labels_packed),
                            np.asarray(ds.value_matrix))
            conv_dist, _ = compressed_filtered_topk(
                precision, oracle_quant(engine), q, ok, cfg.k)
        else:
            conv_dist = gt_dist
        prog = engine.compile(filt)  # once for the probe + exhaustion resume
        st, z = probe_and_features(engine, cfg, q, prog, probe_budget,
                                   n_probes, gt_dist=conv_dist)
        z = z.cpu().numpy()
        st = engine.search(cfg, q, prog, BIG_BUDGET, state=st,
                           gt_dist=conv_dist)
        cc = st.conv_cnt.cpu().numpy()
        cnt = st.cnt.cpu().numpy()
        converged = cc > 0
        feats.append(z)
        wq.append(np.where(converged, cc, cnt).astype(np.int64))
        conv.append(converged)
        gti.append(gt_idx)
        gtd.append(gt_dist)
    return TrainingData(
        features=np.concatenate(feats),
        w_q=np.concatenate(wq),
        converged=np.concatenate(conv),
        gt_idx=np.concatenate(gti),
        gt_dist=np.concatenate(gtd),
    )
