"""From-scratch histogram gradient-boosted decision trees (LightGBM stand-in).

Copy of `repro/core/gbdt.py` (numpy training and the numpy `predict`
oracle): quantile binning, depth-wise complete trees, variance-gain
splits, shrinkage, L2 leaf regularization, gain importances. The same
arrays train to the same model in both packages. Trees are heap-packed
so inference is `depth` rounds of (feature, threshold, compare, descend)
per tree — kernel K2 (`repro_torch.kernels.gbdt`) on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class GBDTModel:
    """Heap-packed complete-tree ensemble.

    feat[t, i]   feature index tested at internal node i of tree t
    thresh[t, i] go left iff x[feat] <= thresh (dead nodes: thresh=+inf)
    leaf[t, j]   leaf values (already scaled by learning rate)
    base         global prior (mean target)
    """

    feat: np.ndarray      # [T, 2^D - 1] int32
    thresh: np.ndarray    # [T, 2^D - 1] float32
    leaf: np.ndarray      # [T, 2^D] float32
    base: float
    depth: int
    importances: np.ndarray  # [F] gain-based

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Vectorized numpy inference (oracle for kernel K2 and its plain
        version)."""
        n = x.shape[0]
        out = np.full(n, self.base, dtype=np.float64)
        n_internal = self.feat.shape[1]
        for t in range(self.n_trees):
            idx = np.zeros(n, dtype=np.int64)
            for _ in range(self.depth):
                f = self.feat[t, idx]
                go_left = x[np.arange(n), f] <= self.thresh[t, idx]
                idx = 2 * idx + 1 + (~go_left)
            out += self.leaf[t, idx - n_internal]
        return out.astype(np.float32)

    def packed(self, device) -> tuple:
        """(feat, thresh, leaf) tensors on `device` and the f32 base — the
        arguments of `kernels.gbdt.gbdt_predict`."""
        return (
            torch.from_numpy(np.ascontiguousarray(self.feat, np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(self.thresh, np.float32)).to(device),
            torch.from_numpy(np.ascontiguousarray(self.leaf, np.float32)).to(device),
            float(np.float32(self.base)),
        )

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, feat=self.feat, thresh=self.thresh, leaf=self.leaf,
            base=self.base, depth=self.depth, importances=self.importances,
        )

    @staticmethod
    def load(path: str) -> "GBDTModel":
        z = np.load(path)
        return GBDTModel(
            feat=z["feat"], thresh=z["thresh"], leaf=z["leaf"],
            base=float(z["base"]), depth=int(z["depth"]),
            importances=z["importances"],
        )


def _quantile_bins(x: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature bin edges [F, n_bins-1] from quantiles (deduplicated)."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T.astype(np.float32)  # [F, n_bins-1]
    return edges


def train_gbdt(
    x: np.ndarray,
    y: np.ndarray,
    n_trees: int = 200,
    depth: int = 5,
    learning_rate: float = 0.1,
    n_bins: int = 64,
    min_child: int = 20,
    l2: float = 1.0,
    subsample: float = 1.0,
    seed: int = 0,
    early_stop_tol: float = 0.0,
    objective: str = "l2",   # "l2" | "quantile"
    tau: float = 0.5,        # pinball quantile (objective="quantile")
) -> GBDTModel:
    """GBDT on (x [n,F], y [n]).

    objective="l2": classic least-squares boosting (the paper's setup).
    objective="quantile": pinball-loss boosting — trees are grown on the
    pinball gradient and leaves are *renewed* to the τ-quantile of the
    in-leaf residuals (LightGBM's quantile trick). Used for the
    beyond-paper safety-margin budget estimator.
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float64)
    n, f = x.shape
    edges = _quantile_bins(x, n_bins)
    # binned features: bin id in [0, n_bins-1]
    xb = np.empty((n, f), dtype=np.int32)
    for j in range(f):
        xb[:, j] = np.searchsorted(edges[j], x[:, j], side="right")

    n_internal = 2**depth - 1
    n_leaves = 2**depth
    feat = np.zeros((n_trees, n_internal), dtype=np.int32)
    thresh = np.full((n_trees, n_internal), np.inf, dtype=np.float32)
    leaf = np.zeros((n_trees, n_leaves), dtype=np.float32)
    importances = np.zeros(f, dtype=np.float64)

    if objective == "quantile":
        base = float(np.quantile(y, tau)) if n else 0.0
    else:
        base = float(y.mean()) if n else 0.0
    pred = np.full(n, base, dtype=np.float64)

    for t in range(n_trees):
        if objective == "quantile":
            # pinball gradient direction: τ where y>pred else τ-1
            resid = np.where(y > pred, tau, tau - 1.0)
        else:
            resid = y - pred
        if subsample < 1.0:
            use = rng.random(n) < subsample
        else:
            use = np.ones(n, dtype=bool)
        # node id per sample within the complete tree (heap index)
        node = np.zeros(n, dtype=np.int64)
        node[~use] = -1

        for level in range(depth):
            lvl_start = 2**level - 1
            lvl_nodes = 2**level
            # histograms per (node-at-level, feature, bin)
            act = node >= 0
            rel = node[act] - lvl_start  # 0..lvl_nodes-1
            rr = resid[act]
            best_gain = np.full(lvl_nodes, 0.0)
            best_feat = np.zeros(lvl_nodes, dtype=np.int32)
            best_bin = np.full(lvl_nodes, -1, dtype=np.int64)

            tot_cnt = np.bincount(rel, minlength=lvl_nodes).astype(np.float64)
            tot_sum = np.bincount(rel, weights=rr, minlength=lvl_nodes)
            parent_score = tot_sum**2 / (tot_cnt + l2)

            for j in range(f):
                key = rel * n_bins + xb[act, j]
                hc = np.bincount(key, minlength=lvl_nodes * n_bins).reshape(lvl_nodes, n_bins)
                hs = np.bincount(key, weights=rr, minlength=lvl_nodes * n_bins).reshape(
                    lvl_nodes, n_bins
                )
                cl = hc.cumsum(axis=1)[:, :-1]  # left counts per split bin
                sl = hs.cumsum(axis=1)[:, :-1]
                cr = tot_cnt[:, None] - cl
                sr = tot_sum[:, None] - sl
                ok = (cl >= min_child) & (cr >= min_child)
                gain = np.where(
                    ok,
                    sl**2 / (cl + l2) + sr**2 / (cr + l2) - parent_score[:, None],
                    -np.inf,
                )
                gb = gain.argmax(axis=1)
                gv = gain[np.arange(lvl_nodes), gb]
                better = gv > best_gain
                best_gain = np.where(better, gv, best_gain)
                best_feat = np.where(better, j, best_feat)
                best_bin = np.where(better, gb, best_bin)

            # record splits; dead nodes keep thresh=+inf (all go left)
            for ni in range(lvl_nodes):
                gi = lvl_start + ni
                if best_bin[ni] >= 0 and best_gain[ni] > early_stop_tol:
                    feat[t, gi] = best_feat[ni]
                    thresh[t, gi] = edges[best_feat[ni], best_bin[ni]]
                    importances[best_feat[ni]] += best_gain[ni]
                # else: feat 0 / thresh inf — passthrough left

            # descend
            cur = node >= 0
            fsel = feat[t, np.maximum(node, 0)]
            tsel = thresh[t, np.maximum(node, 0)]
            go_left = x[np.arange(n), fsel] <= tsel
            node = np.where(cur, 2 * node + 1 + (~go_left), node)

        # leaf values
        leaf_id = node - n_internal
        act = node >= 0
        if objective == "quantile":
            # renew leaves to the τ-quantile of raw residuals in-leaf
            raw = y - pred
            lv = np.zeros(n_leaves)
            for li in np.unique(leaf_id[act]):
                vals = raw[act & (leaf_id == li)]
                if vals.size:
                    lv[li] = np.quantile(vals, tau)
        else:
            lc = np.bincount(leaf_id[act], minlength=n_leaves).astype(np.float64)
            ls = np.bincount(leaf_id[act], weights=resid[act], minlength=n_leaves)
            lv = ls / (lc + l2)
        leaf[t] = (learning_rate * lv).astype(np.float32)

        # update predictions for ALL samples (not just subsampled)
        idx = np.zeros(n, dtype=np.int64)
        for _ in range(depth):
            ff = feat[t, idx]
            go_left = x[np.arange(n), ff] <= thresh[t, idx]
            idx = 2 * idx + 1 + (~go_left)
        pred += leaf[t, idx - n_internal]

    return GBDTModel(
        feat=feat, thresh=thresh, leaf=leaf, base=base, depth=depth,
        importances=importances,
    )
