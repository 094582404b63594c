"""Cost estimator M: features z_q -> predicted search budget Ŵ_q.

Counterpart of `repro/core/estimator.py`: regress log(W_q) with MSE, then
at query time Ŵ_q = α · exp(M(z_q)). The device path runs the forest
through kernel K2 (`kernels.gbdt.gbdt_predict`), the function `repro`
computes with `predict_jax` at this stage. The forest is uploaded once per
device and stays there, as the reference's TPU kernel keeps it resident
in VMEM. `eval_metrics` and `spearman` give Table 3's accuracy metrics on
the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gbdt import GBDTModel, train_gbdt
from repro_torch.kernels.gbdt import gbdt_predict


@dataclasses.dataclass
class CostEstimator:
    model: GBDTModel
    log_target: bool = True
    # the forest on each device it has run on (`packed`), and the highest
    # feature id it tests: neither is part of the estimator's value
    _forest: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)
    _feat_max: int = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self._feat_max = int(self.model.feat.max(initial=0))

    @classmethod
    def fit(cls, features: np.ndarray, w_q: np.ndarray,
            log_target: bool = True, **gbdt_kwargs) -> "CostEstimator":
        y = (np.log(np.maximum(w_q, 1.0)) if log_target
             else np.asarray(w_q, np.float64))
        return cls(model=train_gbdt(features, y, **gbdt_kwargs),
                   log_target=log_target)

    # ---- host-side ----
    def predict_cost(self, features: np.ndarray) -> np.ndarray:
        p = self.model.predict(np.asarray(features, np.float32))
        return np.exp(p) if self.log_target else p

    # ---- device-side ----
    def packed(self, device) -> tuple:
        """The forest on `device`, uploaded on the first call for that
        device; later calls return the same tensors."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._forest:
            self._forest[device] = self.model.packed(device)
        return self._forest[device]

    def predict_budget(self, features: torch.Tensor, alpha: float,
                       min_budget: int, max_budget: int,
                       packed=None) -> torch.Tensor:
        """features [B, F] f32 → budgets [B] i32:
        int32(clip(α·exp(M(z)), min, max)), truncating like the reference."""
        if self._feat_max >= features.shape[1]:
            raise ValueError(
                f"model tests feature {self._feat_max} but features have "
                f"{features.shape[1]} columns")
        feat, thresh, leaf, base = (self.packed(features.device)
                                    if packed is None else packed)
        p = gbdt_predict(features.contiguous(), feat, thresh, leaf, base,
                         self.model.depth)
        w = torch.exp(p) if self.log_target else p
        w = torch.clamp(alpha * w, float(min_budget), float(max_budget))
        return w.to(torch.int32)

    def eval_metrics(self, features: np.ndarray, w_q: np.ndarray) -> dict:
        """Table-3 metrics: Log-RMSE, R² (log space), Spearman ρ — host
        arithmetic, the reference's expressions."""
        y = np.log(np.maximum(w_q, 1.0))
        p = self.model.predict(np.asarray(features, np.float32))
        if not self.log_target:
            p = np.log(np.maximum(p, 1.0))
        err = p - y
        ss_res = float(np.sum(err ** 2))
        ss_tot = float(np.sum((y - y.mean()) ** 2)) + 1e-12
        return dict(log_rmse=float(np.sqrt(np.mean(err ** 2))),
                    r2=1.0 - ss_res / ss_tot, spearman=spearman(p, y))


def _average_ranks(v: np.ndarray) -> np.ndarray:
    """0-based ranks of v; a run of equal values shares their mean rank."""
    order = np.argsort(v, kind="stable")
    r = np.empty(len(v), np.float64)
    r[order] = np.arange(len(v))
    sv = v[order]
    i = 0
    while i < len(sv):
        j = i
        while j + 1 < len(sv) and sv[j + 1] == sv[i]:
            j += 1
        if j > i:
            r[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return r


def spearman(a, b) -> float:
    """Spearman rank correlation (average ranks for ties)."""
    ra = _average_ranks(np.asarray(a))
    rb = _average_ranks(np.asarray(b))
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum()) + 1e-12
    return float((ra * rb).sum() / denom)
