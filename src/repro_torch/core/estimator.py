"""Cost estimator M: features z_q -> predicted search budget Ŵ_q.

Counterpart of `repro/core/estimator.py`: regress log(W_q) with MSE, then
at query time Ŵ_q = α · exp(M(z_q)). The device path runs the forest
through kernel K2 (`kernels.gbdt.gbdt_predict`), the function `repro`
computes with `predict_jax` at this stage.
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
        """The forest on `device`, for repeated `predict_budget` calls."""
        return self.model.packed(device)

    def predict_budget(self, features: torch.Tensor, alpha: float,
                       min_budget: int, max_budget: int,
                       packed=None) -> torch.Tensor:
        """features [B, F] f32 → budgets [B] i32:
        int32(clip(α·exp(M(z)), min, max)), truncating like the reference."""
        if int(self.model.feat.max(initial=0)) >= features.shape[1]:
            raise ValueError(
                f"model tests feature {int(self.model.feat.max())} but "
                f"features have {features.shape[1]} columns")
        feat, thresh, leaf, base = (self.packed(features.device)
                                    if packed is None else packed)
        p = gbdt_predict(features.contiguous(), feat, thresh, leaf, base,
                         self.model.depth)
        w = torch.exp(p) if self.log_target else p
        w = torch.clamp(alpha * w, float(min_budget), float(max_budget))
        return w.to(torch.int32)
