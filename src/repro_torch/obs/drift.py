"""Estimator drift monitoring over the frozen calibration log.

Counterpart of `repro/obs/drift.py` (host numpy; the port keeps its own
copy, with the same detectors, thresholds and report).

The paper trains the cost estimator once offline; the in-depth filtered-
ANNS literature shows search difficulty moves with filter selectivity and
attribute correlation, so a served workload walks away from the training
distribution over time. `obs.calibration.CalibrationMonitor`
records (features, Ŵ_q, actual NDC, plan, recall proxy) per completed
query under a frozen schema — this module watches that log and raises the
trigger signal the future online-recalibration trainer will consume.

Three detectors, each judged against a frozen *reference window* (the
early, presumed-in-distribution stretch of the log):

1. **PSI over probe features** — Population Stability Index per feature
   column, binned at reference quantiles:

       psi = Σ_bins (p_cur − p_ref) · ln(p_cur / p_ref)

   Rule of thumb: <0.1 stationary, 0.1–0.25 drifting, >0.25 shifted. The
   default alarm threshold is 0.5 because small windows carry sampling
   noise of order bins·(1/n_ref + 1/n_cur); at the serve-loop window
   sizes here that noise can reach ~0.2 on a genuinely stationary stream.

2. **log-RMSE trend** — RMSE of ln(Ŵ_q) − ln(actual NDC), the error
   quantity `CalibrationMonitor.report()` already summarizes. Alarms when
   the current window degrades multiplicatively AND additively past the
   reference (ratio + margin, so a near-zero reference can't make noise
   alarm-worthy).

3. **Per-plan win-rate shift** — win rate = P(actual ≤ predicted) per
   planner arm. A selectivity shift changes which plans win before it
   moves aggregate RMSE; alarms on |shift| past a threshold when both
   windows have enough of that plan to compare. A plan present in the
   reference but absent from the current window (or vice versa) at
   comparable volume is itself a plan-mix shift and is counted.

The monitor is windowed by `CalibrationMonitor.n_recorded` (a lifetime
counter, immune to the ring buffer's wraparound) — `observe()` freezes
the reference once enough rows exist, then reports on the rows recorded
since. All report values are finite floats/ints so they export through
the strict Prometheus validator unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_EPS = 1e-4


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Thresholds for the three detectors. Defaults are deliberately
    conservative (see module docstring on PSI sampling noise)."""

    min_ref: int = 64            # rows before the reference freezes
    min_cur: int = 32            # rows before the current window is judged
    window: int = 4096           # max rows in the current window
    psi_bins: int = 8            # quantile bins per feature
    psi_threshold: float = 0.5   # alarm when max-feature PSI exceeds this
    rmse_ratio: float = 1.5      # alarm when cur > ref·ratio + margin
    rmse_margin: float = 0.1
    win_rate_shift: float = 0.25  # alarm on per-plan |Δ win rate| ≥ this
    min_plan_n: int = 24         # plan rows needed in both windows to judge


def psi(reference, current, *, bins: int = 8) -> float:
    """Population Stability Index of `current` against `reference`.

    Bin edges are interior reference quantiles (so the reference spreads
    ~uniformly across bins); both histograms are normalized and clipped
    away from zero before the log-ratio. Returns 0.0 when either side is
    empty or the reference is single-valued (no bins to compare).
    """
    ref = np.asarray(reference, np.float64).ravel()
    cur = np.asarray(current, np.float64).ravel()
    if ref.size == 0 or cur.size == 0:
        return 0.0
    qs = np.quantile(ref, np.linspace(0.0, 1.0, bins + 1)[1:-1])
    edges = np.unique(qs)
    if edges.size == 0:
        return 0.0
    # side='right' puts values equal to an edge in the lower bin, so a
    # point mass at a quantile lands deterministically
    r = np.bincount(np.searchsorted(edges, ref, side="right"),
                    minlength=edges.size + 1).astype(np.float64)
    c = np.bincount(np.searchsorted(edges, cur, side="right"),
                    minlength=edges.size + 1).astype(np.float64)
    r = np.clip(r / r.sum(), _EPS, None)
    c = np.clip(c / c.sum(), _EPS, None)
    r /= r.sum()
    c /= c.sum()
    return float(np.sum((c - r) * np.log(c / r)))


def _log_rmse(predicted, actual) -> float:
    p = np.log(np.maximum(np.asarray(predicted, np.float64), 1.0))
    a = np.log(np.maximum(np.asarray(actual, np.float64), 1.0))
    if p.size == 0:
        return 0.0
    return float(np.sqrt(np.mean((p - a) ** 2)))


def _win_rates(plan, predicted, actual, n_plans: int):
    """(win_rate [P], n [P]) per plan id; win rate 0.0 where a plan has
    no rows (n carries the support)."""
    plan = np.asarray(plan, np.int64)
    win = (np.asarray(actual, np.int64)
           <= np.asarray(predicted, np.int64)).astype(np.float64)
    rates = np.zeros(n_plans, np.float64)
    ns = np.zeros(n_plans, np.int64)
    for p in range(n_plans):
        m = plan == p
        ns[p] = int(m.sum())
        if ns[p]:
            rates[p] = float(win[m].mean())
    return rates, ns


class DriftMonitor:
    """Rolling-window drift detection over a `CalibrationMonitor`.

    Typical serving use is one call per scrape/health poll:

        monitor = DriftMonitor(DriftConfig())
        ...
        rep = monitor.observe(calibration)   # freezes ref when ready

    `set_reference` can pin the reference explicitly (e.g. right after
    warmup); `advance` moves the current-window start forward — the hook
    the recalibration trainer will call after consuming a window.
    """

    def __init__(self, config: DriftConfig | None = None):
        self.config = config or DriftConfig()
        self._ref = None       # frozen reference stats (dict) or None
        self._marker = 0       # n_recorded at the reference freeze/advance

    @property
    def ready(self) -> bool:
        return self._ref is not None

    def set_reference(self, calibration) -> bool:
        """Freeze the reference from `calibration`'s current contents.
        Returns False (and stays unfrozen) below `min_ref` rows."""
        cols = calibration.arrays()
        n = int(cols["rid"].shape[0])
        if n < self.config.min_ref:
            return False
        from repro_torch.obs.calibration import PLAN_NAMES
        feats = np.asarray(cols["features"], np.float64)
        rates, ns = _win_rates(cols["plan"], cols["predicted"],
                               cols["actual"], len(PLAN_NAMES))
        self._ref = {
            "n": n,
            "features": feats,
            "log_rmse": _log_rmse(cols["predicted"], cols["actual"]),
            "win_rates": rates,
            "plan_n": ns,
        }
        self._marker = int(calibration.n_recorded)
        return True

    def advance(self, calibration) -> None:
        """Start a fresh current window at the present log position
        (reference stays frozen)."""
        self._marker = int(calibration.n_recorded)

    def _current_rows(self, calibration):
        """Row window recorded since the marker, as column dict, or None
        when below min_cur. Bounded by `window` and by what the ring
        buffer still holds."""
        cols = calibration.arrays()
        avail = int(cols["rid"].shape[0])
        since = int(calibration.n_recorded) - self._marker
        take = min(since, avail, self.config.window)
        if take < self.config.min_cur:
            return None
        return {k: v[avail - take:] for k, v in cols.items()}

    def observe(self, calibration) -> dict:
        """Freeze the reference if not yet ready, then `report()`."""
        if self._ref is None:
            self.set_reference(calibration)
        return self.report(calibration)

    def report(self, calibration) -> dict:
        """Finite-valued drift report. Shape is stable across states:

        {ready, alarm, alarms: {psi, log_rmse, win_rate}, n_ref, n_cur,
         psi_max, psi_mean, psi_by_feature: [...], log_rmse_ref,
         log_rmse_cur, win_rate_shift_max, plans: {name: {...}}}
        """
        cfg = self.config
        out = {
            "ready": self.ready, "alarm": False,
            "alarms": {"psi": False, "log_rmse": False, "win_rate": False},
            "n_ref": 0 if self._ref is None else int(self._ref["n"]),
            "n_cur": 0,
            "psi_max": 0.0, "psi_mean": 0.0, "psi_by_feature": [],
            "log_rmse_ref": (0.0 if self._ref is None
                             else float(self._ref["log_rmse"])),
            "log_rmse_cur": 0.0,
            "win_rate_shift_max": 0.0,
            "plans": {},
        }
        if self._ref is None:
            return out
        cur = self._current_rows(calibration)
        if cur is None:
            return out
        out["n_cur"] = int(cur["rid"].shape[0])

        ref_f = self._ref["features"]
        cur_f = np.asarray(cur["features"], np.float64)
        n_feat = min(ref_f.shape[1], cur_f.shape[1])
        by_feat = [psi(ref_f[:, j], cur_f[:, j], bins=cfg.psi_bins)
                   for j in range(n_feat)]
        out["psi_by_feature"] = [float(v) for v in by_feat]
        if by_feat:
            out["psi_max"] = float(max(by_feat))
            out["psi_mean"] = float(np.mean(by_feat))
        out["alarms"]["psi"] = out["psi_max"] > cfg.psi_threshold

        out["log_rmse_cur"] = _log_rmse(cur["predicted"], cur["actual"])
        out["alarms"]["log_rmse"] = (
            out["log_rmse_cur"]
            > out["log_rmse_ref"] * cfg.rmse_ratio + cfg.rmse_margin)

        from repro_torch.obs.calibration import PLAN_NAMES
        rates, ns = _win_rates(cur["plan"], cur["predicted"],
                               cur["actual"], len(PLAN_NAMES))
        ref_rates, ref_ns = self._ref["win_rates"], self._ref["plan_n"]
        shift_max = 0.0
        for p, name in enumerate(PLAN_NAMES):
            shift = 0.0
            judged = ref_ns[p] >= cfg.min_plan_n and ns[p] >= cfg.min_plan_n
            if judged:
                shift = abs(float(rates[p]) - float(ref_rates[p]))
                shift_max = max(shift_max, shift)
            out["plans"][name] = {
                "n_ref": int(ref_ns[p]), "n_cur": int(ns[p]),
                "win_rate_ref": float(ref_rates[p]),
                "win_rate_cur": float(rates[p]),
                "shift": float(shift), "judged": bool(judged),
            }
        out["win_rate_shift_max"] = float(shift_max)
        out["alarms"]["win_rate"] = shift_max >= cfg.win_rate_shift

        out["alarm"] = any(out["alarms"].values())
        return out
