"""Calibration telemetry: the served-traffic log the estimator retrains on.

Counterpart of `repro/obs/calibration.py` (host numpy; the port keeps its
own copy). The record schema and the saved files are the reference's, so
a window saved by either package loads in the other.

The paper trains the GBDT cost model offline, once. A production system
can't — workloads drift — and ROADMAP's online-recalibration item needs
exactly one thing from serving: a per-completed-query record of

    (probe feature vector z_q, predicted Ŵ_q, actual NDC spent, plan
     chosen, recall proxy when ground truth is available)

`CalibrationMonitor` collects those records in a bounded window, computes
rolling calibration health (log-space error, over-/under-prediction rates,
per-plan routing shares and win rates), and persists the window with the
same atomic npz + sha256-manifest discipline as the reference's
`train/checkpoint.py` — a
torn write can never be mistaken for a valid calibration log.

**The record schema is frozen** (`SCHEMA_VERSION`, `RECORD_FIELDS`): the
future recalibration PR trains directly from saved windows, so field names,
dtypes and semantics must not change without bumping the version. The
feature vector's width is workload-dependent (n_probes × N_FEATURES) and is
recorded per window in the manifest, not in the schema.
"""
from __future__ import annotations

import hashlib
import json
import os
from collections import deque

import numpy as np

SCHEMA_VERSION = 1

#: plan id encoding in records (index into this tuple); "traverse" is the
#: legacy/no-planner pipeline and therefore the default.
PLAN_NAMES = ("traverse", "scan", "widen")

#: frozen per-record scalar fields: (name, numpy dtype, meaning)
RECORD_FIELDS = (
    ("rid", "int64", "request id (-1 for one-shot pipelines)"),
    ("plan", "int32", "index into PLAN_NAMES"),
    ("predicted", "int64", "predicted total budget Ŵ_q (NDC)"),
    ("actual", "int64", "actual NDC spent (state.cnt at completion)"),
    ("probe_ndc", "int64", "NDC spent by the probe prefix"),
    ("n_slices", "int32", "resume batches the query rode in"),
    ("alpha", "float32", "recall knob the prediction was scaled by"),
    ("recall", "float32", "recall proxy vs ground truth; NaN if unknown"),
)

_EPS = 1e-12


def _plan_id(plan) -> int:
    if isinstance(plan, (int, np.integer)):
        return int(plan)
    try:
        return PLAN_NAMES.index(plan or "traverse")
    except ValueError:
        raise ValueError(f"unknown plan {plan!r} (one of {PLAN_NAMES})")


class CalibrationMonitor:
    """Bounded rolling window of per-query calibration records."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self._rows: deque[tuple] = deque(maxlen=capacity)
        self._feats: deque[np.ndarray] = deque(maxlen=capacity)
        self.n_recorded = 0          # lifetime count (window may evict)

    # ----------------------------------------------------------- record ----
    def record(self, *, predicted, actual, plan="traverse", rid: int = -1,
               probe_ndc: int = 0, n_slices: int = 0, alpha: float = 1.0,
               recall: float = float("nan"), features=None) -> None:
        """One completed query. `features` is the probe feature vector the
        prediction was made from (host array; None stores an empty row —
        the record still contributes to the rolling rates)."""
        self._rows.append((int(rid), _plan_id(plan), int(predicted),
                           int(actual), int(probe_ndc), int(n_slices),
                           float(alpha), float(recall)))
        self._feats.append(np.zeros(0, np.float32) if features is None
                           else np.asarray(features, np.float32).ravel())
        self.n_recorded += 1

    def set_recall(self, recalls: dict) -> None:
        """Backfill recall proxies (rid → recall) after ground truth is
        computed — serving rarely knows gt at completion time."""
        for i, row in enumerate(self._rows):
            if row[0] in recalls:
                self._rows[i] = row[:7] + (float(recalls[row[0]]),)

    def __len__(self) -> int:
        return len(self._rows)

    # ------------------------------------------------------------ views ----
    def arrays(self) -> dict:
        """The window as a dict of column arrays (RECORD_FIELDS order) plus
        `features` [n, F] (F = max row width; short rows zero-pad)."""
        n = len(self._rows)
        cols = {name: np.zeros(n, dtype) for name, dtype, _ in RECORD_FIELDS}
        for i, row in enumerate(self._rows):
            for (name, _, _), v in zip(RECORD_FIELDS, row):
                cols[name][i] = v
        width = max((f.size for f in self._feats), default=0)
        feats = np.zeros((n, width), np.float32)
        for i, f in enumerate(self._feats):
            feats[i, : f.size] = f
        cols["features"] = feats
        return cols

    # ----------------------------------------------------------- report ----
    def report(self) -> dict:
        """Rolling calibration health. All values finite for any window
        size (empty included) — this feeds the Prometheus exporter, which
        forbids NaN samples."""
        cols = self.arrays()
        n = len(self._rows)
        out = dict(schema_version=SCHEMA_VERSION, n_records=n,
                   n_recorded_total=self.n_recorded)
        if n == 0:
            out.update(log_rmse=0.0, mean_log_ratio=0.0,
                       overprediction_rate=0.0, underprediction_rate=0.0,
                       predicted=_quantiles(np.zeros(0)),
                       actual=_quantiles(np.zeros(0)),
                       ratio=_quantiles(np.zeros(0)),
                       recall_mean=0.0, n_with_recall=0, per_plan={})
            return out
        pred = np.maximum(cols["predicted"].astype(np.float64), 1.0)
        act = np.maximum(cols["actual"].astype(np.float64), 1.0)
        log_ratio = np.log(pred) - np.log(act)
        rec = cols["recall"]
        has_rec = np.isfinite(rec)
        out.update(
            log_rmse=float(np.sqrt(np.mean(log_ratio ** 2))),
            # >0: the estimator over-provisions on average (recall-safe,
            # cost-wasteful); <0: under-provisions (cheap, recall-risky)
            mean_log_ratio=float(np.mean(log_ratio)),
            overprediction_rate=float(np.mean(pred > act)),
            underprediction_rate=float(np.mean(pred < act)),
            # predicted-vs-actual scatter summary (the plot, as numbers)
            predicted=_quantiles(pred),
            actual=_quantiles(act),
            ratio=_quantiles(pred / np.maximum(act, _EPS)),
            recall_mean=(float(rec[has_rec].mean()) if has_rec.any() else 0.0),
            n_with_recall=int(has_rec.sum()),
        )
        per_plan = {}
        for pid, name in enumerate(PLAN_NAMES):
            m = cols["plan"] == pid
            if not m.any():
                continue
            # "win" = the plan delivered within its predicted budget — the
            # promise the router's argmin was based on
            per_plan[name] = dict(
                n=int(m.sum()),
                share=float(m.mean()),
                win_rate=float(np.mean(act[m] <= pred[m])),
                mean_log_ratio=float(np.mean(log_ratio[m])),
                mean_actual_ndc=float(act[m].mean()),
            )
        out["per_plan"] = per_plan
        return out

    # ---------------------------------------------------------- persist ----
    def save(self, directory: str, tag: str = "calibration") -> str:
        """Atomic write (tmp + rename) of the rolling window: arrays.npz +
        a JSON manifest with schema version, field docs and a sha256 — the
        checkpoint discipline, so the recalibration trainer can
        validate a window before fitting on it."""
        os.makedirs(directory, exist_ok=True)
        cols = self.arrays()
        tmp = os.path.join(directory, f".tmp_{tag}_{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        data_path = os.path.join(tmp, "arrays.npz")
        np.savez(data_path, **cols)
        digest = _sha256(data_path)
        manifest = dict(
            schema_version=SCHEMA_VERSION,
            sha256=digest,
            n_records=len(self._rows),
            n_recorded_total=self.n_recorded,
            feature_width=int(cols["features"].shape[1]),
            fields=[dict(name=n, dtype=d, doc=doc)
                    for n, d, doc in RECORD_FIELDS],
            plan_names=list(PLAN_NAMES),
        )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        final = os.path.join(directory, tag)
        if os.path.exists(final):
            import shutil

            shutil.rmtree(final)
        os.rename(tmp, final)
        return final

    @classmethod
    def load(cls, path: str, validate: bool = True,
             ) -> tuple["CalibrationMonitor", dict]:
        """Restore a saved window. Returns (monitor, manifest)."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["schema_version"] != SCHEMA_VERSION:
            raise ValueError(
                f"calibration log schema v{manifest['schema_version']} != "
                f"supported v{SCHEMA_VERSION}")
        data_path = os.path.join(path, "arrays.npz")
        if validate:
            digest = _sha256(data_path)
            if digest != manifest["sha256"]:
                raise IOError(f"calibration log {path} failed integrity check")
        with np.load(data_path) as npz:
            z = {name: npz[name] for name in npz.files}
        mon = cls(capacity=max(1, int(manifest["n_records"]) or 1))
        feats = z["features"]
        for i in range(int(manifest["n_records"])):
            mon.record(
                rid=z["rid"][i], plan=int(z["plan"][i]),
                predicted=z["predicted"][i], actual=z["actual"][i],
                probe_ndc=z["probe_ndc"][i], n_slices=z["n_slices"][i],
                alpha=z["alpha"][i], recall=z["recall"][i],
                features=feats[i] if feats.shape[1] else None)
        mon.n_recorded = int(manifest["n_recorded_total"])
        return mon, manifest


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _quantiles(v: np.ndarray, qs=(10, 50, 90)) -> dict:
    v = np.asarray(v, np.float64)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return {f"p{q}": 0.0 for q in qs}
    return {f"p{q}": float(np.percentile(v, q)) for q in qs}
