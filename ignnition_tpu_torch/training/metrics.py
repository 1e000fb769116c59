"""Streaming evaluation metrics.

Matches the reference eval metric set (generate_model.py:770-788):
label/mean, prediction/mean, mae, mre (normalizer=|labels|), and a streaming
r-squared. The reference's r_squared is a running MEAN of per-batch R² values
(generate_model.py:201-216), which is undefined for batches whose labels have
zero within-batch variance (e.g. one graph-level label per batch) and biased
whenever batch label means differ; here R² pools sufficient statistics
(Σl, Σl², Σ(l-p)²) over the whole eval stream instead. All metrics are masked
so padded rows don't contribute.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


@dataclass
class MetricAccumulator:
    label_sum: float = 0.0
    pred_sum: float = 0.0
    abs_err_sum: float = 0.0
    rel_err_sum: float = 0.0
    count: float = 0.0
    label_sq_sum: float = 0.0
    unexplained_sum: float = 0.0

    def update(self, labels: np.ndarray, preds: np.ndarray, mask: np.ndarray):
        labels = np.asarray(labels, np.float64)
        preds = np.asarray(preds, np.float64)
        m = np.asarray(mask, bool)
        l, p = labels[m], preds[m]
        if l.size == 0:
            return
        self.label_sum += float(l.sum())
        self.pred_sum += float(p.sum())
        self.abs_err_sum += float(np.abs(p - l).sum())
        denom = np.maximum(np.abs(l), 1e-12)
        self.rel_err_sum += float((np.abs(p - l) / denom).sum())
        self.count += float(l.size)
        self.label_sq_sum += float((l**2).sum())
        self.unexplained_sum += float(((l - p) ** 2).sum())

    def result(self) -> Dict[str, float]:
        c = max(self.count, 1.0)
        return {
            "label/mean": self.label_sum / c,
            "prediction/mean": self.pred_sum / c,
            "mae": self.abs_err_sum / c,
            "mre": self.rel_err_sum / c,
            "r-squared": self._r2(),
        }

    def _r2(self) -> float:
        # total sum of squares around the pooled label mean
        total = self.label_sq_sum - self.label_sum**2 / max(self.count, 1.0)
        if total <= 0:
            return 0.0
        return 1.0 - self.unexplained_sum / total
