"""Standalone smoothed-metric logger.

The port's own copy of ``locov_tpu/utils/metric_logger.py`` (the same
code).

Parity port of ``ovr/utils/metric_logger.py`` (SmoothedValue /
MetricLogger — present in the reference but unused by its main path;
kept for API completeness)."""
from __future__ import annotations

from collections import defaultdict, deque


class SmoothedValue:
    """Tracks a series and provides smoothed statistics over a window."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        self.deque.append(float(value))
        self.count += 1
        self.total += float(value)

    @property
    def median(self):
        v = sorted(self.deque)
        return v[len(v) // 2] if v else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())
