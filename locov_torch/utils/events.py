"""Metrics bus + writers.

The port's own copy of ``locov_tpu/utils/events.py`` (the same code):
``locov_torch`` imports nothing of the JAX package. Replaces d2's
``EventStorage`` and the reference's writer zoo: ``OvrMetricPrinter``
(events.py:6-66), ``AllMetricPrinter`` (utils/misc.py:99-203), the CSV
``CalcWriter`` with repeated-value suppression (utils/misc.py:33-96),
and d2's JSONWriter. TensorBoard is optional and gated on the package
being importable.
"""
from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional


class HistoryBuffer:
    def __init__(self, window: int = 20):
        self._values = deque(maxlen=window)
        self.latest = None
        self.latest_iter = -1

    def update(self, value: float, iteration: int):
        self._values.append(float(value))
        self.latest = float(value)
        self.latest_iter = iteration

    def median(self):
        v = sorted(self._values)
        return v[len(v) // 2] if v else float("nan")

    def avg(self):
        return sum(self._values) / max(len(self._values), 1)


class EventStorage:
    """Scalar bus keyed by name; one instance per training run."""

    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self._window = window
        self._history: Dict[str, HistoryBuffer] = defaultdict(
            lambda: HistoryBuffer(self._window))

    def put_scalar(self, name: str, value):
        self._history[name].update(float(value), self.iter)

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def histories(self):
        return self._history

    def latest(self) -> Dict[str, float]:
        return {k: h.latest for k, h in self._history.items()
                if h.latest_iter == self.iter}

    def step(self):
        self.iter += 1


class MetricPrinter:
    """Terminal printer in the reference's format: eta, iter, losses
    (smoothed medians), accuracies, lr, data/step time, memory."""

    def __init__(self, max_iter: int, logger=print):
        self.max_iter = max_iter
        self.logger = logger
        self._last_write = None

    def write(self, storage: EventStorage):
        it = storage.iter
        hist = storage.histories()
        eta = ""
        if "time" in hist:
            t = hist["time"].median()
            eta_sec = int(t * (self.max_iter - it))
            eta = "eta: " + str(datetime.timedelta(seconds=eta_sec))
        losses = []
        accs = []
        for k in sorted(hist):
            h = hist[k]
            if h.latest is None:
                continue
            if "loss" in k.lower():
                losses.append(f"{k}: {h.median():.4g}")
            elif "accuracy" in k.lower():
                accs.append(f"{k}: {h.median():.3f}")
        extras = []
        for k in ("lr", "data_time", "time"):
            if k in hist:
                extras.append(f"{k}: {hist[k].median():.4g}")
        self.logger(f"{eta}  iter: {it}  " + "  ".join(losses)
                    + ("  " + "  ".join(accs) if accs else "")
                    + "  " + "  ".join(extras))


class JSONWriter:
    """metrics.json: one JSON dict per line (d2 JSONWriter)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def write(self, storage: EventStorage):
        row = {"iteration": storage.iter}
        for k, h in storage.histories().items():
            if h.latest is not None:
                row[k] = h.latest
        with open(self.path, "a") as f:
            f.write(json.dumps(row, sort_keys=True) + "\n")


class CSVWriter:
    """CalcWriter-style CSV with an epoch column and suppression of
    values already written at the same iteration
    (utils/misc.py:33-96)."""

    def __init__(self, path: str, epoch_size: int = 1000):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.epoch_size = max(epoch_size, 1)
        self._columns = None
        self._last = {}

    def write(self, storage: EventStorage):
        row = {"iteration": storage.iter,
               "epoch": storage.iter / self.epoch_size}
        for k, h in storage.histories().items():
            if h.latest is None:
                continue
            if self._last.get(k) == (h.latest_iter, h.latest):
                continue  # repeated-value suppression
            row[k] = h.latest
            self._last[k] = (h.latest_iter, h.latest)
        import csv
        if self._columns is None:
            self._columns = sorted(set(row))
            with open(self.path, "a", newline="") as f:
                csv.writer(f).writerow(self._columns)
        missing = [c for c in row if c not in self._columns]
        if missing:
            # Metric names appear lazily (e.g. eval metrics join at the
            # first EvalHook firing). Keep the file a single-schema CSV:
            # rewrite it under the expanded header, padding prior rows.
            # Expansion is rare (once per new metric group), so the
            # rewrite cost is negligible at LOG_PERIOD granularity.
            old_columns = self._columns
            self._columns = old_columns + sorted(missing)
            try:
                with open(self.path, newline="") as f:
                    rows = list(csv.reader(f))[1:]  # drop old header
            except FileNotFoundError:
                rows = []
            with open(self.path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(self._columns)
                pad = [""] * len(missing)
                for r in rows:
                    w.writerow(r + pad)
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(
                [row.get(c, "") for c in self._columns])


class TensorboardWriter:
    """Optional TB writer; silently disabled if tensorboard(X) is not
    installed (it is not baked into this image)."""

    def __init__(self, log_dir: str):
        self._w = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(log_dir)
        except Exception:
            try:
                from tensorboardX import SummaryWriter
                self._w = SummaryWriter(log_dir)
            except Exception:
                self._w = None

    def write(self, storage: EventStorage):
        if self._w is None:
            return
        for k, h in storage.histories().items():
            if h.latest_iter == storage.iter and h.latest is not None:
                self._w.add_scalar(k, h.latest, storage.iter)

    def close(self):
        if self._w is not None:
            self._w.close()
