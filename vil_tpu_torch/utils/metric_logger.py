"""Metric logging (the reference's utils/metric_logger.py); a copy of
``vil_tpu/utils/metric_logger.py``.

SmoothedValue (20-deep window with median/avg/global-avg), AverageMeter,
MetricLogger grouping, and a TensorboardLogger writing each scalar to THREE
SummaryWriters — last value, window-average (/avg), window-median (/med) —
matching metric_logger.py:115-165. tensorboardX is optional (gated import).
"""
from __future__ import annotations

import logging
import os
from collections import defaultdict, deque

import numpy as np

logger = logging.getLogger(__name__)


class SmoothedValue:
    """Track a window of values + global stats (metric_logger.py:11-44)."""

    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.series: list[float] = []
        self.total = 0.0
        self.count = 0

    def update(self, value):
        value = float(value)
        self.deque.append(value)
        self.series.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def last(self) -> float:
        return self.deque[-1] if self.deque else 0.0


class AverageMeter:
    """Running average (metric_logger.py:167-182)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricLogger:
    """Grouped smoothed metrics (metric_logger.py:47-112)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
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
            for name, m in self.meters.items()
        )


def _get_writer(log_dir):
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except Exception:  # tensorboardX unavailable: no-op writer
        class _Noop:
            def add_scalar(self, *a, **k):
                pass

            def flush(self):
                pass

            def close(self):
                pass

        return _Noop()


class TensorboardLogger:
    """Triple-writer TB logging (metric_logger.py:115-165): every scalar goes
    to <dir>/ (last), <dir>/avg, <dir>/med."""

    def __init__(self, log_dir: str, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.tb_logger = _get_writer(log_dir)
        self.tb_logger_avg = _get_writer(os.path.join(log_dir, "avg"))
        self.tb_logger_med = _get_writer(os.path.join(log_dir, "med"))

    def update(self, iteration: int, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))
            self.tb_logger.add_scalar(k, float(v), iteration)
            self.tb_logger_avg.add_scalar(k, self.meters[k].avg, iteration)
            self.tb_logger_med.add_scalar(k, self.meters[k].median, iteration)

    def flush(self):
        for w in (self.tb_logger, self.tb_logger_avg, self.tb_logger_med):
            w.flush()

    def close(self):
        for w in (self.tb_logger, self.tb_logger_avg, self.tb_logger_med):
            w.close()

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items()
        )
