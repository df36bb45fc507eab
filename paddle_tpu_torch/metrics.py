"""Python-side streaming metrics (counterpart of paddle_tpu/metrics.py;
fluid's metrics.py): ``Accuracy``, ``Precision``, ``Recall``, ``F1``,
``CompositeMetric`` and ``Auc``, each updated from values fetched by
``Executor.run`` and kept on the host in numpy, and the evaluator classes
under their fluid names.
"""
import numpy as np


class MetricBase(object):
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if isinstance(v, (int, float)):
                setattr(self, k, 0 if isinstance(v, int) else 0.0)
            elif isinstance(v, np.ndarray):
                setattr(self, k, np.zeros_like(v))

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no updates yet")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super(Precision, self).__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super(Recall, self).__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class F1(MetricBase):
    def __init__(self, name=None):
        super(F1, self).__init__(name)
        self.p = Precision()
        self.r = Recall()

    def update(self, preds, labels):
        self.p.update(preds, labels)
        self.r.update(preds, labels)

    def eval(self):
        p, r = self.p.eval(), self.r.eval()
        return 2 * p * r / (p + r) if (p + r) else 0.0


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super(Auc, self).__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(num_thresholds + 1, dtype=np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        score = preds[:, -1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.clip((score * self._num_thresholds).astype(np.int64), 0,
                      self._num_thresholds)
        np.add.at(self._stat_pos, idx, (labels > 0).astype(np.int64))
        np.add.at(self._stat_neg, idx, (labels <= 0).astype(np.int64))

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])[::-1].astype(np.float64)
        fp = np.cumsum(self._stat_neg[::-1])[::-1].astype(np.float64)
        tot_pos, tot_neg = tp[0], fp[0]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tp_next = np.append(tp[1:], 0.0)
        fp_next = np.append(fp[1:], 0.0)
        area = np.sum((fp - fp_next) * (tp + tp_next) / 2.0)
        return float(area / (tot_pos * tot_neg))


# evaluator-class aliases (ref fluid/metrics.py exposes these names)
from .evaluator import ChunkEvaluator, EditDistance, DetectionMAP  # noqa: E402,F401
