"""Metrics — the port of ``paddle_tpu/metric/__init__.py`` (``:11-164``):
``accuracy``, ``Metric``, ``Accuracy`` (top-k), ``Precision``, ``Recall``
and ``Auc``.

``accuracy`` and ``Accuracy.compute`` run on the output's device (the
label is moved there); ``update`` and ``accumulate`` keep the reference's
state on the host in numpy and Python numbers, so each ``update`` reads
its input to the host.  Top-k takes ``argsort`` of the negated scores,
stable, as the reference's ``np.argsort(-pred)`` orders distinct scores.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _host(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _on(x, device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x))).to(device)


def _topk(pred: torch.Tensor, k: int) -> torch.Tensor:
    return torch.argsort(-pred, dim=-1, stable=True)[..., :k]


def accuracy(input, label, k=1, correct=None, total=None,  # noqa: A002
             name=None):
    """The share of rows whose label is among the top ``k`` scores: a
    float32 0-d tensor on ``input``'s device."""
    pred = _on(input, getattr(input, "device", "cpu"))
    lab = _on(label, pred.device).reshape(-1)
    hit = (_topk(pred, k) == lab[:, None]).any(dim=-1)
    return hit.to(torch.float32).mean()


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return type(self).__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """[N, maxk] float32 hits on ``pred``'s device."""
        pred = _on(pred, getattr(pred, "device", "cpu"))
        lab = _on(label, pred.device)
        if lab.ndim > 1 and lab.shape[-1] == 1:
            lab = lab.reshape(lab.shape[:-1])
        correct = _topk(pred, max(self.topk)) == lab[..., None]
        return correct.to(torch.float32)

    def update(self, correct, *args):
        c = _host(correct)
        n = c.shape[0] if c.ndim else 1
        for i, k in enumerate(self.topk):
            self.total[i] += float(c[..., :k].sum())
            self.count[i] += n
        res = [t / max(cn, 1) for t, cn in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _host(preds).reshape(-1)
        lab = _host(labels).reshape(-1)
        pred_pos = (p > 0.5).astype(int)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fp += int(((pred_pos == 1) & (lab == 0)).sum())

    def accumulate(self):
        ap = self.tp + self.fp
        return self.tp / ap if ap else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _host(preds).reshape(-1)
        lab = _host(labels).reshape(-1)
        pred_pos = (p > 0.5).astype(int)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fn += int(((pred_pos == 0) & (lab == 1)).sum())

    def accumulate(self):
        ap = self.tp + self.fn
        return self.tp / ap if ap else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _host(preds)
        lab = _host(labels).reshape(-1)
        p = p[:, 1] if p.ndim == 2 else p.reshape(-1)
        idx = np.minimum((p * self.num_thresholds).astype(int),
                         self.num_thresholds)
        for i, y in zip(idx, lab):
            if y:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoids over the thresholds, from the highest down
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name
