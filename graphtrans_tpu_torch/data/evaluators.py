"""Split metrics on the host (numpy; copied from
``graphtrans_tpu/data/evaluators.py``). ogbg-code2: per-graph set-based
subtoken precision, recall and F1, averaged over the graphs (the OGB
evaluator's semantics); the TU datasets: plain accuracy."""

from __future__ import annotations

import numpy as np


def eval_f1_seq(seq_ref: list, seq_pred: list) -> dict:
    precisions, recalls, f1s = [], [], []
    for ref, pred in zip(seq_ref, seq_pred):
        label, prediction = set(ref), set(pred)
        tp = len(label & prediction)
        p = tp / len(prediction) if prediction else 0.0
        r = tp / len(label) if label else 0.0
        precisions.append(p)
        recalls.append(r)
        f1s.append(2 * p * r / (p + r) if p + r > 0 else 0.0)
    mean = lambda v: float(np.mean(v)) if v else 0.0
    return {"precision": mean(precisions), "recall": mean(recalls),
            "F1": mean(f1s)}


def eval_acc(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    return {"acc": float((y_true == y_pred).mean()) if len(y_true) else 0.0}
