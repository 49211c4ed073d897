"""Evaluation metrics: the gate metrics in torch with an explicit batch axis,
and own numpy copies of the host metrics of ``repro.metrics``.

Gate metrics (``macro_auc_traced`` and friends) take ``probs [..., V, C]``,
``labels [..., V]`` and an optional ``valid [..., V]`` mask and return one
value per leading index — the engine passes the whole swarm at once
(``[N, V, C]`` → ``[N]``), so no host round-trip sits between the forward
pass and the gate. The AUC is the sort-based Mann-Whitney form with average
ranks over ties (left/right ``searchsorted``); masked rows are pushed to
``+inf``, past every valid score, and classes absent from a node's valid
rows leave its macro average.
"""
from __future__ import annotations

import numpy as np
import torch


def _valid(labels, valid):
    if valid is None:
        return torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    return valid.to(torch.bool)


def macro_auc_traced(probs, labels, valid=None):
    """One-vs-rest macro AUC over ``[..., V, C]`` probs → ``[...]``."""
    v = _valid(labels, valid)[..., None, :]                  # [..., 1, V]
    n_classes = probs.shape[-1]
    classes = torch.arange(n_classes, device=labels.device)[:, None]
    scores = probs.to(torch.float32).transpose(-1, -2)       # [..., C, V]
    s = torch.where(v, scores, torch.inf).contiguous()
    lab = labels[..., None, :]
    pos = (lab == classes) & v
    neg = (lab != classes) & v
    ss = torch.sort(s, dim=-1).values
    lo = torch.searchsorted(ss, s, side="left")    # count of strictly-less
    hi = torch.searchsorted(ss, s, side="right")   # count of less-or-equal
    # average 1-based rank over the tie group occupying ranks lo+1..hi
    rank = 0.5 * (lo + hi + 1).to(torch.float32)
    n_pos = pos.sum(-1).to(torch.float32)
    n_neg = neg.sum(-1).to(torch.float32)
    u = torch.where(pos, rank, 0.0).sum(-1) - n_pos * (n_pos + 1.0) / 2.0
    n_pairs = n_pos * n_neg
    auc = torch.where(n_pairs > 0, u / torch.clamp(n_pairs, min=1.0), 0.5)
    present = (n_pos > 0).to(torch.float32)
    return (auc * present).sum(-1) / torch.clamp(present.sum(-1), min=1.0)


def _confusion_traced(probs, labels, valid=None):
    """Per-class (tp, fn, fp, tn) counts ``[..., C]`` from argmax predictions
    (all C classes enter the macro average, as in :func:`confusion_stats`)."""
    v = _valid(labels, valid)[..., None, :]
    preds = torch.argmax(probs, dim=-1)
    classes = torch.arange(probs.shape[-1], device=labels.device)[:, None]
    is_c = labels[..., None, :] == classes                   # [..., C, V]
    pred_c = preds[..., None, :] == classes

    def count(m):
        return (m & v).sum(-1).to(torch.float32)

    return (count(pred_c & is_c), count(~pred_c & is_c),
            count(pred_c & ~is_c), count(~pred_c & ~is_c))


def sensitivity_traced(probs, labels, valid=None):
    """Macro sensitivity (recall); host oracle ``confusion_stats``."""
    tp, fn, _, _ = _confusion_traced(probs, labels, valid)
    return torch.mean(tp / torch.clamp(tp + fn, min=1.0), dim=-1)


def macro_f1_traced(probs, labels, valid=None):
    """Macro F1; host oracle ``confusion_stats(...)['f1']``."""
    tp, fn, fp, _ = _confusion_traced(probs, labels, valid)
    se = tp / torch.clamp(tp + fn, min=1.0)
    pr = tp / torch.clamp(tp + fp, min=1.0)
    return torch.mean(2.0 * pr * se / torch.clamp(pr + se, min=1e-12), dim=-1)


def accuracy_traced(probs, labels, valid=None):
    """Accuracy over valid rows (host oracle :func:`accuracy`)."""
    v = _valid(labels, valid)
    hit = (torch.argmax(probs, dim=-1) == labels) & v
    return hit.sum(-1) / torch.clamp(v.sum(-1), min=1.0)


GATE_METRICS = {
    "auc": macro_auc_traced,
    "accuracy": accuracy_traced,
    "f1": macro_f1_traced,
    "sensitivity": sensitivity_traced,
}


def gate_metric_fn(name: str):
    """The gate metric for ``SwarmConfig.gate_metric``:
    ``fn(probs [..., V, C], labels [..., V], valid [..., V]) -> [...]``."""
    try:
        return GATE_METRICS[name]
    except KeyError:
        raise ValueError(f"unknown gate_metric {name!r}; "
                         f"choose from {sorted(GATE_METRICS)}") from None


# ---------------------------------------------------------------------------
# host metrics (numpy copies of repro.metrics)
# ---------------------------------------------------------------------------

def binary_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (ties averaged) — equivalent to Mann-Whitney U / (n+ n-)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    n_pos, n_neg = labels.sum(), (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = scores[order]
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks over ties
    uniq, inv, counts = np.unique(sorted_scores, return_inverse=True,
                                  return_counts=True)
    cum = np.cumsum(counts)
    avg_rank = (cum - (counts - 1) / 2.0)
    ranks[order] = avg_rank[inv]
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def macro_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """One-vs-rest macro AUC for multiclass probs [N, C]."""
    cs = [binary_auc(probs[:, c], labels == c)
          for c in range(probs.shape[1]) if (labels == c).any()]
    return float(np.mean(cs)) if cs else 0.5


def confusion_stats(preds: np.ndarray, labels: np.ndarray, n_classes: int):
    """Macro-averaged sensitivity / specificity / F1 + per-class recall."""
    sens, spec, f1s, recalls = [], [], [], []
    for c in range(n_classes):
        tp = np.sum((preds == c) & (labels == c))
        fn = np.sum((preds != c) & (labels == c))
        fp = np.sum((preds == c) & (labels != c))
        tn = np.sum((preds != c) & (labels != c))
        se = tp / max(tp + fn, 1)
        sp = tn / max(tn + fp, 1)
        pr = tp / max(tp + fp, 1)
        f1 = 2 * pr * se / max(pr + se, 1e-12)
        sens.append(se); spec.append(sp); f1s.append(f1); recalls.append(se)
    return {
        "sensitivity": float(np.mean(sens)),
        "specificity": float(np.mean(spec)),
        "f1": float(np.mean(f1s)),
        "per_class_recall": [float(r) for r in recalls],
    }


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean(preds == labels))


def davies_bouldin(embeddings: np.ndarray, labels: np.ndarray) -> float:
    """DBI (lower = tighter clusters) — paper reports 15% lower for swarm."""
    embeddings = np.asarray(embeddings, np.float64)
    classes = np.unique(labels)
    cents, scatters = [], []
    for c in classes:
        e = embeddings[labels == c]
        mu = e.mean(0)
        cents.append(mu)
        scatters.append(np.mean(np.linalg.norm(e - mu, axis=1)))
    k = len(classes)
    if k < 2:
        return 0.0
    cents = np.stack(cents)
    db = 0.0
    for i in range(k):
        ratios = [
            (scatters[i] + scatters[j]) / max(np.linalg.norm(cents[i] - cents[j]), 1e-12)
            for j in range(k) if j != i
        ]
        db += max(ratios)
    return float(db / k)


def classify_report(probs: np.ndarray, labels: np.ndarray) -> dict:
    preds = probs.argmax(-1)
    rep = {"auc": macro_auc(probs, labels), "accuracy": accuracy(preds, labels)}
    rep.update(confusion_stats(preds, labels, probs.shape[1]))
    return rep
