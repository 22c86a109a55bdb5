"""Evaluation metrics and the console stats table.

Port of ``primia_tpu/train/metrics.py``. The metrics are numpy alone, so
the training loop evaluates on a machine without scikit-learn; they
follow scikit-learn's definitions and arithmetic (``confusion_matrix``,
``classification_report(output_dict=True, zero_division=0)``,
``matthews_corrcoef``, ``roc_auc_score(multi_class="ovo")``), which the
JAX package calls and ``tests/test_torch_train.py`` holds them to.
tabulate is imported where the table is drawn.

Reference: ``torchlib/utils.py:1295-1467`` (``stats_table`` and the
metric block of ``test``): confusion matrix, per-class
recall/precision/F1/support, macro/weighted averages, micro recall,
Matthews correlation coefficient (the model-selection objective), and
one-vs-one ROC-AUC over min-max-renormalized scores.
"""

from __future__ import annotations

import warnings
from itertools import combinations
from typing import Dict, List, Optional

import numpy as np


def score_probabilities(logits: np.ndarray) -> np.ndarray:
    """The reference's ad-hoc score normalization before ROC-AUC
    (``utils.py:1418-1421``): shift each row to min 0, divide by sum."""
    s = logits - logits.min(axis=1)[:, np.newaxis]
    return s / s.sum(axis=1)[:, np.newaxis]


def confusion_matrix(targets: np.ndarray, preds: np.ndarray, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) int64 counts, rows true, columns predicted."""
    idx = np.asarray(targets, np.int64) * num_classes + np.asarray(preds, np.int64)
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (``zero_division=0``)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    out = num / np.where(den == 0, 1.0, den)
    return np.where(den == 0, 0.0, out)


def _prf(tp, pred, true):
    return _divide(tp, pred), _divide(tp, true), _divide(2.0 * tp, true + pred)


def classification_report(conf: np.ndarray) -> Dict:
    """``sklearn.metrics.classification_report(output_dict=True,
    zero_division=0)`` over every label of ``conf``: per class
    precision, recall, f1-score and support, then ``accuracy`` (the micro
    average's precision), ``macro avg`` and ``weighted avg``."""
    tp = np.diag(conf).astype(np.int64)
    pred = conf.sum(axis=0)
    true = conf.sum(axis=1)
    p, r, f = _prf(tp, pred, true)
    keys = ("precision", "recall", "f1-score", "support")
    report: Dict = {str(i): dict(zip(keys, map(float, (p[i], r[i], f[i], true[i]))))
                    for i in range(len(tp))}
    support = float(np.sum(true))
    mp, _, _ = _prf(tp.sum(), pred.sum(), true.sum())
    report["accuracy"] = float(mp)
    report["macro avg"] = dict(zip(keys, (float(np.mean(p)), float(np.mean(r)),
                                          float(np.mean(f)), support)))
    if true.sum() == 0:
        weighted = (np.mean(p), np.mean(r), np.mean(f))
    else:
        weighted = tuple(np.average(a, weights=true) for a in (p, r, f))
    report["weighted avg"] = dict(zip(keys, (*map(float, weighted), support)))
    return report


def matthews_corrcoef(conf: np.ndarray) -> float:
    """Multiclass Matthews correlation from the confusion matrix
    (scikit-learn's formula; 0 when a marginal is constant)."""
    t_sum = conf.sum(axis=1, dtype=np.float64)
    p_sum = conf.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(conf, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples ** 2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ytyt * cov_ypyp))


def _binary_auc(positive: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve of a binary split: the Mann-Whitney
    statistic, ties counted half (the trapezoidal area of the ROC)."""
    pos, neg = score[positive], score[~positive]
    below = np.searchsorted(np.sort(neg), pos, side="left")
    ties = np.searchsorted(np.sort(neg), pos, side="right") - below
    return float((below.sum() + 0.5 * ties.sum()) / (len(pos) * len(neg)))


def roc_auc_ovo(targets: np.ndarray, scores: np.ndarray) -> float:
    """One-vs-one macro ROC-AUC over probability ``scores``
    (``roc_auc_score(multi_class="ovo")``): for each pair of classes, the
    mean of the two one-vs-other AUCs on the pair's samples, averaged.
    Raises ``ValueError`` where scikit-learn does: scores that are not
    finite probabilities, or a class of ``scores`` absent from
    ``targets``."""
    scores = np.asarray(scores, np.float64)
    if not np.all(np.isfinite(scores)) or not np.allclose(1, scores.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc")
    classes = np.unique(targets)
    if len(classes) != scores.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns "
                         "in 'y_score'")
    pair_scores = []
    for a, b in combinations(classes, 2):
        ab = (targets == a) | (targets == b)
        t = targets[ab]
        pair_scores.append((_binary_auc(t == a, scores[ab, a])
                            + _binary_auc(t == b, scores[ab, b])) / 2)
    return float(np.average(pair_scores))


def evaluate_predictions(
    targets: np.ndarray,
    preds: np.ndarray,
    logits: Optional[np.ndarray] = None,
    num_classes: Optional[int] = None,
) -> Dict:
    """All metrics the reference's ``test`` computes, as one dict.

    ``num_classes`` pins the label set: a small (or skewed-node)
    validation split may not contain every class, and the report and
    confusion matrix still list the absent ones.
    """
    targets = np.asarray(targets)
    preds = np.asarray(preds)
    if num_classes is None:
        num_classes = (logits.shape[1] if logits is not None
                       else int(max(targets.max(), preds.max())) + 1)
    out: Dict = {}
    out["conf_matrix"] = confusion_matrix(targets, preds, num_classes)
    out["report"] = classification_report(out["conf_matrix"])
    out["matthews_coeff"] = matthews_corrcoef(out["conf_matrix"])
    out["objective"] = 100.0 * out["matthews_coeff"]
    out["accuracy"] = float(np.mean(targets == preds))
    out["roc_auc"] = 0.0
    if logits is not None:
        try:
            out["roc_auc"] = roc_auc_ovo(targets, score_probabilities(logits))
        except ValueError:
            warnings.warn(
                "ROC AUC score could not be calculated and was set to zero.",
                category=UserWarning,
            )
    return out


def stats_table(
    conf_matrix: np.ndarray,
    report: Dict,
    roc_auc: float = 0.0,
    matthews_coeff: float = 0.0,
    class_names: Optional[List[str]] = None,
    epoch: int = 0,
) -> str:
    """The reference's "fancy_grid" table (``utils.py:1295-1351``)."""
    from tabulate import tabulate

    rows = []
    for i in range(conf_matrix.shape[0]):
        entry = report[str(i)]
        row = [
            class_names[i] if class_names else i,
            "{:.1f} %".format(entry["recall"] * 100.0),
            "{:.1f} %".format(entry["precision"] * 100.0),
            "{:.1f} %".format(entry["f1-score"] * 100.0),
            entry["support"],
        ]
        row.extend([conf_matrix[i, j] for j in range(conf_matrix.shape[1])])
        rows.append(row)
    for name in ("macro avg", "weighted avg"):
        rows.append(
            [
                "Overall ({})".format(name.split()[0]),
                "{:.1f} %".format(report[name]["recall"] * 100.0),
                "{:.1f} %".format(report[name]["precision"] * 100.0),
                "{:.1f} %".format(report[name]["f1-score"] * 100.0),
                report[name]["support"],
            ]
        )
    rows.append(["Overall stats", "micro recall", "matthews coeff", "AUC ROC score"])
    rows.append(
        [
            "",
            "{:.1f} %".format(100.0 * report["accuracy"]),
            "{:.3f}".format(matthews_coeff),
            "{:.3f}".format(roc_auc),
        ]
    )
    headers = ["Epoch {:d}".format(epoch), "Recall", "Precision", "F1 score", "n total"]
    headers.extend(
        [class_names[i] if class_names else i for i in range(conf_matrix.shape[0])]
    )
    return tabulate(rows, headers=headers, tablefmt="fancy_grid")
