"""Evaluation metrics and the console stats table.

Port of ``primia_tpu/train/metrics.py``; scikit-learn and tabulate are
imported where they are used, so the serving path needs neither.

Reference: ``torchlib/utils.py:1295-1467`` (``stats_table`` and the
metric block of ``test``): confusion matrix, per-class
recall/precision/F1/support, macro/weighted averages, micro recall,
Matthews correlation coefficient (the model-selection objective), and
one-vs-one ROC-AUC over min-max-renormalized scores.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np


def score_probabilities(logits: np.ndarray) -> np.ndarray:
    """The reference's ad-hoc score normalization before ROC-AUC
    (``utils.py:1418-1421``): shift each row to min 0, divide by sum."""
    s = logits - logits.min(axis=1)[:, np.newaxis]
    return s / s.sum(axis=1)[:, np.newaxis]


def evaluate_predictions(
    targets: np.ndarray,
    preds: np.ndarray,
    logits: Optional[np.ndarray] = None,
    num_classes: Optional[int] = None,
) -> Dict:
    """All metrics the reference's ``test`` computes, as one dict.

    ``num_classes`` pins the label set: a small (or skewed-node)
    validation split may not contain every class, and sklearn would
    otherwise drop the absent ones from the report/confusion matrix.
    """
    import sklearn.metrics as mt

    if num_classes is None:
        num_classes = (logits.shape[1] if logits is not None
                       else int(max(targets.max(), preds.max())) + 1)
    labels = np.arange(num_classes)
    out: Dict = {}
    out["conf_matrix"] = mt.confusion_matrix(targets, preds, labels=labels)
    out["report"] = mt.classification_report(
        targets, preds, labels=labels, output_dict=True, zero_division=0
    )
    out["matthews_coeff"] = mt.matthews_corrcoef(targets, preds)
    out["objective"] = 100.0 * out["matthews_coeff"]
    out["accuracy"] = float(np.mean(targets == preds))
    if logits is not None:
        try:
            out["roc_auc"] = mt.roc_auc_score(
                targets, score_probabilities(logits), multi_class="ovo"
            )
        except ValueError:
            warnings.warn(
                "ROC AUC score could not be calculated and was set to zero.",
                category=UserWarning,
            )
            out["roc_auc"] = 0.0
    else:
        out["roc_auc"] = 0.0
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
            # sklearn reports "micro avg" instead of "accuracy" when an
            # explicit label set is passed and some class is absent
            "{:.1f} %".format(100.0 * report.get(
                "accuracy", report.get("micro avg", {}).get("recall", 0.0))),
            "{:.3f}".format(matthews_coeff),
            "{:.3f}".format(roc_auc),
        ]
    )
    headers = ["Epoch {:d}".format(epoch), "Recall", "Precision", "F1 score", "n total"]
    headers.extend(
        [class_names[i] if class_names else i for i in range(conf_matrix.shape[0])]
    )
    return tabulate(rows, headers=headers, tablefmt="fancy_grid")
