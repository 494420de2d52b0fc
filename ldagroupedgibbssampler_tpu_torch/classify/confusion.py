"""Confusion matrix with CSV export.

Replaces ``cc.mallet.classify.evaluate.EnhancedConfusionMatrix``
(classify/evaluate/EnhancedConfusionMatrix.java:1-220): counts
values[true][predicted], overall accuracy, combination of several trials
(cross-validation folds), CSV/pretty-print output. The port's copy of
`ldagroupedgibbssampler_tpu/classify/confusion.py`: host NumPy, the same
values and CSV.
"""

from __future__ import annotations

import numpy as np


class EnhancedConfusionMatrix:
    def __init__(self, true_labels, predicted_labels, class_names=None):
        """`true_labels` / `predicted_labels` are int class indices; a
        single "trial" in reference terms."""
        true_labels = np.asarray(true_labels, np.int64)
        predicted_labels = np.asarray(predicted_labels, np.int64)
        if class_names is None:
            hi = int(max(true_labels.max(initial=-1),
                         predicted_labels.max(initial=-1))) + 1
            class_names = [str(i) for i in range(hi)]
        self.class_names = list(class_names)
        n = len(self.class_names)
        flat = true_labels * n + predicted_labels
        self.values = np.bincount(flat, minlength=n * n).reshape(n, n)
        self.total = int(len(true_labels))
        self.num_correct = int(np.sum(true_labels == predicted_labels))

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def average_accuracy(self) -> float:
        return self.num_correct / self.total if self.total else 0.0

    @classmethod
    def combined(cls, matrices: list["EnhancedConfusionMatrix"]):
        """Combined matrix over trials (the Trial[] constructor,
        EnhancedConfusionMatrix.java:38-66)."""
        assert matrices
        out = object.__new__(cls)
        out.class_names = matrices[0].class_names
        out.values = sum(m.values for m in matrices)
        out.total = sum(m.total for m in matrices)
        out.num_correct = sum(m.num_correct for m in matrices)
        return out

    def to_csv(self, sep: str = ",") -> str:
        """Row = true class, column = predicted (toCsv,
        EnhancedConfusionMatrix.java:69-95)."""
        lines = ["Label (R=true C=Predicted)" + sep + sep.join(
            self.class_names) + sep + "total"]
        for i, name in enumerate(self.class_names):
            row = self.values[i]
            lines.append(name + sep + sep.join(str(int(v)) for v in row)
                         + sep + str(int(row.sum())))
        totals = self.values.sum(axis=0)
        lines.append("total" + sep + sep.join(str(int(v)) for v in totals)
                     + sep + str(int(totals.sum())))
        return "\n".join(lines) + "\n"

    def __str__(self) -> str:
        return (f"Confusion Matrix (accuracy "
                f"{self.average_accuracy:.4f})\n" + self.to_csv(sep="\t"))
