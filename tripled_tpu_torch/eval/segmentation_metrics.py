"""Segmentation metrics (`tripled_tpu/eval/segmentation_metrics.py`):
confusion matrix, IoU/accuracy/precision/freq-w acc, and the evaluation
that both segmentation CLIs run.

As in the JAX package, every class below `n_classes` is scored, the void
train id 19 included. Where a label is larger or smaller than the model's
output (the test transform resizes only the image), `predict_labels`
resizes the log-probabilities bilinearly to the label's size before the
argmax, so that the scores are taken at the label's resolution; the JAX
package's hook and eval CLI raise an IndexError there. Where the sizes
match nothing is resized, and the scores are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from tripled_tpu_torch.ops.image import resize_bilinear


class Evaluator:
    @staticmethod
    def iou(conf):
        with np.errstate(divide="ignore", invalid="ignore"):
            iu = np.diag(conf) / (
                conf.sum(axis=1) + conf.sum(axis=0) - np.diag(conf)
            )
        return {"iou": dict(enumerate(iu)), "meaniou": np.nanmean(iu)}

    @staticmethod
    def accuracy(conf):
        with np.errstate(divide="ignore", invalid="ignore"):
            totalacc = np.diag(conf).sum() / conf.sum()
            acc = np.diag(conf) / conf.sum(axis=1)
        return {"totalacc": totalacc, "meanacc": np.nanmean(acc), "acc": acc}

    @staticmethod
    def precision(conf):
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.diag(conf) / conf.sum(axis=0)
        return {"meanprec": np.nanmean(prec), "prec": prec}

    @staticmethod
    def freqwacc(conf):
        with np.errstate(divide="ignore", invalid="ignore"):
            iu = np.diag(conf) / (
                conf.sum(axis=1) + conf.sum(axis=0) - np.diag(conf)
            )
            freq = conf.sum(axis=1) / conf.sum()
        return {"freqwacc": (freq[freq > 0] * iu[freq > 0]).sum()}


class SegmentationRunningScore:
    def __init__(self, n_classes: int = 20):
        self.n_classes = n_classes
        self.confusion_matrix = np.zeros((n_classes, n_classes))

    def _fast_hist(self, label_true, label_pred):
        n = self.n_classes
        mask = (label_true >= 0) & (label_true < n)
        hist = np.bincount(
            n * label_true[mask].astype(int) + label_pred[mask].astype(int),
            minlength=n * n,
        ).reshape(n, n)
        return hist

    def update(self, label_trues, label_preds):
        for lt, lp in zip(
            np.asarray(label_trues).reshape(-1, *np.asarray(label_trues).shape[-2:]),
            np.asarray(label_preds).reshape(-1, *np.asarray(label_preds).shape[-2:]),
        ):
            self.confusion_matrix += self._fast_hist(lt.ravel(), lp.ravel())

    def get_scores(self) -> dict:
        conf = self.confusion_matrix
        out = {}
        out.update(Evaluator.iou(conf))
        out.update(Evaluator.accuracy(conf))
        out.update(Evaluator.precision(conf))
        out.update(Evaluator.freqwacc(conf))
        return out

    def reset(self):
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes))


def predict_labels(log_probs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, height, width) argmax classes of (B, h, w, C) log-probabilities,
    resized bilinearly (half-pixel centres) to (height, width) first where
    their size differs."""
    return resize_bilinear(log_probs, height, width).argmax(-1)


@torch.no_grad()
def evaluate_segmentation(model, dataset, n_classes: int, device) -> SegmentationRunningScore:
    """The running score of `model` in eval mode over the samples of
    `dataset` that have a label, one image at a time, each image cast to
    the model's parameter dtype (the test transforms draw nothing from
    the sample's RandomState)."""
    model.eval()
    dtype = next(model.parameters()).dtype
    rng = np.random.RandomState(0)
    scores = SegmentationRunningScore(n_classes)
    for i in range(len(dataset)):
        s = dataset.sample(i, rng)
        if "label" not in s:
            continue
        image = torch.from_numpy(s["image"][None]).to(device, dtype)
        pred = predict_labels(model({"image": image}), *s["label"].shape)
        scores.update(s["label"][None], pred.cpu().numpy())
    return scores
