"""Evaluation metrics (the JAX package's `train/metrics.py`): an int32
confusion matrix counted on the logits' device, summaries of it (overall
accuracy, mean class accuracy, mIoU), ScanNet's per-voxel confusion and
S3DIS block merging on the host."""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int, mask: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Confusion matrix [C, C] int32 (rows = truth, cols = prediction) for
    cls (labels [B]) and seg (labels [B, N], mask [B, N]). Masked entries
    count in a sentinel cell C² that is dropped."""
    C = num_classes
    idx = labels.reshape(-1).long() * C + logits.argmax(-1).reshape(-1)
    if mask is not None:
        idx = torch.where(mask.reshape(-1), idx, C * C)
    cm = torch.bincount(idx, minlength=C * C + 1)
    return cm[:-1].to(torch.int32).reshape(C, C)


def summarize_confusion(cm: torch.Tensor) -> dict:
    """OA, mean per-class accuracy, mIoU, per-class IoU from a [C, C]
    matrix (float32, as the JAX package computes them)."""
    cm = cm.to(torch.float32)
    total = cm.sum()
    diag = torch.diagonal(cm)
    row = cm.sum(dim=1)         # ground-truth counts
    col = cm.sum(dim=0)         # prediction counts
    present = row > 0
    n_present = torch.clamp_min(present.sum().float(), 1.0)
    oa = diag.sum() / torch.clamp_min(total, 1.0)
    class_acc = torch.where(present, diag / torch.clamp_min(row, 1.0), 0.0)
    union = row + col - diag
    iou = torch.where(present, diag / torch.clamp_min(union, 1.0), 0.0)
    return {
        "overall_acc": oa,
        "mean_class_acc": class_acc.sum() / n_present,
        "miou": iou.sum() / n_present,
        "iou_per_class": iou,
    }


def voxel_confusion(xyz, logits, labels, mask, voxel_size: float,
                    num_classes: int) -> np.ndarray:
    """ScanNet per-voxel confusion: point predictions projected on a voxel
    grid, each occupied voxel scored once (majority label against majority
    predicted class). Host numpy; a [C, C] int64 matrix summable across
    scenes."""
    xyz = np.asarray(xyz).reshape(-1, 3)
    preds = np.argmax(np.asarray(logits), -1).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    m = np.asarray(mask).reshape(-1).astype(bool)
    xyz, preds, labels = xyz[m], preds[m], labels[m]
    if xyz.shape[0] == 0:
        return np.zeros((num_classes, num_classes), np.int64)

    v = np.floor((xyz - xyz.min(0)) / voxel_size).astype(np.int64)
    dims = v.max(0) + 1
    vid = (v[:, 0] * dims[1] + v[:, 1]) * dims[2] + v[:, 2]
    uniq, inv = np.unique(vid, return_inverse=True)
    lab_hist = np.zeros((len(uniq), num_classes), np.int64)
    np.add.at(lab_hist, (inv, labels), 1)
    pred_hist = np.zeros((len(uniq), num_classes), np.int64)
    np.add.at(pred_hist, (inv, preds), 1)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (lab_hist.argmax(1), pred_hist.argmax(1)), 1)
    return cm


def merge_block_logits(positions, logits, masks, quant: float = 1e-3):
    """S3DIS room merging: block points are keyed by their quantized room
    position and a point sampled into several blocks has its logits summed.
    Host numpy → (merged logits [P, C] float64, first-occurrence index [P]
    into the flat block points)."""
    pos = np.asarray(positions).reshape(-1, positions.shape[-1])
    lg = np.asarray(logits).reshape(-1, logits.shape[-1])
    m = np.asarray(masks).reshape(-1).astype(bool)
    pos, lg = pos[m], lg[m]
    keys = np.round(pos / quant).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    merged = np.zeros((len(uniq), lg.shape[-1]), np.float64)
    np.add.at(merged, inv, lg.astype(np.float64))
    first = np.full(len(uniq), -1, np.int64)
    flat_idx = np.nonzero(m)[0]
    # reverse fill so that earlier indices win
    first[inv[::-1]] = flat_idx[::-1]
    return merged, first
