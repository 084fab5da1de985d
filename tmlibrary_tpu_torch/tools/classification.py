"""Classification tool: supervised per-object classification.

Counterpart: ``tmlibrary_tpu/tools/classification.py``.  Methods:

- ``logreg`` (default): multinomial logistic regression, 300 full-batch
  gradient steps from zeros (``lr`` 0.1, L2 1e-4 on the weights) through
  ``torch.autograd`` on ``device``;
- ``knn``: each object takes the majority class among the labelled
  objects of its k-neighbourhood over the store graph (through the
  analytics index dispatcher); objects with no labelled neighbour take
  the nearest training example's class.

``svm`` and ``randomforest`` train scikit-learn models in the reference;
the port's target machine has no scikit-learn and the port does not
depend on it, so those two methods raise :class:`NotSupportedError`.
``select_k_best`` keeps the training classes' top ANOVA F-score features
first.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlibrary_tpu_torch.analytics import ops
from tmlibrary_tpu_torch.device import resolve_device
from tmlibrary_tpu_torch.errors import NotSupportedError
from tmlibrary_tpu_torch.tools.base import Tool, ToolResult, register_tool

#: methods the reference runs through scikit-learn
SKLEARN_METHODS = ("svm", "randomforest")


def softmax_train(x, y, n_classes: int, n_iter: int = 300, lr: float = 0.1,
                  l2: float = 1e-4, device: "str | torch.device" = "cuda"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-batch multinomial logistic regression; returns (W (F, C), b
    (C,)) on ``device``."""
    dev = resolve_device(device)
    x = ops.as_tensor(x, dev)
    y = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=dev)
    n, f = x.shape
    w = torch.zeros((f, n_classes), dtype=torch.float32, device=dev)
    b = torch.zeros((n_classes,), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)
    with ops.float32_matmuls(dev):
        for _ in range(int(n_iter)):
            w.requires_grad_(True)
            b.requires_grad_(True)
            logp = torch.log_softmax(x @ w + b, dim=1)
            loss = -logp[rows, y].mean() + l2 * (w * w).sum()
            gw, gb = torch.autograd.grad(loss, (w, b))
            with torch.no_grad():
                w, b = w - lr * gw, b - lr * gb
    return w.detach(), b.detach()


def _kbest_anova(x_train: np.ndarray, y_train: np.ndarray, n_classes: int, k: int
                 ) -> np.ndarray:
    """Indices of the ``k`` features with the highest one-way ANOVA F
    between the training classes (ties by column order; zero
    within-class variance scores inf when the classes differ, 0 for a
    constant column)."""
    n, f = x_train.shape
    grand = x_train.mean(axis=0)
    between = np.zeros(f)
    within = np.zeros(f)
    for c in range(n_classes):
        grp = x_train[y_train == c]
        if not len(grp):
            continue
        between += len(grp) * (grp.mean(axis=0) - grand) ** 2
        within += ((grp - grp.mean(axis=0)) ** 2).sum(axis=0)
    df_b = max(n_classes - 1, 1)
    df_w = max(n - n_classes, 1)
    score = np.where(within > 1e-12, (between / df_b) / (within / df_w + 1e-12),
                     np.where(between > 1e-12, np.inf, 0.0))
    k = max(1, min(int(k), f))
    order = np.lexsort((np.arange(f), -score))
    return np.sort(order[:k])


@register_tool("classification")
class Classification(Tool):
    """Supervised per-object classification.  Payload: ``objects_name``,
    ``training_examples`` ([{site_index, label, class}, ...]), optional
    ``method`` (``logreg`` or ``knn``), ``features``, ``select_k_best``,
    and for ``knn`` the neighbourhood ``k`` (10) and ``index``/``top_p``.
    Reports the training accuracy and per-class counts."""

    def process(self, payload: dict) -> ToolResult:
        objects_name = payload["objects_name"]
        method = payload.get("method", "logreg")
        if method in SKLEARN_METHODS:
            raise NotSupportedError(
                f"classification method '{method}' trains a scikit-learn model in the JAX "
                "package; the port runs without scikit-learn (use logreg or knn)")
        if method not in ("logreg", "knn"):
            raise NotSupportedError(f"unknown classification method '{method}'")
        features = payload.get("features")
        examples = payload.get("training_examples") or []
        if not examples:
            raise NotSupportedError("classification needs training_examples")

        ids, x, feat_cols = self.load_feature_matrix(objects_name, features)
        lookup = {t: i for i, t in enumerate(zip(ids["site_index"].tolist(),
                                                 ids["label"].tolist()))}
        class_names = sorted({e["class"] for e in examples})
        cls_index = {c: i for i, c in enumerate(class_names)}
        rows, labels = [], []
        for e in examples:
            t = (e["site_index"], e["label"])
            if t not in lookup:
                raise NotSupportedError(f"training example {t} is not a known object")
            rows.append(lookup[t])
            labels.append(cls_index[e["class"]])
        rows = np.asarray(rows)
        x_train = x[rows]
        y_train = np.asarray(labels, np.int32)

        select_k = payload.get("select_k_best")
        if select_k:
            keep = _kbest_anova(x_train, y_train, len(class_names), int(select_k))
            x, x_train = x[:, keep], x_train[:, keep]
            feat_cols = [feat_cols[i] for i in keep]

        index_info: dict = {}
        if method == "knn":
            from tmlibrary_tpu_torch.analytics.index import knn_search

            k_nn = int(payload.get("k", 10))
            fs = self.feature_store(objects_name)
            nn_idx, _, index_info = knn_search(fs, x, k_nn, mode=payload.get("index"),
                                               features=feat_cols, top_p=payload.get("top_p"),
                                               device=self.device)
            index_info = {"k": k_nn, **index_info}
            seeded = np.full(len(x), -1, np.int64)
            seeded[rows] = y_train
            neigh = seeded[nn_idx]  # (N, k) class per neighbour, -1 unlabelled
            votes = np.stack([(neigh == c).sum(axis=1) for c in range(len(class_names))],
                             axis=1)
            pred = votes.argmax(axis=1)  # ties -> lowest class index
            bare = votes.sum(axis=1) == 0
            if bare.any():
                xb = x[bare]
                d2 = (np.sum(xb * xb, axis=1, keepdims=True) - 2.0 * xb @ x_train.T
                      + np.sum(x_train * x_train, axis=1)[None])
                pred[bare] = y_train[np.argmin(d2, axis=1)]
            pred = pred.astype(np.int64)
            pred_train = pred[rows]
        else:
            dev = resolve_device(self.device)
            w, b = softmax_train(x_train, y_train, len(class_names), device=dev)
            with ops.float32_matmuls(dev), torch.no_grad():
                pred = torch.argmax(ops.as_tensor(x, dev) @ w + b, dim=1).cpu().numpy()
                pred_train = torch.argmax(ops.as_tensor(x_train, dev) @ w + b,
                                          dim=1).cpu().numpy()

        ids["value"] = np.asarray(pred).astype(np.int32)
        train_counts = {c: int((y_train == i).sum()) for c, i in cls_index.items()}
        pred_counts = {c: int((np.asarray(pred) == i).sum()) for c, i in cls_index.items()}
        return ToolResult(
            tool=self.name, objects_name=objects_name, layer_type="categorical", values=ids,
            attributes={
                "method": method,
                "classes": class_names,
                "features": feat_cols,
                "n_training": len(examples),
                "training_accuracy": round(float((pred_train == y_train).mean()), 4),
                "class_counts": {"training": train_counts, "predicted": pred_counts},
                **index_info,
            },
        )
