"""The classification tool's support vector machine: an RBF C-SVC trained
by an SMO kernel on the card, and its one-vs-one decision over every
object.

Counterpart: ``method: svm`` of ``tmlibrary_tpu/tools/classification.py``,
which trains scikit-learn's ``SVC(kernel="rbf", gamma="scale")`` with its
defaults (``C=1.0``, ``tol=1e-3``, no class weights) and predicts with it.
The port runs without scikit-learn and follows libsvm, as sklearn
builds it:

- ``gamma = 1 / (F * var(X_train))`` in float64 over every entry of the
  training matrix, 1 when that variance is 0 (``svm/_base.py``);
- one C-SVC dual a pair of the sorted classes ``a < b``: the training
  rows of class ``a`` (label +1) then of ``b`` (-1), each in their
  order, as libsvm's ``svm_group_classes`` (sklearn's copy sorts the
  labels) lays them out; all pairs solved by :func:`svm_smo`, libsvm's
  SMO with the second-order working set (WSS3) without shrinking (a
  speed heuristic), stopping at a KKT gap below ``tol``; ``rho`` as
  libsvm's ``calculate_rho``; a training row is a support vector when
  its alpha is non-zero in any pair;
- the decision value of pair ``(a, b)`` is ``sum_k alpha_k y_k K(x,
  x_k) - rho``; it votes for ``a`` when positive, else for ``b``, and the
  most votes win, ties to the lowest class index (libsvm's
  ``svm_predict_values``; for two classes this is sklearn's ``predict``,
  whose ``decision_function`` returns the value negated).

The Gram matrix of the training set and the kernel values of every
object against the support vectors are PyTorch in float64 on the tool's
device (``||x||^2 + ||x_k||^2 - 2 x.x_k``, clamped at 0 with the
training diagonal 0, then ``exp(-gamma d2)``), the objects in chunks so
that millions fit.  No TPU kernel computes them.  The SMO iteration runs
in ``csrc/svm_smo.cu`` on a CUDA Gram matrix (one block a pair, every
step on the card) and in :func:`svm_smo_plain`, step for step, on a CPU
one; both round every operation on its own, so on one Gram matrix their
alphas and rhos are bit-equal.

libsvm keeps its kernel cache in float32 and shrinks its working set,
so at the default ``tol`` its decision values and the port's differ by
up to about ``tol``: a class may differ from the reference's only where
a pairwise decision value lies that close to zero (the tier in
``tests/test_torch_classifiers.py``).  At a tight ``tol`` both reach the
same optimum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmlibrary_tpu_torch.ops._cuda import bind_launch
from tmlibrary_tpu_torch.ops._exact import div

#: libsvm's TAU: the curvature used where it is not positive
TAU = 1e-12
#: the box constraint, ``SVC``'s default ``C`` (no class weights)
C = 1.0
#: objects a chunk of the decision (float64 kernel rows against the
#: support vectors)
DECISION_CHUNK = 1 << 16


def svc_gamma(x_train) -> float:
    """``gamma="scale"``: ``1 / (F * X.var())`` in float64, 1 when the
    variance is 0."""
    x = np.asarray(x_train, np.float64)
    var = x.var()
    return 1.0 / (x.shape[1] * var) if var != 0 else 1.0


def rbf_kernel(a: torch.Tensor, b: torch.Tensor, gamma: float, same: bool = False
               ) -> torch.Tensor:
    """``exp(-gamma ||a_i - b_k||^2)`` (float64); with ``same`` (``b``
    is ``a``) the diagonal distance is exactly 0."""
    a, b = a.double(), b.double()
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    d2 = d2.clamp_min(0.0)
    if same:
        d2.fill_diagonal_(0.0)
    return torch.exp(-gamma * d2)


@dataclasses.dataclass
class Problems:
    """The one-vs-one duals of a training set: ``rows`` (int32) the
    training rows of every pair, concatenated, ``y`` (int32, +1/-1) their
    labels, ``offsets`` (int32, pairs + 1) and ``pairs`` [(a, b), ...]."""

    rows: np.ndarray
    y: np.ndarray
    offsets: np.ndarray
    pairs: list[tuple[int, int]]


def ovo_problems(y_enc: np.ndarray, n_classes: int) -> Problems:
    rows, ys, offsets, pairs = [], [], [0], []
    members = [np.flatnonzero(y_enc == c) for c in range(n_classes)]
    for a in range(n_classes):
        for b in range(a + 1, n_classes):
            rows += [members[a], members[b]]
            ys += [np.ones(len(members[a]), np.int32), -np.ones(len(members[b]), np.int32)]
            offsets.append(offsets[-1] + len(members[a]) + len(members[b]))
            pairs.append((a, b))
    return Problems(np.concatenate(rows).astype(np.int32), np.concatenate(ys),
                    np.asarray(offsets, np.int32), pairs)


def default_max_iter(problems: Problems) -> int:
    """libsvm's cap: ``max(10**7, 100 l)`` for the largest dual."""
    return max(10_000_000, 100 * int(np.diff(problems.offsets).max(initial=0)))


def _rho(a: list, g: list, y: list) -> float:
    """libsvm's ``calculate_rho``, summed in index order (its ``min`` and
    ``max`` keep the second of two equal values, as here)."""
    ub, lb, sum_free, nr_free = np.inf, -np.inf, 0.0, 0
    for at, gt, yt in zip(a, g, y):
        yg = float(yt) * gt
        if at >= C:
            if yt == -1:
                ub = ub if ub < yg else yg
            else:
                lb = lb if lb > yg else yg
        elif at <= 0.0:
            if yt == 1:
                ub = ub if ub < yg else yg
            else:
                lb = lb if lb > yg else yg
        else:
            nr_free += 1
            sum_free += yg
    return sum_free / nr_free if nr_free > 0 else (ub + lb) / 2


def _last(mask: torch.Tensor) -> int:
    return int(torch.nonzero(mask)[-1, 0])


def _solve_plain(kk: torch.Tensor, y: np.ndarray, eps: float, max_iter: int
                 ) -> tuple[torch.Tensor, float, int]:
    """One dual on its Gram block ``kk`` (l, l) float64 (CPU)."""
    l = len(y)
    yy = torch.from_numpy(y.astype(np.float64))
    pos = yy > 0
    qd = kk.diagonal().clone()
    a = torch.zeros(l, dtype=torch.float64)
    g = torch.full((l,), -1.0, dtype=torch.float64)
    inf = torch.tensor(np.inf, dtype=torch.float64)
    it = 0
    while it < max_iter:
        up = torch.where(pos, a < C, a > 0.0)
        vals = torch.where(up, torch.where(pos, -g, g), -inf)
        gmax = float(vals.max())
        i = -1 if gmax == -np.inf else _last(vals == gmax)
        low = torch.where(pos, a > 0.0, a < C)
        g2 = torch.where(pos, g, -g)
        gmax2 = float(torch.where(low, g2, -inf).max())
        j = -1
        if i != -1:
            gd = gmax + g2
            quad = (qd[i] + qd) - 2.0 * kk[i]
            nsq = -(gd * gd)
            obj = torch.where(quad > 0.0, nsq / quad, div(nsq, TAU))
            cand = low & (gd > 0.0)
            if bool(cand.any()):
                objm = torch.where(cand, obj, inf)
                j = _last(cand & (objm == objm.min()))
        if gmax + gmax2 < eps or j == -1:
            break
        it += 1
        yi, yj = int(y[i]), int(y[j])
        qij = float(yi * yj) * float(kk[i, j])
        qdi, qdj = float(qd[i]), float(qd[j])
        gi, gj = float(g[i]), float(g[j])
        old_i, old_j = float(a[i]), float(a[j])
        ai, aj = old_i, old_j
        if yi != yj:
            quad_ij = qdi + qdj + 2.0 * qij
            if quad_ij <= 0.0:
                quad_ij = TAU
            delta = (-gi - gj) / quad_ij
            diff = ai - aj
            ai += delta
            aj += delta
            if diff > 0.0:
                if aj < 0.0:
                    aj, ai = 0.0, diff
            elif ai < 0.0:
                ai, aj = 0.0, -diff
            if diff > C - C:
                if ai > C:
                    ai, aj = C, C - diff
            elif aj > C:
                aj, ai = C, C + diff
        else:
            quad_ij = qdi + qdj - 2.0 * qij
            if quad_ij <= 0.0:
                quad_ij = TAU
            delta = (gi - gj) / quad_ij
            total = ai + aj
            ai -= delta
            aj += delta
            if total > C:
                if ai > C:
                    ai, aj = C, total - C
            elif aj < 0.0:
                aj, ai = 0.0, total
            if total > C:
                if aj > C:
                    aj, ai = C, total - C
            elif ai < 0.0:
                ai, aj = 0.0, total
        a[i], a[j] = ai, aj
        dai, daj = ai - old_i, aj - old_j
        qi = (float(yi) * yy) * kk[i]
        qj = (float(yj) * yy) * kk[j]
        g = g + (qi * dai + qj * daj)
    return a, _rho(a.tolist(), g.tolist(), y.tolist()), it


def svm_smo_plain(gram: torch.Tensor, problems: Problems, tol: float = 1e-3
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(alpha float64 (rows,), rho float64 (pairs,), steps int64 (pairs,))
    of every dual, on the CPU, step for step as the kernel (module
    doc)."""
    gram = gram.detach().to("cpu", torch.float64)
    max_iter = default_max_iter(problems)
    alphas, rhos, steps = [], [], []
    for p in range(len(problems.pairs)):
        o0, o1 = int(problems.offsets[p]), int(problems.offsets[p + 1])
        r = torch.from_numpy(problems.rows[o0:o1].astype(np.int64))
        kk = gram.index_select(0, r).index_select(1, r)
        a, rho, it = _solve_plain(kk, problems.y[o0:o1], float(tol), max_iter)
        alphas.append(a)
        rhos.append(rho)
        steps.append(it)
    return (torch.cat(alphas) if alphas else torch.zeros(0, dtype=torch.float64),
            torch.tensor(rhos, dtype=torch.float64), torch.tensor(steps, dtype=torch.int64))


def svm_smo_launcher(gram: torch.Tensor, problems: Problems, tol: float = 1e-3,
                     counter=None):
    """``launch()`` of the SMO kernel on a CUDA float64 Gram matrix (n,
    n), returning alpha (float64 (rows,)); ``launch.rho`` and
    ``launch.steps`` hold the other outputs.  It counts in ``counter``'s
    record."""
    if gram.dtype != torch.float64 or gram.dim() != 2 or gram.shape[0] != gram.shape[1]:
        raise ValueError("svm_smo: the Gram matrix must be (n, n) float64")
    dev = gram.device
    gram = gram.contiguous()
    rows = torch.from_numpy(problems.rows).to(dev)
    ys = torch.from_numpy(problems.y).to(dev)
    offsets = torch.from_numpy(problems.offsets).to(dev)
    n_pairs = len(problems.pairs)
    rho = torch.empty(n_pairs, dtype=torch.float64, device=dev)
    steps = torch.empty(n_pairs, dtype=torch.int64, device=dev)
    grad = torch.empty(len(problems.rows), dtype=torch.float64, device=dev)
    alpha = torch.empty(len(problems.rows), dtype=torch.float64, device=dev)
    launch = bind_launch("svm_smo", counter, (gram, rows, ys, offsets, grad, rho, steps, alpha),
                         gram.shape[0], n_pairs, C, float(tol), default_max_iter(problems))
    launch.rho, launch.steps = rho, steps
    return launch


def svm_smo(gram: torch.Tensor, problems: Problems, tol: float = 1e-3
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(alpha, rho, steps) of every one-vs-one dual on the Gram matrix:
    :func:`svm_smo_plain` on a CPU tensor, the kernel
    ``csrc/svm_smo.cu`` on a CUDA one."""
    if gram.device.type == "cpu":
        return svm_smo_plain(gram, problems, tol)
    launch = svm_smo_launcher(gram, problems, tol, counter=svm_smo)
    return launch(), launch.rho, launch.steps


svm_smo.launches = 0


@dataclasses.dataclass
class SVCModel:
    """A fitted one-vs-one RBF SVC: ``classes``, ``gamma``, the support
    vectors ``sv`` (m, F) float64 on the device with their training rows
    ``support``, ``coef`` (m, pairs) = alpha * y of each pair (0 outside
    it), ``rho`` (pairs,), the ``pairs`` and the SMO ``steps``."""

    classes: np.ndarray
    gamma: float
    support: np.ndarray
    sv: torch.Tensor
    coef: torch.Tensor
    rho: torch.Tensor
    pairs: list[tuple[int, int]]
    steps: np.ndarray


def fit_svc(x_train, y_train, device: "str | torch.device" = "cuda", tol: float = 1e-3
            ) -> SVCModel:
    """``SVC(kernel="rbf", gamma="scale", tol=tol)`` on ``device`` (the
    module doc)."""
    x = np.asarray(x_train, np.float64)
    classes, y_enc = np.unique(np.asarray(y_train), return_inverse=True)
    if len(classes) < 2:
        raise ValueError(f"svm needs at least two classes, got {len(classes)}")
    gamma = svc_gamma(x)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    gram = rbf_kernel(xt, xt, gamma, same=True)
    problems = ovo_problems(y_enc, len(classes))
    alpha, rho, steps = svm_smo(gram, problems, tol)
    coef = torch.zeros((len(x), len(problems.pairs)), dtype=torch.float64, device=gram.device)
    rows = torch.from_numpy(problems.rows.astype(np.int64)).to(gram.device)
    signs = torch.from_numpy(problems.y.astype(np.float64)).to(gram.device)
    for p in range(len(problems.pairs)):
        o0, o1 = int(problems.offsets[p]), int(problems.offsets[p + 1])
        coef[rows[o0:o1], p] = alpha[o0:o1] * signs[o0:o1]
    support = np.flatnonzero((coef != 0).any(dim=1).cpu().numpy())
    keep = torch.from_numpy(support).to(gram.device)
    return SVCModel(classes=classes, gamma=gamma, support=support,
                    sv=xt.index_select(0, keep), coef=coef.index_select(0, keep),
                    rho=rho.to(gram.device), pairs=problems.pairs,
                    steps=steps.cpu().numpy())


def svc_decision(model: SVCModel, x) -> torch.Tensor:
    """The one-vs-one decision values (N, pairs) float64 of ``x`` on the
    model's device, libsvm's sign: positive votes for the pair's first
    class."""
    dev = model.sv.device
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    out = []
    for s in range(0, x.shape[0], DECISION_CHUNK):
        xc = x[s:s + DECISION_CHUNK].to(dev, torch.float64)
        out.append(rbf_kernel(xc, model.sv, model.gamma) @ model.coef - model.rho)
    if not out:
        return torch.zeros((0, len(model.pairs)), dtype=torch.float64, device=dev)
    return torch.cat(out)


def ovo_votes(dec: torch.Tensor, pairs: list[tuple[int, int]], n_classes: int
              ) -> torch.Tensor:
    """The class index (int64) each row's one-vs-one decision values
    vote for: most votes, ties to the lowest index."""
    votes = torch.zeros((dec.shape[0], n_classes), dtype=torch.int64, device=dec.device)
    for p, (a, b) in enumerate(pairs):
        first = (dec[:, p] > 0).long()
        votes[:, a] += first
        votes[:, b] += 1 - first
    return torch.argmax(votes, dim=1)  # the first of equal counts


def svc_predict(model: SVCModel, x) -> torch.Tensor:
    """Class index (int64, into ``model.classes``) of every row of ``x``."""
    return ovo_votes(svc_decision(model, x), model.pairs, len(model.classes))
