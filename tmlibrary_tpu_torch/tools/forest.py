"""The classification tool's random forest: induction on the host, and
inference over every object in a CUDA kernel.

Counterpart: ``method: randomforest`` of
``tmlibrary_tpu/tools/classification.py``, which trains scikit-learn's
``RandomForestClassifier(n_estimators=100, random_state=0)``.  The port
runs without scikit-learn and reproduces that forest tree for tree:

- the per-tree seeds are drawn from ``RandomState(random_state)`` one
  ``randint(2**31 - 1)`` a tree, as ``BaseEnsemble._make_estimator``
  draws them; each tree's bootstrap is ``RandomState(seed).randint(0, n,
  n)``, counted into integer sample weights (``_generate_sample_indices``,
  ``_parallel_build_trees``), and its splitter's xorshift state is the
  first ``randint(0, 2**31 - 1)`` of a fresh ``RandomState(seed)``
  (``Splitter.init``);
- each node is split as the dense ``BestSplitter`` splits it: the
  samples of positive weight only; the Fisher-Yates feature draw of
  ``rand_int`` with its known, drawn and found constant features, the
  constants handed down to the children; a feature is constant when its
  largest value is at most its smallest plus ``FEATURE_THRESHOLD``
  (1e-7 added in float32); a split lies between two sorted values more
  than ``FEATURE_THRESHOLD`` apart; the Gini proxy ``-w_R g_R - w_L g_L``
  in float64, the first (feature in draw order, position) of the
  largest proxy winning, as the reference's strict ``>`` keeps it; the
  threshold ``v[p-1]/2 + v[p]/2`` in float64; unknown (NaN) values at
  prediction go to the child that took more training samples;
- the nodes are numbered in ``DepthFirstTreeBuilder``'s order (the left
  subtree before the right), which is also the order in which the
  splitter's random state and constant-feature arrays run on; a node is
  a leaf when it holds fewer than 2 samples or its Gini is at most the
  float64 epsilon; its ``value`` is the class weights over the node's
  weight.

Features are float32 (the reference's ``DTYPE``) and thresholds float64.
The class weights of a node are sums of integer bootstrap counts, exact
in float64 in any order, so the split search sums them with ``cumsum``
over the sorted samples; the proxies, thresholds and values are the
reference's float64 expressions evaluated term by term.

Induction runs on the host in numpy, as the reference's does: its random
draws run from node to node in sequence, and its input is the labelled
examples (hundreds of rows), so nothing in it grows with the store.
What grows with the store is predicting every object, and that runs on
the tool's device: :func:`forest_predict` launches
``csrc/forest_predict.cu`` on a CUDA tensor (one thread an object walks
the trees in order, sums each leaf's class fractions in float64, divides
by the tree count and takes the first largest) and
:func:`forest_predict_plain`, the same arithmetic in PyTorch, on a CPU
tensor.  :func:`forest_from_arrays` takes any fitted trees' arrays (the
reference's ``tree_`` attributes) into the same flattened forest, so the
inference can be held alone against the reference's own trees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmlibrary_tpu_torch.ops._cuda import bind_launch
from tmlibrary_tpu_torch.ops._exact import div

#: the reference's constants (``tree/_utils.pxd``, ``tree/_partitioner.pxd``,
#: ``tree/_tree.pyx``, ``ensemble/_forest.py``)
RAND_R_MAX = 2147483647
FEATURE_THRESHOLD = np.float32(1e-7)
EPSILON = np.finfo(np.float64).eps
MAX_INT = np.iinfo(np.int32).max
TREE_LEAF = -1
TREE_UNDEFINED = -2

#: the reference's forest: ``RandomForestClassifier(n_estimators=100,
#: random_state=0)``
N_ESTIMATORS, RANDOM_STATE = 100, 0
#: classes the forest kernel sums in registers
MAX_CLASSES = 32


@dataclasses.dataclass
class Tree:
    """One fitted tree in the reference's layout (``tree_`` attributes):
    leaves have children ``-1``, feature ``-2`` and threshold ``-2.0``;
    ``value`` is (nodes, classes), the class fractions of each node."""

    feature: np.ndarray
    threshold: np.ndarray
    children_left: np.ndarray
    children_right: np.ndarray
    value: np.ndarray
    missing_go_to_left: np.ndarray
    impurity: np.ndarray
    n_node_samples: np.ndarray
    weighted_n_node_samples: np.ndarray


@dataclasses.dataclass
class Forest:
    """The fitted trees and the class labels they predict."""

    classes: np.ndarray
    trees: list[Tree]

    def flat(self) -> "FlatForest":
        return forest_from_arrays([t.feature for t in self.trees],
                                  [t.threshold for t in self.trees],
                                  [t.children_left for t in self.trees],
                                  [t.children_right for t in self.trees],
                                  [t.value for t in self.trees],
                                  [t.missing_go_to_left for t in self.trees])


@dataclasses.dataclass
class FlatForest:
    """Every tree's nodes in one set of arrays: node ``n`` of tree ``t``
    at ``roots[t] + n``, children as global indices (``-1`` at a leaf),
    ``value`` (nodes, classes) float64."""

    feature: np.ndarray        # int32
    threshold: np.ndarray      # float64
    left: np.ndarray           # int32
    right: np.ndarray          # int32
    missing_left: np.ndarray   # uint8
    value: np.ndarray          # float64 (nodes, classes)
    roots: np.ndarray          # int32 (trees,)

    @property
    def n_trees(self) -> int:
        return len(self.roots)

    @property
    def n_classes(self) -> int:
        return self.value.shape[1]

    def tensors(self, device) -> dict:
        """The arrays as contiguous tensors on ``device``."""
        names = ("feature", "threshold", "left", "right", "missing_left", "value", "roots")
        return {k: torch.from_numpy(np.ascontiguousarray(getattr(self, k))).to(device)
                for k in names}

    def nbytes(self) -> int:
        return sum(getattr(self, k).nbytes for k in (
            "feature", "threshold", "left", "right", "missing_left", "value", "roots"))


def forest_from_arrays(feature, threshold, children_left, children_right, value,
                       missing_go_to_left=None) -> FlatForest:
    """The flattened forest of fitted trees given as per-tree arrays in
    the reference's layout (``tree_.feature``, ``.threshold``,
    ``.children_left``, ``.children_right``, ``.value`` of shape (nodes,
    classes) or (nodes, 1, classes), and ``.missing_go_to_left``; without
    it unknown values go right)."""
    if missing_go_to_left is None:
        missing_go_to_left = [np.zeros(len(f), np.uint8) for f in feature]
    sizes = [len(f) for f in feature]
    roots = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)

    def shifted(children):
        return np.concatenate([np.where(np.asarray(c) == TREE_LEAF, TREE_LEAF,
                                        np.asarray(c, np.int64) + r)
                               for c, r in zip(children, roots)]).astype(np.int32)

    values = [np.asarray(v, np.float64).reshape(len(v), -1) for v in value]
    return FlatForest(
        feature=np.concatenate([np.asarray(f) for f in feature]).astype(np.int32),
        threshold=np.concatenate([np.asarray(t, np.float64) for t in threshold]),
        left=shifted(children_left),
        right=shifted(children_right),
        missing_left=np.concatenate([np.asarray(m) for m in missing_go_to_left]).astype(np.uint8),
        value=np.ascontiguousarray(np.concatenate(values)),
        roots=roots,
    )


# ---------------------------------------------------------------- random draws
def tree_seeds(n_estimators: int, random_state: int = 0) -> list[int]:
    """Each tree's ``random_state``, in tree order."""
    rs = np.random.RandomState(random_state)
    return [int(rs.randint(MAX_INT)) for _ in range(n_estimators)]


def bootstrap_weights(seed: int, n_samples: int) -> np.ndarray:
    """The tree's bootstrap as float64 sample weights (draw counts)."""
    idx = np.random.RandomState(seed).randint(0, n_samples, n_samples).astype(np.int32)
    return np.bincount(idx, minlength=n_samples).astype(np.float64)


class _RandR:
    """The splitter's 32-bit xorshift (``our_rand_r``) and ``rand_int``."""

    def __init__(self, seed: int):
        self.state = int(np.random.RandomState(seed).randint(0, RAND_R_MAX)) & 0xFFFFFFFF

    def next(self) -> int:
        s = self.state or 1  # DEFAULT_SEED: the state is never 0
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        self.state = s
        return s % (RAND_R_MAX + 1)

    def rand_int(self, low: int, high: int) -> int:
        return low + self.next() % (high - low)


# ------------------------------------------------------------------ induction
def _gini(counts: np.ndarray, weight) -> np.ndarray:
    """``1 - sum_c count_c**2 / w**2``, the squares summed in class order
    (counts (..., classes))."""
    sq = np.zeros(counts.shape[:-1])
    for c in range(counts.shape[-1]):
        sq = sq + counts[..., c] * counts[..., c]
    return 1.0 - sq / (weight * weight)


class _Splitter:
    """``BestSplitter`` over one tree's dense float32 ``x``: the feature
    permutation and the constant features persist from node to node."""

    def __init__(self, x: np.ndarray, y: np.ndarray, weight: np.ndarray, n_classes: int,
                 max_features: int, seed: int):
        self.x, self.y, self.weight = x, y, weight
        self.n_classes, self.max_features = n_classes, max_features
        self.rand = _RandR(seed)
        self.features = list(range(x.shape[1]))
        self.constant = [0] * x.shape[1]
        self.total_weight = float(weight.sum())

    def draw(self, xn: np.ndarray, n_known: int) -> tuple[list[int], int]:
        """The node's feature draw: the non-constant features to search,
        in draw order, and the constant count handed to the children."""
        feats = self.features
        n_feat = len(feats)
        lo, hi = xn.min(axis=0), xn.max(axis=0)
        is_const = hi <= lo + FEATURE_THRESHOLD
        f_i, n_visited, n_found, n_drawn, n_total = n_feat, 0, 0, 0, n_known
        searched = []
        while f_i > n_total and (n_visited < self.max_features
                                 or n_visited <= n_found + n_drawn):
            n_visited += 1
            f_j = self.rand.rand_int(n_drawn, f_i - n_found)
            if f_j < n_known:
                feats[n_drawn], feats[f_j] = feats[f_j], feats[n_drawn]
                n_drawn += 1
                continue
            f_j += n_found
            f = feats[f_j]
            if is_const[f]:
                feats[f_j], feats[n_total] = feats[n_total], feats[f_j]
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            feats[f_i], feats[f_j] = feats[f_j], feats[f_i]
            searched.append(f)
        # the known constants keep their order for siblings and children;
        # the new ones are appended
        feats[:n_known] = self.constant[:n_known]
        self.constant[n_known:n_known + n_found] = feats[n_known:n_known + n_found]
        return searched, n_total

    def split(self, idx: np.ndarray, xn: np.ndarray, searched: list[int], sums: np.ndarray,
              wn: float):
        """The best split of the node over ``searched``: (feature,
        threshold, position, left gini, right gini), or None."""
        if not searched:
            return None
        v = xn[:, searched]                                   # (n, k) float32
        order = np.argsort(v, axis=0, kind="stable")
        vs = np.take_along_axis(v, order, axis=0)
        w = self.weight[idx][order]                           # (n, k)
        onehot = np.eye(self.n_classes)[self.y[idx][order]]   # (n, k, C)
        left = np.cumsum(onehot * w[..., None], axis=0)[:-1]  # left of positions 1..n-1
        w_left = np.cumsum(w, axis=0)[:-1]
        w_right = wn - w_left
        right = sums - left
        g_left, g_right = _gini(left, w_left), _gini(right, w_right)
        proxy = -w_right * g_right - w_left * g_left
        valid = vs[1:] > vs[:-1] + FEATURE_THRESHOLD
        proxy = np.where(valid, proxy, -np.inf)
        best = proxy.max(axis=0)
        top = best.max()
        if top == -np.inf:
            return None
        j = int(np.argmax(best == top))
        p = int(np.argmax(proxy[:, j] == top))                # position p + 1
        threshold = float(vs[p, j]) / 2.0 + float(vs[p + 1, j]) / 2.0
        return searched[j], threshold, p + 1, float(g_left[p, j]), float(g_right[p, j])


def build_tree(x: np.ndarray, y: np.ndarray, weight: np.ndarray, n_classes: int,
               max_features: int, seed: int) -> Tree:
    """One tree grown depth first from float32 ``x``, class indices
    ``y`` and float64 sample ``weight``, the splitter seeded from
    ``seed`` (see the module doc)."""
    sp = _Splitter(x, y, weight, n_classes, max_features, seed)
    nodes: list[list] = []   # feature, threshold, left, right, mgl, impurity, n, wn
    values: list[np.ndarray] = []
    stack = [(np.flatnonzero(weight != 0.0), -1, False, np.inf, 0)]
    first = True
    while stack:
        idx, parent, is_left, impurity, n_const = stack.pop()
        w = weight[idx]
        sums = np.bincount(y[idx], weights=w, minlength=n_classes).astype(np.float64)
        wn = float(w.sum())
        if first:
            impurity = float(_gini(sums, wn))
            first = False
        split = None
        if len(idx) >= 2 and impurity > EPSILON:
            xn = x[idx]
            searched, n_const = sp.draw(xn, n_const)
            split = sp.split(idx, xn, searched, sums, wn)
            if split is not None:
                f, thr, pos, g_l, g_r = split
                goes_left = x[idx, f].astype(np.float64) <= thr
                w_l = float(w[goes_left].sum())
                w_r = wn - w_l
                improvement = (wn / sp.total_weight) * (impurity - (w_r / wn * g_r)
                                                        - (w_l / wn * g_l))
                if improvement + EPSILON < 0.0:
                    split = None
        node_id = len(nodes)
        if parent >= 0:
            nodes[parent][2 if is_left else 3] = node_id
        values.append(sums / wn)
        if split is None:
            nodes.append([TREE_UNDEFINED, float(TREE_UNDEFINED), TREE_LEAF, TREE_LEAF, 0,
                          impurity, len(idx), wn])
            continue
        # unknown values go where more training samples went
        nodes.append([f, thr, TREE_LEAF, TREE_LEAF, int(pos > len(idx) - pos),
                      impurity, len(idx), wn])
        stack.append((idx[~goes_left], node_id, False, g_r, n_const))
        stack.append((idx[goes_left], node_id, True, g_l, n_const))
    cols = list(zip(*nodes))
    return Tree(
        feature=np.asarray(cols[0], np.int64),
        threshold=np.asarray(cols[1], np.float64),
        children_left=np.asarray(cols[2], np.int64),
        children_right=np.asarray(cols[3], np.int64),
        value=np.asarray(values, np.float64),
        missing_go_to_left=np.asarray(cols[4], np.uint8),
        impurity=np.asarray(cols[5], np.float64),
        n_node_samples=np.asarray(cols[6], np.int64),
        weighted_n_node_samples=np.asarray(cols[7], np.float64),
    )


def fit_forest(x, y) -> Forest:
    """``RandomForestClassifier(n_estimators=100, random_state=0)`` with
    its defaults, fitted on the host: bootstrap, ``max_features="sqrt"``,
    Gini, no depth limit, ``min_samples_split=2``, ``min_samples_leaf=1``.
    ``x`` must be finite."""
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2 or not len(x):
        raise ValueError("fit_forest needs a non-empty (n, features) matrix")
    if not np.isfinite(x).all():
        raise ValueError("fit_forest: the training matrix holds NaN or inf")
    classes, y_enc = np.unique(np.asarray(y), return_inverse=True)
    max_features = max(1, int(np.sqrt(x.shape[1])))
    trees = [build_tree(x, y_enc.astype(np.int64), bootstrap_weights(seed, len(x)),
                        len(classes), max_features, seed)
             for seed in tree_seeds(N_ESTIMATORS, RANDOM_STATE)]
    return Forest(classes=classes, trees=trees)


# ------------------------------------------------------------------ inference
def forest_leaves_plain(x: torch.Tensor, forest: FlatForest):
    """The leaf (a global node index, int64 (N,)) each object of float32
    ``x`` (N, F) reaches in each tree, tree by tree: left when ``x[f] <=
    threshold`` in float64, an unknown value as ``missing_left`` says."""
    t = forest.tensors(x.device)
    pick = lambda name, node: t[name].index_select(0, node)  # noqa: E731
    for root in forest.roots.tolist():
        node = torch.full((x.shape[0],), root, dtype=torch.int64, device=x.device)
        while True:
            left = pick("left", node).long()
            inner = left != TREE_LEAF
            if not bool(inner.any()):
                break
            f = pick("feature", node).long().clamp_min(0)
            v = x.gather(1, f[:, None])[:, 0]
            go = torch.where(torch.isnan(v), pick("missing_left", node) != 0,
                             v.double() <= pick("threshold", node))
            node = torch.where(inner, torch.where(go, left, pick("right", node).long()), node)
        yield node


def forest_predict_plain(x: torch.Tensor, forest: FlatForest
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(class index int64 (N,), probabilities float64 (N, C)) of float32
    ``x`` (N, F): the leaves' class fractions
    (:func:`forest_leaves_plain`) summed in tree order in float64 and
    divided by the tree count; the first largest wins."""
    value = torch.from_numpy(forest.value).to(x.device)
    acc = torch.zeros((x.shape[0], forest.n_classes), dtype=torch.float64, device=x.device)
    for leaf in forest_leaves_plain(x, forest):
        acc = acc + value.index_select(0, leaf)
    proba = div(acc, float(forest.n_trees))  # a true division on the card too
    return torch.argmax(proba, dim=1), proba  # the first largest, as np.argmax


def forest_predict_launcher(x: torch.Tensor, forest: FlatForest, with_proba: bool = True,
                            counter=None, tensors: "dict | None" = None):
    """``launch()`` of the forest kernel on CUDA float32 ``x`` (N, F),
    returning the class indices (int64); ``launch.proba`` holds the
    probabilities (float64 (N, C)) when ``with_proba``.  ``tensors`` are
    the forest's arrays on the card (:meth:`FlatForest.tensors`), made
    here when not given; it counts in ``counter``'s record."""
    if forest.n_classes > MAX_CLASSES:
        raise ValueError(f"forest_predict: at most {MAX_CLASSES} classes on the card, got "
                         f"{forest.n_classes}")
    x = x.contiguous()
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("forest_predict: x must be a (N, F) float32 tensor")
    split_on = forest.feature[forest.left != TREE_LEAF]
    if split_on.size and (split_on.min() < 0 or split_on.max() >= x.shape[1]):
        raise ValueError(f"forest_predict: the forest splits on features "
                         f"{split_on.min()}..{split_on.max()}, x has {x.shape[1]} columns")
    t = tensors if tensors is not None else forest.tensors(x.device)
    n = x.shape[0]
    proba = torch.empty((n if with_proba else 1, forest.n_classes), dtype=torch.float64,
                        device=x.device)
    pred = torch.empty(n, dtype=torch.int64, device=x.device)
    launch = bind_launch("forest_predict", counter,
                         (x, t["feature"], t["threshold"], t["left"], t["right"],
                          t["missing_left"], t["value"], t["roots"], proba, pred),
                         n, x.shape[1], forest.n_classes, forest.n_trees, int(with_proba))
    launch.proba = proba if with_proba else None
    return launch


def forest_predict(x: torch.Tensor, forest: FlatForest, with_proba: bool = False
                   ) -> tuple[torch.Tensor, "torch.Tensor | None"]:
    """(class index int64 (N,), probabilities float64 (N, C) or None) of
    float32 ``x`` (N, F): :func:`forest_predict_plain` on a CPU tensor,
    the kernel ``csrc/forest_predict.cu`` on a CUDA one."""
    if x.device.type == "cpu":
        pred, proba = forest_predict_plain(x, forest)
        return pred, (proba if with_proba else None)
    launch = forest_predict_launcher(x, forest, with_proba, counter=forest_predict)
    return launch(), launch.proba


forest_predict.launches = 0
