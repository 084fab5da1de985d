"""The port's random forest and SVM against scikit-learn, on the CPU.

The JAX package's classification tool trains scikit-learn's
``RandomForestClassifier(n_estimators=100, random_state=0)`` and
``SVC(kernel="rbf", gamma="scale")``; the port reproduces both without
it (``tmlibrary_tpu_torch/tools/forest.py``, ``tools/svm.py``).  Only
these tests import scikit-learn.

- The forest: the per-tree seeds and bootstraps, then every tree node
  for node (feature, threshold bit-equal, children, value, and the
  impurity, sample counts and the NaN direction of each split) on two
  and three classes, duplicated rows, a constant column, a perfectly
  separating column, tied values and the tool tests' six examples; the
  reference's own fitted trees through ``forest_from_arrays`` and the
  kernel's plain version give its ``predict_proba`` bit for bit and its
  ``predict``.
- The SVM: ``gamma`` within 1e-12; at ``tol=1e-9`` on both sides the
  decision values within 1e-6 and the same support vectors; at the
  default ``tol`` the classes by ``ovo_hold`` (``SVM_TIER``: libsvm stops
  at a KKT gap of 1e-3 with a single-precision kernel cache, so a
  pairwise decision value may move by about that much); the SMO plain
  version's steps and ``rho`` as libsvm reports them where no kernel
  entries tie.
"""

import numpy as np
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.ensemble._forest import _generate_sample_indices
from sklearn.svm import SVC

from chip_smoke import SVM_TIER, SmokeFailure, ovo_hold
from test_torch_analytics import feature_table, twin_stores
from test_torch_tools import EXAMPLES
from tmlibrary_tpu_torch.analytics.store import FeatureStore
from tmlibrary_tpu_torch.tools import forest, svm

torch.set_num_threads(2)

N_TREES = 100


def two_classes(r):
    x = r.normal(size=(200, 6)).astype(np.float32)
    return x, (x[:, 0] + 0.3 * r.normal(size=200) > 0).astype(np.int64)


def three_classes(r):
    x = r.normal(size=(240, 8)).astype(np.float32)
    return x, np.digitize(x[:, 1] + x[:, 2], [-0.5, 0.5])


def duplicated_rows(r):
    x, y = three_classes(r)
    return np.concatenate([x[:100], x[:100]]), np.concatenate([y[:100], y[:100]])


def constant_column(r):
    x, y = three_classes(r)
    x[:, 2] = 1.5
    return x, y


def separating_column(r):
    x = r.normal(size=(150, 5)).astype(np.float32)
    y = r.integers(0, 3, 150)
    x[:, 4] = y * 10.0
    return x, y


def tied_values(r):
    x, y = three_classes(r)
    x = (np.round(x * 2) / 2).astype(np.float32)
    x[:, 3] = np.float32(1.0) + np.float32(2**-23) * r.integers(0, 3, len(x))  # ulps apart
    return x, y


def tool_examples(r, tmp_path):
    port, _ = twin_stores(tmp_path, {"batch_000": feature_table(np.random.default_rng(21))})
    ids, x, _ = FeatureStore.ensure(port, "nuclei").standardized()
    lookup = {t: i for i, t in enumerate(zip(ids["site_index"].tolist(), ids["label"].tolist()))}
    rows = [lookup[(e["site_index"], e["label"])] for e in EXAMPLES]
    classes = sorted({e["class"] for e in EXAMPLES})
    return x[rows], np.array([classes.index(e["class"]) for e in EXAMPLES])


CASES = {"two_classes": two_classes, "three_classes": three_classes,
         "duplicated_rows": duplicated_rows, "constant_column": constant_column,
         "separating_column": separating_column, "tied_values": tied_values}


def case(name, tmp_path):
    r = np.random.default_rng(sorted(CASES).index(name) if name in CASES else 99)
    return tool_examples(r, tmp_path) if name == "tool_examples" else CASES[name](r)


def reference_forest(x, y):
    return RandomForestClassifier(n_estimators=N_TREES, random_state=0).fit(x, y)


def test_tree_seeds_and_bootstraps_match_the_reference():
    x, y = three_classes(np.random.default_rng(0))
    ref = reference_forest(x, y)
    seeds = forest.tree_seeds(N_TREES, 0)
    assert seeds == [e.random_state for e in ref.estimators_]
    n = len(x)
    for seed in seeds:
        np.testing.assert_array_equal(
            forest.bootstrap_weights(seed, n),
            np.bincount(_generate_sample_indices(seed, n, n, None), minlength=n))


@pytest.mark.parametrize("name", [*CASES, "tool_examples"])
def test_every_tree_matches_the_reference_node_for_node(name, tmp_path):
    x, y = case(name, tmp_path)
    ref = reference_forest(x, y)
    got = forest.fit_forest(x, y)
    np.testing.assert_array_equal(got.classes, ref.classes_)
    assert len(got.trees) == len(ref.estimators_) == N_TREES
    for k, (t, e) in enumerate(zip(got.trees, ref.estimators_)):
        tr = e.tree_
        assert len(t.feature) == tr.node_count, k
        np.testing.assert_array_equal(t.feature, tr.feature, err_msg=f"tree {k}")
        np.testing.assert_array_equal(t.threshold, tr.threshold, err_msg=f"tree {k}")
        np.testing.assert_array_equal(t.children_left, tr.children_left, err_msg=f"tree {k}")
        np.testing.assert_array_equal(t.children_right, tr.children_right, err_msg=f"tree {k}")
        np.testing.assert_array_equal(t.value, tr.value[:, 0, :], err_msg=f"tree {k}")
        np.testing.assert_array_equal(t.impurity, tr.impurity, err_msg=f"tree {k}")
        np.testing.assert_array_equal(t.n_node_samples, tr.n_node_samples, err_msg=f"tree {k}")
        np.testing.assert_array_equal(t.weighted_n_node_samples, tr.weighted_n_node_samples)
        inner = tr.children_left != forest.TREE_LEAF
        np.testing.assert_array_equal(t.missing_go_to_left[inner], tr.missing_go_to_left[inner])


def queries(r, f):
    q = r.normal(size=(3000, f)).astype(np.float32)
    q[::97, 0] = np.nan  # unknown values take the side the split recorded
    return q


@pytest.mark.parametrize("name", ["two_classes", "three_classes", "tied_values"])
def test_the_reference_trees_through_the_plain_inference(name, tmp_path):
    x, y = case(name, tmp_path)
    ref = reference_forest(x, y)
    trees = [e.tree_ for e in ref.estimators_]
    flat = forest.forest_from_arrays([t.feature for t in trees], [t.threshold for t in trees],
                                     [t.children_left for t in trees],
                                     [t.children_right for t in trees],
                                     [t.value for t in trees],
                                     [t.missing_go_to_left for t in trees])
    q = queries(np.random.default_rng(3), x.shape[1])
    idx, proba = forest.forest_predict_plain(torch.from_numpy(q), flat)
    np.testing.assert_array_equal(proba.numpy(), ref.predict_proba(q))
    np.testing.assert_array_equal(ref.classes_[idx.numpy()], ref.predict(q))
    # the port's own forest and the CPU wrapper: the same numbers
    got_idx, got_proba = forest.forest_predict(torch.from_numpy(q), forest.fit_forest(x, y).flat(),
                                               with_proba=True)
    np.testing.assert_array_equal(got_proba.numpy(), ref.predict_proba(q))
    np.testing.assert_array_equal(got_idx.numpy(), idx.numpy())
    assert forest.forest_predict.launches == 0  # the CPU takes the plain version


def test_forest_inference_refuses_what_the_kernel_does_not_take():
    x, y = two_classes(np.random.default_rng(1))
    flat = forest.fit_forest(x[:40], y[:40]).flat()
    with pytest.raises(ValueError, match="float32"):
        forest.forest_predict_launcher(torch.from_numpy(x).double(), flat)
    wide = forest.FlatForest(**{**flat.__dict__, "value": np.zeros((len(flat.feature), 40))})
    with pytest.raises(ValueError, match="classes"):
        forest.forest_predict_launcher(torch.from_numpy(x), wide)
    with pytest.raises(ValueError, match="columns"):
        forest.forest_predict_launcher(torch.from_numpy(x[:, :int(flat.feature.max())]), flat)
    with pytest.raises(ValueError, match="NaN"):
        forest.fit_forest(np.where(x > 2, np.nan, x), y)


@pytest.mark.parametrize("name", ["two_classes", "three_classes", "constant_column",
                                  "tool_examples"])
def test_gamma_matches_the_reference(name, tmp_path):
    x, y = case(name, tmp_path)
    ref = SVC(kernel="rbf", gamma="scale").fit(x, y)
    assert abs(svm.svc_gamma(x) - ref._gamma) <= 1e-12 * ref._gamma
    flat = np.full((5, 3), 2.0, np.float32)
    assert svm.svc_gamma(flat) == 1.0


def reference_ovo(ref, q):
    """sklearn's one-vs-one decision values in libsvm's sign (positive
    votes for the pair's first class)."""
    dec = ref.decision_function(q)
    return -dec[:, None] if len(ref.classes_) == 2 else dec


@pytest.mark.parametrize("name", ["two_classes", "three_classes", "duplicated_rows",
                                  "tool_examples"])
def test_svm_at_a_tight_tol_reaches_the_reference_optimum(name, tmp_path):
    x, y = case(name, tmp_path)
    ref = SVC(kernel="rbf", gamma="scale", tol=1e-9, decision_function_shape="ovo").fit(x, y)
    model = svm.fit_svc(x, y, device="cpu", tol=1e-9)
    q = np.random.default_rng(5).normal(size=(2000, x.shape[1])).astype(np.float32)
    got = svm.svc_decision(model, q).numpy()
    np.testing.assert_allclose(got, reference_ovo(ref, q), rtol=0, atol=1e-6)
    if name != "duplicated_rows":
        # (two copies of a row may share their alpha in any split: there the
        # optimum's support set is not unique, its decision values are)
        np.testing.assert_array_equal(model.support, np.sort(ref.support_))
    np.testing.assert_allclose(-model.rho.numpy(), ref.intercept_ * (
        -1 if len(ref.classes_) == 2 else 1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", [*CASES, "tool_examples"])
def test_svm_classes_hold_to_the_reference_at_the_default_tol(name, tmp_path):
    x, y = case(name, tmp_path)
    ref = SVC(kernel="rbf", gamma="scale", decision_function_shape="ovo").fit(x, y)
    model = svm.fit_svc(x, y, device="cpu")
    q = np.concatenate([x, np.random.default_rng(6).normal(size=(3000, x.shape[1]))
                        .astype(np.float32)])
    got = model.classes[svm.svc_predict(model, q).numpy()]
    want = ref.predict(q)
    ovo_hold(f"svm {name}", got, want, svm.svc_decision(model, q).numpy(), reference_ovo(ref, q),
             SVM_TIER)


def test_ovo_hold_weighs_only_the_pairs_that_flipped():
    """A row's class may differ only where the pairs whose sign flipped
    lie near zero; another pair of the row near zero does not excuse it."""
    want_dec = np.array([[5e-4, 0.5, 0.5], [0.5, 5e-4, 0.5]])
    # row 0: pair (0, 1) flips near zero, 0 -> 1; row 1: pair (0, 1) flips
    # far from zero while pair (0, 2) sits near zero
    got_dec = np.array([[-5e-4, 0.5, 0.5], [-0.5, 5e-4, 0.5]])
    assert ovo_hold("near", [1, 0], [0, 0], got_dec, want_dec, SVM_TIER) == 1
    with pytest.raises(SmokeFailure, match="away from a tie"):
        ovo_hold("far", [1, 1], [0, 0], got_dec, want_dec, SVM_TIER)
    with pytest.raises(SmokeFailure):  # a class that moved with no pair flipped
        ovo_hold("none", [0, 1], [0, 0], want_dec, want_dec, SVM_TIER)


@pytest.mark.parametrize("name", ["two_classes", "three_classes", "constant_column",
                                  "tied_values"])
def test_smo_takes_libsvm_steps_on_untied_kernels(name, tmp_path):
    """Where no two kernel entries tie, the working sets are libsvm's and
    so are the step counts (its shrinking starts only after min(l, 1000)
    steps); duplicated rows or a column that separates the classes give
    equal entries, which libsvm's float32 cache may break the other way."""
    x, y = case(name, tmp_path)
    ref = SVC(kernel="rbf", gamma="scale").fit(x, y)
    model = svm.fit_svc(x, y, device="cpu")
    np.testing.assert_array_equal(model.steps, ref.n_iter_)
    np.testing.assert_allclose(-model.rho.numpy(), ref._intercept_, rtol=0, atol=1e-6)


def test_smo_plain_version_stops_at_its_tol():
    x, y = three_classes(np.random.default_rng(8))
    gram = svm.rbf_kernel(torch.from_numpy(x), torch.from_numpy(x), svm.svc_gamma(x), same=True)
    problems = svm.ovo_problems(y, 3)
    assert problems.pairs == [(0, 1), (0, 2), (1, 2)]
    alpha, rho, steps = svm.svm_smo(gram, problems)
    assert svm.svm_smo.launches == 0  # the CPU takes the plain version
    assert ((alpha >= 0) & (alpha <= 1.0)).all()
    loose = svm.svm_smo_plain(gram, problems, tol=1e-1)
    assert (loose[2] <= steps).all() and (steps > 0).all()
    # y . alpha = 0 in every dual (the equality constraint SMO keeps)
    for p in range(3):
        o0, o1 = problems.offsets[p], problems.offsets[p + 1]
        assert abs(float((alpha[o0:o1] * torch.from_numpy(problems.y[o0:o1]).double()).sum())) \
            < 1e-9
    with pytest.raises(ValueError, match="two classes"):
        svm.fit_svc(x, np.zeros(len(x)), device="cpu")


def test_the_port_trains_and_predicts_without_scikit_learn():
    """Both methods with ``sklearn`` (and JAX and the JAX package)
    unimportable, as on the card's machine."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "for banned in ('sklearn', 'jax', 'tmlibrary_tpu'):\n"
        "    sys.modules[banned] = None\n"
        "import numpy as np, torch\n"
        "from tmlibrary_tpu_torch.tools import forest, svm\n"
        "r = np.random.default_rng(0)\n"
        "x = r.normal(size=(60, 4)).astype(np.float32); y = (x[:, 0] > 0).astype(int)\n"
        "f = forest.fit_forest(x, y)\n"
        "p, _ = forest.forest_predict(torch.from_numpy(x), f.flat())\n"
        "m = svm.fit_svc(x, y, device='cpu')\n"
        "print((p.numpy() == y).mean(), (svm.svc_predict(m, x).numpy() == y).mean())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stdout + out.stderr
    forest_acc, svm_acc = map(float, out.stdout.split())
    assert forest_acc > 0.9 and svm_acc > 0.9
