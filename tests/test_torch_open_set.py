"""The port's open-set evaluation (``evaluation/open_set.py``, the native
matcher ``csrc/osod_eval.cpp``) and ``evaluation/metrics.py``'s
``subset_boxes`` / ``get_gtu_uu_metrics`` against the JAX package, on the
same temporary COCO JSON files (tests/test_open_set.py's fixtures and a
seeded synthetic scene with known and unknown objects).

Results must be equal: the metrics dicts (WI, AOSE, nOSE, E_BK, AP, P, R),
the prediction strings, the GTU / UU splits and the subsets. The native
matcher must equal its plain version, the numpy loops, on seeded random
problems (tests/test_open_set.py's generator).
"""

import copy
import json

import numpy as np
import pytest

from runia_core_tpu.evaluation import metrics as jax_metrics
from runia_core_tpu.evaluation import open_set as jax_open_set
from runia_core_tpu_torch import _kernels
from runia_core_tpu_torch.evaluation import metrics, open_set
import test_open_set as jax_suite
from test_open_set import ind_gt, make_coco, ood_gt  # noqa: F401 (fixtures)

IMG = 100
KNOWN = [(0, "car"), (1, "person"), (2, "bike")]


def _scene(tmp_path, seed, n_ind=6, n_ood=5):
    """A seeded scene: an InD COCO file over KNOWN, an OoD file whose objects
    are all unknown, and per-image predictions in the extractor's layout
    (boxes near the objects and stray ones, 3-class logits, two methods'
    scores)."""
    rng = np.random.RandomState(seed)

    def objects(images, n_cats):
        anns = []
        for im in images:
            for _ in range(rng.randint(1, 5)):
                x, y = rng.uniform(0, 60, 2)
                anns.append((im, int(rng.randint(n_cats)), [float(x), float(y), *rng.uniform(8, 35, 2).tolist()]))
        return anns

    ind_images, ood_images = list(range(1, n_ind + 1)), list(range(100, 100 + n_ood))
    ind_anns, ood_anns = objects(ind_images, 3), objects(ood_images, 2)
    ind_path = make_coco(tmp_path / f"ind{seed}.json", ind_images, ind_anns, KNOWN)
    ood_path = make_coco(tmp_path / f"ood{seed}.json", ood_images, ood_anns, [(0, "cow"), (1, "kite")])

    def predictions(images, anns):
        preds = {}
        for im in images:
            boxes = [[x + rng.normal(0, 2), y + rng.normal(0, 2), x + w + rng.normal(0, 2), y + h + rng.normal(0, 2)]
                     for a_im, _, (x, y, w, h) in anns if a_im == im]
            for _ in range(rng.randint(0, 3)):
                (x1, x2), (y1, y2) = np.sort(rng.uniform(0, IMG, 2)), np.sort(rng.uniform(0, IMG, 2))
                boxes.append([x1, y1, x2, y2])
            boxes = np.array(boxes, float)
            n = len(boxes)
            preds[im] = {"boxes": boxes, "logits": rng.randn(n, 3) * 2,
                         "md": rng.randn(n).tolist(), "energy": (rng.randn(n) + 1).tolist()}
        return preds

    return ind_path, ood_path, {"valid": predictions(ind_images, ind_anns)}, {"oodset": predictions(ood_images,
                                                                                                     ood_anns)}


def _overall(module, ind_path, ood_path, ind_data, ood_data, **kw):
    return module.get_overall_open_set_results(
        ind_dataset_name="ind", ind_gt_annotations_path=ind_path, ind_data_dict=ind_data, ood_data_dict=ood_data,
        ood_datasets_names=["oodset"], ood_annotations_paths={"oodset": ood_path}, methods_names=["md", "energy"],
        methods_thresholds={"md": 0.0, "energy": 1.0}, metric_2007=kw.pop("metric_2007", False),
        evaluate_on_ind=True, get_known_classes_metrics=True, is_open_set_model=False, **kw)


@pytest.mark.parametrize("seed,metric_2007,min_conf", [(0, False, None), (1, True, None), (2, False, 0.4)])
def test_overall_results_equal_jax(tmp_path, seed, metric_2007, min_conf):
    ind_path, ood_path, ind_data, ood_data = _scene(tmp_path, seed)
    got = _overall(open_set, ind_path, ood_path, ind_data, ood_data, metric_2007=metric_2007, min_conf_score=min_conf)
    want = _overall(jax_open_set, ind_path, ood_path, ind_data, ood_data, metric_2007=metric_2007,
                    min_conf_score=min_conf)
    assert got == want
    assert {"WI", "AOSE", "nOSE", "E_BK", "AP_U", "P_U", "R_U"} <= set(got["oodset"]["md"])
    assert {"mAP", "AP_K", "P_K", "R_K"} <= set(got["ind"]["md"])
    flat = open_set.convert_osod_results_for_mlflow_logging(got, ["oodset"], ["md", "energy"])
    assert flat == jax_open_set.convert_osod_results_for_mlflow_logging(want, ["oodset"], ["md", "energy"])


def test_the_evaluator_stores_the_jax_strings_and_metrics(tmp_path):
    ind_path, ood_path, _, ood_data = _scene(tmp_path, 3)
    evaluators = [module.OpenSetEvaluator("ind", ind_path, metric_2007=False) for module in (open_set, jax_open_set)]
    for evaluator, module in zip(evaluators, (open_set, jax_open_set)):
        module._fill_evaluator(evaluator, ood_data["oodset"], "md", 0.0, False, None, False, None, True)
    assert dict(evaluators[0]._predictions) == dict(evaluators[1]._predictions)
    assert any("." in line for lines in evaluators[0]._predictions.values() for line in lines)
    got = evaluators[0].evaluate(ood_path, is_ood=True, get_known_classes_metrics=True)
    assert got == evaluators[1].evaluate(ood_path, is_ood=True, get_known_classes_metrics=True)
    loops = open_set.OpenSetEvaluator("ind", ind_path, metric_2007=False, native=False)
    loops._predictions = evaluators[0]._predictions
    assert loops.evaluate(ood_path, is_ood=True, get_known_classes_metrics=True) == got
    gtu, uu = evaluators[0].get_boxes_gtu_uu(ood_path, is_ood=True)
    want_gtu, want_uu = evaluators[1].get_boxes_gtu_uu(ood_path, is_ood=True)
    np.testing.assert_array_equal(gtu, want_gtu)
    np.testing.assert_array_equal(uu, want_uu)


def test_the_jax_suites_cases_give_the_jax_results(ind_gt, ood_gt):  # noqa: F811
    """tests/test_open_set.py's hand-made cases, through both modules."""
    lines = ["1 0.900 11.0 11.0 40.0 40.0 0.500", "2 0.800 21.0 21.0 60.0 60.0 0.400",
             "1 0.700 80.0 80.0 95.0 95.0 0.100"]
    for classname, is_ood, path in (("car", False, ind_gt), ("person", False, ind_gt), ("unknown", True, ood_gt)):
        for use_07 in (False, True):
            got = open_set.voc_eval(lines, open_set.COCOParser(path), classname, 0.5, use_07, is_ood)
            want = jax_open_set.voc_eval(lines, jax_open_set.COCOParser(path), classname, 0.5, use_07, is_ood)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g, dtype=object), np.asarray(w, dtype=object))
    rec, prec = np.array([0.25, 0.5, 0.75, 1.0]), np.array([1.0, 0.5, 0.75, 0.6])
    assert open_set.voc_ap(rec, prec, False) == jax_open_set.voc_ap(rec, prec, False)
    assert open_set.voc_ap(rec, prec, True) == jax_open_set.voc_ap(rec, prec, True)
    parser = open_set.COCOParser(ind_gt, using_subset=[1])
    assert parser.get_imgIds() == [1] and parser.get_img_ids_per_cat_name("car") == [1]
    assert open_set.get_n_unk_ood_dataset(ood_gt) == jax_open_set.get_n_unk_ood_dataset(ood_gt) == 2
    logits = np.random.RandomState(0).randn(5, 21)
    for g, w in zip(open_set.get_labels_and_scores_from_logits(logits),
                    jax_open_set.get_labels_and_scores_from_logits(logits)):
        np.testing.assert_array_equal(g, w)


def test_tables_equal_jax(tmp_path):
    ind_path, ood_path, ind_data, ood_data = _scene(tmp_path, 4)
    results = _overall(open_set, ind_path, ood_path, ind_data, ood_data)["oodset"]
    for save in (False, True):
        got = open_set.convert_osod_results_to_pandas_df(results, ["md", "energy"], save)
        assert got.equals(jax_open_set.convert_osod_results_to_pandas_df(results, ["md", "energy"], save))
    got = open_set.convert_osod_results_to_hierarchical_pandas_df(results, results, ["md"], False, ["a", "b"])
    assert got.equals(jax_open_set.convert_osod_results_to_hierarchical_pandas_df(results, results, ["md"], False,
                                                                                   ["a", "b"]))
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    table = open_set.convert_osod_results_to_pandas_df(results, ["md", "energy"], False)
    fig = open_set.plot_two_osod_datasets_metrics(table, table, ["md", "energy"], ["a", "b"], ["AOSE", "WI"], False)
    assert len(fig.axes[0].patches) == 2 * 2 * 2
    fig = open_set.plot_two_osod_datasets_per_metric(table, table, ["md", "energy"], ["a", "b"], "WI", False)
    assert len(fig.axes[0].patches) == 2 * 2


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_matcher_equals_the_numpy_loops(seed):
    """The native matcher against its plain version on seeded random
    problems (missing images, difficult objects, empty images): TP / FP
    flags, recall, precision and AP equal; the unknown-overlap flags too."""
    image_ids, bb, recs = jax_suite.TestNativeOsodParity._random_problem(seed)
    npos = int(sum((~r["difficult"]).sum() for r in recs.values()))
    for thresh in (0.35, 0.5):
        got = open_set._greedy_match(image_ids, bb, copy.deepcopy(recs), thresh, npos, bool(seed % 2))
        want = open_set._greedy_match(image_ids, bb, copy.deepcopy(recs), thresh, npos, bool(seed % 2), native=False)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        got = open_set._mark_unknown_overlaps(len(image_ids), image_ids, bb, recs, thresh)
        want = open_set._mark_unknown_overlaps(len(image_ids), image_ids, bb, recs, thresh, native=False)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[2], want[2])
    nd, *_, ap, tp, fp = open_set._greedy_match([], np.empty((0, 4)), recs, 0.5, 10, False)
    assert nd == 0 and ap == 0.0


def test_the_matcher_is_built_from_the_ports_source_and_a_failed_build_raises(monkeypatch, tmp_path):
    module = _kernels.osod_matcher()
    assert module.__name__ == "_runia_osod" and str(_kernels.BUILD_DIR) in module.__file__
    assert "PyInit__runia_osod" in (_kernels.CSRC / "osod_eval.cpp").read_text()
    _kernels.osod_matcher.cache_clear()
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "/bin/false")
    try:
        with pytest.raises(RuntimeError, match="open-set matcher"):
            _kernels.osod_matcher()
    finally:
        _kernels.osod_matcher.cache_clear()


def _box_dicts(seed, n_train=300, n_valid=120, n_ood=200, d=6):
    rng = np.random.RandomState(seed)
    ind = {f"{split} {kind}": rng.randn(n, d if kind != "logits" else 3)
           for split, n in (("train", n_train), ("valid", n_valid)) for kind in ("latent_space_means", "logits",
                                                                                  "features")}
    ood = {f"noise {kind}": rng.randn(n_ood, d) for kind in ("latent_space_means", "logits", "features")}
    ids = {"valid": list(rng.randint(0, 30, n_valid))}
    ood_ids = {"noise": list(rng.randint(0, 40, n_ood))}
    return ind, ood, ids, ood_ids


def test_subset_boxes_equals_jax():
    for with_ids in (False, True):
        out = []
        for module in (metrics, jax_metrics):
            ind, ood, ids, ood_ids = _box_dicts(0)
            out.append(module.subset_boxes(ind, ood, 100, 60, 5, ["noise"], *((ids, ood_ids) if with_ids else ())))
        got, want = out
        assert len(got) == len(want) == (4 if with_ids else 2)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
        assert got[0]["train latent_space_means"].shape[0] == 100 and got[1]["noise features"].shape[0] == 60


def test_get_gtu_uu_metrics_equals_jax(tmp_path):
    ind_path, ood_path, ind_data, ood_data = _scene(tmp_path, 5)
    kw = dict(ind_dataset_name="ind", ind_gt_annotations_path=ind_path, ind_data_dict=ind_data,
              ood_data_dict=ood_data, ood_datasets_names=["oodset"], ood_annotations_paths={"oodset": ood_path},
              methods_names=["md", "energy"], metric_2007=False)
    got, want = metrics.get_gtu_uu_metrics(**kw), jax_metrics.get_gtu_uu_metrics(**kw)
    assert got == want and set(got["oodset"]["md"]) == {"gtu", "uu"}
    assert json.dumps(got, sort_keys=True)
