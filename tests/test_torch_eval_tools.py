"""The port's analysis tools against strive_tpu's scripts, on the CPU.

- ``eval_planner`` on the tracked ``adv_sol_success`` scenarios plus 4
  regular synthetic scenes: ``all_eval_results.csv`` within 1e-5, the
  collision flags exact;
- ``eval_adv_gen --eval_quant`` over the tracked scenario results (all
  6 solved or attacked scenarios and 3 of the 17 failed ones), with
  strive_tpu's sklearn ``cluster.pkl``: ``per_seq_results.csv`` and
  ``total_results.csv`` within 1e-5, flags and cluster labels exact;
- ``compute_coll_feat`` within 1e-6 on every tracked scenario;
- the port's k-means (``strive_tpu_torch/kmeans.py``) against sklearn:
  Lloyd from given centers equals ``KMeans(init=centers, n_init=1)``
  (labels exact, centers within 1e-6); the full fit gives sklearn's
  partition up to relabelling and its inertia within 1e-6 relative, on
  the tracked scenarios and on seeded well-separated 4-D blobs;
- ``cluster_scenarios`` writes a ``cluster.pkl`` that the port's
  ``eval_adv_gen`` reads back with sklearn unimportable;
- the semantic cluster names and the labels file, equal;
- with matplotlib unimportable, ``cluster_scenarios`` and
  ``eval_adv_gen`` write everything but their chart.
"""

import csv
import glob
import importlib.util
import os
import sys

import numpy as np
import jax  # noqa: F401  (JAX on the CPU before torch's threads start)
import pytest
import torch  # noqa: F401

from strive_tpu_torch import kmeans
from strive_tpu_torch.data.scenario_json import read_adv_scenes
from strive_tpu_torch.scripts import cluster_scenarios as tclu
from strive_tpu_torch.scripts import eval_adv_gen as tadv
from strive_tpu_torch.scripts import eval_planner as tpl

sklearn_cluster = pytest.importorskip("sklearn.cluster")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
SCEN_ROOT = os.path.join(REPO, "out/adv_gen_synth_hc_prod/scenario_results")
SKLEARN_PKL = os.path.join(REPO, "out/cluster_prod_r5/cluster.pkl")
# columns that are flags or labels: held exactly
EXACT = {"did_collide", "adv_success", "planner_coll_atk",
         "planner_coll_others", "planner_coll_env", "env_coll_atk",
         "sol_coll_others", "sol_coll_env", "sol_success", "cluster_label",
         "cluster_name", "taxonomy", "count"}


def _load_script(name):
    """scripts/<name>.py of the JAX package, by path."""
    spec = importlib.util.spec_from_file_location(
        f"_strive_scripts_{name}", os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jscripts():
    sys.path.insert(0, SCRIPTS)  # eval_adv_gen imports cluster_scenarios
    try:
        yield {k: _load_script(k) for k in ("eval_planner", "eval_adv_gen",
                                            "cluster_scenarios")}
    finally:
        sys.path.remove(SCRIPTS)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def assert_csv_close(got_path, want_path, tol=1e-5):
    got, want = _csv(got_path), _csv(want_path)
    assert got[0] == want[0] and len(got) == len(want) > 1
    header = got[0]
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0]
        for col, a, b in zip(header[1:], g[1:], w[1:]):
            if col in EXACT or g[0] in EXACT:
                assert a == b, (g[0], col, a, b)
                continue
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, (g[0], col)
                continue
            assert (np.isnan(fa) and np.isnan(fb)) or np.isclose(
                fa, fb, rtol=tol, atol=tol), (g[0], col, fa, fb)


def _out_dir(prefix):
    (d,) = glob.glob(prefix + "_*")
    return d


def test_eval_planner_matches(jscripts, tmp_path):
    argv = ["-c", "/dev/null", "--data_version", "synthetic",
            "--scenario_dir", os.path.join(SCEN_ROOT, "adv_sol_success"),
            "--synth_scenes", "4", "--max_scenes", "4", "--max_agents", "16"]
    want = jscripts["eval_planner"].main(argv + ["--out",
                                                 str(tmp_path / "j")])
    got = tpl.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    csv_path = "all_eval_results.csv"
    rows = _csv(os.path.join(_out_dir(str(tmp_path / "t")), csv_path))
    assert sum(r[0].startswith("adv_") for r in rows) == 4
    assert sum(r[0].startswith("regular_") for r in rows) == 4
    assert_csv_close(os.path.join(_out_dir(str(tmp_path / "t")), csv_path),
                     os.path.join(_out_dir(str(tmp_path / "j")), csv_path))
    assert got[1] == want[1] and got[2] == want[2]  # collision counts
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _scenario_subset(root, n_failed=3):
    """The tracked results with the first ``n_failed`` of adv_failed (the
    JAX script compiles anew for each agent count: ~2 s a scenario)."""
    import shutil

    for t in ("adv_sol_success", "sol_failed", "adv_failed"):
        names = sorted(os.listdir(os.path.join(SCEN_ROOT, t)))
        os.makedirs(os.path.join(root, t))
        for nm in names[:n_failed] if t == "adv_failed" else names:
            shutil.copy(os.path.join(SCEN_ROOT, t, nm), os.path.join(root, t))
    return root


def test_eval_adv_gen_quant_matches(jscripts, tmp_path):
    root = _scenario_subset(str(tmp_path / "scen"))
    argv = ["-c", "/dev/null", "--scenario_root", root, "--eval_quant",
            "--data_version", "synthetic", "--max_agents", "16",
            "--cluster_pkl", SKLEARN_PKL]
    jscripts["eval_adv_gen"].main(argv + ["--out", str(tmp_path / "j")])
    tadv.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    jd, td = _out_dir(str(tmp_path / "j")), _out_dir(str(tmp_path / "t"))
    for name in ("per_seq_results.csv", "total_results.csv"):
        assert_csv_close(os.path.join(td, name), os.path.join(jd, name))
    rows = _csv(os.path.join(td, "per_seq_results.csv"))
    assert len(rows) == 1 + 9 and "cluster_label" in rows[0]
    assert os.path.isfile(os.path.join(td, "scenario_distrib.png"))


def test_compute_coll_feat_matches(jscripts):
    scenes = []
    for t in ("adv_sol_success", "sol_failed", "adv_failed"):
        scenes += read_adv_scenes(os.path.join(SCEN_ROOT, t))
    n_feat = 0
    for sc in scenes:
        args = (np.asarray(sc["veh_att"]), np.asarray(sc["scene_fut"]),
                sc["dt"])
        got = tclu.compute_coll_feat(*args, device="cpu")
        want = jscripts["cluster_scenarios"].compute_coll_feat(*args)
        assert (got is None) == (want is None), sc["name"]
        if want is not None:
            n_feat += 1
            for k in ("hvec", "angvec"):
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-6, err_msg=sc["name"])
    assert n_feat >= 6


def _tracked_features():
    feats = []
    for t in ("adv_sol_success", "sol_failed", "adv_failed"):
        for sc in read_adv_scenes(os.path.join(SCEN_ROOT, t)):
            f = tclu.compute_coll_feat(np.asarray(sc["veh_att"]),
                                       np.asarray(sc["scene_fut"]), sc["dt"])
            if f is not None:
                feats.append(f["angvec"] + f["hvec"])
    return np.asarray(feats)


def _blobs(seed=0, k=5, per=12):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (k, 4))
    return np.concatenate([c + rng.normal(0, 0.3, (per, 4)) for c in centers])


def _same_partition(a, b):
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("data,k", [("tracked", 3), ("blobs", 5),
                                    ("blobs_dense", 3)])
def test_lloyd_from_given_centers_matches_sklearn(data, k):
    X = {"tracked": _tracked_features, "blobs": _blobs,
         "blobs_dense": lambda: _blobs(1, 8, 6)}[data]()
    rng = np.random.default_rng(2)
    init = X[rng.choice(len(X), k, replace=False)]
    want = sklearn_cluster.KMeans(n_clusters=k, init=init, n_init=1).fit(X)
    got = kmeans.fit(X, k, init=init)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-6)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))


@pytest.mark.parametrize("data,k", [("tracked", 4), ("blobs", 5),
                                    ("blobs_wide", 6)])
def test_kmeans_fit_gives_sklearns_partition(data, k):
    X = {"tracked": _tracked_features, "blobs": _blobs,
         "blobs_wide": lambda: _blobs(3, 6, 10)}[data]()
    want = sklearn_cluster.KMeans(n_clusters=k, random_state=0,
                                  n_init=10).fit(X)
    got = kmeans.fit(X, k, n_init=10, seed=0)
    assert _same_partition(got.labels_, want.labels_)
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-6)
    assert got.n_clusters == k and got.cluster_centers_.shape == (k, 4)
    # predict: the nearest center, as sklearn's predict on its own centers
    np.testing.assert_array_equal(
        kmeans.predict(want.cluster_centers_, X), want.predict(X))


def test_cluster_pkl_read_back_without_sklearn(jscripts, tmp_path,
                                               monkeypatch):
    dirs = [os.path.join(SCEN_ROOT, t) for t in ("adv_sol_success",
                                                 "sol_failed")]
    clustering = tclu.main(["--scenario_dirs", *dirs, "--k", "3", "--out",
                            str(tmp_path / "c"), "--device", "cpu"])
    want = jscripts["cluster_scenarios"].main(
        ["--scenario_dirs", *dirs, "--k", "3", "--out", str(tmp_path / "j")])
    assert _same_partition(clustering.labels_, want.labels_)
    cdir = _out_dir(str(tmp_path / "c"))
    assert sorted(os.listdir(cdir)) == sorted(
        os.listdir(_out_dir(str(tmp_path / "j"))))
    monkeypatch.setitem(sys.modules, "sklearn", None)
    tadv.main(["-c", "/dev/null", "--scenario_root", SCEN_ROOT,
               "--eval_quant", "--data_version", "synthetic",
               "--max_agents", "16", "--out", str(tmp_path / "e"),
               "--cluster_pkl", os.path.join(cdir, "cluster.pkl"),
               "--cluster_labels", os.path.join(cdir, "cluster_labels.txt"),
               "--device", "cpu"])
    rows = _csv(os.path.join(_out_dir(str(tmp_path / "e")),
                             "per_seq_results.csv"))
    col = rows[0].index("cluster_label")
    got = [int(r[col]) for r in rows[1:] if r[col] != "nan"]
    assert len(got) >= 6 and set(got) <= {0, 1, 2}


def test_tools_without_matplotlib_write_all_but_the_chart(tmp_path,
                                                         monkeypatch):
    dirs = [os.path.join(SCEN_ROOT, t) for t in ("adv_sol_success",
                                                 "sol_failed")]
    argv = ["--scenario_dirs", *dirs, "--k", "3", "--device", "cpu"]
    tclu.main(argv + ["--out", str(tmp_path / "c")])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tclu.main(argv + ["--out", str(tmp_path / "n")])
    cdir, ndir = (_out_dir(str(tmp_path / d)) for d in ("c", "n"))
    assert sorted(os.listdir(ndir)) == sorted(
        f for f in os.listdir(cdir) if f != "cluster_k3.jpg")
    assert "cluster_k3.jpg" in os.listdir(cdir)
    tadv.main(["-c", "/dev/null", "--scenario_root", SCEN_ROOT,
               "--eval_quant", "--data_version", "synthetic",
               "--max_agents", "16", "--out", str(tmp_path / "e"),
               "--cluster_pkl", os.path.join(ndir, "cluster.pkl"),
               "--device", "cpu"])
    files = os.listdir(_out_dir(str(tmp_path / "e")))
    assert "scenario_distrib.png" not in files
    assert {"per_seq_results.csv", "total_results.csv"} <= set(files)


def test_semantic_names_and_labels_equal(jscripts, tmp_path):
    jclu = jscripts["cluster_scenarios"]
    rng = np.random.default_rng(0)
    centers = np.concatenate([rng.normal(size=(40, 4)),
                              [[1, 0, -1, 0], [-1, 0, 1, 0], [0, 1, 1, 0],
                               [0, -1, 0, 1], [1, 0.1, 1, 0]]])
    for c in centers:
        assert tclu.semantic_cluster_name(c) == jclu.semantic_cluster_name(c)

    class Fake:
        cluster_centers_ = centers[:12]
        n_clusters = 12

    got = tclu.write_cluster_labels(Fake(), str(tmp_path))
    with open(got[0]) as f:
        text = f.read()
    want = jclu.write_cluster_labels(Fake(), str(tmp_path))
    assert got[1] == want[1]
    with open(want[0]) as f:
        assert f.read() == text
    jadv = jscripts["eval_adv_gen"]
    assert tadv.load_cluster_labels(got[0], 12) == \
        jadv.load_cluster_labels(got[0], 12)
    assert tadv.load_cluster_labels(None, 2) == ["cluster 0", "cluster 1"]
