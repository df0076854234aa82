"""``scripts/torch_run_replication.py`` and
``scripts/torch_estimator_convergence.py``: every compared row's
configuration identical to the JAX row's by its run name, the gate's
arithmetic on fixed inputs (against scipy), both scripts end to end at a
tiny size on the CPU, the synthetic data byte for byte the JAX package's,
and the committed card artifacts against their own verdict.
"""

import importlib.util
import json
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import special, stats

from iwae_replication_project_tpu.data import loaders as jloaders
from iwae_replication_project_tpu_torch.data import loaders as tloaders

REPO = Path(__file__).resolve().parent.parent
RESULTS = REPO / "results"


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rep():
    return _script("torch_run_replication")


@pytest.fixture(scope="module")
def conv():
    return _script("torch_estimator_convergence")


def _jax_rows(fname):
    return {r["name"]: r for r in json.loads((RESULTS / fname).read_text())}


# --------------------------------------------------------------------------
# configuration identity
# --------------------------------------------------------------------------

def _suites(rep):
    """Each JAX summary's run list, as the port's script builds it."""
    return {
        "scaled": rep.seed_study((0, 1, 2, 3, 4), 8, 0.2),
        "bf16": rep.seed_study((0, 1, 2, 3, 4), 8, 0.2, "bfloat16"),
        "seeds": rep.seed_study((1, 2), 8),
        "suite": rep.replication_suite(8),
    }


@pytest.mark.parametrize("study", ["scaled", "bf16", "seeds", "suite"])
def test_every_jax_row_has_the_ports_configuration(rep, study):
    """Each JAX row of the study is one run of the port's list, and the
    port's config gives the JAX row's run name: by ``run_name()`` itself
    for the scaled, bf16 and digits_gray rows, by the name the JAX package
    gave before ``passes_scale`` joined the science fields for the other
    unscaled rows."""
    jax = _jax_rows(rep.OUTPUTS[study][1])
    runs = dict(_suites(rep)[study])
    assert set(runs) == set(jax)
    for name, cfg in runs.items():
        how = rep.matches_jax_row(cfg, jax[name]["run_name"])
        if study in ("scaled", "bf16") or name.startswith("digitsgray"):
            assert how == "run_name", name
            assert cfg.run_name() == jax[name]["run_name"]
        else:
            assert how == "before_passes_scale", name
            assert cfg.passes_scale == 1.0
        assert cfg.save_figures is False and cfg.resume is False
        assert (cfg.compute_dtype or "float32") == \
            (jax[name].get("compute_dtype") or "float32")
        # the older rows carry fewer fields: compare those they carry
        row = jax[name]
        assert row["k"] == cfg.k and row["loss"] == cfg.loss_function
        assert row["layers"] == len(cfg.n_hidden_encoder)
        assert row.get("seed", cfg.seed) == cfg.seed
        assert row.get("passes_scale", 1.0) == cfg.passes_scale
        assert row["run_name"].split("-s")[-1].split("-")[0] \
            == str(cfg.seed)


def test_an_altered_science_field_is_no_match(rep):
    name, cfg = rep.seed_study((0,), 8, 0.2)[0]
    want = _jax_rows("summary_seeds_scaled.json")[name]["run_name"]
    cfg.adam_eps = 1e-3
    assert rep.matches_jax_row(cfg, want) == ""


def test_the_suite_takes_jaxs_eval_batch_and_dtype(rep):
    for name, cfg in rep.replication_suite(8):
        assert cfg.compute_dtype is None
        assert cfg.eval_batch_size == (500 if name.startswith("synthetic")
                                       else 99)
        assert cfg.allow_synthetic == name.startswith("synthetic")
    for name, cfg in rep.seed_study((0,), 8, 0.2, "bfloat16"):
        assert cfg.compute_dtype == "bfloat16" and name.endswith("bfloat16")


@pytest.mark.parametrize("name", ["binarized_mnist", "mnist"])
def test_synthetic_data_is_jaxs_byte_for_byte(name, tmp_path):
    """The three synthetic rows are compared because both packages make
    the same synthetic data from the same seed."""
    a = jloaders.load_dataset(name, data_dir=str(tmp_path),
                              allow_synthetic=True)
    b = tloaders.load_dataset(name, data_dir=str(tmp_path),
                              allow_synthetic=True)
    assert a.synthetic and b.synthetic and a.binarization == b.binarization
    for f in ("x_train", "x_test"):
        assert np.asarray(getattr(a, f)).tobytes() \
            == np.asarray(getattr(b, f)).tobytes()
    assert np.asarray(a.output_bias).tobytes() \
        == np.asarray(b.output_bias).tobytes()


# --------------------------------------------------------------------------
# the gate's arithmetic
# --------------------------------------------------------------------------

#: the bounds the JAX seed studies set (ISSUE table): (file, key) -> (mean,
#: sd, bound)
JAX_TABLE = {
    ("summary_seeds_scaled.json", (1, "VAE", 1)): (240.404, 0.567, 2.0),
    ("summary_seeds_scaled.json", (1, "IWAE", 50)): (238.214, 0.407, 2.0),
    ("summary_seeds_scaled.json", (2, "VAE", 1)): (242.566, 0.840, 2.0),
    ("summary_seeds_scaled.json", (2, "IWAE", 50)): (238.825, 0.420, 2.0),
    ("summary_seeds_scaled_bf16.json", (1, "VAE", 1)): (240.405, 0.571, 2.0),
    ("summary_seeds_scaled_bf16.json", (1, "IWAE", 50)): (238.058, 0.409,
                                                          2.0),
    ("summary_seeds_scaled_bf16.json", (2, "VAE", 1)): (242.556, 0.835, 2.0),
    ("summary_seeds_scaled_bf16.json", (2, "IWAE", 50)): (238.823, 0.351,
                                                          2.0),
}


@pytest.mark.parametrize("fname,key", list(JAX_TABLE))
def test_bounds_from_jaxs_seed_studies(rep, fname, key):
    nll = [r["NLL"] for r in _jax_rows(fname).values()
           if rep.study_key(r["name"]) == key]
    assert len(nll) == 5
    mean, sd = rep.mean_sd(nll)
    want_mean, want_sd, want_bound = JAX_TABLE[fname, key]
    assert round(mean, 3) == pytest.approx(want_mean, abs=1e-3)
    assert round(sd, 3) == pytest.approx(want_sd, abs=1e-3)
    assert rep.bound(nll) == want_bound
    assert rep.bound(nll) == max(2.0, 3 * math.sqrt(2) * np.std(nll, ddof=1)
                                 / math.sqrt(5))


def test_bound_above_the_floor_is_three_root_two_se(rep):
    xs = [230.0, 236.0, 240.0, 244.0, 250.0]
    se = np.std(xs, ddof=1) / math.sqrt(5)
    assert rep.bound(xs) == pytest.approx(3 * math.sqrt(2) * se)
    assert rep.bound(xs) > 2.0


@pytest.mark.parametrize("a,b,x", [(2.5, 0.5, 0.3), (0.5, 0.5, 0.9),
                                   (4.0, 0.5, 0.999), (30.0, 0.5, 0.2),
                                   (1.0, 1.0, 0.5)])
def test_betainc_matches_scipy(rep, a, b, x):
    assert rep.betainc(a, b, x) == pytest.approx(special.betainc(a, b, x),
                                                 rel=1e-10, abs=1e-14)


@pytest.mark.parametrize("t", [-3.0, -0.4, 0.0, 0.7, 2.1, 8.0])
@pytest.mark.parametrize("df", [1.0, 3.7, 8.0, 40.0])
def test_t_sf_matches_scipy(rep, t, df):
    assert rep.t_sf(t, df) == pytest.approx(stats.t.sf(t, df), rel=1e-9,
                                            abs=1e-14)


@pytest.mark.parametrize("iwae,vae", [
    ([238.33, 238.761, 237.719, 237.919, 238.343],
     [239.464, 240.864, 240.325, 240.802, 240.566]),   # JAX fp32, 1L
    ([239.0, 240.5, 238.2], [239.4, 239.1, 241.0, 240.2]),
    ([241.0, 242.0, 241.5], [240.0, 240.4, 239.9]),      # the wrong order
])
def test_welch_one_sided_matches_scipy(rep, iwae, vae):
    got = rep.welch_one_sided(iwae, vae)
    want = stats.ttest_ind(iwae, vae, equal_var=False, alternative="less")
    assert got["t"] == pytest.approx(-want.statistic, rel=1e-12)
    assert got["p"] == pytest.approx(want.pvalue, rel=1e-9)
    assert got["holds"] == (want.pvalue < 0.05)
    assert got["gap"] == pytest.approx(np.mean(vae) - np.mean(iwae))


def test_study_verdict_on_fixed_rows(rep):
    """Port rows 0.5 nats above JAX's in one configuration and 3 in
    another: inside and outside the 2-nat bound; the ordering from the
    port's own seeds."""
    jax = list(_jax_rows("summary_seeds_scaled.json").values())
    port = []
    for r in jax:
        shift = {(1, "VAE", 1): 0.5, (2, "IWAE", 50): 3.0}.get(
            rep.study_key(r["name"]), 0.0)
        port.append(dict(r, NLL=r["NLL"] + shift,
                         NLL_by_stage=[r["NLL"] + shift]))
    v = rep.study_verdict(jax, port, "fp32")
    c = v["configs"]
    assert c["1L VAE k=1"]["gap"] == pytest.approx(0.5)
    assert c["1L VAE k=1"]["inside"] is True
    assert c["2L IWAE k=50"]["gap"] == pytest.approx(3.0)
    assert c["2L IWAE k=50"]["inside"] is False
    assert v["all_inside"] is False
    assert v["ordering_IWAE50_below_VAE1"]["1L"]["holds"] is True
    assert v["ordering_IWAE50_below_VAE1"]["2L"]["jax_gap"] \
        == pytest.approx(3.7402, abs=1e-4)


# --------------------------------------------------------------------------
# the scripts end to end, tiny
# --------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_replication_tiny_end_to_end(rep, conv, tmp_path, one_thread):
    out = tmp_path / "results"
    args = ["--tiny", "--device", "cpu", "--results-dir", str(out)]
    assert rep.main(["--bf16-study", "--seeds", "0,1"] + args) == 0
    assert rep.main(["--bf16-study", "--seeds", "2", "--only",
                     "2L-IWAE"] + args) == 0
    assert rep.main(["--only", "digitsgray"] + args) == 0
    assert conv.main(["--tiny", "--device", "cpu", "--results-dir",
                      str(out)]) == 0
    assert rep.main(["--check", "--results-dir", str(out)]) == 0
    doc = json.loads((out / rep.OUTPUTS["bf16"][0]).read_text())
    assert doc["device"] == "cpu" and doc["tiny"] is True
    names = [r["name"] for r in doc["rows"]]
    assert len(names) == 9 and len(set(names)) == 9   # merged by name
    for r in doc["rows"]:
        for f in ("NLL", "best_NLL", "best_stage", "IWAE_bound", "VAE_bound",
                  "active_units", "pca_active_units", "wall_seconds"):
            assert f in r, f
        assert len(r["NLL_by_stage"]) == 2 and np.isfinite(r["NLL"])
        assert r["best_NLL"] == min(r["NLL_by_stage"])
        assert r["launches"] == {"hot_loop_fwd": 0, "hot_loop_bwd": 0}
        assert r["card"] is None
    check = json.loads((out / rep.CHECK).read_text())
    assert set(check["gated"]) == {"scaled", "bf16"}
    assert check["gated"]["scaled"]["configs"]["1L VAE k=1"]["inside"] \
        is None                                          # not run here
    gray = {e["name"]: e for e in check["reported"]["suite"]}
    assert "port_NLL" in gray["digitsgray-1L-VAE-k1"]
    assert gray["digits-1L-VAE-k1"]["port"] == "not run"
    for est in ("STL", "PIWAE"):
        c = json.loads((out / rep.CONVERGENCE[est][0]).read_text())
        assert c["estimator"] == est and len(c["stages"]) == 2
        assert check["reported"][f"convergence_{est}"]["port_final_NLL"] \
            == c["final_NLL"]


def test_convergence_configs_are_jaxs(conv):
    with tempfile.TemporaryDirectory() as d:
        stl = conv.run_config(d, False, **conv.RUNS["STL"][0])
        piwae = conv.run_config(d, False, **conv.RUNS["PIWAE"][0])
    jstl = json.loads((RESULTS / "convergence_stl.json").read_text())
    jpiwae = json.loads((RESULTS / "convergence_piwae.json").read_text())
    for cfg, j in ((stl, jstl), (piwae, jpiwae)):
        for f in ("k", "k2", "seed", "n_stages", "passes_scale"):
            assert getattr(cfg, f) == j["config"][f], f
        assert cfg.n_hidden_encoder == (64,) and cfg.n_latent_encoder == (16,)
        assert cfg.dataset == j["config"]["dataset"]


# --------------------------------------------------------------------------
# the committed card artifacts
# --------------------------------------------------------------------------

def test_committed_verdict_is_the_check_of_the_committed_summaries(rep):
    committed = json.loads((RESULTS / rep.CHECK).read_text())
    assert json.loads(json.dumps(rep.check(RESULTS))) == committed


def test_committed_scaled_studies_ran_on_the_card(rep):
    """Five port seeds per configuration in both scaled studies, from the
    card, and the verdict the issue asks for: every gap and ordering
    stated."""
    check = json.loads((RESULTS / rep.CHECK).read_text())
    for study in ("scaled", "bf16"):
        doc = json.loads((RESULTS / rep.OUTPUTS[study][0]).read_text())
        assert doc["device"] == "cuda" and doc["tiny"] is False
        assert doc["cards"] and all("H100" in c for c in doc["cards"])
        by = {}
        for r in doc["rows"]:
            by.setdefault(rep.study_key(r["name"]), []).append(r["seed"])
            assert r["stages"] == 8 and len(r["NLL_by_stage"]) == 8
        assert {k: sorted(v) for k, v in by.items()} == {
            k: [0, 1, 2, 3, 4] for k in rep.STUDY_CONFIGS}
        v = check["gated"][study]
        assert len(v["configs"]) == 4
        for c in v["configs"].values():
            assert c["inside"] in (True, False)
            assert c["inside"] == (abs(c["gap"]) <= c["bound"])
        for o in v["ordering_IWAE50_below_VAE1"].values():
            assert o["holds"] == (o["p"] < rep.ALPHA)
