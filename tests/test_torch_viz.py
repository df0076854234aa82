"""The port's figures (``utils/viz.py``) against the JAX package's
``utils/viz.py``: the grid bitwise, the standard-library PNG writer decoded
by PIL, the stage figures on JAX's replayed draws, the latent scatter's
projection; and the figures and compile-cache fields in the port's driver
on the CPU."""

import contextlib
import io
import json
import os
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity as tp
from iwae_replication_project_tpu.utils import viz as jviz
from iwae_replication_project_tpu_torch import experiment as exp
from iwae_replication_project_tpu_torch.ops import _kernels
from iwae_replication_project_tpu_torch.utils import viz as tviz
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig

#: the six compile fields of a JAX stage row (JAX experiment.py:437-442)
COMPILE_FIELDS = ("aot_hits", "aot_misses", "aot_compile_seconds",
                  "compile_cache_hits", "compile_cache_misses",
                  "compile_seconds")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def _decode(data: bytes):
    """(width, height, colour type, pixel rows) of a PNG this module
    writes, decoded with zlib alone (filter byte 0 on every row)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = int.from_bytes(ihdr[:4], "big"), int.from_bytes(ihdr[4:8], "big")
    colour = ihdr[9]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()
    return w, h, colour, raw[:, 1:]


@pytest.mark.parametrize("n,ncols,hw,pad", [
    (100, 10, (28, 28), 2), (40, 10, (28, 28), 2), (7, 3, (4, 5), 1),
    (1, 10, (28, 28), 0), (13, 4, (6, 6), 3)])
def test_image_grid_bitwise_jax(n, ncols, hw, pad):
    x = np.random.RandomState(n).uniform(-0.2, 1.2, (n, hw[0] * hw[1]))
    got = tviz.image_grid(x.astype(np.float32), ncols, hw, pad)
    want = jviz.image_grid(x.astype(np.float32), ncols, hw, pad)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(302, 302), (1, 1), (5, 17), (122, 302),
                                   (600, 600, 3), (3, 9, 3), (1, 1, 3)])
def test_save_png_decodes_to_the_array(shape, tmp_path):
    a = np.random.RandomState(sum(shape)).randint(0, 256, shape
                                                  ).astype(np.uint8)
    path = tmp_path / "t.png"
    tviz.save_png(a, str(path))
    assert np.array_equal(_png(path), a)
    w, h, colour, rows = _decode(path.read_bytes())
    assert (h, w) == shape[:2] and colour == (0 if len(shape) == 2 else 2)
    assert np.array_equal(rows.reshape(shape), a)
    if len(shape) == 2:  # JAX's writer is grayscale only
        jpath = tmp_path / "j.png"
        jviz.save_png(a, str(jpath))
        assert np.array_equal(_png(jpath), _png(path))


def test_save_png_refuses_other_shapes(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        tviz.save_png(np.zeros((4, 4, 4), np.uint8), str(tmp_path / "x.png"))


def _stage_noise(jcfg, key, n_samples, n_recon):
    """JAX save_stage_figures' draws for `key` (JAX viz.py:62-75)."""
    k_gen, k_rec = jax.random.split(key)
    h_top = np.array(jax.random.normal(
        k_gen, (1, n_samples, jcfg.n_latent_enc[-1])))
    k_enc, k_dec = jax.random.split(k_rec)
    return {"h_top": torch.from_numpy(h_top),
            "gen": tp.decode_noise(jcfg, jax.random.fold_in(k_gen, 1),
                                   n_samples),
            "recon_enc": [torch.from_numpy(np.array(e)) for e in
                          tp.encode_noise(jcfg, k_enc, 1, n_recon)],
            "recon_dec": tp.decode_noise(jcfg, k_dec, n_recon)}


@pytest.mark.parametrize("layers,dtype", [(1, None), (2, None),
                                          (2, "bfloat16")])
def test_stage_figures_match_jax_on_replayed_draws(layers, dtype, tmp_path):
    """Within one grey level of JAX's PNGs (the two packages' float
    reductions round apart, and a value on a level's edge may land on
    either side)."""
    jcfg, tcfg = tp.configs(layers, compute_dtype=dtype)
    jp, tparams = tp.params(jcfg, seed=layers)
    x = tp.binary_rows(30, seed=layers)
    key = jax.random.PRNGKey(7 + layers)
    want = jviz.save_stage_figures(jp, jcfg, key, x, str(tmp_path / "jax"), 3)
    got = tviz.save_stage_figures(tparams, tcfg, x, str(tmp_path / "port"),
                                  3, noise=_stage_noise(jcfg, key, 100, 20))
    assert [Path(p).name for p in got] == [Path(p).name for p in want] == [
        "stage_03_samples.png", "stage_03_recons.png"]
    for g, w in zip(got, want):
        a, b = _png(g).astype(int), _png(w).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1


def test_stage_figures_from_a_generator(tmp_path):
    """The driver's call: draws from a generator, a 784-pixel model's grids
    are 10x10 and 4x10 tiles of 28x28 with 2 px padding."""
    _, tcfg = tp.configs(2)
    import dataclasses
    tcfg = dataclasses.replace(tcfg, n_latent_dec=(8, 784), x_dim=784)
    from iwae_replication_project_tpu_torch.models import iwae as tmodel
    params = tmodel.init_params(torch.Generator().manual_seed(0), tcfg,
                                output_bias=np.zeros(784, np.float32))
    x = (np.random.RandomState(0).rand(25, 784) > 0.5).astype(np.float32)
    paths = tviz.save_stage_figures(params, tcfg, torch.from_numpy(x),
                                    str(tmp_path), 1,
                                    generator=torch.Generator().manual_seed(3))
    samples, recons = (_png(p) for p in paths)
    assert samples.shape == (302, 302) and recons.shape == (122, 302)
    # the recons grid's odd tiles are the originals
    assert np.array_equal(recons[2:30, 2:30] > 127, x[0].reshape(28, 28) > 0)


@pytest.mark.parametrize("layers,layer,labels", [(1, -1, True), (2, 0, False),
                                                 (2, -1, True)])
def test_latent_scatter_projection_matches_jax(layers, layer, labels,
                                               tmp_path):
    """Within 1e-4, up to each principal component's sign."""
    jcfg, tcfg = tp.configs(layers)
    jp, tparams = tp.params(jcfg, seed=layers)
    x = tp.binary_rows(40, seed=5)
    y = np.arange(40) % 10 if labels else None
    key = jax.random.PRNGKey(11)
    want = jviz.latent_scatter(jp, jcfg, key, x, str(tmp_path / "j.png"),
                               labels=y, layer=layer, n_samples=16)
    eps = [torch.from_numpy(np.array(e))
           for e in tp.encode_noise(jcfg, key, 16, 40)]
    got = tviz.latent_scatter(tparams, tcfg, x, str(tmp_path / "t.png"),
                              labels=y, layer=layer, n_samples=16, eps=eps)
    assert got.shape == want.shape == (40, 2)
    for c in range(2):
        sign = np.sign(np.dot(got[:, c], want[:, c]))
        np.testing.assert_allclose(sign * got[:, c], want[:, c], atol=1e-4,
                                   rtol=0)
    img = _png(tmp_path / "t.png")
    assert img.shape == (600, 600, 3)
    colours = {tuple(int(v) for v in c) for c in img.reshape(-1, 3)}
    if labels:  # the strip holds the ten class colours as they are
        want = tviz.TAB10.astype(int)
    else:  # the first colour at alpha 0.7 over white
        want = np.round(0.3 * 255 + 0.7 * tviz.TAB10[:1]).astype(int)
    for c in want:
        assert tuple(c) in colours


def test_latent_scatter_refuses_a_one_dim_layer(tmp_path):
    jcfg, tcfg = tp.configs(1)
    import dataclasses
    tcfg = dataclasses.replace(tcfg, n_latent_enc=(1,))
    from iwae_replication_project_tpu_torch.models import iwae as tmodel
    params = tmodel.init_params(torch.Generator().manual_seed(0), tcfg,
                                output_bias=np.zeros(tp.D, np.float32))
    with pytest.raises(ValueError, match="dimension 1"):
        tviz.latent_scatter(params, tcfg, tp.binary_rows(4),
                            str(tmp_path / "x.png"), n_samples=2,
                            generator=torch.Generator().manual_seed(0))


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------

def _tiny(tmp_path, **over):
    d = dict(dataset="digits", allow_synthetic=False,
             n_hidden_encoder=(16,), n_hidden_decoder=(16,),
             n_latent_encoder=(4,), n_latent_decoder=(784,),
             loss_function="IWAE", k=4, batch_size=100, n_stages=2,
             eval_k=4, nll_k=8, nll_chunk=4, eval_batch_size=99,
             activity_samples=8, log_dir=str(tmp_path / "runs"),
             checkpoint_dir=str(tmp_path / "ckpt"))
    d.update(over)
    return ExperimentConfig(**d)


def test_driver_writes_the_stage_figures_and_compile_fields(tmp_path):
    cfg = _tiny(tmp_path)
    _, hist = exp.run_experiment(cfg, max_batches_per_pass=1, device="cpu")
    run_dir = Path(cfg.log_dir) / cfg.run_name()
    figs = sorted(p.name for p in (run_dir / "figures").iterdir())
    assert figs == [f"stage_0{s}_{n}.png" for s in (1, 2)
                    for n in ("latent", "recons", "samples")]
    for s in (1, 2):
        assert _png(run_dir / "figures" / f"stage_0{s}_samples.png").shape \
            == (302, 302)
        assert _png(run_dir / "figures" / f"stage_0{s}_recons.png").shape \
            == (122, 302)
        assert _png(run_dir / "figures" / f"stage_0{s}_latent.png").shape \
            == (600, 600, 3)
    rows = [json.loads(l) for l in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    for row, h in zip(rows, hist):
        for key in COMPILE_FIELDS:
            assert row[key] == 0.0, key  # nothing captured or built here
            assert h[key] == 0.0, key
        assert row["stage_figure_seconds"] > 0
    # the figures are the driver's generators' draws: a second run of the
    # same config writes the same bytes
    cfg2 = _tiny(tmp_path / "again")
    exp.run_experiment(cfg2, max_batches_per_pass=1, device="cpu")
    again = Path(cfg2.log_dir) / cfg2.run_name() / "figures"
    for name in figs:
        assert (again / name).read_bytes() == \
            (run_dir / "figures" / name).read_bytes(), name

    # a finished run resumed writes nothing
    stamps = {p: p.stat().st_mtime_ns for p in run_dir.rglob("*")}
    with contextlib.redirect_stdout(io.StringIO()):
        _, hist2 = exp.run_experiment(cfg, max_batches_per_pass=1,
                                      device="cpu")
    assert hist2 == []
    assert {p: p.stat().st_mtime_ns for p in run_dir.rglob("*")} == stamps


def test_driver_without_figures_and_the_latent_only_on_digits(tmp_path):
    cfg = _tiny(tmp_path, n_stages=1, save_figures=False)
    _, hist = exp.run_experiment(cfg, max_batches_per_pass=1, device="cpu")
    assert not (Path(cfg.log_dir) / cfg.run_name() / "figures").exists()
    assert hist[0]["stage_figure_seconds"] < 0.05
    cfg = _tiny(tmp_path / "mnist", n_stages=1, dataset="binarized_mnist",
                allow_synthetic=True, data_dir=str(tmp_path / "none"))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        exp.run_experiment(cfg, max_batches_per_pass=1, device="cpu")
    figs = sorted(p.name for p in
                  (Path(cfg.log_dir) / cfg.run_name() / "figures").iterdir())
    assert figs == ["stage_01_recons.png", "stage_01_samples.png"]


# --------------------------------------------------------------------------
# the compile cache's directory
# --------------------------------------------------------------------------

@pytest.fixture
def fresh_kernels(monkeypatch):
    """``ops/_kernels`` with no directory resolved and nothing loaded."""
    monkeypatch.setattr(_kernels, "_dir", None)
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.delenv(_kernels.CACHE_ENV, raising=False)
    return _kernels


@pytest.mark.parametrize("field,env,want", [
    (None, None, "default"), ("X", None, "X"), (None, "E", "E"),
    ("X", "E", "X"), (None, "off", None), ("off", "E", None),
    ("none", None, None), ("0", None, None), ("OFF", None, None),
    ("", None, "default")])
def test_build_dir_resolution(field, env, want, fresh_kernels, monkeypatch,
                              tmp_path):
    """The field wins, ``IWAE_COMPILE_CACHE`` fills in when it is None,
    off/none/0 means a fresh private directory, and neither set the
    package's ``_build/`` (JAX utils/compile_cache.py:167-207)."""
    if env is not None:
        monkeypatch.setenv(fresh_kernels.CACHE_ENV,
                           env if env == "off" else str(tmp_path / env))
    arg = field if field in (None, "", "off", "none", "0", "OFF") \
        else str(tmp_path / field)
    got = fresh_kernels.resolve_build_dir(arg)
    if want == "default":
        assert got == fresh_kernels.BUILD_DIR
    elif want is None:
        assert got is None
    else:
        assert got == tmp_path / want
    used = fresh_kernels.use_build_dir(arg, say=lambda *a: None)
    assert fresh_kernels.build_dir() == used
    assert fresh_kernels.library_path("row_sum").parent == used
    if want is None:  # a fresh private directory each time
        assert used.is_dir() and used != fresh_kernels.BUILD_DIR
        other = fresh_kernels.use_build_dir(arg, say=lambda *a: None)
        assert other.is_dir() and other != used


def test_build_dir_first_wins_once_loaded(fresh_kernels, tmp_path):
    said = []
    first = fresh_kernels.use_build_dir(str(tmp_path / "a"))
    fresh_kernels._libs["row_sum"] = object()  # a library is loaded
    got = fresh_kernels.use_build_dir(str(tmp_path / "b"), say=said.append)
    assert got == first == tmp_path / "a"
    assert len(said) == 1 and "already loaded" in said[0] \
        and str(tmp_path / "b") in said[0]
    said.clear()
    assert fresh_kernels.use_build_dir(str(tmp_path / "a"),
                                       say=said.append) == first
    assert said == []


def test_cache_stats_count_disk_hits_and_builds(fresh_kernels, monkeypatch,
                                                tmp_path):
    """A library found built is a hit; one that nvcc makes is a build, with
    its seconds (nvcc replaced by a stub that writes the file)."""
    import subprocess
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc

    fresh_kernels.use_build_dir(str(tmp_path / "lib"))

    class _Nvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"so")

        def communicate(self):
            return "", None

    monkeypatch.setattr(subprocess, "Popen", _Nvcc)
    monkeypatch.setattr(fresh_kernels, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(fresh_kernels, "build_log", {})
    before = cc.cache_stats()
    fresh_kernels.build(["row_sum", "row_dense"])
    mid = cc.stats_delta(before)
    assert mid["kernel_builds"] == 2 and mid["kernel_disk_hits"] == 0
    assert mid["kernel_build_seconds"] > 0
    assert mid["kernel_cache_dir"] == str(tmp_path / "lib")
    fresh_kernels.build(["row_sum", "row_dense"])
    again = cc.stats_delta(before)
    assert again["kernel_builds"] == 2 and again["kernel_disk_hits"] == 2
    assert sorted(os.listdir(tmp_path / "lib")) == sorted(
        fresh_kernels.library_path(n).name for n in ("row_dense", "row_sum"))


def test_capture_notes_are_the_aot_counters():
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc

    before = cc.cache_stats()
    cc.note_capture(0.25)
    cc.note_capture(0.5)
    cc.note_replay()
    d = cc.stats_delta(before)
    assert (d["aot_misses"], d["aot_captures"], d["aot_hits"]) == (2, 2, 1)
    assert d["aot_capture_seconds"] == pytest.approx(0.75)
