"""The port's experiment config and command line (``utils/config.py``)
against the JAX package's: run names, JSON round trips, the flags both
runners take on the same argv (``--backend`` with JAX's three values), the
flag the port refuses, and C5's path selection rule driven with stub
library numbers."""

import dataclasses
import json

import pytest
import torch

from iwae_replication_project_tpu.utils import config as jconfig
from iwae_replication_project_tpu_torch.ops import hot_loop as thl
from iwae_replication_project_tpu_torch.utils import config as tconfig

ExperimentConfig = tconfig.ExperimentConfig

#: argv lists both runners take; each is parsed by both and compared on the
#: port's fields
SHARED_ARGV = [
    [],
    ["--k", "9", "--loss-function", "CIWAE", "--beta", "0.25",
     "--hidden-encoder", "32,16", "--latent-encoder", "8,4"],
    ["--preset", "table9-miwae-5x10", "--seed", "3", "--n-stages", "2",
     "--passes-scale", "0.5"],
    ["--dataset", "digits", "--data-dir", "d", "--batch-size", "64",
     "--compute-dtype", "float32", "--likelihood", "clamp",
     "--no-fused-likelihood", "--eval-k", "7", "--nll-k", "40",
     "--nll-chunk", "8"],
    ["--log-dir", "L", "--checkpoint-dir", "C",
     "--checkpoint-every-passes", "4", "--no-resume",
     "--no-preemption-grace", "--no-diagnostics", "--snr-window", "9",
     "--serving-precision", "bf16", "--k2", "5", "--p", "2.0",
     "--alpha", "0.5"],
    ["--preset", "table10-iwae-to-vae-k1", "--fused-likelihood"],
    ["--no-figures", "--compile-cache-dir", "kcache", "--dataset", "digits"],
    ["--compile-cache-dir", "off"],
]


def _port_view(cfg) -> dict:
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(ExperimentConfig)}


@pytest.mark.parametrize("argv", SHARED_ARGV, ids=lambda a: " ".join(a)
                         or "defaults")
def test_shared_flags_parse_as_jax_does(argv):
    got = tconfig.config_from_args(argv)
    want = jconfig.config_from_args(argv)
    assert _port_view(got) == {k: getattr(want, k) for k in _port_view(got)}
    assert got.run_name() == want.run_name()
    assert got.science_fields() == want.science_fields()


def test_every_port_field_is_a_jax_field():
    jax_fields = {f.name for f in dataclasses.fields(jconfig.ExperimentConfig)}
    port_fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    assert port_fields <= jax_fields
    assert jax_fields - port_fields == set(tconfig.JAX_ONLY_FIELDS)
    assert tconfig.SCIENCE_FIELDS == jconfig.SCIENCE_FIELDS
    jd = jconfig.ExperimentConfig()
    for name, (default, _) in tconfig.JAX_ONLY_FIELDS.items():
        assert getattr(jd, name) == default, name
    td = ExperimentConfig()
    for name in port_fields:
        assert getattr(td, name) == getattr(jd, name), name


@pytest.mark.parametrize("over", [
    {}, {"alpha": 0.25}, {"seed": 1}, {"switch_stage": 5,
                                       "switch_loss": "VAE"},
    {"n_hidden_encoder": (5, 6), "passes_scale": 0.2},
])
def test_run_name_and_json_match_jax(over):
    cfg = ExperimentConfig(**over)
    jcfg = jconfig.ExperimentConfig(**over)
    assert cfg.run_name() == jcfg.run_name()
    assert ExperimentConfig.from_json(cfg.to_json()) == cfg
    # a JAX-written config loads (its JAX-only fields at their defaults)
    # with the same identity, and the port's loads in the JAX package
    assert ExperimentConfig.from_json(jcfg.to_json()).run_name() == \
        jcfg.run_name()
    assert jconfig.ExperimentConfig.from_json(cfg.to_json()).run_name() == \
        cfg.run_name()


def test_json_refuses_what_the_port_cannot_run():
    d = json.loads(jconfig.ExperimentConfig().to_json())
    bad = dict(d, donate_buffers=False)
    with pytest.raises(ValueError, match="no buffer donation"):
        ExperimentConfig.from_json(json.dumps(bad))
    # a JAX config naming an eager backend loads as the JAX config holds it
    for backend in ("torch", "tf2"):
        eager = dict(d, backend=backend)
        got = ExperimentConfig.from_json(json.dumps(eager))
        want = jconfig.ExperimentConfig.from_json(json.dumps(eager))
        assert got.backend == want.backend == backend
        assert got.run_name() == want.run_name()
    # the mesh fields load as the JAX config holds them
    mesh = dict(d, mesh_dp=2, mesh_sp=2, multihost=True,
                coordinator="h:1", num_processes=4, process_id=3)
    got = ExperimentConfig.from_json(json.dumps(mesh))
    want = jconfig.ExperimentConfig.from_json(json.dumps(mesh))
    for key in ("mesh_dp", "mesh_sp", "multihost", "coordinator",
                "num_processes", "process_id"):
        assert getattr(got, key) == getattr(want, key) == mesh[key], key
    assert got.uses_mesh() and got.run_name() == want.run_name()
    # the figures' switch and the compile cache's directory load as the
    # JAX config holds them
    over = dict(d, save_figures=False, compile_cache_dir="kcache")
    got = ExperimentConfig.from_json(json.dumps(over))
    want = jconfig.ExperimentConfig.from_json(json.dumps(over))
    assert got.save_figures is want.save_figures is False
    assert got.compile_cache_dir == want.compile_cache_dir == "kcache"
    assert got.run_name() == want.run_name() == \
        ExperimentConfig.from_json(json.dumps(d)).run_name()


@pytest.mark.parametrize("argv,why", [
    (["--no-donate-buffers"], "no buffer donation"),
])
def test_refused_flags_name_their_roadmap_item(argv, why, capsys):
    """The JAX flag of a field the port lacks is refused with the reason:
    the port's step has no buffer donation to turn off."""
    with pytest.raises(SystemExit) as e:
        tconfig.config_from_args(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert why in err and argv[0] in err
    jconfig.config_from_args(argv)  # the JAX runner takes them


@pytest.mark.parametrize("argv,backend", [
    (["--backend", "torch"], "torch"),
    (["--backend", "tf2"], "tf2"),
    (["--backend", "jax"], "jax"),
])
def test_backend_flag_parses_as_jax_does(argv, backend):
    """``--backend``, once refused, parses as the JAX runner parses it:
    "jax" the port's own path, "torch" and "tf2" the eager oracles. The
    run's identity does not change with it (an execution knob)."""
    got = tconfig.config_from_args(argv)
    want = jconfig.config_from_args(argv)
    assert got.backend == want.backend == backend
    assert _port_view(got) == {k: getattr(want, k) for k in _port_view(got)}
    assert got.run_name() == want.run_name() == ExperimentConfig().run_name()


def test_unknown_backend_flag_is_an_argparse_error(capsys):
    with pytest.raises(SystemExit) as e:
        tconfig.config_from_args(["--backend", "numpy"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("argv,field,value", [
    (["--mesh-dp", "4"], "mesh_dp", 4), (["--mesh-sp", "2"], "mesh_sp", 2),
    (["--multihost"], "multihost", True),
    (["--coordinator", "h:1"], "coordinator", "h:1"),
    (["--num-processes", "2"], "num_processes", 2),
    (["--process-id", "0"], "process_id", 0),
])
def test_mesh_flags_parse_into_the_config(argv, field, value):
    """The mesh and multihost flags, once refused, parse as the JAX runner
    parses them; any of them but ``--mesh-sp 1`` takes the parallel path."""
    got = tconfig.config_from_args(argv)
    want = jconfig.config_from_args(argv)
    assert getattr(got, field) == getattr(want, field) == value
    assert _port_view(got) == {k: getattr(want, k) for k in _port_view(got)}
    assert got.uses_mesh() == (field not in ("coordinator", "num_processes",
                                             "process_id"))


def test_device_flag_and_validation():
    ns, cfg = tconfig.parse_args(["--device", "cpu", "--no-figures"])
    assert ns.device == "cpu" and cfg == ExperimentConfig(save_figures=False)
    assert ExperimentConfig().save_figures is True
    assert tconfig.config_from_args(
        ["--compile-cache-dir", "d"]).compile_cache_dir == "d"
    assert tconfig.parse_args([])[0].device is None
    with pytest.raises(SystemExit):
        tconfig.parse_args(["--device", "tpu"])
    with pytest.raises(ValueError, match="checkpoint_every_passes"):
        ExperimentConfig(checkpoint_every_passes=-1)
    with pytest.raises(ValueError, match="checkpoint_every_passes"):
        tconfig.config_from_args(["--checkpoint-every-passes", "-2"])
    with pytest.raises(ValueError, match="compute_dtype"):
        tconfig.config_from_args(["--compute-dtype", "fp16"])


def test_list_presets_prints_the_zoo(capsys):
    from iwae_replication_project_tpu_torch import zoo
    with pytest.raises(SystemExit) as e:
        tconfig.config_from_args(["--list-presets"])
    assert e.value.code == 0
    assert capsys.readouterr().out.split() == list(zoo.configs())


# --------------------------------------------------------------------------
# C5: the hot loop's path at widths the kernels refuse
# --------------------------------------------------------------------------

def _stub_limits(h1, hid, bf16):
    """Stub library numbers shaped like the libraries' own: shared memory
    grows with the reduction width, and in bf16 both register budgets end
    at 240-wide reductions; fp32 takes every width used here."""
    kp = max(-(-h1 // 16) * 16, -(-hid // 16) * 16)
    if not bf16:
        return thl.BlockLimits(4 * (32 * (h1 + 2 * hid) + 8192), 40_000,
                               True, True)
    return thl.BlockLimits(216 * kp + 40_000, 860 * kp, kp <= 240, kp <= 240)


@pytest.mark.parametrize("h1,hid,bf16,why", [
    (100, 200, True, None),           # the flagship
    (50, 200, True, None),            # the 1-layer presets
    (100, 240, True, None),           # the widest reduction the budget takes
    (100, 256, True, "register"),     # C5: a 256-wide output block
    (100, 336, True, "register"),
    (256, 100, True, "register"),     # a wide bottom latent
    (100, 256, False, None),          # fp32 has no register limit
])
def test_refusal_rule_from_library_numbers(h1, hid, bf16, why):
    got = thl.block_refusal(_stub_limits(h1, hid, bf16))
    assert (got is None) == (why is None)
    if why:
        assert why in got


def test_refusal_reads_shared_memory_and_both_kernels():
    fits = thl.BlockLimits(1000, 1000, True, True)
    assert thl.block_refusal(fits, max_smem=1000) is None
    assert "hot_loop_fwd needs 1001 bytes" in thl.block_refusal(
        dataclasses.replace(fits, fwd_smem=1001), max_smem=1000)
    assert "hot_loop_bwd needs" in thl.block_refusal(
        dataclasses.replace(fits, bwd_smem=1001), max_smem=1000)
    assert "hot_loop_bwd: a reduction" in thl.block_refusal(
        dataclasses.replace(fits, bwd_fits=False))


def test_dispatcher_takes_reference_where_a_kernel_refuses(monkeypatch):
    """select_path and the serving gate on a CUDA device, from stub library
    numbers (nothing is built on the CPU): the flagship takes the kernel, a
    bf16 256-wide output block the reference path, and a kernel pin there
    is an error."""
    monkeypatch.setattr(thl, "library_limits", _stub_limits)
    cuda = torch.device("cuda")
    assert thl.select_path(cuda, widths=(100, 200, True)) == "kernel"
    assert thl.select_path(cuda, widths=(100, 256, True)) == "reference"
    assert thl.select_path(cuda, widths=(100, 256, False)) == "kernel"
    with pytest.raises(ValueError, match="refuses"):
        thl.select_path(cuda, "kernel", widths=(100, 256, True))
    assert thl.select_path(torch.device("cpu"),
                           widths=(100, 256, True)) == "reference"
    wide = ExperimentConfig(n_hidden_decoder=(100, 256)).model_config("cuda")
    assert thl.block_widths(wide) == (100, 256, True)
    assert wide.fused_likelihood
    assert thl.serving_dispatch_config(wide, device=cuda) == (
        dataclasses.replace(wide, row_invariant=True), "reference")
    flag = ExperimentConfig().model_config("cuda")
    out, path = thl.serving_dispatch_config(flag, device=cuda)
    assert path == "kernel" and out.hot_loop_path == "kernel"
    assert out.row_invariant
    one = ExperimentConfig(n_hidden_encoder=(200,), n_latent_encoder=(50,),
                           n_hidden_decoder=(200,),
                           n_latent_decoder=(784,)).model_config("cuda")
    assert thl.block_widths(one) == (50, 200, True)


def test_decoder_score_records_the_reference_path(monkeypatch):
    """On a refused width the dispatcher's choice is what decoder_score
    records under kernel_path/reference; driven here through a stubbed
    selection on CPU tensors."""
    seen = []
    real = thl.select_path

    def spy(device, force=None, widths=None, shape=None):
        seen.append(widths)
        return real(device, force, widths, shape)

    monkeypatch.setattr(thl, "select_path", spy)
    g = torch.Generator().manual_seed(0)
    out = {"l1": {"w": torch.randn(4, 20, generator=g),
                  "b": torch.zeros(20)},
           "l2": {"w": torch.randn(20, 20, generator=g),
                  "b": torch.zeros(20)},
           "out": {"w": torch.randn(20, 12, generator=g),
                   "b": torch.zeros(12)}}
    before = thl.path_counters().get("reference", 0)
    thl.decoder_score(out, torch.ones(3, 12), torch.randn(2, 3, 4,
                                                          generator=g),
                      compute_dtype=torch.bfloat16)
    assert seen == [(4, 20, True)]
    assert thl.path_counters()["reference"] == before + 1
