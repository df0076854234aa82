"""Experiment configuration and its command line (port of
``utils/config.py``).

The fields are the JAX config's, less the execution knob the port has no
counterpart for (:data:`JAX_ONLY_FIELDS`): ``donate_buffers``. ``backend``
is JAX's switch with JAX's values: ``"jax"`` runs the port's own path,
``"torch"`` and ``"tf2"`` the eager oracles (``backends/``; the driver's
``_run_experiment_eager``). ``save_figures``
makes the stage figures (``utils/viz.py``) and ``compile_cache_dir`` names
the directory of the kernels' libraries (``ops/_kernels.use_build_dir``).
:meth:`ExperimentConfig.run_name` gives the JAX name for the same science
fields, so the two packages name a run's checkpoint and log directories
alike, and :func:`build_argparser` takes the JAX flags of every field the
port has, the mesh and multihost ones included; a flag of a field it lacks
is an error that says why.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
from typing import Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
from iwae_replication_project_tpu_torch.objectives.estimators import (
    ObjectiveSpec,
)
from iwae_replication_project_tpu_torch.utils.dtypes import validate_precision

#: the config fields that define an experiment's identity (the JAX list)
SCIENCE_FIELDS = (
    "dataset", "n_hidden_encoder", "n_hidden_decoder",
    "n_latent_encoder", "n_latent_decoder", "loss_function", "k", "p",
    "alpha", "beta", "k2", "batch_size", "adam_eps",
    "seed", "switch_stage", "switch_loss", "switch_k", "likelihood",
    "passes_scale")

#: the ``backend`` values (JAX's): the port's own path, the eager torch
#: oracle, the TF2 oracle
BACKENDS = ("jax", "torch", "tf2")

#: JAX config fields the port does not have: field -> (the JAX default, why
#: the port lacks it). A config JSON may carry one at its default (a
#: JAX-written config does); any other value is refused.
JAX_ONLY_FIELDS = {
    "donate_buffers": (True, "the port has no buffer donation to turn off: "
                             "its train step writes the new state into the "
                             "old state's tensors in place"),
}

_TUPLE_FIELDS = ("n_hidden_encoder", "n_hidden_decoder", "n_latent_encoder",
                 "n_latent_decoder")


@dataclasses.dataclass
class ExperimentConfig:
    # data
    dataset: str = "binarized_mnist"
    data_dir: str = "data"
    allow_synthetic: bool = True

    # architecture (the 2-layer flagship by default)
    n_hidden_encoder: Tuple[int, ...] = (200, 100)
    n_hidden_decoder: Tuple[int, ...] = (100, 200)
    n_latent_encoder: Tuple[int, ...] = (100, 50)
    n_latent_decoder: Tuple[int, ...] = (100, 784)

    # objective
    loss_function: str = "IWAE"
    k: int = 50
    p: float = 1.0
    alpha: float = 1.0
    beta: float = 0.5
    k2: int = 1

    # training (experiment_example.py:35-40; Burda's schedule)
    batch_size: int = 100
    n_stages: int = 8
    adam_eps: float = 1e-4
    seed: int = 0
    # stage i trains max(1, round(3^(i-1) * passes_scale)) passes
    passes_scale: float = 1.0

    # objective switching: from `switch_stage` on, train with `switch_loss`
    # (and `switch_k` if given) instead of `loss_function`
    switch_stage: Optional[int] = None
    switch_loss: Optional[str] = None
    switch_k: Optional[int] = None

    # evaluation after each stage (flexible_IWAE.py:496-526); the NLL chunk
    # and the eval batch are clamped to divisors of nll_k and the test-set
    # size, and each history row records the values used
    eval_k: int = 50
    nll_k: int = 5000
    nll_chunk: int = 250
    eval_batch_size: int = 500
    activity_samples: int = 1000

    # execution backend (BACKENDS): "jax" runs the port's own path, "torch"
    # the eager oracle and "tf2" the TF2 oracle (single process, no mesh)
    backend: str = "jax"

    # the (dp, sp) mesh (parallel/): with mesh_dp or mesh_sp > 1 the run
    # takes the parallel path; mesh_dp None absorbs the ranks. Without
    # --multihost the CLI starts one rank per local card (or CPU rank);
    # with it this process joins a cluster as rank process_id of
    # num_processes through the coordinator host:port (None: torchrun's
    # RANK/WORLD_SIZE/MASTER_ADDR)
    mesh_dp: Optional[int] = None
    mesh_sp: int = 1
    multihost: bool = False
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    # None (fp32 matmuls) | "bfloat16" (bf16 operands, fp32 accumulation);
    # "float32" normalizes to None. bf16 is the production default.
    compute_dtype: Optional[str] = "bfloat16"
    # serving precision policy handed to the engine by zoo.serving_engine
    serving_precision: Optional[str] = None
    # "logits": exact x*l - softplus(l); "clamp": sigmoid + reference clamp
    likelihood: str = "logits"
    # the fused hot-loop dispatcher; None = auto: "logits" and CUDA
    fused_likelihood: Optional[bool] = None
    # gradient-SNR diagnostics over the trailing snr_window steps of a pass,
    # and the estimator diagnostics of each stage's evaluation
    diagnostics: bool = True
    snr_window: int = 50
    # per-stage sample/reconstruction PNG grids (and the latent scatter on
    # the digits) under <log_dir>/<run_name>/figures
    save_figures: bool = True
    # the kernels' library directory (ops/_kernels.use_build_dir): None =
    # $IWAE_COMPILE_CACHE, else the package's _build/; "off" = a fresh
    # private directory. Execution knob, not a science field
    compile_cache_dir: Optional[str] = None

    # persistence: logs and checkpoints go under <dir>/<run_name()>
    log_dir: str = "runs"
    checkpoint_dir: str = "checkpoints"
    checkpoint_keep: int = 3
    resume: bool = True
    # also checkpoint inside a stage, at the first dispatch boundary at
    # least this many passes after the last save (0 = stage boundaries only)
    checkpoint_every_passes: int = 0
    # absorb SIGTERM/SIGINT, finish the dispatch, save, exit 75
    preemption_grace: bool = True

    def __post_init__(self):
        if self.compute_dtype == "float32":
            self.compute_dtype = None
        if self.compute_dtype not in (None, "bfloat16"):
            raise ValueError(
                f"compute_dtype must be None, 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}")
        if self.serving_precision is not None:
            validate_precision(self.serving_precision)
        if self.checkpoint_every_passes < 0:
            raise ValueError(
                f"checkpoint_every_passes must be >= 0 (0 = stage boundaries "
                f"only), got {self.checkpoint_every_passes}")

    def uses_mesh(self) -> bool:
        """Whether the run takes the parallel path: any mesh flag, even at
        (1, 1), as the JAX driver decides (experiment.py:142)."""
        return self.multihost or self.mesh_dp is not None or self.mesh_sp > 1

    def model_config(self, device=None) -> ModelConfig:
        """The architecture as a :class:`ModelConfig`. With
        ``fused_likelihood`` left None the hot loop is fused when the
        likelihood is ``"logits"`` and the model runs on CUDA (`device`, or
        the presence of a CUDA device when `device` is None)."""
        fused = self.fused_likelihood
        if fused is None:
            on_cuda = torch.device(device).type == "cuda" \
                if device is not None else torch.cuda.is_available()
            fused = self.likelihood == "logits" and on_cuda
        return ModelConfig(
            n_hidden_enc=tuple(self.n_hidden_encoder),
            n_latent_enc=tuple(self.n_latent_encoder),
            n_hidden_dec=tuple(self.n_hidden_decoder),
            n_latent_dec=tuple(self.n_latent_decoder),
            likelihood=self.likelihood,
            compute_dtype=self.compute_dtype,
            fused_likelihood=bool(fused),
        )

    def diagnostics_config(self):
        """The DiagnosticsConfig training runs under, or None when
        diagnostics are off."""
        if not self.diagnostics:
            return None
        from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
            DiagnosticsConfig)
        return DiagnosticsConfig(snr_window=self.snr_window)

    def objective_spec(self, stage: Optional[int] = None) -> ObjectiveSpec:
        """The objective in effect at `stage` (1-based; None -> the base
        one)."""
        name, k = self.loss_function, self.k
        if (self.switch_stage is not None and stage is not None
                and stage >= self.switch_stage):
            name = self.switch_loss or name
            k = self.switch_k if self.switch_k is not None else k
        return ObjectiveSpec(name=name, k=k, p=self.p, alpha=self.alpha,
                             beta=self.beta, k2=self.k2)

    def science_fields(self) -> dict:
        """The fields that define the experiment's identity: not the output
        paths, the execution knobs or ``n_stages`` (extending the schedule
        and resuming is the intended workflow)."""
        return {f: getattr(self, f) for f in SCIENCE_FIELDS}

    def run_name(self) -> str:
        """``IWAE-2L-k_50-binarized_mnist-s0-1a2b3c4d``: the JAX package's
        name for these science fields (a hash of all of them), so that
        configs differing in any of them never share a run directory."""
        ident = hashlib.sha1(
            json.dumps(self.science_fields(), sort_keys=True, default=list)
            .encode()).hexdigest()[:8]
        return (f"{self.loss_function}-{len(self.n_hidden_encoder)}L-k_{self.k}"
                f"-{self.dataset}-s{self.seed}-{ident}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "ExperimentConfig":
        """The config of a JSON document, this package's or the JAX
        package's: a JAX-only field (:data:`JAX_ONLY_FIELDS`) at its JAX
        default is dropped, at any other value refused."""
        d = json.loads(s)
        for key, (default, why) in JAX_ONLY_FIELDS.items():
            if key in d:
                v = d.pop(key)
                if v != default:
                    raise ValueError(f"{key}={v!r}: {why}")
        for key in _TUPLE_FIELDS:
            d[key] = tuple(d[key])
        return ExperimentConfig(**d)


def _int_list(s: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in s.split(",") if v)


def _refused(why: str, takes_value: bool):
    """An argparse action refusing a JAX flag whose field the port lacks."""
    class Refused(argparse.Action):
        def __init__(self, option_strings, dest, **kw):
            kw.pop("nargs", None)
            super().__init__(option_strings, dest,
                             nargs="?" if takes_value else 0, **kw)

        def __call__(self, parser, namespace, values, option_string=None):
            parser.error(f"{option_string}: {why}")
    return Refused


def build_argparser() -> argparse.ArgumentParser:
    """The JAX runner's flags for every field the port has, the refused
    ones of the fields it lacks, and ``--device``."""
    ap = argparse.ArgumentParser(
        prog="iwae_replication_project_tpu_torch",
        description="IWAE experiment runner (PyTorch/CUDA port)")
    ap.add_argument("--config", type=str, default=None,
                    help="JSON config file; CLI flags override it")
    ap.add_argument("--preset", type=str, default=None,
                    help="named experiment from the zoo (reference Tables "
                         "1-10); CLI flags override it")
    ap.add_argument("--list-presets", action="store_true", default=False,
                    help="print all zoo preset names and exit")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to run (default: the CUDA card; a missing "
                         "card is an error, never a fall back to the CPU)")
    ap.add_argument("--dataset", default=None, type=str)
    ap.add_argument("--data-dir", dest="data_dir", default=None, type=str)
    ap.add_argument("--loss-function", dest="loss_function", default=None,
                    type=str)
    ap.add_argument("--k", default=None, type=int)
    ap.add_argument("--k2", default=None, type=int)
    ap.add_argument("--p", default=None, type=float)
    ap.add_argument("--alpha", default=None, type=float)
    ap.add_argument("--beta", default=None, type=float)
    ap.add_argument("--batch-size", dest="batch_size", default=None, type=int)
    ap.add_argument("--n-stages", dest="n_stages", default=None, type=int)
    ap.add_argument("--passes-scale", dest="passes_scale", default=None,
                    type=float)
    ap.add_argument("--seed", default=None, type=int)
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="jax: the port's own path (the default); torch: "
                         "the eager oracle; tf2: the TF2 oracle (needs "
                         "TensorFlow)")
    why = JAX_ONLY_FIELDS["donate_buffers"][1]
    ap.add_argument("--no-donate-buffers", action=_refused(why, False),
                    default=None, help=f"refused: {why}")
    ap.add_argument("--compile-cache-dir", dest="compile_cache_dir",
                    default=None, type=str,
                    help="directory the CUDA kernels' libraries are built "
                         "into and loaded from (default: "
                         "$IWAE_COMPILE_CACHE, else the package's _build/; "
                         "'off' builds into a fresh private directory)")
    ap.add_argument("--mesh-dp", dest="mesh_dp", default=None, type=int,
                    help="data-parallel ranks (default: the ranks --mesh-sp "
                         "leaves)")
    ap.add_argument("--mesh-sp", dest="mesh_sp", default=None, type=int,
                    help="sample-parallel ranks (the k axis)")
    ap.add_argument("--multihost", dest="multihost", default=None,
                    action="store_true",
                    help="join a cluster as one rank (one process per "
                         "card) before building the mesh; without it a "
                         "mesh flag starts one rank per local card")
    ap.add_argument("--coordinator", default=None, type=str,
                    help="rank 0's host:port (default: torchrun's "
                         "MASTER_ADDR/MASTER_PORT)")
    ap.add_argument("--num-processes", dest="num_processes", default=None,
                    type=int, help="ranks in the cluster (default: "
                                   "WORLD_SIZE)")
    ap.add_argument("--process-id", dest="process_id", default=None,
                    type=int, help="this process's rank (default: RANK)")
    ap.add_argument("--compute-dtype", dest="compute_dtype", default=None,
                    type=str)
    ap.add_argument("--serving-precision", dest="serving_precision",
                    default=None, type=str,
                    help="serving precision policy for this config "
                         "(fp32 | bf16 | int8); read by zoo.serving_engine, "
                         "never by training")
    ap.add_argument("--likelihood", default=None, type=str)
    ap.add_argument("--fused-likelihood", dest="fused_likelihood",
                    action="store_true", default=None)
    ap.add_argument("--no-fused-likelihood", dest="fused_likelihood",
                    action="store_false", default=None)
    ap.add_argument("--log-dir", dest="log_dir", default=None, type=str)
    ap.add_argument("--checkpoint-dir", dest="checkpoint_dir", default=None,
                    type=str)
    ap.add_argument("--checkpoint-every-passes",
                    dest="checkpoint_every_passes", default=None, type=int,
                    help="also checkpoint every N passes inside a stage "
                         "(0 = stage boundaries only)")
    ap.add_argument("--no-diagnostics", dest="diagnostics",
                    action="store_false", default=None,
                    help="disable the estimator diagnostics (ESS, "
                         "log-weight variance, grad SNR)")
    ap.add_argument("--snr-window", dest="snr_window", default=None, type=int,
                    help="trailing train steps in the gradient-SNR estimate")
    ap.add_argument("--no-preemption-grace", dest="preemption_grace",
                    action="store_false", default=None,
                    help="die immediately on SIGTERM/SIGINT instead of "
                         "finishing the dispatch, saving a mid-stage "
                         "checkpoint and exiting 75")
    ap.add_argument("--no-resume", dest="resume", action="store_false",
                    default=None)
    ap.add_argument("--no-figures", dest="save_figures",
                    action="store_false", default=None,
                    help="write no per-stage figures")
    ap.add_argument("--hidden-encoder", dest="n_hidden_encoder", default=None,
                    type=_int_list)
    ap.add_argument("--hidden-decoder", dest="n_hidden_decoder", default=None,
                    type=_int_list)
    ap.add_argument("--latent-encoder", dest="n_latent_encoder", default=None,
                    type=_int_list)
    ap.add_argument("--latent-decoder", dest="n_latent_decoder", default=None,
                    type=_int_list)
    ap.add_argument("--eval-k", dest="eval_k", default=None, type=int)
    ap.add_argument("--nll-k", dest="nll_k", default=None, type=int)
    ap.add_argument("--nll-chunk", dest="nll_chunk", default=None, type=int)
    return ap


def parse_args(argv=None) -> Tuple[argparse.Namespace, ExperimentConfig]:
    """``(namespace, config)`` of a command line: the preset or config file,
    then every flag given on top of it (``--list-presets`` prints the zoo
    and exits)."""
    ns = build_argparser().parse_args(argv)
    if ns.list_presets:
        from iwae_replication_project_tpu_torch import zoo
        for name in zoo.configs():
            print(name)
        raise SystemExit(0)
    if ns.preset:
        from iwae_replication_project_tpu_torch import zoo
        cfg = zoo.get(ns.preset)
    elif ns.config:
        with open(ns.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = ExperimentConfig()
    for field in dataclasses.fields(ExperimentConfig):
        v = getattr(ns, field.name, None)
        if v is not None:
            setattr(cfg, field.name, v)
    cfg.__post_init__()  # flags bypass construction: validate again
    return ns, cfg


def config_from_args(argv=None) -> ExperimentConfig:
    return parse_args(argv)[1]
