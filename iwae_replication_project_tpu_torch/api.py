"""The ``FlexibleModel`` facade (port of ``api.py`` and
``backends/jax_backend.py``).

The reference exposes everything through one Keras subclass
(``Flexible_Model``, flexible_IWAE.py:177-545). This facade keeps that
method-for-method surface (``compile``, ``fit``, ``train_step``, the
``get_L*``/``get_NLL``/``get_training_statistics``/activity family,
``generate``, ``tensorboard_log``, ``save_weights``/``load_weights``)
behind JAX's ``backend=`` switch, with the same three values, so that a
call written for the JAX facade runs unchanged:

* ``backend="jax"`` (the default) is the package's own path, here the
  port's: :class:`CoreFlexibleModel` over the functional core, on the card
  with its kernels (the JAX name is kept; nothing of JAX runs);
* ``backend="torch"`` is the eager oracle (``backends/torch_ref.py``):
  per-op autograd with no kernel, independent of the core;
* ``backend="tf2"`` is the TF2 oracle (``backends/tf2_ref.py``); without
  TensorFlow it raises an ImportError that names the alternatives.

``isinstance(m, FlexibleModel)`` holds for all three. :class:`FlexibleModel`
holds only what the three share: the constructor's arguments and their
validation, the output bias, the eager ``fit`` of the oracles, the
``.npz`` weights and ``tensorboard_log``; the compute lives in each
subclass, so the oracles inherit no method of the core's.

:class:`CoreFlexibleModel` keeps the JAX facade's constructor order and
defaults: ``likelihood="clamp"`` and fp32 matmuls, so that at its defaults
it is the reference's arithmetic and runs no kernel. With
``likelihood="logits"`` on the card the decoder block runs the hot-loop
kernels (B1/B2). ``mesh=`` (a ``parallel.Mesh``) or ``mesh_sp > 1`` trains
on a ``(dp, sp)`` mesh: every rank builds the facade alike, and ``fit``
runs one parallel epoch function call per epoch; evaluation stays on each
rank's device, as in JAX. ``device=`` is where the model lives (None: the
card).

Weights are saved in the JAX facade's ``.npz`` format (one entry per leaf,
in the JAX tree's order, plus the ``__meta__`` JSON of key paths and
architecture), so a file written by any backend of either package loads
into any other. The legacy ``.pkl`` payloads hold JAX treedefs and are
refused.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from iwae_replication_project_tpu_torch.evaluation import activity as au
from iwae_replication_project_tpu_torch.evaluation import metrics as ev
from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives.estimators import (
    ObjectiveSpec,
    bound_from_log_weights,
)
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils.device import resolve_device
from iwae_replication_project_tpu_torch.utils.sizes import largest_divisor_leq
from iwae_replication_project_tpu_torch.utils.tree import (
    tree_leaves,
    tree_unflatten,
)

#: 'not passed' sentinel for dataset_bias: the implicit default
#: ("binarized_mnist") differs from an explicit name combined with
#: pixel_means=/bias=, which is an error
_UNSET = object()


def key_paths(tree, prefix: str = "") -> list:
    """The ``jax.tree_util.keystr`` of every leaf's path, in leaf order:
    ``['enc'][0]['l1']['b']`` for a dict key and a sequence index."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in key_paths(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, (tuple, list)):
        return [p for i, node in enumerate(tree)
                for p in key_paths(node, f"{prefix}[{i}]")]
    return [prefix]


def assemble_tree(pairs):
    """The ``models/iwae.init_params`` tree, ``{"enc": (blk, ...), "dec":
    (blk, ...), "out": {...}}``, from ``(tree path, leaf)`` pairs as the
    oracles' correspondence walks yield them (JAX ``assemble_jax_tree``):
    one assembler for both oracles' weight and gradient exports."""
    tree = {"enc": [], "dec": [], "out": {}}
    for path, leaf in pairs:
        if path[0] == "out":
            tree["out"][path[1]] = leaf
        else:
            group, i, nm = path
            lst = tree[group]
            while len(lst) <= i:
                lst.append({})
            lst[i][nm] = leaf
    tree["enc"] = tuple(tree["enc"])
    tree["dec"] = tuple(tree["dec"])
    return tree


class FlexibleModel:
    """The facade's shared surface and its ``backend=`` switch (module
    docstring). ``FlexibleModel(...)`` returns the backend's subclass."""

    def __new__(cls, *args, backend: str = "jax", **kwargs):
        if cls is not FlexibleModel:
            return super().__new__(cls)
        if backend == "jax":
            return super().__new__(CoreFlexibleModel)
        if backend == "torch":
            from iwae_replication_project_tpu_torch.backends.torch_ref import (
                TorchFlexibleModel)
            return super().__new__(TorchFlexibleModel)
        if backend == "tf2":
            try:
                import tensorflow  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "backend='tf2' requires TensorFlow, which is not "
                    "installed in this environment. Use backend='jax' (the "
                    "port's own path, on the card) or backend='torch' (the "
                    "eager oracle).") from e
            from iwae_replication_project_tpu_torch.backends.tf2_ref import (
                TF2FlexibleModel)
            return super().__new__(TF2FlexibleModel)
        raise ValueError(f"unknown backend {backend!r}; choose jax|torch|tf2")

    def __init__(self, n_hidden_encoder: Sequence[int],
                 n_hidden_decoder: Sequence[int],
                 n_latent_encoder: Sequence[int],
                 n_latent_decoder: Sequence[int],
                 dataset_bias=_UNSET,
                 loss_function: str = "VAE", k: int = 50, p: float = 1,
                 alpha: float = 1, beta: float = 0.5, *,
                 backend: str = "jax", k2: int = 1, seed: int = 0,
                 data_dir: str = "data", pixel_means=None, bias=None):
        """`dataset_bias` is a dataset name (the output bias from its pixel
        means, local files or the synthetic fallback) or None; the bias can
        instead be given as ``pixel_means=`` (through the logit of the
        clipped mean) or ``bias=`` (installed as is). ``backend`` picked
        the subclass (:meth:`__new__`)."""
        self.n_hidden_encoder = tuple(n_hidden_encoder)
        self.n_hidden_decoder = tuple(n_hidden_decoder)
        self.n_latent_encoder = tuple(n_latent_encoder)
        self.n_latent_decoder = tuple(n_latent_decoder)
        self.loss_function = loss_function
        self.k = k
        self.p = p
        self.alpha = alpha
        self.beta = beta
        self.k2 = k2
        self.seed = seed
        self.epoch = 0  # per-batch counter (flexible_IWAE.py:245)
        # per-epoch counter of the oracles' fit() shuffle stream, apart from
        # `epoch` so the data order of fit(epochs=N) does not depend on
        # interleaved train_step() calls
        self._fit_epochs = 0
        self._logger = None
        if dataset_bias is _UNSET:
            dataset_bias = (None if pixel_means is not None or bias is not None
                            else "binarized_mnist")
        self.dataset_bias = dataset_bias
        self._output_bias = self._resolve_bias(dataset_bias, data_dir,
                                               pixel_means=pixel_means,
                                               bias=bias)

    @staticmethod
    def _resolve_bias(dataset_bias, data_dir: str, *, pixel_means=None,
                      bias=None) -> Optional[np.ndarray]:
        from iwae_replication_project_tpu_torch.data import (
            load_dataset, output_bias_from_pixel_means)

        def check_1d(a, what):
            arr = np.asarray(a, np.float32)
            if arr.ndim != 1:
                raise ValueError(f"{what} must be a 1-D array, got shape "
                                 f"{arr.shape}")
            return arr

        if pixel_means is not None or bias is not None:
            if pixel_means is not None and bias is not None:
                raise ValueError("pass pixel_means= OR bias=, not both")
            if dataset_bias is not None:
                raise ValueError(
                    "pixel_means=/bias= replace dataset_bias; leave "
                    "dataset_bias at its default (or None) when using them")
            if pixel_means is not None:
                arr = check_1d(pixel_means, "pixel_means")
                if arr.min() < 0.0 or arr.max() > 1.0:
                    raise ValueError(
                        f"pixel_means must lie in [0,1], got range "
                        f"[{arr.min():.3g}, {arr.max():.3g}]; a precomputed "
                        f"bias vector goes in bias=")
                return output_bias_from_pixel_means(arr)
            return check_1d(bias, "bias")
        if dataset_bias is None:
            return None
        if isinstance(dataset_bias, str):
            return load_dataset(dataset_bias, data_dir=data_dir,
                                allow_synthetic=True).output_bias
        raise TypeError("dataset_bias is a dataset name or None; pass an "
                        "array as pixel_means= or bias=")

    def objective_spec(self, name: Optional[str] = None,
                       k: Optional[int] = None, **over) -> ObjectiveSpec:
        return ObjectiveSpec(
            name=name or self.loss_function, k=k if k is not None else self.k,
            p=over.get("p", self.p), alpha=over.get("alpha", self.alpha),
            beta=over.get("beta", self.beta), k2=over.get("k2", self.k2))

    def fit(self, x_train, epochs: int = 1, batch_size: int = 100,
            binarization: str = "none", shuffle: bool = True,
            verbose: bool = False) -> Dict[str, list]:
        """The oracles' eager fit: one ``train_step`` per host batch
        (``backends.epoch_batches``, the JAX pipeline's shuffle), the
        reference's ``keras.Model.fit`` loop (experiment_example.py:82).
        :class:`CoreFlexibleModel` runs whole epochs on the device
        instead."""
        from iwae_replication_project_tpu_torch.backends import epoch_batches
        x_train = np.asarray(x_train, np.float32).reshape(len(x_train), -1)
        history = {"loss": []}
        for i in range(epochs):
            e = self._fit_epochs
            self._fit_epochs += 1
            losses = [self.train_step(b)[self.loss_function]
                      for b in epoch_batches(x_train, batch_size, epoch=e,
                                             seed=self.seed,
                                             binarization=binarization,
                                             shuffle=shuffle)]
            history["loss"].append(float(np.mean(losses)))
            if verbose:
                print(f"epoch {i + 1}/{epochs}: "
                      f"loss={history['loss'][-1]:.4f}")
        return history

    def serving_engine(self, **knobs):
        """An online-inference engine over this model's weights: the port's
        own path only (``backend="jax"``)."""
        raise NotImplementedError(
            "serving requires backend='jax' (the port's own path): the "
            "torch/tf2 oracles have no serving programs")

    # ------------------------------------------------------------------
    # logging and persistence
    # ------------------------------------------------------------------

    def _run_name(self) -> str:
        return f"{self.loss_function}-{len(self.n_hidden_encoder)}L-k_{self.k}"

    def tensorboard_log(self, res: dict, epoch_n: int = -1,
                        logdir: str = "runs"):
        """Write the eval scalars (flexible_IWAE.py:529-545) as JSONL and
        TensorBoard events."""
        from iwae_replication_project_tpu_torch.utils.logging import (
            MetricsLogger)
        if self._logger is None:
            self._logger = MetricsLogger(logdir, run_name=self._run_name())
        self._logger.log(res, step=self.epoch if epoch_n == -1 else epoch_n)

    def _arch_descr(self) -> dict:
        return {"n_hidden_encoder": list(self.n_hidden_encoder),
                "n_hidden_decoder": list(self.n_hidden_decoder),
                "n_latent_encoder": list(self.n_latent_encoder),
                "n_latent_decoder": list(self.n_latent_decoder)}

    def _weights_tree(self):
        """The weights as a tree in the ``models/iwae.init_params`` layout
        (kernels ``[in, out]``), leaves tensors or arrays (backend hook)."""
        raise NotImplementedError

    def _set_weights_tree(self, leaves: list) -> None:
        """Install float32 arrays, in :meth:`_weights_tree`'s leaf order,
        as the weights (backend hook)."""
        raise NotImplementedError

    def save_weights(self, path: str):
        """The weights as the JAX facade's ``.npz`` (api.py:245-274): one
        ``leaf_i`` entry per leaf and the ``__meta__`` JSON of key paths and
        architecture. Under a mesh every rank holds them; call it on one."""
        tree = self._weights_tree()
        meta = {"paths": key_paths(tree), "arch": self._arch_descr(),
                "format": 1}
        arrays = {f"leaf_{i}": _to_numpy(t)
                  for i, t in enumerate(tree_leaves(tree))}
        if path.endswith(".pkl"):
            path = path[:-len(".pkl")]
        out = path if path.endswith(".npz") else path + ".npz"
        with open(out, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        return out

    def load_weights(self, path: str):
        """Load a ``.npz`` of any backend of either package, refusing any
        structure mismatch: the architecture lists, the key paths and every
        leaf's shape and dtype must match this model (api.py:276-357)."""
        tree = self._weights_tree()
        if path.endswith(".pkl") and not os.path.exists(path) \
                and os.path.exists(path[:-len(".pkl")] + ".npz"):
            fp = path[:-len(".pkl")] + ".npz"
        elif path.endswith((".npz", ".pkl")):
            fp = path
        elif os.path.exists(path + ".npz"):
            fp = path + ".npz"
        elif os.path.exists(path + ".pkl"):
            fp = path + ".pkl"
        else:
            fp = path
        if fp.endswith(".pkl"):
            raise ValueError(
                f"{fp} is a legacy pickle of the JAX facade: it holds JAX "
                f"treedefs, which cannot be read without JAX. Load it with "
                f"the JAX package and save it again with save_weights (an "
                f".npz, which both packages read)")
        with np.load(fp) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            saved_paths = meta["paths"]
            arrays = [z[f"leaf_{i}"] for i in range(len(saved_paths))]
        saved_arch = meta.get("arch", "<unknown>")
        paths, flat = key_paths(tree), tree_leaves(tree)

        def refuse(why: str):
            raise ValueError(
                f"checkpoint architecture mismatch ({why}): checkpoint was "
                f"saved from {saved_arch}, this model is "
                f"{self._arch_descr()}")

        if isinstance(meta.get("arch"), dict) \
                and meta["arch"] != self._arch_descr():
            refuse("architecture lists differ")
        if len(flat) != len(arrays):
            refuse(f"{len(arrays)} leaves vs {len(flat)}")
        if saved_paths != paths:
            diff = next((f"{s!r} vs {c!r}" for s, c in zip(saved_paths, paths)
                         if s != c), "")
            refuse(f"parameter tree structure differs: {diff}")
        for i, (cur, saved) in enumerate(zip(flat, arrays)):
            if tuple(cur.shape) != tuple(saved.shape):
                refuse(f"leaf {i} ({paths[i]}) shape {tuple(saved.shape)} "
                       f"vs {tuple(cur.shape)}")
            if saved.dtype != np.float32:
                refuse(f"leaf {i} ({paths[i]}) dtype {saved.dtype} "
                       f"vs float32")
        self._set_weights_tree(arrays)


def _to_numpy(leaf) -> np.ndarray:
    """One weights leaf (a tensor or an array) as a float32 host array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).numpy()
    return np.asarray(leaf, np.float32)


class CoreFlexibleModel(FlexibleModel):
    """``backend="jax"``: the facade over the port's functional core, on
    the card with its kernels (module docstring)."""

    def __init__(self, *args, mesh=None, mesh_sp: int = 1,
                 compute_dtype: Optional[str] = None,
                 likelihood: str = "clamp", device=None, **kwargs):
        # the core's execution knobs are consumed here; everything else
        # must be a known base argument (a typo raises)
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        if mesh is not None:
            self.device = mesh.device
        self.cfg = model.ModelConfig(
            n_hidden_enc=self.n_hidden_encoder,
            n_latent_enc=self.n_latent_encoder,
            n_hidden_dec=self.n_hidden_decoder,
            n_latent_dec=self.n_latent_decoder,
            x_dim=self.n_latent_decoder[-1], likelihood=likelihood,
            compute_dtype=compute_dtype,
            fused_likelihood=likelihood == "logits"
            and self.device.type == "cuda")
        self.mesh = mesh
        self.mesh_sp = mesh_sp
        self.state: Optional[ts.TrainState] = None
        self._step_fn = None
        self._epoch_fn = None
        self._epoch_sig = None
        self._eval_gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 1)

    # ------------------------------------------------------------------
    # training (reference: compile/fit/train_step)
    # ------------------------------------------------------------------

    def compile(self, learning_rate: float = 1e-3):
        """Fresh weights from `seed` and Adam with the reference's eps=1e-4
        (experiment_example.py:36-40); under a mesh, each rank's state of
        it (``parallel.parallel_train_state``)."""
        self.state = ts.create_train_state(self.seed, self.cfg,
                                           output_bias=self._output_bias,
                                           lr=learning_rate,
                                           device=self.device)
        spec = self.objective_spec()
        if self.mesh is None and self.mesh_sp > 1:
            from iwae_replication_project_tpu_torch.parallel import make_mesh
            self.mesh = make_mesh(sp=self.mesh_sp, device=self.device)
        if self.mesh is not None:
            from iwae_replication_project_tpu_torch.parallel import dp as pdp
            self.state = pdp.parallel_train_state(self.mesh, self.state)
            self._step_fn = pdp.make_parallel_train_step(spec, self.cfg,
                                                         self.mesh)
            self._place_batch = lambda b: pdp.shard_batch(self.mesh, b)
        else:
            self._step_fn = ts.make_train_step(spec, self.cfg)
            self._place_batch = lambda b: b
        self._epoch_sig = None
        return self

    def set_learning_rate(self, lr: float):
        ts.set_learning_rate(self.state, lr)

    def train_step(self, x) -> Dict[str, float]:
        """One optimizer step on one batch (flexible_IWAE.py:221-247); under
        a mesh every rank passes the whole batch and takes its rows."""
        self._require_compiled()
        x = self._place_batch(self._flatten(x))
        self.state, metrics = self._step_fn(self.state, x)
        self.epoch += 1
        return {self.loss_function: float(metrics["loss"])}

    def fit(self, x_train, epochs: int = 1, batch_size: int = 100,
            binarization: str = "none", shuffle: bool = True,
            verbose: bool = False) -> Dict[str, list]:
        """Train for `epochs` passes (keras ``fit``, experiment_example.py
        :82): one epoch function call per epoch, ``training.epoch`` on one
        device and ``parallel.make_parallel_epoch_fn`` under a mesh, so
        the shuffle, the binarization and every step stay on the device."""
        self._require_compiled()
        x = self._flatten(x_train)
        epoch_fn = self._get_epoch_fn(x.shape[0], batch_size, binarization,
                                      shuffle)
        history = {"loss": []}
        n_batches = x.shape[0] // batch_size
        for e in range(epochs):
            self.state, losses = epoch_fn(self.state, x)
            self.epoch += n_batches
            history["loss"].append(float(losses.mean()))
            if verbose:
                print(f"epoch {e + 1}/{epochs}: "
                      f"loss={history['loss'][-1]:.4f}")
        return history

    def _get_epoch_fn(self, n_train: int, batch_size: int,
                      binarization: str, shuffle: bool):
        sig = (n_train, batch_size, binarization, shuffle,
               self.objective_spec(), self.mesh)
        if self._epoch_sig != sig:
            kw = dict(stochastic_binarization=binarization == "stochastic",
                      shuffle=shuffle)
            if self.mesh is not None:
                from iwae_replication_project_tpu_torch.parallel import (
                    make_parallel_epoch_fn)
                self._epoch_fn = make_parallel_epoch_fn(
                    self.objective_spec(), self.cfg, self.mesh, n_train,
                    batch_size, **kw)
            else:
                from iwae_replication_project_tpu_torch.training.epoch import (
                    make_epoch_fn)
                self._epoch_fn = make_epoch_fn(
                    self.objective_spec(), self.cfg, n_train, batch_size,
                    **kw)
            self._epoch_sig = sig
        return self._epoch_fn

    def serving_engine(self, **knobs):
        """An online-inference engine over a snapshot of the current
        weights; `k` defaults to this model's."""
        self._require_compiled()
        from iwae_replication_project_tpu_torch.serving.engine import (
            ServingEngine)
        knobs.setdefault("k", self.k)
        knobs.setdefault("device", self.device)
        params = tree_unflatten(self.params, [
            t.detach().clone() for t in tree_leaves(self.params)])
        return ServingEngine(params=params, model_config=self.cfg, **knobs)

    # ------------------------------------------------------------------
    # objectives (reference get_L_* family)
    # ------------------------------------------------------------------

    def get_log_weights(self, x, n_samples: int) -> torch.Tensor:
        self._require_compiled()
        with torch.no_grad():
            return model.log_weights(self.params, self.cfg, self._flatten(x),
                                     n_samples, generator=self._eval_gen)

    def _bound(self, name: str, x, k: int, **over) -> torch.Tensor:
        self._require_compiled()
        spec = self.objective_spec(name=name, k=k, **over)
        with torch.no_grad():
            log_w, aux = model.log_weights_and_aux(
                self.params, self.cfg, self._flatten(x), k,
                generator=self._eval_gen)
            return bound_from_log_weights(spec, log_w, aux)

    def get_L(self, x, k: int = 5000):
        return self._bound("VAE", x, k)

    def get_L_k(self, x, k: int):
        return self._bound("IWAE", x, k)

    def get_L_V1(self, x, n_samples: int):
        return self._bound("VAE_V1", x, n_samples)

    def get_L_alpha(self, x, n_samples: int, alpha: float):
        return self._bound("L_alpha", x, n_samples, alpha=alpha)

    def get_L_power_p(self, x, k: int, p: float):
        return self._bound("L_power_p", x, k, p=p)

    def get_L_median(self, x, k: int):
        return self._bound("L_median", x, k)

    def get_L_CIWAE(self, x, n_samples: int, beta: float):
        return self._bound("CIWAE", x, n_samples, beta=beta)

    def get_L_MIWAE(self, x, k1: int, k2: int):
        return self._bound("MIWAE", x, k1 * k2, k2=k2)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def get_NLL(self, x, k: int = 5000, chunk: int = 250):
        self._require_compiled()
        return ev.streaming_nll(self.params, self.cfg, self._flatten(x),
                                k=k, chunk=largest_divisor_leq(k, chunk),
                                generator=self._eval_gen)

    def reconstructed_x_probs(self, x):
        self._require_compiled()
        with torch.no_grad():
            return model.reconstruct_probs(self.params, self.cfg,
                                           self._flatten(x),
                                           generator=self._eval_gen)

    def get_reconstruction_loss(self, x):
        self._require_compiled()
        return ev.reconstruction_loss(self.params, self.cfg, self._flatten(x),
                                      generator=self._eval_gen)

    def get_E_qhIx_log_pxIh(self, x, n_samples: int):
        self._require_compiled()
        with torch.no_grad():
            _, aux = model.log_weights_and_aux(
                self.params, self.cfg, self._flatten(x), n_samples,
                generator=self._eval_gen)
            return torch.mean(aux["log_px_given_h"])

    def get_Dkl_qhIx_ph(self, x, k: int):
        """E_q[log p(x|h)] - L (flexible_IWAE.py:414-415), one pass."""
        self._require_compiled()
        with torch.no_grad():
            log_w, aux = model.log_weights_and_aux(
                self.params, self.cfg, self._flatten(x), k,
                generator=self._eval_gen)
            return torch.mean(aux["log_px_given_h"]) - torch.mean(log_w)

    def get_Dkl_qhIx_phIx(self, x, k: int):
        """L_5000 - L (flexible_IWAE.py:411-412)."""
        return -(self.get_L(x, k) + self.get_NLL(x))

    def get_levels_of_units_activity(self, x, n_samples: int):
        self._require_compiled()
        return au.posterior_mean_activity(self.params, self.cfg,
                                          self._flatten(x),
                                          n_samples=n_samples,
                                          generator=self._eval_gen)

    def get_eigenvalues_PCA(self, data):
        return au.pca_eigenvalues(torch.as_tensor(data, dtype=torch.float32))

    @staticmethod
    def _check_threshold(threshold: float) -> None:
        if threshold != au.ACTIVE_THRESHOLD:
            raise ValueError(f"the port counts active units at the paper's "
                             f"threshold {au.ACTIVE_THRESHOLD}, not "
                             f"{threshold}")

    def get_active_units(self, variances, eigen_values,
                         threshold: float = au.ACTIVE_THRESHOLD):
        self._check_threshold(threshold)
        return au.active_units(variances, eigen_values)

    def get_NLL_without_inactive_units(self, x,
                                       threshold: float = au.ACTIVE_THRESHOLD,
                                       n_samples: int = 5000,
                                       activity_samples: int = 1000):
        self._require_compiled()
        self._check_threshold(threshold)
        x = self._flatten(x)
        variances, eigvals = self.get_levels_of_units_activity(
            x, activity_samples)
        masks, _, _ = au.active_units(variances, eigvals)
        return au.nll_without_inactive_units(self.params, self.cfg, x, masks,
                                             k=n_samples,
                                             generator=self._eval_gen)

    def get_training_statistics(self, x, k: int, batch_size: int = 100,
                                **kw) -> Tuple[dict, dict]:
        """The evaluation suite (``evaluation.training_statistics``);
        `batch_size` stays 100 on the facade, as in JAX."""
        self._require_compiled()
        return ev.training_statistics(self.params, self.cfg,
                                      self._flatten(x), k,
                                      batch_size=batch_size,
                                      generator=self._eval_gen, **kw)

    def generate(self, n: int, generator: Optional[torch.Generator] = None):
        """Ancestral samples from the prior: pixel probabilities
        ``[n, x_dim]``."""
        self._require_compiled()
        gen = generator if generator is not None else self._eval_gen
        with torch.no_grad():
            h_top = torch.randn((1, n, self.cfg.n_latent_enc[-1]),
                                generator=gen, device=self.device)
            return model.generate_x(self.params, self.cfg, h_top,
                                    generator=gen)[0]

    # ------------------------------------------------------------------

    @property
    def params(self):
        return self.state.params

    def _weights_tree(self):
        self._require_compiled()
        return self.params

    def _set_weights_tree(self, leaves: list) -> None:
        with torch.no_grad():
            for cur, saved in zip(tree_leaves(self.params), leaves):
                cur.copy_(torch.from_numpy(saved))
        self.state.graphs.clear()

    def _require_compiled(self):
        if self.state is None:
            raise RuntimeError("call .compile() before training/evaluation")

    def _flatten(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, dtype=torch.float32).to(self.device)
        return x.reshape(x.shape[0], -1)
