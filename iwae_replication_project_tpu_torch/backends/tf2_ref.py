"""The eager TF2 oracle behind ``backend="tf2"`` (port of
``backends/tf2_ref.py``): the reference's own execution style (an
eager-TF2/Keras/TFP class, flexible_IWAE.py:177-545) behind the facade.

As in the JAX package it has no TFP dependency (closed-form Normal and
Bernoulli log-densities with the parity constants: std floor 1e-6, prob
clamp ``p*(1-1e-6)+1e-7``), no Keras layers (plain ``tf.Variable``s in the
``models/iwae.init_params`` layout, ``w [in, out]``, so weight tying is a
direct copy), and gradients by ``tf.GradientTape``, with DReG/STL/PIWAE as
surrogate scalars on score-stopped graphs, mirroring ``torch_ref``.

TensorFlow is imported when the first model is built, never when this
module is imported (the card's machine has no TensorFlow, and the facade
refuses ``backend="tf2"`` there with the guidance error). TF places its own
ops: ``device=`` is accepted and ignored, as the core's execution knobs
are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from iwae_replication_project_tpu_torch.api import (
    FlexibleModel,
    assemble_tree,
)
from iwae_replication_project_tpu_torch.utils.sizes import largest_divisor_leq

_PCLAMP_SCALE = 1.0 - 1e-6
_PCLAMP_SHIFT = 1e-7
_STD_FLOOR = 1e-6
_LOG_2PI = float(np.log(2.0 * np.pi))

#: the ``tensorflow`` module, bound by :func:`_load_tf` when the first model
#: is built
tf = None


def _load_tf():
    global tf
    if tf is None:
        import tensorflow
        tf = tensorflow
    return tf


class TF2FlexibleModel(FlexibleModel):
    def __init__(self, *args, mesh=None, mesh_sp: int = 1, compute_dtype=None,
                 likelihood: str = "clamp", device=None, **kwargs):
        # accept (and ignore) the core's execution knobs so callers can flip
        # backend= without changing anything else; unknown kwargs raise
        super().__init__(*args, **kwargs)
        _load_tf()
        # seed BOTH streams: the Generator drives weight init; the global
        # op-level seed drives every tf.random.normal sampling call (the
        # JAX package's tf2 oracle's whole-process semantics)
        tf.random.set_seed(self.seed)
        rng = tf.random.Generator.from_seed(self.seed)

        def dense(in_dim, out_dim):
            lim = float(np.sqrt(6.0 / (in_dim + out_dim)))
            return {"w": tf.Variable(rng.uniform((in_dim, out_dim),
                                                 -lim, lim, tf.float32)),
                    "b": tf.Variable(tf.zeros((out_dim,), tf.float32))}

        def block(in_dim, hidden, latent):
            return {"l1": dense(in_dim, hidden), "l2": dense(hidden, hidden),
                    "mu": dense(hidden, latent), "lstd": dense(hidden, latent)}

        L = len(self.n_hidden_encoder)
        self.L = L
        x_dim = self.n_latent_decoder[-1]
        enc, in_dim = [], x_dim
        for i in range(L):
            enc.append(block(in_dim, self.n_hidden_encoder[i],
                             self.n_latent_encoder[i]))
            in_dim = self.n_latent_encoder[i]
        self.enc = enc
        dec, in_dim = [], self.n_latent_encoder[-1]
        for i in range(L - 1):
            dec.append(block(in_dim, self.n_hidden_decoder[i],
                             self.n_latent_decoder[i]))
            in_dim = self.n_latent_decoder[i]
        self.dec = dec
        self.out = {"l1": dense(in_dim, self.n_hidden_decoder[-1]),
                    "l2": dense(self.n_hidden_decoder[-1],
                                self.n_hidden_decoder[-1]),
                    "out": dense(self.n_hidden_decoder[-1], x_dim)}
        if self._output_bias is not None:
            self.out["out"]["b"].assign(
                np.asarray(self._output_bias, np.float32))
        self.optimizer = None

    # ------------------------------------------------------------------
    # parameter plumbing
    # ------------------------------------------------------------------

    def _iter_dense_tree(self):
        """``(dense-param dict, tree path)`` pairs — the correspondence
        contract of torch_ref._iter_linear_tree (layout already [in, out])."""
        for group, blocks in (("enc", self.enc), ("dec", self.dec)):
            for i, blk in enumerate(blocks):
                for nm in ("l1", "l2", "mu", "lstd"):
                    yield blk[nm], (group, i, nm)
        for nm in ("l1", "l2", "out"):
            yield self.out[nm], ("out", nm)

    def variables(self):
        out = []
        for d, _ in self._iter_dense_tree():
            out.extend([d["w"], d["b"]])
        return out

    def _param_groups(self):
        enc, rest = [], []
        for d, path in self._iter_dense_tree():
            (enc if path[0] == "enc" else rest).extend([d["w"], d["b"]])
        return enc, rest

    def load_jax_params(self, params) -> "TF2FlexibleModel":
        """Copy a parameter tree in the ``models/iwae.init_params`` layout
        (the JAX package's or the port's; tensors or arrays) into this
        backend, for weight-tied comparisons. The same [in, out] kernel
        layout, so the copy is direct."""
        for d, path in self._iter_dense_tree():
            node = params
            for pkey in path:
                node = node[pkey]
            d["w"].assign(_host(node["w"]))
            d["b"].assign(_host(node["b"]))
        return self

    def _weights_tree(self):
        """Weights in the ``init_params`` layout (kernels already
        [in, out]): the facade's shared ``.npz`` payload."""
        return assemble_tree(
            (path, {"w": d["w"].numpy(), "b": d["b"].numpy()})
            for d, path in self._iter_dense_tree())

    def _set_weights_tree(self, leaves: list) -> None:
        from iwae_replication_project_tpu_torch.utils.tree import (
            tree_unflatten)
        self.load_jax_params(tree_unflatten(self._weights_tree(), leaves))

    # ------------------------------------------------------------------
    # model math (parity constants of flexible_IWAE.py:75,102)
    # ------------------------------------------------------------------

    def _dense(self, d, x):
        return tf.linalg.matmul(x, d["w"]) + d["b"]

    def _block(self, blk, x):
        y = tf.tanh(self._dense(blk["l1"], x))
        y = tf.tanh(self._dense(blk["l2"], y))
        mu = self._dense(blk["mu"], y)
        std = tf.exp(self._dense(blk["lstd"], y)) + _STD_FLOOR
        return mu, std

    @staticmethod
    def _normal_log_prob(x, mu, std):
        z = (x - mu) / std
        return -0.5 * z * z - tf.math.log(std) - 0.5 * _LOG_2PI

    def _encode(self, x, k: int, stop_q_score: bool = False, masks=None):
        """Encoder pass; `masks` zeroes inactive latent coords after sampling,
        densities evaluated at the masked values (flexible_IWAE.py:466-494
        semantics, = evaluation/activity.py)."""
        sg = tf.stop_gradient if stop_q_score else (lambda t: t)
        mu, std = self._block(self.enc[0], x)
        h1 = mu + std * tf.random.normal((k,) + tuple(mu.shape))
        if masks is not None:
            h1 = h1 * masks[0]
        log_q = tf.reduce_sum(self._normal_log_prob(h1, sg(mu), sg(std)), -1)
        h = [h1]
        q_last = (mu, std)
        for i in range(1, self.L):
            mu, std = self._block(self.enc[i], h[-1])
            hi = mu + std * tf.random.normal(tf.shape(mu))
            if masks is not None:
                hi = hi * masks[i]
            log_q = log_q + tf.reduce_sum(
                self._normal_log_prob(hi, sg(mu), sg(std)), -1)
            h.append(hi)
            q_last = (mu, std)
        return h, log_q, q_last

    def _decode_probs(self, h1):
        y = tf.tanh(self._dense(self.out["l1"], h1))
        y = tf.tanh(self._dense(self.out["l2"], y))
        probs = tf.sigmoid(self._dense(self.out["out"], y))
        return probs * _PCLAMP_SCALE + _PCLAMP_SHIFT

    def _log_weights_aux(self, x, k: int, stop_q_score: bool = False,
                         masks=None):
        h, log_q, q_last = self._encode(x, k, stop_q_score=stop_q_score,
                                        masks=masks)
        probs = self._decode_probs(h[0])
        log_pxIh = tf.reduce_sum(
            x * tf.math.log(probs) + (1 - x) * tf.math.log1p(-probs), -1)
        log_ph = tf.reduce_sum(-0.5 * h[-1] ** 2 - 0.5 * _LOG_2PI, -1)
        for i in range(self.L - 1):
            mu, std = self._block(self.dec[i], h[self.L - 1 - i])
            log_ph = log_ph + tf.reduce_sum(
                self._normal_log_prob(h[self.L - 2 - i], mu, std), -1)
        return log_ph + log_pxIh - log_q, {"log_px_given_h": log_pxIh,
                                           "q_last": q_last, "h": h}

    def get_log_weights(self, x, n_samples: int):
        return self._log_weights_aux(self._flatten(x), n_samples)[0]

    # ------------------------------------------------------------------
    # bounds (same reducer family as objectives/estimators.py)
    # ------------------------------------------------------------------

    @staticmethod
    def _iwae(log_w):
        m = tf.stop_gradient(tf.reduce_max(log_w, axis=0, keepdims=True))
        return tf.reduce_mean(
            tf.math.log(tf.reduce_mean(tf.exp(log_w - m), axis=0)) + m[0])

    @staticmethod
    def _miwae(log_w, k2: int):
        k = log_w.shape[0]
        g = tf.reshape(log_w, (k2, k // k2) + tuple(log_w.shape[1:]))
        m = tf.stop_gradient(tf.reduce_max(g, axis=1, keepdims=True))
        return tf.reduce_mean(
            tf.math.log(tf.reduce_mean(tf.exp(g - m), axis=1)) + m[:, 0])

    def _bound(self, name, x, k, **over):
        x = self._flatten(x)
        log_w, aux = self._log_weights_aux(x, k)
        if name == "VAE":
            return tf.reduce_mean(log_w)
        if name == "IWAE":
            return self._iwae(log_w)
        if name == "L_power_p":
            p = over.get("p", self.p)
            return self._iwae(p * log_w) / p
        if name == "L_median":
            # interpolating median over the k axis (jnp.median semantics)
            s = tf.sort(log_w, axis=0)
            lo, hi = (k - 1) // 2, k // 2
            return tf.reduce_mean((s[lo] + s[hi]) / 2.0)
        if name == "CIWAE":
            b = over.get("beta", self.beta)
            return b * tf.reduce_mean(log_w) + (1 - b) * self._iwae(log_w)
        if name == "L_alpha":
            a = over.get("alpha", self.alpha)
            return ((1 - a) * tf.reduce_mean(aux["log_px_given_h"])
                    + a * tf.reduce_mean(log_w))
        if name == "MIWAE":
            return self._miwae(log_w, over.get("k2", self.k2))
        if name == "VAE_V1":
            if len(self.enc) > 1:
                raise ValueError(
                    "VAE_V1's analytic KL is defined for single-stochastic-"
                    "layer models only (flexible_IWAE.py:433); this model "
                    f"has {len(self.enc)} stochastic layers")
            mu, std = aux["q_last"]
            kl = tf.reduce_mean(tf.reduce_sum(
                -0.5 * (1 + 2 * tf.math.log(std) - mu ** 2 - std ** 2), -1))
            return tf.reduce_mean(aux["log_px_given_h"]) - kl
        raise NotImplementedError(
            f"objective {name!r} is not implemented in the tf2 backend")

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
    # training
    # ------------------------------------------------------------------

    def compile(self, optimizer=None, learning_rate: float = 1e-3):
        self.optimizer = optimizer or tf.keras.optimizers.Adam(
            learning_rate=learning_rate, beta_1=0.9, beta_2=0.999,
            epsilon=1e-4)
        return self

    def set_learning_rate(self, lr: float):
        self.optimizer.learning_rate.assign(lr)

    def _estimator_value_and_grads(self, x, name: str, k: int, k2: int = 1):
        """DReG/STL/PIWAE gradients via surrogate scalars on a GradientTape
        (same derivation as torch_ref._estimator_value_and_grads). Returns
        ``(bound, variables, grads)`` as parallel lists (tf.Variable is not
        hashable in eager mode, so no dict keying)."""
        x = self._flatten(x)
        enc_v, rest_v = self._param_groups()
        varlist = enc_v + rest_v
        if name in ("DReG", "STL"):
            with tf.GradientTape(persistent=True) as tape:
                log_w, _ = self._log_weights_aux(x, k, stop_q_score=True)
                B = int(log_w.shape[1])
                w = tf.stop_gradient(tf.nn.softmax(log_w, axis=0))
                s_dec = tf.reduce_sum(w * log_w) / B
                s_enc = tf.reduce_sum(w ** 2 * log_w) / B
            bound = self._iwae(tf.stop_gradient(log_w))
            if name == "STL":
                grads = tape.gradient(s_dec, varlist)
            else:
                grads = (tape.gradient(s_enc, enc_v)
                         + tape.gradient(s_dec, rest_v))
            del tape
            return bound, varlist, grads
        if name == "PIWAE":
            with tf.GradientTape(persistent=True) as tape:
                log_w, _ = self._log_weights_aux(x, k)
                bound = self._iwae(log_w)
                miwae = self._miwae(log_w, k2)
            grads = tape.gradient(miwae, enc_v) + tape.gradient(bound, rest_v)
            del tape
            return bound, varlist, grads
        raise NotImplementedError(name)

    def train_step(self, x) -> Dict[str, float]:
        if self.optimizer is None:
            raise RuntimeError("call .compile() first")
        if self.loss_function in ("DReG", "STL", "PIWAE"):
            bound, varlist, grads = self._estimator_value_and_grads(
                x, self.loss_function, self.k, k2=self.k2)
            self.optimizer.apply_gradients(
                [(-g, v) for g, v in zip(grads, varlist) if g is not None])
            self.epoch += 1
            return {self.loss_function: float(-bound)}
        varlist = self.variables()
        with tf.GradientTape() as tape:
            loss = -self._bound(self.loss_function, x, self.k)
        grads = tape.gradient(loss, varlist)
        self.optimizer.apply_gradients(
            [(g, v) for g, v in zip(grads, varlist) if g is not None])
        self.epoch += 1
        return {self.loss_function: float(loss)}

    # fit() is the shared eager loop on the base facade
    # (api.FlexibleModel.fit); train_step accepts numpy via _flatten.

    # ------------------------------------------------------------------
    # evaluation surface (parity with flexible_IWAE.py:249-302, 466-526)
    # ------------------------------------------------------------------

    def _generate_from_top(self, h_top):
        h = h_top
        for i in range(self.L - 1):
            mu, std = self._block(self.dec[i], h)
            h = mu + std * tf.random.normal(tf.shape(mu))
        return self._decode_probs(h)

    def reconstructed_x_probs(self, x):
        h, _, _ = self._encode(self._flatten(x), 1)
        return self._generate_from_top(h[-1])

    def generate(self, n: int):
        h_top = tf.random.normal((1, n, self.n_latent_encoder[-1]))
        return self._generate_from_top(h_top)[0]

    def get_reconstruction_loss(self, x):
        x = self._flatten(x)
        probs = self.reconstructed_x_probs(x)
        lp = tf.reduce_sum(
            x * tf.math.log(probs) + (1 - x) * tf.math.log1p(-probs), -1)
        return -tf.reduce_mean(lp)

    def get_E_qhIx_log_pxIh(self, x, n_samples: int):
        _, aux = self._log_weights_aux(self._flatten(x), n_samples)
        return tf.reduce_mean(aux["log_px_given_h"])

    def get_Dkl_qhIx_ph(self, x, k: int):
        lw, aux = self._log_weights_aux(self._flatten(x), k)
        return tf.reduce_mean(aux["log_px_given_h"]) - tf.reduce_mean(lw)

    def get_Dkl_qhIx_phIx(self, x, k: int):
        return -(self._bound("VAE", x, k) + self.get_NLL(x))

    def get_NLL(self, x, k: int = 5000, chunk: int = 250):
        """Streaming large-k NLL, online logsumexp in O(chunk) memory."""
        chunk = largest_divisor_leq(k, chunk)
        x = self._flatten(x)
        n = int(x.shape[0])
        m = tf.fill((n,), -np.inf)
        s = tf.zeros((n,))
        for _ in range(k // chunk):
            lw, _ = self._log_weights_aux(x, chunk)
            cm = tf.maximum(m, tf.reduce_max(lw, axis=0))
            s = s * tf.exp(m - cm) + tf.reduce_sum(tf.exp(lw - cm), axis=0)
            m = cm
        return -tf.reduce_mean(tf.math.log(s / k) + m)

    def get_levels_of_units_activity(self, x, n_samples: int, chunk: int = 10):
        x = self._flatten(x)
        n = int(x.shape[0])
        sums = [tf.zeros((n, d)) for d in self.n_latent_encoder]
        done = 0
        while done < n_samples:
            c = min(chunk, n_samples - done)
            h, _, _ = self._encode(x, c)
            for j, hj in enumerate(h):
                sums[j] = sums[j] + tf.reduce_sum(hj, axis=0)
            done += c
        means = [s / n_samples for s in sums]
        variances = [tf.math.reduce_variance(mn, axis=0) for mn in means]
        eig = [self.get_eigenvalues_PCA(mn) for mn in means]
        return variances, eig

    def get_eigenvalues_PCA(self, data):
        data = tf.convert_to_tensor(np.asarray(data), tf.float32)
        centered = data - tf.reduce_mean(data, axis=0)
        cov = tf.linalg.matmul(centered, centered, transpose_a=True) \
            / float(data.shape[0])
        return tf.linalg.eigvalsh(cov)

    def get_active_units(self, variances, eigen_values, threshold: float = 0.01):
        masks = [tf.cast(v > threshold, tf.float32) for v in variances]
        n_active = [int(tf.reduce_sum(mk)) for mk in masks]
        n_pca = [int(tf.reduce_sum(tf.cast(e > threshold, tf.int32)))
                 for e in eigen_values]
        return masks, n_active, n_pca

    def _masked_log_weights(self, x, masks, k: int):
        return self._log_weights_aux(x, k, masks=masks)[0]

    def get_NLL_without_inactive_units(self, x, threshold: float = 0.01,
                                       n_samples: int = 5000,
                                       activity_samples: int = 1000,
                                       chunk: int = 250):
        x = self._flatten(x)
        variances, eig = self.get_levels_of_units_activity(x, activity_samples)
        masks, _, _ = self.get_active_units(variances, eig, threshold)
        chunk = largest_divisor_leq(n_samples, chunk)
        n = int(x.shape[0])
        m = tf.fill((n,), -np.inf)
        s = tf.zeros((n,))
        for _ in range(n_samples // chunk):
            lw = self._masked_log_weights(x, masks, chunk)
            cm = tf.maximum(m, tf.reduce_max(lw, axis=0))
            s = s * tf.exp(m - cm) + tf.reduce_sum(tf.exp(lw - cm), axis=0)
            m = cm
        return -tf.reduce_mean(tf.math.log(s / n_samples) + m)

    def get_training_statistics(self, x, k: int, batch_size: int = 100,
                                nll_k: int = 5000, nll_chunk: int = 250,
                                activity_samples: int = 1000,
                                activity_threshold: float = 0.01,
                                include_pruned_nll: bool = True):
        """The evaluation suite, the core's and torch_ref's schema
        (flexible_IWAE.py:496-526)."""
        x = self._flatten(x)
        n = int(x.shape[0])
        batch_size = largest_divisor_leq(n, batch_size)
        nll_chunk = largest_divisor_leq(nll_k, nll_chunk)
        n_batches = n // batch_size

        acc = {"VAE": 0.0, "IWAE": 0.0, "NLL": 0.0,
               "E_q(h|x)[log(p(x|h))]": 0.0, "D_kl(q(h|x),p(h))": 0.0,
               "D_kl(q(h|x),p(h|x))": 0.0, "reconstruction_loss": 0.0,
               "nll_chunk": float(nll_chunk),
               "eval_batch": float(batch_size)}
        for i in range(n_batches):
            xb = x[i * batch_size:(i + 1) * batch_size]
            lw, aux = self._log_weights_aux(xb, k)
            vae = float(tf.reduce_mean(lw))
            recon_term = float(tf.reduce_mean(aux["log_px_given_h"]))
            nll = float(self.get_NLL(xb, k=nll_k, chunk=nll_chunk))
            acc["VAE"] += vae / n_batches
            acc["IWAE"] += float(self._iwae(lw)) / n_batches
            acc["NLL"] += nll / n_batches
            acc["E_q(h|x)[log(p(x|h))]"] += recon_term / n_batches
            acc["D_kl(q(h|x),p(h))"] += (recon_term - vae) / n_batches
            acc["D_kl(q(h|x),p(h|x))"] += (-nll - vae) / n_batches
            acc["reconstruction_loss"] += float(
                self.get_reconstruction_loss(xb)) / n_batches

        variances, eig = self.get_levels_of_units_activity(x, activity_samples)
        masks, n_active, n_pca = self.get_active_units(variances, eig,
                                                       activity_threshold)
        res2 = {"active_units": masks, "number_of_active_units": n_active,
                "number_of_PCA_active_units": n_pca, "variances": variances}
        if include_pruned_nll:
            acc["LL_pruned"] = float(self.get_NLL_without_inactive_units(
                x[:batch_size], activity_threshold, nll_k, activity_samples,
                nll_chunk))
        return acc, res2

    # tensorboard_log() is shared on the base facade (api.FlexibleModel).

    @staticmethod
    def _flatten(x):
        x = tf.convert_to_tensor(_host(x))
        return tf.reshape(x, (x.shape[0], -1))


def _host(a) -> np.ndarray:
    """A tensor of either framework, or an array, as a float32 host array."""
    if hasattr(a, "detach"):        # a torch tensor
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)
