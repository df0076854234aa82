"""Dataset layer (port of ``data/loaders.py``, copied: it is numpy-only):
MNIST / fixed-binarization MNIST / Fashion-MNIST / Omniglot / digits.

Every dataset resolves from a local ``data_dir`` (idx-ubyte / .npz / .amat /
chardata.mat), and a deterministic synthetic fallback, announced loudly,
stands in when the files are absent. The output-layer bias is computed here
from training pixel means and handed to the model as a value. The digits
datasets import scikit-learn, and Omniglot scipy, only when asked for.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

X_DIM = 28 * 28


@dataclasses.dataclass
class Dataset:
    """Host-side dataset: float32 arrays in [0, 1], shape [N, 784]."""

    name: str
    x_train: np.ndarray
    x_test: np.ndarray
    #: pixel means used for the decoder output-bias init. May come from a
    #: DIFFERENT source than x_train: the reference initializes the fixed-bin
    #: model with raw-MNIST means (flexible_IWAE.py:150-155).
    bias_means: np.ndarray
    #: "none" (already binary / leave as-is) or "stochastic" (re-binarize per
    #: batch — the Burda protocol the PDF p.13 flags as the discrepancy).
    binarization: str = "none"
    #: True when the named dataset was NOT found on disk and deterministic
    #: synthetic blobs were substituted — downstream results are not
    #: comparable to any published number.
    synthetic: bool = False
    #: where `bias_means` came from: "raw" = raw grayscale means (the
    #: reference's fixed-binarization policy, flexible_IWAE.py:150-155),
    #: "train" = means of x_train itself (the default for every other
    #: dataset, and the fallback when raw files are absent).
    bias_source: str = "train"

    @property
    def output_bias(self) -> np.ndarray:
        return output_bias_from_pixel_means(self.bias_means)


def output_bias_from_pixel_means(means: np.ndarray) -> np.ndarray:
    """logit of the clipped mean pixel value — the decoder's output-bias init
    (formula of flexible_IWAE.py:174)."""
    clipped = np.clip(means, 0.001, 0.999)
    return (-np.log(1.0 / clipped - 1.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# Raw-format readers (all offline)
# ---------------------------------------------------------------------------

def _read_idx_images(path: str) -> np.ndarray:
    """MNIST/Fashion idx3-ubyte (optionally .gz) -> [N, 784] float32 in [0,1]."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx magic {magic}")
        buf = f.read(n * rows * cols)
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(n, rows * cols)
    return arr.astype(np.float32) / 255.0


def _warn_loud(msg: str) -> None:
    """Banner on stderr + plain line on stdout — the same double-channel the
    synthetic-data fallback uses, so the warning survives both log captures."""
    import sys
    banner = "=" * 78
    print(f"{banner}\nWARNING: {msg}\n{banner}", file=sys.stderr, flush=True)
    print(f"WARNING: {msg}", flush=True)


def _find(data_dir: str, candidates) -> Optional[str]:
    for c in candidates:
        p = os.path.join(data_dir, c)
        if os.path.exists(p):
            return p
    return None


def _load_idx_pair(data_dir: str, train_names, test_names) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    tr = _find(data_dir, train_names)
    te = _find(data_dir, test_names)
    if tr is None or te is None:
        return None
    return _read_idx_images(tr), _read_idx_images(te)


def _load_npz(data_dir: str, names) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    p = _find(data_dir, names)
    if p is None:
        return None
    with np.load(p) as z:
        xtr = z["x_train"].reshape(-1, X_DIM).astype(np.float32)
        xte = z["x_test"].reshape(-1, X_DIM).astype(np.float32)
    if xtr.max() > 1.0:
        xtr, xte = xtr / 255.0, xte / 255.0
    return xtr, xte


def _load_amat(data_dir: str, train_names, test_names) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Larochelle-format binarized-MNIST .amat text files."""
    tr = _find(data_dir, train_names)
    te = _find(data_dir, test_names)
    if tr is None or te is None:
        return None
    return (np.loadtxt(tr, dtype=np.float32), np.loadtxt(te, dtype=np.float32))


def _load_omniglot_mat(data_dir: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Burda-split Omniglot `chardata.mat` (flexible_IWAE.py:164-165 uses the
    same file; parsed here with scipy if present, else a minimal .mat reader
    is out of scope -> require scipy)."""
    p = _find(data_dir, ["chardata.mat"])
    if p is None:
        return None
    import scipy.io as sio

    d = sio.loadmat(p)
    xtr = d["data"].T.reshape(-1, X_DIM).astype(np.float32)
    xte = d["testdata"].T.reshape(-1, X_DIM).astype(np.float32)
    return xtr, xte


def _synthetic(name: str, n_train: int = 1024, n_test: int = 256,
               seed: int = 0, binary: bool = True
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like blobs: mixture of per-class pixel-probability
    templates. Keeps tests/benches hermetic and shape-true.

    ``binary=True`` samples pixels to {0,1} (fixed-binarization stand-in);
    ``binary=False`` returns the grayscale probabilities themselves, so
    datasets whose protocol is per-epoch stochastic binarization feed the
    re-binarization path values genuinely in (0,1) — with binary inputs,
    ``bernoulli(p)`` is the identity and the stochastic path would be
    exercised in name only."""
    rs = np.random.RandomState(seed + (zlib.crc32(name.encode()) % 1000))
    n_classes = 10
    yy, xx = np.mgrid[0:28, 0:28] / 27.0
    templates = []
    for c in range(n_classes):
        cx, cy = rs.uniform(0.25, 0.75, 2)
        r1, r2 = rs.uniform(0.05, 0.2, 2)
        blob = np.exp(-(((xx - cx) ** 2) / (2 * r1 ** 2) + ((yy - cy) ** 2) / (2 * r2 ** 2)))
        ring = np.exp(-((np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) - 0.25) ** 2) / 0.004)
        templates.append(np.clip(0.85 * blob + 0.6 * ring, 0.01, 0.95).ravel())
    templates = np.stack(templates)

    def sample(n, seed2):
        rs2 = np.random.RandomState(seed2)
        cls = rs2.randint(0, n_classes, n)
        probs = templates[cls]
        if not binary:
            return probs.astype(np.float32)
        return (rs2.uniform(size=probs.shape) < probs).astype(np.float32)

    return sample(n_train, seed + 1), sample(n_test, seed + 2)


# ---------------------------------------------------------------------------
# Public registry
# ---------------------------------------------------------------------------

DATASETS = ("binarized_mnist", "mnist", "fashion_mnist", "omniglot", "digits",
            "digits_gray")


#: train/test split point of the 1797 sklearn digits
_DIGITS_N_TRAIN = 1500


def _digits_gray_arrays() -> Tuple[np.ndarray, np.ndarray]:
    """sklearn's bundled UCI optdigits as 28x28 grayscale intensities in
    [0, 1]: nearest-neighbor upsample 8x8 -> 32x32, center-crop to 28x28
    (the same geometry prep `digits` uses before its fixed draw)."""
    from sklearn.datasets import load_digits as _sk_load_digits

    d = _sk_load_digits()
    gray = d.images.astype(np.float32) / 16.0  # [1797, 8, 8] in [0, 1]
    up = np.repeat(np.repeat(gray, 4, axis=1), 4, axis=2)  # [N, 32, 32]
    up = up[:, 2:30, 2:30].reshape(-1, X_DIM)  # center-crop -> [N, 784]
    return up[:_DIGITS_N_TRAIN], up[_DIGITS_N_TRAIN:]


def _load_sklearn_digits(seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """REAL handwritten-digit data that ships inside scikit-learn (UCI
    optdigits, 1797 8x8 grayscale images) — the only real image dataset
    available in this zero-egress environment.

    Prepared to mirror the fixed-binarization MNIST protocol (PDF §3.1):
    grayscale prep (:func:`_digits_gray_arrays`), then ONE deterministic
    Bernoulli binarization (Larochelle-style fixed draw). Returns
    ``(x_train_bin, x_test_bin, raw_train_means)`` — the raw grayscale means
    feed the bias init, reproducing the reference's raw-means-for-fixed-bin
    policy (flexible_IWAE.py:150-155).
    """
    gray_train, gray_test = _digits_gray_arrays()
    up = np.concatenate([gray_train, gray_test])
    rs = np.random.RandomState(seed)
    binary = (rs.uniform(size=up.shape) < up).astype(np.float32)
    n_train = len(gray_train)
    return binary[:n_train], binary[n_train:], gray_train.mean(axis=0)


_MNIST_TRAIN = ["train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"]
_MNIST_TEST = ["t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz"]


def load_dataset(name: str, data_dir: str = "data", allow_synthetic: bool = True,
                 synthetic_sizes: Tuple[int, int] = (1024, 256)) -> Dataset:
    """Resolve `name` from local files in `data_dir`, else synthetic fallback.

    Binarization policy mirrors the reference experiments (PDF §3.1):
    fixed-bin MNIST ships binary; "mnist"/"fashion_mnist"/"omniglot" use
    per-batch stochastic binarization of the grayscale intensities.
    """
    name = name.lower()
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; choose from {DATASETS}")

    pair = None
    bias_means = None
    if name == "binarized_mnist":
        pair = (_load_amat(data_dir,
                           ["binarized_mnist_train.amat", "binarized_mnist-train.amat"],
                           ["binarized_mnist_test.amat", "binarized_mnist-test.amat"])
                or _load_npz(data_dir, ["binarized_mnist.npz"]))
        # bias uses RAW mnist means when available (flexible_IWAE.py:150-155)
        raw = (_load_idx_pair(os.path.join(data_dir, "mnist"), _MNIST_TRAIN, _MNIST_TEST)
               or _load_idx_pair(data_dir, _MNIST_TRAIN, _MNIST_TEST)
               or _load_npz(data_dir, ["mnist.npz"])
               or _load_npz(os.path.join(data_dir, "mnist"), ["mnist.npz"]))
        if raw is not None:
            bias_means = raw[0].mean(axis=0)
        binarization = "none"
    elif name in ("mnist", "fashion_mnist"):
        sub = os.path.join(data_dir, name)
        pair = (_load_idx_pair(sub, _MNIST_TRAIN, _MNIST_TEST)
                or _load_npz(data_dir, [f"{name}.npz"]))
        # root-level idx files are accepted for plain MNIST only — fashion
        # shares the idx filenames, so a root fallback would silently load the
        # wrong dataset
        if pair is None and name == "mnist":
            pair = _load_idx_pair(data_dir, _MNIST_TRAIN, _MNIST_TEST)
        binarization = "stochastic"
    elif name == "omniglot":
        pair = _load_omniglot_mat(data_dir) or _load_npz(data_dir, ["omniglot.npz"])
        binarization = "stochastic"
    elif name == "digits":  # bundled with scikit-learn, needs no data_dir
        xtr, xte, raw_means = _load_sklearn_digits()
        pair = (xtr, xte)
        bias_means = raw_means
        binarization = "none"
    else:  # digits_gray: the same real images under the PDF Table 2 protocol
        # (grayscale intensities kept; per-epoch stochastic re-binarization
        # on device, like the reference's "mnist"/"omniglot" datasets —
        # flexible_IWAE.py:147-175). Bias comes from the grayscale train
        # means, which for this dataset ARE the raw means.
        pair = _digits_gray_arrays()
        binarization = "stochastic"

    # The fixed-binarization bias policy is a known tenths-of-nats NLL lever
    # (flexible_IWAE.py:150-155): silently substituting binarized-train means
    # would make a replication attempt quietly diverge from the reference.
    if name == "binarized_mnist" and pair is not None and bias_means is None:
        _warn_loud(
            f"dataset 'binarized_mnist' loaded from {data_dir!r} WITHOUT raw "
            f"MNIST files alongside — the decoder output bias will fall back "
            f"to binarized-train pixel means instead of the reference's "
            f"raw-MNIST means (flexible_IWAE.py:150-155). NLL may differ from "
            f"published numbers by tenths of nats. Place raw idx files "
            f"({_MNIST_TRAIN[0]}[.gz] / {_MNIST_TEST[0]}[.gz]) or mnist.npz "
            f"in {data_dir!r} (or its mnist/ subdir) to restore the policy.")

    synthetic = False
    if pair is None:
        if not allow_synthetic:
            raise FileNotFoundError(
                f"dataset {name!r} not found under {data_dir!r} and synthetic "
                f"fallback disabled")
        synthetic = True
        # any bias means gathered from real raw files must not leak into the
        # synthetic run: initializing the decoder bias to real-MNIST pixel
        # means while training on blobs would both skew the fake run and let
        # metrics certify `raw_means_bias` on data the policy never saw
        bias_means = None
        _warn_loud(
            f"dataset {name!r} NOT FOUND under {data_dir!r} — substituting "
            f"SYNTHETIC blobs. Results are NOT comparable to published "
            f"numbers. Place real files in {data_dir!r} (see data/loaders.py "
            f"docstring / scripts/prepare_data.py) or pass "
            f"allow_synthetic=False to fail instead.")
        # stochastic-binarization datasets get grayscale synthetic values so
        # the per-epoch re-binarization path sees real (0,1) probabilities
        pair = _synthetic(name, *synthetic_sizes,
                          binary=binarization != "stochastic")

    x_train, x_test = pair
    bias_source = "raw"
    if bias_means is None:
        bias_means = x_train.mean(axis=0)
        bias_source = "train"
    return Dataset(name=name, x_train=x_train, x_test=x_test,
                   bias_means=bias_means, binarization=binarization,
                   synthetic=synthetic, bias_source=bias_source)
