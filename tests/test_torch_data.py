"""The port's dataset loaders (``data/loaders.py``) against the JAX
package's on the reference's on-disk formats, written here at small sizes:
the ``.amat`` pair with and without the raw idx pair (root and ``mnist/``),
the mnist idx pair at the root and under ``mnist/``, the fashion pair under
``fashion_mnist/`` (and never the root's), ``chardata.mat`` and the
``.npz`` forms. Arrays, bias means and source, binarization and the
missing-file errors are equal. The synthetic blobs the production
rehearsal writes (``scripts/torch_dress_rehearsal.py``) equal JAX's bit for
bit at the real sizes. ``utils/checkpoint.latest_step`` passes over a
truncated newest step."""

import hashlib
import os

import numpy as np
import pytest

from fixture_io import write_idx_gz
from iwae_replication_project_tpu.data import loaders as jax_loaders
from iwae_replication_project_tpu_torch.data import loaders
from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils import checkpoint as ck

#: the real (train, test) sizes of the production rehearsal (the JAX
#: script's SIZES)
REAL_SIZES = {"binarized_mnist": (50_000, 10_000),
              "omniglot": (24_345, 8_070),
              "fashion_mnist": (60_000, 10_000)}


def _binary(rs, n):
    return (rs.rand(n, 784) > 0.5).astype(np.float32)


def _gray_u8(rs, n):
    return rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)


def _amat(d, rs):
    np.savetxt(os.path.join(d, "binarized_mnist_train.amat"), _binary(rs, 6),
               fmt="%d")
    np.savetxt(os.path.join(d, "binarized_mnist_test.amat"), _binary(rs, 4),
               fmt="%d")


def _idx_pair(d, rs):
    os.makedirs(d, exist_ok=True)
    write_idx_gz(os.path.join(d, "train-images-idx3-ubyte.gz"),
                 _gray_u8(rs, 5))
    write_idx_gz(os.path.join(d, "t10k-images-idx3-ubyte.gz"),
                 _gray_u8(rs, 3))


def _write_amat_raw_root(d, rs):
    _amat(d, rs)
    _idx_pair(d, rs)


def _write_amat_raw_sub(d, rs):
    _amat(d, rs)
    _idx_pair(os.path.join(d, "mnist"), rs)


def _write_amat_raw_npz(d, rs):
    _amat(d, rs)
    np.savez(os.path.join(d, "mnist.npz"), x_train=_gray_u8(rs, 5),
             x_test=_gray_u8(rs, 2))


def _write_mnist_root(d, rs):
    _idx_pair(d, rs)


def _write_mnist_sub(d, rs):
    _idx_pair(os.path.join(d, "mnist"), rs)
    _idx_pair(d, rs)  # the subdirectory wins over the root


def _write_fashion_sub(d, rs):
    _idx_pair(os.path.join(d, "fashion_mnist"), rs)


def _write_fashion_root_only(d, rs):
    _idx_pair(d, rs)  # plain mnist's names: fashion must not take them


def _write_chardata(d, rs):
    import scipy.io as sio
    sio.savemat(os.path.join(d, "chardata.mat"),
                {"data": rs.rand(784, 7).astype(np.float32),
                 "testdata": rs.rand(784, 3).astype(np.float32)})


def _npz(name, scale):
    def write(d, rs):
        x = _gray_u8(rs, 6) if scale else \
            _binary(rs, 6).reshape(-1, 28, 28)
        y = _gray_u8(rs, 2) if scale else \
            _binary(rs, 2).reshape(-1, 28, 28)
        np.savez(os.path.join(d, f"{name}.npz"), x_train=x, x_test=y)
    return write


#: case -> (dataset, writer)
CASES = {
    "amat-alone": ("binarized_mnist", _amat),
    "amat-raw-idx-root": ("binarized_mnist", _write_amat_raw_root),
    "amat-raw-idx-mnist-dir": ("binarized_mnist", _write_amat_raw_sub),
    "amat-raw-npz": ("binarized_mnist", _write_amat_raw_npz),
    "binarized-npz": ("binarized_mnist", _npz("binarized_mnist", False)),
    "mnist-idx-root": ("mnist", _write_mnist_root),
    "mnist-idx-mnist-dir": ("mnist", _write_mnist_sub),
    "mnist-npz": ("mnist", _npz("mnist", True)),
    "fashion-idx-dir": ("fashion_mnist", _write_fashion_sub),
    "fashion-npz": ("fashion_mnist", _npz("fashion_mnist", True)),
    "omniglot-chardata": ("omniglot", _write_chardata),
    "omniglot-npz": ("omniglot", _npz("omniglot", True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loaders_match_jax(case, tmp_path):
    name, write = CASES[case]
    write(str(tmp_path), np.random.RandomState(sorted(CASES).index(case)))
    got = loaders.load_dataset(name, data_dir=str(tmp_path),
                               allow_synthetic=False)
    want = jax_loaders.load_dataset(name, data_dir=str(tmp_path),
                                    allow_synthetic=False)
    assert not got.synthetic and not want.synthetic
    for field in ("x_train", "x_test", "bias_means"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(got.output_bias, want.output_bias)
    assert (got.binarization, got.bias_source) == \
        (want.binarization, want.bias_source)
    raw = case.startswith("amat-raw")
    assert got.bias_source == ("raw" if raw else "train")


@pytest.mark.parametrize("name,write", [
    ("binarized_mnist", None), ("mnist", None), ("fashion_mnist", None),
    ("omniglot", None), ("fashion_mnist", _write_fashion_root_only),
    ("binarized_mnist", _write_mnist_root)],
    ids=["binarized-empty", "mnist-empty", "fashion-empty", "omniglot-empty",
         "fashion-root-idx-only", "binarized-raw-only"])
def test_missing_files_raise_alike(name, write, tmp_path):
    if write is not None:
        write(str(tmp_path), np.random.RandomState(0))
    errors = []
    for load in (loaders.load_dataset, jax_loaders.load_dataset):
        with pytest.raises(FileNotFoundError) as e:
            load(name, data_dir=str(tmp_path), allow_synthetic=False)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "gray"])
@pytest.mark.parametrize("name", sorted(REAL_SIZES))
def test_synthetic_blobs_equal_jax_at_real_sizes(name, binary):
    """The rehearsal's data: the same code and seed on both sides, so the
    same bytes (and the port's NLL is comparable to JAX's committed one)."""
    got = loaders._synthetic(name, *REAL_SIZES[name], seed=0, binary=binary)
    want = jax_loaders._synthetic(name, *REAL_SIZES[name], seed=0,
                                  binary=binary)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        assert _digest(a) == _digest(b)


def test_latest_step_passes_over_a_truncated_newest_step(tmp_path, capsys):
    cfg = ModelConfig(n_hidden_enc=(8,), n_latent_enc=(2,),
                      n_hidden_dec=(8,), n_latent_dec=(784,),
                      likelihood="logits")
    d = str(tmp_path)
    assert ck.latest_step(d) is None
    assert ck.latest_step(str(tmp_path / "absent")) is None
    state = ts.create_train_state(0, cfg, device="cpu")
    for step in (1, 2, 3):
        ck.save_checkpoint(d, step, state, stage=step)
    assert ck.checkpoint_steps(d) == [3, 2, 1]
    assert ck.latest_step(d) == ck.checkpoint_steps(d)[0] == 3
    ck.truncate_newest_checkpoint(d)
    assert ck.checkpoint_steps(d) == [3, 2, 1]  # still on disk
    assert ck.latest_step(d) == ck.checkpoint_steps(d)[1] == 2
    assert "failed integrity verification" in capsys.readouterr().out
    restored = ck.restore_latest(d, ts.create_train_state(1, cfg,
                                                          device="cpu"))
    assert restored[0] == ck.latest_step(d) == 2
