#!/usr/bin/env python3
"""Dataset report of the port (``scripts/prepare_data.py``'s counterpart):
which datasets the port's loaders find under ``--data-dir``, and what the
driver would train on.

    python3 scripts/torch_prepare_data.py [--data-dir data] [--device cpu]
        [--export-digits PATH]

Prints one line per dataset of ``data.DATASETS``: ``REAL`` with the train
and test shapes, the binarization and the bytes of both splits once placed
on ``--device`` as the driver places them (default: the card),
``MISSING`` (the driver would fall back to synthetic blobs unless
``allow_synthetic`` is off) or ``UNAVAILABLE`` (a reader's import failed).

Expected files under --data-dir (any one layout per dataset suffices):

  binarized_mnist   binarized_mnist_train.amat + binarized_mnist_test.amat
                    (Larochelle's fixed binarization), or binarized_mnist.npz
                    with x_train/x_test keys. Optionally mnist idx/npz
                    alongside: the output-bias init then uses the raw mnist
                    means, the reference's policy.
  mnist             mnist/train-images-idx3-ubyte(.gz) + t10k-... (LeCun
                    idx), the same names at the root, or mnist.npz.
  fashion_mnist     fashion_mnist/train-images-idx3-ubyte(.gz) + t10k-...
                    (Zalando), or fashion_mnist.npz; never the root's idx.
  omniglot          chardata.mat (the Burda split; read with scipy), or
                    omniglot.npz.
  digits,           nothing: the package carries the UCI optdigits table
  digits_gray       (data/digits.csv.gz), real handwritten digits.

``--export-digits PATH`` writes the prepared digits set (``x_train``,
``x_test``, ``bias_means``) to PATH as .npz. ``--device cpu`` reports
without a card.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from iwae_replication_project_tpu_torch.data import (  # noqa: E402
    DATASETS,
    load_dataset,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--export-digits", metavar="PATH", default=None,
                    help="write the prepared digits dataset to PATH (.npz)")
    ap.add_argument("--device", default=None,
                    help="where the splits are placed (default: the card)")
    ns = ap.parse_args(argv)
    import torch

    from iwae_replication_project_tpu_torch.utils.device import (
        resolve_device)

    dev = resolve_device(ns.device)

    print(f"checking datasets under {ns.data_dir!r}:")
    for name in DATASETS:
        try:
            ds = load_dataset(name, data_dir=ns.data_dir,
                              allow_synthetic=False)
            placed = [torch.as_tensor(x.reshape(len(x), -1),
                                      dtype=torch.float32).to(dev)
                      for x in (ds.x_train, ds.x_test)]
            nbytes = sum(t.numel() * t.element_size() for t in placed)
            print(f"  {name:16s} REAL   train={ds.x_train.shape} "
                  f"test={ds.x_test.shape} binarization={ds.binarization} "
                  f"on {dev.type}: {nbytes} bytes")
            del placed
        except FileNotFoundError:
            print(f"  {name:16s} MISSING (loaders would fall back to "
                  f"synthetic blobs; see this script's docstring for the "
                  f"expected files)")
        except ImportError as e:
            # omniglot imports scipy at load time: a missing dependency
            # marks one dataset unavailable, it does not end the report
            print(f"  {name:16s} UNAVAILABLE (import failed: {e})")

    if ns.export_digits:
        import numpy as np
        ds = load_dataset("digits", allow_synthetic=False)
        np.savez(ns.export_digits, x_train=ds.x_train, x_test=ds.x_test,
                 bias_means=ds.bias_means)
        print(f"wrote {ns.export_digits}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
