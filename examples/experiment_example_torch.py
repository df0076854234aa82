"""The reference's experiment script on the PyTorch port's facade.

The flow of ``examples/experiment_example.py`` (the reference's
experiment_example.py with its defects repaired), with the same constants,
on ``iwae_replication_project_tpu_torch.api.FlexibleModel``: build and
compile the model, then per Burda stage set the learning rate, fit, compute
the evaluation statistics, log them and save the weights.

Run it:

    python examples/experiment_example_torch.py                # 8 stages, the card
    python examples/experiment_example_torch.py --smoke        # 2 stages, tiny k
    python examples/experiment_example_torch.py --device cpu   # on the CPU
"""

import argparse
import datetime
import os
import pickle
import sys

# `python examples/experiment_example_torch.py` puts examples/ (not the
# repo root) on sys.path; make the script runnable without an install
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from iwae_replication_project_tpu_torch.api import FlexibleModel  # noqa: E402
from iwae_replication_project_tpu_torch.data import load_dataset  # noqa: E402
from iwae_replication_project_tpu_torch.training import (  # noqa: E402
    burda_stages,
)

parser = argparse.ArgumentParser()
parser.add_argument("--smoke", action="store_true",
                    help="2 stages, k=8, small eval (CI-sized)")
parser.add_argument("--dataset", default="binarized_mnist")
parser.add_argument("--data-dir", default="data")
parser.add_argument("--out-dir", default="runs/experiment_example_torch")
parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to run (default: the CUDA card)")
args = parser.parse_args()

# data load (reference :25-31; the synthetic fallback announces itself)
ds = load_dataset(args.dataset, data_dir=args.data_dir)
x_train, x_test = ds.x_train, ds.x_test

# training constants (reference :35-40; Adam eps=1e-4 matches Burda)
batch_size = 100

# architecture constants: the 2-layer flagship (reference :48-51)
n_hidden_encoder = [200, 100]
n_hidden_decoder = [100, 200]
n_latent_encoder = [100, 50]
n_latent_decoder = [100, 784]

# loss constants (reference :54-58)
loss_function = "IWAE"
k = 8 if args.smoke else 50
p = 1
alpha = 1
beta = 0.05

# model build + compile (reference :60-63, ctor order (..., loss_function,
# k, p, alpha, beta))
mdl = FlexibleModel(n_hidden_encoder, n_hidden_decoder,
                    n_latent_encoder, n_latent_decoder,
                    dataset_bias=None, pixel_means=ds.bias_means,
                    loss_function=loss_function, k=k, p=p, alpha=alpha,
                    beta=beta, device=args.device)
mdl.compile()

# TensorBoard setup (reference :67-70)
log_dir = os.path.join(
    args.out_dir, datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))

# the 8-stage Burda schedule (PDF §3.4: lr = 1e-4 * round(10^(1-(i-1)/7),
# 1), 3^(i-1) passes per stage)
n_stages = 2 if args.smoke else 8
results_history = []
eval_k = k
nll_k = 64 if args.smoke else 5000
nll_chunk = 32 if args.smoke else 250
x_eval = x_test[:100] if args.smoke else x_test

for i, lr, passes in burda_stages(n_stages):
    mdl.set_learning_rate(lr)
    # train + eval + persist (reference :82-97)
    mdl.fit(x_train, epochs=passes, batch_size=batch_size,
            binarization=ds.binarization)
    res, res2 = mdl.get_training_statistics(
        x_eval, eval_k, nll_k=nll_k, nll_chunk=nll_chunk,
        activity_samples=100 if args.smoke else 1000)
    print(f"stage {i}: " + ", ".join(f"{name}={v:.4f}"
                                     for name, v in res.items()))
    mdl.tensorboard_log(res, epoch_n=i, logdir=log_dir)
    results_history.append((res, res2["number_of_active_units"]))
    mdl.save_weights(os.path.join(
        log_dir, f"{loss_function}-{len(n_hidden_encoder)}L-k_{k}-epoch_{i}"))
    with open(os.path.join(log_dir, "results.pkl"), "wb") as f:
        pickle.dump(results_history, f)

print(f"done: {n_stages} stages, artifacts under {log_dir}")
