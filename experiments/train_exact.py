"""Dense exact-GP trainer CLI (reference baseline: experiments/train_keops.py).

The reference uses KeOps CUDA kernels for the dense MVMs; here the dense
kernel matrix is plain XLA matmul territory, so this baseline is a Cholesky
exact GP.  O(n^2) memory: use --max-n on large datasets.
"""

import argparse
import pathlib
import sys

_ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
_HERE = str(pathlib.Path(__file__).resolve().parent)
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)

from common import add_common_args, init_kwargs, load_dataset, run_training  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern"])
    p.add_argument("--nu", type=float, default=1.5)
    args = p.parse_args()

    from simplex_gp_tpu import DenseGP

    ds = load_dataset(args)
    model = DenseGP(
        num_dims=ds.train_x.shape[-1],
        kernel=args.kernel,
        nu=args.nu,
        min_noise=args.min_noise,
    )
    run_training(model, model.init_params(**init_kwargs(args, ds)), ds, args, "exact")


if __name__ == "__main__":
    main()
