"""Export the benchmark's synthetic GP ensemble as a numpy fixture for the
PyTorch port.

`bench.py` trains its GP with `utils/benchkit.py::synthetic_gp_model` at
`max_points=128, max_inducing=40, n_data=128, n_train=50, seed=0`. The port
(`gpmpc_tpu_torch`) never imports JAX, so it reads that model from
`gpmpc_tpu_torch/data/bench_gp.npz`, which this script writes: every
`GpModel` leaf, the raw hyperparameters included, as float32 (and `trained`
as a bool).

    python scripts/export_torch_gp_fixture.py [--out PATH]

Runs the JAX package on the CPU. `tests/test_torch_setup.py` regenerates the
model in memory and checks it against the committed file.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DEFAULT_OUT = REPO / "gpmpc_tpu_torch" / "data" / "bench_gp.npz"

# bench.py:148-151 at its defaults (gp_points=128, gp_inducing=40, gp_data=128)
BENCH_GP_KW = dict(max_points=128, max_inducing=40, n_data=128, n_train=50, seed=0)


def bench_gp_arrays() -> dict:
    """The bench GP's leaves as a flat dict of numpy arrays (the fixture's keys)."""
    import jax
    import numpy as np

    from gpmpc_tpu.utils.benchkit import synthetic_gp_model

    # bench.py runs with 64-bit mode off; with it on, the inducing-point draw
    # (jax.random) picks other points.
    with jax.enable_x64(False), jax.default_device(jax.devices("cpu")[0]):
        gp = synthetic_gp_model(**BENCH_GP_KW)
    out = {}
    for name, leaf in gp._asdict().items():
        if name == "hypers":
            for h_name, h_leaf in leaf._asdict().items():
                out[h_name] = np.asarray(h_leaf, np.float32)
        elif name == "trained":
            out[name] = np.asarray(leaf, bool)
        else:
            out[name] = np.asarray(leaf, np.float32)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    arrays = bench_gp_arrays()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes): "
          + ", ".join(f"{k}{tuple(v.shape)}" for k, v in arrays.items()))


if __name__ == "__main__":
    main()
