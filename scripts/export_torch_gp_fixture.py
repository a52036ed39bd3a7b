"""Export the benchmark's synthetic GP ensembles as numpy fixtures for the
PyTorch port.

`bench.py` trains its GP per model family (`BENCH_MODEL`) with
`utils/benchkit.py::synthetic_gp_model`, `synthetic_cartpole_gp_model` or
`synthetic_twolink_gp_model`, each at `max_points=128, max_inducing=40,
n_data=128, n_train=50, seed=0`. The port (`gpmpc_tpu_torch`) never imports
JAX, so it reads those models from `gpmpc_tpu_torch/data/bench_gp.npz`
(quadrotor), `bench_gp_cartpole.npz` and `bench_gp_twolink.npz`, which this
script writes: every `GpModel` leaf, the raw hyperparameters included, as
float32 (and `trained` as a bool).

    python scripts/export_torch_gp_fixture.py [--family NAME] [--out PATH]

Without `--family` it writes all three to their default paths. Runs the JAX
package on the CPU. `tests/test_torch_setup.py` regenerates the models in
memory and checks them against the committed files.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("quadrotor", "cartpole", "twolink")

# bench.py:109-111, :130-132 and :148-151 at its defaults (gp_points=128,
# gp_inducing=40, gp_data=128)
BENCH_GP_KW = dict(max_points=128, max_inducing=40, n_data=128, n_train=50, seed=0)


def bench_gp_arrays(family: str = "quadrotor") -> dict:
    """The family's bench GP leaves as a flat dict of numpy arrays (the
    fixture's keys)."""
    import jax
    import numpy as np

    from gpmpc_tpu.utils import benchkit

    make = {
        "quadrotor": benchkit.synthetic_gp_model,
        "cartpole": benchkit.synthetic_cartpole_gp_model,
        "twolink": benchkit.synthetic_twolink_gp_model,
    }[family]
    # bench.py runs with 64-bit mode off; with it on, the inducing-point draw
    # (jax.random) picks other points.
    with jax.enable_x64(False), jax.default_device(jax.devices("cpu")[0]):
        gp = make(**BENCH_GP_KW)
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
    ap.add_argument("--family", choices=FAMILIES, help="one family (default: all three)")
    ap.add_argument("--out", type=Path, help="output path (with --family only)")
    args = ap.parse_args(argv)
    if args.out is not None and args.family is None:
        ap.error("--out needs --family")

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from gpmpc_tpu_torch.convert import bench_gp_path

    for family in (args.family,) if args.family else FAMILIES:
        out = args.out or bench_gp_path(family)
        arrays = bench_gp_arrays(family)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out, **arrays)
        print(f"wrote {out} ({out.stat().st_size} bytes): "
              + ", ".join(f"{k}{tuple(v.shape)}" for k, v in arrays.items()))


if __name__ == "__main__":
    main()
