"""Roofline probe of the PyTorch/CUDA port: which mapping of the batched
12 x 12 products wins on the card (`gpmpc_tpu_torch/roofline.py`).

    python3 scripts/bench_roofline_torch.py
    BENCH_ROOFLINE_ONLY=cuda_lanes,cuda_lanes_bf16_pair python3 scripts/bench_roofline_torch.py

Needs one CUDA card and `nvcc` (the kernels build on first launch). Prints one
JSON line per row.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpmpc_tpu_torch.roofline import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
