"""Online GP learning: collect transitions, refit, swap the model. Port of
`gpmpc_tpu/runtime/online.py`'s `OnlineLearner`.

The GP is an argument of every step (padded buffers), so a refit yields a
new `GpModel` of the same shapes that the caller swaps in between steps.
`capacity` must equal the serving model's padded dataset capacity
(`max_gp_points`) and `max_inducing` its inducing count (`max_gp_samples`).
"""

from __future__ import annotations

import numpy as np
import torch

from gpmpc_tpu_torch.control.gpmpc import (
    GpModel,
    model_spec,
    pack_training_buffers,
    preprocess_data_jnp,
    train_gp_models,
)
from gpmpc_tpu_torch.device import resolve

_INGEST_CHUNK = 256  # the reference's ring writes go in chunks of this many rows


class OnlineLearner:
    """Accumulate transitions into a ring buffer (host numpy) and refit the
    GP ensemble on everything buffered, on `device` (None: the card). Call
    `ingest` and `refit` from one thread. The inducing draws come from a
    generator seeded with `seed`."""

    def __init__(
        self,
        model,
        prior_params: dict | None = None,
        capacity: int = 4096,
        max_inducing: int = 40,
        sparse: bool = True,
        n_train: int = 100,
        lr: float = 0.05,
        seed: int = 0,
        device=None,
    ):
        self.spec = spec = model_spec(model)
        self.device = resolve(device)
        self._model = model
        self._x = np.zeros((capacity, spec.z_dim), np.float32)
        self._y = np.zeros((capacity, spec.num_gps), np.float32)
        self._capacity = capacity
        self._write = 0  # ring head
        self._count = 0  # rows filled (saturates at capacity)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # the quadrotor's thrust map comes from the caller's prior fit when given
        self._thrust_map = (
            (float(prior_params["a"]), float(prior_params["b"]))
            if spec.name == "quadrotor" and prior_params is not None else None
        )
        self._sparse, self._n_train, self._lr = sparse, n_train, lr
        self._max_inducing = min(max_inducing, capacity)

    @property
    def n_points(self) -> int:
        return self._count

    def _preprocess(self, x, u, x_next):
        t = lambda a: torch.as_tensor(np.array(a, np.float32), device=self.device)  # noqa: E731
        x, u, x_next = t(x), t(u), t(x_next)
        if self._thrust_map is not None:
            xi, ti = preprocess_data_jnp(self._model, *self._thrust_map, x, u, x_next)
        else:
            xi, ti = self.spec.make_targets(self._model, x, u, x_next)
        return xi.cpu().numpy(), ti.cpu().numpy()

    def ingest(self, x: np.ndarray, u: np.ndarray, x_next: np.ndarray) -> int:
        """Preprocess raw transitions into GP inputs and residual targets and
        write them into the ring (the oldest rows go first once it is full),
        in chunks of 256 rows as the reference does. Returns the number of
        rows ingested."""
        n = x.shape[0]
        if n == 0:
            return 0
        xi, ti = self._preprocess(x, u, x_next)
        # the reference's ring writes, chunk by chunk (the same rows land in
        # the same slots)
        for lo in range(0, n, _INGEST_CHUNK):
            xc, tc = xi[lo:lo + _INGEST_CHUNK], ti[lo:lo + _INGEST_CHUNK]
            m = xc.shape[0]
            w, cap = self._write, self._capacity
            if m >= cap:  # the chunk alone overwrites the whole ring
                self._x[:], self._y[:] = xc[m - cap:], tc[m - cap:]
                self._write, self._count = 0, cap
                continue
            head = min(m, cap - w)
            self._x[w:w + head], self._y[w:w + head] = xc[:head], tc[:head]
            if m > head:
                self._x[:m - head], self._y[:m - head] = xc[head:], tc[head:]
            self._write = (w + m) % cap
            self._count = min(self._count + m, cap)
        return n

    def refit(self) -> GpModel:
        """Refit the ensemble on everything buffered: a new GpModel. Raises
        if nothing was ingested."""
        if self._count == 0:
            raise RuntimeError("no transitions ingested yet")
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        data = pack_training_buffers(t(self._x), t(self._y), self._count, self.spec)
        return train_gp_models(
            data, self._generator, sparse=self._sparse, max_inducing=self._max_inducing,
            n_train=self._n_train, lr=self._lr,
        )
