"""A window of closed-loop steps as one device program: the port's counterpart
of bench.py's fused window (`BENCH_FUSED=1`, bench.py:257-285: one `lax.scan`
of closed-loop steps with no host involvement) and of the scan behind the
reference's `parallel/batch.py:179 batched_episode`.

The reference compiles the window into one XLA program; the port captures it
in a CUDA graph. `FusedWindow` keeps the loop's carry in static device
buffers, captures `steps_per_graph` steps into one `torch.cuda.CUDAGraph` and
replays it: a window of n steps is n // k replays of that graph and, when
n % k is not 0, one replay of a second graph of n % k steps. Each step writes
u[0, 0] into the window's trace at a step counter kept on the device, so the
window reads nothing back to the host. The step must be capturable: between
its inputs and its outputs no host read and no copy from pageable host
memory. The lanes SQP loop's early exit is such a read, so a step to capture
runs it with `SqpConfig(early_exit=False)`, which gives the same solution
(converged scenarios are frozen either way). A capture that fails raises;
nothing falls back to the eager loop. On the CPU the same window body runs
eagerly, step by step.

A graph grows with its steps: the `xla` step is some 10^5 nodes, so a
window of 60 such steps in one graph is millions. Before a graph of more
than one step is captured, the window captures the one-step graph (which it
keeps), reads its node count and the card memory it took, and projects the
larger graph from them (`project`); a projection past a `FREE_SHARE` of
the card's free memory raises ValueError naming the projected nodes and
bytes, before that capture starts.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, NamedTuple

import torch

from gpmpc_tpu_torch.control.gpmpc import cached_forms
from gpmpc_tpu_torch.device import cached_constants
from gpmpc_tpu_torch.parallel.mesh import tree_leaves, tree_map

MAX_STEPS = 4096  # the trace's length: the most steps one `run` takes
FREE_SHARE = 0.9  # the share of the card's free memory a projected graph may take


class GraphStats(NamedTuple):
    """One captured graph: its steps, the host's seconds to record them
    (`capture_s`) and to instantiate the graph (`instantiate_s`), its nodes
    (counted for the one-step graph, else None), the growth of the caching
    allocator's reserved memory over the capture (`pool_bytes`: the graph's
    private pool) and the rest of the card memory it took (`graph_bytes`:
    what the CUDA runtime took for the instantiated graph)."""

    steps: int
    capture_s: float
    instantiate_s: float
    nodes: int | None
    pool_bytes: int
    graph_bytes: int


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with `keep_graph=True`
    (`cuGraphGetNodes` from libcuda)."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return count.value


class FusedWindow:
    """`step_fn(*carry) -> (*new_carry, u)`, with u (B, nu), run as a window
    from the static carry `self.carry` (a copy of `carry`, a tuple of
    tensor trees: for bench.py's loop the plant states, the controller
    states and the observations). After `run(n)`, `self.carry` holds the
    carry after the n steps, `self.last` the carry before the last of them
    and `self.u` that step's actions. On a CUDA device the constructor runs
    one step on a side stream (its results are dropped: it fills the step's
    caches, as PyTorch's graph recipe warms a capture), and `run` captures
    each graph it needs on first use (`capture`); a step that reads the
    host or copies from pageable memory makes the capture raise (it runs
    under `torch.cuda.set_sync_debug_mode("error")`). `max_steps` bounds
    the steps of one `run`. `stats` holds each captured graph's
    `GraphStats` by its steps."""

    def __init__(self, step_fn: Callable, carry: tuple, steps_per_graph: int = 1,
                 max_steps: int = MAX_STEPS):
        if steps_per_graph < 1:
            raise ValueError(f"steps_per_graph must be positive, got {steps_per_graph}")
        leaves = tree_leaves(carry)
        self.device = leaves[0].device
        if any(t.device != self.device for t in leaves):
            raise ValueError(f"the carry spans devices {sorted({str(t.device) for t in leaves})}")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no fused window on {self.device}")
        self.step_fn, self.k, self.max_steps = step_fn, steps_per_graph, max_steps
        self.carry = tree_map(torch.clone, tuple(carry))
        self.last = tree_map(torch.empty_like, self.carry)
        self.u = None  # the last step's actions, allocated at the first step
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.stats: dict[int, GraphStats] = {}
        self._counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._trace = None
        if self.device.type == "cuda":
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                *_, u = step_fn(*self.carry)
                self._allocate(u)
            torch.cuda.current_stream(self.device).wait_stream(side)
            # the constants the step read from the module caches stay alive with the graphs
            self._held = (cached_forms(), cached_constants())

    def _allocate(self, u: torch.Tensor) -> None:
        self.u = torch.empty_like(u)
        self._trace = torch.zeros(self.max_steps, dtype=u.dtype, device=self.device)

    def _body(self, n: int) -> None:
        """n steps from the static carry and back into it: what one graph
        holds, and what the CPU runs eagerly."""
        carry = self.carry
        for i in range(n):
            if i == n - 1:
                tree_map(lambda dst, src: dst.copy_(src), self.last, carry)
            *new, u = self.step_fn(*carry)
            carry = tuple(new)
            if self.u is None:
                self._allocate(u)
            self._trace.index_copy_(0, self._counter, u[0, :1].to(self._trace.dtype))
            self._counter += 1
        self.u.copy_(u)
        # an output that shares memory with another static buffer is copied first, so that
        # no copy below reads a buffer an earlier one has written
        statics = {t.untyped_storage().data_ptr() for t in tree_leaves(self.carry)}
        carry = tree_map(lambda dst, src: src if src is dst or src.untyped_storage().data_ptr()
                         not in statics else src.clone(), self.carry, carry)
        tree_map(lambda dst, src: dst.copy_(src), self.carry, carry)

    def capture(self, n: int) -> torch.cuda.CUDAGraph:
        """The graph of n steps, captured on first use; past one step only
        once `project` allows it."""
        if n not in self.graphs:
            if n > 1:
                self.project(n)
            self._capture(n)
        return self.graphs[n]

    def project(self, n: int) -> tuple[int, int]:
        """(nodes, bytes) projected for a graph of n steps from the one-step
        graph (captured here if it is not yet): n times its nodes, its pool
        once (a capture reuses the blocks its steps free) and n times the
        rest of the memory it took. Raises ValueError if the bytes exceed a
        `FREE_SHARE` of the card's free memory."""
        one = self.stats.get(1) or self._capture(1)
        nodes, need = n * one.nodes, one.pool_bytes + n * one.graph_bytes
        limit = int(FREE_SHARE * torch.cuda.mem_get_info(self.device)[0])
        if need > limit:
            raise ValueError(
                f"a graph of {n} steps is projected at {nodes} nodes and {need} bytes of card "
                f"memory (one step: {one.nodes} nodes, a pool of {one.pool_bytes} bytes and "
                f"{one.graph_bytes} bytes of graph), over the {limit} bytes it may take; capture "
                "fewer steps a graph")
        return nodes, need

    def _capture(self, n: int) -> GraphStats:
        """Captures and instantiates the graph of n steps under sync-debug
        "error", recording its `GraphStats`; the one-step graph keeps its
        CUDA graph for `graph_nodes`."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        free, reserved = torch.cuda.mem_get_info(self.device)[0], torch.cuda.memory_reserved(
            self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=n == 1)
        with torch.cuda.graph(graph):
            t0 = time.perf_counter()
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._body(n)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            t1 = time.perf_counter()
        nodes = None
        if n == 1:
            nodes = graph_nodes(graph)
            graph.instantiate()
        torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        pool = torch.cuda.memory_reserved(self.device) - reserved
        taken = free - torch.cuda.mem_get_info(self.device)[0]
        self.graphs[n] = graph
        self.stats[n] = GraphStats(n, t1 - t0, t2 - t1, nodes, pool, max(taken - pool, 0))
        return self.stats[n]

    def run(self, n: int) -> torch.Tensor:
        """n closed-loop steps from the static carry: the (n,) trace of
        u[0, 0], on the carry's device (reading it is the caller's barrier).
        On a CUDA device: n // k replays of the k-step graph, then one of
        the (n % k)-step graph."""
        if not 0 < n <= self.max_steps:
            raise ValueError(f"a window of 1 to {self.max_steps} steps, got {n}")
        full, rest = divmod(n, self.k)
        self._counter.zero_()
        if self.device.type == "cpu":
            for _ in range(full):
                self._body(self.k)
            if rest:
                self._body(rest)
        else:
            graph = self.capture(self.k) if full else None
            tail = self.capture(rest) if rest else None
            for _ in range(full):
                graph.replay()
            if rest:
                tail.replay()
        return self._trace[:n].clone()
