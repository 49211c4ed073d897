"""Captured programs: the port's counterpart of ``jax.jit`` for the
serving steps.

A program is a zero-argument body that reads only its static input tensors
and writes only its static output tensors; the caller copies each
dispatch's values into the inputs before ``run()`` and reads the outputs
after it. That is the contract of a jitted step whose parameters are
arguments, with the arguments moved into buffers that stay put.

* **On CUDA** the body is captured once, when the program is built: first
  ``WARMUP`` eager passes on the pool's side stream, under
  ``torch.cuda.set_sync_debug_mode("error")`` so that any op that waits on
  the card raises, then one capture with ``torch.cuda.graph`` into the
  memory pool that every program of a :class:`ProgramPool` shares.
  ``run()`` replays the graph on the current stream. The warm-up also
  does each kernel's first-use work before the capture (the ``nvcc`` build
  and ``ctypes`` load of `repro_torch.kernels.build`, the dynamic shared
  memory attribute the flash and SSD launchers set once). Sharing one pool
  is safe because replays are serial on one stream and a program's outputs
  are static tensors allocated outside the pool; what the body allocates
  (the kernels' outputs and scratch) is graph memory that no host
  reference holds across replays.
* **On the CPU** (what the tests run) ``run()`` calls the body, so a CPU
  run exercises exactly the data flow of a replay.
* **Eager pools** (``ProgramPool(device, eager=True)``): a body that holds
  a collective of a gloo group (serving over a model group,
  `repro_torch.launch.serve` with a mesh) cannot be captured, since gloo
  stages its tensors through host memory. The group's backend asks for
  this mode explicitly; every ``run()`` then calls the body, on the card
  too, and counts in ``eager_calls``.

There is no fallback: a capture that fails raises, and no program of a
pool that did not ask for the eager mode runs uncaptured on CUDA. On CUDA
a captured body runs eagerly only in its warm-up; ``Program.eager_calls``
counts its eager passes (warm-up passes on CUDA, every run on the CPU or
in an eager pool) so a test can pin that. Kernel launches are counted as `repro_torch.kernels` says: the
capture's ``LAUNCHES`` delta is taken out again and added back per replay.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import LAUNCHES

WARMUP = 1   # eager passes before a capture


class ProgramPool:
    """The graph memory pool and the side stream that a group of programs
    (one engine's, one set of step buffers') share; nothing on the CPU or
    with ``eager`` (bodies that cannot be captured: every run calls the
    body)."""

    def __init__(self, device, eager: bool = False):
        self.device = torch.device(device)
        self.eager = eager
        self.cuda = self.device.type == "cuda" and not eager
        self.handle = torch.cuda.graph_pool_handle() if self.cuda else None
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def capture(self, body: Callable[[], None]) -> "Program":
        return Program(body, self)


class Program:
    """``body`` built once into a program on ``pool``'s device: captured
    into a CUDA graph there, called as it is on the CPU or in an eager
    pool."""

    def __init__(self, body: Callable[[], None], pool: ProgramPool):
        self.body = body
        self.eager_calls = 0     # passes of the body that ran its ops
        self.replays = 0
        self.capture_s = 0.0     # warm-up and capture, synchronized
        #: kernel launches of one replay (the capture's LAUNCHES delta)
        self.launches: Dict[str, int] = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        if pool.cuda:
            self._capture(pool)

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def _eager(self) -> None:
        self.eager_calls += 1
        self.body()

    def _capture(self, pool: ProgramPool) -> None:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(pool.device)
        pool.stream.wait_stream(current)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(pool.stream):
                for _ in range(WARMUP):
                    self._eager()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(pool.stream)
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool.handle,
                                  stream=pool.stream):
                self.body()
        finally:
            # the capture recorded these launches and ran none of them
            self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                             if LAUNCHES[k] != before[k]}
            for k, d in self.launches.items():
                LAUNCHES[k] -= d
        torch.cuda.synchronize(pool.device)
        self._graph = graph
        self.capture_s = time.perf_counter() - t0

    def run(self) -> None:
        """One dispatch: a replay on CUDA, the body on the CPU."""
        if self._graph is None:
            self._eager()
            return
        self._graph.replay()
        self.replays += 1
        for k, d in self.launches.items():
            LAUNCHES[k] += d
