"""One function's calls replayed from a CUDA graph.

The port's solves that read nothing back to the host (PnP-RANSAC's,
``ops/pnp.py::_solve``; bundle adjustment's,
``models/bundle_adjust.py::ba_solve``) run at fixed shapes, so each input
signature is captured once and replayed: the same kernels on the same
shapes, one launch where eager PyTorch makes one per ATen op.  Each
caller keys its own graphs, counts its own captures and replays, and
holds its own memory pool (``torch.cuda.graph_pool_handle()``), so no
family's replays depend on the order of another's.
"""

from __future__ import annotations

import torch


class GraphedCall:
    """`fn` over static input buffers (clones of the first call's
    `tensors`; None stays None) captured as one CUDA graph.  A call copies
    its inputs in, replays, and returns clones of the outputs (a
    NamedTuple of tensors): a result outlives the next replay."""

    WARMUP = 3  # eager calls on the capture stream first: library handles, workspaces, constants

    def __init__(self, fn, tensors: tuple, pool):
        dev = next(t for t in tensors if t is not None).device
        self.inputs = tuple(None if t is None else t.clone() for t in tensors)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(self.WARMUP):
                fn(*self.inputs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.out = fn(*self.inputs)

    def __call__(self, tensors: tuple):
        for dst, src in zip(self.inputs, tensors, strict=True):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        return type(self.out)(*(t.clone() for t in self.out))
