"""Solves replayed from CUDA graphs, one family of graphs per solver.

The port's solves that read nothing back to the host (PnP-RANSAC's,
``ops/pnp.py::_solve``; bundle adjustment's,
``models/bundle_adjust.py::ba_solve``; ORB's corner stage,
``ops/orb.py::_corner_stage``) run at fixed shapes, so each input
signature is captured once and replayed: the same kernels on the same
shapes, one launch where eager PyTorch makes one per ATen op.

One rule decides for every family (:meth:`GraphFamily.replays_on`): a call
on a CUDA device without a mesh replays; the CPU and a mesh (collectives
inside) run eagerly.  Each family keys its own graphs, counts its own
captures, replays and eager calls, and holds its own memory pool
(``torch.cuda.graph_pool_handle()``), so no family's replays depend on the
order of another's.  A new graphed solve is one more family here and one
call in its solver.
"""

from __future__ import annotations

import torch


class GraphedCall:
    """`fn` over static input buffers (clones of the first call's
    `tensors`; None stays None) captured as one CUDA graph.  A call copies
    its inputs in, replays, and returns clones of the outputs (a
    NamedTuple of tensors, or of tuples of tensors): a result outlives the
    next replay."""

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
        return type(self.out)(*(t.clone() if isinstance(t, torch.Tensor)
                                else tuple(x.clone() for x in t) for t in self.out))


def _is_input(v) -> bool:
    """A graph's input (copied in on every replay): a tensor, or None in a
    tensor's place.  Every other argument is baked into the graph."""
    return v is None or isinstance(v, torch.Tensor)


class GraphFamily:
    """One solver's graphs, one per signature, captured on its first call,
    with the family's pool and counters (``captures``, ``replays`` and
    ``eager`` calls of this process; ``lane_calls`` and ``lane_replays``,
    its calls on more than one lane and those of them replayed, where
    `lanes` gives a call's lanes from its arguments)."""

    def __init__(self, lanes=None):
        self.graphs: dict = {}  # signature -> GraphedCall
        self.pool = None  # the family's graphs replay one at a time on one stream
        self.captures = self.replays = self.eager = 0
        self.lanes = lanes
        self.lane_calls = self.lane_replays = 0

    def replays_on(self, device: torch.device, mesh) -> bool:
        """The rule: replay on a CUDA device without a mesh."""
        return device.type == "cuda" and mesh is None

    @staticmethod
    def key(args: dict) -> tuple:
        """What a graph bakes in: every input's shape and dtype (None kept as
        None), the device, and every other argument by value (the camera,
        the scalars)."""
        device = next(v.device for v in args.values() if isinstance(v, torch.Tensor))
        return device, tuple(
            (name, (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else v)
            for name, v in sorted(args.items()))

    def __call__(self, fn, mesh=None, **args):
        """``fn(**args)`` (and ``mesh=mesh`` where one is given): replayed
        from the graph of `args`' signature where :meth:`replays_on` allows
        it (captured first if it is new), else eager.  Tensors and Nones are
        the graph's inputs; every other argument is baked in and keys the
        graph."""
        key = self.key(args)
        stacked = self.lanes is not None and self.lanes(args) > 1
        self.lane_calls += stacked
        if not self.replays_on(key[0], mesh):
            self.eager += 1
            return fn(**args) if mesh is None else fn(mesh=mesh, **args)
        names = [n for n, v in args.items() if _is_input(v)]
        tensors = tuple(args[n] for n in names)
        graph = self.graphs.get(key)
        if graph is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            baked = {n: v for n, v in args.items() if not _is_input(v)}
            graph = GraphedCall(lambda *t: fn(**dict(zip(names, t)), **baked), tensors,
                                self.pool)
            self.graphs[key] = graph
            self.captures += 1
        self.replays += 1
        self.lane_replays += stacked
        return graph(tensors)


PNP = GraphFamily(lambda a: a["mask"].shape[0])  # ops/pnp.py::_solve, (B, N) masks
BA = GraphFamily()  # models/bundle_adjust.py::ba_solve
# ops/orb.py::_corner_stage, an (H, W) image or a (B, H, W) stack
ORB = GraphFamily(lambda a: a["img"].shape[0] if a["img"].dim() == 3 else 1)
FAMILIES = {"pnp": PNP, "ba": BA, "orb": ORB}
