"""One CUDA graph per decode block: the counterpart of the JAX package's
``lax.while_loop`` over denoise steps.

A block's device program has three parts, each a function over static
device buffers: the prologue (reset the block's counters, the refresh
pass where the method has one, the loop condition), the body (one
denoise step, then the loop condition again) and the epilogue (straggler
finalize, early exit). ``BlockGraph`` captures each part with
``torch.cuda.CUDAGraph(keep_graph=True)`` into one memory pool, and
``csrc/graph_loop.cu`` assembles them as

    prologue -> n x IF(pred) { body } -> epilogue

where ``pred`` is a 0-dim CUDA bool that the prologue and every body
rewrite. A replay runs the whole block with no host read: iterations
after the loop closes skip their body. The graphs need CUDA 12.4 or
later (conditional nodes) and a PyTorch whose ``CUDAGraph`` takes
``keep_graph``; without either, ``require_support`` raises and says
which.
"""
from __future__ import annotations

import ctypes
import functools
import gc

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ops as kops


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("graph_loop")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
            ("graph_loop_create", [p]),
            ("graph_loop_add_child", [p, p, p, p]),
            ("graph_loop_add_if", [p, p, p, p, p]),
            ("graph_loop_instantiate", [p, p]),
            ("graph_loop_upload", [p, p]),
            ("graph_loop_launch", [p, p]),
            ("graph_loop_node_count", [p, p]),
            ("graph_loop_destroy", [p, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i
    lib.graph_loop_error_string.argtypes = [i]
    lib.graph_loop_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().graph_loop_error_string(err).decode()
        raise RuntimeError(f"CUDA graph block loop: {what} failed: {msg} "
                           f"(cudaError {err})")


def require_support() -> None:
    """Raise unless this PyTorch and CUDA can build the block graph."""
    major, minor = (int(v) for v in (torch.version.cuda or "0.0")
                    .split(".")[:2])
    if (major, minor) < (12, 4):
        raise RuntimeError(
            f"the CUDA graph block loop needs CUDA >= 12.4 for conditional "
            f"graph nodes; this PyTorch is built for CUDA {torch.version.cuda}")
    try:
        torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as err:
        raise RuntimeError(
            "the CUDA graph block loop needs torch.cuda.CUDAGraph("
            f"keep_graph=True) and raw_cuda_graph() (torch "
            f"{torch.__version__}): {err}") from err


def _capture(fn, pool):
    """``fn()`` captured into a kept (not instantiated) CUDA graph, with
    the launches it counted: capture launches nothing, so the counts are
    put back and returned."""
    before = dict(kops.LAUNCHES)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, pool=pool):
        fn()
    counted = {k: kops.LAUNCHES[k] - before[k] for k in before}
    kops.LAUNCHES.update(before)
    return graph, counted


class BlockGraph:
    """``prologue``, then ``n_iter`` IF nodes on ``pred`` around ``body``,
    then ``epilogue``, as one instantiated CUDA graph. ``launches`` holds
    each part's kernel launches per run, for ``kops.LAUNCHES``."""

    def __init__(self, prologue, body, epilogue, pred: torch.Tensor,
                 n_iter: int, pool):
        if pred.dtype != torch.bool or pred.dim() != 0 or not pred.is_cuda:
            raise ValueError("pred must be a 0-dim CUDA bool tensor")
        lib = _lib()
        self._parts = []
        self.launches = {}
        # A graph freed during a capture (a dead decoder's, by the cycle
        # collector) would invalidate it: collect first, then hold the
        # collector off until the captures end.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for name, fn in (("prologue", prologue), ("body", body),
                             ("epilogue", epilogue)):
                graph, counted = _capture(fn, pool)
                self._parts.append(graph)      # keeps the pool's memory
                self.launches[name] = counted
        finally:
            if collecting:
                gc.enable()
        pro, bod, epi = (ctypes.c_void_p(g.raw_cuda_graph())
                         for g in self._parts)
        self._graph = ctypes.c_void_p()
        self._exec = ctypes.c_void_p()
        _check(lib.graph_loop_create(ctypes.byref(self._graph)), "create")
        node = ctypes.c_void_p()
        _check(lib.graph_loop_add_child(self._graph, None, pro,
                                        ctypes.byref(node)), "prologue")
        pred_ptr = ctypes.c_void_p(pred.data_ptr())
        for i in range(n_iter):
            nxt = ctypes.c_void_p()
            _check(lib.graph_loop_add_if(self._graph, node, pred_ptr, bod,
                                         ctypes.byref(nxt)),
                   f"IF node {i} (conditional graph nodes)")
            node = nxt
        _check(lib.graph_loop_add_child(self._graph, node, epi,
                                        ctypes.byref(node)), "epilogue")
        _check(lib.graph_loop_instantiate(self._graph,
                                          ctypes.byref(self._exec)),
               "instantiate")
        self.n_iter = n_iter
        self.device = pred.device
        self._lib = lib
        _check(lib.graph_loop_upload(
            self._exec, torch.cuda.current_stream(self.device).cuda_stream),
            "upload")

    def nodes(self) -> int:
        """Top-level nodes of the block graph: the prologue, a
        predicate-setting kernel and an IF node per iteration, the
        epilogue."""
        n = ctypes.c_ulonglong()
        _check(_lib().graph_loop_node_count(self._graph, ctypes.byref(n)),
               "node count")
        return n.value

    def replay(self) -> None:
        """Launch the block on the current stream (no sync)."""
        _check(self._lib.graph_loop_launch(
            self._exec, torch.cuda.current_stream(self.device).cuda_stream),
            "launch")

    def add_launches(self, bodies_run: int) -> None:
        """Count one replay's kernel launches in ``kops.LAUNCHES``: the
        prologue's and epilogue's, and the body's times the bodies that
        ran (the device's step counter says how many)."""
        for k in kops.LAUNCHES:
            kops.LAUNCHES[k] += (self.launches["prologue"][k]
                                 + bodies_run * self.launches["body"][k]
                                 + self.launches["epilogue"][k])

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.graph_loop_destroy(self._graph, self._exec)
