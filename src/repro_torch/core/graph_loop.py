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

Several engine threads share the card. ``capture_guard`` is the one
process-wide capture lock: it admits one capture at a time and, for its
length, holds the cyclic collector off (a graph freed mid-capture
invalidates it), restoring the collector's state once, when the
outermost guard exits. Each part is captured in ``thread_local`` error
mode, so an allocation or a sync of its own stream that another engine's
thread makes meanwhile does not invalidate it (a device-wide sync would,
in any mode: the serving paths sync their own stream only).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import threading

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


_CAPTURE_LOCK = threading.RLock()
_hold = {"depth": 0, "collecting": False}
_capture_streams = {}


@contextlib.contextmanager
def capture_guard():
    """One capture at a time across the process (re-entrant on its own
    thread), with the cyclic collector held off from the outermost entry
    to the outermost exit and then put back as it was."""
    with _CAPTURE_LOCK:
        if _hold["depth"] == 0:
            gc.collect()
            _hold["collecting"] = gc.isenabled()
            gc.disable()
        _hold["depth"] += 1
        try:
            yield
        finally:
            _hold["depth"] -= 1
            if _hold["depth"] == 0 and _hold["collecting"]:
                gc.enable()


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream captures of ``device`` run on (one per device: the
    guard lets one capture run at a time)."""
    if device.index not in _capture_streams:
        _capture_streams[device.index] = torch.cuda.Stream(device)
    return _capture_streams[device.index]


def _capture(fn, pool, device):
    """``fn()`` captured into a kept (not instantiated) CUDA graph, with
    the launches it counted (capture launches nothing, so they go to this
    thread's tally, not ``kops.LAUNCHES``). Call inside
    ``capture_guard``. ``thread_local`` mode: only this thread's unsafe
    CUDA calls can invalidate the capture."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream = _capture_stream(device)
    stream.synchronize()
    with torch.cuda.stream(stream), kops.capturing() as counted:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
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
        with capture_guard():
            for name, fn in (("prologue", prologue), ("body", body),
                             ("epilogue", epilogue)):
                graph, counted = _capture(fn, pool, pred.device)
                self._parts.append(graph)      # keeps the pool's memory
                self.launches[name] = counted
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
        kops.count({k: self.launches["prologue"][k]
                    + bodies_run * self.launches["body"][k]
                    + self.launches["epilogue"][k]
                    for k in self.launches["body"]})

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.graph_loop_destroy(self._graph, self._exec)
