"""Several engine threads on one card: the repairs that keep one-engine
code right when engines capture, replay and count at once, pinned on the
CPU (the card halves are ``tests/test_torch_cuda.py::
test_capture_on_one_thread_while_another_replays_and_syncs`` and
``::test_two_engines_on_two_streams_give_the_baseline_bits``).

- launches counted from several threads, one of them inside a capture,
  lose no count, and the capture's own launches go to its tally only;
- the capture guard admits one capture at a time across threads, holds
  the cyclic collector off for its length and restores it once;
- a capture runs in ``thread_local`` error mode on the capture stream;
- no device-wide sync is left on a serving path (a sync waits for the
  calling engine's stream only);
- the confidence kernel's arrival counters are allocated per launch, so
  launches on two streams never share them.
"""
import ast
import contextlib
import gc
import threading
import types
from pathlib import Path

import pytest
import torch

from repro_torch.core import graph_loop
from repro_torch.kernels import confidence, ops

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 60


def _run_threads(*targets):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive()


def test_launch_counts_survive_a_concurrent_capture():
    n = 20000
    before = dict(ops.LAUNCHES)
    tallies = []
    started = threading.Event()

    def counter():
        started.wait(JOIN_S)
        for _ in range(n):
            ops.count({"gemm": 1, "block_attention": 2})

    def capturer():
        with ops.capturing() as tally:
            started.set()
            for _ in range(n):
                ops.count({"gemm": 1})
            tallies.append(dict(tally))

    _run_threads(counter, counter, capturer)
    # the two counting threads' launches all landed, the capture's none
    assert ops.LAUNCHES["gemm"] - before["gemm"] == 2 * n
    assert ops.LAUNCHES["block_attention"] - before["block_attention"] \
        == 4 * n
    assert tallies == [{"block_attention": 0, "confidence_argmax": 0,
                        "gemm": n}]


def test_replay_counts_add_under_the_lock():
    """``BlockGraph.add_launches`` from two replaying threads: prologue +
    bodies x body + epilogue per replay, nothing lost."""
    parts = {"prologue": {"block_attention": 1, "confidence_argmax": 0,
                          "gemm": 3},
             "body": {"block_attention": 2, "confidence_argmax": 1,
                      "gemm": 5},
             "epilogue": {"block_attention": 0, "confidence_argmax": 1,
                          "gemm": 0}}
    graph = types.SimpleNamespace(launches=parts)
    before = dict(ops.LAUNCHES)
    n = 3000

    def replayer():
        for _ in range(n):
            graph_loop.BlockGraph.add_launches(graph, 4)

    _run_threads(replayer, replayer)
    got = {k: ops.LAUNCHES[k] - before[k] for k in before}
    assert got == {"block_attention": 2 * n * 9,
                   "confidence_argmax": 2 * n * 5, "gemm": 2 * n * 23}


class _FakeGC:
    """Tracks the collector's state and counts enables."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self.enables = 0

    def collect(self):
        return 0

    def isenabled(self):
        return self.enabled

    def disable(self):
        self.enabled = False

    def enable(self):
        self.enabled = True
        self.enables += 1


@pytest.mark.parametrize("initially", [True, False])
def test_capture_guard_is_process_wide_and_restores_gc_once(monkeypatch,
                                                            initially):
    fake = _FakeGC(initially)
    monkeypatch.setattr(graph_loop, "gc", fake)
    inside = threading.Event()
    release = threading.Event()
    order = []

    def first():
        with graph_loop.capture_guard():
            with graph_loop.capture_guard():      # re-entrant
                order.append("first in")
                inside.set()
                assert not fake.enabled
                release.wait(JOIN_S)
            assert not fake.enabled               # still held: outer open
            order.append("first out")

    def second():
        inside.wait(JOIN_S)
        t = threading.Timer(0.2, release.set)
        t.start()
        with graph_loop.capture_guard():          # waits for first
            order.append("second in")
            assert not fake.enabled
        t.join(JOIN_S)

    _run_threads(first, second)
    assert order == ["first in", "first out", "second in"]
    assert fake.enabled is initially
    assert fake.enables == (2 if initially else 0)   # once per outermost


def test_capture_is_thread_local_and_tallies_its_launches(monkeypatch):
    calls = []

    class FakeGraph:
        def __init__(self, keep_graph=False):
            assert keep_graph

        def capture_begin(self, pool=None, capture_error_mode="global"):
            calls.append(("begin", pool, capture_error_mode))

        def capture_end(self):
            calls.append(("end",))

    class FakeStream:
        def __init__(self, device=None):
            pass

        def synchronize(self):
            calls.append(("sync",))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graph_loop, "_capture_streams", {})
    before = dict(ops.LAUNCHES)
    with graph_loop.capture_guard():
        graph, counted = graph_loop._capture(
            lambda: ops.count({"gemm": 7}), "pool", torch.device("cpu"))
    assert isinstance(graph, FakeGraph)
    assert calls == [("sync",), ("begin", "pool", "thread_local"),
                     ("end",)]
    assert counted["gemm"] == 7 and ops.LAUNCHES == before
    assert gc.isenabled()


SERVING_SOURCES = ("core/decoder.py", "core/graph_loop.py",
                   "serving", "server", "cache", "obs")


def test_no_device_wide_sync_on_serving_paths():
    """``torch.cuda.synchronize`` waits for every stream of the card, so
    one engine's prefill would wait for another engine's whole block: the
    serving code syncs its current stream instead."""
    base = ROOT / "src" / "repro_torch"
    files = []
    for rel in SERVING_SOURCES:
        p = base / rel
        files += sorted(p.rglob("*.py")) if p.is_dir() else [p]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Attribute) \
                    and node.attr == "synchronize" \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr == "cuda":
                raise AssertionError(f"device-wide sync in {f}:"
                                     f"{node.lineno}")


def test_confidence_counters_are_per_launch():
    a = confidence._counters(torch.device("cpu"), 8)
    b = confidence._counters(torch.device("cpu"), 8)
    assert a.dtype == torch.int32 and a.shape == (8,)
    assert not a.any() and not b.any()
    assert a.data_ptr() != b.data_ptr()
