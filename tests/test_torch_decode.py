"""The port's decoder and batch engine against the JAX package's
``DiffusionDecoder`` on ``tiny`` (JAX ``PRNGKey(3)`` weights carried
across by ``repro_torch.bridge``): identical tokens and identical
NFE / steps-per-block / query-token / kv-token / early-exit counters for
the five methods and ``frozen_suffix``, on the device loop and the host
loop, with attention and confidence on the plain path and on the kernel
route (the kernels' plain versions on the CPU); the dKV step's
``self_kv_mix`` against the JAX model. Plus the port's isolation from
JAX and its refusal to fall back to the CPU."""
import ast
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.decoder import DecodeConfig as JDecodeConfig
from repro.core.decoder import DiffusionDecoder as JDiffusionDecoder
from repro.models import get_config as jget_config
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models.model import apply_model as japply_model
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.core.decoder import (METHODS, DecodeConfig,
                                      DiffusionDecoder)
from repro_torch.models.model import apply_model
from repro_torch.core.engine import ServingEngine
from repro_torch.kernels import ops
from repro_torch.models.config import get_config

# tiny shapes: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG_J = jget_config("tiny")
CFG = get_config("tiny")
JPARAMS = jax.jit(jinit_params, static_argnums=0)(CFG_J, jax.random.PRNGKey(3))
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")
PROMPT = np.random.default_rng(0).integers(0, 200, (2, 10)).astype(np.int32)
BASE = dict(gen_len=16, block_size=8, window=4, tau0=0.5)
COUNTERS = ("nfe", "steps_per_block", "query_tokens_processed",
            "kv_tokens_attended", "early_exits")


@functools.lru_cache(maxsize=None)
def _jax_result(method, eos=None, **kw):
    cfg = CFG_J if eos is None else dataclasses.replace(CFG_J,
                                                        eos_token_id=eos)
    d = JDecodeConfig(method=method, **{**BASE, **kw})
    return JDiffusionDecoder(cfg, JPARAMS, d).generate(PROMPT.copy())


def _port_result(method, use_kernels, eos=None, **kw):
    """The port's result; ``kw`` may name ``fused=False`` (the host
    loop)."""
    cfg = CFG if eos is None else dataclasses.replace(CFG, eos_token_id=eos)
    d = DecodeConfig(method=method, use_kernels=use_kernels,
                     **{**BASE, **kw})
    return DiffusionDecoder(cfg, PARAMS, d, device="cpu").generate(
        PROMPT.copy())


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.tokens, ref.tokens)
    for name in COUNTERS:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
@pytest.mark.parametrize("method", METHODS)
def test_decode_matches_jax(method, use_kernels):
    port = _port_result(method, use_kernels)
    _assert_same(port, _jax_result(method))
    assert (port.tokens != CFG.mask_token_id).all()
    n_blocks = len(port.steps_per_block)
    assert port.host_syncs == n_blocks + (method == "dkv")
    for s in port.block_stats:
        assert s.tokens_committed == s.live_rows * BASE["block_size"]
        assert np.isfinite(s.commit_conf).all()


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
@pytest.mark.parametrize("method", METHODS)
def test_host_loop_matches_jax(method, use_kernels):
    """The port's host loop (the oracle) against the JAX decoder, with
    the JAX host loop's sync counts: one per step, and a (B, K, V)
    logit copy per step for the fixed-schedule methods."""
    port = _port_result(method, use_kernels, fused=False)
    ref = _jax_result(method, fused=False)
    _assert_same(port, ref)
    assert port.host_syncs == ref.host_syncs == port.nfe
    assert port.logit_syncs == ref.logit_syncs


@pytest.mark.parametrize("fused", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_frozen_suffix_matches_jax(use_kernels, fused):
    kw = dict(gen_len=32, window=8, frozen_suffix=True)
    port = _port_result("streaming", use_kernels, fused=fused, **kw)
    _assert_same(port, _jax_result("streaming", **kw))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_decode_early_exit_matches_jax(use_kernels):
    """With a fake EOS the model actually emits (its most frequent
    token), both decoders agree on which rows exit, when, and on the
    truncated outputs."""
    kw = dict(gen_len=32, window=8)
    r0 = _jax_result("streaming", early_exit=False, **kw)
    vals, counts = np.unique(r0.tokens, return_counts=True)
    eos = int(vals[counts.argmax()])
    ref = _jax_result("streaming", eos=eos, **kw)
    port = _port_result("streaming", use_kernels, eos=eos, **kw)
    _assert_same(port, ref)
    assert port.early_exits > 0


@pytest.mark.parametrize("method", ["dkv", "streaming"])
def test_host_loop_early_exit_matches_jax(method):
    kw = dict(gen_len=32, window=8)
    r0 = _jax_result(method, early_exit=False, **kw)
    vals, counts = np.unique(r0.tokens, return_counts=True)
    eos = int(vals[counts.argmax()])
    port = _port_result(method, True, eos=eos, fused=False, **kw)
    _assert_same(port, _jax_result(method, eos=eos, fused=False, **kw))
    assert port.early_exits > 0


def test_self_kv_mix_step_matches_jax():
    """One dKV step at the model level: the query region attends a
    position-indexed cache under a (B, T) validity mask, its frozen
    tokens take their K/V from the cache (``self_kv_mix``), and every
    query token's K/V is written at its position. Logits (f32) and the
    written cache against the JAX model at 2e-5."""
    B, T, P = 2, 26, 10
    rng = np.random.default_rng(4)
    x = rng.integers(0, 300, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    cache_j = japply_model(CFG_J, JPARAMS, tokens=jax.numpy.asarray(x),
                           positions=jax.numpy.asarray(pos),
                           cache=jinit_cache(CFG_J, B, T)).cache
    qpos = np.tile(np.arange(P, T, dtype=np.int32), (B, 1))
    valid = np.zeros((B, T), bool)
    valid[:, :P] = True
    valid[0, 12] = valid[1, 15] = valid[1, 16] = True
    mix = valid[np.arange(B)[:, None], qpos]
    q_toks = x[np.arange(B)[:, None], qpos]
    want = japply_model(CFG_J, JPARAMS, tokens=jax.numpy.asarray(q_toks),
                        positions=jax.numpy.asarray(qpos), mode="append",
                        cache=cache_j, kv_valid=jax.numpy.asarray(valid),
                        append_at=jax.numpy.asarray(qpos),
                        self_kv_mix=jax.numpy.asarray(mix))
    cache_t = cache_from_jax(jax.tree.map(np.asarray, cache_j), "cpu")
    got = apply_model(CFG, PARAMS, tokens=torch.tensor(q_toks),
                      positions=torch.tensor(qpos), mode="append",
                      cache=cache_t, kv_valid=torch.tensor(valid),
                      append_at=torch.tensor(qpos),
                      self_kv_mix=torch.tensor(mix))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=2e-5, rtol=2e-5)
    for (k, v), (wk, wv) in zip(got.cache, cache_from_jax(
            jax.tree.map(np.asarray, want.cache), "cpu")):
        np.testing.assert_allclose(k.numpy(), wk.numpy(), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(v.numpy(), wv.numpy(), atol=2e-5,
                                   rtol=2e-5)
    # the mix changes the step: without it the frozen tokens' K/V are
    # recomputed from their tokens and the logits move
    plain = apply_model(CFG, PARAMS, tokens=torch.tensor(q_toks),
                        positions=torch.tensor(qpos), mode="step",
                        cache=cache_from_jax(jax.tree.map(np.asarray,
                                                          cache_j), "cpu"),
                        kv_valid=torch.tensor(valid))
    assert not torch.allclose(plain.logits, got.logits, atol=1e-3)


def test_batch_engine_serves_a_queue():
    d = DecodeConfig(method="streaming", **BASE)
    eng = ServingEngine(CFG, PARAMS, d, mode="batch", device="cpu")
    uids = [eng.submit(p, max_tokens=12) for p in
            ("Q:11+22=? A:", "Q:33-04=? A:", "Q:7+1=? A:")]
    done = eng.run_to_completion()
    assert sorted(c.uid for c in done) == uids
    assert eng.stats["batches"] == 2          # two prompt-length buckets
    first = [c for c in done if c.uid in uids[:2]]
    prompts = np.stack([eng.tok.encode(p) for p in
                        ("Q:11+22=? A:", "Q:33-04=? A:")])
    ref = DiffusionDecoder(CFG, PARAMS, dataclasses.replace(d, gen_len=16),
                           device="cpu").generate(prompts)
    for i, c in enumerate(sorted(first, key=lambda c: c.uid)):
        np.testing.assert_array_equal(c.tokens, ref.tokens[i])
        assert c.text == eng.tok.decode(ref.tokens[i])
    assert eng.throughput > 0


def test_serve_cli_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "tiny", "--device", "cpu", "--dtype",
                      "float32", "--train-steps", "0", "--n", "3",
                      "--gen-len", "16", "--mode", "batch"])
    assert out["served"] == 3 and out["nfe"] > 0
    assert out["launches"] == {"block_attention": 0, "confidence_argmax": 0,
                               "gemm": 0}
    assert out["host_syncs"] == 2             # one batch of two blocks


def test_serve_cli_dkv_host_loop_on_cpu():
    """``--method dkv --host-loop`` serves through the host loop: one
    sync per pass (the prefill pass included), as many as the NFE."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", "tiny", "--device", "cpu", "--dtype",
                      "float32", "--train-steps", "0", "--n", "3",
                      "--gen-len", "16", "--method", "dkv", "--host-loop"])
    assert out["served"] == 3 and out["method"] == "dkv"
    assert out["host_syncs"] == out["nfe"] > 0


# ------------------------------------------------------------ boundaries

@pytest.mark.parametrize("kw,item", [(dict(executor=object()), "A11")])
def test_unported_paths_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        DiffusionDecoder(CFG, PARAMS, DecodeConfig(**BASE), device="cpu",
                         **kw)


def test_unported_engine_paths_raise():
    """Continuous serving, the prefix cache, the HTTP front end, the
    auditor and the fleet are ported (ROADMAP A6-A10): stealing, handoff,
    prefill-only engines, host budgets and a stealing router build and
    run without raising. What is not ported raises naming its item:
    executor and mesh placement (A11)."""
    from repro_torch.launch import host
    from repro_torch.server import EngineLoop, EngineRouter
    from repro_torch.serving import BlockScheduler, ContinuousEngine
    d = DecodeConfig(**BASE)
    eng = ContinuousEngine(CFG, PARAMS, d, device="cpu",
                           host_budget=host.compute_host_budget(2, cores=4))
    assert eng.metrics.host_threads == 2
    loops = [EngineLoop(eng), EngineLoop(ContinuousEngine(
        CFG, PARAMS, d, device="cpu", prefill_only=True), role="prefill")]
    assert eng.scheduler.steal_waiting() is None
    assert eng.scheduler.steal_paused() is None
    assert eng.scheduler.take_handoffs() == []
    router = EngineRouter(loops)
    assert router.disaggregated and not loops[1].steal
    auditor = object()
    eng.attach_auditor(auditor)
    assert eng.auditor is auditor
    for kw in (dict(executor=object()), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="A11"):
            BlockScheduler(CFG, PARAMS, d, device="cpu", **kw)
    sched = BlockScheduler(CFG, PARAMS, d, device="cpu", prefill_only=True)
    assert sched.debug_state()["prefill_only"] is True


def test_cuda_decoder_requires_kernels():
    """The plain versions never serve on the card."""
    with pytest.raises(ValueError, match="use_kernels"):
        DiffusionDecoder(CFG, PARAMS, DecodeConfig(use_kernels=False, **BASE),
                         device="cuda")


def test_defaulted_device_raises_without_cuda(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = DecodeConfig(**BASE)
    for call in (lambda: resolve_device(),
                 lambda: DiffusionDecoder(CFG, PARAMS, d),
                 lambda: ServingEngine(CFG, PARAMS, d, mode="batch"),
                 lambda: init_params(CFG, torch.Generator()),
                 lambda: serve.main(["--arch", "tiny"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# modules the import checks must reach by name: the prefix cache copies
# JAX-free modules of the JAX package (radix, store), which the port must
# not import from there; so does the training slice (data.synthetic)
NAMED_MODULES = ("repro_torch.cache", "repro_torch.cache.radix",
                 "repro_torch.cache.store", "repro_torch.cache.slicing",
                 "repro_torch.kernels.gemm", "repro_torch.server",
                 "repro_torch.server.types", "repro_torch.server.wire",
                 "repro_torch.server.loop", "repro_torch.server.router",
                 "repro_torch.server.http", "repro_torch.server.client",
                 "repro_torch.server.console", "repro_torch.obs.series",
                 "repro_torch.obs.audit", "repro_torch.obs.profiler",
                 "repro_torch.launch.host", "repro_torch.launch.train",
                 "repro_torch.data.synthetic", "repro_torch.training",
                 "repro_torch.training.tree",
                 "repro_torch.training.checkpoint",
                 "repro_torch.training.optimizer",
                 "repro_torch.training.loss", "repro_torch.training.train")


def test_import_leaves_jax_out():
    """Importing the port and every submodule (the prefix cache, the
    GEMM binding, the HTTP front end and the auditor among them) loads
    no jax and nothing of the JAX package
    (the test process itself has jax, so this runs in a fresh
    interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"missing = [m for m in {NAMED_MODULES!r} if m not in sys.modules]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))), bad,\n"
        "      missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_imports_in_port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    named = {".".join(f.relative_to(ROOT / "src").with_suffix("").parts)
             .replace(".__init__", "") for f in files}
    assert set(NAMED_MODULES) <= named
    for f in files + [ROOT / "chip_smoke.py", ROOT / "chip_ab_counters.py"]:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_launch_counters_reset():
    ops.LAUNCHES["block_attention"] = 5
    ops.reset_launches()
    assert set(ops.LAUNCHES.values()) == {0}
