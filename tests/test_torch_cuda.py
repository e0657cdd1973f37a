"""The port on the card: what the kernel wrappers refuse to launch, the
confidence kernel on strided rows, the GEMM against its plain version
and bit for bit across batch sizes and row positions, and the CUDA-graph
block loop on
``tiny`` (against the host loop for every method, two states
interleaved, no new capture at known shapes, launch counts under
replay), and continuous serving's use of it (compacted and merged states
on graphs of a new batch, a dkv row parked and resumed, no capture after
``ContinuousEngine.prewarm``, gangs of several sizes that compact and
merge with every request equal to its B = 1 decode). Each kernel against its plain version
at the main path's shapes, and llada-8b through the graphs, are checked
by ``chip_smoke.py``. Needs a CUDA card; skips without one. Imports no JAX,
so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _attn(B, Sq, Skv, H, Hkv, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g).to(dtype)
    k = torch.randn((B, Skv, Hkv, D), generator=g).to(dtype)
    v = torch.randn((B, Skv, Hkv, D), generator=g).to(dtype)
    qp = torch.arange(50, 50 + Sq, dtype=torch.int32)[None].repeat(B, 1)
    kp = torch.arange(Skv, dtype=torch.int32)[None].repeat(B, 1)
    km = torch.rand((B, Skv), generator=g) < 0.7
    km[:, 0] = True
    return [t.cuda() for t in (q, k, v, qp, kp, km)]


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    before = dict(ops.LAUNCHES)
    q, k, v, qp, kp, km = _attn(1, 8, 16, 2, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.block_attention(q, k, v, qp, kp, km)
    q, k, v, qp, kp, km = _attn(1, 8, 16, 2, 1, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.block_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v, qp, kp, km)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.block_attention(q.half(), k.half(), v.half(), qp, kp, km)
    with pytest.raises(ValueError, match="int32"):
        ops.block_attention(q, k, v, qp.long(), kp, km)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        ops.block_attention(shifted, k, v, qp, kp, km)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.confidence_argmax(torch.zeros(2, 64, dtype=torch.float16,
                                          device=cuda))
    assert ops.LAUNCHES == before             # a refused call counts nothing


def test_attention_wrapper_refuses_pairs_no_kernel_takes(cuda):
    """bf16 goes to the tensor-core kernel (D 64/128), float32 to the
    simple kernel (D 32/64/128); any other (dtype, D) raises, and so does
    an output dtype other than float32 or bfloat16."""
    before = dict(ops.LAUNCHES)
    for D, dtype in ((32, torch.bfloat16), (16, torch.bfloat16),
                     (256, torch.float32)):
        args = _attn(1, 8, 16, 2, 1, D, dtype)
        with pytest.raises(ValueError, match="head dim"):
            ops.block_attention(*args)
    args = _attn(1, 8, 16, 2, 1, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="out_dtype"):
        ops.block_attention(*args, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.block_attention(args[0], *[a.float() if a.is_floating_point()
                                       else a for a in args[1:]])
    assert ops.LAUNCHES == before


def test_confidence_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """float16, a ban outside the row, a row that is not contiguous: each
    raises before a launch, and a refused call counts none."""
    before = dict(ops.LAUNCHES)
    x = torch.randn((4, 1000), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.confidence_argmax(x.half(), mask_id=3)
    with pytest.raises(ValueError, match="mask_id"):
        ops.confidence_argmax(x, mask_id=1000)
    with pytest.raises(ValueError, match="contiguous"):
        ops.confidence_argmax(x[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        ops.confidence_argmax(x.to(torch.bfloat16).t().contiguous().t())
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_confidence_kernel_matches_plain_on_strided_rows(cuda, dtype):
    """Rows of a wider buffer (stride 1003, so no row but the first starts
    on a 16-byte boundary) with a ban: the kernel against the plain
    version, idx exact and conf within 1e-5; one launch counted."""
    g = torch.Generator(device=cuda).manual_seed(0)
    buf = (torch.randn((40, 1003), generator=g, device=cuda) * 4).to(dtype)
    x = buf[:, :997]
    x[5, 400] = 50.0                  # the banned column holds the max
    before = ops.LAUNCHES["confidence_argmax"]
    conf, idx = ops.confidence_argmax(x, mask_id=400)
    c_ref, i_ref = ops.ref.confidence_argmax_ref(x, mask_id=400)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["confidence_argmax"] == before + 1
    assert torch.equal(idx, i_ref) and idx[5] != 400
    assert (conf - c_ref).abs().max().item() <= 1e-5


# ------------------------------------------------ the CUDA-graph block loop

_BASE = dict(gen_len=16, block_size=8, window=4, tau0=0.5)


@pytest.fixture
def tiny_cuda(cuda):
    """``tiny`` (float32) with seeded random weights on the card, and
    prompts."""
    import numpy as np

    from repro_torch.models import get_config, init_params
    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(3),
                         cuda)
    prompt = np.random.default_rng(0).integers(0, 200, (2, 10)).astype(
        np.int32)
    return cfg, params, prompt


def _decoder(tiny, **kw):
    from repro_torch.core.decoder import DecodeConfig, DiffusionDecoder
    cfg, params, _ = tiny
    return DiffusionDecoder(cfg, params, DecodeConfig(**{**_BASE, **kw}),
                            device="cuda")


COUNTERS = ("nfe", "steps_per_block", "query_tokens_processed",
            "kv_tokens_attended", "early_exits")


@pytest.mark.parametrize("method,kw", [
    ("vanilla", {}), ("dkv", {}), ("prefix", {}), ("fast", {}),
    ("streaming", {}),
    ("streaming", dict(frozen_suffix=True, gen_len=32, window=8))],
    ids=["vanilla", "dkv", "prefix", "fast", "streaming", "frozen_suffix"])
def test_graph_loop_matches_host_loop(tiny_cuda, method, kw):
    """Each block one graph replay: tokens and counters equal the
    per-step host loop's, with one host sync per block (plus dkv's
    prefill pass)."""
    prompt = tiny_cuda[2]
    graph = _decoder(tiny_cuda, method=method, **kw)
    res = graph.generate(prompt.copy())
    host = _decoder(tiny_cuda, method=method, fused=False,
                    **kw).generate(prompt.copy())
    assert (res.tokens == host.tokens).all()
    for name in COUNTERS:
        assert getattr(res, name) == getattr(host, name), name
    n_blocks = len(res.steps_per_block)
    assert res.host_syncs == n_blocks + (method == "dkv")
    assert res.logit_syncs == 0
    assert graph.graph_cache_size() == n_blocks


@pytest.mark.parametrize("method", ["streaming", "dkv"])
def test_interleaved_states_keep_their_caches(tiny_cuda, method):
    """Two states with distinct prompts, decoded block by block in turns
    on one decoder (one set of graphs), give the tokens each gives
    alone: the binding rule keeps each state's cache its own."""
    import numpy as np
    prompt = tiny_cuda[2]
    other = np.random.default_rng(7).integers(0, 200, prompt.shape).astype(
        np.int32)
    alone = [_decoder(tiny_cuda, method=method).generate(p.copy())
             for p in (prompt, other)]
    dec = _decoder(tiny_cuda, method=method)
    states = [dec.prefill(p.copy()) for p in (prompt, other)]
    if method == "dkv":
        assert states[0].cache is not states[1].cache
    while not all(s.finished for s in states):
        for s in states:
            dec.decode_block(s)
    for s, ref in zip(states, alone):
        out = dec.finalize(s)
        assert (out.tokens == ref.tokens).all()
        assert out.nfe == ref.nfe


def test_second_generate_captures_no_graph(tiny_cuda):
    import numpy as np
    dec = _decoder(tiny_cuda, method="streaming")
    dec.generate(tiny_cuda[2].copy())
    size = dec.graph_cache_size()
    assert size == _BASE["gen_len"] // _BASE["block_size"]
    other = np.random.default_rng(9).integers(0, 200, (2, 10)).astype(
        np.int32)
    dec.generate(other)
    assert dec.graph_cache_size() == size


def test_replayed_block_counts_the_launches_of_an_eager_block(tiny_cuda):
    """``ops.LAUNCHES`` after a replayed block equals the host loop's on
    the same block: replays add the captured parts' launches times the
    bodies the device ran."""
    import copy
    prompt = tiny_cuda[2]
    graph = _decoder(tiny_cuda, method="streaming")
    host = _decoder(tiny_cuda, method="streaming", fused=False)
    warm = graph.prefill(prompt.copy())
    graph.decode_block(warm)                # captures block 0's graph
    st_g, st_h = graph.prefill(prompt.copy()), host.prefill(prompt.copy())
    counts = []
    for dec, st in ((graph, st_g), (host, st_h)):
        ops.reset_launches()
        dec.decode_block(st)
        torch.cuda.synchronize()
        counts.append(dict(ops.LAUNCHES))
    assert counts[0] == counts[1]
    assert counts[0]["block_attention"] > 0
    assert counts[0]["confidence_argmax"] == st_g.steps_per_block[0]
    assert (st_g.x == st_h.x).all()
    twin = copy.deepcopy(st_g)              # another buffer: adopts the bound
    graph.decode_block(twin)
    graph.decode_block(st_g)
    assert (twin.x == st_g.x).all()


def test_graph_loop_with_embed_scale(tiny_cuda):
    """``embed_scale`` multiplies by a 0-dim CPU tensor inside the
    captured passes; the graph loop still equals the host loop."""
    import dataclasses

    from repro_torch.core.decoder import DecodeConfig, DiffusionDecoder
    cfg, params, prompt = tiny_cuda
    cfg = dataclasses.replace(cfg, embed_scale=True)
    res = [DiffusionDecoder(cfg, params, DecodeConfig(fused=fused, **_BASE),
                            device="cuda").generate(prompt.copy())
           for fused in (True, False)]
    assert (res[0].tokens == res[1].tokens).all()
    assert res[0].nfe == res[1].nfe
    assert res[0].host_syncs == len(res[0].steps_per_block)


@pytest.mark.parametrize("method", ["vanilla", "dkv", "prefix", "fast",
                                    "streaming"])
def test_graph_if_nodes_skip_after_the_loop_closes(tiny_cuda, method):
    """Five of the first block's eight tokens already committed and a
    threshold no confidence reaches: one commit per step, so the loop
    closes after 3 steps and the graph's remaining IF nodes skip their
    bodies. Tokens, steps and launch counts equal the host loop's."""
    prompt = tiny_cuda[2]
    out = []
    for fused in (True, False):
        dec = _decoder(tiny_cuda, method=method, tau0=1.01, alpha=0.0,
                       fused=fused)
        dec.decode_block(dec.prefill(prompt.copy()))   # captures block 0
        st = dec.prefill(prompt.copy())
        st.committed[:, st.prompt_len:st.prompt_len + 5] = True
        ops.reset_launches()
        dec.decode_block(st)
        torch.cuda.synchronize()
        out.append((st, dict(ops.LAUNCHES)))
    (graph, g_launch), (host, h_launch) = out
    assert graph.steps_per_block == host.steps_per_block == [3]
    assert (graph.x == host.x).all()
    assert g_launch == h_launch


def _host_twin(tiny, state, **kw):
    """(host-loop decoder, a deep copy of ``state``) for running the
    same state through the per-step host loop."""
    import copy
    return _decoder(tiny, fused=False, **kw), copy.deepcopy(state)


def _finish(dec, state):
    while not state.finished:
        dec.decode_block(state)
    return dec.finalize(state)


@pytest.mark.parametrize("method", ["prefix", "streaming"])
def test_take_and_merge_rows_replay_graphs_of_a_new_batch(tiny_cuda,
                                                          method):
    """A compacted (B 2 -> 1) and a merged (1 + 2 -> 3) state capture and
    replay the graphs of their new batch on its bound buffer, and give
    the host loop's tokens and counters for the same state."""
    import numpy as np
    kw = dict(method=method, gen_len=32)
    prompt = tiny_cuda[2]
    dec = _decoder(tiny_cuda, **kw)
    st = dec.prefill(prompt.copy())
    dec.decode_block(st)
    sub = dec.take_rows(st, [1])
    assert sub.cache is dec._block_buffers(1, st.total_len).cache
    other = dec.prefill(np.random.default_rng(5).integers(
        0, 200, (2, 10)).astype(np.int32))
    dec.decode_block(other)
    merged = dec.merge_rows([(st, [0]), (other, [0, 1])])
    for state in (sub, merged):
        hdec, twin = _host_twin(tiny_cuda, state, **kw)
        before = dec.graph_cache_size()
        got, want = _finish(dec, state), _finish(hdec, twin)
        assert dec.graph_cache_size() > before     # graphs of the new B
        assert (got.tokens == want.tokens).all()
        for name in COUNTERS:
            assert getattr(got, name) == getattr(want, name), name
        # one sync per block decoded since the state was made (it keeps
        # its sources' step counts for the block before)
        assert state.host_syncs == len(state.steps_per_block) - 1


def test_dkv_row_preempted_and_resumed_through_the_graph_loop(tiny_cuda):
    """dkv's one ``take_rows`` path: a row parked off-slot carries its
    gathered KV and masks, stays bit-stable while its old gang decodes
    on, and resumes through the graph loop with the host loop's tokens
    and counters for the same state."""
    kw = dict(method="dkv", gen_len=32)
    dec = _decoder(tiny_cuda, **kw)
    st = dec.prefill(tiny_cuda[2].copy())
    dec.decode_block(st)
    sub = dec.take_rows(st, [1], alloc_cache=False)
    assert sub.cache is not None and sub.cache is not st.cache
    snap = [t.clone() for kv in sub.cache for t in kv]
    _finish(dec, st)                       # the old gang decodes on
    assert all(torch.equal(a, b) for a, b in
               zip(snap, [t for kv in sub.cache for t in kv]))
    hdec, twin = _host_twin(tiny_cuda, sub, **kw)
    got, want = _finish(dec, sub), _finish(hdec, twin)
    assert (got.tokens == want.tokens).all()
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name


def test_prewarm_leaves_no_capture_after_it(tiny_cuda):
    """``ContinuousEngine.prewarm`` captures every (bucket, gang size,
    block) graph; serving a script with a preempt, a cancel and two
    buckets afterwards captures none, one sync per block."""
    from repro_torch.core.decoder import DecodeConfig
    from repro_torch.serving import ContinuousEngine
    cfg, params, prompt = tiny_cuda
    eng = ContinuousEngine(cfg, params, DecodeConfig(**{
        **_BASE, "gen_len": 24, "early_exit": False}), max_slots=2,
        device="cuda")
    rep = eng.prewarm([(10, 24), (10, 8)])
    # gangs of 1 and 2 rows, each a set of graphs of its own
    assert rep["graphs"] == 2 * (3 + 1) and rep["batch_sizes"] == [1, 2]
    uids = [eng.submit(prompt[i % 2], max_tokens=24 if i < 3 else 8)
            for i in range(5)]
    eng.step()
    eng.preempt(uids[0])
    eng.step()
    eng.cancel(uids[1])
    done = eng.run_to_completion()
    snap = eng.metrics.snapshot()
    assert snap["post_warm_compiles"] == 0 and snap["prewarmed"] == 1
    assert snap["requests"] == 5 and snap["cancelled"] == 1
    assert snap["host_syncs_per_block"] == 1.0
    assert all((c.tokens != cfg.mask_token_id).all() for c in done)


def test_card_compacts_and_merges_gangs_of_several_sizes(tiny_cuda):
    """On the card the decoder is batch-invariant (the model's products
    run through the GEMM kernel, whose sum order does not depend on the
    row count), so the scheduler forms gangs of several sizes, compacts a
    gang when a row leaves and merges stragglers, and every request ends
    with the tokens and commit confidences of its own B = 1 decode. The
    script: three requests with max_gang 2 (gangs of 2 and 1); the
    second is preempted after the first block (its gang compacts to 1)
    and resumes as a gang of its own; the two 1-row gangs at the same
    block merge."""
    import numpy as np

    from repro_torch.core.decoder import DecodeConfig, DiffusionDecoder
    from repro_torch.serving import BlockScheduler
    cfg, params, prompt = tiny_cuda
    prompts = np.concatenate([prompt, prompt[:1] + 1])
    d = DecodeConfig(**{**_BASE, "gen_len": 32, "early_exit": False})
    for m in ("vanilla", "prefix", "fast", "streaming"):
        assert _decoder(tiny_cuda, method=m).batch_invariant
    assert not _decoder(tiny_cuda, method="dkv").batch_invariant
    s = BlockScheduler(cfg, params, d, max_slots=4, max_gang=2,
                       device="cuda")
    assert s.batch_multiple == 1
    for p in prompts:
        s.submit(p, 32, 32)
    sizes, done, tick = [], [], 0
    while not s.idle:
        done += s.tick()[1]
        sizes.append(sorted(g.batch for g in s.gangs))
        if tick == 0:
            s.preempt(2)
        tick += 1
    assert {b for t in sizes for b in t} == {1, 2}, sizes
    assert s.merges >= 1
    dec = DiffusionDecoder(cfg, params, d, device="cuda")
    for c in sorted(done, key=lambda c: c.uid):
        ref = dec.generate(prompts[c.uid - 1][None].copy())
        assert (c.tokens == ref.tokens[0]).all(), c.uid
        assert np.array_equal(c.commit_conf, np.concatenate(
            [b.commit_conf[0] for b in ref.block_stats])), c.uid


# ------------------------------------------------------------------ GEMM

def _bf16_ulp(v):
    """The spacing of bfloat16 numbers at |v| (8 significant bits)."""
    e = torch.frexp(v.abs().float())[1]
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _gemm_ok(y, x, w):
    """The kernel's y against the plain float32 product ``ref`` of the
    same inputs. float32: max |y - ref| <= 2e-5 * max |ref| (the sums run
    in another order). bfloat16: within one bf16 ulp of ref rounded to
    bf16, the ulp taken at the larger of |ref| and 2^-10 * max |ref| (so
    a sum that cancels to nearly 0 is held to the float32 order error
    of its terms, not to the spacing at 0)."""
    ref = x.float() @ w.float()
    scale = ref.abs().max()
    if y.dtype == torch.float32:
        return bool((y - ref).abs().max() <= 2e-5 * scale)
    tol = _bf16_ulp(torch.maximum(ref.abs(), scale * 2.0 ** -10))
    return bool(((y.float() - ref.to(torch.bfloat16).float()).abs()
                 <= tol).all())


# (M, K, N): a llada-8b denoise step at B = 4 (q/k/v/o, gate/up, down),
# a refresh of a middle block (4 rows of prefix 256 + 129), the LM head
# at B = 4 and B = 1 (32 rows a request); the tails the bf16 kernel
# treats apart: one request (M = 129: the second row tile has one live
# row and a warpgroup that skips its wgmmas), one row, N and K that are
# not multiples of 64 (a W box wholly past N, a zero-filled K tail)
_GEMM_SHAPES = {"step_qkvo": (516, 4096, 4096), "step_gate_up": (516, 4096,
                                                                 12288),
                "step_down": (516, 12288, 4096),
                "refresh_gate_up": (1540, 4096, 12288),
                "head": (128, 4096, 126464), "head_b1": (32, 4096, 126464),
                "request_b1": (129, 4096, 4096), "one_row": (1, 4096, 4096),
                "ragged_n136_k72": (129, 72, 136), "ragged": (37, 72, 40)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(_GEMM_SHAPES))
def test_gemm_kernel_matches_plain(cuda, shape, dtype):
    M, K, N = _GEMM_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    w = (torch.randn((K, N), generator=g, device=cuda)
         / K ** 0.5).to(dtype)
    before = ops.LAUNCHES["gemm"]
    y = ops.gemm(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gemm"] == before + 1
    assert y.dtype == dtype and y.shape == (M, N)
    assert _gemm_ok(y, x, w)


@pytest.mark.parametrize("KNR", [(4096, 4096, 129), (4096, 12288, 129),
                                 (12288, 4096, 129), (4096, 126464, 32)],
                         ids=["qkvo", "gate_up", "down", "head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_row_is_bit_equal_at_every_batch_size_and_position(cuda, KNR,
                                                                dtype):
    """A request's rows (129 for a denoise step's products, 32 for the LM
    head) multiplied alone (B = 1) and placed at every request slot
    j < B of a batch of B = 1..8 requests (M = rows * B, the other rows
    random): their outputs are bit-equal."""
    K, N, R = KNR
    g = torch.Generator(device=cuda).manual_seed(1)
    w = (torch.randn((K, N), generator=g, device=cuda) / K ** 0.5).to(dtype)
    x0 = torch.randn((R, K), generator=g, device=cuda).to(dtype)
    y0 = ops.gemm(x0, w)
    for B in range(2, 9):
        x = torch.randn((R * B, K), generator=g, device=cuda).to(dtype)
        for j in range(B):
            xj = x.clone()
            xj[R * j:R * (j + 1)] = x0
            y = ops.gemm(xj, w)
            assert torch.equal(y[R * j:R * (j + 1)], y0), (B, j)


def test_gemm_captures_in_a_cuda_graph(cuda):
    """A captured launch replays with its TMA tensor maps (kernel
    parameters) on new contents of the same buffers."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((258, 4096), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((4096, 4096), generator=g, device=cuda)
         / 64).to(torch.bfloat16)
    ops.gemm(x, w)             # first use: builds, sets smem, encodes maps
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = ops.gemm(x, w)
    x.copy_(torch.randn(x.shape, generator=g, device=cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, ops.gemm(x, w))


_TAIL_CHILD = """
import itertools, sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops
from test_torch_cuda import _gemm_ok
g = torch.Generator(device="cuda").manual_seed(4)
bad = []
for M, K, N in itertools.product((1, 63, 64, 65, 127, 128, 129, 257),
                                 (8, 72, 4104), (8, 40, 136, 264, 4104)):
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=g, device="cuda")
         / K ** 0.5).to(torch.bfloat16)
    if not _gemm_ok(ops.gemm(x, w), x, w):
        bad.append((M, K, N))
torch.cuda.synchronize()
print("bad", bad)
"""


def test_gemm_ring_finishes_at_every_tail(cuda):
    """The bf16 kernel at every kind of tail of its 128 x 256 x 64 tile
    (rows past M in one or both warpgroups, W boxes partly or wholly past
    N, a K shorter than one box or one past a whole tile) finishes and
    matches its plain version. It runs in a child process under a time
    limit, so a ring whose barriers never complete (an ``expect_tx`` that
    differs from what the boxes deliver) fails the test instead of
    hanging the run."""
    tests = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _TAIL_CHILD, str(tests)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "bad []", out.stdout


def test_gemm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    before = dict(ops.LAUNCHES)
    x = torch.randn((8, 64), device=cuda)
    w = torch.randn((64, 32), device=cuda)
    with pytest.raises(ValueError, match="dtypes"):
        ops.gemm(x.half(), w.half())
    with pytest.raises(ValueError, match="dtypes"):
        ops.gemm(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        ops.gemm(x, w.t().contiguous().t())
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.gemm(x[:, :60].contiguous().to(torch.bfloat16),
                 w[:60].contiguous().to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        ops.gemm(x, w[:32])
    with pytest.raises(ValueError, match="devices"):
        ops.gemm(x, w.cpu())
    assert ops.LAUNCHES == before
