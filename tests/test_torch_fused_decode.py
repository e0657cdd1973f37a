"""The port's device loop (``fused=True``) against its host loop
(``fused=False``), as ``tests/test_fused_decode.py`` holds the JAX
package's two loops against each other: on ``tiny`` on the CPU, with JAX
``PRNGKey(3)`` weights carried across by ``repro_torch.bridge``.

On the CPU the device loop runs the same prologue / step body / epilogue
that the card captures into one CUDA graph, with the loop condition read
from a host tensor; the card's graphs are held against the host loop by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import get_config as jget_config
from repro.models import init_params as jinit_params
from repro_torch.bridge import params_from_jax
from repro_torch.core.decoder import METHODS, DecodeConfig, DiffusionDecoder
from repro_torch.models.config import get_config

torch.set_num_threads(1)

CFG = get_config("tiny")
PARAMS = params_from_jax(jax.tree.map(np.asarray, jax.jit(
    jinit_params, static_argnums=0)(jget_config("tiny"),
                                     jax.random.PRNGKey(3))), "cpu")
PROMPT = np.random.default_rng(0).integers(0, 200, (2, 10)).astype(np.int32)
COUNTERS = ("nfe", "steps_per_block", "query_tokens_processed",
            "kv_tokens_attended", "early_exits")


def _decoder(cfg=CFG, **kw):
    kw.setdefault("gen_len", 16)
    kw.setdefault("block_size", 8)
    kw.setdefault("window", 4)
    return DiffusionDecoder(cfg, PARAMS, DecodeConfig(**kw), device="cpu")


def _pair(method, cfg=CFG, **kw):
    """(host-loop result, device-loop result) on identical inputs."""
    host = _decoder(cfg, method=method, fused=False, **kw).generate(
        PROMPT.copy())
    fused = _decoder(cfg, method=method, fused=True, **kw).generate(
        PROMPT.copy())
    return host, fused


def _assert_same(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    for name in COUNTERS:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
@pytest.mark.parametrize("method", METHODS)
def test_fused_matches_host_loop(method, use_kernels):
    """Identical tokens and identical NFE, steps-per-block, query-token,
    kv-token and early-exit counters between the two loops, on the plain
    route and on the kernel route (the kernels' plain versions here)."""
    host, fused = _pair(method, use_kernels=use_kernels, tau0=0.5)
    _assert_same(host, fused)
    assert (fused.tokens != CFG.mask_token_id).all()
    for h, f in zip(host.block_stats, fused.block_stats):
        assert h.committed_per_step == f.committed_per_step
        assert h.conf_hist == f.conf_hist
        assert h.straggler_fill == f.straggler_fill
        np.testing.assert_array_equal(h.commit_conf, f.commit_conf)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
def test_fused_matches_host_loop_frozen_suffix(use_kernels):
    host, fused = _pair("streaming", gen_len=32, window=8,
                        frozen_suffix=True, tau0=0.5,
                        use_kernels=use_kernels)
    _assert_same(host, fused)
    # the steps query only the block: K tokens, not K + w + 1
    plain = _decoder(method="streaming", gen_len=32, window=8,
                     tau0=0.5).generate(PROMPT.copy())
    assert fused.query_tokens_processed < plain.query_tokens_processed


def test_fused_matches_host_loop_early_exit():
    """With a fake EOS the model actually emits, both loops agree on
    which rows exit, when, and on the truncated outputs."""
    r0 = _decoder(method="streaming", gen_len=32, window=8,
                  early_exit=False).generate(PROMPT.copy())
    vals, counts = np.unique(r0.tokens, return_counts=True)
    cfg2 = dataclasses.replace(CFG, eos_token_id=int(vals[counts.argmax()]))
    host, fused = _pair("streaming", cfg2, gen_len=32, window=8)
    _assert_same(host, fused)
    assert fused.early_exits > 0


def test_fused_one_host_sync_per_block():
    """The host loop syncs every denoise step (and, on the fixed-schedule
    methods, copies the (B, K, V) block logits each time); the device
    loop syncs once per block and copies no logits."""
    host, fused = _pair("prefix")
    n_blocks = len(fused.steps_per_block)
    assert fused.host_syncs == n_blocks
    assert fused.logit_syncs == 0
    assert host.host_syncs == host.nfe
    assert host.logit_syncs == host.nfe
    host_s, fused_s = _pair("streaming")
    assert host_s.logit_syncs == fused_s.logit_syncs == 0
    assert fused_s.host_syncs == len(fused_s.steps_per_block)
    assert host_s.host_syncs == host_s.nfe
    # dkv's prefill pass is one more pass and one more sync
    host_d, fused_d = _pair("dkv")
    assert fused_d.host_syncs == len(fused_d.steps_per_block) + 1
    assert host_d.host_syncs == host_d.nfe
    assert host_d.logit_syncs == host_d.nfe - 1


def test_no_new_program_at_the_same_shapes():
    """One block program per (B, T, Sq, block start) (a captured graph
    on the card): a second generation at the same shapes adds none."""
    dec = _decoder(method="streaming")
    dec.generate(PROMPT.copy())
    size = dec.graph_cache_size()
    assert size == 16 // 8
    other = np.random.default_rng(9).integers(0, 200, (2, 10)).astype(
        np.int32)
    dec.generate(other)
    assert dec.graph_cache_size() == size


def test_straggler_finalize_preserves_done_rows():
    """When the steps cap forces a straggler commit, rows that
    early-exited in a prior block keep their masked tail (both loops)."""
    for fused in (False, True):
        dec = _decoder(method="streaming", steps_per_block=1, tau0=0.99,
                       fused=fused)
        st = dec.prefill(PROMPT.copy())
        st.done[0] = True               # pretend row 0 exited in block -1
        dec.decode_block(st)
        blk = st.x[:, st.prompt_len:st.prompt_len + 8]
        assert (blk[0] == CFG.mask_token_id).any(), fused
        assert (blk[1] != CFG.mask_token_id).all(), fused
        assert st.block_stats[0].straggler_fill == 7, fused


@pytest.mark.parametrize("method", ["streaming", "dkv"])
def test_decode_state_resume_across_loop_switch(method):
    """DecodeState is loop-agnostic: blocks alternately decoded by the
    host loop and the device loop reproduce a single-loop run."""
    ref = _decoder(method=method, gen_len=32, window=8).generate(
        PROMPT.copy())
    dec_f = _decoder(method=method, gen_len=32, window=8)
    dec_h = _decoder(method=method, gen_len=32, window=8, fused=False)
    st = dec_h.prefill(PROMPT.copy())
    for dec in (dec_h, dec_f, dec_h, dec_f):
        dec.decode_block(st)
    out = dec_f.finalize(st)
    _assert_same(out, ref)


@pytest.mark.parametrize("method", ["streaming", "dkv"])
def test_interleaved_states_keep_their_caches(method):
    """The cache binding rule: two states decoded block by block in turns
    on one decoder give the tokens each gives alone. dkv states own their
    KV (copied through the bound buffer); the others share the bound
    buffer, which every block refresh rewrites."""
    other = np.random.default_rng(7).integers(0, 200, PROMPT.shape).astype(
        np.int32)
    alone = [_decoder(method=method).generate(p.copy())
             for p in (PROMPT, other)]
    dec = _decoder(method=method)
    states = [dec.prefill(p.copy()) for p in (PROMPT, other)]
    bound = dec._block_buffers(*states[0].x.shape).cache
    if method == "dkv":
        assert all(s.cache is not bound for s in states)
        assert states[0].cache is not states[1].cache
    else:
        assert all(s.cache is bound for s in states)
    while not all(s.finished for s in states):
        for s in states:
            dec.decode_block(s)
    for s, ref in zip(states, alone):
        _assert_same(dec.finalize(s), ref)


def test_copied_state_adopts_the_bound_buffer():
    """A deep copy of a state (another KV buffer) decodes its next block
    on the bound buffer, exactly as the original does."""
    dec = _decoder(method="streaming", gen_len=32, window=8)
    st = dec.prefill(PROMPT.copy())
    dec.decode_block(st)
    twin = copy.deepcopy(st)
    assert twin.cache is not st.cache
    dec.decode_block(twin)
    dec.decode_block(st)
    assert twin.cache is st.cache
    np.testing.assert_array_equal(twin.x, st.x)


@pytest.mark.parametrize("method", METHODS)
def test_loop_closes_early(method):
    """Five of the first block's eight tokens already committed and a
    threshold no confidence reaches: one commit per step, so the loop
    closes after 3 of its 8 steps and the remaining iterations do
    nothing (on the card: their IF nodes skip their bodies). Both loops
    agree on the tokens and the step count."""
    states = []
    for fused in (False, True):
        dec = _decoder(method=method, tau0=1.01, alpha=0.0, fused=fused)
        st = dec.prefill(PROMPT.copy())
        st.committed[:, st.prompt_len:st.prompt_len + 5] = True
        dec.decode_block(st)
        states.append(st)
    host, fused = states
    assert host.steps_per_block == fused.steps_per_block == [3]
    np.testing.assert_array_equal(host.x, fused.x)
    assert fused.block_stats[0].committed_per_step == [2, 2, 2]
    assert fused.host_syncs == 1 + (method == "dkv")
