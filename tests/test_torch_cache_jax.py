"""The port's prefix-cache decode against the JAX package's on ``tiny``
(JAX ``PRNGKey(3)`` weights carried across by ``repro_torch.bridge``):
a cold decode, then a warm one of the same prompts from the store the
cold one filled, each with identical tokens and NFE / steps-per-block /
query-token / kv-token / early-exit counters, for every method with a
KV cache on the device loop and on the host loop (the JAX package's
Pallas kernels are not on this path: ``use_kernels`` is off on its side,
as its own cache tests run it); and one stored chunk's KV against the
reference store's to 2e-5."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.cache import PrefixKVCache as JPrefixKVCache
from repro.core.decoder import DecodeConfig as JDecodeConfig
from repro.core.decoder import DiffusionDecoder as JDiffusionDecoder
from repro.models import get_config as jget_config
from repro.models import init_params as jinit_params
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.cache import PrefixKVCache, device_placement
from repro_torch.core.decoder import DecodeConfig, DiffusionDecoder
from repro_torch.models.config import get_config

torch.set_num_threads(1)

CFG_J = jget_config("tiny")
CFG = get_config("tiny")
JPARAMS = jax.jit(jinit_params, static_argnums=0)(CFG_J, jax.random.PRNGKey(3))
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")
CHUNK = 8
PROMPT = np.random.default_rng(1).integers(0, 200, (2, 20)).astype(np.int32)
BASE = dict(gen_len=16, block_size=8, window=4, tau0=0.5, prefix_cache=True,
            cache_chunk=CHUNK)
COUNTERS = ("nfe", "steps_per_block", "query_tokens_processed",
            "kv_tokens_attended", "early_exits")


@functools.lru_cache(maxsize=None)
def _jax_runs(method, fused):
    store = JPrefixKVCache(chunk_tokens=CHUNK)
    d = JDecodeConfig(method=method, fused=fused, **BASE)
    runs = [JDiffusionDecoder(CFG_J, JPARAMS, d, prompt_cache=store)
            .generate(PROMPT.copy()) for _ in range(2)]
    return runs, store


def _port_runs(method, fused):
    store = PrefixKVCache(chunk_tokens=CHUNK,
                          placement=device_placement("cpu"))
    d = DecodeConfig(method=method, fused=fused, **BASE)
    runs = [DiffusionDecoder(CFG, PARAMS, d, device="cpu",
                             prompt_cache=store).generate(PROMPT.copy())
            for _ in range(2)]
    return runs, store


@pytest.mark.parametrize("fused", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("method", ["dkv", "prefix", "fast", "streaming"])
def test_prefix_cache_decode_matches_jax(method, fused):
    (cold, warm), store = _port_runs(method, fused)
    (jcold, jwarm), jstore = _jax_runs(method, fused)
    for port, ref in ((cold, jcold), (warm, jwarm)):
        np.testing.assert_array_equal(port.tokens, ref.tokens)
        for name in COUNTERS:
            assert getattr(port, name) == getattr(ref, name), name
    assert warm.nfe == cold.nfe - 2               # two chunk passes saved
    assert store.stats()["lookup_hit_tokens"] == \
        jstore.stats()["lookup_hit_tokens"] == 2 * 2 * CHUNK
    assert store.nodes == jstore.nodes == 4


def test_stored_chunk_kv_matches_jax():
    """The second chunk of row 1 (it attends to the first chunk and
    itself: chunk-causal) as each store holds it."""
    _, store = _port_runs("streaming", True)
    _, jstore = _jax_runs("streaming", True)
    got = store.match(PROMPT[1])[1].payload
    want = cache_from_jax(jax.tree.map(np.asarray,
                                       jstore.match(PROMPT[1])[1].payload),
                          "cpu")
    assert len(got) == len(want) == CFG.n_layers
    for (k, v), (jk, jv) in zip(got, want):
        assert k.shape == jk.shape == (CHUNK, k.shape[1], CFG.head_dim)
        torch.testing.assert_close(k, jk, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(v, jv, atol=2e-5, rtol=2e-5)
