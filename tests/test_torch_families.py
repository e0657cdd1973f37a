"""The port's other families (ROADMAP A13 steps 1-3: qwen3, phi4-mini,
minitron, gemma2, the MoE configs olmoe, kimi-k2, tiny-moe, and the
recurrent recurrentgemma and xlstm) against the JAX package on the CPU,
on JAX-initialised weights carried across by ``repro_torch.bridge``:
forward logits and the MoE aux loss, one train step's loss and gradients
given JAX's noise draw, cached steps against a full encode (gemma2, the
recurrent configs), qwen3's long-serve layout, streaming decodes of
gemma2, olmoe, recurrentgemma and xlstm on both loops (tokens and
counters equal), the recurrent configs' prefix-cache refusal and
checkpoints, and the tied head's one contiguous copy. Tolerance 2e-5 in
float32, 2e-2 (relative to the largest logit) in bfloat16."""
import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decoder import DecodeConfig as JDecodeConfig
from repro.core.decoder import DiffusionDecoder as JDiffusionDecoder
from repro.models import get_config as jget_config
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models.model import apply_model as japply_model
from repro.training import checkpoint as jcheckpoint
from repro.training.loss import diffusion_loss as jdiffusion_loss
from repro_torch.bridge import cache_from_jax, jax_layout, params_from_jax
from repro_torch.core import schedule
from repro_torch.core.decoder import DecodeConfig, DiffusionDecoder
from repro_torch.models import model as model_mod
from repro_torch.models.config import get_config
from repro_torch.models.model import apply_model, init_cache, init_params
from repro_torch.training import checkpoint, tree
from repro_torch.training.loss import loss_given_noise

torch.set_num_threads(1)

TOL = 2e-5
BF16_TOL = 2e-2
RECURRENT = ["recurrentgemma-9b-smoke", "xlstm-350m-smoke"]
FAMILIES = ["qwen3-32b-smoke", "phi4-mini-3.8b-smoke", "minitron-4b-smoke",
            "gemma2-27b-smoke", "olmoe-1b-7b-smoke",
            "kimi-k2-1t-a32b-smoke", "tiny-moe", *RECURRENT]
COUNTERS = ("nfe", "steps_per_block", "query_tokens_processed",
            "kv_tokens_attended", "early_exits")


@functools.lru_cache(maxsize=None)
def pair(name, dtype="float32", **over):
    """(JAX config, port config, JAX params, bridged port params)."""
    over = dict(over, dtype=dtype, param_dtype=dtype)
    cj = jget_config(name, **over)
    jp = jax.jit(jinit_params, static_argnums=0)(cj, jax.random.PRNGKey(0))
    return cj, get_config(name, **over), jp, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 4, (B, S)).astype(np.int32)


def f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits_and_aux_match_jax(name):
    cj, ct, jp, tp = pair(name)
    toks = tokens(cj, 2, 32)
    want = japply_model(cj, jp, tokens=jnp.asarray(toks))
    got = apply_model(ct, tp, tokens=torch.tensor(toks))
    assert got.logits.shape == (2, 32, ct.vocab_size)
    np.testing.assert_allclose(got.logits.numpy(), f32(want.logits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               atol=TOL, rtol=TOL)
    assert (float(got.aux_loss) > 0) == (ct.n_experts > 0)


@pytest.mark.parametrize("name", ["gemma2-27b-smoke", "olmoe-1b-7b-smoke",
                                  *RECURRENT])
def test_bf16_forward_matches_jax(name):
    cj, ct, jp, tp = pair(name, "bfloat16")
    assert tp["layers"][0]["mixer"]["w_up" if "xlstm" in name else
                                    "w_in" if "recurrent" in name
                                    else "wq"].dtype == torch.bfloat16
    toks = tokens(cj, 2, 24, seed=1)
    want = f32(japply_model(cj, jp, tokens=jnp.asarray(toks)).logits)
    got = apply_model(ct, tp, tokens=torch.tensor(toks)).logits.numpy()
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


# ------------------------------------------------------------ train step

def jax_noise(rng, loss_mask):
    """The JAX package's draw, as ``repro.training.loss`` makes it."""
    B, S = loss_mask.shape
    k_t, k_mask = jax.random.split(rng)
    t = jax.random.uniform(k_t, (B, 1), minval=0.05, maxval=1.0)
    mask = (jax.random.uniform(k_mask, (B, S)) < t) & loss_mask
    none = ~jnp.any(mask, axis=1, keepdims=True)
    first = jnp.argmax(loss_mask, axis=1)
    forced = jax.nn.one_hot(first, S, dtype=jnp.bool_) & loss_mask
    return t, mask | (none & forced)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_loss_and_grads_match_jax(name):
    """One train step's loss, its ``ce``/``aux`` metrics and every
    gradient, the port given JAX's ``(t, mask)``."""
    cj, ct, jp, tp = pair(name)
    toks = jnp.asarray(tokens(cj, 2, 24, seed=2))
    lm = jnp.ones((2, 24), bool)
    rng = jax.random.PRNGKey(1)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jdiffusion_loss(cj, p, toks, lm, rng), has_aux=True)(jp)
    leaves, td = tree.flatten(tp)
    leaves = [p.clone().requires_grad_(True) for p in leaves]
    noise = tuple(torch.tensor(np.asarray(a)) for a in jax_noise(rng, lm))
    loss, m = loss_given_noise(ct, tree.unflatten(td, leaves),
                               torch.tensor(np.asarray(toks)), *noise)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    want = tree.flatten(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                        "cpu"))[0]
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)


# ------------------------------------------------------------ cache, layout

def test_gemma2_cached_step_matches_full_encode_and_jax():
    """Refresh + step equals one full encode on the query region (the
    same visibility, local and global layers, both softcaps), and the
    step equals the JAX package's."""
    cj, ct, jp, tp = pair("gemma2-27b-smoke")
    B, P, Q = 2, 12, 6
    toks = tokens(cj, B, P + Q, seed=3)
    full = apply_model(ct, tp, tokens=torch.tensor(toks))
    cache = init_cache(ct, B, P + Q, "cpu")
    apply_model(ct, tp, tokens=torch.tensor(toks), cache=cache)
    qpos = torch.arange(P, P + Q, dtype=torch.int32)[None].expand(B, Q)
    step = apply_model(ct, tp, tokens=torch.tensor(toks[:, P:]),
                       positions=qpos, mode="step", cache=cache,
                       kv_valid=torch.full((B,), P, dtype=torch.int32))
    np.testing.assert_allclose(step.logits.numpy(),
                               full.logits[:, P:].numpy(), atol=TOL,
                               rtol=TOL)
    jenc = japply_model(cj, jp, tokens=jnp.asarray(toks), mode="encode",
                        cache=jinit_cache(cj, B, P + Q), cache_upto=P)
    jstep = japply_model(cj, jp, tokens=jnp.asarray(toks[:, P:]),
                         positions=jnp.asarray(qpos.numpy()), mode="step",
                         cache=jenc.cache,
                         kv_valid=jnp.full((B,), P, jnp.int32))
    np.testing.assert_allclose(step.logits.numpy(), f32(jstep.logits),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_cached_step_matches_full_encode_and_jax(name):
    """``tests/test_models.py::test_cached_step_consistency`` on the port:
    a refresh split at the prefix (``cache_upto``) keeps the recurrent
    state at the boundary, and a step that resumes from it over the query
    region equals one full encode there (causal scans: the prefix saw
    nothing after it); the step, the refresh's logits and every cache leaf
    equal the JAX package's."""
    cj, ct, jp, tp = pair(name)
    B, P, Q = 2, 12, 6
    toks = tokens(cj, B, P + Q, seed=3)
    full = apply_model(ct, tp, tokens=torch.tensor(toks))
    cache = init_cache(ct, B, P + Q, "cpu")
    enc = apply_model(ct, tp, tokens=torch.tensor(toks), cache=cache,
                      cache_upto=P)
    qpos = torch.arange(P, P + Q, dtype=torch.int32)[None].expand(B, Q)
    step = apply_model(ct, tp, tokens=torch.tensor(toks[:, P:]),
                       positions=qpos, mode="step", cache=cache,
                       kv_valid=torch.full((B,), P, dtype=torch.int32))
    np.testing.assert_allclose(step.logits.numpy(),
                               full.logits[:, P:].numpy(), atol=TOL,
                               rtol=TOL)
    jenc = japply_model(cj, jp, tokens=jnp.asarray(toks), mode="encode",
                        cache=jinit_cache(cj, B, P + Q), cache_upto=P)
    jstep = japply_model(cj, jp, tokens=jnp.asarray(toks[:, P:]),
                         positions=jnp.asarray(qpos.numpy()), mode="step",
                         cache=jenc.cache,
                         kv_valid=jnp.full((B,), P, jnp.int32))
    np.testing.assert_allclose(enc.logits.numpy(), f32(jenc.logits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(step.logits.numpy(), f32(jstep.logits),
                               atol=TOL, rtol=TOL)
    want = cache_from_jax(jax.tree.map(np.asarray, jenc.cache), "cpu")
    assert [type(c).__name__ for c in want] == \
        [type(c).__name__ for c in cache]
    for got_l, want_l in zip(cache, want):
        for g, w in zip(got_l, want_l):
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_prefix_cache_is_refused_as_in_jax(name):
    """The prefix cache needs an attention-only layout in both packages:
    the same assertion, worded alike."""
    cj, ct, jp, tp = pair(name, block_size=8)
    d = dict(DECODE, prefix_cache=True)
    with pytest.raises(AssertionError, match="attention-only") as jerr:
        JDiffusionDecoder(cj, jp, JDecodeConfig(**d))
    with pytest.raises(AssertionError, match="attention-only") as terr:
        DiffusionDecoder(ct, tp, DecodeConfig(**d), device="cpu")
    assert str(terr.value) == str(jerr.value)


def _assert_leaves_equal(port_params, cfg, jtree):
    ours = tree.flatten(jax_layout(port_params, cfg))[0]
    leaves = jax.tree.leaves(jtree)
    assert len(leaves) == len(ours)
    for a, t in zip(leaves, ours):
        assert a.dtype == jnp.dtype(str(t.dtype).split(".")[-1])
        assert a.shape == tuple(t.shape)
        np.testing.assert_array_equal(np.asarray(jnp.asarray(a, jnp.float32)),
                                      t.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_checkpoints_cross_both_ways(name, dtype):
    """A JAX checkpoint of a recurrent config read into the port, and the
    port's read by the JAX package (float32: its ``restore`` reads no
    bfloat16 leaf), every leaf (``wq``/``wk``/``wv`` (di, H, dk), ``r_*``
    (H, hd, hd), ``lam``, ``conv``, ``gn``) equal bit for bit."""
    cj, ct, jp, _ = pair(name, dtype)
    with tempfile.TemporaryDirectory() as tmp:
        jcheckpoint.save(f"{tmp}/jax", jp)
        like = init_params(ct, torch.Generator().manual_seed(0), "cpu")
        back = checkpoint.restore(f"{tmp}/jax", like, ct)
        _assert_leaves_equal(back, ct, jp)
        if dtype == "float32":
            ours = init_params(ct, torch.Generator().manual_seed(2), "cpu")
            checkpoint.save(f"{tmp}/port", ours, ct)
            _assert_leaves_equal(ours, ct,
                                 jcheckpoint.restore(f"{tmp}/port", jp))


def test_long_serve_layout_switch():
    cfg = get_config("qwen3-32b-smoke")
    assert all(s.mixer == "attn_local"
               for s in cfg.effective_layout(serve_long=True))
    assert all(s.mixer == "attn" for s in cfg.effective_layout())
    # the port switches through the config; the same logits as the JAX
    # package's serve_long pass
    cj, ct, jp, tp = pair("qwen3-32b-smoke", local_window=8)
    toks = tokens(cj, 2, 32, seed=4)
    want = japply_model(cj, jp, tokens=jnp.asarray(toks), serve_long=True)
    local = dataclasses.replace(ct, force_local_attention=True)
    got = apply_model(local, tp, tokens=torch.tensor(toks))
    np.testing.assert_allclose(got.logits.numpy(), f32(want.logits),
                               atol=TOL, rtol=TOL)
    wide = apply_model(ct, tp, tokens=torch.tensor(toks)).logits
    assert not torch.allclose(got.logits, wide, atol=1e-3)


# ------------------------------------------------------------ decode

DECODE = dict(method="streaming", gen_len=16, block_size=8, window=4)


@functools.lru_cache(maxsize=None)
def jax_decode(name, fused, tau0):
    cj, _, jp, _ = pair(name, block_size=8)
    prompts = tokens(cj, 2, 10, seed=1)
    d = JDecodeConfig(fused=fused, tau0=tau0, **DECODE)
    return JDiffusionDecoder(cj, jp, d).generate(prompts)


@pytest.mark.parametrize("tau0", [0.5, 0.02], ids=["one_a_step", "parallel"])
@pytest.mark.parametrize("fused", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("name", ["gemma2-27b-smoke", "olmoe-1b-7b-smoke",
                                  *RECURRENT])
def test_streaming_decode_matches_jax(name, fused, tau0):
    cj, ct, _, tp = pair(name, block_size=8)
    ref = jax_decode(name, fused, tau0)
    prompts = tokens(cj, 2, 10, seed=1)
    d = DecodeConfig(fused=fused, tau0=tau0, **DECODE)
    got = DiffusionDecoder(ct, tp, d, device="cpu").generate(prompts)
    # exact: no near-tie arises at these seeds, so none is excused
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    for k in COUNTERS:
        assert getattr(got, k) == getattr(ref, k), k
    assert (got.tokens != ct.mask_token_id).all()


# ------------------------------------------------------------ tied head

def test_tied_head_is_one_contiguous_copy_per_embed(monkeypatch):
    """gemma2 (tied): every head product of a decode, on both loops and
    across decoders on the same weights, reads the one contiguous (d, V)
    copy that the first decoder built; a new embed tensor, or one
    written in place, gets a new copy; training keeps ``embed.T``."""
    _, ct, _, tp = pair("gemma2-27b-smoke", block_size=8)
    tp = dict(tp, embed=tp["embed"].clone())      # a copy of our own
    built, heads = [], []
    contiguous = torch.Tensor.contiguous

    def counting(self, *a, **kw):
        if self.shape == (ct.d_model, ct.vocab_size):
            built.append(1)
        return contiguous(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "contiguous", counting)
    linear = model_mod.linear

    def seen(x, w, **kw):
        if w.shape == (ct.d_model, ct.vocab_size):
            heads.append(w)
        return linear(x, w, **kw)

    for mod in (model_mod, schedule):       # the full head, the fused head
        monkeypatch.setattr(mod, "linear", seen)
    prompts = tokens(ct, 2, 10, seed=5)
    for fused in (True, False):
        for method in ("streaming", "vanilla"):
            d = DecodeConfig(fused=fused, **dict(DECODE, method=method))
            dec = DiffusionDecoder(ct, tp, d, device="cpu")
            dec.generate(prompts)
    assert len(built) == 1
    head = model_mod.serving_head(ct, tp)
    assert head.is_contiguous() and head.shape == (ct.d_model,
                                                   ct.vocab_size)
    assert torch.equal(head, tp["embed"].T)
    assert heads and all(h is head for h in heads)
    assert dec.head is head
    tp["embed"].mul_(1.0)                           # written in place
    assert model_mod.serving_head(ct, tp) is not head and len(built) == 2
    toks = torch.tensor(prompts)
    out = apply_model(ct, tp, tokens=toks, train=True)
    assert len(built) == 2 and out.logits.shape[-1] == ct.vocab_size
