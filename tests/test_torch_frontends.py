"""The modality frontends (ROADMAP A13 step 4: ``llava-next-34b`` vision
patches, ``musicgen-medium`` audio frames; each a stub of precomputed
embeddings through ``frontend_proj``) against the JAX package on the
CPU, on JAX-initialised weights carried across by ``repro_torch.bridge``:
the forward with ``prefix_embeds`` (frontend-width and d-wide) and with
frontend-width ``embeds``, ``frontend_proj`` through the bridge both
ways, one train step's loss and gradients given JAX's noise draw (a
token-only step: ``frontend_proj``'s gradient is zero on both sides),
and streaming decodes token for token, counter for counter, on both
loops (``tests/test_decoder.py::test_streaming_decode_every_family``).
Inputs are numpy draws from a seed; tolerance 2e-5 in float32."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decoder import DecodeConfig as JDecodeConfig
from repro.core.decoder import DiffusionDecoder as JDiffusionDecoder
from repro.models import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models.model import apply_model as japply_model
from repro.training.loss import diffusion_loss as jdiffusion_loss
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.core.decoder import DecodeConfig, DiffusionDecoder
from repro_torch.models.config import get_config
from repro_torch.models.model import apply_model, init_params
from repro_torch.training import tree
from repro_torch.training.loss import loss_given_noise
from repro_torch.training.train import TrainConfig, train

torch.set_num_threads(1)

TOL = 2e-5
FRONTENDS = ["llava-next-34b-smoke", "musicgen-medium-smoke"]
COUNTERS = ("nfe", "steps_per_block", "query_tokens_processed",
            "kv_tokens_attended", "early_exits")


@functools.lru_cache(maxsize=None)
def pair(name, **over):
    """(JAX config, port config, JAX params, bridged port params)."""
    cj = jget_config(name, **over)
    jp = jax.jit(jinit_params, static_argnums=0)(cj, jax.random.PRNGKey(0))
    return cj, get_config(name, **over), jp, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def draws(cfg, seed=0, S=12):
    """Token ids, frontend-width and d-wide embeddings from one seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size - 4, (2, S)).astype(np.int32)
    pe = rng.standard_normal((2, cfg.frontend_prefix_len,
                              cfg.frontend_embed_dim)).astype(np.float32)
    pd = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    e = rng.standard_normal((2, S, cfg.frontend_embed_dim)).astype(np.float32)
    return toks, pe, pd, e


def check(got, want):
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", FRONTENDS)
def test_forward_with_prefix_embeds_matches_jax(name):
    cj, ct, jp, tp = pair(name)
    toks, pe, pd, _ = draws(cj)
    assert tp["frontend_proj"].shape == (ct.frontend_embed_dim, ct.d_model)
    for prefix in (pe, pd):         # projected; d-wide, prepended as is
        want = japply_model(cj, jp, tokens=jnp.asarray(toks),
                            prefix_embeds=jnp.asarray(prefix))
        got = apply_model(ct, tp, tokens=torch.tensor(toks),
                          prefix_embeds=torch.tensor(prefix))
        assert got.logits.shape == (2, prefix.shape[1] + toks.shape[1],
                                    ct.vocab_size)
        check(got, want)


@pytest.mark.parametrize("name", FRONTENDS)
def test_forward_with_frontend_embeds_matches_jax(name):
    cj, ct, jp, tp = pair(name)
    _, pe, _, e = draws(cj, seed=1)
    want = japply_model(cj, jp, embeds=jnp.asarray(e),
                        prefix_embeds=jnp.asarray(pe))
    got = apply_model(ct, tp, embeds=torch.tensor(e),
                      prefix_embeds=torch.tensor(pe))
    check(got, want)
    # the kernel route (its plain versions on the CPU) computes the same
    got_k = apply_model(ct, tp, embeds=torch.tensor(e),
                        prefix_embeds=torch.tensor(pe), use_kernels=True)
    np.testing.assert_allclose(got_k.logits.numpy(), got.logits.numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_proj_through_the_bridge_both_ways(name):
    cj, ct, jp, tp = pair(name)
    back = params_to_jax(tp, ct)
    np.testing.assert_array_equal(back["frontend_proj"],
                                  np.asarray(jp["frontend_proj"]))
    again = params_from_jax(back, "cpu")
    assert torch.equal(again["frontend_proj"], tp["frontend_proj"])
    # the port's own init draws it at the reference's shape and scale
    own = init_params(ct, torch.Generator().manual_seed(0), "cpu")
    w = own["frontend_proj"]
    assert w.shape == jp["frontend_proj"].shape
    assert abs(float(w.std()) - ct.frontend_embed_dim ** -0.5) < 0.01


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


@pytest.mark.parametrize("name", FRONTENDS)
def test_train_step_loss_and_grads_match_jax(name):
    cj, ct, jp, tp = pair(name)
    toks = jnp.asarray(draws(cj, seed=2, S=24)[0])
    lm = jnp.ones((2, 24), bool)
    rng = jax.random.PRNGKey(1)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jdiffusion_loss(cj, p, toks, lm, rng), has_aux=True)(jp)
    leaves, td = tree.flatten(tp)
    leaves = [p.clone().requires_grad_(True) for p in leaves]
    noise = tuple(torch.tensor(np.asarray(a)) for a in jax_noise(rng, lm))
    loss, _ = loss_given_noise(ct, tree.unflatten(td, leaves),
                               torch.tensor(np.asarray(toks)), *noise)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    want = tree.flatten(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                        "cpu"))[0]
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
    assert not bool(np.asarray(jgrads["frontend_proj"]).any())


def jax_frontend_noise(rng, loss_mask):
    """The draw of the JAX package's frontend step
    (``repro.launch.steps._dl_frontend``): no first position forced."""
    B, S = loss_mask.shape
    k_t, k_mask = jax.random.split(rng)
    t = jax.random.uniform(k_t, (B, 1), minval=0.05, maxval=1.0)
    return t, (jax.random.uniform(k_mask, (B, S)) < t) & loss_mask


@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_train_loss_and_grads_match_jax(name):
    """The frontend train step's loss (the dry run's ``train_4k`` step on
    these configs): ``loss_given_noise(..., prefix_embeds=)`` given the
    draw of ``_dl_frontend`` equals it in loss, ce, aux, masked_acc and
    every gradient, ``frontend_proj``'s now nonzero; ``frontend_draw``
    makes a draw of the same form."""
    from repro.launch.steps import _dl_frontend
    from repro_torch.training.loss import frontend_draw
    cj, ct, jp, tp = pair(name)
    toks, pe, _, _ = draws(cj, seed=3, S=24)
    lm = np.ones((2, 24), bool)
    lm[1, :5] = False                   # a prompt the loss leaves out
    rng = jax.random.PRNGKey(2)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: _dl_frontend(cj, p, jnp.asarray(toks), jnp.asarray(lm),
                               jnp.asarray(pe), rng, None, ()),
        has_aux=True)(jp)
    leaves, td = tree.flatten(tp)
    leaves = [p.clone().requires_grad_(True) for p in leaves]
    t, mask = (torch.tensor(np.asarray(a))
               for a in jax_frontend_noise(rng, jnp.asarray(lm)))
    loss, m = loss_given_noise(ct, tree.unflatten(td, leaves),
                               torch.tensor(toks), t, mask,
                               prefix_embeds=torch.tensor(pe))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    for key in ("ce", "aux", "masked_acc"):
        np.testing.assert_allclose(float(m[key].detach()), float(jm[key]),
                                   rtol=TOL, atol=TOL)
    assert int(m["n_masked"]) == int(jm["n_masked"])
    want = tree.flatten(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                        "cpu"))[0]
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
    assert bool(np.asarray(jgrads["frontend_proj"]).any())
    t2, mask2 = frontend_draw(torch.tensor(lm),
                              torch.Generator().manual_seed(0))
    assert t2.shape == (2, 1) and bool(((t2 >= 0.05) & (t2 < 1)).all())
    assert mask2.dtype == torch.bool and not bool(mask2[1, :5].any())


def test_train_cli_step_runs_on_a_frontend_config():
    """The port's train loop on a frontend config: the token-only step
    leaves ``frontend_proj`` a zero gradient (weight decay alone moves
    it), as ``jax.grad`` does."""
    ct = get_config("musicgen-medium-smoke")
    params = init_params(ct, torch.Generator().manual_seed(0), "cpu")
    before = params["frontend_proj"].clone()
    out, hist = train(ct, TrainConfig(steps=2, batch_size=2, seq_len=16),
                      params=params, verbose=False, device="cpu")
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    moved = out["frontend_proj"] - before
    assert float(moved.abs().max()) > 0
    # decay only: the update is proportional to the weight itself
    ratio = (moved / before)[before.abs() > 1e-3]
    assert float(ratio.max() - ratio.min()) < 1e-5


DECODE = dict(method="streaming", gen_len=16, block_size=8, window=4,
              early_exit=False)


@pytest.mark.parametrize("fused", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("name", FRONTENDS)
def test_streaming_decode_matches_jax(name, fused):
    """``tests/test_decoder.py::test_streaming_decode_every_family`` on
    both packages: the same tokens and counters (no near-tie arises at
    these seeds, so none is excused)."""
    cj, ct, jp, tp = pair(name, block_size=8)
    prompts = np.random.default_rng(1).integers(
        0, cj.vocab_size - 4, (2, 10)).astype(np.int32)
    ref = JDiffusionDecoder(cj, jp, JDecodeConfig(fused=fused, **DECODE)
                            ).generate(prompts)
    got = DiffusionDecoder(ct, tp, DecodeConfig(fused=fused, **DECODE),
                           device="cpu").generate(prompts)
    assert got.tokens.shape == (2, 16)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    for k in COUNTERS:
        assert getattr(got, k) == getattr(ref, k), k
    assert (got.tokens != ct.mask_token_id).all()
