"""The port's training path against the JAX package's, on the CPU in
float32 (tolerance 2e-5 unless stated): the dataset, the loss and every
gradient given JAX's own noise draw, ``chunked_ce``, three optimizer
steps, checkpoints written by one package and read by the other, the
leaf order against ``jax.tree.flatten``, and a ``tiny`` model trained by
the JAX package, loaded into the port from its checkpoint and decoded by
both: tokens and counters equal for all five methods on both loops, on
weights whose decode commits several tokens in a step and exits early."""
import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decoder import DecodeConfig as JDecodeConfig
from repro.core.decoder import DiffusionDecoder as JDiffusionDecoder
from repro.data import synthetic as jsynthetic
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro.models import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models.config import LayerSpec as JLayerSpec
from repro.training import checkpoint as jcheckpoint
from repro.training.loss import chunked_ce as jchunked_ce
from repro.training.loss import diffusion_loss as jdiffusion_loss
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as jadamw_init
from repro.training.train import TrainConfig as JTrainConfig
from repro.training.train import make_train_step as jmake_train_step
from repro.training.train import train as jtrain
from repro_torch.bridge import jax_layout, params_from_jax, params_to_jax
from repro_torch.core.decoder import METHODS, DecodeConfig, DiffusionDecoder
from repro_torch.data import synthetic
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import get_config, init_params
from repro_torch.training import checkpoint, tree
from repro_torch.training.loss import chunked_ce, loss_given_noise
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train import TrainConfig, make_train_step

torch.set_num_threads(1)

TOL = 2e-5
CFG_J = jget_config("tiny")
CFG = get_config("tiny")
JPARAMS = jax.jit(jinit_params, static_argnums=0)(CFG_J, jax.random.PRNGKey(3))
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")
COUNTERS = ("nfe", "steps_per_block", "query_tokens_processed",
            "kv_tokens_attended", "early_exits")


def jax_noise(rng, loss_mask):
    """The JAX package's draw, exactly as ``repro.training.loss``'s
    ``diffusion_loss`` makes it from ``rng``."""
    B, S = loss_mask.shape
    k_t, k_mask = jax.random.split(rng)
    t = jax.random.uniform(k_t, (B, 1), minval=0.05, maxval=1.0)
    mask = (jax.random.uniform(k_mask, (B, S)) < t) & loss_mask
    none = ~jnp.any(mask, axis=1, keepdims=True)
    first = jnp.argmax(loss_mask, axis=1)
    forced = jax.nn.one_hot(first, S, dtype=jnp.bool_) & loss_mask
    return t, mask | (none & forced)


def as_torch_noise(noise):
    return tuple(torch.tensor(np.asarray(a)) for a in noise)


def assert_trees_close(port_params, jtree, rtol=TOL, atol=TOL):
    want = tree.flatten(params_from_jax(jax.tree.map(np.asarray, jtree),
                                        "cpu"))[0]
    got = tree.flatten(port_params)[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                   rtol=rtol, atol=atol)


def _batch(step, B=8, S=28):
    ds = jsynthetic.ArithmeticDataset(JByteTokenizer(320), seq_len=S, seed=0)
    return ds.batch(step, B)


# ------------------------------------------------------------ data

@pytest.mark.parametrize("seed,shots,seq_len", [(0, 0, 28), (7, 2, 96)])
def test_dataset_batches_and_eval_sets_equal_jax(seed, shots, seq_len):
    ours = synthetic.ArithmeticDataset(ByteTokenizer(320), seq_len=seq_len,
                                       shots=shots, seed=seed)
    ref = jsynthetic.ArithmeticDataset(JByteTokenizer(320), seq_len=seq_len,
                                       shots=shots, seed=seed)
    for step in (0, 1, 299):
        a, b = ours.batch(step, 6), ref.batch(step, 6)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.loss_mask, b.loss_mask)
        assert a.tokens.dtype == b.tokens.dtype
    for n, s in ((32, 10_000), (5, 3)):
        assert ours.eval_set(n, seed=s) == [
            synthetic.Sample(x.prompt, x.answer) for x in ref.eval_set(n, s)]
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    assert synthetic.few_shot_prompt(rng_a, 3) == \
        jsynthetic.few_shot_prompt(rng_b, 3)
    gen = np.full((3, 8), 300, np.int32)
    samples = ours.eval_set(3)
    assert synthetic.exact_match(ByteTokenizer(320), gen, samples) == \
        jsynthetic.exact_match(JByteTokenizer(320), gen, samples)


# ------------------------------------------------------------ loss

def test_loss_metrics_and_gradients_match_jax_given_its_draw():
    b = _batch(0)
    lm = jnp.asarray(b.loss_mask)
    rng = jax.random.PRNGKey(5)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jdiffusion_loss(CFG_J, p, jnp.asarray(b.tokens), lm, rng),
        has_aux=True)(JPARAMS)
    leaves, td = tree.flatten(PARAMS)
    leaves = [p.clone().requires_grad_(True) for p in leaves]
    loss, m = loss_given_noise(CFG, tree.unflatten(td, leaves),
                               torch.tensor(b.tokens),
                               *as_torch_noise(jax_noise(rng, lm)))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    for k in ("ce", "aux", "masked_acc", "n_masked"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=TOL, err_msg=k)
    assert_trees_close(tree.unflatten(td, list(grads)), jgrads)


def test_chunked_ce_matches_jax():
    g = np.random.default_rng(1)
    B, S = 2, 37
    hidden = g.standard_normal((B, S, CFG.d_model)).astype(np.float32)
    tokens = g.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    w = np.abs(g.standard_normal((B, S))).astype(np.float32)
    jn, jc = jchunked_ce(CFG_J, JPARAMS, jnp.asarray(hidden),
                         jnp.asarray(tokens), jnp.asarray(w), chunk=16)
    n, c = chunked_ce(CFG, PARAMS, torch.tensor(hidden),
                      torch.tensor(tokens), torch.tensor(w), chunk=16)
    np.testing.assert_allclose(float(n), float(jn), rtol=TOL)
    np.testing.assert_allclose(float(c), float(jc), rtol=TOL)


def test_three_train_steps_match_jax():
    """``make_train_step`` three times from the same weights, the port
    given each step's JAX draw: loss, grad_norm and lr each step, and the
    weights after the third, to 2e-5."""
    ocfg = dataclasses.replace(JAdamWConfig(), total_steps=3)
    jstep = jax.jit(jmake_train_step(CFG_J, ocfg))
    jp, jst = JPARAMS, jadamw_init(ocfg, JPARAMS)
    popt = AdamWConfig(**dataclasses.asdict(ocfg))
    pstep = make_train_step(CFG, popt)
    p, pst = PARAMS, adamw_init(popt, tree.flatten(PARAMS)[0])
    key = jax.random.PRNGKey(0)
    for step in range(3):
        b = _batch(step)
        key, sub = jax.random.split(key)
        lm = jnp.asarray(b.loss_mask)
        jp, jst, jm = jstep(jp, jst, jnp.asarray(b.tokens), lm, sub)
        p, pst, m = pstep(p, pst, torch.tensor(b.tokens),
                          as_torch_noise(jax_noise(sub, lm)))
        for k in ("loss", "grad_norm", "lr", "masked_acc"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                       err_msg=f"step {step} {k}")
    assert pst.step == int(jst.step) == 3
    assert_trees_close(p, jp)


def test_train_config_defaults_equal_jax():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())


# ------------------------------------------------------------ checkpoints

def _leaf_equal(port_params, jtree):
    want = tree.flatten(params_to_jax(port_params, CFG))[0]
    got = jax.tree.leaves(jax.tree.map(np.asarray, jtree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_reads_into_the_port(tmp_path):
    path = str(tmp_path / "jax")
    jcheckpoint.save(path, JPARAMS, {"from": "jax"})
    like = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    back = checkpoint.restore(path, like, CFG)
    for a, b in zip(tree.flatten(back)[0], tree.flatten(PARAMS)[0]):
        assert torch.equal(a, b)
    assert checkpoint.load_metadata(path) == {"from": "jax"}


def test_port_checkpoint_reads_into_jax(tmp_path):
    path = str(tmp_path / "port")
    params = init_params(CFG, torch.Generator().manual_seed(2), "cpu")
    checkpoint.save(path, params, CFG, {"from": "port"})
    back = jcheckpoint.restore(path, JPARAMS)
    _leaf_equal(params, back)
    assert jcheckpoint.load_metadata(path) == {"from": "port"}


def _configs(which):
    if which == "pattern_and_tail":
        over = dict(n_layers=5, reps=0, local_window=4)
        pj = (JLayerSpec("attn", "swiglu"), JLayerSpec("attn_local", "swiglu"))
        from repro_torch.models.config import LayerSpec
        pp = (LayerSpec("attn", "swiglu"), LayerSpec("attn_local", "swiglu"))
        return (dataclasses.replace(CFG_J, pattern=pj,
                                    tail=(JLayerSpec("attn", "gelu"),),
                                    **over),
                dataclasses.replace(CFG, pattern=pp,
                                    tail=(LayerSpec("attn", "gelu"),),
                                    **over))
    if which == "tied":
        return (dataclasses.replace(CFG_J, tie_embeddings=True),
                dataclasses.replace(CFG, tie_embeddings=True))
    return jget_config(which), get_config(which)


@pytest.mark.parametrize("which", ["tiny", "tiny-100m", "pattern_and_tail",
                                   "tied"])
def test_leaf_order_is_jax_tree_flatten(which):
    """The port's checkpoint order (``tree.flatten`` of ``jax_layout``)
    against JAX's own ``jax.tree.flatten`` of ``init_params``: the same
    treedef string and every leaf's shape and dtype, position for
    position."""
    cfg_j, cfg = _configs(which)
    shapes = jax.eval_shape(lambda k: jinit_params(cfg_j, k),
                            jax.random.PRNGKey(0))
    jleaves, jdef = jax.tree.flatten(shapes)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shape_of = lambda ls: torch.empty((len(ls), *ls[0].shape),  # noqa: E731
                                      dtype=ls[0].dtype, device="meta")
    leaves, td = tree.flatten(jax_layout(params, cfg, lambda t: t, shape_of))
    assert tree.treedef_str(td) == str(jdef)
    assert [tuple(l.shape) for l in leaves] == [l.shape for l in jleaves]
    assert all(str(l.dtype) == f"torch.{j.dtype}"
               for l, j in zip(leaves, jleaves))


# ------------------------------------------------------------ trained decode

TRAIN = dict(steps=100, batch_size=16, seq_len=28, log_every=99)
DECODE = dict(gen_len=16, block_size=8, window=4, tau0=0.9, alpha=0.3)
# two-token blocks: rows of one batch exit at different blocks
STAGGERED = dict(gen_len=8, block_size=2, window=4, tau0=0.9, alpha=0.3)


@functools.lru_cache(maxsize=None)
def trained():
    """``tiny`` trained by the JAX package (100 steps: the first count
    whose decode writes answers, not only EOS), saved by its
    ``checkpoint.save`` and restored by the port's ``restore``."""
    jp, hist = jtrain(CFG_J, JTrainConfig(**TRAIN), verbose=False)
    like = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trained")
        jcheckpoint.save(path, jp, {"steps": TRAIN["steps"]})
        params = checkpoint.restore(path, like, CFG)
    tok = ByteTokenizer(320)
    samples = synthetic.ArithmeticDataset(tok, seq_len=28).eval_set(8)
    prompts = np.stack([tok.encode(s.prompt) for s in samples]
                       ).astype(np.int32)
    return jp, params, prompts, hist


@functools.lru_cache(maxsize=None)
def jax_decode(method, fused, setting):
    jp, _, prompts, _ = trained()
    d = JDecodeConfig(method=method, fused=fused, **setting_kw(setting))
    return JDiffusionDecoder(CFG_J, jp, d).generate(prompts.copy())


def setting_kw(setting):
    return {"blocks_of_8": DECODE, "blocks_of_2": STAGGERED}[setting]


def port_decode(method, fused, setting, use_kernels):
    _, params, prompts, _ = trained()
    d = DecodeConfig(method=method, fused=fused, use_kernels=use_kernels,
                     **setting_kw(setting))
    return DiffusionDecoder(CFG, params, d, device="cpu").generate(
        prompts.copy())


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
@pytest.mark.parametrize("fused", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("method", METHODS)
def test_trained_decode_matches_jax(method, fused, use_kernels):
    """No near-tie is excused: tokens and every counter equal."""
    port = port_decode(method, fused, "blocks_of_8", use_kernels)
    ref = jax_decode(method, fused, "blocks_of_8")
    np.testing.assert_array_equal(port.tokens, ref.tokens)
    for name in COUNTERS:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("fused", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("method", ["dkv", "streaming"])
def test_trained_decode_with_staggered_exits_matches_jax(method, fused):
    port = port_decode(method, fused, "blocks_of_2", True)
    ref = jax_decode(method, fused, "blocks_of_2")
    np.testing.assert_array_equal(port.tokens, ref.tokens)
    for name in COUNTERS:
        assert getattr(port, name) == getattr(ref, name), name


def test_trained_weights_commit_several_tokens_and_exit_early():
    """What random weights never reach: a parallel method commits more
    than one token in a step, blocks exit early on EOS, and with
    two-token blocks rows of one batch exit at different blocks; the
    model answers (not only EOS) and its loss fell."""
    _, _, _, hist = trained()
    assert hist[-1]["loss"] < hist[0]["loss"]
    r = port_decode("streaming", True, "blocks_of_8", True)
    assert max(max(s.committed_per_step) for s in r.block_stats) > 1
    assert r.nfe < len(r.steps_per_block) * DECODE["block_size"]
    assert r.early_exits > 0
    assert r.tokens_generated > 0
    s = port_decode("streaming", True, "blocks_of_2", True)
    exits = [b.early_exits for b in s.block_stats]
    assert sum(1 for e in exits if e) >= 2, exits
