"""The port's MoE dense path (``repro_torch.models.moe``) against the
JAX package's on the CPU: ``apply_moe_dense`` and its aux loss in float32
(2e-5) and bfloat16 (2e-2), the combine against a token-by-token sum,
the load-balance loss of uniform routing, the top-k order on ties, the
router kept float32 through a bf16 bridge, ``init_params`` and a cast,
``remat`` against no remat, and MoE checkpoints read bit for bit by the
other package."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.training import checkpoint as jcheckpoint
from repro_torch.bridge import jax_layout, params_from_jax
from repro_torch.models import moe
from repro_torch.models.config import get_config
from repro_torch.models.model import init_params, params_to
from repro_torch.training import checkpoint, tree
from repro_torch.training.loss import loss_given_noise

torch.set_num_threads(1)

TOL = 2e-5
CFG_J = jget_config("tiny-moe")
CFG = get_config("tiny-moe")


def moe_pair(dtype=jnp.float32):
    jp = jmoe.init_moe(jax.random.PRNGKey(0), CFG_J, dtype)
    return jp, {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.float32 if k == "router" else
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_dense_matches_jax(dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp, tp = moe_pair(jd)
    x = np.random.default_rng(0).standard_normal((2, 6, CFG.d_model))
    y_j, aux_j = jmoe.apply_moe_dense(CFG_J, jp, jnp.asarray(x, jd))
    xt = torch.tensor(x, dtype=torch.float32).to(getattr(torch, dtype))
    y, aux = moe.apply_moe_dense(CFG, tp, xt)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    want = np.asarray(jnp.asarray(y_j, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), want, atol=TOL, rtol=TOL)
    else:
        assert np.abs(y.float().numpy() - want).max() \
            <= 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=TOL)


def test_dense_path_matches_manual():
    """The combine equals, token by token, the sum over its top-k
    experts of the gate weight times the expert's SwiGLU (the JAX
    package's ``test_moe.py`` check)."""
    _, p = moe_pair()
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 6, CFG.d_model)), dtype=torch.float32)
    y, _ = moe.apply_moe_dense(CFG, p, x)
    x2 = x.reshape(-1, CFG.d_model)
    probs = torch.softmax(x2 @ p["router"], -1)
    w, ids = moe.top_k(probs, CFG.moe_top_k)
    w = w / w.sum(-1, keepdim=True)
    want = torch.zeros_like(x2)
    for t in range(x2.shape[0]):
        for j in range(CFG.moe_top_k):
            e = int(ids[t, j])
            h = torch.nn.functional.silu(x2[t] @ p["w_gate"][e]) \
                * (x2[t] @ p["w_up"][e])
            want[t] += w[t, j] * (h @ p["w_down"][e])
    np.testing.assert_allclose(y.reshape(-1, CFG.d_model).numpy(),
                               want.numpy(), atol=1e-5, rtol=1e-5)


def test_load_balance_loss_uniform_is_one():
    E, T, k = 8, 1024, 2
    cfg = dataclasses.replace(CFG, n_experts=E)
    probs = torch.full((T, E), 1.0 / E)
    ids = torch.tensor(np.random.default_rng(0).integers(0, E, (T, k)))
    val = float(moe.load_balance_loss(cfg, probs, ids))
    assert abs(val - 1.0) < 0.05
    want = float(jmoe.load_balance_loss(
        type("c", (), {"n_experts": E})(), jnp.asarray(probs.numpy()),
        jnp.asarray(ids.numpy())))
    np.testing.assert_allclose(val, want, rtol=1e-6)


def test_top_k_ties_follow_lax_top_k():
    """Equal probabilities: the lower expert first, as ``jax.lax.top_k``
    orders them."""
    rng = np.random.default_rng(2)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    probs[0] = 0.25                                # a row of one value
    for k in (1, 2, 5, 16):
        w, ids = moe.top_k(torch.tensor(probs), k)
        wj, idj = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(idj))
        np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    assert moe.top_k(torch.tensor(probs[:1]), 3)[1].tolist() == [[0, 1, 2]]


def test_router_stays_float32():
    """Through a bf16 bridge, ``init_params`` of a bf16 config and a cast
    of the params tree, the router stays float32 and every other float
    leaf takes the model's dtype, as in the JAX package."""
    bf = get_config("olmoe-1b-7b-smoke", param_dtype="bfloat16",
                    dtype="bfloat16")
    jp = jax.jit(jinit_params, static_argnums=0)(
        jget_config("olmoe-1b-7b-smoke"), jax.random.PRNGKey(0))
    bridged = params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                              torch.bfloat16)
    ported = init_params(bf, torch.Generator().manual_seed(0), "cpu")
    cast = params_to(init_params(get_config("olmoe-1b-7b-smoke"),
                                 torch.Generator(), "cpu"), torch.bfloat16)
    jbf = jax.jit(jinit_params, static_argnums=0)(
        jget_config("olmoe-1b-7b-smoke", param_dtype="bfloat16"),
        jax.random.PRNGKey(0))
    assert jbf["scan"][0]["ffn"]["router"].dtype == jnp.float32
    for params in (bridged, ported, cast):
        for layer in params["layers"]:
            assert layer["ffn"]["router"].dtype == torch.float32
            assert layer["ffn"]["w_gate"].dtype == torch.bfloat16
        assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bridged["layers"][1]["ffn"]["router"].numpy(),
        np.asarray(jp["scan"][0]["ffn"]["router"][1]))


def test_remat_gives_the_same_loss_and_grads():
    """``remat=True`` recomputes each scanned layer in the backward pass
    (``torch.utils.checkpoint``): the same loss and gradients."""
    base = init_params(CFG, torch.Generator().manual_seed(4), "cpu")
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, CFG.vocab_size - 4, (2, 20), generator=g)
    t = torch.full((2, 1), 0.5)
    mask = torch.rand((2, 20), generator=g) < 0.5
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(CFG, remat=remat)
        leaves, td = tree.flatten(base)
        leaves = [p.clone().requires_grad_(True) for p in leaves]
        loss, m = loss_given_noise(cfg, tree.unflatten(td, leaves), toks,
                                   t, mask)
        out.append((loss, m["aux"], torch.autograd.grad(loss, leaves)))
    (l0, a0, g0), (l1, a1, g1) = out
    assert float(a0.detach()) > 0
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(a1, a0, rtol=1e-6, atol=1e-7)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def assert_leaves_equal(port_params, cfg, jtree):
    """Every leaf of the port's params, in the JAX package's layout and
    leaf order, equal to ``jtree``'s in dtype, shape and bits."""
    ours = tree.flatten(jax_layout(port_params, cfg))[0]
    leaves = jax.tree.leaves(jtree)
    assert len(leaves) == len(ours)
    for a, t in zip(leaves, ours):
        assert a.dtype == jnp.dtype(str(t.dtype).split(".")[-1])
        assert a.shape == tuple(t.shape)
        np.testing.assert_array_equal(np.asarray(jnp.asarray(a, jnp.float32)),
                                      t.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_moe_checkpoint_reads_into_the_port(tmp_path, dtype):
    """A JAX checkpoint of tiny-moe read into the port: every leaf equal
    bit for bit, the router float32 in a bf16 model too."""
    cj = jget_config("tiny-moe", param_dtype=dtype)
    ct = get_config("tiny-moe", param_dtype=dtype)
    jp = jax.jit(jinit_params, static_argnums=0)(cj, jax.random.PRNGKey(1))
    jcheckpoint.save(str(tmp_path / "jax"), jp)
    like = init_params(ct, torch.Generator().manual_seed(0), "cpu")
    back = checkpoint.restore(str(tmp_path / "jax"), like, ct)
    assert back["layers"][0]["ffn"]["router"].dtype == torch.float32
    assert_leaves_equal(back, ct, jp)


def test_port_moe_checkpoint_reads_into_jax(tmp_path):
    """The port's tiny-moe checkpoint read by the JAX package's
    ``restore``, every leaf equal bit for bit (float32: that ``restore``
    reads no bfloat16 leaf, its own or the port's)."""
    cj, ct = jget_config("tiny-moe"), get_config("tiny-moe")
    jp = jax.jit(jinit_params, static_argnums=0)(cj, jax.random.PRNGKey(1))
    ours = init_params(ct, torch.Generator().manual_seed(2), "cpu")
    checkpoint.save(str(tmp_path / "port"), ours, ct)
    assert_leaves_equal(ours, ct, jcheckpoint.restore(str(tmp_path / "port"),
                                                      jp))
