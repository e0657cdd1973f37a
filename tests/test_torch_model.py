"""The port's layers, model, bridge and schedule against the JAX package
on the same numpy inputs and JAX-initialised weights carried across by
``repro_torch.bridge``. Op-level tolerance 2e-5 (float32); model logits
atol/rtol 1e-4, because several layers of float32 matmuls sum in a
different order in the two frameworks."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as jsched
from repro.models import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models.model import apply_model as japply_model
from repro.models.model import init_cache as jinit_cache
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.core import schedule as sched
from repro_torch.models import layers
from repro_torch.models.config import get_config
from repro_torch.models.model import (apply_model, cache_take_rows,
                                      init_cache, init_params, params_to)

# tiny shapes: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

RNG = np.random.default_rng(0)


def _np(x):
    return np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------ layers

def test_rms_norm():
    x = RNG.standard_normal((2, 5, 64), np.float32)
    w = RNG.standard_normal((64,), np.float32) * 0.1
    _close(layers.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 2e-5)


def test_apply_rope():
    x = RNG.standard_normal((2, 7, 3, 32), np.float32)
    pos = np.array([[0, 1, 2, 3, 40, 41, 99], [5, 6, 7, 8, 9, 10, 300]],
                   np.int32)
    _close(layers.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
           2e-5)


@pytest.mark.parametrize("window", [0, 6])
def test_attend_ref_with_fully_masked_row(window):
    """attend_ref keeps the JAX reference's uniform average on a row with
    no valid key (the kernel route gives zeros)."""
    q = RNG.standard_normal((2, 9, 4, 16), np.float32)
    k = RNG.standard_normal((2, 20, 2, 16), np.float32)
    v = RNG.standard_normal((2, 20, 2, 16), np.float32)
    qp = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    kp = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    km = RNG.random((2, 20)) < 0.6
    km[1] = False
    kw = dict(scale=0.25, attn_softcap=0.0, window=window)
    got = layers.attend_ref(*map(torch.tensor, (q, k, v)),
                            q_pos=torch.tensor(qp), kv_pos=torch.tensor(kp),
                            kv_mask=torch.tensor(km), **kw)
    want = jlayers.attend_ref(*map(jnp.asarray, (q, k, v)),
                              q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp),
                              kv_mask=jnp.asarray(km), **kw)
    _close(got, want, 2e-5)
    assert got[1].abs().sum() > 0


def test_attend_ref_query_chunking(monkeypatch):
    """Past the score budget both sides chunk the query axis."""
    monkeypatch.setattr(layers, "SCORE_BUDGET", 64 * 40)
    monkeypatch.setattr(jlayers, "_SCORE_BUDGET", 64 * 40)
    q = RNG.standard_normal((1, 300, 2, 8), np.float32)
    k = RNG.standard_normal((1, 40, 2, 8), np.float32)
    v = RNG.standard_normal((1, 40, 2, 8), np.float32)
    got = layers.attend_ref(*map(torch.tensor, (q, k, v)), scale=0.3,
                            kv_valid=torch.tensor([33]))
    want = jlayers.attend_ref(*map(jnp.asarray, (q, k, v)), scale=0.3,
                              kv_valid=jnp.asarray([33]))
    _close(got, want, 2e-5)


def _model_pair(arch):
    """(JAX config, port config, JAX params, bridged port params)."""
    cj = jget_config(arch)
    jp = jax.jit(jinit_params, static_argnums=0)(cj, jax.random.PRNGKey(3))
    return cj, get_config(arch), jp, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


MODELS = {a: _model_pair(a) for a in ("tiny", "llada-8b-smoke")}
CFG_J, CFG_T, JP, TP = MODELS["tiny"]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("valid_kind", ["none", "length", "mask"])
def test_apply_attention_with_cache(valid_kind, use_kernels):
    B, S, P = 2, 6, 12
    jp, tp = JP["scan"][0]["mixer"], TP["layers"][1]["mixer"]
    jp = jax.tree.map(lambda a: a[1], jp)
    x = RNG.standard_normal((B, S, CFG_T.d_model), np.float32)
    ck = RNG.standard_normal((B, P, CFG_T.n_kv_heads, CFG_T.head_dim),
                             np.float32)
    cv = RNG.standard_normal(ck.shape, np.float32)
    qp = np.tile(np.arange(20, 20 + S, dtype=np.int32), (B, 1))
    kvp = np.concatenate([np.tile(np.arange(P, dtype=np.int32), (B, 1)), qp],
                         1)
    kv_valid = {"none": None, "length": np.array([5, 12], np.int32),
                "mask": RNG.random((B, P)) < 0.5}[valid_kind]
    jkw = dict(q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kvp),
               kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
               kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    tkw = dict(q_pos=torch.tensor(qp), kv_pos=torch.tensor(kvp),
               kv_cache=(torch.tensor(ck), torch.tensor(cv)),
               kv_valid=None if kv_valid is None else torch.tensor(kv_valid))
    want, (wk, wv) = jlayers.apply_attention(
        CFG_J, jp, jnp.asarray(x), return_kv=True, **jkw)
    got, (gk, gv) = layers.apply_attention(
        CFG_T, tp, torch.tensor(x), return_kv=True, use_kernels=use_kernels,
        **tkw)
    _close(got, want, 1e-4)
    _close(gk, wk, 1e-4)
    _close(gv, wv, 1e-4)


def test_apply_attention_bf16_kernel_route_matches_jax():
    """bf16 weights and activations on the kernel route: the wrapper's
    fused bf16 output (``out_dtype=q.dtype``) gives what the JAX path's
    ``.astype(q.dtype)`` gives, at the bf16 tolerance 2e-2."""
    B, S, P = 2, 6, 12
    bf = torch.bfloat16
    jp = jax.tree.map(lambda a: a[1].astype(jnp.bfloat16),
                      JP["scan"][0]["mixer"])
    tp = {k: w.to(bf) for k, w in TP["layers"][1]["mixer"].items()}
    x = RNG.standard_normal((B, S, CFG_T.d_model), np.float32)
    ck = RNG.standard_normal((B, P, CFG_T.n_kv_heads, CFG_T.head_dim),
                             np.float32)
    cv = RNG.standard_normal(ck.shape, np.float32)
    qp = np.tile(np.arange(20, 20 + S, dtype=np.int32), (B, 1))
    kvp = np.concatenate([np.tile(np.arange(P, dtype=np.int32), (B, 1)), qp],
                         1)
    kv_valid = np.array([5, 12], np.int32)
    want = jlayers.apply_attention(
        CFG_J, jp, jnp.asarray(x, jnp.bfloat16), q_pos=jnp.asarray(qp),
        kv_pos=jnp.asarray(kvp), kv_valid=jnp.asarray(kv_valid),
        kv_cache=(jnp.asarray(ck, jnp.bfloat16),
                  jnp.asarray(cv, jnp.bfloat16)), use_kernels=True)
    got = layers.apply_attention(
        CFG_T, tp, torch.tensor(x).to(bf), q_pos=torch.tensor(qp),
        kv_pos=torch.tensor(kvp), kv_valid=torch.tensor(kv_valid),
        kv_cache=(torch.tensor(ck).to(bf), torch.tensor(cv).to(bf)),
        use_kernels=True)
    assert got.dtype == bf
    _close(got.float(), np.asarray(want, np.float32), 2e-2)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_apply_ffn(kind):
    d, f = 32, 48
    p = {n: RNG.standard_normal(s, np.float32) / 6 for n, s in
         [("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d))]}
    x = RNG.standard_normal((3, 5, d), np.float32)
    _close(layers.apply_ffn({k: torch.tensor(v) for k, v in p.items()},
                            torch.tensor(x), kind),
           jlayers.apply_ffn({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind), 2e-5)


# ------------------------------------------------------------ model

def _caches_close(tcache, jcache, tol=1e-4):
    want = cache_from_jax(jcache, "cpu")
    assert len(tcache) == len(want)
    for (tk, tv), (wk, wv) in zip(tcache, want):
        np.testing.assert_allclose(tk.numpy(), wk.numpy(), atol=tol, rtol=tol)
        np.testing.assert_allclose(tv.numpy(), wv.numpy(), atol=tol, rtol=tol)


B_, S_, T_, SQ_ = 2, 10, 24, 5
MODE_TOKS = RNG.integers(0, 1024, (B_, S_)).astype(np.int32)
MODE_POS = np.tile(np.arange(S_, dtype=np.int32), (B_, 1))
MODE_QTOKS = RNG.integers(0, 1024, (B_, SQ_)).astype(np.int32)
MODE_QPOS = np.tile(np.array([10, 11, 12, 20, 23], np.int32), (B_, 1))
MODE_VALID = np.array([S_, 7], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_modes(arch):
    """The JAX side of ``test_apply_model_modes``, once per arch: logits
    and caches (numpy) of encode, encode with a cache, step, and append
    at kv_valid offsets / at explicit slots."""
    cj, _, jp, _ = MODELS[arch]
    toks = jnp.asarray(MODE_TOKS % cj.vocab_size)
    pos = jnp.asarray(MODE_POS)
    out = {"encode": japply_model(cj, jp, tokens=toks, positions=pos)}
    out["refresh"] = japply_model(cj, jp, tokens=toks, positions=pos,
                                  cache=jinit_cache(cj, B_, T_), cache_upto=6)
    cache = out["refresh"].cache
    common = dict(tokens=jnp.asarray(MODE_QTOKS % cj.vocab_size),
                  positions=jnp.asarray(MODE_QPOS),
                  kv_valid=jnp.asarray(MODE_VALID))
    out["step"] = japply_model(cj, jp, mode="step", cache=cache, **common)
    for name, at in (("append", None), ("append_at", jnp.asarray(MODE_QPOS))):
        out[name] = japply_model(cj, jp, mode="append", cache=cache,
                                 skip_head=True, append_at=at, **common)
    return {k: (np.asarray(o.logits),
                None if o.cache is None else jax.tree.map(np.asarray, o.cache),
                np.asarray(o.kv_valid)) for k, o in out.items()}


@pytest.mark.parametrize("arch", sorted(MODELS))
@pytest.mark.parametrize("use_kernels", [False, True])
def test_apply_model_modes(arch, use_kernels):
    """encode (no cache, then refreshing a cache), step and append (at
    kv_valid offsets and at explicit slots) — logits and caches."""
    cj, ct, _, tp = MODELS[arch]
    want = _jax_modes(arch)

    def run(**kw):
        return apply_model(ct, tp, use_kernels=use_kernels, **kw)

    toks = torch.tensor(MODE_TOKS % cj.vocab_size)
    pos = torch.tensor(MODE_POS)
    out = run(tokens=toks, positions=pos)
    _close(out.logits, want["encode"][0], 1e-4)

    tc = init_cache(ct, B_, T_, "cpu")
    out = run(tokens=toks, positions=pos, cache=tc, cache_upto=6)
    _close(out.logits, want["refresh"][0], 1e-4)
    _caches_close(out.cache, want["refresh"][1])
    assert out.kv_valid.tolist() == want["refresh"][2].tolist()

    common = dict(tokens=torch.tensor(MODE_QTOKS % cj.vocab_size),
                  positions=torch.tensor(MODE_QPOS),
                  kv_valid=torch.tensor(MODE_VALID))
    out = run(mode="step", cache=tc, **common)
    _close(out.logits, want["step"][0], 1e-4)
    assert out.cache is None

    for name, at in (("append", None), ("append_at", MODE_QPOS)):
        tc2 = [(k.clone(), v.clone()) for k, v in tc]
        out = run(mode="append", cache=tc2, skip_head=True,
                  append_at=None if at is None else torch.tensor(at),
                  **common)
        _close(out.logits, want[name][0], 1e-4)
        _caches_close(out.cache, want[name][1])
        assert out.kv_valid.tolist() == want[name][2].tolist()


def test_write_kv_clamps_like_dynamic_update_slice():
    """An append whose offset runs past the buffer lands at P - S, as the
    JAX package's ``dynamic_update_slice`` clamps it."""
    cj, ct, jp, tp = MODELS["tiny"]
    B, T = 1, 8
    toks = np.array([[3, 4, 5]], np.int32)
    pos = np.array([[6, 7, 8]], np.int32)
    kw = dict(mode="append", kv_valid=np.array([7], np.int32))
    out_j = japply_model(cj, jp, tokens=jnp.asarray(toks),
                         positions=jnp.asarray(pos), cache=jinit_cache(
                             cj, B, T), kv_valid=jnp.asarray(kw["kv_valid"]),
                         mode="append")
    out_t = apply_model(ct, tp, tokens=torch.tensor(toks),
                        positions=torch.tensor(pos),
                        cache=init_cache(ct, B, T, "cpu"),
                        kv_valid=torch.tensor(kw["kv_valid"]), mode="append")
    _caches_close(out_t.cache, jax.tree.map(np.asarray, out_j.cache))
    assert out_t.cache[0][0][0, 5:].abs().sum() > 0


def test_bridge_unstacks_scan_groups():
    cj, ct, jp, tp = MODELS["tiny"]
    assert len(tp["layers"]) == cj.n_layers
    for r in range(cj.reps):
        np.testing.assert_array_equal(
            tp["layers"][r]["ffn"]["w_up"].numpy(),
            np.asarray(jp["scan"][0]["ffn"]["w_up"][r]))
    bf = params_from_jax(jax.tree.map(np.asarray, jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), jp)), "cpu")
    assert bf["embed"].dtype == torch.bfloat16


def test_init_params_and_cache_shapes():
    cfg = get_config("llada-8b-smoke")
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p["layers"][0]["mixer"]["wq"].shape == (cfg.d_model, cfg.n_heads,
                                                   cfg.head_dim)
    assert p["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["embed"], again["embed"])
    c = init_cache(cfg, 3, 20, "cpu")
    assert len(c) == cfg.n_layers
    assert c[0][0].shape == (3, 20, cfg.n_kv_heads, cfg.head_dim)
    sub = cache_take_rows(c, [2, 0])
    assert sub[0][0].shape[0] == 2
    assert params_to(p, "cpu")["embed"].device.type == "cpu"


def test_recurrent_layers_not_ported():
    from repro_torch.models.config import LayerSpec
    cfg = dataclasses.replace(get_config("tiny"),
                              pattern=(LayerSpec("mlstm", "none"),))
    with pytest.raises(NotImplementedError, match="A13"):
        init_params(cfg, torch.Generator(), "cpu")


# ------------------------------------------------------------ schedule

def test_confidence_and_tokens():
    x = RNG.standard_normal((3, 4, 50), np.float32) * 3
    x[0, 0, [7, 9]] = 20.0                   # tie: the first index wins
    c, t = sched.confidence_and_tokens(torch.tensor(x))
    cj, tj = jsched.confidence_and_tokens(jnp.asarray(x))
    _close(c, cj, 1e-6)
    assert t.tolist() == _np(tj).tolist() and t[0, 0] == 7


def test_dynamic_threshold_float32():
    r = np.array([1.0, 0.5, 0.125, 0.0], np.float32)
    got = sched.dynamic_threshold(0.9, 0.3, torch.tensor(r))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), _np(jsched.dynamic_threshold(0.9, 0.3, jnp.asarray(r))))


@pytest.mark.parametrize("tau", [0.5, "rows"])
def test_select_tokens(tau):
    conf = RNG.random((4, 8)).astype(np.float32)
    conf[3] = 0.2                            # all equal: fallback takes first
    masked = RNG.random((4, 8)) < 0.7
    masked[2] = False                        # nothing masked: no commit
    masked[3] = True
    t = np.array([0.6, 0.9, 0.5, 0.95], np.float32) if tau == "rows" else tau
    got = sched.select_tokens(torch.tensor(conf), torch.tensor(masked),
                              torch.tensor(t) if tau == "rows" else t)
    want = jsched.select_tokens(jnp.asarray(conf), jnp.asarray(masked),
                                jnp.asarray(t) if tau == "rows" else t)
    assert got.tolist() == _np(want).tolist()
    assert not got[2].any() and got[3].tolist() == [True] + [False] * 7


@pytest.mark.parametrize("n_commit", [1, 2, 3])
def test_fixed_rate_select_with_ties(n_commit):
    conf = np.array([[0.5, 0.5, 0.5, 0.1, 0.5, 0.9],
                     [0.2, 0.2, 0.2, 0.2, 0.2, 0.2],
                     [0.7, 0.3, 0.7, 0.3, 0.7, 0.3]], np.float32)
    masked = np.array([[1, 1, 0, 1, 1, 1], [0, 1, 1, 1, 0, 1],
                       [1, 1, 1, 1, 1, 1]], bool)
    got = sched.fixed_rate_select(torch.tensor(conf), torch.tensor(masked),
                                  n_commit)
    want = jsched.fixed_rate_select(jnp.asarray(conf), jnp.asarray(masked),
                                    n_commit)
    assert got.tolist() == _np(want).tolist()


def test_head_confidence_and_tokens_row_chunks():
    h = RNG.standard_normal((2, 5, 16), np.float32)
    head = RNG.standard_normal((16, 40), np.float32)
    kw = dict(mask_id=39, logit_softcap=10.0, row_chunk=3)
    c, t = sched.head_confidence_and_tokens(torch.tensor(h),
                                            torch.tensor(head), **kw)
    cj, tj = jsched.head_confidence_and_tokens(jnp.asarray(h),
                                               jnp.asarray(head), **kw)
    _close(c, cj, 1e-5)
    assert t.tolist() == _np(tj).tolist()


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel_route"])
@pytest.mark.parametrize("mode", ["encode", "step", "append", "dkv"])
def test_per_pass_inputs_are_bit_identical_to_per_layer(mode, use_kernels):
    """``apply_model`` builds the RoPE table, the key positions and the
    key validity once per pass; layer by layer, ``apply_layer`` without
    them builds each itself. Same logits and cache, bit for bit."""
    from repro_torch.models.model import apply_layer
    from repro_torch.models.layers import rms_norm
    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    B, S, T = 2, 9, 30
    g = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    pos = (torch.arange(S, dtype=torch.int32) + 12)[None].expand(B, S)
    base = init_cache(cfg, B, T, "cpu")
    for k, v in base:
        k.normal_(generator=g)
        v.normal_(generator=g)
    kw = dict(mode=mode, kv_valid=torch.tensor([7, 12], dtype=torch.int32))
    if mode == "encode":
        kw = dict(mode="encode")
    elif mode == "dkv":
        valid = torch.rand((B, T), generator=g) < 0.5
        kw = dict(mode="append", kv_valid=valid, append_at=pos,
                  self_kv_mix=torch.rand((B, S), generator=g) < 0.5)
    caches = [[(k.clone(), v.clone()) for k, v in base] for _ in range(2)]
    out = apply_model(cfg, params, tokens=toks, positions=pos,
                      cache=caches[0], use_kernels=use_kernels, **kw)
    x = params["embed"][toks.long()]
    kv_valid = kw.get("kv_valid", torch.zeros((B,), dtype=torch.int32))
    for i, spec in enumerate(cfg.effective_layout()):
        x, _ = apply_layer(cfg, params["layers"][i], spec, x, q_pos=pos,
                           cache=caches[1][i], kv_valid=kv_valid,
                           mode=kw["mode"], append_at=kw.get("append_at"),
                           self_kv_mix=kw.get("self_kv_mix"),
                           use_kernels=use_kernels)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    assert torch.equal(out.logits, (x @ head.to(x.dtype)).float())
    for (a, b), (c, d) in zip(*caches):
        assert torch.equal(a, c) and torch.equal(b, d)
