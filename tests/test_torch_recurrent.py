"""The port's recurrent mixers (``repro_torch.models.recurrent``: RG-LRU,
mLSTM, sLSTM) against the JAX package's on the CPU, on the same weights:
``causal_conv1d``, each mixer with and without ``state=`` /
``return_state=`` in float32 (2e-5) and bfloat16 (2e-2 of the largest
value), both RG-LRU scan forms; the plain scans (``kernels.ref``) as the
CPU route of ``ops.*_scan`` and against a float64 run; the serving
layout (concatenated and, in bfloat16, zero-padded weights) bit-equal to
the reference's separate products, built once per weight tensor, and
every bfloat16 product of a pass with K and N multiples of 8; the
recurrent cache's leaves through ``cache_take_rows`` / ``cache_map``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import get_config as jget_config
from repro.models import recurrent as jrec
from repro_torch.bridge import to_tensor
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as layers_mod
from repro_torch.models import model as model_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.config import get_config
from repro_torch.models.model import (apply_model, cache_map,
                                      cache_take_rows, init_cache,
                                      init_params)

torch.set_num_threads(1)

TOL = 2e-5
BF16_TOL = 2e-2
MIXERS = [("rglru", "recurrentgemma-9b-smoke"), ("mlstm", "xlstm-350m-smoke"),
          ("slstm", "xlstm-350m-smoke")]
JAX_MIXER = {"rglru": (jrec.init_rglru, jrec.apply_rglru),
             "mlstm": (jrec.init_mlstm, jrec.apply_mlstm),
             "slstm": (jrec.init_slstm, jrec.apply_slstm)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def mixer_pair(kind, name, dtype, **over):
    """(JAX config, port config, JAX params, the same params as tensors)."""
    over = dict(over, dtype=dtype, param_dtype=dtype)
    cj, ct = jget_config(name, **over), get_config(name, **over)
    jp = JAX_MIXER[kind][0](jax.random.PRNGKey(3), cj, JDT[dtype])
    return cj, ct, jp, {k: to_tensor(np.asarray(v), "cpu")
                        for k, v in jp.items()}


def inputs(cfg, B, S, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.tensor(x).to(TDT[dtype])


def f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * max(
            np.abs(want).max(), 1e-6)


# ------------------------------------------------------------ conv, mixers

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32) \
        if with_state else None
    want, wst = jrec.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st))
    got, gst = rec.causal_conv1d(torch.tensor(x), torch.tensor(w),
                                 None if st is None else torch.tensor(st))
    np.testing.assert_allclose(got.numpy(), f32(want), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(gst.numpy(), f32(wst))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,name", MIXERS)
def test_mixer_matches_jax_with_and_without_state(kind, name, dtype):
    """No state: one scan from the zero state, as JAX's. ``return_state``
    after a first segment, then ``state=`` for the second: both outputs
    and every leaf of both states match JAX's, and the two segments equal
    the one scan over both (the block refresh's split)."""
    cj, ct, jp, tp = mixer_pair(kind, name, dtype)
    jx, tx = inputs(cj, 2, 14, dtype, seed=2)
    apply_j, apply_t = JAX_MIXER[kind][1], rec.APPLY[kind]
    wy1, wst = apply_j(cj, jp, jx[:, :9], return_state=True)
    wy2, wst2 = apply_j(cj, jp, jx[:, 9:], state=wst, return_state=True)
    gy1, gst = apply_t(ct, tp, tx[:, :9], return_state=True)
    gy2, gst2 = apply_t(ct, tp, tx[:, 9:], state=gst, return_state=True)
    assert type(gst).__name__ == type(wst).__name__
    assert gst._fields == wst._fields
    for got, want in [(gy1, wy1), (gy2, wy2), *zip(gst, wst),
                      *zip(gst2, wst2)]:
        close(got, want, dtype)
    whole = apply_t(ct, tp, tx)
    assert whole.dtype == TDT[dtype]
    close(whole, apply_j(cj, jp, jx), dtype)
    close(torch.cat([gy1, gy2], dim=1), whole.float().numpy(), dtype)


@pytest.mark.parametrize("remat", [False, True], ids=["assoc", "sequential"])
def test_rglru_both_scan_forms_match_jax(remat):
    """``cfg.remat`` picks the sequential scan, else the associative one,
    in both packages; each matches its JAX counterpart, and the two forms
    agree to float32 rounding."""
    cj, ct, jp, tp = mixer_pair("rglru", "recurrentgemma-9b-smoke",
                                "float32", remat=remat)
    jx, tx = inputs(cj, 2, 33, "float32", seed=3)
    st = rec.rglru_state(ct, 2, torch.float32, "cpu")
    st = st._replace(h=torch.randn((2, ct.lru_width),
                                   generator=torch.Generator().manual_seed(4)))
    jst = jrec.RGLRUState(jnp.asarray(st.h.numpy()),
                          jnp.asarray(st.conv.numpy()))
    want, wst = jrec.apply_rglru(cj, jp, jx, state=jst, return_state=True)
    got, gst = rec.apply_rglru(ct, tp, tx, state=st, return_state=True)
    close(got, want, "float32")
    close(gst.h, wst.h, "float32")
    g = torch.Generator().manual_seed(5)
    a = torch.rand((2, 33, 16), generator=g)
    b = torch.randn((2, 33, 16), generator=g)
    h0 = torch.randn((2, 16), generator=g)
    hs_a, hT_a = ref.linear_scan(a, b, h0, assoc=True)
    hs_s, hT_s = ref.linear_scan(a, b, h0, assoc=False)
    np.testing.assert_allclose(hs_a.numpy(), hs_s.numpy(), atol=1e-6,
                               rtol=1e-6)
    assert torch.equal(hT_a, hs_a[:, -1]) and torch.equal(hT_s, hs_s[:, -1])


# ------------------------------------------------------------ plain scans

def _scan_args(kind, dtype=torch.float32, B=2, S=24, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g)

    if kind == "rglru":
        w = 32
        return (rn(B, S, 2 * w), rn(B, S, w).to(dtype),
                torch.rand((w,), generator=g) * 0.5 + 0.4, rn(B, w)), {}
    if kind == "mlstm":
        H, dk, dv = 2, 8, 16
        proj = rn(B, S, 2 * H * dk + H * dv + 2 * H + 4).to(dtype)
        return (proj, rn(B, H, dk, dv), rn(B, H, dk), rn(B, H)), \
            dict(H=H, dk=dk, dv=dv)
    H, hd = 2, 8
    d = H * hd
    return (rn(B, S, 4 * d).to(dtype), rn(4, H, hd, hd) / hd ** 0.5,
            rn(B, d), rn(B, d), rn(B, d).abs() + 1, rn(B, d)), {}


PLAIN = {"rglru": ref.rglru_scan_ref, "mlstm": ref.mlstm_scan_ref,
         "slstm": ref.slstm_scan_ref}
OPS = {"rglru": ops.rglru_scan, "mlstm": ops.mlstm_scan,
       "slstm": ops.slstm_scan}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_cpu_scan_wrappers_are_the_plain_versions(kind, dtype):
    """On CPU tensors ``ops.*_scan`` is the plain scan, bit for bit, its
    per-step output cast to ``out_dtype`` (the activations' by default),
    and no launch is counted."""
    args, kw = _scan_args(kind, dtype)
    before = dict(ops.LAUNCHES)
    got = OPS[kind](*args, **kw)
    want = PLAIN[kind](*args, **kw)
    assert got[0].dtype == dtype
    assert torch.equal(got[0], want[0].to(dtype))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    wide = OPS[kind](*args, out_dtype=torch.float32, **kw)
    assert torch.equal(wide[0], want[0])
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_plain_scans_hold_float32_against_float64(kind):
    """The float32 plain scans over 96 steps against the same scans in
    float64: the rounding that a scan compounds stays near float32's own
    (the scale the card's kernel cases are held to)."""
    args, kw = _scan_args(kind, S=96, seed=1)
    got = PLAIN[kind](*args, **kw)
    want = PLAIN[kind](*args, acc=torch.float64, **kw)
    assert want[0].dtype == torch.float64
    for g, w in zip(got, want):
        err = (g.double() - w).abs().max() / w.abs().max()
        assert err <= 1e-5, (kind, float(err))


# ------------------------------------------------------------ serving layout

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,name", MIXERS)
def test_served_products_equal_the_reference_products(kind, name, dtype):
    """Each column of a concatenated (and, in bfloat16, zero-padded)
    product equals the reference's own product bit for bit on the plain
    route (``ops.linear``): K fixes a column's sum, and the padded
    columns are exact zeros (gelu(0) = 0 meets zero rows in the sLSTM's
    FFN)."""
    _, ct, _, p = mixer_pair(kind, name, dtype)
    lw = rec.mixer_weights(kind, p)
    x = torch.randn((2, 7, ct.d_model),
                    generator=torch.Generator().manual_seed(6)).to(TDT[dtype])
    lin = ops.linear
    if kind == "rglru":
        w = p["w_in"].shape[1]
        y = lin(x, lw["w_in_gate"])
        assert torch.equal(y[..., :w], lin(x, p["w_in"]))
        assert torch.equal(y[..., w:], lin(x, p["w_gate"]))
        u = y[..., :w].float()
        gx = lin(u, lw["w_ax"])
        assert lw["w_ax"].dtype == torch.float32
        assert torch.equal(gx[..., :w], lin(u, p["w_a"].float()))
        assert torch.equal(gx[..., w:], lin(u, p["w_x"].float()))
    elif kind == "mlstm":
        di, H, dk = p["wq"].shape
        dv = p["wv"].shape[2]
        y = lin(x, lw["w_up_z"])
        assert torch.equal(y[..., :di], lin(x, p["w_up"]))
        assert torch.equal(y[..., di:], lin(x, p["w_z"]))
        c = F.silu(y[..., :di])
        proj = lin(c, lw["w_proj"])
        parts = [p["wq"].reshape(di, H * dk), p["wk"].reshape(di, H * dk),
                 p["wv"].reshape(di, H * dv), p["w_i"], p["w_f"]]
        o = 0
        for part in parts:
            n = part.shape[1]
            assert torch.equal(proj[..., o:o + n], lin(c, part))
            o += n
        assert (proj[..., o:] == 0).all()
        assert proj.shape[-1] % (8 if dtype == "bfloat16" else 1) == 0
    else:
        d = ct.d_model
        y = lin(x, lw["w_gates"])
        for i, g in enumerate("zifo"):
            assert torch.equal(y[..., i * d:(i + 1) * d], lin(x, p[f"w_{g}"]))
        assert torch.equal(lw["r"], torch.stack(
            [p[f"r_{g}"] for g in "zifo"]).float())
        up = lin(x, lw["w_ffn_up"])
        f = p["w_ffn_up"].shape[1]
        assert torch.equal(up[..., :f], lin(x, p["w_ffn_up"]))
        assert (up[..., f:] == 0).all()
        h = F.gelu(up, approximate="tanh")
        assert torch.equal(lin(h, lw["w_ffn_down"]),
                           lin(h[..., :f], p["w_ffn_down"]))
        if dtype == "bfloat16":
            assert lw["w_ffn_up"].shape[1] % 8 == 0 and f % 8 != 0


def test_serving_layout_is_built_once_per_weight_tensor():
    """The serving route reads one layout per mixer until a weight is
    written in place (its version counter) or replaced; the training
    route builds it per call under autograd, so gradients reach the
    weights."""
    _, ct, _, p = mixer_pair("slstm", "xlstm-350m-smoke", "float32")
    first = rec.mixer_weights("slstm", p)
    assert rec.mixer_weights("slstm", p) is first
    p["r_f"].mul_(1.0)
    second = rec.mixer_weights("slstm", p)
    assert second is not first and torch.equal(second["r"], first["r"])
    p = dict(p, w_z=p["w_z"].clone())
    assert rec.mixer_weights("slstm", p) is not second
    leaf = p["w_o"].clone().requires_grad_(True)
    lw = rec.mixer_weights("slstm", dict(p, w_o=leaf), train=True)
    assert lw["w_gates"].requires_grad
    lw["w_gates"].sum().backward()
    assert torch.equal(leaf.grad, torch.ones_like(leaf))


@pytest.mark.parametrize("name", ["recurrentgemma-9b-smoke",
                                  "xlstm-350m-smoke"])
def test_every_bf16_product_is_aligned(monkeypatch, name):
    """A bfloat16 refresh (with the prefix split) and a step: every
    product of the pass reaches ``linear`` with K and N multiples of 8,
    as the card's GEMM takes them, and the only float32 products are
    RG-LRU's ``u @ [w_a | w_x]``."""
    cfg = get_config(name, dtype="bfloat16", param_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    lin = ops.linear

    def recording(x, w, **kw):
        calls.append((x.dtype, w.dtype, *w.shape))
        return lin(x, w, **kw)

    for mod in (rec, layers_mod, model_mod):
        monkeypatch.setattr(mod, "linear", recording)
    toks = torch.randint(0, 1000, (2, 20))
    cache = init_cache(cfg, 2, 20, "cpu")
    apply_model(cfg, params, tokens=toks, cache=cache, cache_upto=12)
    qpos = torch.arange(12, 20, dtype=torch.int32)[None].expand(2, 8)
    apply_model(cfg, params, tokens=toks[:, 12:], positions=qpos,
                mode="step", cache=cache,
                kv_valid=torch.full((2,), 12, dtype=torch.int32))
    assert calls
    for xd, wd, K, N in calls:
        assert xd == wd
        if wd == torch.bfloat16:
            assert K % 8 == 0 and N % 8 == 0, (K, N)
        else:
            assert (K, N) == (cfg.lru_width, 2 * cfg.lru_width)


@pytest.mark.parametrize("name,per_layer", [
    ("recurrentgemma-9b-smoke", {"rglru": 6, "attn_local": 7}),
    ("xlstm-350m-smoke", {"mlstm": 3, "slstm": 3})])
def test_one_pass_calls_linear_for_each_product(monkeypatch, name,
                                                per_layer):
    """A step calls ``linear`` 3 times per recurrent mixer (RG-LRU: w_in
    | w_gate, the float32 w_a | w_x, w_out; mLSTM: w_up | w_z, the fused
    projection, w_down; sLSTM: the four gates, the FFN's up and down),
    plus its FFN's, 7 per attention layer with SwiGLU, and the head; a
    refresh split at the prefix runs each recurrent mixer's twice."""
    cfg = get_config(name)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    lin = ops.linear

    def counting(x, w, **kw):
        calls.append(1)
        return lin(x, w, **kw)

    for mod in (rec, layers_mod, model_mod):
        monkeypatch.setattr(mod, "linear", counting)
    toks = torch.randint(0, 1000, (2, 16))
    cache = init_cache(cfg, 2, 16, "cpu")
    step = sum(per_layer[s.mixer] for s in cfg.layout) + 1
    mixers = sum(3 for s in cfg.layout if s.mixer in rec.APPLY)
    apply_model(cfg, params, tokens=toks, cache=cache, cache_upto=10)
    assert len(calls) == step + mixers
    calls.clear()
    qpos = torch.arange(10, 16, dtype=torch.int32)[None].expand(2, 6)
    apply_model(cfg, params, tokens=toks[:, 10:], positions=qpos,
                mode="step", cache=cache,
                kv_valid=torch.full((2,), 10, dtype=torch.int32))
    assert len(calls) == step


# ------------------------------------------------------------ caches

def test_recurrent_cache_leaves_take_and_merge_rows():
    """``init_cache`` gives each recurrent layer its state with a buffer
    per leaf (written in place), attention layers their (k, v); rows are
    gathered and concatenated leaf by leaf, keeping each layer's type."""
    cfg = get_config("recurrentgemma-9b-smoke")
    cache = init_cache(cfg, 3, 10, "cpu")
    kinds = [type(c).__name__ for c in cache]
    assert kinds == ["RGLRUState", "RGLRUState", "tuple"]
    ptrs = [t.data_ptr() for c in cache for t in c]
    assert len(set(ptrs)) == len(ptrs)
    x = get_config("xlstm-350m-smoke")
    xc = init_cache(x, 3, 10, "cpu")
    assert [type(c).__name__ for c in xc] == ["MLSTMState", "SLSTMState"]
    assert bool((xc[0].m == -1e30).all()) and bool((xc[1].m == -1e30).all())
    for c in (cache, xc):
        for layer in c:
            for t in layer:
                t.copy_(torch.randn(t.shape).to(t.dtype))
        sub = cache_take_rows(c, [2, 0])
        assert [type(a) for a in sub] == [type(a) for a in c]
        for a, b in zip(sub, c):
            for ta, tb in zip(a, b):
                assert torch.equal(ta, tb[[2, 0]])
        merged = cache_map(lambda *ts: torch.cat(ts), sub,
                           cache_take_rows(c, [1]))
        for a, b in zip(merged, c):
            for ta, tb in zip(a, b):
                assert torch.equal(ta, tb[[2, 0, 1]])


def test_refresh_writes_the_prefix_state_in_place():
    """A refresh (encode with ``cache_upto``) writes the state at the
    prefix boundary into the cache's own buffers, so a captured graph
    reads it: the same tensors, holding the first segment's state."""
    cfg = get_config("xlstm-350m-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    cache = init_cache(cfg, 2, 16, "cpu")
    ptrs = [t.data_ptr() for c in cache for t in c]
    toks = torch.randint(0, 1000, (2, 16))
    out = apply_model(cfg, params, tokens=toks, cache=cache, cache_upto=11)
    assert out.cache is cache
    assert [t.data_ptr() for c in cache for t in c] == ptrs
    prefix = init_cache(cfg, 2, 16, "cpu")
    apply_model(cfg, params, tokens=toks[:, :11], cache=prefix)
    for a, b in zip(cache, prefix):
        for ta, tb in zip(a, b):
            assert torch.equal(ta, tb)
    before = [t.clone() for c in cache for t in c]
    apply_model(cfg, params, tokens=toks[:, 11:], mode="step", cache=cache,
                positions=torch.arange(11, 16)[None].expand(2, 5))
    assert all(torch.equal(a, t) for a, t in
               zip(before, [t for c in cache for t in c]))


def test_recurrent_configs_equal_the_jax_ones():
    for name in ("recurrentgemma-9b", "recurrentgemma-9b-smoke",
                 "xlstm-350m", "xlstm-350m-smoke"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget_config(name))


# ------------------------------------------------------------- sLSTM plan

def test_slstm_plan_fits_every_config_with_an_slstm():
    """Every config with an sLSTM layer has a kernel plan for its head
    dim (the wrapper refuses none of them): a cluster of at most 8 CTAs
    (the portable size) of 32 channels each, holding the R columns of
    its channels (4 gates x hd x channels, float32) and the
    double-buffered h of 8 rows in the 232,448 bytes a CTA may use."""
    from repro_torch.kernels import recurrent as krec
    from repro_torch.models.config import SLSTM, list_configs
    seen = {}
    for name in list_configs():
        cfg = get_config(name)
        if not any(s.mixer == SLSTM for s in cfg.layout):
            continue
        hd = cfg.d_model // cfg.n_heads
        plan = krec.slstm_plan(hd)
        assert plan is not None, (name, hd)
        assert plan.cluster * plan.channels == hd and plan.cluster <= 8
        assert plan.threads == 4 * plan.channels and plan.threads % 32 == 0
        assert plan.smem_bytes == 4 * (4 * hd * plan.channels
                                       + 2 * plan.rows * hd) + 16
        assert plan.smem_bytes <= 232448
        seen[name] = (hd, plan.cluster)
    assert seen["xlstm-350m"] == (256, 8)
    assert seen["xlstm-350m-smoke"] == (64, 2)
    # the card test's refused head dim, and one past a cluster of 8
    assert krec.slstm_plan(48) is None and krec.slstm_plan(288) is None


def test_recurrent_cu_constants_match_the_slstm_plan():
    """Every ``constexpr int kSlstm*`` of csrc/recurrent.cu has the value
    ``recurrent.SLSTM`` gives it."""
    import pathlib
    import re
    from repro_torch.kernels import recurrent as krec
    src = (pathlib.Path(krec.__file__).parent / "csrc"
           / "recurrent.cu").read_text()
    found = {name: int(v) for name, v in
             re.findall(r"constexpr int (kSlstm\w+) = (\d+);", src)}
    assert found == krec.SLSTM


# ------------------------------------------------- mLSTM and RG-LRU plans

def _scan_widths(cfg):
    """(mLSTM (H, dk, dv) or None, RG-LRU width or None) of ``cfg``'s
    layout, as ``models.recurrent`` sizes them."""
    from repro_torch.models.config import MLSTM, RGLRU
    mixers = {s.mixer for s in cfg.layout}
    di, H = 2 * cfg.d_model, cfg.n_heads
    return ((H, di // H // 2, di // H) if MLSTM in mixers else None,
            (cfg.lru_width or cfg.d_model) if RGLRU in mixers else None)


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_scan_plans_fit_every_config_with_an_mlstm_or_rglru(B, elem_bytes):
    """Every config with an mLSTM or RG-LRU layer has a kernel plan at
    its widths (the mLSTM wrapper refuses none of them): chunks of 16
    steps (the RG-LRU's 32), the mLSTM's dynamic shared memory (a chunk's raw and widened
    inputs and each warp's partials) within the 232,448 bytes a CTA may
    use, the RG-LRU's ring (and a, b) as well, and more CTAs than the
    first kernels launched (B w / 256 for the RG-LRU)."""
    from repro_torch.kernels import recurrent as krec
    from repro_torch.models.config import list_configs
    seen = {}
    for name in list_configs():
        ml, w = _scan_widths(get_config(name))
        if ml is not None:
            H, dk, dv = ml
            plan = krec.mlstm_plan(B, H, dk, dv, elem_bytes)
            assert plan is not None, (name, ml)
            L, P = plan.chunk, plan.cols
            assert (L, P, plan.threads) == (16, 32, 256)
            assert plan.smem_bytes == L * (2 * dk + P) * elem_bytes \
                + 4 * L * (2 * (dk + 32) + P + 2 + 2 * 8 * P
                           + dk // 32 * 33 + 1)
            assert plan.smem_bytes <= 232448 and plan.smem_bytes % 16 == 0
            assert plan.ctas == dv // 32 * H * B
            seen[name, "mlstm"] = (dk, dv, plan.ctas)
        if w is not None:
            plan = krec.rglru_plan(B, w, elem_bytes)
            assert (plan.chunk, plan.stages, plan.channels,
                    plan.threads) == (32, 3, 32, 512)
            assert plan.smem_bytes == 3 * 32 * 32 * (8 + elem_bytes) \
                + 2 * 2 * 32 * 32 * 4 + 4 * 32
            assert plan.smem_bytes <= 232448
            assert plan.ctas == -(-w // 32) * B > B * w / 256
            seen[name, "rglru"] = (w, plan.ctas)
    assert seen["xlstm-350m", "mlstm"] == (256, 512, 64 * B)
    assert seen["xlstm-350m-smoke", "mlstm"][:2] == (64, 128)
    assert seen["recurrentgemma-9b", "rglru"] == (4096, 128 * B)
    assert ("recurrentgemma-9b-smoke", "rglru") in seen
    # the dk and dv the card test's refusal uses, and a ragged dv
    assert krec.mlstm_plan(B, 2, 32, 128, elem_bytes) is None
    assert krec.mlstm_plan(B, 2, 64, 48, elem_bytes) is None


@pytest.mark.parametrize("prefix", ["kRglru", "kMlstm"])
def test_recurrent_cu_constants_match_the_scan_plans(prefix):
    """Every ``constexpr int kRglru*`` / ``kMlstm*`` of csrc/recurrent.cu
    given as a number has the value ``recurrent.RGLRU`` / ``MLSTM`` gives
    it."""
    import pathlib
    import re
    from repro_torch.kernels import recurrent as krec
    src = (pathlib.Path(krec.__file__).parent / "csrc"
           / "recurrent.cu").read_text()
    found = {name: int(v) for name, v in
             re.findall(rf"constexpr int ({prefix}\w+) = (\d+);", src)}
    assert found == {"kRglru": krec.RGLRU, "kMlstm": krec.MLSTM}[prefix]
