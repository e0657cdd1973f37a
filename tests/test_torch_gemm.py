"""The port's GEMM (``kernels/gemm.py``, ``csrc/gemm.cu``) where the CPU
reaches it: the plain version against numpy, the tile plan's freedom
from the row count (what makes the card's decoder batch-invariant),
``ops.linear`` as ``torch.matmul`` on the CPU, and every product of the
model routed through ``ops.linear`` (an AST walk, so a new ``@`` cannot
slip past, and a count of the calls one pass makes). The kernel itself
runs only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""
import ast
import inspect
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import gemm, ops, ref
from repro_torch.models import get_config, init_params
from repro_torch.models import layers as layers_mod
from repro_torch.models import model as model_mod
from repro_torch.models.model import apply_model, init_cache

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_ref_is_a_float32_product(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((37, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 24)).astype(np.float32))
    x, w = x.to(dtype), w.to(dtype)
    want = x.float().numpy() @ w.float().numpy()
    got = ref.gemm_ref(x, w)
    assert got.dtype == dtype and got.shape == (37, 24)
    np.testing.assert_allclose(got.float().numpy(),
                               torch.from_numpy(want).to(dtype).float()
                               .numpy(), rtol=2e-5, atol=2e-5)


def test_launch_plan_takes_no_row_count():
    assert list(inspect.signature(gemm.launch_plan).parameters) == \
        ["N", "K", "dtype"]
    for dtype in (torch.float32, torch.bfloat16):
        plan = gemm.launch_plan(4096, 12288, dtype)
        assert plan == gemm.launch_plan(4096, 12288, dtype)
        assert plan.k_tiles == -(-12288 // plan.block_k)
        # the grid grows with M in its row tiles only; every row tile
        # runs the same k loop
        for B in range(1, 9):
            M = 129 * B
            rows = -(-M // plan.block_m)
            assert plan.row_tiles(M) == rows
            want = (rows * plan.n_tiles,) if plan.tma else \
                (rows, plan.n_tiles)
            assert plan.grid(M) == want
    head = gemm.launch_plan(126464, 4096, torch.bfloat16)
    assert (head.block_m, head.block_n, head.block_k, head.stages,
            head.threads) == (128, 256, 64, 4, 384)
    assert head.smem_bytes == 197696 and head.n_tiles == 494
    qkvo = gemm.launch_plan(4096, 4096, torch.bfloat16)
    assert (qkvo.block_m, qkvo.block_n, qkvo.block_k, qkvo.stages) == \
        (128, 256, 64, 4)
    assert qkvo.smem_bytes == 197696 and qkvo.n_tiles == 16
    with pytest.raises(ValueError):
        gemm.launch_plan(64, 64, torch.float16)


# (K, N) of every bf16 product: llada-8b's q/k/v, o, gate/up, down and LM
# head; tiny's q/o, k/v, gate/up, down and head; and each product of the
# other families at full width (``_family_products``)
_PRODUCTS = {"llada_qkv": (4096, 4096), "llada_o": (4096, 4096),
             "llada_gate_up": (4096, 12288), "llada_down": (12288, 4096),
             "llada_head": (4096, 126464), "tiny_qo": (256, 256),
             "tiny_kv": (256, 128), "tiny_gate_up": (256, 768),
             "tiny_down": (768, 256), "tiny_head": (256, 320)}


def _family_products(arch):
    """{name: (K, N)} of every bf16 product of ``arch`` at full width: q,
    k/v, o, the FFN's or each expert's gate/up and down, the LM head."""
    c = get_config(arch)
    d, hd = c.d_model, c.head_dim
    f = c.moe_d_ff if c.n_experts else c.d_ff
    tag = arch.split("-")[0]
    return {f"{tag}_q": (d, c.n_heads * hd), f"{tag}_kv": (d, c.n_kv_heads
                                                           * hd),
            f"{tag}_o": (c.n_heads * hd, d), f"{tag}_up": (d, f),
            f"{tag}_down": (f, d), f"{tag}_head": (d, c.vocab_size)}


for _arch in ("qwen3-32b", "phi4-mini-3.8b", "minitron-4b", "gemma2-27b",
              "olmoe-1b-7b", "kimi-k2-1t-a32b"):
    _PRODUCTS.update(_family_products(_arch))


def _recurrent_products(arch):
    """{name: (K, N)} of every bf16 product of ``arch`` at full width as
    served: each recurrent mixer's weights through its serving layout
    (``recurrent.mixer_weights``, built here on meta tensors, so nothing
    is allocated), the attention layers' and FFNs' as above, the head.
    RG-LRU's u @ [w_a | w_x] is float32 and not listed."""
    import jax
    import jax.numpy as jnp
    from repro.models import get_config as jget_config
    from repro.models import recurrent as jrec
    from repro_torch.models import recurrent as rec
    c = get_config(arch, dtype="bfloat16", param_dtype="bfloat16")
    tag = arch.split("-")[0]
    out = {f"{tag}_head": (c.d_model, c.vocab_size)}
    for spec in dict.fromkeys(c.layout):
        if spec.mixer not in rec.APPLY:
            out.update({k: v for k, v in _family_products(arch).items()
                        if not k.endswith("_head")})
            continue
        # the reference's parameter shapes, as bf16 meta tensors
        shapes = jax.eval_shape(
            lambda k, m=spec.mixer: getattr(jrec, f"init_{m}")(
                k, jget_config(arch), jnp.bfloat16), jax.random.PRNGKey(0))
        p = {k: torch.empty(v.shape, dtype=torch.bfloat16, device="meta")
             for k, v in shapes.items()}
        lw = rec._LAYOUTS[spec.mixer][1](p)
        for k, w in {**p, **lw}.items():
            if w.dim() == 2 and w.dtype == torch.bfloat16 and k != "conv" \
                    and (k in lw or k in ("w_out", "w_down")):
                out[f"{tag}_{spec.mixer}_{k}"] = tuple(w.shape)
    return out


for _arch in ("recurrentgemma-9b", "xlstm-350m"):
    _PRODUCTS.update(_recurrent_products(_arch))


@pytest.mark.parametrize("product", list(_PRODUCTS))
def test_bf16_plan_fits_the_card(product):
    """The bf16 plan of each product: its ring fits the 227 KB a block
    may use; every TMA box starts on a 1024-byte swizzle atom and has an
    inner row of 128 bytes (the 128-byte swizzle's limit); the tile is
    whole warpgroups of 64 rows, whole k16 wgmma steps and whole 64-wide
    W boxes (wgmma takes N <= 256), the same tile for every N."""
    K, N = _PRODUCTS[product]
    plan = gemm.launch_plan(N, K, torch.bfloat16)
    assert plan.tma
    assert plan.smem_bytes <= 232448     # what an H100 block may use
    x_box = plan.block_m * plan.block_k * 2
    w_box = plan.block_k * gemm.BOX * 2
    assert plan.stage_bytes == x_box + plan.block_n // gemm.BOX * w_box
    boxes = [s * plan.stage_bytes + off for s in range(plan.stages)
             for off in [0] + [x_box + j * w_box
                               for j in range(plan.block_n // gemm.BOX)]]
    assert all(off % 1024 == 0 for off in boxes)
    assert gemm.BOX * 2 == 128 and plan.block_k == gemm.BOX
    assert plan.block_m % 64 == 0 and plan.block_m // 64 == 2
    assert plan.block_k % 16 == 0
    assert plan.block_n % gemm.BOX == 0 and plan.block_n <= 256
    assert plan.threads == 3 * 128       # two consumer groups, a producer
    assert plan.block_n == 256 and plan.n_tiles == -(-N // 256)
    # what ops.gemm asks of a bf16 operand (TMA rows 16-byte aligned)
    assert K % 8 == 0 and N % 8 == 0


def test_gemm_cu_constants_match_the_plan():
    """Every ``constexpr int`` of csrc/gemm.cu that ``_TILES`` names has
    the value ``_TILES`` gives it, so the source and the plan cannot
    drift apart."""
    src = (PORT / "kernels" / "csrc" / "gemm.cu").read_text()
    found = {}
    for decl in re.findall(r"constexpr int ([^;]+);", src):
        for name, value in re.findall(r"(k\w+) = (\d+)\b", decl):
            found[name] = int(value)
    assert {k: found.get(k) for k in gemm._TILES} == gemm._TILES
    # the float32 tile's derived sizes, as the source computes them
    assert re.search(r"constexpr int kFAStride = kFBK \+ (\d+);",
                     src).group(1) == str(gemm.F32_A_STRIDE - gemm._TILES[
                         "kFBK"])
    assert "return (bn + 31) / 32 * 32 + 8;" in src
    assert [gemm.f32_b_stride(bn) for bn in (8, 16, 32, 64)] == \
        [40, 40, 40, 72]


# (name, M, K, N) of the float32 products on the card: the MoE routers,
# RG-LRU's u @ [w_a | w_x] (at a block-0 step of 2 requests), tiny's FFN
_F32_PRODUCTS = {"olmoe_router": (128, 2048, 64),
                 "kimi_router": (128, 7168, 384),
                 "recurrentgemma_u_wa_wx": (128, 4096, 8192),
                 "tiny_gate_up": (26, 256, 768), "ragged": (37, 72, 40)}


@pytest.mark.parametrize("product", list(_F32_PRODUCTS))
def test_float32_plan_spreads_narrow_products_without_split_k(product):
    """The float32 (3xTF32) plan: 64 rows x BN columns x 32 k, BN the
    widest of 64 .. 8 giving N 32 column tiles or more (a router gets
    more CTAs from narrower tiles, never from splitting K: every CTA runs
    all of K), whole m16n8k8 fragments for each of 4 warps, a ring that
    fits the card, and fragment loads on 32 distinct banks."""
    M, K, N = _F32_PRODUCTS[product]
    plan = gemm.launch_plan(N, K, torch.float32)
    assert not plan.tma and plan.threads == 128 and plan.stages == 4
    assert (plan.block_m, plan.block_k) == (64, 32)
    assert plan.k_tiles == -(-K // 32)
    wider = [bn for bn in (8, 16, 32, 64) if bn > plan.block_n]
    assert plan.n_tiles >= 32 or plan.block_n == 8
    assert all(-(-N // bn) < 32 for bn in wider)
    wm, wn = plan.warps
    assert wm * wn == plan.threads // 32
    assert plan.block_m % (16 * wm) == 0 and plan.block_n % (8 * wn) == 0
    assert plan.smem_bytes <= 232448
    assert plan.grid(M) == (-(-M // 64), -(-N // plan.block_n))
    # A fragment (row lane / 4, k lane % 4) and B fragment (k lane % 4, n
    # lane / 4) in rows of F32_A_STRIDE / f32_b_stride floats
    lanes = range(32)
    assert len({((l // 4) * gemm.F32_A_STRIDE + l % 4) % 32
                for l in lanes}) == 32
    assert len({((l % 4) * gemm.f32_b_stride(plan.block_n) + l // 4) % 32
                for l in lanes}) == 32
    want = {"olmoe_router": (8, 16), "kimi_router": (8, 96),
            "recurrentgemma_u_wa_wx": (64, 256)}.get(product)
    if want:
        assert (plan.block_n, math.prod(plan.grid(M))) == want


def _tf32(v):
    """``cvt.rna.tf32.f32``: float32 rounded to a 10-bit mantissa, to
    nearest with ties away from zero."""
    u = v.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mma_3xtf32(x, w, terms=3):
    """gemm.cu's float32 route in numpy: x and w split once into big =
    tf32(v) and small = tf32(v - big); per k8 step, ascending, the terms
    small.big, big.small, big.big (or big.big alone), each an exact sum
    of 8 products, summed in float32 into the step's own value, which is
    added to the output's float32 accumulator."""
    xb = _tf32(x)
    xs = _tf32(x - xb)
    wb = _tf32(w)
    ws = _tf32(w - wb)
    pairs = [(xs, wb), (xb, ws), (xb, wb)][3 - terms:]
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k in range(0, x.shape[1], 8):
        step = np.zeros_like(acc)
        for a, b in pairs:
            part = a[:, k:k + 8].astype(np.float64) @ b[k:k + 8].astype(
                np.float64)
            step = (step.astype(np.float64) + part).astype(np.float32)
        acc = acc + step
    return acc


@pytest.mark.parametrize("K", [2048, 4096, 7168])
def test_three_tf32_products_keep_float32_accuracy(K):
    """The split keeps the float32 product within chip_smoke.py's
    ``gemm_close`` tolerance, 2e-5 of max |ref| against the float64
    product, at the routers' and RG-LRU's depths; one TF32 product (big
    . big alone) would not."""
    rng = np.random.default_rng(K)
    x = rng.standard_normal((8, K)).astype(np.float32)
    w = (rng.standard_normal((K, 32)) / math.sqrt(K)).astype(np.float32)
    full = x.astype(np.float64) @ w.astype(np.float64)
    tol = 2e-5 * np.abs(full).max()
    assert np.abs(_mma_3xtf32(x, w) - full).max() <= tol
    assert np.abs(_mma_3xtf32(x, w, terms=1) - full).max() > tol


def test_float32_gemm_bound_is_the_3xtf32_rate():
    """A float32 product's bound counts 2 M K N operations at a third of
    the 495 TFLOP/s TF32 rate (the kernel's three TF32 products), every
    other float32 op keeps 67 TFLOP/s, and the counted FLOPs are
    unchanged."""
    from repro_torch.kernels import cost
    got = {name: cost.gemm_bound(M, K, N, torch.float32)
           for name, (M, K, N) in _F32_PRODUCTS.items()
           if name in ("olmoe_router", "kimi_router",
                       "recurrentgemma_u_wa_wx")}
    assert got["recurrentgemma_u_wa_wx"][1] == "operations"
    assert got["recurrentgemma_u_wa_wx"][0] == pytest.approx(0.0521,
                                                             abs=5e-5)
    assert got["olmoe_router"][1] == got["kimi_router"][1] == "bytes"
    assert got["olmoe_router"][0] == pytest.approx(0.000479, abs=5e-7)
    assert got["kimi_router"][0] == pytest.approx(0.00444, abs=5e-6)
    ops_, _, rate = cost.gemm_cost(128, 4096, 8192, torch.float32)
    assert ops_ == 2 * 128 * 4096 * 8192
    assert cost.peak_ops_s(rate) == 495e12 / 3
    assert cost.peak_ops_s(torch.float32) == 67e12
    assert cost.gemm_cost(128, 4096, 8192, torch.bfloat16)[2] == \
        torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_on_the_cpu_is_matmul_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 5, 64), generator=g).to(dtype)
    w = torch.randn((64, 48), generator=g).to(dtype)
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.linear(x, w), torch.matmul(x, w))
    assert torch.equal(ops.linear(x[:, 1:4], w), x[:, 1:4] @ w)
    assert torch.equal(ops.gemm(x[0], w), ref.gemm_ref(x[0], w))
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="shapes"):
        ops.gemm(x[0], w[:32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float32_out_is_the_unrounded_product(dtype):
    """``out_dtype=torch.float32`` (a tensor-parallel partial sum): the
    float32 product of the same inputs, which rounds to the plain
    output; anything but x's dtype or float32 is refused."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((7, 64), generator=g).to(dtype)
    w = torch.randn((64, 24), generator=g).to(dtype)
    y = ops.linear(x, w, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    assert torch.equal(y, x.float() @ w.float())
    assert torch.equal(ops.gemm(x, w, torch.float32), y)
    assert torch.equal(ref.gemm_ref(x, w, torch.float32).to(dtype),
                       ref.gemm_ref(x, w))
    with pytest.raises(ValueError, match="out_dtype"):
        ops.gemm(x, w, torch.float16)
    # a tensor-parallel chain: the second half of K added to the first's
    # float32 sums (on the CPU, the plain float32 sum)
    acc = ops.gemm(x[:, :32], w[:32], torch.float32)
    chain = ops.gemm(x[:, 32:], w[32:], torch.float32, acc=acc)
    assert torch.allclose(chain, y, rtol=1e-5, atol=1e-5)
    assert torch.equal(ops.linear(x[:, 32:], w[32:], out_dtype=torch.float32,
                                  acc=acc), chain)
    with pytest.raises(ValueError, match="acc"):
        ops.gemm(x, w, acc=acc)


def _products(path):
    """(line, what) of every matrix product written in ``path`` other than
    through ``linear``: ``@``, and calls of matmul/mm/bmm/einsum/linear
    of torch or of a tensor."""
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            found.append((node.lineno, "@"))
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute):
            if node.func.attr in ("matmul", "mm", "bmm", "einsum", "linear",
                                  "addmm", "baddbmm", "tensordot"):
                found.append((node.lineno, node.func.attr))
    return found


def test_every_model_product_goes_through_linear():
    """No product in ``models/`` or ``core/schedule.py`` bypasses
    ``ops.linear``, except the plain attention reference (``attend_ref``'s
    einsums: the CPU tests' route; the card runs the attention kernel)."""
    files = sorted((PORT / "models").glob("*.py")) + [
        PORT / "core" / "schedule.py"]
    src = (PORT / "models" / "layers.py").read_text().splitlines()
    chunk = next(i for i, ln in enumerate(src, 1)
                 if ln.startswith("def _attend_chunk"))
    chunk_end = next(i for i, ln in enumerate(src, 1)
                     if i > chunk and ln.startswith("def "))
    for f in files:
        for line, what in _products(f):
            allowed = (f.name == "layers.py" and what == "einsum"
                       and chunk < line < chunk_end)
            assert allowed, f"{f.relative_to(ROOT)}:{line} multiplies " \
                f"with {what!r}, not ops.linear"


@pytest.mark.parametrize("arch", ["tiny", "tiny-moe"])
@pytest.mark.parametrize("mode", ["encode", "step"])
def test_one_pass_calls_linear_for_each_product(monkeypatch, mode, arch):
    """A pass with the LM head calls ``linear`` 7 times per SwiGLU layer
    (q, k, v, o, gate, up, down), 5 + 3 E per MoE layer (q, k, v, o, the
    float32 router, each expert's gate, up and down) and once for the
    head; with ``skip_head`` the head's product comes from
    ``chunked_head_reduce``, which calls it once per row chunk."""
    from repro_torch.core import schedule
    from repro_torch.models import moe as moe_mod
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    per_layer = 5 + 3 * cfg.n_experts if cfg.n_experts else 7
    calls = []

    def counting(x, w, **kw):
        calls.append(tuple(w.shape))
        if w.shape == (cfg.d_model, cfg.n_experts):
            assert x.dtype == w.dtype == torch.float32    # the router
        return ops.linear(x, w, **kw)

    for mod in (layers_mod, model_mod, schedule, moe_mod):
        monkeypatch.setattr(mod, "linear", counting)
    toks = torch.randint(0, 200, (2, 12))
    kw = {}
    cache = init_cache(cfg, 2, 24, "cpu")
    if mode == "step":
        kw = dict(cache=cache, kv_valid=torch.full((2,), 4,
                                                   dtype=torch.int32))
    apply_model(cfg, params, tokens=toks, mode=mode, **kw)
    assert len(calls) == per_layer * cfg.n_layers + 1
    assert calls[-1] == (cfg.d_model, cfg.vocab_size)
    calls.clear()
    out = apply_model(cfg, params, tokens=toks, mode=mode, skip_head=True,
                      **kw)
    schedule.head_confidence_and_tokens(out.logits, params["lm_head"],
                                        row_chunk=16)
    assert len(calls) == per_layer * cfg.n_layers + 2  # 24 rows, chunks of 16
