"""The port's kernel plain versions and wrappers against the JAX package:
``repro.kernels.ref`` and the Pallas kernels in interpret mode, on the
same numpy inputs. Tolerances as ``tests/test_kernels.py``: float32
2e-5, bfloat16 2e-2, argmax indices exact. The CUDA kernels themselves
run only on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import block_attention as kba
from repro_torch.kernels import ops, ref

# tiny shapes: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ATTN_SHAPES = [
    (1, 8, 16, 2, 1, 16), (2, 33, 100, 4, 2, 32), (1, 129, 257, 8, 4, 64),
    (2, 16, 512, 4, 4, 128), (1, 64, 64, 6, 2, 32),
]


def _attn_inputs(B, Sq, Skv, H, Hkv, D, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D), np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D), np.float32)
    qp = np.broadcast_to(np.arange(100, 100 + Sq, dtype=np.int32)[None],
                         (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32)[None], (B, Skv)).copy()
    km = rng.random((B, Skv)) < 0.75
    km[:, 0] = True  # at least one valid key
    return q, k, v, qp, kp, km


def _both(arrs, dtype):
    """numpy inputs -> (jax arrays, torch tensors), floats in ``dtype``."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    j = [jnp.asarray(a, jd) if a.dtype == np.float32 else jnp.asarray(a)
         for a in arrs]
    t = [torch.tensor(a).to(td) if a.dtype == np.float32 else torch.tensor(a)
         for a in arrs]
    return j, t


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_attention_ref_matches_jax_ref(shape, dtype):
    B, Sq, Skv, H, Hkv, D = shape
    j, t = _both(_attn_inputs(*shape), dtype)
    want = jref.block_attention_ref(*j, scale=1 / np.sqrt(D))
    got = ops.block_attention(*t)        # CPU tensors -> the plain version
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, D)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", [ATTN_SHAPES[1], ATTN_SHAPES[4]])
def test_block_attention_ref_matches_pallas_interpret(shape):
    D = shape[-1]
    j, t = _both(_attn_inputs(*shape), "float32")
    want = jops.block_attention(*j, tq=16, tk=32, interpret=True)
    got = ref.block_attention_ref(*t, scale=1 / np.sqrt(D))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("window", [0, 8, 64])
def test_block_attention_features(softcap, window):
    j, t = _both(_attn_inputs(2, 40, 120, 4, 2, 32), "float32")
    kw = dict(softcap=softcap, window=window)
    want = jref.block_attention_ref(*j, scale=1 / np.sqrt(32), **kw)
    got = ops.block_attention(*t, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_block_attention_features_match_pallas_interpret():
    j, t = _both(_attn_inputs(2, 40, 120, 4, 2, 32), "float32")
    kw = dict(softcap=20.0, window=8)
    want = jops.block_attention(*j, tq=16, tk=32, interpret=True, **kw)
    got = ops.block_attention(*t, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_block_attention_fully_masked_rows_are_zero():
    q, k, v, qp, kp, km = _attn_inputs(2, 16, 32, 2, 1, 16)
    km[1] = False                       # row 1 sees no key at all
    j, t = _both((q, k, v, qp, kp, km), "float32")
    got = ops.block_attention(*t)
    want = jops.block_attention(*j, tq=16, tk=16, interpret=True)
    assert (got[1] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_sliding_window_matches_full_when_window_huge():
    q, k, v, qp, kp, km = _attn_inputs(1, 24, 48, 4, 2, 32)
    _, t = _both((q, k, v, qp, kp, np.ones_like(km)), "float32")
    full = ops.block_attention(*t)
    win = ops.sliding_window_attention(*t[:5], window=10_000)
    np.testing.assert_allclose(full.numpy(), win.numpy(), atol=1e-6)


@pytest.mark.parametrize("NV", [(5, 64), (37, 777), (128, 2048), (3, 50304)])
def test_confidence_argmax_matches_jax(NV):
    N, V = NV
    x = np.random.default_rng(N).standard_normal((N, V), np.float32) * 4
    cr, ir = jref.confidence_argmax_ref(jnp.asarray(x))
    c, i = ops.confidence_argmax(torch.tensor(x))
    assert c.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(c.numpy(), np.asarray(cr), atol=1e-5)
    assert (i.numpy() == np.asarray(ir)).all()


def test_confidence_argmax_matches_pallas_interpret_with_ties():
    x = np.random.default_rng(1).standard_normal((6, 1000), np.float32)
    x[:, [3, 700, 999]] = 9.0           # ties across the kernel's tiles
    x[2, [40, 41]] = 10.0               # ties inside one tile
    ck, ik = jops.confidence_argmax(jnp.asarray(x), ts=8, tv=256,
                                    interpret=True)
    c, i = ops.confidence_argmax(torch.tensor(x))
    np.testing.assert_allclose(c.numpy(), np.asarray(ck), atol=1e-5)
    assert (i.numpy() == np.asarray(ik)).all()
    assert i.tolist() == [3, 3, 40, 3, 3, 3]


def test_confidence_argmax_batched_shape():
    x = np.random.default_rng(2).standard_normal((2, 9, 333), np.float32)
    c, i = ops.confidence_argmax(torch.tensor(x))
    assert c.shape == (2, 9) and i.shape == (2, 9)
    cj, ij = jops.confidence_argmax(jnp.asarray(x))
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-5)
    assert (i.numpy() == np.asarray(ij)).all()


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_head_confidence_argmax_matches_jax(softcap):
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 7, 64), np.float32)
    head = rng.standard_normal((64, 500), np.float32) / 8
    kw = dict(mask_id=499, logit_softcap=softcap, row_chunk=4)
    cj, ij = jops.head_confidence_argmax(jnp.asarray(h), jnp.asarray(head),
                                         **kw)
    c, i = ops.head_confidence_argmax(torch.tensor(h), torch.tensor(head),
                                      **kw)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-5)
    assert (i.numpy() == np.asarray(ij)).all()
    assert (i != 499).all()


def test_cpu_wrappers_do_not_count_launches():
    """The counters count kernel launches only; the CPU route is the
    plain version."""
    ops.reset_launches()
    _, t = _both(_attn_inputs(1, 8, 16, 2, 1, 16), "float32")
    ops.block_attention(*t)
    ops.confidence_argmax(torch.randn(3, 50))
    ops.gemm(torch.randn(3, 8), torch.randn(8, 5))
    ops.linear(torch.randn(2, 3, 8), torch.randn(8, 5))
    ops.rglru_scan(torch.randn(1, 3, 8), torch.randn(1, 3, 4),
                   torch.rand(4), torch.randn(1, 4))
    assert ops.LAUNCHES == {"block_attention": 0, "confidence_argmax": 0,
                            "gemm": 0, "rglru_scan": 0, "mlstm_scan": 0,
                            "slstm_scan": 0, "gemm_f32": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_attention_out_dtype_bf16_is_the_rounded_f32_result(dtype):
    """``out_dtype=bfloat16`` is the float32 result rounded to nearest
    even, bit for bit: the cast ``apply_attention`` used to make."""
    _, t = _both(_attn_inputs(2, 33, 100, 4, 2, 64), dtype)
    kw = dict(softcap=20.0, window=16)
    got = ops.block_attention(*t, out_dtype=torch.bfloat16, **kw)
    want = ref.block_attention_ref(*t, scale=1 / np.sqrt(64), **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


# (B, Sq, H, Hkv, D): llada-8b step and refresh, dream-7b GQA step,
# ragged Sq, D=64, and a GQA group wider than one CTA's rows
PLAN_SHAPES = [(4, 129, 32, 32, 128), (4, 385, 32, 32, 128),
               (4, 129, 28, 4, 128), (2, 1, 4, 2, 128), (2, 65, 4, 2, 128),
               (2, 129, 8, 1, 64), (1, 4000, 8, 8, 128), (16, 33, 32, 8, 64),
               # recurrentgemma-9b (16 heads over 1, D = 256): a step and a
               # refresh of 2 rows, and one row alone
               (2, 64, 16, 1, 256), (2, 192, 16, 1, 256), (1, 64, 16, 1, 256)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_launch_plan_covers_every_query_row_once(shape):
    B, Sq, H, Hkv, D = shape
    plan = kba.launch_plan(B, Sq, H, Hkv, D)
    assert plan.rows == H // Hkv * Sq
    assert plan.tiles * kba.ROWS_PER_WARP >= plan.rows
    assert (plan.tiles - 1) * kba.ROWS_PER_WARP < plan.rows
    covered = np.zeros(plan.tiles * kba.ROWS_PER_WARP, np.int64)
    for lo, hi in plan.tile_ranges():
        assert 1 <= hi - lo <= plan.warps   # every CTA's tiles fit its warps
        covered[lo * kba.ROWS_PER_WARP:hi * kba.ROWS_PER_WARP] += 1
    assert (covered == 1).all()
    assert 1 <= plan.warps <= kba.max_warps(D) <= kba.MAX_WARPS
    assert plan.threads == (plan.warps + 1) * 32 <= 1024
    assert plan.smem_bytes <= kba.SMEM_LIMIT
    assert plan.grid == (plan.ctas_per_head, Hkv, B)
    assert plan.stages == kba.STAGES


def test_launch_plan_geometry_at_the_main_path_shapes():
    """One CTA per (b, kv head) at the llada-8b step (128 CTAs, one
    wave); the refresh splits its 385 rows over 3 CTAs; dream-7b's 7
    packed heads (903 rows) over 8, so 128 CTAs fill the card."""
    step = kba.launch_plan(4, 129, 32, 32, 128)
    assert (step.ctas_per_head, step.warps, step.smem_bytes) == (1, 9, 109440)
    refresh = kba.launch_plan(4, 385, 32, 32, 128)
    assert (refresh.ctas_per_head, refresh.warps) == (3, 9)
    gqa = kba.launch_plan(4, 129, 28, 4, 128)
    assert (gqa.rows, gqa.ctas_per_head, gqa.warps) == (903, 8, 8)
    assert kba.smem_bytes(128, kba.MAX_WARPS) == 118144


def test_launch_plan_at_head_dim_256():
    """D = 256 has its own warp cap (7 consumer warps: 256 threads, so
    the kernel may hold 255 registers), and its largest plan fits the
    shared memory a block may use; D = 64 and 128 keep theirs."""
    assert kba.BF16_D == (64, 128, 256)
    assert kba.max_warps(256) == kba.MAX_WARPS_256 == 7
    assert kba.max_warps(128) == kba.max_warps(64) == kba.MAX_WARPS == 11
    assert kba.smem_bytes(256, 7) == 194944 <= kba.SMEM_LIMIT
    step = kba.launch_plan(2, 64, 16, 1, 256)
    assert (step.rows, step.tiles, step.ctas_per_head, step.warps) == \
        (1024, 64, 64, 1)
    wide = kba.launch_plan(1, 4000, 8, 8, 256)
    assert wide.warps <= 7 and wide.threads <= 256
    assert wide.smem_bytes <= kba.SMEM_LIMIT
    assert kba.launch_plan(4, 129, 32, 32, 128).warps == 9
