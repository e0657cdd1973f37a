"""The port's confidence kernel around its arithmetic, on the CPU: the
launch plan's geometry, the plain version with the [MASK] ban against the
JAX package (``repro.kernels.ref`` and the Pallas kernel in interpret
mode), and the kernel route of the head path against the plain route.
Tolerances: conf 1e-5, idx exact. The CUDA kernel itself runs only on the
card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import schedule as sched
from repro_torch.kernels import confidence as kconf
from repro_torch.kernels import ops

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("V", [320, 50257, 126464, 152064])
@pytest.mark.parametrize("N", [1, 32, 128])
def test_launch_plan_covers_every_column_once(N, V, dtype):
    """For every start offset a row may have, the splits read each column
    exactly once, and every cut inside the row falls on a 16-byte
    boundary (column a0 + k * vec)."""
    plan = kconf.launch_plan(N, V, dtype)
    assert plan.vec == kconf.VEC_BYTES // dtype.itemsize
    assert 1 <= plan.splits <= kconf.MAX_SPLITS
    assert plan.grid == (N, plan.splits)
    assert N * plan.splits <= max(N, kconf.H100_SMS * kconf.CTAS_PER_SM)
    assert plan.splits * plan.chunk >= V // plan.vec
    for a0 in range(plan.vec):
        covered = np.zeros(V, np.int64)
        splits = plan.columns(V, a0)
        assert len(splits) == plan.splits
        for y, ranges in enumerate(splits):
            for lo, hi in ranges:
                assert 0 <= lo < hi <= V
                covered[lo:hi] += 1
                for cut in (lo, hi):
                    if cut not in (0, V, min(a0, V)):
                        assert (cut - a0) % plan.vec == 0, (y, lo, hi)
        assert (covered == 1).all()


def test_launch_plan_geometry_at_the_main_path_shapes():
    """One wave of 4 CTAs per SM at the main path's largest gang: at
    N = 128 rows each row splits 4 ways (512 CTAs) in both dtypes and at
    both vocabularies; N = 32 (one request) and N = 1 take the same 4
    splits, since the count never depends on N; a tiny vocabulary one."""
    for dtype in DTYPES:
        for V in (126464, 152064):
            plan = kconf.launch_plan(128, V, dtype)
            assert (plan.splits, plan.grid) == (4, (128, 4))
    assert kconf.launch_plan(128, 126464, torch.bfloat16).chunk == 3952
    assert kconf.launch_plan(32, 126464, torch.bfloat16).grid == (32, 4)
    assert kconf.launch_plan(1, 126464, torch.bfloat16).splits == 4
    assert kconf.launch_plan(32, 126464, torch.float32).splits == 4
    assert kconf.launch_plan(4, 320, torch.float32).splits == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("V", [320, 50257, 126464, 152064])
def test_split_count_does_not_depend_on_rows(V, dtype):
    """A row's partials merge the same way at every row count (the
    continuous scheduler changes a gang's batch size): every N gives the
    same splits and chunk, so the same column cuts."""
    plans = [kconf.launch_plan(N, V, dtype) for N in (1, 32, 64, 96, 128,
                                                    512, 1024)]
    assert len({(p.splits, p.chunk) for p in plans}) == 1


def _logits(N, V, seed):
    x = np.random.default_rng(seed).standard_normal((N, V), np.float32) * 4
    return x


@pytest.mark.parametrize("NV", [(5, 64), (37, 777), (4, 50257)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_with_ban_matches_jax_ref(NV, dtype):
    """``ops.confidence_argmax(mask_id=...)`` on the CPU (the plain
    version: cast, ban, reduce) against ``repro.kernels.ref`` on the same
    values with the banned column set to -1e30. Row 1's maximum sits at
    the banned column, so its idx must be the next largest."""
    N, V = NV
    x = _logits(N, V, N)
    mask_id = V // 2
    x[1, mask_id] = 100.0
    x = torch.tensor(x).to(dtype).float().numpy()     # the values bf16 holds
    banned = x.copy()
    banned[:, mask_id] = -1e30
    cr, ir = jref.confidence_argmax_ref(jnp.asarray(banned))
    c, i = ops.confidence_argmax(torch.tensor(x).to(dtype), mask_id=mask_id)
    assert c.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(c.numpy(), np.asarray(cr), atol=1e-5)
    assert (i.numpy() == np.asarray(ir)).all()
    assert int(i[1]) != mask_id and (i != mask_id).all()


def test_plain_with_ban_matches_pallas_interpret_with_ties():
    """The plain version with a ban against the Pallas kernel in
    interpret mode on the banned logits, with ties inside and across its
    tiles and a row whose maximum is the banned column."""
    x = np.random.default_rng(3).standard_normal((6, 1000), np.float32)
    x[:, [3, 700, 999]] = 9.0
    x[2, [40, 41]] = 10.0
    x[4, 500] = 20.0                     # the banned column's maximum
    banned = x.copy()
    banned[:, 500] = -1e30
    ck, ik = jops.confidence_argmax(jnp.asarray(banned), ts=8, tv=256,
                                    interpret=True)
    c, i = ops.confidence_argmax(torch.tensor(x), mask_id=500)
    np.testing.assert_allclose(c.numpy(), np.asarray(ck), atol=1e-5)
    assert (i.numpy() == np.asarray(ik)).all()
    assert i.tolist() == [3, 3, 40, 3, 3, 3]


def test_plain_version_does_not_touch_its_input():
    x = torch.tensor(_logits(3, 50, 0))
    keep = x.clone()
    ops.confidence_argmax(x, mask_id=7)
    assert torch.equal(x, keep)


@pytest.mark.parametrize("mask_id", [-1, -5])
def test_negative_mask_id_bans_nothing(mask_id):
    x = torch.tensor(_logits(4, 90, 1))
    c, i = ops.confidence_argmax(x, mask_id=mask_id)
    c0, i0 = ops.confidence_argmax(x)
    assert torch.equal(c, c0) and torch.equal(i, i0)


def test_mask_id_outside_the_row_is_refused():
    with pytest.raises(ValueError, match="mask_id"):
        ops.confidence_argmax(torch.zeros(2, 10), mask_id=10)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_head_kernel_route_equals_plain_route_bit_for_bit_bf16(softcap):
    """The kernel route hands each chunk's bf16 head output and the ban to
    ``confidence_argmax`` (softcap, when set, first in float32); on the
    CPU that is the plain version, and it must give what the plain route
    (float32 cast, softcap, ban, Eq. 4) gives, bit for bit."""
    rng = np.random.default_rng(9)
    h = torch.tensor(rng.standard_normal((2, 7, 64), np.float32)).to(
        torch.bfloat16)
    head = torch.tensor(rng.standard_normal((64, 500), np.float32) / 8).to(
        torch.bfloat16)
    kw = dict(mask_id=499, logit_softcap=softcap, row_chunk=4)
    c, i = ops.head_confidence_argmax(h, head, **kw)
    cp, ip = sched.head_confidence_and_tokens(h, head, **kw)
    assert c.shape == (2, 7) and i.shape == (2, 7)
    assert torch.equal(c, cp) and torch.equal(i, ip)
    assert (i != 499).all()
