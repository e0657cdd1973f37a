"""The port's kernel wrappers on the card: what they refuse to launch.
Each kernel against its plain version, and ``tiny`` through the kernels
against the CPU path, are checked by ``chip_smoke.py`` on the card.
Needs a CUDA card; skips without one. Imports no JAX, so it runs where
JAX is absent:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _attn(B, Sq, Skv, H, Hkv, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g).to(dtype)
    k = torch.randn((B, Skv, Hkv, D), generator=g).to(dtype)
    v = torch.randn((B, Skv, Hkv, D), generator=g).to(dtype)
    qp = torch.arange(50, 50 + Sq, dtype=torch.int32)[None].repeat(B, 1)
    kp = torch.arange(Skv, dtype=torch.int32)[None].repeat(B, 1)
    km = torch.rand((B, Skv), generator=g) < 0.7
    km[:, 0] = True
    return [t.cuda() for t in (q, k, v, qp, kp, km)]


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    before = dict(ops.LAUNCHES)
    q, k, v, qp, kp, km = _attn(1, 8, 16, 2, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.block_attention(q, k, v, qp, kp, km)
    q, k, v, qp, kp, km = _attn(1, 8, 16, 2, 1, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.block_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v, qp, kp, km)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.block_attention(q.half(), k.half(), v.half(), qp, kp, km)
    with pytest.raises(ValueError, match="int32"):
        ops.block_attention(q, k, v, qp.long(), kp, km)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        ops.block_attention(shifted, k, v, qp, kp, km)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.confidence_argmax(torch.zeros(2, 64, dtype=torch.float16,
                                          device=cuda))
    assert ops.LAUNCHES == before             # a refused call counts nothing


def test_attention_wrapper_refuses_pairs_no_kernel_takes(cuda):
    """bf16 goes to the tensor-core kernel (D 64/128), float32 to the
    simple kernel (D 32/64/128); any other (dtype, D) raises, and so does
    an output dtype other than float32 or bfloat16."""
    before = dict(ops.LAUNCHES)
    for D, dtype in ((32, torch.bfloat16), (16, torch.bfloat16),
                     (256, torch.float32)):
        args = _attn(1, 8, 16, 2, 1, D, dtype)
        with pytest.raises(ValueError, match="head dim"):
            ops.block_attention(*args)
    args = _attn(1, 8, 16, 2, 1, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="out_dtype"):
        ops.block_attention(*args, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.block_attention(args[0], *[a.float() if a.is_floating_point()
                                       else a for a in args[1:]])
    assert ops.LAUNCHES == before


def test_confidence_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """float16, a ban outside the row, a row that is not contiguous: each
    raises before a launch, and a refused call counts none."""
    before = dict(ops.LAUNCHES)
    x = torch.randn((4, 1000), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.confidence_argmax(x.half(), mask_id=3)
    with pytest.raises(ValueError, match="mask_id"):
        ops.confidence_argmax(x, mask_id=1000)
    with pytest.raises(ValueError, match="contiguous"):
        ops.confidence_argmax(x[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        ops.confidence_argmax(x.to(torch.bfloat16).t().contiguous().t())
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_confidence_kernel_matches_plain_on_strided_rows(cuda, dtype):
    """Rows of a wider buffer (stride 1003, so no row but the first starts
    on a 16-byte boundary) with a ban: the kernel against the plain
    version, idx exact and conf within 1e-5; one launch counted."""
    g = torch.Generator(device=cuda).manual_seed(0)
    buf = (torch.randn((40, 1003), generator=g, device=cuda) * 4).to(dtype)
    x = buf[:, :997]
    x[5, 400] = 50.0                  # the banned column holds the max
    before = ops.LAUNCHES["confidence_argmax"]
    conf, idx = ops.confidence_argmax(x, mask_id=400)
    c_ref, i_ref = ops.ref.confidence_argmax_ref(x, mask_id=400)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["confidence_argmax"] == before + 1
    assert torch.equal(idx, i_ref) and idx[5] != 400
    assert (conf - c_ref).abs().max().item() <= 1e-5
