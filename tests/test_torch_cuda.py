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
