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
import pathlib

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
            assert plan.grid(M) == (-(-M // plan.block_m), plan.n_tiles)
    bf = gemm.launch_plan(126464, 4096, torch.bfloat16)
    assert (bf.block_m, bf.block_n, bf.block_k, bf.stages) == (128, 128, 32, 4)
    assert bf.smem_bytes == 75776 and bf.n_tiles == 988
    with pytest.raises(ValueError):
        gemm.launch_plan(64, 64, torch.float16)


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


@pytest.mark.parametrize("mode", ["encode", "step"])
def test_one_pass_calls_linear_for_each_product(monkeypatch, mode):
    """A pass with the LM head calls ``linear`` 7 times per SwiGLU layer
    (q, k, v, o, gate, up, down) and once for the head; with
    ``skip_head`` the head's product comes from ``chunked_head_reduce``,
    which calls it once per row chunk."""
    from repro_torch.core import schedule
    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []

    def counting(x, w):
        calls.append(tuple(w.shape))
        return ops.linear(x, w)

    for mod in (layers_mod, model_mod, schedule):
        monkeypatch.setattr(mod, "linear", counting)
    toks = torch.randint(0, 200, (2, 12))
    kw = {}
    cache = init_cache(cfg, 2, 24, "cpu")
    if mode == "step":
        kw = dict(cache=cache, kv_valid=torch.full((2,), 4,
                                                   dtype=torch.int32))
    apply_model(cfg, params, tokens=toks, mode=mode, **kw)
    assert len(calls) == 7 * cfg.n_layers + 1
    assert calls[-1] == (cfg.d_model, cfg.vocab_size)
    calls.clear()
    out = apply_model(cfg, params, tokens=toks, mode=mode, skip_head=True,
                      **kw)
    schedule.head_confidence_and_tokens(out.logits, params["lm_head"],
                                        row_chunk=16)
    assert len(calls) == 7 * cfg.n_layers + 2     # 24 rows, chunks of 16
