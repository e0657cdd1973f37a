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


# (K, N) of every product: llada-8b's q/k/v, o, gate/up, down and LM
# head; tiny's q/o, k/v, gate/up, down and head
_PRODUCTS = {"llada_qkv": (4096, 4096), "llada_o": (4096, 4096),
             "llada_gate_up": (4096, 12288), "llada_down": (12288, 4096),
             "llada_head": (4096, 126464), "tiny_qo": (256, 256),
             "tiny_kv": (256, 128), "tiny_gate_up": (256, 768),
             "tiny_down": (768, 256), "tiny_head": (256, 320)}


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

    def counting(x, w, **kw):
        calls.append(tuple(w.shape))
        return ops.linear(x, w, **kw)

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
