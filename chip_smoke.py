#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``triton``; imports nothing of JAX or
of the JAX package. Phases, each printing JSON lines:

1. device   — card name and power limit (nvidia-smi), torch/CUDA versions.
2. build    — builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
              with nvcc (the port's two libraries and two probe builds of
              the attention kernel, in parallel; ptxas registers and
              spills per kernel) and compiles the first port's Triton
              confidence kernel, kept only to be timed here.
3. kernels  — each kernel against its plain PyTorch version on the card at
              the main path's shapes and at small edge cases, with its
              time, the plain version's, the library call's and the bound;
              at the timed shapes also the first port's kernel (simple
              attention; Triton confidence on float32), in turns with the
              new one; then the LM-head path of a denoise step as a unit,
              against the route it replaced.
4. probe    — the bf16 attention kernel against its load path alone and
              its math alone, at the timed shapes.
5. reference — ``tiny`` (float32) on the card through the kernels against
              the plain path on the CPU: model logits and decode tokens;
              then llada-8b at full width, 2 layers, bf16, through the
              kernels against ``attend_ref`` on the card.
6. serve    — ``ServingEngine`` in batch mode, llada-8b at full width and
              depth (bf16, random weights from a seed), streaming decode
              of 4 prompts; launch counters read around this run only.
7. profile  — the middle block of that decode: wall time without the
              profiler, device time by kernel under it, idle share.

Then the kernels summary line, the nvidia-smi line and, last, the device
line ``{"ok": true, "device": {...}}``. Any failure raises: the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import schedule as sched  # noqa: E402
from repro_torch.core.decoder import (DecodeConfig,  # noqa: E402
                                      DiffusionDecoder)
from repro_torch.core.engine import ServingEngine  # noqa: E402
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.kernels import block_attention as kba  # noqa: E402
from repro_torch.kernels import build, confidence, ops, ref  # noqa: E402
from repro_torch.models import apply_model, get_config, init_params  # noqa: E402
from repro_torch.models.model import init_cache, params_to  # noqa: E402

HBM_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
SEED = 0
PROMPT_LEN = 128
N_PROMPTS = 4
GEN_LEN, BLOCK, WINDOW = 256, 32, 96


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, cycling
    through ``arg_sets`` (sized so that together they exceed the 50 MB
    L2: each launch finds its inputs cold, as in the decode loop). The
    launches are captured in one CUDA graph and replayed, so the host's
    cost per call (a wrapper's checks in Python) does not set the pace:
    ``eager_ms`` times that."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean time per call of ``fn(*args)`` issued one by one from Python,
    with events around the run: the pace of whichever is slower, the
    host issuing the calls or the device running them."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_copies(nbytes: int) -> int:
    return max(1, math.ceil(120e6 / max(nbytes, 1)))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------------ kernels

def attention_inputs(B, Sq, Skv, H, Hkv, D, dtype, *, n_valid=None,
                     q_start=0, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda").to(dtype)
    qp = (q_start + torch.arange(Sq, device="cuda", dtype=torch.int32))
    qp = qp[None].expand(B, Sq).contiguous()
    kp = torch.arange(Skv, device="cuda", dtype=torch.int32)[None]
    kp = kp.expand(B, Skv).contiguous()
    if n_valid is None:
        km = torch.rand((B, Skv), generator=g, device="cuda") < 0.75
        km[:, 0] = True
    else:
        km = torch.ones((B, Skv), dtype=torch.bool, device="cuda")
        km[:, n_valid:Skv - Sq] = False      # cache slots past prefix_len
    return q, k, v, qp, kp, km


def attention_bound(q, k, v, qp, kp, km, out, window):
    """Bytes and operations this run's data needs: K/V rows that no query
    may attend (masked, or outside every query's window) are never read,
    and only valid (query, key) pairs are multiplied."""
    valid = km[:, None, :].expand(q.shape[0], q.shape[1], k.shape[1])
    if window:
        valid = valid & ((qp[:, :, None] - kp[:, None, :]).abs() <= window)
    pairs = int(valid.sum()) * q.shape[2]          # (b, q, key, head)
    ops = 4 * pairs * q.shape[3]                   # QK^T and PV
    peak = PEAK_OPS_S["bfloat16" if q.dtype == torch.bfloat16 else "float32"]
    kv_rows = int(valid.any(dim=1).sum())          # (b, key) read at all
    kv_bytes = 2 * kv_rows * k.shape[2] * k.shape[3] * k.element_size()
    t_bytes = (nbytes(q, qp, kp, km, out) + kv_bytes) / HBM_BYTES_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def check_attention(name, shape, dtype, *, softcap=0.0, window=0,
                    n_valid=None, q_start=0, masked_row=False, timed=False):
    """The wrapper's kernel (bf16: the tensor-core kernel, float32: the
    simple one) against the plain version on the same inputs. bf16 cases
    also check the fused bf16 epilogue: the kernel's bf16 output is its
    float32 output rounded to nearest even, bit for bit. Timed cases time
    the first port's simple kernel on the same inputs, in turns."""
    B, Sq, Skv, H, Hkv, D = shape
    args = attention_inputs(B, Sq, Skv, H, Hkv, D, dtype, n_valid=n_valid,
                            q_start=q_start)
    q, k, v, qp, kp, km = args
    if masked_row:
        km[-1] = False                       # the last row sees no key
    scale = 1.0 / math.sqrt(D)
    kw = dict(scale=scale, softcap=softcap, window=window)
    out = ops.block_attention(*args, **kw)
    want = ref.block_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    # both sides take the same bf16 inputs and compute in f32, so bf16
    # needs no more room than f32's summation order (errors seen ~1e-6)
    tol = 1e-4 if dtype == torch.bfloat16 else 2e-5
    ok = torch.allclose(out, want, atol=tol, rtol=tol)
    if masked_row:
        ok = ok and bool((out[-1] == 0).all())
    route = "bf16_tensor_core" if dtype == torch.bfloat16 else "simple"
    extra = {}
    if dtype == torch.bfloat16:
        out_bf = ops.block_attention(*args, out_dtype=torch.bfloat16, **kw)
        extra["bf16_out_exact"] = bool(torch.equal(out_bf,
                                                   out.to(torch.bfloat16)))
        ok = ok and extra["bf16_out_exact"]
        plan = kba.launch_plan(B, Sq, H, Hkv, D,
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
        extra["plan"] = {"ctas_per_head": plan.ctas_per_head,
                         "warps": plan.warps, "threads": plan.threads,
                         "stages": plan.stages,
                         "smem_bytes": plan.smem_bytes,
                         "ctas": plan.ctas_per_head * Hkv * B}
    rec = {"phase": "kernels", "kernel": "block_attention", "route": route,
           "case": name,
           "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hkv": Hkv,
                     "D": D}, "dtype": str(dtype).split(".")[-1],
           "softcap": softcap, "window": window,
           "max_abs_err": err, "tol": tol, "ok": ok, **extra}
    if timed:
        sets = [attention_inputs(B, Sq, Skv, H, Hkv, D, dtype,
                                 n_valid=n_valid, q_start=q_start, seed=s)
                for s in range(n_copies(nbytes(*args, out)))]
        out_s = torch.empty_like(out)
        kba.launch_simple(*args, out_s, **kw)
        torch.cuda.synchronize()
        rec["simple_max_abs_err"] = (out_s - want).abs().max().item()

        def new(*a):
            return ops.block_attention(*a, **kw)

        def simple(*a):
            kba.launch_simple(*a, out_s, **kw)

        # in turns: new, simple, simple, new
        t_new, t_simple = time_ms(new, sets), time_ms(simple, sets)
        t_simple2, t_new2 = time_ms(simple, sets), time_ms(new, sets)
        rec["kernel_ms"] = (t_new + t_new2) / 2
        rec["simple_ms"] = (t_simple + t_simple2) / 2
        rec["eager_ms"] = eager_ms(new, sets)
        rec["kernel_ms_turns"] = [t_new, t_new2]
        rec["simple_ms_turns"] = [t_simple, t_simple2]
        rec["plain_ms"] = time_ms(
            lambda *a: ref.block_attention_ref(*a, **kw), sets)
        lib = None
        if not softcap:
            def sdpa(q, k, v, qp, kp, km):
                mask = km[:, None, None, :]
                if window:
                    mask = mask & ((qp[:, None, :, None] - kp[:, None, None, :])
                                   .abs() <= window)
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, scale=scale, enable_gqa=H != Hkv)
            lib = time_ms(sdpa, sets)
        rec["library_ms"] = lib
        rec["bound_ms"], rec["bound_by"] = attention_bound(*args, out, window)
    emit(rec)
    if not ok:
        raise AssertionError(f"block_attention {name}: max err {err} > {tol}")
    return rec


def phase_probe():
    """Where the bf16 attention kernel's time goes: the full kernel, the
    load path alone (probe 1: consumers skip the math) and the math
    alone (probe 2: the producer skips the copies), in turns on the same
    inputs at the three timed shapes. The probes' outputs are garbage
    and are not checked."""
    probes = {1: kba.load_probe(1), 2: kba.load_probe(2)}
    T, Sq = PROMPT_LEN + GEN_LEN, BLOCK + WINDOW + 1
    mid = PROMPT_LEN + (GEN_LEN // BLOCK // 2) * BLOCK
    for name, shape, n_valid, q_start in (
            ("llada8b_step", (4, Sq, T + Sq, 32, 32, 128), mid, mid),
            ("llada8b_refresh", (4, mid + Sq, mid + Sq, 32, 32, 128),
             mid + Sq, 0),
            ("dream7b_step_gqa", (4, Sq, T + Sq, 28, 4, 128), mid, mid)):
        B, Sq_, Skv, H, Hkv, D = shape
        sets = [attention_inputs(B, Sq_, Skv, H, Hkv, D, torch.bfloat16,
                                 n_valid=n_valid, q_start=q_start, seed=s)
                for s in range(6)]
        out = torch.empty((B, Sq_, H, D), device="cuda")
        kw = dict(scale=1.0 / math.sqrt(D), softcap=0.0, window=0)

        def timed(lib):
            return time_ms(lambda *a: kba.launch(*a, out, lib=lib, **kw),
                           sets)

        full, load, math_ = timed(None), timed(probes[1]), timed(probes[2])
        full2, load2, math2 = timed(None), timed(probes[1]), timed(probes[2])
        emit({"phase": "probe", "kernel": "block_attention", "case": name,
              "full_ms": (full + full2) / 2, "load_only_ms": (load + load2) / 2,
              "math_only_ms": (math_ + math2) / 2,
              "turns": [full, load, math_, full2, load2, math2]})


def row_a0(x, row: int) -> int:
    """Column of the first 16-byte boundary of ``x[row]``."""
    addr = x.data_ptr() + row * x.stride(0) * x.element_size()
    return (-addr % 16) // x.element_size()


def plant_ties(x, mask_id: int) -> None:
    """Equal maxima where the kernel's merges meet, one pattern per row in
    turn: inside one 16-byte vector; across threads and warps; on both
    sides of every split cut that ``launch_plan`` picks; the row's scalar
    head, first body column and scalar tail; and a larger value at
    ``mask_id``, which must not win. The first index of the (unbanned)
    maximum must win."""
    N, V = x.shape
    plan = confidence.launch_plan(N, V, x.dtype, torch.cuda
                                  .get_device_properties(0)
                                  .multi_processor_count)
    vec, top = plan.vec, 30.0                   # above every randn * 4 value
    for r in range(N):
        a0 = row_a0(x, r)
        kind = r % 5
        if kind == 0:
            cols = [a0 + 3 * vec + 1, a0 + 3 * vec + vec - 1]
        elif kind == 1:
            cols = [a0 + vec * (confidence.THREADS + 5), a0 + vec * (96 + 5),
                    a0 + vec * 5 + 2]
        elif kind == 2:
            cuts = [rg[0][0] for rg in plan.columns(V, a0)[1:] if rg]
            cols = [c + d for c in cuts for d in (-1, 0)] or [V // 2, V - 1]
        elif kind == 3:
            cols = [0, a0, V - 1]
        else:
            cols = [7, V // 3]
            if mask_id >= 0:
                x[r, mask_id] = top + 2
        x[r, [c for c in cols if c < V and c != mask_id]] = top


def check_confidence(name, N, V, dtype, *, mask_id=-1, timed=False,
                     ties=False):
    """The CUDA kernel through ``ops.confidence_argmax`` against the
    plain version on the same inputs (the same bf16 or float32 values,
    the same ban): idx exact, conf within 1e-5. Timed cases also time
    the plain version and, on float32 inputs, the first port's Triton
    kernel (no ban; in turns with the new one)."""

    def make(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = (torch.randn((N, V), generator=g, device="cuda") * 4).to(dtype)
        if ties:
            plant_ties(x, mask_id)
        return x

    x = make(0)
    conf, idx = ops.confidence_argmax(x, mask_id=mask_id)
    c_ref, i_ref = ref.confidence_argmax_ref(x, mask_id=mask_id)
    torch.cuda.synchronize()
    err = (conf - c_ref).abs().max().item()
    idx_ok = bool((idx == i_ref).all())
    again = ops.confidence_argmax(x, mask_id=mask_id)
    same = bool(torch.equal(again[0], conf) and torch.equal(again[1], idx))
    ok = idx_ok and err <= 1e-5 and same
    plan = confidence.launch_plan(N, V, dtype, torch.cuda
                                  .get_device_properties(0)
                                  .multi_processor_count)
    rec = {"phase": "kernels", "kernel": "confidence_argmax", "route": "cuda",
           "case": name, "shape": {"N": N, "V": V},
           "dtype": str(dtype).split(".")[-1], "mask_id": mask_id,
           "plan": {"splits": plan.splits, "chunk_vectors": plan.chunk,
                    "ctas": N * plan.splits},
           "row0_a0": row_a0(x, 0), "max_abs_err": err, "tol": 1e-5,
           "idx_exact": idx_ok, "repeat_identical": same, "ok": ok}
    if timed:
        sets = [(make(s),) for s in range(n_copies(nbytes(x)))]

        def new(a):
            return ops.confidence_argmax(a, mask_id=mask_id)

        def plain(a):
            return ref.confidence_argmax_ref(a, mask_id=mask_id)

        def probe(mode):
            lib = confidence.load_probe(mode)
            return lambda a: confidence.launch(a, conf, idx, mask_id=mask_id,
                                               lib=lib)

        # the kernel against its loads alone and its arithmetic alone (the
        # probes' outputs are garbage) and, on float32, the first port's
        # Triton kernel (no ban; checked without one), on the same inputs.
        # In turns: port, others, others reversed, port.
        others = {"load_only": probe(1), "math_only": probe(2)}
        if dtype == torch.float32:
            c_t = torch.empty_like(conf)
            i_t = torch.empty_like(idx)
            confidence.launch_triton(x, c_t, i_t)
            c_nb, i_nb = ref.confidence_argmax_ref(x)
            torch.cuda.synchronize()
            rec["triton_max_abs_err"] = (c_t - c_nb).abs().max().item()
            rec["triton_idx_exact"] = bool((i_t == i_nb).all())
            ok = ok and rec["triton_max_abs_err"] <= 1e-5 \
                and rec["triton_idx_exact"]
            others["triton"] = lambda a: confidence.launch_triton(a, c_t, i_t)
        turns = {"port": [time_ms(new, sets)]}
        for k, fn in others.items():
            turns[k] = [time_ms(fn, sets)]
        for k in reversed(list(others)):
            turns[k].append(time_ms(others[k], sets))
        turns["port"].append(time_ms(new, sets))
        rec["kernel_ms_turns"] = turns["port"]
        rec["kernel_ms"] = sum(turns["port"]) / 2
        for k, t in turns.items():
            if k != "port":
                rec[f"{k}_ms"] = sum(t) / 2
        rec["eager_ms"] = eager_ms(new, sets)
        rec["plain_ms"] = time_ms(plain, sets)
        rec["library_ms"] = None     # no single PyTorch call computes it
        t_bytes = (nbytes(x) + N * 8) / HBM_BYTES_S
        t_ops = 5 * N * V / PEAK_OPS_S["float32"]   # max, sub, exp, add, cmp
        rec["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["bound_share"] = rec["bound_ms"] / rec["kernel_ms"]
        rec["ok"] = ok
    emit(rec)
    if not ok:
        raise AssertionError(f"confidence_argmax {name}: err {err}, "
                             f"idx exact {idx_ok}, repeat identical {same}")
    return rec


def confidence_scaling(mask_id: int):
    """Device time of the main path's form (bf16 + ban, V = 126464) as the
    rows grow from 64 to 512: about 512 CTAs each time (launch_plan), so
    each CTA's share of the bytes grows with N. A least-squares line
    through (bytes, ms) gives the rate the kernel streams at (its slope)
    and its cost that does not grow with the bytes (its intercept:
    launch, ramp-up, the rows' last-CTA merges)."""
    V, rows = 126464, []
    for N in (64, 128, 256, 512):
        def make(seed):
            g = torch.Generator(device="cuda").manual_seed(seed)
            return (torch.randn((N, V), generator=g, device="cuda")
                    * 4).to(torch.bfloat16)
        x = make(0)
        sets = [(make(s),) for s in range(n_copies(nbytes(x)))]
        ms = time_ms(lambda a: ops.confidence_argmax(a, mask_id=mask_id),
                     sets)
        plan = confidence.launch_plan(N, V, torch.bfloat16)
        rows.append({"N": N, "bytes": nbytes(x), "ms": ms,
                     "ctas": N * plan.splits})
    b = np.array([r["bytes"] for r in rows], dtype=np.float64)
    t = np.array([r["ms"] for r in rows], dtype=np.float64)
    slope, intercept = np.polyfit(b, t, 1)
    emit({"phase": "kernels", "kernel": "confidence_argmax",
          "case": "scaling_bf16", "points": rows,
          "fit_tb_s": 1e-9 / slope, "fit_fixed_ms": intercept})


def check_head_path(mask_id: int, d: int = 4096, V: int = 126464):
    """The head path of one llada-8b denoise step as a unit:
    ``ops.head_confidence_argmax`` on hidden (4, 32, 4096) bf16 through
    the head (4096, 126464) bf16 (GEMM, then the kernel on its bf16
    output with the ban), against the previous route (GEMM, float32
    cast, ban as an indexed store, Triton kernel) and the plain route,
    on the same inputs. Both routes graph-timed in turns, with the GEMM
    alone and the GEMM's own bound (the head's bytes) beside them."""
    B, K = N_PROMPTS, BLOCK
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    hidden = torch.randn((B, K, d), generator=g, device="cuda").to(
        torch.bfloat16)
    head = (torch.randn((d, V), generator=g, device="cuda")
            / math.sqrt(d)).to(torch.bfloat16)
    h2 = hidden.reshape(-1, d)
    c_prev = torch.empty(B * K, dtype=torch.float32, device="cuda")
    i_prev = torch.empty(B * K, dtype=torch.int32, device="cuda")

    def new():
        return ops.head_confidence_argmax(hidden, head, mask_id=mask_id)

    def previous():
        logits = (h2 @ head).float()
        logits[:, mask_id] = -1e30
        confidence.launch_triton(logits, c_prev, i_prev)
        return c_prev, i_prev

    def gemm():
        return h2 @ head

    c_new, i_new = new()
    previous()
    c_pl, i_pl = sched.head_confidence_and_tokens(hidden, head,
                                                  mask_id=mask_id)
    torch.cuda.synchronize()
    err = (c_new - c_pl).abs().max().item()
    idx_ok = bool((i_new == i_pl).all())
    prev_agree = bool((i_new.reshape(-1) == i_prev).all())
    ok = idx_ok and err <= 1e-5 and prev_agree
    t_new, t_prev = time_ms(new, [()]), time_ms(previous, [()])
    t_prev2, t_new2 = time_ms(previous, [()]), time_ms(new, [()])
    t_gemm = time_ms(gemm, [()])
    t_bytes = (nbytes(hidden, head) + B * K * 8) / HBM_BYTES_S
    t_ops = 2 * B * K * d * V / PEAK_OPS_S["bfloat16"]
    rec = {"phase": "kernels", "kernel": "head_path", "case": "llada8b_step",
           "shape": {"rows": B * K, "d": d, "V": V}, "mask_id": mask_id,
           "max_abs_err": err, "tol": 1e-5, "idx_exact": idx_ok,
           "previous_route_idx_agree": prev_agree,
           "new_ms": (t_new + t_new2) / 2,
           "previous_ms": (t_prev + t_prev2) / 2,
           "new_ms_turns": [t_new, t_new2],
           "previous_ms_turns": [t_prev, t_prev2], "gemm_ms": t_gemm,
           "gemm_bound_ms": 1e3 * max(t_bytes, t_ops),
           "gemm_bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "ok": ok}
    emit(rec)
    del head
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"head path: err {err}, idx exact {idx_ok}, "
                             f"previous route agrees {prev_agree}")
    return rec


def phase_kernels():
    bf16, f32 = torch.bfloat16, torch.float32
    T = PROMPT_LEN + GEN_LEN
    Sq = BLOCK + WINDOW + 1
    mid = PROMPT_LEN + (GEN_LEN // BLOCK // 2) * BLOCK   # a middle block
    # main path, llada-8b: a denoise step attends [whole cache || self]
    # with the cache valid up to the block start; a refresh is unmasked
    step = check_attention("llada8b_step", (4, Sq, T + Sq, 32, 32, 128),
                           bf16, n_valid=mid, q_start=mid, timed=True)
    check_attention("llada8b_refresh", (4, mid + Sq, mid + Sq, 32, 32, 128),
                    bf16, n_valid=mid + Sq, timed=True)
    check_attention("dream7b_step_gqa", (4, Sq, T + Sq, 28, 4, 128), bf16,
                    n_valid=mid, q_start=mid, timed=True)
    for softcap in (0.0, 20.0):
        for window in (0, 8):
            check_attention(f"f32_sc{softcap:g}_w{window}",
                            (2, 40, 120, 4, 2, 32), f32, softcap=softcap,
                            window=window, q_start=30)
    check_attention("f32_masked_row", (2, 16, 32, 2, 1, 64), f32,
                    masked_row=True)
    check_attention("f32_ragged", (1, 129, 257, 8, 4, 64), f32)
    check_attention("bf16_ragged", (2, 33, 100, 4, 2, 128), bf16)
    # the bf16 tensor-core kernel: every feature, edge and geometry it takes
    for D in (128, 64):
        for softcap in (0.0, 20.0):
            for window in (0, 8):
                check_attention(f"bf16_d{D}_sc{softcap:g}_w{window}",
                                (2, 40, 120, 4, 2, D), bf16, softcap=softcap,
                                window=window, q_start=30)
        check_attention(f"bf16_d{D}_masked_row", (2, 16, 32, 2, 1, D), bf16,
                        masked_row=True)
        for sq in (1, 65, 129):      # Skv = 100, not a multiple of 32 keys
            check_attention(f"bf16_d{D}_ragged_sq{sq}", (2, sq, 100, 4, 2, D),
                            bf16)
        for g in (1, 7):
            check_attention(f"bf16_d{D}_gqa_g{g}", (2, 65, 201, 2 * g, 2, D),
                            bf16, window=24, q_start=80)
    # rows split over several CTAs, with a window that skips whole tiles
    check_attention("bf16_split_window", (1, 600, 700, 8, 8, 128), bf16,
                    window=40, softcap=20.0)
    llada_mask = get_config("llada-8b").mask_token_id
    dream_mask = get_config("dream-7b").mask_token_id
    for dtype in (bf16, f32):
        tag = "bf16" if dtype == bf16 else "f32"
        rec = check_confidence(f"llada8b_head_{tag}", 128, 126464, dtype,
                               mask_id=llada_mask, timed=True)
        if dtype == bf16:
            conf = rec                  # the main path's form
        check_confidence(f"dream7b_head_{tag}", 128, 152064, dtype,
                         mask_id=dream_mask, timed=True)
        check_confidence(f"llada8b_ties_{tag}", 128, 126464, dtype,
                         mask_id=llada_mask, ties=True)
        check_confidence(f"rows32_ties_{tag}", 32, 126464, dtype,
                         mask_id=llada_mask, ties=True)
        check_confidence(f"rows1_{tag}", 1, 126464, dtype,
                         mask_id=llada_mask)
        check_confidence(f"ragged_v_ties_{tag}", 128, 50257, dtype,
                         mask_id=50256, ties=True)
        check_confidence(f"ragged_v_mid_ban_{tag}", 128, 50257, dtype,
                         mask_id=25000, ties=True)
        check_confidence(f"small_unaligned_{tag}", 8, 1001, dtype,
                         mask_id=2, ties=True)
        check_confidence(f"no_ban_{tag}", 64, 4099, dtype, ties=True)
    confidence_scaling(llada_mask)
    check_head_path(llada_mask)     # llada-8b: d = 4096, V = 126464
    return step, conf


# ------------------------------------------------------------------ model

def phase_reference():
    """tiny (float32) through the kernels on the card vs the plain path
    on the CPU, from the same weights."""

    cfg = get_config("tiny")
    cpu = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    gpu = params_to(cpu, "cuda")
    rng = np.random.default_rng(SEED)
    B, S, P = 2, 24, 40
    toks = torch.from_numpy(rng.integers(0, 300, (B, S)).astype(np.int32))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    errs = {}
    for mode in ("encode", "step"):
        outs = []
        for params, dev, uk in ((cpu, "cpu", False), (gpu, "cuda", True)):
            cache = init_cache(cfg, B, P, dev)
            kw = {}
            if mode == "step":
                apply_model(cfg, params, tokens=toks.to(dev),
                            positions=pos.to(dev), cache=cache,
                            use_kernels=uk)
                kw = dict(kv_valid=torch.full((B,), 20, dtype=torch.int32,
                                              device=dev))
            out = apply_model(cfg, params, tokens=toks.to(dev),
                              positions=(pos + 20).to(dev), mode=mode,
                              cache=cache, use_kernels=uk, **kw)
            outs.append(out.logits.cpu())
        errs[mode] = (outs[0] - outs[1]).abs().max().item()
    prompt = rng.integers(0, 200, (2, 10)).astype(np.int32)
    d = DecodeConfig(method="streaming", gen_len=32, block_size=8, window=8,
                     tau0=0.5, use_kernels=False)
    r_cpu = DiffusionDecoder(cfg, cpu, d, device="cpu").generate(prompt)
    r_gpu = DiffusionDecoder(cfg, gpu, dataclasses.replace(
        d, use_kernels=True), device="cuda").generate(prompt)
    agree = float((r_cpu.tokens == r_gpu.tokens).mean())
    ok = (max(errs.values()) <= 1e-4 and agree == 1.0
          and r_cpu.steps_per_block == r_gpu.steps_per_block)
    emit({"phase": "reference", "arch": "tiny", "logits_max_abs_err": errs,
          "tol": 1e-4, "decode_token_agreement": agree,
          "steps_per_block": [r_cpu.steps_per_block, r_gpu.steps_per_block],
          "ok": ok})
    if not ok:
        raise AssertionError("tiny on the card disagrees with the CPU path")


LLADA_REF_TOL = 2e-2


def phase_reference_llada():
    """llada-8b at full width, cut to 2 layers, bf16 with seeded random
    weights: one refresh pass (encode of the 384-token buffer into the
    cache) and one denoise step (129 query tokens over the cache valid
    to 256, Skv = 513: the serve shapes) through the kernels, against the
    same passes through ``attend_ref`` on the card.

    Tolerance: ``attend_ref`` is the JAX package's bf16 reference path:
    it rounds q*scale and the softmax probabilities to bf16 before its
    products, where the kernel keeps f32 and rounds only its output. The
    attention outputs so differ at bf16 resolution (2^-8 relative), and
    through two layers and the LM head the logits may differ by a few
    bf16 steps of their own scale: max |d logits| <= 2e-2 * max |logits|.
    """
    cfg = get_config("llada-8b", dtype="bfloat16", param_dtype="bfloat16",
                     n_layers=2, reps=0)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 1), "cuda")
    T = PROMPT_LEN + GEN_LEN
    Sq = BLOCK + WINDOW + 1
    mid = PROMPT_LEN + (GEN_LEN // BLOCK // 2) * BLOCK
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size - 2,
                                         (N_PROMPTS, T)).astype(np.int32))
    toks = toks.cuda()
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None].expand(
        N_PROMPTS, T)
    step_toks = toks[:, mid - Sq // 2:mid - Sq // 2 + Sq]
    step_pos = (mid + torch.arange(Sq, dtype=torch.int32, device="cuda"))
    step_pos = step_pos[None].expand(N_PROMPTS, Sq)
    logits, launches = {}, {}
    for uk in (True, False):
        cache = init_cache(cfg, N_PROMPTS, T, "cuda")
        ops.reset_launches()
        refresh = apply_model(cfg, params, tokens=toks, positions=pos,
                              cache=cache, use_kernels=uk)
        step = apply_model(cfg, params, tokens=step_toks,
                           positions=step_pos, mode="step", cache=cache,
                           kv_valid=torch.full((N_PROMPTS,), mid,
                                               dtype=torch.int32,
                                               device="cuda"),
                           use_kernels=uk)
        torch.cuda.synchronize()
        launches[uk] = ops.LAUNCHES["block_attention"]
        logits[uk] = {"refresh": refresh.logits, "step": step.logits}
    rec = {"phase": "reference", "arch": "llada-8b", "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "bfloat16",
           "shapes": {"refresh_S": T, "step_Sq": Sq, "step_Skv": T + Sq,
                      "cache_valid": mid},
           "kernel_launches": launches[True], "tol_rel_to_max": LLADA_REF_TOL}
    ok = launches[True] == 2 * cfg.n_layers and launches[False] == 0
    for name in ("refresh", "step"):
        got, want = logits[True][name], logits[False][name]
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        rec[name] = {"logits_max_abs_err": err, "logits_max_abs": scale,
                     "rel_to_max": err / scale, "argmax_agreement": agree,
                     "finite": bool(torch.isfinite(got).all())}
        ok = ok and rec[name]["finite"] and err <= LLADA_REF_TOL * scale
    rec["ok"] = ok
    emit(rec)
    del params
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("llada-8b bf16 through the kernels disagrees "
                             "with attend_ref on the card")


def make_prompts(n, seed):
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz .,0123456789"))
    return ["".join(rng.choice(alphabet, PROMPT_LEN)) for _ in range(n)]


def phase_serve():

    cfg = get_config("llada-8b", dtype="bfloat16", param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    dcfg = DecodeConfig(method="streaming", gen_len=GEN_LEN, block_size=BLOCK,
                        window=WINDOW, use_kernels=True)
    eng = ServingEngine(cfg, params, dcfg, mode="batch", device="cuda")
    prompts = make_prompts(N_PROMPTS, SEED)
    for p in prompts:
        eng.submit(p, max_tokens=GEN_LEN)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t1 = time.perf_counter()
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    res = eng.results[0]
    confs = np.concatenate([s.commit_conf.ravel() for s in res.block_stats])
    n_blocks = len(res.steps_per_block)
    rec = {"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "method": dcfg.method,
           "requests": len(done), "prompt_len": PROMPT_LEN,
           "gen_len": GEN_LEN, "block_size": BLOCK, "window": WINDOW,
           "nfe": res.nfe, "steps_per_block": res.steps_per_block,
           "tokens_generated": res.tokens_generated, "wall_s": wall,
           "tok_s": res.tokens_generated / wall,
           "host_syncs": res.host_syncs, "init_s": t_init,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_block": {k: v / n_blocks for k, v in launches.items()},
           "no_mask_left": bool((res.tokens != cfg.mask_token_id).all()),
           "conf_finite": bool(np.isfinite(confs).all()),
           "completion_lens": [len(c.tokens) for c in done]}
    rec["ok"] = (len(done) == N_PROMPTS and rec["no_mask_left"]
                 and rec["conf_finite"]
                 and all(c.tokens.shape == (GEN_LEN,) for c in done)
                 and all(v > 0 for v in launches.values()))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("serve phase failed its checks")
    return cfg, params, dcfg, rec


def phase_profile(cfg, params, dcfg):
    """Where a main-path block's time goes: the middle block of the same
    llada-8b streaming decode, once timed without the profiler (host
    clock to a synchronize) and once, from an identical copy of the
    state, under torch.profiler for device time by kernel. Idle share =
    1 - kernel time / unprofiled wall."""

    dec = DiffusionDecoder(cfg, params, dcfg, device="cuda")
    tok = ByteTokenizer(cfg.vocab_size)
    prompts = np.stack([tok.encode(p) for p in make_prompts(N_PROMPTS, SEED)])
    state = dec.prefill(prompts.astype(np.int32))
    mid = GEN_LEN // BLOCK // 2
    while state.block_idx < mid:
        dec.decode_block(state)
    twin = copy.deepcopy(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.decode_block(state)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.decode_block(twin)
        torch.cuda.synchronize()
    groups = {"matmul": 0.0, "block_attention": 0.0,
              "confidence_argmax": 0.0, "other": 0.0}
    kernels, host_ops = [], []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            host_ops.append((ev.self_cpu_time_total, ev.key, ev.count))
            continue
        us = ev.self_device_time_total
        name = ev.key
        if "block_attention" in name or "attn_" in name:
            groups["block_attention"] += us
        elif "conf_argmax" in name or "conf_kernel" in name:
            groups["confidence_argmax"] += us
        elif "gemm" in name or "nvjet" in name or "cutlass" in name:
            groups["matmul"] += us
        else:
            groups["other"] += us
        kernels.append((us, name, ev.count))
    kernels.sort(reverse=True)
    busy = sum(groups.values())
    steps = state.steps_per_block[-1]
    emit({"phase": "profile", "block": mid, "steps": steps,
          "wall_us": wall_us, "wall_us_per_step": wall_us / steps,
          "device_kernel_us": busy, "device_idle_share": 1 - busy / wall_us,
          "device_us_by_group": groups,
          "top": [{"name": k[:80], "device_us": us, "calls": c}
                  for us, k, c in kernels[:10]],
          "host_op_calls": sum(c for _, _, c in host_ops),
          "host_top": [{"name": k[:60], "self_cpu_us": us, "calls": c}
                       for us, k, c in sorted(host_ops, reverse=True)[:10]]})


# ------------------------------------------------------------------ main

def ptxas_report(log: str):
    """Per kernel instantiation: registers, spills, static shared memory,
    from nvcc's ``-Xptxas -v`` output."""
    funcs = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            short = re.search(r"((?:attn|conf)_\w+?_kernel)I(.*?)EEv",
                              name)
            funcs.append({"kernel": short.group(1) + "<" + short.group(2)
                          + ">" if short else name, "registers": None,
                          "spill_stores": 0, "spill_loads": 0,
                          "smem_static": 0})
            continue
        if not funcs:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            funcs[-1]["spill_stores"] = int(m.group(1))
            funcs[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            funcs[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            funcs[-1]["smem_static"] = int(sm.group(1)) if sm else 0
    return funcs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    # one nvcc per library, all started together: the port's two kernel
    # libraries and the two probe builds of the attention kernel
    jobs = [("block_attention", ()), ("confidence", ()),
            ("block_attention", ("ATTN_PROBE=1",)),
            ("block_attention", ("ATTN_PROBE=2",)),
            ("confidence", ("CONF_PROBE=1",)),
            ("confidence", ("CONF_PROBE=2",))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: build.compile_library(*j), jobs))
    build.load("block_attention")
    build.load("confidence")
    t_nvcc = time.perf_counter() - t0
    confidence.triton_kernel()
    import triton
    ptxas = [f for lib in libs[:2]
             for f in ptxas_report(lib.with_suffix(".log").read_text())]
    emit({"phase": "build", "nvcc_s": t_nvcc,
          "libraries": [os.path.relpath(lib, ROOT) for lib in libs[:2]],
          "ptxas": ptxas,
          "spills": any(f["spill_stores"] or f["spill_loads"] for f in ptxas),
          "triton": triton.__version__})

    step, conf = phase_kernels()
    phase_probe()
    phase_reference()
    phase_reference_llada()
    *model, serve = phase_serve()
    phase_profile(*model)

    kernels = [
        {"name": "block_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/block_attention.cu",
         "replaces": "src/repro/kernels/block_attention.py:109",
         "launches": serve["launches"]["block_attention"],
         "max_abs_err": step["max_abs_err"], "ms": step["kernel_ms"],
         "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
         "bound_by": step["bound_by"], "library_ms": step["library_ms"]},
        {"name": "confidence_argmax", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/confidence.cu",
         "replaces": "src/repro/kernels/confidence.py:70",
         "launches": serve["launches"]["confidence_argmax"],
         "max_abs_err": conf["max_abs_err"], "ms": conf["kernel_ms"],
         "plain_ms": conf["plain_ms"], "bound_ms": conf["bound_ms"],
         "bound_by": conf["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
