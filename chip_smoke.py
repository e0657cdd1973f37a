#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package. Phases, each printing JSON lines:

1. device   — card name and power limit (nvidia-smi), torch/CUDA versions.
2. build    — builds the CUDA sources of ``src/repro_torch/kernels/csrc``
              with nvcc (the port's kernel libraries: attention,
              confidence, the GEMM and the CUDA-graph block loop, two
              probe builds of each of the first two and one of the GEMM,
              in parallel; ptxas
              registers and spills per kernel; from ``cuobjdump -sass``
              each kernel's HGMMA, UTMALDG and HMMA counts: the bf16 GEMM
              must use wgmma and TMA and no mma.sync).
3. kernels  — each kernel against its plain PyTorch version on the card at
              the main path's shapes and at small edge cases, with its
              time, the plain version's, the library call's and the bound;
              at the timed shapes also the first port's simple attention
              kernel, in turns with the new one; the confidence kernel as
              its rows grow from 32 to 512; then the LM-head path of a
              denoise step as a unit, against the plain route; then the
              GEMM at every product of a llada-8b denoise step at
              B = 1..8, at a refresh and at the LM head, against its
              plain version, cuBLAS and its bound, with its tile plan
              (tile, stages, CTAs, waves on the card's SMs).
4. probe    — the GEMM against its probe build (its load path alone)
              at a step's products and the head; the bf16 attention
              kernel against its load path alone and its math alone, at
              the timed shapes.
5. reference — ``tiny`` (float32) on the card through the kernels against
              the plain path on the CPU: model logits and decode tokens;
              then llada-8b at full width, 2 layers, bf16, through the
              kernels against ``attend_ref`` on the card.
6. invariance — the same row at B = 1..8 (first and last in its batch),
              llada-8b at full width cut to 2 layers, bf16: bit for bit
              after every attention and FFN, in the head logits and the
              confidence kernel's outputs, and in whole decodes at
              B = 1..4; any difference fails the run.
7. methods  — llada-8b at full width cut to 2 layers (bf16, random
              weights), gen_len 64: every method and frozen_suffix on the
              CUDA-graph block loop against the per-step host loop:
              identical tokens and counters (a near-tie at the flipped
              position is printed and excused), one host sync per block.
8. serve    — ``ServingEngine`` in batch mode, llada-8b at full width and
              depth (bf16, random weights from a seed), streaming decode
              of 4 prompts: an untimed run captures the block graphs, the
              timed run replays them (launch counters read around it
              only), and the host loop on the same prompts must give the
              same tokens and counters.
9. profile  — the middle block of that decode through its graph: wall
              time without the profiler, device time by kernel under it,
              idle share, and the blocking syncs inside the block; the
              same block through the host loop for comparison, with the
              host's cost per eager launch (a tensor-map encode, the
              GEMM's launch and wrapper, a PyTorch elementwise op).
10. continuous — ``ContinuousEngine`` at llada-8b full width and depth on
              the serve phase's weights: prewarm, then a scripted mix of
              arrivals, a preempt and a cancel, timed, with gangs of
              several sizes that compact and merge; against the same
              script through the host loop and against each request
              decoded alone (``phase_continuous``, ``continuous_script``).
11. prefix_cache — the same model with the prefix cache: cold against
              warm prefill of prompts sharing a 192-token prefix, then two
              waves through ``ContinuousEngine`` at gang sizes 1, 2 and 4
              with a preempt and resume, each request equal to its cold
              decode bit for bit (``phase_prefix_cache``).

Then the kernels summary line (launches counted
on the continuous phase's timed run; the GEMM has no TPU kernel behind
it, and its line names the reference's XLA product it stands for), the nvidia-smi line and, last, the device
line ``{"ok": true, "device": {...}}``. Any failure raises: the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import schedule as sched  # noqa: E402
from repro_torch.core.decoder import (DecodeConfig,  # noqa: E402
                                      DiffusionDecoder)
from repro_torch.core.engine import ServingEngine  # noqa: E402
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.kernels import block_attention as kba  # noqa: E402
from repro_torch.kernels import build, confidence, gemm, ops, ref  # noqa: E402
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
    the plain version and the kernel's two probe builds."""

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
        # probes' outputs are garbage), on the same inputs. In turns:
        # port, others, others reversed, port.
        others = {"load_only": probe(1), "math_only": probe(2)}
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
    rows grow from 32 (a gang of one request) to 512. The split count
    does not depend on N (launch_plan), so the grid grows with N: 128
    CTAs at N = 32, 512 at N = 128. A least-squares line through
    (bytes, ms) gives the rate the kernel streams at (its slope) and its
    cost that does not grow with the bytes (its intercept: launch,
    ramp-up, the rows' last-CTA merges)."""
    V, rows = 126464, []
    for N in (32, 64, 128, 256, 512):
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
    output with the ban), against the plain route (GEMM, float32 cast,
    ban, Eq. 4 in PyTorch) on the same inputs. Both routes graph-timed
    in turns, with the GEMM alone and the GEMM's own bound (the head's
    bytes) beside them."""
    B, K = N_PROMPTS, BLOCK
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    hidden = torch.randn((B, K, d), generator=g, device="cuda").to(
        torch.bfloat16)
    head = (torch.randn((d, V), generator=g, device="cuda")
            / math.sqrt(d)).to(torch.bfloat16)
    h2 = hidden.reshape(-1, d)

    def new():
        return ops.head_confidence_argmax(hidden, head, mask_id=mask_id)

    def plain():
        return sched.head_confidence_and_tokens(hidden, head,
                                                mask_id=mask_id)

    def gemm():
        return h2 @ head

    c_new, i_new = new()
    c_pl, i_pl = plain()
    torch.cuda.synchronize()
    err = (c_new - c_pl).abs().max().item()
    idx_ok = bool((i_new == i_pl).all())
    ok = idx_ok and err <= 1e-5
    t_new, t_prev = time_ms(new, [()]), time_ms(plain, [()])
    t_prev2, t_new2 = time_ms(plain, [()]), time_ms(new, [()])
    t_gemm = time_ms(gemm, [()])
    t_bytes = (nbytes(hidden, head) + B * K * 8) / HBM_BYTES_S
    t_ops = 2 * B * K * d * V / PEAK_OPS_S["bfloat16"]
    rec = {"phase": "kernels", "kernel": "head_path", "case": "llada8b_step",
           "shape": {"rows": B * K, "d": d, "V": V}, "mask_id": mask_id,
           "max_abs_err": err, "tol": 1e-5, "idx_exact": idx_ok,
           "new_ms": (t_new + t_new2) / 2,
           "plain_ms": (t_prev + t_prev2) / 2,
           "new_ms_turns": [t_new, t_new2],
           "plain_ms_turns": [t_prev, t_prev2], "gemm_ms": t_gemm,
           "gemm_bound_ms": 1e3 * max(t_bytes, t_ops),
           "gemm_bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "ok": ok}
    emit(rec)
    del head
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"head path: err {err}, idx exact {idx_ok}")
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


# ------------------------------------------------------------------ GEMM

# llada-8b's products per layer of a pass, as (name, K, N, count): q, k, v
# and o; gate and up; down. The LM head is (4096, 126464), once a step.
LLADA_PRODUCTS = (("qkvo", 4096, 4096, 4), ("gate_up", 4096, 12288, 2),
                  ("down", 12288, 4096, 1))
LLADA_HEAD = (4096, 126464)


def bf16_ulp(v):
    """The spacing of bfloat16 numbers at |v| (8 significant bits)."""
    e = torch.frexp(v.abs().float())[1]
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def gemm_close(y, x, w):
    """(ok, max |y - ref|) of the kernel's y against the plain float32
    product ``ref``. float32: max |y - ref| <= 2e-5 * max |ref| (another
    summation order). bfloat16: within one bf16 ulp of ref rounded to
    bf16, the ulp taken at the larger of |ref| and 2^-10 * max |ref| (a
    sum that cancels to nearly 0 is held to its terms' float32 order
    error, not to the spacing at 0)."""
    want = ref.gemm_ref(x, w).float()
    full = x.float() @ w.float()
    err = (y.float() - full).abs().max().item()
    scale = full.abs().max()
    if y.dtype == torch.float32:
        return bool(err <= 2e-5 * scale.item()), err
    tol = bf16_ulp(torch.maximum(full.abs(), scale * 2.0 ** -10))
    return bool(((y.float() - want).abs() <= tol).all()), err


def gemm_bound(M, K, N, dtype):
    """The least time for (M, K) @ (K, N): x and W read once, y written
    once, against 2 M K N operations at the dense peak of ``dtype``."""
    es = torch.empty((), dtype=dtype).element_size()
    t_bytes = (M * K + K * N + M * N) * es / HBM_BYTES_S
    t_ops = 2 * M * K * N / PEAK_OPS_S[str(dtype).split(".")[-1]]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def check_gemm(name, M, K, N, dtype=torch.bfloat16, *, plain=False):
    """The GEMM kernel through ``ops.gemm`` against its plain version on
    the same inputs (``gemm_close``), then device time beside one
    ``torch.matmul`` (cuBLAS, the library call; the port never makes it),
    in turns (kernel, library, library, kernel), on inputs cycled past
    the L2, and the bound; ``plain`` also times the plain version."""

    def make(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return (torch.randn((M, K), generator=g, device="cuda").to(dtype),
                (torch.randn((K, N), generator=g, device="cuda")
                 / math.sqrt(K)).to(dtype))

    x, w = make(0)
    y = ops.gemm(x, w)
    torch.cuda.synchronize()
    ok, err = gemm_close(y, x, w)
    sets = [make(s) for s in range(n_copies(nbytes(x, w)))]
    t_k, t_l = time_ms(ops.gemm, sets), time_ms(torch.matmul, sets)
    t_l2, t_k2 = time_ms(torch.matmul, sets), time_ms(ops.gemm, sets)
    bound, by = gemm_bound(M, K, N, dtype)
    plan = gemm.launch_plan(N, K, dtype)
    ctas = math.prod(plan.grid(M))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rec = {"phase": "kernels", "kernel": "gemm", "route": "cuda",
           "case": name, "shape": {"M": M, "K": K, "N": N},
           "dtype": str(dtype).split(".")[-1],
           "plan": {"block": [plan.block_m, plan.block_n, plan.block_k],
                    "stages": plan.stages, "ctas": ctas,
                    "smem_bytes": plan.smem_bytes,
                    # bf16: one CTA per SM at a time (its ring fills the SM)
                    "waves": ctas / sms if plan.tma else None},
           "max_abs_err": err, "ok": ok,
           "kernel_ms": (t_k + t_k2) / 2, "library_ms": (t_l + t_l2) / 2,
           "kernel_ms_turns": [t_k, t_k2], "library_ms_turns": [t_l, t_l2],
           "bound_ms": bound, "bound_by": by}
    rec["bound_share"] = bound / rec["kernel_ms"]
    if plain:
        rec["plain_ms"] = time_ms(ref.gemm_ref, sets)
    emit(rec)
    del sets
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"gemm {name}: kernel disagrees with plain "
                             f"(max err {err})")
    return rec


def phase_gemm():
    """The GEMM kernel at the main path's shapes (llada-8b, bf16): each
    product of a denoise step (Sq = 129 rows a request) at B = 1..8, the
    same products at a middle block's refresh (B = 4, prefix 256 + 129),
    and the LM head of a step (32 rows a request) at B = 1 and 4; then
    float32 (the ``tiny`` config's route) at a small shape. Per B, the
    step's 32 layers of products summed: kernel, cuBLAS and bound."""
    layers = get_config("llada-8b").n_layers
    for B in range(1, 9):
        tot = {"kernel_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for name, K, N, count in LLADA_PRODUCTS:
            rec = check_gemm(f"step_B{B}_{name}", 129 * B, K, N,
                             plain=(B == 4 and name == "gate_up"))
            if B == 4 and name == "gate_up":
                main = rec
            for k in tot:
                tot[k] += layers * count * rec[k]
        emit({"phase": "kernels", "kernel": "gemm", "case": f"step_B{B}",
              "per_step_all_layers": tot, "layers": layers})
    for name, K, N, _ in LLADA_PRODUCTS:
        check_gemm(f"refresh_B4_{name}", 4 * (256 + 129), K, N)
    for B in (1, 4):
        check_gemm(f"head_B{B}", 32 * B, *LLADA_HEAD)
    check_gemm("f32_tiny_ffn", 2 * 13, 256, 768, torch.float32)
    check_gemm("f32_ragged", 37, 72, 40, torch.float32)
    check_gemm("bf16_ragged", 37, 72, 40)
    return main


def phase_gemm_probe():
    """Where the GEMM's time goes: the kernel against its probe build
    (``GEMM_PROBE=1`` in csrc/gemm.cu: the TMA load path alone, the
    consumers releasing each stage without their wgmmas; its output is
    garbage), in turns on the same inputs (kernel, probe, kernel, probe):
    a step's products at B = 1, 4 and 8 and the LM head at B = 4."""
    probe = gemm.load_probe()
    cases = [(f"step_B{B}_{name}", 129 * B, K, N)
             for B in (1, 4, 8) for name, K, N, _ in LLADA_PRODUCTS]
    cases.append(("head_B4", 32 * 4, *LLADA_HEAD))
    for name, M, K, N in cases:
        sets = []
        for seed in range(n_copies((M * K + K * N) * 2)):
            g = torch.Generator(device="cuda").manual_seed(seed)
            sets.append((torch.randn((M, K), generator=g, device="cuda").to(
                torch.bfloat16), (torch.randn((K, N), generator=g,
                                              device="cuda")
                                  / math.sqrt(K)).to(torch.bfloat16)))
        y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")

        def timed(lib):
            return time_ms(lambda x, w: gemm.launch(x, w, y, lib=lib), sets)

        turns = [timed(None), timed(probe), timed(None), timed(probe)]
        emit({"phase": "gemm_probe", "case": name,
              "shape": {"M": M, "K": K, "N": N},
              "kernel_ms": (turns[0] + turns[2]) / 2,
              "load_only_ms": (turns[1] + turns[3]) / 2, "turns": turns})
        del sets
        torch.cuda.empty_cache()


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


def phase_invariance(prompts):
    """Batch invariance on the card, held bit for bit (it raises on any
    difference): llada-8b at full width cut to 2 layers, bf16, through
    the kernels. For a refresh pass (encode of the whole 384-token
    buffer) and a denoise step (Sq = 129 over the cache valid to a middle
    block start), a reference row at B = 1 against the same row at slot 0
    and at slot B - 1 of a batch of B = 2..8 (the other rows random):
    every attention and FFN output, the head logits of the block (the
    GEMM's bf16 output) and the confidence kernel's conf/idx on them.
    Then the confidence kernel alone: the same rows reduced as N = 1, 32
    and 128. Then whole decodes (streaming, gen_len 64, the graph loop) of a
    prompt at B = 1..4, first and last in its batch: tokens and commit
    confidences."""
    from repro_torch.models import model as model_mod
    cfg = get_config("llada-8b", dtype="bfloat16", param_dtype="bfloat16",
                     n_layers=2, reps=0)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 4), "cuda")
    T, Sq = PROMPT_LEN + GEN_LEN, BLOCK + WINDOW + 1
    mid = PROMPT_LEN + (GEN_LEN // BLOCK // 2) * BLOCK
    rng = np.random.default_rng(SEED + 4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size - 2, (8, T))
                            .astype(np.int32)).cuda()
    qpos = (mid + torch.arange(Sq, dtype=torch.int32, device="cuda"))
    head = params["lm_head"]
    mask_id = cfg.mask_token_id
    seen = []
    orig = (model_mod.apply_attention, model_mod.apply_ffn)

    def rec_attn(*a, **kw):
        out = orig[0](*a, **kw)
        seen.append(("attn", out[0] if isinstance(out, tuple) else out))
        return out

    def rec_ffn(*a, **kw):
        out = orig[1](*a, **kw)
        seen.append(("ffn", out))
        return out

    def one_pass(B, kind, slot):
        """The named outputs of the reference row, sitting at ``slot``."""
        batch = toks[:B].clone()
        batch[slot] = toks[0]
        seen.clear()
        pos = torch.arange(T, dtype=torch.int32, device="cuda")[None]
        cache = init_cache(cfg, B, T, "cuda")
        out = apply_model(cfg, params, tokens=batch, positions=pos.expand(
            B, T), cache=cache, skip_head=True, use_kernels=True)
        blk = slice(mid, mid + BLOCK)
        if kind == "step":
            seen.clear()
            out = apply_model(cfg, params, tokens=batch[:, T - Sq:],
                              positions=qpos[None].expand(B, Sq),
                              mode="step", cache=cache,
                              kv_valid=torch.full((B,), mid, dtype=torch.int32,
                                                  device="cuda"),
                              skip_head=True, use_kernels=True)
            blk = slice(0, BLOCK)
        hid = out.logits[:, blk].reshape(-1, cfg.d_model)
        logits = ops.linear(hid, head)
        conf, idx = ops.confidence_argmax(logits, mask_id=mask_id)
        rows = slice(slot * BLOCK, (slot + 1) * BLOCK)
        got = {f"{n}{i // 2}": t[slot].clone()
               for i, (n, t) in enumerate(seen)}
        got["head_logits"] = logits[rows].clone()
        got["conf"], got["idx"] = conf[rows].clone(), idx[rows].clone()
        return got

    model_mod.apply_attention, model_mod.apply_ffn = rec_attn, rec_ffn
    rec = {"phase": "invariance", "arch": "llada-8b", "layers": 2,
           "cut": "n_layers 32 -> 2", "batch_sizes": list(range(1, 9))}
    ok = True
    try:
        with torch.no_grad():
            for kind in ("refresh", "step"):
                want = one_pass(1, kind, 0)
                diff = {k: 0.0 for k in want}
                equal = {k: True for k in want}
                for B in range(2, 9):
                    for slot in (0, B - 1):
                        got = one_pass(B, kind, slot)
                        for k, v in want.items():
                            equal[k] &= bool(torch.equal(got[k], v))
                            diff[k] = max(diff[k], (got[k].float() - v.float())
                                          .abs().max().item())
                rec[kind] = {k: {"bit_equal": equal[k],
                                 "max_abs_diff": diff[k]} for k in want}
                ok = ok and all(equal.values())
    finally:
        model_mod.apply_attention, model_mod.apply_ffn = orig
    # the confidence kernel alone: the same rows reduced as N = 1, 32, 128
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x = (torch.randn((128, 126464), generator=g, device="cuda") * 4).to(
        torch.bfloat16)
    c128, i128 = ops.confidence_argmax(x, mask_id=mask_id)
    c32, i32 = ops.confidence_argmax(x[:32].contiguous(), mask_id=mask_id)
    c1, i1 = ops.confidence_argmax(x[:1].contiguous(), mask_id=mask_id)
    rec["confidence_kernel"] = {
        "splits": {N: confidence.launch_plan(N, 126464, torch.bfloat16)
                   .splits for N in (1, 32, 128)},
        "bit_equal_32_vs_128": bool(torch.equal(c32, c128[:32])
                                    and torch.equal(i32, i128[:32])),
        "bit_equal_1_vs_128": bool(torch.equal(c1, c128[:1])
                                   and torch.equal(i1, i128[:1]))}
    ok = (ok and rec["confidence_kernel"]["bit_equal_32_vs_128"]
          and rec["confidence_kernel"]["bit_equal_1_vs_128"])
    dcfg = DecodeConfig(method="streaming", gen_len=64, block_size=BLOCK,
                        window=WINDOW, use_kernels=True)
    dec = DiffusionDecoder(cfg, params, dcfg, device="cuda")
    runs = {}
    for B in (1, 2, 3, 4):
        for slot in sorted({0, B - 1}):
            order = [i for i in range(1, 4)][:B - 1]
            order.insert(slot, 0)
            r = dec.generate(prompts[order].copy())
            runs[(B, slot)] = (r.tokens[slot], np.concatenate(
                [s.commit_conf[slot] for s in r.block_stats]))
    base = runs[(1, 0)]
    rec["decode"] = {f"B{B}_slot{slot}": {
        "tokens_equal": bool((t == base[0]).all()),
        "commit_conf_bit_equal": bool((c == base[1]).all())}
        for (B, slot), (t, c) in runs.items()}
    ok = ok and all(v["tokens_equal"] and v["commit_conf_bit_equal"]
                    for v in rec["decode"].values())
    rec["batch_invariant"] = rec["ok"] = ok
    emit(rec)
    del dec, params
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("invariance phase: a row's bits change with "
                             "the batch on the card")
    return rec


def make_prompts(n, seed):
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz .,0123456789"))
    return ["".join(rng.choice(alphabet, PROMPT_LEN)) for _ in range(n)]


COUNTERS = ("nfe", "steps_per_block", "query_tokens_processed",
            "kv_tokens_attended", "early_exits")
NEAR_TIE = 1e-5


def compare_runs(graph, host, K):
    """Tokens and counters of a graph-loop run against a host-loop run.
    A token difference is excused only as a near-tie (ROADMAP: a top-2
    confidence gap or a |conf - tau| below 1e-5) at the decision that
    flipped: at the first position where the runs differ, the graph
    run's commit confidence lies within 1e-5 of another commit
    confidence of that row and block (the ranking that picked it). The
    dynamic tau of that step is not in the result, so a flip at the
    threshold is not excused."""
    rec = {"tokens_identical": bool((graph.tokens == host.tokens).all()),
           "counters_identical": all(getattr(graph, c) == getattr(host, c)
                                     for c in COUNTERS),
           "token_agreement": float((graph.tokens == host.tokens).mean())}
    rec["near_tie"] = None
    if not rec["tokens_identical"]:
        diff = np.argwhere(graph.tokens != host.tokens)
        row, pos = (int(v) for v in diff[np.argmin(diff[:, 1])])
        blk = pos // K
        conf = graph.block_stats[blk].commit_conf[row]
        at = conf[pos % K]
        gap = float(np.abs(np.delete(conf, pos % K) - at).min())
        rec["near_tie"] = {"row": row, "position": pos, "block": blk,
                           "gap": gap, "is_near_tie": gap < NEAR_TIE}
        print(json.dumps({"phase": "near_tie", **rec["near_tie"]}),
              flush=True)
    rec["ok"] = rec["counters_identical"] and (
        rec["tokens_identical"] or rec["near_tie"]["is_near_tie"])
    return rec


def phase_methods(prompts):
    """Every method (and frozen_suffix) on llada-8b at full width, cut to
    2 layers, bf16, gen_len 64: the graph loop against the host loop."""
    cfg = get_config("llada-8b", dtype="bfloat16", param_dtype="bfloat16",
                     n_layers=2, reps=0)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED + 3), "cuda")
    ok = True
    for method, kw in (("vanilla", {}), ("dkv", {}), ("prefix", {}),
                       ("fast", {}), ("streaming", {}),
                       ("streaming", {"frozen_suffix": True})):
        dcfg = DecodeConfig(method=method, gen_len=64, block_size=BLOCK,
                            window=WINDOW, use_kernels=True, **kw)
        dec = DiffusionDecoder(cfg, params, dcfg, device="cuda")
        t0 = time.perf_counter()
        graph = dec.generate(prompts.copy())
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        ops.reset_launches()
        t0 = time.perf_counter()
        again = dec.generate(prompts.copy())
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        hdec = DiffusionDecoder(cfg, params, dataclasses.replace(
            dcfg, fused=False), device="cuda")
        ops.reset_launches()
        t0 = time.perf_counter()
        host = hdec.generate(prompts.copy())
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        n_blocks = len(graph.steps_per_block)
        rec = {"phase": "methods", "arch": "llada-8b", "layers": 2,
               "cut": "n_layers 32 -> 2", "method": method,
               "frozen_suffix": bool(kw), "gen_len": 64, "nfe": graph.nfe,
               "steps_per_block": graph.steps_per_block,
               "graphs": dec.graph_cache_size(),
               "capture_s": dec.capture_time, "first_run_s": first_s,
               "graph_s": graph_s, "host_s": host_s,
               "host_syncs": [graph.host_syncs, host.host_syncs],
               "logit_syncs": [graph.logit_syncs, host.logit_syncs],
               "launches": [launches, dict(ops.LAUNCHES)],
               "repeat_identical": bool((graph.tokens == again.tokens).all()),
               **compare_runs(again, host, BLOCK)}
        rec["one_sync_per_block"] = (again.host_syncs
                                     == n_blocks + (method == "dkv"))
        rec["ok"] = (rec["ok"] and rec["one_sync_per_block"]
                     and rec["repeat_identical"]
                     and rec["launches"][0] == rec["launches"][1])
        emit(rec)
        ok = ok and rec["ok"]
        del dec, hdec
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("methods phase: graph loop != host loop")


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
    # untimed: the first run captures one graph per block
    for p in prompts:
        eng.submit(p, max_tokens=GEN_LEN)
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    dec = eng._decoder(GEN_LEN)
    capture_s, graphs = dec.capture_time, dec.graph_cache_size()
    for p in prompts:
        eng.submit(p, max_tokens=GEN_LEN)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t1 = time.perf_counter()
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    res = eng.results[-1]
    # the host loop on the same prompts
    tokens = np.stack([eng.tok.encode(p) for p in prompts]).astype(np.int32)
    hdec = DiffusionDecoder(cfg, params, dataclasses.replace(dcfg, fused=False),
                            device="cuda")
    ops.reset_launches()
    t2 = time.perf_counter()
    host = hdec.generate(tokens)
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t2
    host_launches = dict(ops.LAUNCHES)
    confs = np.concatenate([s.commit_conf.ravel() for s in res.block_stats])
    n_blocks = len(res.steps_per_block)
    rec = {"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "method": dcfg.method,
           "requests": len(done), "prompt_len": PROMPT_LEN,
           "gen_len": GEN_LEN, "block_size": BLOCK, "window": WINDOW,
           "nfe": res.nfe, "steps_per_block": res.steps_per_block,
           "tokens_generated": res.tokens_generated, "wall_s": wall,
           "tok_s": res.tokens_generated / wall,
           "host_syncs": res.host_syncs,
           "host_syncs_per_block": res.host_syncs / n_blocks,
           "graphs": graphs, "capture_s": capture_s, "warm_run_s": warm_s,
           "graph_nodes": [p.graph.nodes() for p in dec._programs.values()],
           "init_s": t_init,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_block": {k: v / n_blocks for k, v in launches.items()},
           "host_loop": {"wall_s": host_wall,
                         "tok_s": host.tokens_generated / host_wall,
                         "host_syncs": host.host_syncs,
                         "launches": host_launches},
           "vs_host_loop": compare_runs(res, host, BLOCK),
           "no_mask_left": bool((res.tokens != cfg.mask_token_id).all()),
           "conf_finite": bool(np.isfinite(confs).all()),
           "completion_lens": [len(c.tokens) for c in done]}
    rec["ok"] = (len(done) == N_PROMPTS and rec["no_mask_left"]
                 and rec["conf_finite"]
                 and rec["host_syncs_per_block"] == 1.0
                 and rec["vs_host_loop"]["ok"]
                 and launches == host_launches
                 and all(c.tokens.shape == (GEN_LEN,) for c in done)
                 and all(v > 0 for v in launches.values()))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("serve phase failed its checks")
    return cfg, dec, hdec, tokens, rec


# ------------------------------------------------------------ continuous

MAX_SLOTS, MAX_GANG = 8, 4
SHORT = 96                     # the second gen_len bucket (3 blocks)
# the script's requests: name -> (prompt index, max_tokens)
SCRIPT = {"A0": (0, GEN_LEN), "A1": (1, GEN_LEN), "A2": (2, GEN_LEN),
          "A3": (3, GEN_LEN), "B0": (4, SHORT), "B1": (5, SHORT),
          "C0": (6, GEN_LEN), "C1": (7, GEN_LEN), "C2": (8, GEN_LEN)}
# PR 15's continuous phase on the same script less C2, every gang at one
# size (chip call 4 of PR 15, H100 80GB HBM3, 700 W)
PR15_CONTINUOUS = {"tok_s": 154.6, "mean_occupancy": 0.629,
                   "ttfb_p50_s": 0.907}


def continuous_script(eng, prompts):
    """The continuous phase's submission script, one tick at a time.
    Tick 0: A0-A3 (256 tokens) and B0, B1 (96 tokens, a second bucket and
    decoder) are submitted; admission makes gang G1 = A0-A3 (B = 4) and
    gang G2 = B0, B1 (B = 2). After tick 1: preempt A1 (extracted at tick
    2's block boundary, at block 3: G1 compacts to B = 3). G2 ends at
    tick 2; A1 comes back at once (backfill), as its own gang (B = 1) at
    block 3. After tick 2: submit C0-C2 (256 tokens). Tick 3: A1's gang
    and G1 sit at the same (bucket, block 3) and merge (cross-gang merge,
    B = 4); the free slots admit C0-C2 (backfill, B = 3). After tick 3:
    cancel A2 (released at tick 4's block boundary: the merged gang
    compacts to B = 3), so two live gangs of one (B, T) run at different
    blocks (4 and 1). Returns (trace, completions, uids): the trace holds
    (batch, total length, next block, lane uids) of every gang after
    every tick."""
    uids = {}

    def submit(name):
        i, mt = SCRIPT[name]
        uids[name] = eng.submit(prompts[i], max_tokens=mt)

    for name in ("A0", "A1", "A2", "A3", "B0", "B1"):
        submit(name)
    trace, comps, tick = [], [], 0
    while not eng.scheduler.idle:
        comps += eng.step()
        trace.append([(g.batch, g.state.total_len, g.state.block_idx,
                       tuple(r.uid if r is not None else 0
                             for r in g.requests))
                      for g in eng.scheduler.gangs])
        if tick == 1:
            eng.preempt(uids["A1"])
        elif tick == 2:
            for name in ("C0", "C1", "C2"):
                submit(name)
        elif tick == 3:
            got = eng.cancel(uids["A2"])
            if got is not None:
                comps.append(got)
        tick += 1
    return trace, comps, uids


def phase_continuous(cfg, params, invariance):
    """``ContinuousEngine`` at llada-8b full width and depth (the serve
    phase's weights), streaming, gen_len 256 / block 32 / window 96,
    ``max_slots=8, max_gang=4``, driven by ``continuous_script``.

    Gang size: the decoder is batch-invariant on the card (the products
    run through the GEMM kernel; the invariance phase holds it bit for
    bit), so the scheduler's default forms gangs of every size, compacts
    them as rows leave and merges stragglers. The phase uses that
    default and checks it, beside PR 15's numbers at one gang size.

    First ``prewarm`` captures every (bucket, gang size, block) graph,
    then the script runs timed. Checks: no capture after prewarm; one
    host sync per gang block; no [MASK] in a completion and finite
    commit confidences; the cancelled request's partial completion; the
    preempted request resumed at the block it left; gangs of several
    sizes, a compaction and a merge; the same script through the host
    loop (``fused=False``) gives the same tokens, NFE, blocks,
    completion order and gangs tick by tick; every uncancelled request
    equals, token for token and in its commit confidences, a batch-mode
    decode of its prompt alone (B = 1); no near-tie is excused. Device
    idle share over the timed run is one minus the CUDA-event span of
    every ``decode_block`` call over the run's wall; host time of a graph
    replay is timed around the launch call, without the profiler."""
    from repro_torch.core import graph_loop
    from repro_torch.serving import ContinuousEngine
    from repro_torch.serving.metrics import percentile
    dcfg = DecodeConfig(method="streaming", gen_len=GEN_LEN, block_size=BLOCK,
                        window=WINDOW, use_kernels=True)
    prompts = make_prompts(len(SCRIPT), SEED + 7)
    tok = ByteTokenizer(cfg.vocab_size)

    def engine(d):
        return ContinuousEngine(cfg, params, d, max_slots=MAX_SLOTS,
                                max_gang=MAX_GANG, device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine(dcfg)
    mode = {"batch_multiple": eng.scheduler.batch_multiple,
            "decoder_batch_invariant": eng.scheduler.decoder_for(
                GEN_LEN).batch_invariant,
            "invariance_phase_found_invariant": invariance}
    print(json.dumps({"phase": "continuous_mode", **mode}), flush=True)
    t0 = time.perf_counter()
    warm = eng.prewarm([(PROMPT_LEN, GEN_LEN), (PROMPT_LEN, SHORT)])
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t0
    capture_s = sum(d.capture_time for d in eng.scheduler._decoders.values())

    # the timed run: events around every decode_block, host time of
    # every replay call; launch counters read around this run only
    spans, replay_s = [], []
    decode_block = DiffusionDecoder.decode_block
    replay = graph_loop.BlockGraph.replay

    def timed_block(self, state):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = decode_block(self, state)
        b.record()
        spans.append((a, b))
        return out

    def timed_replay(self):
        t = time.perf_counter()
        replay(self)
        replay_s.append(time.perf_counter() - t)

    DiffusionDecoder.decode_block = timed_block
    graph_loop.BlockGraph.replay = timed_replay
    try:
        ops.reset_launches()
        t1 = time.perf_counter()
        trace, comps, uids = continuous_script(eng, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(ops.LAUNCHES)
    finally:
        DiffusionDecoder.decode_block = decode_block
        graph_loop.BlockGraph.replay = replay
    busy = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    snap = eng.metrics.snapshot()
    lat = [r.latency_s for r in eng.metrics.requests]
    ttfb = [r.ttfb_s for r in eng.metrics.requests]
    by_uid = {c.uid: c for c in comps}
    name_of = {u: n for n, u in uids.items()}

    # the same script through the host loop
    heng = engine(dataclasses.replace(dcfg, fused=False))
    t2 = time.perf_counter()
    htrace, hcomps, _ = continuous_script(heng, prompts)
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t2

    def summary(cs):
        return [(c.uid, c.tokens.tolist(), c.nfe, c.n_blocks, c.cancelled)
                for c in cs]

    vs_host = {"trace_identical": trace == htrace,
               "completion_order_identical": [c.uid for c in comps]
               == [c.uid for c in hcomps],
               "requests_identical": summary(comps) == summary(hcomps)}

    # batch mode on the same prompts, each request alone (B = 1); the
    # wall includes the capture of its graphs
    beng = ServingEngine(cfg, params, dcfg, max_batch=1, mode="batch",
                         device="cuda")
    keep = [n for n in SCRIPT if not by_uid[uids[n]].cancelled]
    t3 = time.perf_counter()
    name_of_b = {beng.submit(prompts[SCRIPT[n][0]],
                             max_tokens=SCRIPT[n][1]): n for n in keep}
    batch = {}
    while True:
        got = beng.step()                     # one batch of one request
        if not got:
            break
        res = beng.results[-1]
        batch[name_of_b[got[0].uid]] = (got[0].tokens, np.concatenate(
            [bs.commit_conf[0] for bs in res.block_stats]))
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t3
    vs_batch = {n: bool(np.array_equal(by_uid[uids[n]].tokens, batch[n][0])
                        and np.array_equal(by_uid[uids[n]].commit_conf,
                                           batch[n][1]))
                for n in keep}

    a1, a2 = by_uid[uids["A1"]], by_uid[uids["A2"]]

    def two_shapes(t):
        blocks = {}
        for B, T, blk, _ in t:
            blocks.setdefault((B, T), set()).add(blk)
        return any(len(v) >= 2 for v in blocks.values())

    a0_sizes = [g[0] for t in trace for g in t if uids["A0"] in g[3]]
    gang_sizes = sorted({g[0] for t in trace for g in t})
    reached = {
        "merge": snap["gang_merges"] >= 1,
        "compaction": any(b < a for a, b in zip(a0_sizes, a0_sizes[1:])),
        "several_gang_sizes": len(gang_sizes) > 1,
        # A1 back in a gang of its own at the block its old gang is at
        "resumed_row": any(g[3][0] == uids["A1"] and not any(g[3][1:])
                           and any(h[2] == g[2] and uids["A0"] in h[3]
                                   for h in t)
                           for t in trace for g in t),
        "backfill": any(uids["C0"] in g[3] for t in trace for g in t),
        "two_live_gangs_one_shape_different_blocks": any(
            two_shapes(t) for t in trace)}
    rec = {"phase": "continuous", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "method": dcfg.method, **mode,
           "max_slots": MAX_SLOTS, "max_gang": MAX_GANG,
           "gang_sizes": gang_sizes, "pr15_one_gang_size": PR15_CONTINUOUS,
           "buckets": warm["buckets"], "prewarm_batch_sizes":
           warm["batch_sizes"], "graphs": eng.graph_cache_size(),
           "prewarm_s": prewarm_s, "capture_s": capture_s,
           "post_warm_captures": snap["post_warm_compiles"],
           "requests": snap["requests"], "tokens": snap["tokens"],
           "ticks": eng.metrics.ticks,
           "wall_s": wall, "tok_s": snap["tokens"] / wall,
           "ttfb_p50_s": percentile(ttfb, 50),
           "ttfb_p90_s": percentile(ttfb, 90),
           "latency_p50_s": percentile(lat, 50),
           "latency_p90_s": percentile(lat, 90),
           "mean_occupancy": snap["mean_occupancy"],
           "gang_merges": snap["gang_merges"],
           "gang_blocks": len(spans),
           "host_syncs_per_block": snap["host_syncs_per_block"],
           "pool": eng.pool.stats(),
           "peak_mem_gb": peak,
           "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
           "replay_host_ms": {"mean": 1e3 * float(np.mean(replay_s)),
                              "max": 1e3 * float(np.max(replay_s)),
                              "n": len(replay_s)} if replay_s else None,
           "launches": launches,
           "trace": trace, "reached": reached,
           "completions": {name_of[c.uid]: {
               "n_tokens": c.n_tokens, "nfe": c.nfe, "n_blocks": c.n_blocks,
               "cancelled": c.cancelled} for c in comps},
           "vs_host_loop": {**vs_host, "host_wall_s": host_wall},
           "vs_batch_mode_b1": vs_batch,
           "batch_mode_b1": {"wall_s_with_captures": batch_wall,
                             "graphs": sum(d.graph_cache_size() for d in
                                           beng._decoders.values())}}
    checks = {
        "no_capture_after_prewarm": rec["post_warm_captures"] == 0,
        "one_sync_per_gang_block": rec["host_syncs_per_block"] == 1.0
        and sum(c.host_syncs for c in comps) == sum(
            c.n_blocks for c in comps),
        "no_mask": all((c.tokens != cfg.mask_token_id).all() for c in comps),
        "conf_finite": all(c.commit_conf is None
                           or np.isfinite(c.commit_conf).all()
                           for c in comps),
        "cancelled_partial": a2.cancelled and 0 < len(a2.tokens) < GEN_LEN
        and len(a2.tokens) == a2.n_blocks * BLOCK,
        "preempted_resumed": (not a1.cancelled and a1.n_blocks
                              == GEN_LEN // BLOCK and "A1" in vs_batch),
        "graph_loop_equals_host_loop": all(vs_host.values()),
        "card_default_compacts": mode["batch_multiple"] == 1
        and mode["decoder_batch_invariant"],
        "equals_batch_mode_b1": all(vs_batch.values()),
        "every_request_served": sorted(by_uid) == sorted(uids.values()),
        "kernels_launched": all(v > 0 for v in launches.values()),
        "one_replay_per_gang_block": len(replay_s) == len(spans),
        "reached": all(reached.values())}
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"continuous phase failed: {checks}")
    del eng, heng, beng
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------------ prefix cache

PC_PROMPT, PC_SHARED, PC_CHUNK, PC_GEN = 256, 192, 16, 96


def prefix_waves(seed):
    """Two waves of 4 prompts of 256 tokens that share their first 192
    (12 chunks of 16); each prompt's last 64 tokens are its own."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 250, PC_SHARED)
    return [np.stack([np.concatenate([shared, rng.integers(
        0, 250, PC_PROMPT - PC_SHARED)]) for _ in range(4)]).astype(np.int32)
        for _ in range(2)]


def phase_prefix_cache(cfg, params):
    """The prefix cache at llada-8b full width and depth (32 layers, bf16,
    the serve phase's weights), streaming, gen_len 96. First the prefill
    alone, one gang of 4 on a decoder with a store: wave 1 cold (16 chunk
    passes), then wave 2 warm (12 chunks hit, 4 passes), timed, with the
    warm prompt KV against a storeless prefill of the same prompts (bit
    for bit). Then both waves through ``ContinuousEngine`` at gang sizes
    1, 2 and 4 (``max_gang``), each engine with a fresh store; at gang
    size 4 a wave-2 request is preempted after its first block and
    resumes, re-primed from the store. Every request's tokens and commit
    confidences must equal the cold run: the same prompt decoded alone
    (B = 1) with no store."""
    from repro_torch.cache import PrefixKVCache, device_placement
    from repro_torch.serving import ContinuousEngine
    dcfg = DecodeConfig(method="streaming", gen_len=PC_GEN, block_size=BLOCK,
                        window=WINDOW, use_kernels=True, prefix_cache=True,
                        cache_chunk=PC_CHUNK)
    waves = prefix_waves(SEED + 9)

    def store():
        return PrefixKVCache(chunk_tokens=PC_CHUNK, max_bytes=4 << 30,
                             placement=device_placement("cuda"))

    def timed_prefill(dec, prompts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = dec.prefill(prompts.copy())
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    rec = {"phase": "prefix_cache", "arch": cfg.name, "layers": cfg.n_layers,
           "prompt_len": PC_PROMPT, "shared_prefix": PC_SHARED,
           "chunk": PC_CHUNK, "gen_len": PC_GEN}
    # a storeless prefill of wave 2 first: the reference for the warm
    # prompt KV, and the first use of the chunk passes' shapes
    plain = DiffusionDecoder(cfg, params, dcfg, device="cuda").prefill(
        waves[1].copy())
    st0 = store()
    dec = DiffusionDecoder(cfg, params, dcfg, device="cuda", prompt_cache=st0)
    cold, cold_s = timed_prefill(dec, waves[0])
    after_cold = st0.stats()
    warm, warm_s = timed_prefill(dec, waves[1])
    kv_equal = all(torch.equal(a[:, :PC_PROMPT], b[:, :PC_PROMPT])
                   for kv_w, kv_p in zip(warm.cache, plain.cache)
                   for a, b in zip(kv_w, kv_p))
    rec["prefill"] = {
        "cold_s": cold_s, "warm_s": warm_s,
        "cold_passes": cold.nfe, "warm_passes": warm.nfe,
        "cold_q_tokens": cold.q_tokens, "warm_q_tokens": warm.q_tokens,
        "warm_hit_tokens": warm.prefix_hit_tokens.tolist(),
        "store_after_cold": after_cold, "store_after_warm": st0.stats(),
        "warm_kv_equals_storeless": kv_equal}
    del dec, cold, warm, plain, st0
    torch.cuda.empty_cache()

    ref_dec = DiffusionDecoder(cfg, params, dcfg, device="cuda")
    cold_runs = {}
    for w, prompts in enumerate(waves):
        for i in range(4):
            r = ref_dec.generate(prompts[i:i + 1].copy())
            cold_runs[(w, i)] = (r.tokens[0], np.concatenate(
                [bs.commit_conf[0] for bs in r.block_stats]))
    del ref_dec
    runs, ok = {}, kv_equal
    for gang in (1, 2, 4):
        eng = ContinuousEngine(cfg, params, dcfg, max_slots=4, max_gang=gang,
                               prefix_cache=store(), device="cuda")
        sizes, equal, hits, resumed = set(), {}, {}, None
        t0 = time.perf_counter()
        for w, prompts in enumerate(waves):
            uids = {eng.submit(p, max_tokens=PC_GEN): i
                    for i, p in enumerate(prompts)}
            tick, comps = 0, []
            while not eng.scheduler.idle:
                comps += eng.step()
                sizes |= {g.batch for g in eng.scheduler.gangs}
                if gang == 4 and w == 1 and tick == 0:
                    resumed = next(u for u, i in uids.items() if i == 1)
                    eng.preempt(resumed)
                    lookups = eng.prefix_cache.stats()["lookups"]
                    hit_tokens = eng.prefix_cache.stats()[
                        "lookup_hit_tokens"]
                tick += 1
            for c in comps:
                t, conf = cold_runs[(w, uids[c.uid])]
                equal[f"w{w}r{uids[c.uid]}"] = bool(
                    np.array_equal(c.tokens, t)
                    and np.array_equal(c.commit_conf, conf))
                hits[f"w{w}r{uids[c.uid]}"] = c.cache_hit_tokens
        torch.cuda.synchronize()
        stats = eng.prefix_cache.stats()
        run = {"wall_s": time.perf_counter() - t0,
               "gang_sizes": sorted(sizes), "equals_cold_b1": equal,
               "cache_hit_tokens": hits, "store": stats,
               "merges": eng.scheduler.merges}
        ok = ok and all(equal.values()) and len(equal) == 8
        if gang == 4:
            # the resume re-primes: one more lookup, hitting the row's
            # own 16 chunks
            run["resume"] = {
                "lookups": stats["lookups"] - lookups,
                "hit_tokens": stats["lookup_hit_tokens"] - hit_tokens}
            ok = ok and run["resume"] == {"lookups": 1,
                                          "hit_tokens": PC_PROMPT}
        runs[gang] = run
        del eng
        torch.cuda.empty_cache()
    rec["runs"] = runs
    pre = rec["prefill"]
    rec["checks"] = {
        "warm_computes_only_the_tail":
            pre["cold_passes"] == PC_PROMPT // PC_CHUNK
            and pre["warm_passes"] == (PC_PROMPT - PC_SHARED) // PC_CHUNK
            and pre["warm_hit_tokens"] == [PC_SHARED] * 4,
        "warm_kv_equals_storeless": kv_equal,
        "cached_equals_cold_at_gang_sizes_1_2_4": ok}
    rec["ok"] = all(rec["checks"].values())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"prefix_cache phase failed: {rec['checks']}")
    return rec


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def kernel_groups(prof, label):
    """Device time by group and the top kernels from a profile. The
    ``record_function(label)`` range also shows on the device timeline;
    it is a range, not a kernel, and is left out."""
    groups = {"matmul": 0.0, "block_attention": 0.0,
              "confidence_argmax": 0.0, "graph_control": 0.0, "other": 0.0}
    kernels, host_ops = [], []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            host_ops.append((ev.self_cpu_time_total, ev.key, ev.count))
            continue
        if ev.key == label:
            continue
        us = ev.self_device_time_total
        name = ev.key
        if "block_attention" in name or "attn_" in name:
            groups["block_attention"] += us
        elif "conf_argmax" in name or "conf_kernel" in name:
            groups["confidence_argmax"] += us
        elif "gemm" in name or "nvjet" in name or "cutlass" in name:
            groups["matmul"] += us
        elif "set_if_kernel" in name:
            groups["graph_control"] += us
        else:
            groups["other"] += us
        kernels.append((us, name, ev.count))
    kernels.sort(reverse=True)
    return groups, kernels, host_ops


def syncs_inside(prof, label):
    """Blocking device-to-host waits (stream/device/event synchronize,
    synchronous memcpy) issued inside the ``record_function(label)``
    range."""
    events = prof.events()
    span = [e for e in events if e.name == label][0].time_range
    return sorted(e.name for e in events if e.name in SYNC_CALLS
                  and span.start <= e.time_range.start <= span.end)


def encode_us(n: int = 20000) -> float:
    """Host µs per ``cuTensorMapEncodeTiled`` of the map gemm.cu makes
    for W at a (4096, 4096) product (bf16, 64 x 64 boxes, 128-byte
    swizzle, zero fill), two of which it encodes per launch; called here
    through ctypes, whose cost is included."""
    fn = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    fn.restype = ctypes.c_int
    w = torch.empty((4096, 4096), dtype=torch.bfloat16, device="cuda")
    buf = ctypes.create_string_buffer(128 + 64)        # a 64-byte aligned map
    args = [ctypes.c_void_p((ctypes.addressof(buf) + 63) & ~63),
            ctypes.c_int(9), ctypes.c_uint32(2),      # bf16, rank 2
            ctypes.c_void_p(w.data_ptr()), (ctypes.c_uint64 * 2)(4096, 4096),
            (ctypes.c_uint64 * 1)(4096 * 2), (ctypes.c_uint32 * 2)(64, 64),
            (ctypes.c_uint32 * 2)(1, 1), ctypes.c_int(0),
            ctypes.c_int(3), ctypes.c_int(3),          # 128B swizzle, L2 256B
            ctypes.c_int(0)]
    if fn(*args) != 0:
        raise AssertionError("cuTensorMapEncodeTiled failed")
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return (time.perf_counter() - t0) / n * 1e6


def host_us(fn, n: int = 200) -> float:
    """Host µs to issue one ``fn()``: n calls back to back without a
    sync, fewer than the launch queue holds, so the host never waits for
    the card; the least of three runs."""
    fn()
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / n * 1e6


def host_costs() -> dict:
    """What one eager launch of the host loop costs the host: a tensor-map
    encode, ``gemm.launch`` (ctypes, two encodes, the launch),
    ``ops.linear`` (its checks and output allocation besides), and one
    PyTorch elementwise op, at a step's q/k/v/o shape at B = 4."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((516, 4096), generator=g, device="cuda").to(
        torch.bfloat16)
    w = torch.randn((4096, 4096), generator=g, device="cuda").to(
        torch.bfloat16)
    y = torch.empty((516, 4096), dtype=torch.bfloat16, device="cuda")
    return {"encode_us": encode_us(),
            "gemm_launch_us": host_us(lambda: gemm.launch(x, w, y)),
            "linear_us": host_us(lambda: ops.linear(x, w)),
            "torch_add_us": host_us(lambda: torch.add(x, x, out=y))}


def phase_profile(cfg, dec, hdec, tokens):
    """Where a main-path block's time goes: the middle block of the same
    llada-8b streaming decode through its CUDA graph, once timed without
    the profiler (host clock to a synchronize, and CUDA events around
    it) and once, from an identical copy of the state, under
    torch.profiler for device time by kernel and the blocking syncs
    inside the block. Idle share = 1 - kernel time / unprofiled wall.
    The same block through the host loop, timed and profiled the same
    way, gives the per-kernel breakdown of the eager passes, and
    ``host_costs`` what one of its launches costs the host."""
    state = dec.prefill(tokens.copy())
    mid = GEN_LEN // BLOCK // 2
    while state.block_idx < mid:
        dec.decode_block(state)
    twins = [copy.deepcopy(state) for _ in range(3)]
    torch.cuda.synchronize()
    rec = {"phase": "profile", "block": mid}
    for loop, d, st, twin in (("graph", dec, state, twins[0]),
                              ("host", hdec, twins[1], twins[2])):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        d.decode_block(st)
        end.record()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("decode_block"):
                d.decode_block(twin)
            torch.cuda.synchronize()
        groups, kernels, host_ops = kernel_groups(prof, "decode_block")
        busy = sum(groups.values())
        steps = st.steps_per_block[-1]
        rec[loop] = {
            "steps": steps, "wall_us": wall_us,
            "wall_us_per_step": wall_us / steps,
            "event_span_us": start.elapsed_time(end) * 1e3,
            "device_kernel_us": busy,
            "device_idle_share": 1 - busy / wall_us,
            "device_us_by_group": groups,
            "kernel_launches_traced": sum(c for _, _, c in kernels),
            "wall_us_per_launch": wall_us / sum(c for _, _, c in kernels),
            "blocking_syncs_in_block": syncs_inside(prof, "decode_block"),
            "top": [{"name": k[:80], "device_us": us, "calls": c}
                    for us, k, c in kernels[:10]],
            "host_op_calls": sum(c for _, _, c in host_ops),
            "host_top": [{"name": k[:60], "self_cpu_us": us, "calls": c}
                         for us, k, c in sorted(host_ops, reverse=True)[:10]]}
        del twin
    same = bool((state.x == twins[1].x).all())
    rec["graph_block_equals_host_block"] = same
    rec["host_costs"] = host_costs()
    rec["ok"] = same and len(rec["graph"]["blocking_syncs_in_block"]) == 1
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("profile phase: the graph block made "
                             f"{rec['graph']['blocking_syncs_in_block']} "
                             f"blocking syncs (want 1), same tokens as the "
                             f"host loop: {same}")


# ------------------------------------------------------------------ main

def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol
    (the identifier after its length digits, so the file name in the
    anonymous namespace's prefix does not match)."""
    m = re.search(r"\d((?:attn|conf|gemm|set_if)_\w*?kernel)"
                  r"(I(?:L\w+?E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[a-z](\w+?)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def ptxas_report(log: str):
    """Per kernel instantiation: registers, spills, static shared memory,
    from nvcc's ``-Xptxas -v`` output."""
    funcs = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            funcs.append({"kernel": kernel_name(m.group(1)), "registers": None,
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


def cuobjdump_path():
    """The toolkit's cuobjdump, else the copy in Triton's package, else
    None."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        return "/usr/local/cuda/bin/cuobjdump"
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cand = os.path.join(os.path.dirname(spec.origin), "backends",
                            "nvidia", "bin", "cuobjdump")
        if os.path.exists(cand):
            return cand
    return None


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_report(tool: str, lib) -> list:
    """Per kernel of a built library: how many HGMMA (wgmma), UTMALDG
    (TMA tensor loads) and HMMA (mma.sync) instructions its SASS holds."""
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs = []
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            funcs.append({"kernel": kernel_name(m.group(1)),
                          **{op: 0 for op in SASS_OPS}})
            continue
        if funcs:
            for op in SASS_OPS:
                if re.search(r"\b" + op + r"\b", ln):
                    funcs[-1][op] += 1
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
    # one nvcc per library, all started together: the port's kernel
    # libraries and their probe builds
    jobs = [("block_attention", ()), ("confidence", ()), ("graph_loop", ()),
            ("gemm", ()), ("block_attention", ("ATTN_PROBE=1",)),
            ("block_attention", ("ATTN_PROBE=2",)),
            ("confidence", ("CONF_PROBE=1",)),
            ("confidence", ("CONF_PROBE=2",)), ("gemm", ("GEMM_PROBE=1",))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: build.compile_library(*j), jobs))
    build.load("block_attention")
    build.load("confidence")
    build.load("graph_loop")
    build.load("gemm")
    t_nvcc = time.perf_counter() - t0
    ptxas = [f for lib in libs[:4]
             for f in ptxas_report(lib.with_suffix(".log").read_text())]
    tool = cuobjdump_path()
    sass = ([dict(f, library=name) for (name, _), lib in zip(jobs[:4], libs)
             for f in sass_report(tool, lib)] if tool
            else "not available (no cuobjdump in the toolkit or Triton)")
    emit({"phase": "build", "nvcc_s": t_nvcc,
          "libraries": [os.path.relpath(lib, ROOT) for lib in libs[:4]],
          "ptxas": ptxas,
          "spills": any(f["spill_stores"] or f["spill_loads"] for f in ptxas),
          "cuobjdump": tool, "sass": sass})
    if tool:
        # the bf16 GEMM reaches wgmma and TMA, and no mma.sync is left
        bf16 = [f for f in sass if f["kernel"].startswith("gemm_bf16")]
        if not bf16 or not all(f["HGMMA"] and f["UTMALDG"] and not f["HMMA"]
                               for f in bf16):
            raise AssertionError(f"gemm_bf16_kernel SASS: {bf16}")

    step, conf = phase_kernels()
    gemm_main = phase_gemm()
    phase_gemm_probe()
    phase_probe()
    phase_reference()
    phase_reference_llada()
    tok = ByteTokenizer(get_config("llada-8b").vocab_size)
    prompts = np.stack([tok.encode(p) for p in make_prompts(
        N_PROMPTS, SEED)]).astype(np.int32)
    inv = phase_invariance(prompts)
    phase_methods(prompts)
    *model, serve = phase_serve()
    phase_profile(*model)
    cont = phase_continuous(model[0], model[1].params, inv["batch_invariant"])
    phase_prefix_cache(model[0], model[1].params)

    kernels = [
        {"name": "block_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/block_attention.cu",
         "replaces": "src/repro/kernels/block_attention.py:109",
         "launches": cont["launches"]["block_attention"],
         "max_abs_err": step["max_abs_err"], "ms": step["kernel_ms"],
         "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
         "bound_by": step["bound_by"], "library_ms": step["library_ms"]},
        {"name": "confidence_argmax", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/confidence.cu",
         "replaces": "src/repro/kernels/confidence.py:70",
         "launches": cont["launches"]["confidence_argmax"],
         "max_abs_err": conf["max_abs_err"], "ms": conf["kernel_ms"],
         "plain_ms": conf["plain_ms"], "bound_ms": conf["bound_ms"],
         "bound_by": conf["bound_by"], "library_ms": None},
        # no TPU kernel: the JAX package leaves its projections to XLA's
        # dot; the main-path shape timed here is a step's gate/up at B = 4
        {"name": "gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "replaces": "src/repro/models/layers.py:252",
         "launches": cont["launches"]["gemm"],
         "max_abs_err": gemm_main["max_abs_err"],
         "ms": gemm_main["kernel_ms"], "plain_ms": gemm_main["plain_ms"],
         "bound_ms": gemm_main["bound_ms"], "bound_by": gemm_main["bound_by"],
         "library_ms": gemm_main["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
