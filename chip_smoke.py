#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package. Phases, each printing JSON lines:

1. device   — card name and power limit (nvidia-smi), torch/CUDA versions.
2. build    — builds the CUDA sources of ``src/repro_torch/kernels/csrc``
              with nvcc (the port's kernel libraries: attention,
              confidence, the GEMM, the recurrent scans and the CUDA-graph
              block loop, two
              probe builds of each of the first two and one of the GEMM,
              in parallel; ptxas
              registers and spills per kernel; from ``cuobjdump -sass``
              each kernel's HGMMA, UTMALDG and HMMA counts: the bf16 GEMM
              must use wgmma and TMA and no mma.sync, the float32 GEMM
              mma.sync; the sLSTM kernel's registers and its plan's
              shared bytes).
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
              (tile, stages, CTAs, waves on the card's SMs); the float32
              kernel (3xTF32) at the routers' and RG-LRU's products, and
              its ``acc`` chain cut at K / 2 bit-equal to the whole.
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
10. dryrun  — the dry run (``launch/steps.py``, ``launch/dryrun.py``):
              llada-8b's serve step at the serve phase's shape counted on
              shape-only tensors on a (1, 1) mesh, then run on the card
              on the serve phase's weights: the count's gemm FLOPs equal
              the 2 M K N of the step's gemm.cu launches, its attention
              FLOPs the attention launches' count (``kernels/cost.py``),
              its argument bytes the card's tensors', and the step is
              not faster than the count's bound; kimi-k2 and qwen3-32b
              ``decode_32k`` counted on the production (16, 16) mesh (one
              rank's FLOPs, bytes, collectives, dominant term, whether it
              fits 80 GB); the launch counts and the card's allocated
              bytes unchanged across the counts; at most 30 s
              (``phase_dryrun``).
11. continuous — ``ContinuousEngine`` at llada-8b full width and depth on
              the serve phase's weights: prewarm, then a scripted mix of
              arrivals, a preempt and a cancel, timed, with gangs of
              several sizes that compact and merge; against the same
              script through the host loop and against each request
              decoded alone (``phase_continuous``, ``continuous_script``).
12. prefix_cache — the same model with the prefix cache: cold against
              warm prefill of prompts sharing a 192-token prefix, then two
              waves through ``ContinuousEngine`` at gang sizes 1, 2 and 4
              with a preempt and resume, each request equal to its cold
              decode bit for bit (``phase_prefix_cache``).
13. http    — the port's front end on the same weights, in this process:
              ``HttpFrontend`` over ``EngineLoop`` with the prefix cache,
              the shadow auditor (host and cold lanes), the block
              profiler, the metrics recorder, the SLO watchdog and the
              flight recorder, driven over loopback by
              ``repro_torch.server.client``: two timed bursts (JSON and
              SSE, a shared system prompt, a deadline, a disconnect),
              every endpoint, a burst above max_pending (429) and the
              drain; every finished request equal to its decode alone
              (``phase_http``, ``http_traffic``).
14. fleet   — several engines on the card, each on its own CUDA stream
              and ``EngineLoop`` thread, on the same weights: a steal
              fleet of two engines under ``EngineRouter(steal=True)``
              (every request sent to loop 0; a parked row and waiting
              requests stolen), one engine alone as the baseline, and a
              ``prefill:1,decode:1`` pool fleet over one shared prefix
              store; every completion equal to the baseline's bit for
              bit, handoffs out = in, and one block graph captured on one
              engine's thread while another engine decodes; launches
              counted per run and per engine, and the card's idle share
              bracketed by CUDA-event spans (``phase_fleet``).
15. train   — the llada-8b weights freed, training and checkpoints: one
              float32 train step of ``tiny`` on the card against the CPU
              (loss, every gradient, every weight after AdamW); tiny-100m
              trained at full size with ``examples/train_and_serve.py``'s
              recipe (300 steps, batch 16, seq_len 76; ``TRAIN_STEPS``
              lists counts to rerun at if no method answers): loss, masked
              accuracy, step ms, tokens/s, peak bytes; its checkpoint
              written and read back bit for bit; the methods table on the
              trained weights in bf16 and f32 (exact-match accuracy, NFE,
              steps per block, tokens per step, the share of blocks whose
              IF nodes skipped, tok/s, speedup), graph loop against host
              loop; then ``ContinuousEngine`` on the 32 prompts, each
              equal to its decode alone (``phase_train``).
16. families_reference — the trained model freed: qwen3-32b, phi4-mini,
              minitron-4b (2 layers each) and kimi-k2 (1 layer, all 384
              experts) at full width, bf16 random weights: a refresh and
              a streaming step through the kernels against the plain
              route (``attend_ref``, ``torch.matmul``), the float32 router
              products counted (``phase_families_reference``).
17. families — gemma2-27b (tied head, softcaps, local/global layers) and
              olmoe-1b-7b (64 experts, top-8) at full width, depth cut to
              8 and 2 layers (``FAM_DEPTH``): the graph loop against the
              host loop, block 0 profiled (one blocking sync), step ms
              beside the weight-bytes bound; then olmoe through
              ``ContinuousEngine(4, 4)`` after prewarm, every request equal
              to its decode alone at B = 1 (``phase_families``,
              ``serve_family``).
18. recurrent — the families' weights freed: each scan kernel
              (``csrc/recurrent.cu``: RG-LRU, mLSTM, sLSTM) against its
              plain version at both models' refresh and step shapes (bf16,
              and float32 at the step's; the plain version's own error
              against float64 beside it; bf16 output = float32 rounded;
              a row alone = its row in the batch), attention at D = 256 at
              recurrentgemma's step and refresh against its plain version
              and SDPA; then recurrentgemma-9b (RG-LRU + local MQA
              attention, tied head) and xlstm-350m (mLSTM + sLSTM) at full
              width and depth as the families phase serves its models,
              xlstm also through ``ContinuousEngine(4, 4)``
              (``phase_recurrent``).
19. frontends — the modality frontends at full width, bf16 random
              weights: musicgen-medium at full size (48 layers, V 2048)
              and llava-next-34b cut to 4 of 60 layers (``FRONT_DEPTH``):
              each frontend projection's GEMM and the head's confidence
              at its vocabulary against their plain versions; an encode
              of the whole frontend prefix (256 frames / 2880 patches)
              plus 128 text tokens through the kernels against the plain
              route, both beside a float32 pass; a streaming decode on
              the graph loop against the host loop (``phase_frontends``).
20. placement — llada-8b at full width, 2 layers, on a
              ``DecodeExecutor``: (a) a one-rank NCCL world, graph loop,
              bit-equal to the decoder without one, one sync a block,
              then ``ContinuousEngine`` on it, each request equal to its
              decode alone; (b) two ranks sharing the card over gloo
              (rank 1 a process this phase starts), host loop: mesh
              (2, 1) exact, (1, 2) at agreement >= 0.95 with the same
              NFE, the graph loop refused on gloo, and the GEMM's
              float32 output and its two-rank chain at the (1, 2)
              shards' row-parallel products; then the serve CLI's own
              functions serving a placed model over loopback HTTP
              (``repro_torch.server.client``; 6 requests of 32 tokens,
              JSON and SSE, 4 at once): (c) ``--mesh 1,1 --http`` in a
              one-rank NCCL world on the graph loop, prewarmed, each
              completion bit-equal to its decode alone without an
              executor, one sync a block, no capture after prewarm; (d)
              two gloo ranks on the card, host loop, ``--mesh 2,1
              --http`` (one data-sharded engine) and ``--mesh 1,1
              --engines 2 --http`` (two engines behind the router, rank
              0 the controller, rank 1 replaying engine 1's ops): every
              completion bit-equal to rank 0's decode alone, both
              engines serving, a cancel mid-stream and the next request
              exact, both ranks at exit 0; with every serving layer on:
              (e) ``--mesh 1,1 --http`` in the one-rank NCCL world with
              the shadow auditor's host lane, the flight recorder, the
              block profiler and the trace: every completion exact, every
              one audited clean, a manual flight dump of the engine's
              state, a profile naming the attention kernel, no capture
              after prewarm; (f) ``--mesh 1,1 --pool prefill:1,decode:1``
              on the two gloo ranks (the prefill engine on rank 0, the
              decode engine on rank 1) with the prefix cache, the
              auditor's cold lane, the trace and the flight recorder:
              every completion exact, every handoff a full prefix hit on
              rank 1, its bytes and ops' wall reported, audits clean, and
              rank 1's block spans inside their requests' http spans in
              rank 0's trace (``phase_placement``).

The build phase also builds ``csrc/recurrent.cu`` and fails if any
instantiation spills (the D = 256 attention kernel's included). The
kernels phase also runs attention, confidence and the GEMM at the
other families' shapes (``family_kernel_cases``, ``family_gemm_cases``),
and every phase prints its seconds. Then the kernels summary line
(launches counted on the continuous phase's timed run, the scans' on
the recurrent phase's timed decodes; the GEMM and the scans have no TPU
kernel behind them, and their lines name the reference's XLA product
and ``lax.scan`` steps they stand for), the nvidia-smi line and, last, the device
line ``{"ok": true, "device": {...}}``. Any failure raises: the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
from repro_torch.core.decoder import METHODS as DECODE_METHODS  # noqa
from repro_torch.core.decoder import (DecodeConfig,  # noqa: E402
                                      DiffusionDecoder, eos_truncate)
from repro_torch.core.engine import ServingEngine  # noqa: E402
from repro_torch.data.synthetic import (ArithmeticDataset,  # noqa: E402
                                        exact_match)
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.kernels import block_attention as kba  # noqa: E402
from repro_torch.kernels import build, confidence, gemm, ops, ref  # noqa: E402
from repro_torch.kernels import recurrent as krec  # noqa: E402
from repro_torch.models import apply_model, get_config, init_params  # noqa: E402
from repro_torch.models.model import (DTYPES, init_cache,  # noqa: E402
                                      params_to, serving_head)
from repro_torch.training import checkpoint, tree  # noqa: E402
from repro_torch.training.loss import (draw_noise,  # noqa: E402
                                       loss_given_noise)
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            adamw_init, adamw_update)
from repro_torch.training.train import (TrainConfig,  # noqa: E402
                                        make_train_step, train)

# the H100's rates and each kernel's bound: one count with the dry run's
# (``kernels/cost.py``; ``launch/dryrun.py``)
from repro_torch.kernels.cost import (HBM_BYTES_S, PEAK_OPS_S,  # noqa: E402
                                      attention_bound, confidence_bound,
                                      gemm_bound, scan_bound)
SEED = 0
PROMPT_LEN = 128
N_PROMPTS = 4
GEN_LEN, BLOCK, WINDOW = 256, 32, 96
# the other families (families phases): prompts, generation, batch; a
# streaming step of block 0 queries the block and the 32 suffix tokens
FAM_PROMPT, FAM_GEN, FAM_N = 128, 64, 2
FAM_SQ = BLOCK + min(WINDOW, FAM_GEN - BLOCK)


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


ATTN_PATH = ("block_attention", "confidence_argmax", "gemm")
SCAN_OF = {"rglru": "rglru_scan", "mlstm": "mlstm_scan",
           "slstm": "slstm_scan"}


def path_kernels(cfg=None) -> tuple:
    """The kernels a decode of ``cfg`` launches (llada-8b's path when
    None): the confidence kernel and the GEMM, the GEMM's float32 kernel
    where the config has float32 products (a MoE router, RG-LRU's gates,
    a float32 model), attention where the layout has an attention layer,
    each recurrent mixer's scan."""
    if cfg is None:
        return ATTN_PATH
    mixers = {s.mixer for s in cfg.layout}
    return tuple(k for k in ops.LAUNCHES
                 if k in ("confidence_argmax", "gemm")
                 or (k == "gemm_f32" and (cfg.n_experts or "rglru" in mixers
                                          or cfg.dtype == "float32"))
                 or (k == "block_attention"
                     and mixers & {"attn", "attn_local"})
                 or k in {SCAN_OF[m] for m in mixers if m in SCAN_OF})


def launched(counts, cfg=None) -> bool:
    """Every kernel of ``cfg``'s path (``path_kernels``) counted at least
    one launch in ``counts``."""
    return all(counts[k] > 0 for k in path_kernels(cfg))


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


def check_attention(name, shape, dtype, *, softcap=0.0, window=0,
                    n_valid=None, q_start=0, masked_row=False, timed=False,
                    scale=None):
    """The wrapper's kernel (bf16: the tensor-core kernel, float32: the
    simple one) against the plain version on the same inputs. bf16 cases
    also check the fused bf16 epilogue: the kernel's bf16 output is its
    float32 output rounded to nearest even, bit for bit. Timed cases time
    the first port's simple kernel on the same inputs, in turns.
    ``scale`` defaults to 1/sqrt(D) (gemma2: 1/12)."""
    B, Sq, Skv, H, Hkv, D = shape
    args = attention_inputs(B, Sq, Skv, H, Hkv, D, dtype, n_valid=n_valid,
                            q_start=q_start)
    q, k, v, qp, kp, km = args
    if masked_row:
        km[-1] = False                       # the last row sees no key
    scale = scale or 1.0 / math.sqrt(D)
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
           "softcap": softcap, "window": window, "scale": scale,
           "max_abs_err": err, "tol": tol, "ok": ok, **extra}
    if timed:
        sets = [attention_inputs(B, Sq, Skv, H, Hkv, D, dtype,
                                 n_valid=n_valid, q_start=q_start, seed=s)
                for s in range(n_copies(nbytes(*args, out)))]

        def new(*a):
            return ops.block_attention(*a, **kw)

        if D in kba.SIMPLE_D:
            out_s = torch.empty_like(out)
            kba.launch_simple(*args, out_s, **kw)
            torch.cuda.synchronize()
            rec["simple_max_abs_err"] = (out_s - want).abs().max().item()

            def simple(*a):
                kba.launch_simple(*a, out_s, **kw)

            # in turns: new, simple, simple, new
            t_new, t_simple = time_ms(new, sets), time_ms(simple, sets)
            t_simple2, t_new2 = time_ms(simple, sets), time_ms(new, sets)
            rec["simple_ms"] = (t_simple + t_simple2) / 2
            rec["simple_ms_turns"] = [t_simple, t_simple2]
        else:                    # the first port's kernel stops at D = 128
            t_new, t_new2 = time_ms(new, sets), time_ms(new, sets)
        rec["kernel_ms"] = (t_new + t_new2) / 2
        rec["eager_ms"] = eager_ms(new, sets)
        rec["kernel_ms_turns"] = [t_new, t_new2]
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
        rec["bound_ms"], rec["bound_by"] = confidence_bound(
            N, V, x.element_size())
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
    for D in (128, 64, 256):
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
    family_kernel_cases()
    return step, conf


def family_kernel_cases():
    """Attention and confidence at the other families' shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    # the other families' step shapes (families phase: 2 prompts of 128,
    # a block-0 step of FAM_SQ queries over [192 cache slots valid to 128
    # || self]): gemma2-27b (32 / 16 heads, scale 1/12, softcap 50, its
    # local layers' window 4096), olmoe-1b-7b (16 / 16 heads, qk-normed)
    T = FAM_PROMPT + FAM_GEN
    fam = dict(n_valid=FAM_PROMPT, q_start=FAM_PROMPT)
    check_attention("gemma2_27b_step_local", (FAM_N, FAM_SQ, T + FAM_SQ, 32,
                                              16, 128), bf16, softcap=50.0,
                    window=4096, scale=1.0 / 12.0, timed=True, **fam)
    check_attention("gemma2_27b_step_global", (FAM_N, FAM_SQ, T + FAM_SQ,
                                               32, 16, 128), bf16,
                    softcap=50.0, scale=1.0 / 12.0, **fam)
    check_attention("olmoe_1b_7b_step", (FAM_N, FAM_SQ, T + FAM_SQ, 16, 16,
                                         128), bf16, timed=True, **fam)
    # their heads: gemma2's softcapped logits reach the kernel in float32
    # (kernels/ops.py head_confidence_argmax), olmoe's in bf16
    check_confidence("gemma2_27b_head_f32", FAM_N * BLOCK, 256000, f32,
                     mask_id=get_config("gemma2-27b").mask_token_id,
                     timed=True)
    check_confidence("olmoe_1b_7b_head_bf16", FAM_N * BLOCK, 50304, bf16,
                     mask_id=get_config("olmoe-1b-7b").mask_token_id,
                     timed=True)


# ------------------------------------------------------------------ GEMM

# llada-8b's products per layer of a pass, as (name, K, N, count): q, k, v
# and o; gate and up; down. The LM head is (4096, 126464), once a step.
LLADA_PRODUCTS = (("qkvo", 4096, 4096, 4), ("gate_up", 4096, 12288, 2),
                  ("down", 12288, 4096, 1))
LLADA_HEAD = (4096, 126464)
# the other families' products new to gemm.cu, as (name, K, N, dtype):
# gemma2-27b's gate/up, an olmoe expert's gate/up and down, a kimi-k2
# expert's gate/up, the float32 routers (olmoe E = 64, kimi E = 384) and
# recurrentgemma-9b's float32 u @ [w_a | w_x]; then each new LM head (K, N)
FAMILY_PRODUCTS = (("gemma2_27b_gate_up", 4608, 36864, torch.bfloat16),
                   ("olmoe_expert_gate_up", 2048, 1024, torch.bfloat16),
                   ("olmoe_expert_down", 1024, 2048, torch.bfloat16),
                   ("kimi_expert_gate_up", 7168, 2048, torch.bfloat16),
                   ("olmoe_router_f32", 2048, 64, torch.float32),
                   ("kimi_router_f32", 7168, 384, torch.float32),
                   ("recurrentgemma_9b_u_wa_wx_f32", 4096, 8192,
                    torch.float32))
FAMILY_PLAIN = ("gemma2_27b_gate_up", "olmoe_expert_gate_up",
                "recurrentgemma_9b_u_wa_wx_f32")
FAMILY_HEADS = {"gemma2-27b": (4608, 256000), "olmoe-1b-7b": (2048, 50304),
                "qwen3-32b": (5120, 151936), "kimi-k2": (7168, 163840),
                "phi4-mini": (3072, 200064)}


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
    float32 (the ``tiny`` config's route) at small shapes, and the other
    families' products (``family_gemm_cases``). Per B, the step's 32
    layers of products summed: kernel, cuBLAS and bound. Returns the
    gate/up record at B = 4 and the float32 products' records."""
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
    check_gemm_f32_chain("f32_ragged", 37, 80, 42)
    return main, family_gemm_cases()


def family_gemm_cases():
    """gemm.cu at the other families' new shapes, beside cuBLAS, and the
    float32 kernel's ``acc`` chain at its products. Returns the records of
    the float32 products by name."""
    # the other families' new shapes, at a block-0 step of the families
    # phase (FAM_N x FAM_SQ rows) and its head (FAM_N x BLOCK rows)
    M = FAM_N * FAM_SQ
    f32 = {}
    for name, K, N, dtype in FAMILY_PRODUCTS:
        rec = check_gemm(name, M, K, N, dtype, plain=name in FAMILY_PLAIN)
        if dtype == torch.float32:
            f32[name] = rec
            check_gemm_f32_chain(name, M, K, N)
    for arch, (K, N) in FAMILY_HEADS.items():
        check_gemm(f"{arch}_head", FAM_N * BLOCK, K, N)
    return f32


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
                 and launched(launches))
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
        "kernels_launched": launched(launches),
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


# ------------------------------------------------------------ http

HTTP_PROMPT, HTTP_SHARED, HTTP_GEN = 256, 192, 128
HTTP_MAX_PENDING = 4
# the deadline request's timeout_s. It is sent first, to an idle loop,
# so its prefill and first block run in the step that admits it, before
# the loop checks a deadline; 0.5 s is less than that step at llada-8b
# (~1 s at B = 1), so the deadline ends it after its first block (after
# two on a card twice as fast), never before one or after all four
HTTP_TIMEOUT_S = 0.5
PROM_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
PROM_SAMPLE = re.compile(rf"^({PROM_NAME})(?:\{{(.*)\}})?\s(\S+)$")
PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text):
    """Strict parse of Prometheus text format 0.0.4: HELP, then TYPE,
    then samples per family; known types; label sets and float values
    that parse; no sample twice. Returns {family: [(name, labels,
    value)]}; raises on any breach."""
    fams, types, seen = {}, {}, set()
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if ln.startswith("# HELP "):
            name = ln.split()[2]
            if name in fams or not re.fullmatch(PROM_NAME, name):
                raise AssertionError(f"/metrics: bad or repeated HELP {ln!r}")
            fams[name], types[name] = [], None
        elif ln.startswith("# TYPE "):
            _, _, name, mtype = ln.split()
            if name not in fams or types[name] is not None or mtype not in (
                    "counter", "gauge", "summary", "histogram"):
                raise AssertionError(f"/metrics: bad TYPE line {ln!r}")
            types[name] = mtype
        else:
            m = PROM_SAMPLE.match(ln)
            if ln.startswith("#") or not m:
                raise AssertionError(f"/metrics: bad sample line {ln!r}")
            name, labels, value = m.groups()
            fam = next((name[:-len(s)] for s in ("_bucket", "_sum", "_count")
                        if name.endswith(s) and types.get(name[:-len(s)])
                        in ("summary", "histogram")), name)
            if fam not in fams or (labels and PROM_LABEL.sub(
                    "", labels).strip(", ")) or (name, labels) in seen:
                raise AssertionError(f"/metrics: bad sample {ln!r}")
            seen.add((name, labels))
            fams[fam].append((name, labels or "", float(value)))
    if None in types.values():
        raise AssertionError("/metrics: a family without TYPE")
    return fams


def http_prompts(seed):
    """The http phase's prompts, strings of 256 one-byte tokens: 4 that
    share their first 192 characters (as requests behind a chat front
    end share a system prompt; built as ``prefix_waves`` builds its
    waves), 4 distinct ones, a warm-up and the burst above max_pending."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz .,0123456789"))

    def text(n):
        return "".join(rng.choice(alphabet, n))

    shared = text(HTTP_SHARED)
    return {"S": [shared + text(HTTP_PROMPT - HTTP_SHARED)
                  for _ in range(4)],
            "D": [text(HTTP_PROMPT) for _ in range(4)],
            "warmup": text(HTTP_PROMPT),
            "burst": [text(HTTP_PROMPT) for _ in range(HTTP_MAX_PENDING + 1)]}


class HttpServerThread:
    """The front end's asyncio loop on a thread of its own; the phase's
    client runs on the main thread's loop."""

    def __init__(self, frontend):
        import asyncio
        import threading
        self.frontend = frontend
        self.loop = asyncio.new_event_loop()
        self.ready = threading.Event()
        self.error = None
        self.thread = threading.Thread(target=self._run, name="http-asyncio")

    def _run(self):
        import asyncio
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.frontend.start())
        except BaseException as err:       # reported by start()
            self.error = err
            self.ready.set()
            return
        self.ready.set()
        self.loop.run_forever()

    def start(self):
        self.thread.start()
        if not self.ready.wait(120) or self.error is not None:
            raise AssertionError(f"http front end did not start: {self.error}")
        return self

    async def shutdown(self, drain: bool = True):
        import asyncio
        await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
            self.frontend.shutdown(drain=drain, timeout_s=300), self.loop))

    def stop(self):
        if self.thread.is_alive():
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(60)
        if not self.thread.is_alive():
            self.loop.close()


async def http_traffic(host, port, server, prompts, mark):
    """The http phase's client (``repro_torch.server.client`` on this
    thread's event loop): a warm-up request and its audit; then, timed,
    burst 1 (D1 with a deadline, sent first; once it decodes, S0 SSE, S1,
    D0 SSE) and burst 2 (S2 SSE,
    S3, D2, D3 SSE dropped after its first chunk; S2 and S3 find S0's
    and S1's 192-token prefix in the cache); the endpoints once at least
    two audits completed; then a burst of max_pending + 1 requests, and
    the drain while the admitted ones are in flight. ``mark(name)`` is
    called at the timed window's ends. Returns the responses, the
    endpoints' answers and the client's clock readings."""
    import asyncio
    from repro_torch.server import client as C
    perf = time.perf_counter

    async def json_req(name, prompt, **kw):
        t0 = perf()
        st, hd, doc = await C.complete(host, port, {
            "prompt": prompt, "max_tokens": HTTP_GEN, **kw})
        return name, {"stream": False, "status": st, "headers": hd,
                      "doc": doc, "prompt": prompt, "latency_s": perf() - t0,
                      "ttfb_s": None}

    async def sse_req(name, prompt, drop_after=None):
        t0 = perf()
        stream = await C.SSEStream.open(host, port, {
            "prompt": prompt, "max_tokens": HTTP_GEN})
        events, first = [], None
        if stream.status == 200:
            async for ev in stream.events():
                first = perf() - t0 if first is None else first
                events.append(ev)
                if drop_after is not None and len(events) >= drop_after:
                    stream.abort()
                    break
        if drop_after is None or stream.status != 200:
            await stream.close()
        finals = [e for e in events if "finish_reason" in e]
        return name, {"stream": True, "status": stream.status,
                      "doc": finals[0] if finals else None,
                      "events": events, "prompt": prompt,
                      "dropped": drop_after is not None,
                      "latency_s": perf() - t0, "ttfb_s": first}

    async def get(path):
        st, hd, body = await C.request(host, port, "GET", path)
        return st, hd, body

    async def audits_done(n, timeout_s=600.0):
        """Poll /debug/vars until n audits completed (and /metrics every
        second meanwhile: scrapes while the decode thread decodes and
        captures the audit lanes)."""
        t0, scrapes = perf(), 0
        while perf() - t0 < timeout_s:
            st, _, body = await get("/debug/vars")
            assert st == 200
            if json.loads(body)["engines"][0]["audit"]["completed"] >= n:
                return scrapes
            st, _, _ = await get("/metrics")
            assert st == 200
            scrapes += 1
            await asyncio.sleep(1.0)
        raise AssertionError(f"fewer than {n} audits after {timeout_s} s")

    out, clock = {}, {}
    out.update([await json_req("warmup", prompts["warmup"])])
    clock["scrapes_while_auditing"] = await audits_done(1)
    mark("t0")
    clock["window_t0"] = perf()
    d1 = asyncio.create_task(json_req("D1", prompts["D"][1],
                                      timeout_s=HTTP_TIMEOUT_S))
    while not json.loads((await get("/debug/vars"))[2])[
            "engines"][0]["scheduler"]["live_rows"]:
        assert not d1.done() and perf() - clock["window_t0"] < 60
        await asyncio.sleep(0.005)
    out.update(await asyncio.gather(
        sse_req("S0", prompts["S"][0]), json_req("S1", prompts["S"][1]),
        sse_req("D0", prompts["D"][0]), d1))
    out.update(await asyncio.gather(
        sse_req("S2", prompts["S"][2]), json_req("S3", prompts["S"][3]),
        json_req("D2", prompts["D"][2]),
        sse_req("D3", prompts["D"][3], drop_after=1)))
    clock["window_t1"] = perf()
    mark("t1")
    clock["scrapes_while_auditing"] += await audits_done(2)
    endpoints = {}
    for path in ("/healthz", "/debug/vars", "/debug/timeline?window=600",
                 "/console", "/metrics", "/debug/flight"):
        st, hd, body = await get(path)
        endpoints[path] = (st, hd, body.decode())
    t0 = perf()
    while json.loads((await get("/healthz"))[2])["inflight"]:
        assert perf() - t0 < 120, "requests still in flight"
        await asyncio.sleep(0.05)
    # the burst above max_pending; drain once it is refused and the
    # admitted requests are in flight
    tasks = [asyncio.create_task(json_req(f"B{i}", p))
             for i, p in enumerate(prompts["burst"])]
    while not any(t.done() for t in tasks):
        await asyncio.sleep(0.01)
    clock["inflight_at_drain"] = sum(not t.done() for t in tasks)
    await server.shutdown(drain=True)
    out.update(await asyncio.gather(*tasks))
    return out, endpoints, clock


def union_ms(ref, spans, lo=-math.inf, hi=math.inf) -> float:
    """Milliseconds covered by the union of ``spans`` (pairs of recorded
    CUDA events, on any streams), read against ``ref`` on the card's
    clock and clipped to [lo, hi]."""
    iv = sorted((max(ref.elapsed_time(a), lo), min(ref.elapsed_time(b), hi))
                for a, b in spans)
    busy, cur = 0.0, None
    for a, b in iv:
        if cur is None or a > cur[1]:
            busy += max(cur[1] - cur[0], 0.0) if cur else 0.0
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (max(cur[1] - cur[0], 0.0) if cur else 0.0)


class DeviceSpans:
    """CUDA events around every call of the named ``DiffusionDecoder``
    methods, recorded on the calling engine's current stream; each span
    is ``(start, end, method, the decoder's dcfg.fused)``. Device busy is
    read as a union of spans on the card's clock (two engines' spans
    overlap, and a method may call another), so a gap inside a span
    counts as busy."""

    def __init__(self, on_card,
                 names=("prefill", "prime_prompt_kv", "decode_block")):
        self.on_card, self.names, self.spans, self.saved = \
            on_card, names, [], {}

    def __enter__(self):
        if not self.on_card:
            return self

        def spanned(fn, name):
            def run(dec, *a, **kw):
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
                out = fn(dec, *a, **kw)
                ev[1].record()
                self.spans.append((*ev, name, dec.dcfg.fused))
                return out
            return run

        for name in self.names:
            self.saved[name] = getattr(DiffusionDecoder, name)
            setattr(DiffusionDecoder, name, spanned(self.saved[name], name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(DiffusionDecoder, name, fn)

    def mark(self):
        """(reference event, index of the next span)."""
        if not self.on_card:
            return None, len(self.spans)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev, len(self.spans)

    def idle_share(self, start, end):
        """The card's idle share between two marks, bracketed: ``low``
        counts every span as busy (a gap inside one, such as the decode
        engine's KV assembly from host memory, counts as busy); ``high``
        counts only the block graphs' spans (``decode_block``: a graph
        runs its ~56k kernels back to back) and every prefill and prime
        as idle."""
        if not self.on_card:
            return None
        torch.cuda.synchronize()
        (ref, i0), (stop, i1) = start, end
        window = ref.elapsed_time(stop)
        inside = self.spans[i0:i1]
        every = union_ms(ref, [(a, b) for a, b, *_ in inside], 0.0, window)
        blocks = union_ms(ref, [(a, b) for a, b, name, _ in inside
                                if name == "decode_block"], 0.0, window)
        return {"window_ms": window, "busy_ms": every, "block_ms": blocks,
                "idle_share_low": 1 - every / window,
                "idle_share_high": 1 - blocks / window, "spans": i1 - i0}


def phase_http(cfg, params, device="cuda"):
    """The port's front end at llada-8b full width and depth (the serve
    phase's weights), in this process: ``DecodeConfig(method="streaming",
    gen_len=256, block_size=32, window=96, prefix_cache=True)``,
    ``ContinuousEngine(max_slots=8, max_gang=4)`` with a prefix store,
    prewarmed for the traffic's bucket (256-token prompts, 128 tokens) at
    gang sizes 1-4; a ``Tracer``, a ``ShadowAuditor`` at
    ``AuditConfig(sample_rate=0.5, oracle="auto")`` (host and cold lanes),
    a ``BlockProfiler`` over 2 blocks, a ``MetricsRecorder`` at 0.5 s, a
    loose ``SLOWatchdog`` and a ``FlightRecorder``, all wired by
    ``repro_torch.server.http._front``; ``HttpFrontend`` on
    127.0.0.1:0 on its own asyncio thread, driven by ``http_traffic``.

    Checks (any failure raises): every request that finished equals its
    decode alone on the card (B = 1, cold, bit for bit in tokens and
    commit confidences), and the deadline's partial completion the same
    decode's first blocks; SSE chunks in block order whose joined text is
    the final text; the cache hits of S2 and S3; the disconnect's
    cancel; /healthz, /debug/vars, /debug/timeline, /console and
    /debug/flight answer 200; /metrics parses as Prometheus text and
    holds the device's bytes in use and the five prefix-cache series
    (hits >= 1); at least 2 audits completed through both lanes with no
    error and no divergence but a near-tie (printed on its own line); no
    serving capture after prewarm (the cold lane's counted apart); the
    profiler's trace names the three kernels; a 429 with Retry-After on
    the burst above max_pending; the drain finishes the admitted requests
    and the loop thread joins; every kernel launched. Timed window:
    bursts 1 and 2, with the client's tok/s, TTFB (first SSE event) and
    latency beside the engine's ``ServeMetrics`` for the same requests,
    and the card's idle share (1 - the CUDA-event spans of every prefill
    and decode_block on the decode thread, serving and audit lanes, over
    the window's wall)."""
    import asyncio
    import tempfile

    from repro_torch.cache import PrefixKVCache, device_placement
    from repro_torch.obs import (AuditConfig, BlockProfiler, FlightRecorder,
                                 SLOWatchdog, Tracer, device_memory_stats)
    from repro_torch.server import HttpFrontend
    from repro_torch.server.http import _front
    from repro_torch.serving import ContinuousEngine
    from repro_torch.serving.metrics import percentile
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()

    def bytes_in_use():
        mem = device_memory_stats().get("cuda:0")
        return int(mem["bytes_in_use"]) if mem else 0

    class RecordingWatchdog(SLOWatchdog):
        """Keeps every completion the loop observes (the engine's
        ``Completion`` objects: tokens, commit confidences)."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.comps = []

        def observe(self, comp):
            self.comps.append(comp)
            super().observe(comp)

    mem_before = bytes_in_use()
    dcfg = DecodeConfig(method="streaming", gen_len=GEN_LEN, block_size=BLOCK,
                        window=WINDOW, use_kernels=True, prefix_cache=True,
                        cache_chunk=PC_CHUNK)
    prompts = http_prompts(SEED + 11)
    eng = ContinuousEngine(cfg, params, dcfg, max_slots=MAX_SLOTS,
                           max_gang=MAX_GANG, device=device,
                           prefix_cache=PrefixKVCache(
                               chunk_tokens=PC_CHUNK, max_bytes=4 << 30,
                               placement=device_placement(device)))
    t0 = time.perf_counter()
    warm = eng.prewarm([(HTTP_PROMPT, HTTP_GEN)])
    prewarm_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    tracer = Tracer()
    flight = FlightRecorder(os.path.join(tmp, "flight"), tracer=tracer)
    watchdog = RecordingWatchdog(ttfb_p50_s=600.0, token_latency_s=60.0,
                                 flight=flight)
    eng.profiler = BlockProfiler(tmp, 2)
    loop = _front(eng, HTTP_MAX_PENDING, tracer, steal=False,
                  audit=AuditConfig(sample_rate=0.5, oracle="auto"),
                  watchdog=watchdog, flight=flight, metrics_interval_s=0.5)
    frontend = HttpFrontend(loop, host="127.0.0.1", port=0, tracer=tracer,
                            flight=flight, watchdog=watchdog)

    # CUDA-event spans around every prefill and decode_block (the decode
    # thread's device work: serving and the audit lanes), each tagged
    # with its loop: a host-loop block's span also covers the gaps its
    # eager launches leave, so it counts as busy time the card idles
    marks = {}
    ops.reset_launches()
    server = HttpServerThread(frontend).start()
    with DeviceSpans(on_card, ("prefill", "decode_block")) as spans:
        try:
            out, endpoints, clock = asyncio.run(asyncio.wait_for(
                http_traffic(frontend.host, frontend.port, server, prompts,
                             lambda name: marks.setdefault(
                                 name, len(spans.spans))), 1200))
        finally:
            server.stop()
    launches = dict(ops.LAUNCHES)
    loop_joined = not loop.running
    window = clock["window_t1"] - clock["window_t0"]
    # device busy in the window: the spans that started inside it, split
    # by loop (graph: serving and the cold lane; host: the host lane)
    busy = {True: 0.0, False: 0.0}
    if on_card:
        torch.cuda.synchronize()
        inside = spans.spans[marks["t0"]:marks["t1"]]
        for fused in busy:
            group = [(a, b) for a, b, _, f in inside if f == fused]
            if group:
                busy[fused] = union_ms(group[0][0], group) / 1e3
    auditor = eng.auditor
    astats = auditor.stats()
    snap = eng.metrics.snapshot()
    comps = {c.uid: c for c in watchdog.comps}
    by_name = {n: r for n, r in out.items()}
    uid_of = {n: r["doc"]["uid"] for n, r in by_name.items()
              if r["doc"] is not None and "uid" in r["doc"]}
    # the disconnected stream's uid comes from its first chunk
    for n, r in by_name.items():
        if n not in uid_of and r.get("events"):
            uid_of[n] = r["events"][0]["uid"]

    # the reference: each request decoded alone (B = 1) by a cold
    # decoder; the audit's cold lane is one, with its graphs captured
    ref_dec = auditor._lane_decoders.get(("cold", HTTP_GEN)) or \
        DiffusionDecoder(cfg, params, dataclasses.replace(
            dcfg, gen_len=HTTP_GEN), device=device)
    tok = eng.tok
    alone, equal = {}, {}
    t_ref = time.perf_counter()
    for n, uid in sorted(uid_of.items()):
        c = comps.get(uid)
        if c is None:
            continue
        r = ref_dec.generate(tok.encode(by_name[n]["prompt"])[None].copy())
        conf = np.concatenate([bs.commit_conf[0] for bs in r.block_stats])
        k = len(c.tokens)
        alone[n] = r
        equal[n] = bool(np.array_equal(c.tokens, r.tokens[0][:k])
                        and (c.commit_conf is None or np.array_equal(
                            c.commit_conf, conf[:len(c.commit_conf)]))
                        and (c.cancelled or k == HTTP_GEN))
    ref_s = time.perf_counter() - t_ref

    timed = ("S0", "S1", "D0", "D1", "S2", "S3", "D2", "D3")
    finished = [n for n, u in uid_of.items()
                if u in comps and not comps[u].cancelled]
    sse_ok = {}
    for n in ("S0", "D0", "S2"):
        r = by_name[n]
        blocks = [e for e in r["events"] if "block" in e]
        sse_ok[n] = bool(
            r["doc"] is not None
            and [b["block"] for b in blocks] == list(range(len(blocks)))
            and blocks[-1]["finished"]
            and "".join(b["text"] for b in blocks) == r["doc"]["text"])
    d1, d3 = by_name["D1"]["doc"], comps.get(uid_of.get("D3"))
    burst = [r for n, r in by_name.items() if n.startswith("B")]
    refused = [r for r in burst if r["status"] == 429]
    admitted = [r for r in burst if r["status"] == 200]

    # endpoints
    st = {p: v[0] for p, v in endpoints.items()}
    fams = parse_prometheus(endpoints["/metrics"][2])

    def sample(fam, labels=""):
        rows = [v for _, lab, v in fams.get(fam, ()) if lab == labels]
        return rows[0] if rows else None

    dev_bytes = sample("repro_device_bytes_in_use", 'device="cuda:0"')
    cache_series = {f: sample(f) for f in (
        "repro_prefix_cache_hits_total", "repro_prefix_cache_hit_tokens_total",
        "repro_prefix_cache_evictions_total", "repro_prefix_cache_bytes",
        "repro_prefix_cache_chunks")}
    flight_doc = json.loads(endpoints["/debug/flight"][2])
    flight_files = sorted(os.listdir(flight_doc["path"])) \
        if flight_doc.get("path") else []

    # audits: a divergence is excused only as a near-tie at the flipped
    # decision (as compare_runs judges one)
    near_ties, real = [], []
    for res in auditor.results:
        if res.matched:
            continue
        c = comps.get(res.uid)
        blk, j = divmod(res.position, BLOCK)
        gap = math.inf
        if c is not None and c.commit_conf is not None \
                and res.position < len(c.commit_conf):
            conf = c.commit_conf[blk * BLOCK:(blk + 1) * BLOCK]
            gap = float(np.abs(np.delete(conf, j) - conf[j]).min())
        row = {"phase": "http_near_tie", **res.to_dict(), "gap": gap,
               "is_near_tie": gap < NEAR_TIE}
        print(json.dumps(row), flush=True)
        (near_ties if gap < NEAR_TIE else real).append(row)

    # the profiler's trace
    trace_path = eng.profiler.trace_path
    kernels_traced = {}
    if os.path.exists(trace_path):
        with open(trace_path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        kernels_traced = {k: sum(k in nm for nm in names)
                          for k in ("attn_", "conf_", "gemm")}

    def pct(vals, p):
        return percentile(list(vals), p) if vals else None

    timed_uids = {uid_of[n] for n in timed if n in uid_of}
    em = [r for r in eng.metrics.requests if r.uid in timed_uids]
    done_docs = [by_name[n]["doc"] for n in timed
                 if by_name[n]["doc"] is not None]
    client_tokens = sum(d["n_tokens"] for d in done_docs)
    rec = {
        "phase": "http", "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "method": dcfg.method,
        "prompt_len": HTTP_PROMPT, "shared_prefix": HTTP_SHARED,
        "max_tokens": HTTP_GEN, "max_slots": MAX_SLOTS, "max_gang": MAX_GANG,
        "max_pending": HTTP_MAX_PENDING, "prewarm": warm,
        "prewarm_s": prewarm_s, "bytes_in_use_before": mem_before,
        "window_s": window,
        "client": {
            "requests": len(done_docs), "tokens": client_tokens,
            "tok_s": client_tokens / window,
            "ttfb_p50_s": pct([by_name[n]["ttfb_s"] for n in timed
                               if by_name[n]["ttfb_s"] is not None], 50),
            "ttfb_p90_s": pct([by_name[n]["ttfb_s"] for n in timed
                               if by_name[n]["ttfb_s"] is not None], 90),
            "latency_p50_s": pct([by_name[n]["latency_s"] for n in timed
                                  if by_name[n]["doc"] is not None], 50),
            "latency_p90_s": pct([by_name[n]["latency_s"] for n in timed
                                  if by_name[n]["doc"] is not None], 90)},
        "engine": {
            "requests": len(em), "tokens": sum(r.n_tokens for r in em),
            "tok_s": sum(r.n_tokens for r in em) / window,
            "ttfb_p50_s": pct([r.ttfb_s for r in em], 50),
            "ttfb_p90_s": pct([r.ttfb_s for r in em], 90),
            "latency_p50_s": pct([r.latency_s for r in em], 50),
            "latency_p90_s": pct([r.latency_s for r in em], 90),
            "throughput_tok_s_all": snap["throughput_tok_s"],
            "mean_occupancy": snap["mean_occupancy"]},
        "device_busy_s": {"graph_loop": busy[True],
                          "host_loop_lane": busy[False]}
        if on_card else None,
        "device_idle_share": 1 - (busy[True] + busy[False]) / window
        if on_card else None,
        "device_spans_in_window": marks["t1"] - marks["t0"],
        "audit": astats, "audit_near_ties": len(near_ties),
        "lane_graphs": auditor.lane_graphs(),
        "serving_graphs": eng.graph_cache_size(),
        "post_warm_captures": snap["post_warm_compiles"],
        "scrapes_while_auditing": clock["scrapes_while_auditing"],
        "deadline": {k: d1[k] for k in ("n_tokens", "n_blocks",
                                         "finish_reason", "cancelled")},
        "cache_hit_tokens": {n: by_name[n]["doc"]["cache_hit_tokens"]
                             for n in ("S0", "S1", "S2", "S3")},
        "burst": {"refused": len(refused), "admitted": len(admitted),
                  "inflight_at_drain": clock["inflight_at_drain"],
                  "retry_after": [r["headers"].get("retry-after")
                                  for r in refused]},
        "status": st, "metrics_families": len(fams),
        "device_bytes_in_use_metric": dev_bytes,
        "prefix_cache_series": cache_series,
        "flight": {"dumps": flight_doc.get("dumps"), "files": flight_files},
        "profiler": {"trace": os.path.exists(trace_path),
                     "kernels": kernels_traced},
        "launches": launches, "equals_alone_b1": equal,
        "reference_s": ref_s}
    checks = {
        "prewarm_gang_sizes_1_4": warm["batch_sizes"] == [1, 2, 3, 4],
        "finished_equal_alone_b1": bool(finished) and all(
            equal.get(n, False) for n in finished)
        and set(finished) >= {"warmup", "S0", "S1", "D0", "S2", "S3", "D2"},
        "deadline_partial": d1["cancelled"]
        and d1["finish_reason"] == "deadline"
        and 0 < d1["n_tokens"] < HTTP_GEN and equal.get("D1", False),
        "disconnect_cancelled": d3 is not None and d3.cancelled,
        "sse_in_block_order_joined_equals_final": all(sse_ok.values()),
        "cache_hits": all(by_name[n]["doc"]["cache_hit_tokens"]
                          == HTTP_SHARED for n in ("S2", "S3")),
        "endpoints_200": all(v == 200 for v in st.values()),
        "metrics_device_bytes": (dev_bytes or 0) > 0 or not on_card,
        "metrics_cache_series": None not in cache_series.values()
        and cache_series["repro_prefix_cache_hits_total"] >= 1,
        "flight_dump": set(flight_files) >= {"trace.json", "metrics.json",
                                             "state.json"},
        "audits": astats["completed"] >= 2 and astats["errors"] == 0
        and {r.lane for r in auditor.results} == {"host", "cold"},
        "audit_no_divergence_but_near_ties": not real,
        "no_capture_after_prewarm": snap["post_warm_compiles"] == 0,
        "profiler_trace": os.path.exists(trace_path) and (
            not on_card or all(kernels_traced.values())),
        "refused_429_retry_after": len(refused) >= 1 and all(
            int(r["headers"].get("retry-after", 0)) >= 1 for r in refused),
        "drain_finished_inflight": bool(admitted) and all(
            not r["doc"]["cancelled"] and r["doc"]["n_tokens"] == HTTP_GEN
            for r in admitted) and clock["inflight_at_drain"] >= 1,
        "loop_thread_joined": loop_joined,
        "kernels_launched": not on_card or launched(launches)}
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    # the engine is held by the loop, the front end, the server thread
    # and the flight recorder's state provider (cycles: gc)
    del eng, loop, frontend, server, auditor, ref_dec, alone, watchdog
    del comps, flight, tracer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rec["bytes_in_use_after"] = bytes_in_use()
    rec["phase_s"] = time.perf_counter() - t_phase
    shutil.rmtree(tmp, ignore_errors=True)
    for name, keys in (
            ("http_timing", ("window_s", "client", "engine")),
            ("http_idle", ("device_busy_s", "device_idle_share")),
            ("http_audit", ("audit", "audit_near_ties", "lane_graphs",
                            "post_warm_captures")),
            ("http_memory", ("bytes_in_use_before", "bytes_in_use_after"))):
        print(json.dumps({"phase": name, **{k: rec[k] for k in keys}}),
              flush=True)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"http phase failed: {checks}")
    return rec


# ------------------------------------------------------------ fleet

FLEET_PROMPT, FLEET_SHARED, FLEET_GEN = 256, 192, 128
FLEET_SLOTS, FLEET_GANG = 4, 2
FLEET_NEW_BUCKET = 128          # the capture under load's prompt length
FLEET_WAVE1 = 5                 # wave 1 fills 2 gangs of 2 and queues 1
FLEET_WAIT_S = 600
FLEET_HOLD_S = 120              # the victim holds its parked row at most


def fleet_prompts(seed):
    """The fleet phase's 8 prompts, strings of 256 one-byte tokens: S0-S3
    share their first 192 characters, D0-D3 are distinct (as the http
    phase builds them), in arrival order: wave 1 S0 D0 S1 D1 S2, wave 2
    D2 S3 D3."""
    p = http_prompts(seed)
    names = ("S0", "D0", "S1", "D1", "S2", "D2", "S3", "D3")
    return [(n, p[n[0]][int(n[1])]) for n in names]


class FleetClient:
    """Submits requests to a loop or a router and times each on the
    caller's side: TTFB to the first chunk event, latency to the done
    event (a stolen request keeps its first submission's clock)."""

    def __init__(self):
        self.recs = []

    def submit(self, target, name, prompt):
        import threading

        from repro_torch.server.types import ServerRequest
        rec = {"name": name, "prompt": prompt, "t_first": None,
               "t_done": None, "comp": None, "dones": 0,
               "done": threading.Event()}

        def deliver(ev, rec=rec):
            now = time.perf_counter()
            if ev[0] == "chunk" and rec["t_first"] is None:
                rec["t_first"] = now
            elif ev[0] == "done":
                rec["t_done"], rec["comp"] = now, ev[1]
                rec["dones"] += 1
                rec["done"].set()

        rec["t_submit"] = time.perf_counter()
        t = target.submit(ServerRequest(prompt=prompt,
                                        max_tokens=FLEET_GEN), deliver)
        if t.loop is None:
            t.loop = target
        rec["ticket"], rec["first_loop"] = t, t.loop
        self.recs.append(rec)
        return rec

    def wait(self, timeout_s=FLEET_WAIT_S):
        t0 = time.perf_counter()
        for rec in self.recs:
            left = timeout_s - (time.perf_counter() - t0)
            if not rec["done"].wait(max(left, 0.0)):
                raise AssertionError(f"fleet: {rec['name']} never finished")

    def timing(self) -> dict:
        from repro_torch.serving.metrics import percentile
        t0 = min(r["t_submit"] for r in self.recs)
        t1 = max(r["t_done"] for r in self.recs)
        toks = sum(r["comp"].n_tokens for r in self.recs)
        ttfb = [r["t_first"] - r["t_submit"] for r in self.recs
                if r["t_first"] is not None]
        lat = [r["t_done"] - r["t_submit"] for r in self.recs]
        return {"requests": len(self.recs), "tokens": toks,
                "window_s": t1 - t0, "tok_s": toks / (t1 - t0),
                "ttfb_p50_s": percentile(ttfb, 50),
                "ttfb_p90_s": percentile(ttfb, 90),
                "latency_p50_s": percentile(lat, 50),
                "latency_p90_s": percentile(lat, 90)}


class ThreadLaunches:
    """While open, every ``ops.count`` (the wrappers' and a replay's)
    also adds to its thread's row, so a run's launches split by engine
    (each engine counts on its loop's thread)."""

    def __enter__(self):
        import threading
        self.rows, self.saved = {}, ops.count

        def count(counts):
            self.saved(counts)
            row = self.rows.setdefault(threading.get_ident(),
                                       dict.fromkeys(ops.LAUNCHES, 0))
            for name, n in counts.items():
                row[name] += n

        ops.count = count
        return self

    def __exit__(self, *exc):
        ops.count = self.saved

    def of(self, lp) -> dict:
        return self.rows.get(lp._thread.ident, dict.fromkeys(ops.LAUNCHES, 0))


def preempt_after_first_block(eng, out, thief=None):
    """Wrap ``eng.step`` (called on its loop's thread): after the first
    step that leaves a gang past its first block, preempt that gang's
    first live row, once. The row parks at the next block boundary.

    ``thief`` (the steal fleet's other engine): while a row is parked
    here and the thief has adopted fewer than two requests, ``eng``
    holds at the block boundary (``step`` returns nothing) instead of
    ticking, for at most ``FLEET_HOLD_S``. Its loop keeps serving
    commands between the calls, steals included, so the parked row is
    stolen rather than resumed here. Without the hold, which of the two
    happens is decided by the two threads' timing
    (``tests/test_torch_steal_race.py``)."""
    step = eng.step
    held = {}

    def wrapped():
        if thief is not None and eng.scheduler.paused \
                and thief.metrics.steals_in < 2:
            t0 = held.setdefault("t0", time.perf_counter())
            if time.perf_counter() - t0 < FLEET_HOLD_S:
                time.sleep(0.002)
                return []
        comps = step()
        if not out:
            for g in eng.scheduler.gangs:
                rows = g.live_rows()
                if 1 <= g.state.block_idx < g.state.n_blocks - 1 and rows:
                    eng.preempt(g.requests[rows[0]].uid)
                    out.append(g.requests[rows[0]].uid)
                    break
        return comps

    eng.step = wrapped


def engine_busy(engines):
    return [(e.metrics.prefill_busy_s, e.metrics.decode_busy_s)
            for e in engines]


def run_fleet(loops, target, prompts, spans, wave2, preempt_eng,
              thief=None):
    """Start ``loops``, submit wave 1 (the first ``FLEET_WAVE1`` of
    ``prompts``) to ``target``, then the rest once ``wave2(t0)`` returns,
    and wait for every request; one row of ``preempt_eng`` is preempted
    after its first block. With ``thief`` (a steal fleet) wave 1 is
    queued before the loops start, so the victim forms its gangs from
    all of it at once, and the victim holds its parked row for the
    thief (``preempt_after_first_block``). The launch counts are zeroed
    just before the run and read just after it, in all and by engine.
    Returns the run's record (client, preempted uid, span marks, busy
    seconds and launches per engine) and the wave-2 offset."""
    engines = [lp.engine for lp in loops]
    busy0 = engine_busy(engines)
    client, preempted = FleetClient(), []
    preempt_after_first_block(preempt_eng, preempted, thief)
    if thief is None:
        for lp in loops:
            if not lp.running:
                lp.start()
    ops.reset_launches()
    with ThreadLaunches() as by_thread:
        start = spans.mark()
        for name, p in prompts[:FLEET_WAVE1]:
            client.submit(target, name, p)
        for lp in loops:
            if not lp.running:
                lp.start()
        t0 = client.recs[0]["t_submit"]
        wave2(t0)
        offset = time.perf_counter() - t0
        for name, p in prompts[FLEET_WAVE1:]:
            client.submit(target, name, p)
        client.wait()
        end = spans.mark()
    launches = dict(ops.LAUNCHES)
    del preempt_eng.step
    busy = [(a1 - a0, b1 - b0) for (a0, b0), (a1, b1)
            in zip(busy0, engine_busy(engines))]
    by_engine = [by_thread.of(lp) for lp in loops]
    return {"client": client, "busy": busy, "preempted": preempted,
            "engines": engines, "marks": (start, end), "launches": launches,
            "launches_by_engine": by_engine,
            "launches_on_engine_threads": {
                k: sum(r[k] for r in by_engine) for k in launches}}, offset


def run_summary(run) -> dict:
    t = run["client"].timing()
    return {"timing": t, "engines": [
        {"prefill_busy_s": a, "decode_busy_s": b} for a, b in run["busy"]],
        "busy_sum_over_window": sum(a + b for a, b in run["busy"])
        / t["window_s"],
        "graphs": [e.graph_cache_size() for e in run["engines"]],
        "concluded_once": all(r["dones"] == 1 for r in run["client"].recs),
        "launches": run["launches"],
        "launches_by_engine": run["launches_by_engine"]}


def phase_fleet(cfg, params, device="cuda"):
    """Several engines on one card (ROADMAP A10): llada-8b at full width
    and depth on the serve phase's weights, ``DecodeConfig(method=
    "streaming", gen_len=128, block_size=32, window=96, prefix_cache=True,
    cache_chunk=16)``, every engine ``ContinuousEngine(max_slots=4,
    max_gang=2)`` with gangs padded to 2 rows (one set of 4 graphs an
    engine), each on its own CUDA stream and ``EngineLoop`` thread. The 8
    requests of ``fleet_prompts`` arrive in two waves, of 5 (two gangs
    and one queued) and 3; one row of the first decode engine is
    preempted after its first block. Each run's launch counts are zeroed
    just before it and read just after it, in all and by engine (the
    loop thread that counted them); CUDA-event spans on every engine's
    stream bracket the card's idle share (``DeviceSpans.idle_share``).
    Runs:

    - steal fleet: two loops of role "both", each engine with its own
      store, under ``EngineRouter(steal=True)`` after ``prewarm_all``;
      every request goes to loop 0, so loop 1 serves only what it
      steals: the queued request at once, then the parked row; wave 2
      follows loop 1's adoption of the parked row. Wave 1 is queued
      before the loops start, and loop 0 holds at the block boundary
      while its parked row waits (``preempt_after_first_block``), so
      both steals happen by construction, not by the threads' timing.
      Then,
      while loop 0 decodes two more requests, loop 1's engine captures
      one block graph of a new bucket (128-token prompts) on its own
      thread, checked against the host loop;
    - baseline: one engine alone behind an ``EngineLoop``, wave 2 at the
      steal fleet's offset: the reference tokens and timings;
    - pool fleet: ``prefill:1,decode:1`` through the router over one
      shared ``PrefixKVCache(shared=True)``: a prefill-only engine and
      the baseline's engine (its store cleared), wave 2 at that offset.

    Checks (any failure raises): loop 1 stole at least 2 requests, one a
    parked row; every ticket concluded once; every completion of every
    run equals the baseline's tokens bit for bit; no capture after
    prewarm on a serving engine; handoffs out = in = the requests routed
    to the prefill pool; the prefill engine decoded nothing and holds no
    graph; every prime on the decode engine hit all 256 prompt tokens (16
    chunks: no remainder to compute); no pin left in the shared store;
    the capture under load made one graph whose block equals the host
    loop's, and loop 0's requests in its window equal the baseline; each
    run and the capture's window launched every kernel, every engine that
    decodes launched every kernel in its run, the prefill engine the GEMM
    and attention, and every launch was counted on an engine's thread."""
    import threading

    from repro_torch.cache import PrefixKVCache, device_placement
    from repro_torch.launch.serve import prewarm_all
    from repro_torch.obs import device_memory_stats
    from repro_torch.server import EngineLoop, EngineRouter
    from repro_torch.serving import ContinuousEngine
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()

    def bytes_in_use():
        mem = device_memory_stats().get("cuda:0")
        return int(mem["bytes_in_use"]) if mem else 0

    mem_before = bytes_in_use()
    dcfg = DecodeConfig(method="streaming", gen_len=FLEET_GEN,
                        block_size=BLOCK, window=WINDOW, use_kernels=True,
                        prefix_cache=True, cache_chunk=PC_CHUNK)
    prompts = fleet_prompts(SEED + 19)

    def store(shared=False):
        return PrefixKVCache(chunk_tokens=PC_CHUNK, max_bytes=4 << 30,
                             placement=device_placement(device),
                             shared=shared)

    def engine(st, prefill_only=False):
        return ContinuousEngine(cfg, params, dcfg, max_slots=FLEET_SLOTS,
                                max_gang=FLEET_GANG,
                                batch_multiple=FLEET_GANG, prefix_cache=st,
                                prefill_only=prefill_only, device=device)

    def loop(e, i, role="both"):
        return EngineLoop(e, max_pending=16, idle_poll_s=0.002, index=i,
                          role=role)

    shared = store(shared=True)
    base = engine(shared)                     # baseline, then pool decode
    steal_engines = [engine(store()), engine(store())]
    pre = engine(shared, prefill_only=True)
    t0 = time.perf_counter()
    bucket = [(FLEET_PROMPT, FLEET_GEN)]
    warm = {"steal": prewarm_all(steal_engines, bucket),
            "baseline": base.prewarm(bucket), "prefill": pre.prewarm(bucket)}
    prewarm_s = time.perf_counter() - t0
    graphs_warm = {"baseline": base.graph_cache_size(),
                   "steal": [e.graph_cache_size() for e in steal_engines],
                   "prefill": pre.graph_cache_size()}
    streams = [str(e.cuda_stream) for e in (base, *steal_engines, pre)]

    with DeviceSpans(on_card) as spans:
        # ------------------------------------------------- steal fleet
        sloops = [loop(e, i) for i, e in enumerate(steal_engines)]
        router = EngineRouter(sloops, steal=True)
        eng0, eng1 = steal_engines

        def after_paused_steal(t_wave1):
            # until loop 1 adopts the parked row (its second steal), or
            # loop 0 has nothing left that it could steal
            while eng1.metrics.steals_in < 2 and sloops[0].inflight \
                    and time.perf_counter() - t_wave1 < 120:
                time.sleep(0.005)

        steal_run, offset = run_fleet(sloops, sloops[0], prompts, spans,
                                      after_paused_steal, eng0, thief=eng1)
        recs = steal_run["client"].recs
        steal_run.update(
            steals_in=[e.metrics.steals_in for e in steal_engines],
            steals_out=[e.metrics.steals_out for e in steal_engines],
            post_warm=[e.metrics.post_warm_compiles for e in steal_engines],
            paused_stolen=sum(bool(r["comp"].stolen) for r in recs),
            served_by_loop1=sum(r["ticket"].loop is sloops[1] for r in recs))

        # capture under load: loop 1's thread captures one graph of a
        # new bucket while loop 0 decodes two more requests
        trigger, captured, cap = threading.Event(), threading.Event(), {}
        small = np.stack([eng1.tok.encode(prompts[i][1])[:FLEET_NEW_BUCKET]
                          for i in (1, 3)]).astype(np.int32)

        def capture_once():
            if not trigger.is_set() or captured.is_set():
                return False
            try:
                dec = eng1.scheduler.decoder_for(FLEET_GEN)
                with eng1.on_stream():
                    g0, t_c = eng1.graph_cache_size(), time.perf_counter()
                    st = dec.prefill(small.copy(), cache=eng1.pool.acquire(
                        small.shape[0], small.shape[1] + FLEET_GEN))
                    dec.decode_block(st)
                    cap.update(t0=t_c, t1=time.perf_counter(),
                               graphs=eng1.graph_cache_size() - g0,
                               x=st.x.copy(),
                               thread=threading.current_thread().name)
                    eng1.scheduler._release(dec, st)
            except Exception as err:               # reported by a check
                cap["error"] = repr(err)
            captured.set()
            return True

        eng1.audit_tick = capture_once            # runs on loop 1's thread
        load = FleetClient()
        ops.reset_launches()
        for i in (0, 1):
            load.submit(sloops[0], *prompts[i])
        t = time.perf_counter()
        while not eng0.scheduler.gangs and time.perf_counter() - t < 60:
            time.sleep(0.002)
        trigger.set()
        load.wait()
        captured.wait(FLEET_WAIT_S)
        load_launches = dict(ops.LAUNCHES)
        del eng1.audit_tick
        if not router.close(drain=True, timeout_s=120):
            raise AssertionError("fleet: the steal fleet did not drain")
        steal_run["post_warm_after_capture"] = [
            e.metrics.post_warm_compiles for e in steal_engines]

        # ------------------------------------------------- baseline
        bloop = loop(base, 0)

        def at_offset(t_wave1):
            time.sleep(max(0.0, t_wave1 + offset - time.perf_counter()))

        base_run, _ = run_fleet([bloop], bloop, prompts, spans, at_offset,
                                base)
        if not bloop.close(drain=True, timeout_s=120):
            raise AssertionError("fleet: the baseline loop did not drain")
        base_run["post_warm"] = base.metrics.post_warm_compiles

        # ------------------------------------------------- pool fleet
        cleared = shared.clear()
        dec = base.scheduler.decoder_for(FLEET_GEN)
        hits, prime = [], dec.prime_prompt_kv

        def recording_prime(state):
            out = prime(state)
            hits.extend(int(h) for h in state.prefix_hit_tokens)
            return out

        dec.prime_prompt_kv = recording_prime
        ploops = [loop(pre, 0, "prefill"), loop(base, 1, "decode")]
        prouter = EngineRouter(ploops)
        hand0 = base.metrics.handoffs_in
        pool_run, _ = run_fleet(ploops, prouter, prompts, spans, at_offset,
                                base)
        if not prouter.close(drain=True, timeout_s=120):
            raise AssertionError("fleet: the pool fleet did not drain")
        del dec.prime_prompt_kv
        precs = pool_run["client"].recs
        pool_run.update(
            handoffs_out=pre.metrics.handoffs_out,
            handoffs_in=base.metrics.handoffs_in - hand0,
            to_prefill_pool=sum(r["first_loop"] is ploops[0]
                                for r in precs),
            handed_off=sum(bool(r["comp"].handed_off) for r in precs),
            prefill_decode_wall_s=pre.scheduler.decode_wall_s,
            prefill_graphs=pre.graph_cache_size(),
            decode_primes=len(hits), decode_prime_hits=sorted(set(hits)),
            store_cleared_chunks=cleared,
            pins_left=sum(n.refs for n in shared.tree.nodes),
            post_warm=base.metrics.post_warm_compiles)
        idle = {name: spans.idle_share(*r["marks"]) for name, r in (
            ("steal", steal_run), ("baseline", base_run),
            ("pool", pool_run))}

    # the reference: the baseline's tokens for each prompt
    ref = {r["name"]: r["comp"].tokens for r in base_run["client"].recs}

    def equal(client):
        return {r["name"]: bool(np.array_equal(r["comp"].tokens,
                                               ref[r["name"]])
                                and not r["comp"].cancelled)
                for r in client.recs}

    # the captured graph's first block against the host loop's
    host = DiffusionDecoder(cfg, params, dataclasses.replace(
        dcfg, fused=False), device=device)
    hst = host.prefill(small.copy())
    host.decode_block(hst)
    blk = slice(FLEET_NEW_BUCKET, FLEET_NEW_BUCKET + BLOCK)
    cap_equal = "x" in cap and bool(np.array_equal(cap["x"][:, blk],
                                                   hst.x[:, blk]))
    load_eq = equal(load)
    overlap = "t0" in cap and cap["t0"] < max(
        r["t_done"] for r in load.recs) and cap["t1"] > min(
        r["t_submit"] for r in load.recs)
    steal_eq, pool_eq = equal(steal_run["client"]), equal(pool_run["client"])
    rec = {"phase": "fleet", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "method": dcfg.method,
           "prompt_len": FLEET_PROMPT, "shared_prefix": FLEET_SHARED,
           "max_tokens": FLEET_GEN, "max_slots": FLEET_SLOTS,
           "max_gang": FLEET_GANG, "streams": streams, "prewarm": warm,
           "prewarm_s": prewarm_s, "graphs_after_prewarm": graphs_warm,
           "bytes_in_use_before": mem_before, "wave2_offset_s": offset,
           "baseline": run_summary(base_run),
           "steal": {**run_summary(steal_run), "equal_baseline": steal_eq,
                     **{k: steal_run[k] for k in (
                         "steals_in", "steals_out", "paused_stolen",
                         "served_by_loop1", "post_warm",
                         "post_warm_after_capture")}},
           "idle": idle,
           "pool": {**run_summary(pool_run), "equal_baseline": pool_eq,
                    **{k: pool_run[k] for k in (
                        "handoffs_out", "handoffs_in", "to_prefill_pool",
                        "handed_off", "prefill_decode_wall_s",
                        "prefill_graphs", "decode_primes",
                        "decode_prime_hits", "store_cleared_chunks",
                        "pins_left")}},
           "capture_under_load": {
               **{k: cap.get(k) for k in ("graphs", "thread", "error")},
               "seconds": cap["t1"] - cap["t0"] if "t0" in cap else None,
               "equals_host_loop": cap_equal, "overlapped_load": overlap,
               "load_equal_baseline": load_eq,
               "launches": load_launches}}
    runs = (steal_run, base_run, pool_run)
    # every engine that decodes: both steal engines, the baseline's, the
    # pool's decode engine; the prefill engine runs prefill's kernels
    decoders = [*steal_run["launches_by_engine"],
                *base_run["launches_by_engine"],
                pool_run["launches_by_engine"][1]]
    prefiller = pool_run["launches_by_engine"][0]
    checks = {
        "prewarm_graphs_4_4_4_0": not on_card or graphs_warm == {
            "baseline": 4, "steal": [4, 4], "prefill": 0},
        "steals_in_ge_2_one_paused": steal_run["steals_in"][1] >= 2
        and steal_run["paused_stolen"] >= 1,
        "concluded_once": all(rec[n]["concluded_once"]
                              for n in ("baseline", "steal", "pool")),
        "steal_equal_baseline": all(steal_eq.values()),
        "pool_equal_baseline": all(pool_eq.values()),
        "no_capture_after_prewarm": steal_run["post_warm"] == [0, 0]
        and steal_run["post_warm_after_capture"] == [0, 0]
        and base_run["post_warm"] == 0 and pool_run["post_warm"] == 0,
        "preempted_in_each_run": all(len(r["preempted"]) == 1 for r in (
            steal_run, base_run, pool_run)),
        "handoffs_out_eq_in_eq_routed": pool_run["handoffs_out"]
        == pool_run["handoffs_in"] == pool_run["to_prefill_pool"]
        == pool_run["handed_off"] >= 1,
        "prefill_engine_decoded_nothing":
        pool_run["prefill_decode_wall_s"] == 0.0
        and pool_run["prefill_graphs"] == 0,
        "decode_primes_hit_every_aligned_token":
        pool_run["decode_primes"] >= 1 and pool_run["decode_prime_hits"]
        == [FLEET_PROMPT // PC_CHUNK * PC_CHUNK],
        "no_pin_leak": pool_run["pins_left"] == 0,
        "capture_under_load": cap.get("graphs") == 1 and "error" not in cap
        and cap_equal and overlap and all(load_eq.values()),
        "kernels_launched_in_each_run": not on_card or all(
            launched(r["launches"]) for r in runs)
        and launched(load_launches),
        "kernels_launched_by_each_decode_engine": not on_card or all(
            launched(row) for row in decoders),
        "prefill_engine_launched_its_kernels": not on_card or (
            prefiller["gemm"] > 0 and prefiller["block_attention"] > 0),
        "launches_only_on_engine_threads": all(
            r["launches_on_engine_threads"] == r["launches"] for r in runs)}
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    # the engines are held by the loops, the clients' tickets and the
    # closures that drove them
    del base, pre, steal_engines, eng0, eng1, sloops, ploops, router
    del prouter, bloop, host, hst, shared, dec, steal_run, base_run
    del pool_run, runs, load, recs, precs, prime, recording_prime
    del capture_once
    del after_paused_steal, at_offset
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rec["bytes_in_use_after"] = bytes_in_use()
    rec["phase_s"] = time.perf_counter() - t_phase
    for name in ("baseline", "steal", "pool"):
        r = rec[name]
        print(json.dumps({"phase": f"fleet_{name}", **r["timing"],
                          "engines": r["engines"],
                          "busy_sum_over_window": r["busy_sum_over_window"],
                          "idle": idle[name], "graphs": r["graphs"],
                          "launches": r["launches"],
                          "launches_by_engine": r["launches_by_engine"]}),
              flush=True)
    print(json.dumps({"phase": "fleet_memory", **{k: rec[k] for k in (
        "bytes_in_use_before", "bytes_in_use_after", "phase_s")}}),
        flush=True)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"fleet phase failed: {checks}")
    return rec


# ------------------------------------------------------------ train

# examples/train_and_serve.py's recipe at tiny-100m, and its decode
TRAIN_ARCH = "tiny-100m"
# the example's count. A rerun at the bench's count (benchmarks/common.py)
# when no method answers any prompt at 300, TRAIN_STEPS = (300, 1200),
# answered 2 of 32 and took ~185 s on the H100, which the script's
# 1200 s limit no longer holds (on the H100, 600 steps answered none)
TRAIN_STEPS = (300,)
TRAIN_BATCH, TRAIN_SEQ = 16, 76
EVAL_N, TRAIN_GEN, TRAIN_BLOCK, TRAIN_WINDOW = 32, 64, 8, 16
TRAIN_TAU0, TRAIN_ALPHA = 0.9, 0.3
# continuous serving's dtype: the card's batch invariance holds in bf16
# (gemm.cu); a CPU dry run sets float32
TRAIN_SERVE_DTYPE = "bfloat16"


def train_step_on(device, cfg, params, toks, noise):
    """Loss, gradients and the weights after one AdamW step (the
    recipe's optimizer) of ``params`` on ``device``."""
    leaves, td = tree.flatten(params_to(params, device))
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, _ = loss_given_noise(cfg, tree.unflatten(td, leaves),
                               toks.to(device), *(a.to(device)
                                                  for a in noise))
    grads = torch.autograd.grad(loss, leaves)
    opt = AdamWConfig(total_steps=TRAIN_STEPS[0])
    new, _, _ = adamw_update(opt, list(grads), adamw_init(opt, leaves),
                             [p.detach() for p in leaves])
    return loss.detach(), grads, new


def check_train_step(device):
    """Item 1: one float32 train step of ``tiny`` on ``device`` against
    the CPU from the same weights, batch and draw. Loss to rtol 1e-5;
    every gradient and every weight after AdamW to rtol 1e-4, atol 1e-6
    (``torch.testing.assert_close``, which raises)."""
    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    b = ArithmeticDataset(ByteTokenizer(cfg.vocab_size),
                          seq_len=28, seed=SEED).batch(0, 8)
    noise = draw_noise(torch.as_tensor(b.loss_mask),
                       torch.Generator().manual_seed(SEED + 1))
    toks = torch.as_tensor(b.tokens)
    ops.reset_launches()
    card = train_step_on(device, cfg, params, toks, noise)
    launched = dict(ops.LAUNCHES)
    host = train_step_on(torch.device("cpu"), cfg, params, toks, noise)
    torch.testing.assert_close(card[0].cpu(), host[0], rtol=1e-5, atol=0)
    errs = []
    for got, want in zip(card[1] + tuple(card[2]), host[1] + tuple(host[2])):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6)
        errs.append(float((got.cpu() - want).abs().max()))
    rec = {"phase": "train_step_card_vs_cpu", "arch": cfg.name,
           "loss": [float(card[0]), float(host[0])],
           "max_abs_err_grads": max(errs[:len(card[1])]),
           "max_abs_err_params": max(errs[len(card[1]):]),
           "launches": launched,
           "ok": not any(launched.values())}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the training route launched a kernel")


def train_recipe(cfg, steps, device):
    """Item 2: ``train`` with the example's recipe, one sync a step
    (``log_every=1``), so each step's wall is the difference of two log
    points. Returns (params, record)."""
    if device.type == "cuda":
        # what an earlier round's decoders left (their graph pools go with
        # the cyclic collector) is not this run's
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, hist = train(cfg, TrainConfig(
        steps=steps, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED,
        log_every=1), verbose=False, device=device)
    wall = time.perf_counter() - t0
    step_ms = 1e3 * np.diff([0.0] + [h["elapsed_s"] for h in hist])
    every = TrainConfig().log_every          # the reference's cadence
    logged = [{k: h[k] for k in ("step", "loss", "masked_acc")}
              for h in hist if h["step"] % every == 0
              or h["step"] == steps - 1]
    rec = {"phase": "train_run", "arch": cfg.name,
           "params_m": sum(p.numel() for p in tree.flatten(params)[0]) / 1e6,
           "steps": steps, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "log": logged, "wall_s": wall,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p90": float(np.percentile(step_ms, 90)),
           "first_step_ms": float(step_ms[0]),
           "train_tok_s": steps * TRAIN_BATCH * TRAIN_SEQ / wall,
           "peak_bytes": (torch.cuda.max_memory_allocated()
                          if device.type == "cuda" else None),
           "loss_fell": hist[-1]["loss"] < hist[0]["loss"]}
    emit(rec)
    if not rec["loss_fell"]:
        raise AssertionError(f"train: the loss did not fall: {logged}")
    return params, rec


def profile_train_steps(cfg, params, n: int = 5):
    """Where a train step's time goes, on the card: ``n`` steps of the
    recipe's step from the trained weights (after 2 warm-up steps), timed
    to a synchronize without the profiler, then ``n`` more under
    torch.profiler for device time by group; and the AdamW update alone
    (random gradients, issued from Python: ``eager_ms``). Idle share =
    1 - kernel time / unprofiled wall."""
    opt = AdamWConfig(total_steps=TRAIN_STEPS[0])
    step = make_train_step(cfg, opt)
    ds = ArithmeticDataset(ByteTokenizer(cfg.vocab_size), seq_len=TRAIN_SEQ,
                           seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = adamw_init(opt, tree.flatten(params)[0])
    batches = []
    for i in range(2 + 2 * n):
        b = ds.batch(i, TRAIN_BATCH)
        lm = torch.as_tensor(b.loss_mask, device="cuda")
        batches.append((torch.as_tensor(b.tokens, device="cuda"),
                        draw_noise(lm, gen)))
    p = params
    for b in batches[:2]:
        p, state, _ = step(p, state, *b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:2 + n]:
        p, state, _ = step(p, state, *b)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[2 + n:]:
            p, state, _ = step(p, state, *b)
        torch.cuda.synchronize()
    groups, kernels, _ = kernel_groups(prof, "")
    busy = sum(groups.values()) / n
    leaves = tree.flatten(p)[0]
    grads = [torch.randn_like(x) for x in leaves]
    opt_ms = eager_ms(lambda: adamw_update(opt, grads, state, leaves), [()],
                      iters=10)
    rec = {"phase": "train_profile", "steps": n, "wall_ms_per_step":
           wall_us / 1e3, "device_kernel_ms_per_step": busy / 1e3,
           "device_idle_share": 1 - busy / wall_us,
           "device_ms_per_step_by_group": {k: v / n / 1e3
                                           for k, v in groups.items()},
           "kernel_launches_per_step": sum(cnt for _, _, cnt in kernels) / n,
           "adamw_update_ms": opt_ms,
           "top": [{"name": k[:80], "device_us_per_step": us / n,
                    "calls_per_step": cnt / n}
                   for us, k, cnt in kernels[:6]]}
    emit(rec)
    return rec


def checkpoint_round_trip(cfg, params, device):
    """Item 3: save through the port's writer, restore into fresh params,
    every leaf bit-equal."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tiny100m")
        checkpoint.save(path, params, cfg, {"steps": "chip_smoke"})
        nbytes_ = os.path.getsize(path + ".npz") + os.path.getsize(
            path + ".json")
        fresh = init_params(cfg, torch.Generator(device=device).manual_seed(
            SEED + 5), device)
        back = checkpoint.restore(path, fresh, cfg)
        n_leaves = json.load(open(path + ".json"))["n_leaves"]
    a, b = tree.flatten(params)[0], tree.flatten(back)[0]
    rec = {"phase": "train_checkpoint", "file_bytes": nbytes_,
           "n_leaves": n_leaves,
           "bit_equal": len(a) == len(b) and all(
               x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(a, b))}
    emit(rec)
    if not rec["bit_equal"]:
        raise AssertionError("checkpoint round trip changed a leaf")


def block_summary(r, steps_cap):
    """Mean steps per block; mean tokens a row commits per step; whether
    some row committed several tokens in one step (a step's commits
    above its live rows); and the share of blocks whose loop closed
    before ``steps_cap`` (their remaining IF nodes skipped their
    bodies)."""
    steps = [s.steps for s in r.block_stats]
    committed = sum(sum(s.committed_per_step) for s in r.block_stats)
    row_steps = sum(s.steps * s.live_rows for s in r.block_stats)
    return {"steps_per_block": float(np.mean(steps)),
            "tokens_per_step": committed / max(row_steps, 1),
            "multi_token_step": any(max(s.committed_per_step) > s.live_rows
                                    for s in r.block_stats),
            "blocks": len(steps),
            "if_skip_share": float(np.mean([s < steps_cap for s in steps])),
            "early_exits": r.early_exits}


def methods_table(cfg, params, prompts, samples, tok, device):
    """Item 4: the five methods on the trained weights through the graph
    loop (an untimed run captures, the timed run replays) and the host
    loop, in bfloat16 (cast from the float32 weights: the timed route)
    and in float32. The graph loop's tokens and counters equal the host
    loop's. Returns the rows and the item's launches."""
    rows = []
    ops.reset_launches()
    for dtype in ("bfloat16", "float32"):
        dcfg_model = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        p = params_to(params, DTYPES[dtype])
        base_tps = None
        for method in DECODE_METHODS:
            d = DecodeConfig(method=method, gen_len=TRAIN_GEN,
                             block_size=TRAIN_BLOCK, window=TRAIN_WINDOW,
                             tau0=TRAIN_TAU0, alpha=TRAIN_ALPHA,
                             use_kernels=True)
            dec = DiffusionDecoder(dcfg_model, p, d, device=device)
            dec.generate(prompts.copy())               # captures
            before = dict(ops.LAUNCHES)
            r = dec.generate(prompts.copy())
            launched = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
            host = DiffusionDecoder(dcfg_model, p, dataclasses.replace(
                d, fused=False), device=device).generate(prompts.copy())
            tps = r.tokens_generated / r.wall_time
            if method == "vanilla":
                base_tps = tps
            row = {"dtype": dtype, "method": method,
                   "acc": exact_match(tok, r.tokens, samples),
                   "nfe": r.nfe, **block_summary(r, dec.steps_cap),
                   "tokens_generated": r.tokens_generated,
                   "tok_s": tps,
                   "speedup": tps / base_tps if base_tps else None,
                   "host_loop_s": host.wall_time,
                   "launches_per_block": {k: v / len(r.block_stats)
                                          for k, v in launched.items()},
                   **compare_runs(r, host, TRAIN_BLOCK)}
            rows.append(row)
            emit({"phase": "train_methods", **row})
            del dec
        del p
    return rows, dict(ops.LAUNCHES)


def continuous_on_trained(cfg, params, texts, device):
    """Item 5: the eval prompts through ``ContinuousEngine(max_slots=8,
    max_gang=4)`` after ``prewarm``, streaming, in ``TRAIN_SERVE_DTYPE``;
    every request equal (tokens and commit confidences) to its decode
    alone at B = 1."""
    from repro_torch.serving import ContinuousEngine
    cfg = dataclasses.replace(cfg, dtype=TRAIN_SERVE_DTYPE,
                              param_dtype=TRAIN_SERVE_DTYPE)
    p = params_to(params, DTYPES[TRAIN_SERVE_DTYPE])
    d = DecodeConfig(method="streaming", gen_len=TRAIN_GEN,
                     block_size=TRAIN_BLOCK, window=TRAIN_WINDOW,
                     tau0=TRAIN_TAU0, alpha=TRAIN_ALPHA, use_kernels=True)
    eng = ContinuousEngine(cfg, p, d, max_slots=MAX_SLOTS, max_gang=MAX_GANG,
                           device=device)
    warm = eng.prewarm([(len(eng.tok.encode(texts[0])), TRAIN_GEN)])
    # every gang block's (batch, live rows), and every compaction: a gang
    # gathered into a smaller batch (no request is preempted here)
    blocks, compactions = [], []
    decode_block = DiffusionDecoder.decode_block
    take_rows = DiffusionDecoder.take_rows

    def counted_block(self, state):
        blocks.append((state.batch, int((~state.done).sum())))
        return decode_block(self, state)

    def counted_take(self, state, rows, *a, **kw):
        compactions.append((state.batch, len(rows)))
        return take_rows(self, state, rows, *a, **kw)

    DiffusionDecoder.decode_block = counted_block
    DiffusionDecoder.take_rows = counted_take
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        uids = [eng.submit(text, max_tokens=TRAIN_GEN) for text in texts]
        comps = eng.run_to_completion()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        DiffusionDecoder.decode_block = decode_block
        DiffusionDecoder.take_rows = take_rows
    snap = eng.metrics.snapshot()
    # each request alone (B = 1), through batch mode
    beng = ServingEngine(cfg, p, d, max_batch=1, mode="batch", device=device)
    alone_of = {beng.submit(text, max_tokens=TRAIN_GEN): u
                for u, text in zip(uids, texts)}
    by_uid = {c.uid: c for c in comps}
    equal = []
    while True:
        got = beng.step()                     # one batch of one request
        if not got:
            break
        conf = np.concatenate([bs.commit_conf[0]
                               for bs in beng.results[-1].block_stats])
        c = by_uid[alone_of[got[0].uid]]
        equal.append(bool(np.array_equal(c.tokens, got[0].tokens)
                          and np.array_equal(c.commit_conf, conf)))
    rec = {"phase": "train_continuous", "requests": len(comps),
           "graphs_prewarmed": warm["graphs"],
           "prewarm_batch_sizes": warm["batch_sizes"],
           "post_warm_captures": snap["post_warm_compiles"],
           "wall_s": wall, "tok_s": snap["tokens"] / wall,
           "tokens": snap["tokens"], "gang_blocks": len(blocks),
           "gang_sizes": sorted({b for b, _ in blocks}),
           "live_rows_per_gang_block": float(np.mean([n for _, n in blocks])),
           "compactions": sum(1 for b, n in compactions if n < b),
           "merges": snap["gang_merges"],
           "mean_occupancy": snap["mean_occupancy"],
           "steps_per_block": snap["device_steps_per_block"],
           "equal_to_b1": sum(equal), "launches": launches}
    rec["ok"] = (all(equal) and len(equal) == len(comps) == len(texts)
                 and rec["post_warm_captures"] == 0
                 and (device.type != "cuda" or launched(launches)))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"train phase, continuous: {rec}")
    return rec


def kernels_at_train_shapes(cfg):
    """Item 6: each kernel against its plain version, timed beside its
    bound (and the library call where there is one), at the shapes the
    trained model's bf16 decode gives it: a streaming denoise step of the
    32 prompts in block 0 (Sq = block + window + 1 = 25 queries a row
    over [76 cache slots, 12 valid || 25 self]), the head's block rows
    (32 x 8) over V = 320, and a step's gate/up product (32 x 25 rows,
    768 -> 2048)."""
    P = len(ByteTokenizer(cfg.vocab_size).encode(
        ArithmeticDataset(ByteTokenizer(cfg.vocab_size)).eval_set(1)[0]
        .prompt))
    Sq, T = TRAIN_BLOCK + TRAIN_WINDOW + 1, P + TRAIN_GEN
    attn = check_attention("tiny100m_step", (EVAL_N, Sq, T + Sq, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.head_dim),
                           torch.bfloat16, n_valid=P, q_start=P, timed=True)
    conf = check_confidence("tiny100m_head", EVAL_N * TRAIN_BLOCK,
                            cfg.vocab_size, torch.bfloat16,
                            mask_id=cfg.mask_token_id, timed=True)
    mm = check_gemm("tiny100m_step_gate_up", EVAL_N * Sq, cfg.d_model,
                    cfg.d_ff, plain=True)
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    rec = {"phase": "train_kernels",
           **{name: {k: r.get(k) for k in keys} for name, r in (
               ("block_attention", attn), ("confidence_argmax", conf),
               ("gemm", mm))}}
    emit(rec)
    return rec


def phase_train(device="cuda"):
    """The ``train`` phase (ROADMAP A12): train ``tiny-100m`` at full size
    on the card with ``examples/train_and_serve.py``'s recipe, write and
    read back its checkpoint, then serve the trained weights with all
    five methods through the graph loop and the kernels, and through
    ``ContinuousEngine``. Items, each raising on a failed check:
    1. one float32 train step of ``tiny``, card against CPU;
    2. the recipe (300 steps, batch 16, seq_len 76, seed 0): loss and
       masked accuracy at the log points, step ms, tokens/s, peak bytes;
       the last loss below the first;
    3. the checkpoint round trip, bit-equal;
    4. the methods table in bf16 and f32 on ``ds.eval_set(32)``: accuracy,
       NFE, steps per block, tokens per step, the share of blocks whose IF
       nodes skipped, tok/s and speedup; graph loop = host loop; some
       method commits several tokens in a step and some block exits
       early. If every accuracy is 0, the recipe reruns at the next count
       of ``TRAIN_STEPS``, if it lists one;
    5. continuous serving of the 32 prompts, each equal to its decode
       alone, no capture after prewarm;
    6. on the card, each kernel at the trained model's shapes against its
       plain version, timed beside its bound; and a train step profiled
       (device time by group, idle share, the AdamW update alone).
    Launches are counted over items 4 and 5 apart; every kernel must
    launch in each."""
    device = torch.device(device)
    t_phase = time.perf_counter()
    check_train_step(device)
    cfg = get_config(TRAIN_ARCH, block_size=TRAIN_BLOCK)
    tok = ByteTokenizer(cfg.vocab_size)
    samples = ArithmeticDataset(tok, seq_len=TRAIN_SEQ,
                                seed=SEED).eval_set(EVAL_N)
    prompts = np.stack([tok.encode(s.prompt) for s in samples]
                       ).astype(np.int32)
    why = "the example's count"
    for steps in TRAIN_STEPS:
        params = None              # a rerun's peak bytes are its own
        params, run = train_recipe(cfg, steps, device)
        checkpoint_round_trip(cfg, params, device)
        rows, m_launches = methods_table(cfg, params, prompts, samples, tok,
                                         device)
        if any(r["acc"] > 0 for r in rows):
            break
        why = f"every method's accuracy was 0 at {steps} steps"
        if steps != TRAIN_STEPS[-1]:
            print(json.dumps({"phase": "train_retrain", "steps": steps,
                              "why": why}), flush=True)
    cont = continuous_on_trained(cfg, params, [s.prompt for s in samples],
                                 device)
    kern = prof = None
    if device.type == "cuda":
        kern = kernels_at_train_shapes(cfg)
        prof = profile_train_steps(cfg, params)
    checks = {
        "graph_loop_equals_host_loop": all(r["ok"] for r in rows),
        "multi_token_commits": any(r["multi_token_step"] for r in rows),
        "early_exit": any(r["early_exits"] > 0 for r in rows),
        # the CPU (a dry run) takes the plain versions and counts nothing
        "kernels_launched_in_methods": device.type != "cuda"
        or launched(m_launches),
        "kernels_launched_in_continuous": device.type != "cuda"
        or launched(cont["launches"])}
    rec = {"phase": "train", "arch": cfg.name, "steps": run["steps"],
           "steps_why": why,
           "step_ms_p50": run["step_ms_p50"],
           "train_tok_s": run["train_tok_s"],
           "peak_bytes": run["peak_bytes"],
           "methods": {f"{r['dtype']}/{r['method']}": {k: r[k] for k in (
               "acc", "nfe", "steps_per_block", "tokens_per_step",
               "if_skip_share", "tok_s", "speedup")} for r in rows},
           "launches_per_block": {f"{r['dtype']}/{r['method']}":
                                  r["launches_per_block"] for r in rows},
           "methods_launches": m_launches,
           "kernels_at_train_shapes": kern, "train_profile": prof,
           "continuous_launches": cont["launches"],
           "phase_s": time.perf_counter() - t_phase, "checks": checks,
           "ok": all(checks.values())}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"train phase failed: {checks}")
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


# ------------------------------------------------------------ dry run

# the serve phase's step: 4 prompts of 128 + 256 generated tokens, one
# streaming step (block + window + 1 queries) against the whole cache
DRY_SHAPE = dict(seq=PROMPT_LEN + GEN_LEN, batch=N_PROMPTS, kind="decode")
# counted on the production (16, 16) mesh: sizes that fit no card
DRY_BIG = (("kimi-k2-1t-a32b", "decode_32k"), ("qwen3-32b", "decode_32k"))
DRY_LIMIT_S = 30.0
DRY_RUNS = 5


def card_step(cfg, params, spec, device):
    """``spec``'s step on the card on real tensors of its shapes: the
    serve phase's weights, a cache of its (B, T) whose every slot is
    valid, the block's positions. Returns (ms a step, the (M, K, N) of
    every gemm.cu launch and the operations of every attention launch
    of one step (``kernels.cost``, from the launch's own inputs), the
    bytes of the step's arguments, the bytes the cache took)."""
    from repro_torch.kernels import cost
    B, T, Sq = spec.meta["batch"], spec.meta["seq"], spec.meta["q_len"]
    on_card = torch.device(device).type == "cuda"
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    cache = init_cache(cfg, B, T, device)
    cache_alloc = (torch.cuda.memory_allocated() - mem0) if on_card else None
    g = torch.Generator(device=device).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, Sq), generator=g,
                         device=device, dtype=torch.int32)
    pos = (PROMPT_LEN + torch.arange(Sq, device=device, dtype=torch.int32)
           )[None].expand(B, Sq).contiguous()
    kv_valid = torch.full((B,), T, dtype=torch.int32, device=device)
    args = (params, toks, pos, cache, kv_valid)
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in tree.flatten(list(args))[0])
    products, attention = [], []
    gemm_fn, attn_fn = ops.gemm, ops.block_attention

    def gemm_rec(x, w, *a):
        products.append((x.shape[0], w.shape[0], w.shape[1]))
        return gemm_fn(x, w, *a)

    def attn_rec(q, k, v, qp, kp, km, **kw):
        out = attn_fn(q, k, v, qp, kp, km, **kw)
        attention.append(cost.attention_cost(q, k, qp, kp, km, out,
                                             kw.get("window", 0))[0])
        return out

    ops.gemm, ops.block_attention = gemm_rec, attn_rec
    try:
        with torch.no_grad():
            spec.fn(*args)
    finally:
        ops.gemm, ops.block_attention = gemm_fn, attn_fn
    sync(device)
    with torch.no_grad():
        spec.fn(*args)
        sync(device)
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(DRY_RUNS):
                spec.fn(*args)
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1]) / DRY_RUNS
        else:
            t0 = time.perf_counter()
            for _ in range(DRY_RUNS):
                spec.fn(*args)
            ms = (time.perf_counter() - t0) * 1e3 / DRY_RUNS
    del cache, args
    return ms, products, attention, arg_bytes, cache_alloc


def dry_summary(rec) -> dict:
    """The numbers of a dry-run record this phase prints."""
    per = rec["per_device"]
    return {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "rank": rec["rank"], "flops": per["flops"],
            "hbm_bytes": per["hbm_bytes"],
            "argument_bytes": per["argument_bytes"],
            "temp_bytes": per["temp_bytes"],
            "total_bytes": per["total_bytes"], "fits_80gb": rec["fits_80gb"],
            "collectives": rec["collectives"], "links": rec["links"],
            "roofline": rec["roofline"],
            "dominant_term": rec["dominant_term"],
            "count_s": rec["compile_s"]}


def phase_dryrun(cfg, params, device="cuda"):
    """The dry run (ROADMAP A14: ``launch/steps.py``, ``launch/dryrun.py``)
    held against the card. (a) llada-8b's serve step at the serve phase's
    shape (``DRY_SHAPE``) on a (1, 1) mesh, counted on shape-only tensors;
    the same step function then runs on the card on the serve phase's
    weights (``card_step``): the count's gemm FLOPs equal the sum of 2 M K
    N over the step's gemm.cu launches, its attention FLOPs the sum of
    ``attention_bound``'s count over the attention launches, its argument
    bytes the card's tensors' bytes (the cache's allocation printed
    beside), and the measured step is not below the count's lower bound
    (max of its compute time and ``memory_floor_s``: the kernels' own
    bytes or the arguments read once, over the HBM rate), which a wrong
    count could make it; the unfused count's time is printed beside it
    as an upper estimate. (b) kimi-k2 and qwen3-32b ``decode_32k`` on the production
    (16, 16) mesh (``DRY_BIG``): one rank's FLOPs, bytes, collectives and
    dominant term, and whether its total fits 80 GB. (c) The counts
    launch nothing and allocate nothing on the card: ``ops.LAUNCHES`` and
    ``torch.cuda.memory_allocated()`` are the same before and after (a)
    and (b). The phase takes at most ``DRY_LIMIT_S``."""
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_production_mesh
    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    cfg = dataclasses.replace(cfg, block_size=BLOCK)
    spec = steps.build_serve(cfg, make_production_mesh(data=1, model=1),
                             DRY_SHAPE)
    step_ms, products, attention, card_args, cache_alloc = card_step(
        cfg, params, spec, device)
    # the card step's cache and inputs go before the snapshot
    free_device()
    sync(device)
    # no collection while the counts run: only they could move the
    # card's allocated bytes between the two snapshots
    gc.disable()
    try:
        before = (dict(ops.LAUNCHES),
                  torch.cuda.memory_allocated() if on_card else 0)
        t0 = time.perf_counter()
        small = dryrun.count(spec)
        small_s = time.perf_counter() - t0
        big = []
        with tempfile.TemporaryDirectory() as out:
            for arch, shape in DRY_BIG:
                big.append(dry_summary(dryrun.run_one(arch, shape, False,
                                                      out_dir=out)))
        after = (dict(ops.LAUNCHES),
                 torch.cuda.memory_allocated() if on_card else 0)
    finally:
        gc.enable()
    kernels = small["meter"].kernels
    terms = dryrun.roofline_terms(small, 1)
    # held against the lower bound (the kernels' own bytes or the
    # arguments read once); the unfused count's time printed beside it
    bound_ms = 1e3 * max(terms["compute_s"], terms["memory_floor_s"])
    unfused_ms = 1e3 * max(terms["compute_s"], terms["memory_s"])
    gemm_card = sum(2 * M * K * N for M, K, N in products)
    rec = {"phase": "dryrun", "arch": cfg.name, "shape": DRY_SHAPE,
           "q_len": spec.meta["q_len"], "count_s": small_s,
           "count": {"flops": small["flops"],
                     "gemm_flops": kernels["gemm"]["flops"],
                     "gemm_calls": kernels["gemm"]["calls"],
                     "attention_flops": kernels["block_attention"]["flops"],
                     "attention_calls": kernels["block_attention"]["calls"],
                     "hbm_bytes": small["hbm_bytes"],
                     "argument_bytes": small["argument_bytes"],
                     "temp_bytes": small["temp_bytes"],
                     "kernel_bytes": sum(k["bytes"]
                                         for k in kernels.values()),
                     "roofline": terms, "bound_ms": bound_ms,
                     "unfused_upper_estimate_ms": unfused_ms},
           "card": {"step_ms": step_ms, "gemm_launches": len(products),
                    "gemm_flops": gemm_card,
                    "attention_launches": len(attention),
                    "attention_flops": sum(attention),
                    "argument_bytes": card_args,
                    "cache_allocated_bytes": cache_alloc,
                    "step_over_bound": step_ms / bound_ms},
           "big": big, "launches_before_after": [before[0], after[0]],
           "allocated_before_after": [before[1], after[1]]}
    checks = {
        "gemm_flops_equal_launches": not on_card or (
            kernels["gemm"]["flops"] == gemm_card
            and kernels["gemm"]["calls"] == len(products)),
        "attention_flops_equal_bound_count": not on_card or (
            kernels["block_attention"]["flops"] == sum(attention)
            and kernels["block_attention"]["calls"] == len(attention)),
        "argument_bytes_equal_card": small["argument_bytes"] == card_args,
        "step_not_below_bound": step_ms >= bound_ms,
        "big_counted": len(big) == len(DRY_BIG)
        and all(b["flops"] > 0 for b in big),
        "count_touched_no_card": before == after}
    rec["seconds"] = time.perf_counter() - t_phase
    checks["within_limit"] = rec["seconds"] <= DRY_LIMIT_S
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    for b in big:
        print(json.dumps({"phase": "dryrun_rank", **b}), flush=True)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"dryrun phase failed: {checks}")
    return rec


# ------------------------------------------------------------ families

# families_reference: (arch, layers) at full width, the depth cut
FAM_REF = (("qwen3-32b", 2), ("phi4-mini-3.8b", 2), ("minitron-4b", 2),
           ("kimi-k2-1t-a32b", 1))
FAM_REF_TOL = 2e-2
FAM_FLIP_SHARE = 0.25          # tokens a near-tie may leave out, at most
FAM_SERVE = ("gemma2-27b", "olmoe-1b-7b")
# olmoe's continuous run: the max_tokens of its 6 requests (ragged, all
# in the 64-token bucket), on ContinuousEngine(max_slots=4, max_gang=4)
FAM_CONT_LENS = (64, 33, 48, 64, 40, 57)
FAM_SLOTS, FAM_GANG = 4, 4
# the gang sizes that run reaches (a gang of 4, then the other 2; the
# decodes alone at 1), prewarmed and no other: a capture costs ~9 s at
# olmoe's depth (64 experts: ~9k nodes a body, 31 copies)
FAM_CONT_SIZES = (1, 2, 4)
# depth cuts of the families phase (the whole script's time limit, since
# the recurrent phase was added): layers kept, the layout's pattern
# repeated; every check runs as at full depth
FAM_DEPTH = {"gemma2-27b": 8, "olmoe-1b-7b": 2}
# the configs served through that engine as well
FAM_CONTINUOUS = ("olmoe-1b-7b", "xlstm-350m")
# the families' dtype ("float32" for a CPU dry run, where bf16 rows are not
# batch-invariant)
FAM_DTYPE = "bfloat16"


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def plain_products():
    """The plain route's products: while open, ``ops.linear`` multiplies
    through ``torch.matmul`` (cuBLAS, TF32 off) in place of gemm.cu."""
    kernel = ops.gemm

    def plain(x, w, out_dtype=None, acc=None):
        if out_dtype is None:
            return torch.matmul(x, w)
        y = torch.matmul(x.float(), w.float())
        return y if acc is None else acc + y

    ops.gemm = plain
    try:
        yield
    finally:
        ops.gemm = kernel


@contextlib.contextmanager
def gemm_calls():
    """While open, every ``ops.gemm`` call is recorded as (x's dtype, K,
    N) before it launches."""
    calls, kernel = [], ops.gemm

    def recording(x, w, *out_dtype):
        calls.append((str(x.dtype).split(".")[-1], w.shape[0], w.shape[1]))
        return kernel(x, w, *out_dtype)

    ops.gemm = recording
    try:
        yield calls
    finally:
        ops.gemm = kernel


@contextlib.contextmanager
def routing():
    """While open, every MoE layer's routing is recorded: (router probs
    (T, E), top-k ids (T, k)) per call of ``models.moe.route``."""
    from repro_torch.models import moe
    seen, route = [], moe.route

    def recording(*a, **kw):
        out = route(*a, **kw)
        seen.append((out[0], out[2]))
        return out

    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = route


def gemm_per_pass(cfg, head: bool = True) -> int:
    """gemm.cu launches of one pass (a step's; a refresh scans each
    recurrent layer in two segments, so it runs that mixer's products
    twice): q, k, v and o per attention layer, 3 per recurrent one
    (``models/recurrent.py``'s fused products), its FFN's products
    (SwiGLU 3, GELU 2, MoE the router and 3 per expert) and the LM
    head."""
    ffn = {"swiglu": 3, "gelu": 2, "moe": 1 + 3 * cfg.n_experts, "none": 0}
    mixer = {"attn": 4, "attn_local": 4, "rglru": 3, "mlstm": 3, "slstm": 3}
    return sum(mixer[s.mixer] + ffn[s.ffn] for s in cfg.layout) + int(head)


def family_prompts(cfg, n, seed):
    tok = ByteTokenizer(cfg.vocab_size)
    return np.stack([tok.encode(p) for p in make_prompts(n, seed)]).astype(
        np.int32)


def family_passes(cfg, params, device, use_kernels):
    """A block refresh (an encode of the FAM_N x 192-token buffer into
    the cache) and a block-0 streaming step (FAM_SQ queries over the cache
    valid to the prompt): their logits."""
    T = FAM_PROMPT + FAM_GEN
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size - 2, (FAM_N, T))
                            .astype(np.int32)).to(device)
    pos = torch.arange(T, dtype=torch.int32, device=device)[None].expand(
        FAM_N, T)
    cache = init_cache(cfg, FAM_N, T, device)
    refresh = apply_model(cfg, params, tokens=toks, positions=pos,
                          cache=cache, use_kernels=use_kernels)
    step = apply_model(cfg, params,
                       tokens=toks[:, FAM_PROMPT:FAM_PROMPT + FAM_SQ],
                       positions=pos[:, FAM_PROMPT:FAM_PROMPT + FAM_SQ],
                       mode="step", cache=cache, use_kernels=use_kernels,
                       kv_valid=torch.full((FAM_N,), FAM_PROMPT,
                                           dtype=torch.int32, device=device))
    return {"refresh": refresh.logits, "step": step.logits}


def routing_flips(cfg, got, want, S_of):
    """Tokens whose top-k experts differ between the kernel route
    (``got``) and the plain route (``want``), per recorded layer call:
    [(pass, b, s, gap, moved)], with the plain route's gap between its
    k-th and (k+1)-th probability and the largest move of that token's
    router probabilities between the routes. A flip with gap <= moved is
    a near-tie: inputs that differ at bf16 resolution reorder it."""
    flips = []
    for call, ((pk, ik), (pp, ip)) in enumerate(zip(got, want)):
        same = (ik.sort(-1).values == ip.sort(-1).values).all(-1)
        srt = pp.sort(-1, descending=True).values
        gap = srt[:, cfg.moe_top_k - 1] - srt[:, cfg.moe_top_k]
        moved = (pk - pp).abs().max(-1).values
        S = S_of(call)
        for r in torch.nonzero(~same).flatten().tolist():
            flips.append((call, r // S, r % S, float(gap[r]),
                          float(moved[r])))
    return flips


def phase_families_reference(device="cuda", archs=FAM_REF):
    """The other dense families and kimi-k2's MoE at full width, depth
    cut (``FAM_REF``), bf16 random weights from seed 0: one refresh and
    one block-0 streaming step through the kernels (block_attention,
    gemm.cu for every product, the float32 router included) against the
    plain route (``attend_ref``, ``torch.matmul``) on the same weights.
    Each config is freed before the next loads.

    Tolerance: as the llada-8b reference phase, max |d logits| <= 2e-2 *
    max |logits|. A MoE token whose top-k experts differ between the
    routes is left out of that comparison only as a near-tie
    (``routing_flips``), and is counted. At most ``FAM_FLIP_SHARE`` of
    the tokens may be left out: kimi-k2's random router spreads its
    probabilities over 384 experts, so about 5 % of the tokens have a
    k-th and (k+1)-th probability closer than the routes' bf16
    difference moves them; a router that computed something else would
    flip most tokens."""
    t_phase = time.perf_counter()
    out = []
    for arch, layers in archs:
        t0 = time.perf_counter()
        cfg = get_config(arch, dtype=FAM_DTYPE, param_dtype=FAM_DTYPE,
                         n_layers=layers, reps=0, tail=())
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            SEED), device)
        sync(device)
        init_s = time.perf_counter() - t0
        leaves = tree.flatten(params)[0]
        moe_layers = [p["ffn"] for p in params["layers"]
                      if "router" in p.get("ffn", {})]
        ops.reset_launches()
        with gemm_calls() as calls, routing() as route_k:
            got = family_passes(cfg, params, device, True)
        sync(device)
        launches = dict(ops.LAUNCHES)
        with plain_products(), routing() as route_p:
            ops.reset_launches()
            want = family_passes(cfg, params, device, False)
            sync(device)
            plain_launches = dict(ops.LAUNCHES)
        T = FAM_PROMPT + FAM_GEN
        per_call = [T, FAM_SQ] if cfg.n_experts else []
        flips = routing_flips(cfg, route_k, route_p,
                              lambda c: per_call[c // layers]) \
            if cfg.n_experts else []
        rec = {"phase": "families_reference", "arch": arch,
               "layers": layers, "cut": f"n_layers {get_config(arch).n_layers}"
               f" -> {layers}", "d_model": cfg.d_model,
               "weights_gb": nbytes(*leaves) / 1e9, "init_s": init_s,
               "launches": launches, "plain_launches": plain_launches,
               "gemm_per_pass": gemm_per_pass(cfg),
               "tol_rel_to_max": FAM_REF_TOL}
        ok = True
        if cfg.n_experts:
            f32 = [c for c in calls if c[0] == "float32"]
            rec["router"] = {
                "param_dtypes": sorted({str(f["router"].dtype)
                                        for f in moe_layers}),
                "float32_products": len(f32),
                "all_float32_are_routers": all(
                    c[1:] == (cfg.d_model, cfg.n_experts) for c in f32)}
            ok = rec["router"]["param_dtypes"] == ["torch.float32"]
            rec["routing_flips"] = [
                {"pass": ("refresh", "step")[c // layers], "b": b, "s": s,
                 "gap": gap, "moved": moved} for c, b, s, gap, moved in flips]
        if torch.device(device).type == "cuda":
            # (on the CPU ops.linear is x @ w and reaches no ops.gemm)
            ok = ok and (launches["block_attention"] == 2 * layers
                         and launches["gemm"] == 2 * gemm_per_pass(cfg)
                         and len(calls) == launches["gemm"]
                         and not any(plain_launches.values()))
            if cfg.n_experts:
                ok = ok and (rec["router"]["float32_products"] == 2 * layers
                             and rec["router"]["all_float32_are_routers"])
        for name in ("refresh", "step"):
            g, w = got[name].float(), want[name].float()
            keep = torch.ones(g.shape[:2], dtype=torch.bool, device=g.device)
            for c, b, s, gap, moved in flips:
                if ("refresh", "step")[c // layers] == name and gap <= moved:
                    keep[b, s] = False
            err = (g - w).abs().amax(-1)[keep].max().item()
            scale = w.abs().max().item()
            agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
            rec[name] = {"logits_max_abs_err": err, "logits_max_abs": scale,
                         "rel_to_max": err / scale, "argmax_agreement": agree,
                         "tokens_left_out": int((~keep).sum()),
                         "finite": bool(torch.isfinite(g).all())}
            ok = ok and rec[name]["finite"] and err <= FAM_REF_TOL * scale \
                and int((~keep).sum()) <= FAM_FLIP_SHARE * keep.numel()
        ok = ok and all(gap <= moved for _, _, _, gap, moved in flips)
        rec["seconds"] = time.perf_counter() - t0
        rec["ok"] = ok
        emit(rec)
        out.append(rec)
        del params, leaves, moe_layers, got, want, route_k, route_p
        free_device()
        if not ok:
            raise AssertionError(f"families_reference {arch}: the kernel "
                                 "route disagrees with the plain route")
    emit({"phase": "families_reference", "seconds":
          time.perf_counter() - t_phase})
    return out


def family_decode(cfg, params, dcfg, dec, prompts, device, warm=True):
    """The graph loop (``dec``: a warm run that captures what it lacks,
    unless ``warm`` is False because its graphs are prewarmed, then a
    timed run, launches counted around it) against the host loop on the
    same prompts: tokens and counters (``compare_runs``), one host sync
    per block, the same launches."""
    t0 = time.perf_counter()
    if warm:
        dec.generate(prompts.copy())
    sync(device)
    warm_s = time.perf_counter() - t0
    ops.reset_launches()
    t1 = time.perf_counter()
    res = dec.generate(prompts.copy())
    sync(device)
    wall = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    hdec = DiffusionDecoder(cfg, params, dataclasses.replace(
        dcfg, fused=False), device=device)
    ops.reset_launches()
    t2 = time.perf_counter()
    host = hdec.generate(prompts.copy())
    sync(device)
    host_wall = time.perf_counter() - t2
    host_launches = dict(ops.LAUNCHES)
    n_blocks = len(res.steps_per_block)
    rec = {"nfe": res.nfe, "steps_per_block": res.steps_per_block,
           "tokens_generated": res.tokens_generated, "warm_run_s": warm_s,
           "wall_s": wall, "tok_s": res.tokens_generated / wall,
           "step_ms": 1e3 * wall / res.nfe,
           "host_syncs_per_block": res.host_syncs / n_blocks,
           "launches": launches,
           "launches_per_pass": {k: v / res.nfe for k, v in launches.items()},
           "launches_per_block": {k: v / n_blocks
                                  for k, v in launches.items()},
           "host_loop": {"wall_s": host_wall,
                         "tok_s": host.tokens_generated / host_wall,
                         "step_ms": 1e3 * host_wall / host.nfe,
                         "host_syncs": host.host_syncs,
                         "launches": host_launches},
           "vs_host_loop": compare_runs(res, host, BLOCK),
           "no_mask_left": bool((res.tokens != cfg.mask_token_id).all())}
    ok = (rec["vs_host_loop"]["ok"] and rec["host_syncs_per_block"] == 1.0
          and rec["no_mask_left"])
    if torch.device(device).type == "cuda":
        ok = ok and launches == host_launches and launched(launches, cfg)
    rec["ok"] = ok
    del hdec
    return rec, res


def profile_block(dec, prompts):
    """Block 0 of ``dec``'s decode (its graph already captured): wall
    without the profiler, then, from a fresh prefill, device time by
    group and the blocking syncs inside the block under torch.profiler."""
    state = dec.prefill(prompts.copy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.decode_block(state)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    twin = dec.prefill(prompts.copy())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("decode_block"):
            dec.decode_block(twin)
        torch.cuda.synchronize()
    groups, kernels, _ = kernel_groups(prof, "decode_block")
    busy = sum(groups.values())
    scans = {}
    for us, k, c in kernels:
        m = re.search(r"(rglru|mlstm|slstm)_scan_kernel", k)
        if m:
            prev = scans.get(m.group(0), {"device_us": 0.0, "calls": 0})
            scans[m.group(0)] = {"device_us": prev["device_us"] + us,
                                 "calls": prev["calls"] + c}
    return {"steps": state.steps_per_block[-1], "wall_us": wall_us,
            "scan_device_us": scans,
            "device_kernel_us": busy, "device_idle_share": 1 - busy / wall_us,
            "device_us_by_group": groups,
            "kernel_launches_traced": sum(c for _, _, c in kernels),
            "blocking_syncs_in_block": syncs_inside(prof, "decode_block"),
            "profile_s": time.perf_counter() - t1,
            "top": [{"name": k[:80], "device_us": us, "calls": c}
                    for us, k, c in kernels[:6]]}


def family_model(arch, device, depth=None):
    """A serve config at full width, bf16, random weights from seed 0, at
    full depth or cut to ``depth`` (``FAM_DEPTH``'s by default) layers,
    with its init time, weight bytes and the tied head's copy."""
    layers = depth or FAM_DEPTH.get(arch)
    cut = dict(n_layers=layers, reps=0, tail=()) if layers else {}
    cfg = get_config(arch, dtype=FAM_DTYPE, param_dtype=FAM_DTYPE, **cut)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        SEED), device)
    sync(device)
    info = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "cut": f"n_layers {get_config(arch).n_layers} -> {layers}"
            if layers else None,
            "params_b": sum(t.numel() for t in tree.flatten(params)[0])
            / 1e9, "weights_gb": nbytes(*tree.flatten(params)[0]) / 1e9,
            "init_s": time.perf_counter() - t0,
            "tied_head_copy_gb": cfg.d_model * cfg.vocab_size * 2 / 1e9
            if cfg.tie_embeddings else 0.0}
    return cfg, params, info


def family_continuous(cfg, params, eng, dec, device):
    """``FAM_CONT_LENS`` requests (ragged max_tokens, one bucket) through
    the prewarmed ``eng``, then each request alone at B = 1 on the same
    decoder: tokens and commit confidences equal bit for bit, no capture
    after prewarm, none for the B = 1 decodes either."""
    prompts = family_prompts(cfg, len(FAM_CONT_LENS), SEED + 11)
    graphs = dec.graph_cache_size()
    ops.reset_launches()
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_tokens=m) for p, m in zip(prompts,
                                                         FAM_CONT_LENS)]
    comps, sizes = [], set()
    while not eng.scheduler.idle:
        comps += eng.step()
        sizes |= {g.batch for g in eng.scheduler.gangs}
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    snap = eng.metrics.snapshot()
    by_uid = {c.uid: c for c in comps}
    alone = {}
    with eng.on_stream():
        for uid, p, m in zip(uids, prompts, FAM_CONT_LENS):
            r = dec.generate(p[None])
            gen, _ = eos_truncate(r.tokens[0], cfg.eos_token_id)
            conf = np.concatenate([bs.commit_conf[0]
                                   for bs in r.block_stats])
            c = by_uid[uid]
            alone[uid] = bool(np.array_equal(c.tokens, gen[:m])
                              and np.array_equal(c.commit_conf, conf))
    sync(device)
    rec = {"max_slots": FAM_SLOTS, "max_gang": FAM_GANG,
           "max_tokens": list(FAM_CONT_LENS), "requests": snap["requests"],
           "tokens": snap["tokens"], "wall_s": wall,
           "gang_sizes": sorted(sizes),
           "tok_s": snap["tokens"] / wall,
           "mean_occupancy": snap["mean_occupancy"],
           "host_syncs_per_block": snap["host_syncs_per_block"],
           "post_warm_captures": snap["post_warm_compiles"],
           "b1_captures": dec.graph_cache_size() - graphs,
           "launches": launches,
           "equals_decode_alone_b1": [alone[u] for u in uids]}
    rec["ok"] = (sorted(by_uid) == sorted(uids) and all(alone.values())
                 and rec["post_warm_captures"] == 0
                 and rec["b1_captures"] == 0
                 and rec["host_syncs_per_block"] == 1.0)
    return rec


def serve_family(arch, device, phase):
    """One config at full width (``family_model``: full depth unless
    ``FAM_DEPTH`` cuts it), streaming
    (gen_len 64, block 32, window 96), 2 prompts of 128 bytes: the graph
    loop (a warm run, then a timed run) against the host loop, tokens and
    counters equal, one host sync per block, and block 0 profiled (its
    blocking syncs: 1). A config in ``FAM_CONTINUOUS`` first prewarms
    ``ContinuousEngine(max_slots=4, max_gang=4)`` and decodes through its
    decoder's graphs, then serves ``FAM_CONT_LENS`` requests, each equal
    to its decode alone at B = 1, with no capture after prewarm. Step ms
    and tok/s beside the weight-bytes bound of a pass, launches per pass
    by kernel, peak bytes allocated and its seconds."""
    from repro_torch.serving import ContinuousEngine
    dcfg = DecodeConfig(method="streaming", gen_len=FAM_GEN, block_size=BLOCK,
                        window=WINDOW, use_kernels=True)
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cfg, params, info = family_model(arch, device)
    prompts = family_prompts(cfg, FAM_N, SEED)
    rec = {"phase": phase, **info, "method": dcfg.method,
           "prompts": FAM_N, "prompt_len": FAM_PROMPT, "gen_len": FAM_GEN,
           "block_size": BLOCK, "window": WINDOW}
    eng = None
    if arch.removesuffix("-smoke") in FAM_CONTINUOUS:
        eng = ContinuousEngine(cfg, params, dcfg, max_slots=FAM_SLOTS,
                               max_gang=FAM_GANG, device=device)
        t1 = time.perf_counter()
        rec["prewarm"] = eng.prewarm([(FAM_PROMPT, FAM_GEN)],
                                     batch_sizes=FAM_CONT_SIZES)
        rec["prewarm"]["wall_s"] = time.perf_counter() - t1
        dec = eng.scheduler.decoder_for(FAM_GEN)
    else:
        dec = DiffusionDecoder(cfg, params, dcfg, device=device)
    if cfg.tie_embeddings:
        # the decoder's contiguous (d, V) copy is the one every head
        # product reads (serving_head returns it again, no new copy)
        rec["tied_head_is_one_copy"] = (
            dec.head.is_contiguous() and dec.head.shape
            == (cfg.d_model, cfg.vocab_size)
            and serving_head(cfg, params) is dec.head)
    ctx = eng.on_stream() if eng is not None else contextlib.nullcontext()
    with ctx:
        rec["decode"], res = family_decode(cfg, params, dcfg, dec,
                                           prompts, device,
                                           warm=eng is None)
    rec["graphs"] = dec.graph_cache_size()
    rec["capture_s"] = dec.capture_time
    rec["weight_bound_ms_per_pass"] = 1e3 * rec["weights_gb"] * 1e9 \
        / HBM_BYTES_S
    rec["step_ms_over_bound"] = rec["decode"]["step_ms"] \
        / rec["weight_bound_ms_per_pass"]
    rec["gemm_per_pass_body"] = gemm_per_pass(cfg, head=False)
    if cfg.n_experts:
        rec["moe_gemm_per_pass"] = {
            "experts": cfg.n_layers * 3 * cfg.n_experts,
            "routers_f32": cfg.n_layers,
            "attention": 4 * cfg.n_layers}
    if torch.device(device).type == "cuda":
        with ctx:
            rec["profile_block0"] = profile_block(dec, prompts)
    if eng is not None:
        rec["continuous"] = family_continuous(cfg, params, eng, dec,
                                              device)
    if torch.device(device).type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.perf_counter() - t0
    checks = {"graph_loop_equals_host_loop": rec["decode"]["ok"],
              "tied_head_is_one_copy": rec.get("tied_head_is_one_copy",
                                               True),
              "continuous": rec.get("continuous", {}).get("ok", True),
              "one_sync_in_block0": len(rec.get("profile_block0", {}).get(
                  "blocking_syncs_in_block", [None])) == 1}
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    emit(rec)
    del cfg, params, dec, eng, res
    free_device()
    if not rec["ok"]:
        raise AssertionError(f"{phase} phase {arch} failed: {checks}")
    return rec


def phase_families(device="cuda", archs=FAM_SERVE):
    """gemma2-27b and olmoe-1b-7b at full width, depth cut to
    ``FAM_DEPTH``, bf16 random weights from seed 0 (``serve_family``). gemma2's tied head is one
    contiguous copy the decoder builds; olmoe also runs the continuous
    engine."""
    t_phase = time.perf_counter()
    out = {arch: serve_family(arch, device, "families") for arch in archs}
    emit({"phase": "families", "seconds": time.perf_counter() - t_phase})
    return out


# ------------------------------------------------------------ recurrent

# the recurrent families at full width and depth; the scans' shapes: a
# refresh scans the prefix (FAM_PROMPT tokens at block 0) and then the
# query region from the boundary state, a step the query region (FAM_SQ)
REC_SERVE = ("recurrentgemma-9b", "xlstm-350m")
# scans over S steps: the plain version's own error against float64 is
# measured beside the kernel's, and where the kernel's error from the
# plain version passes the base tolerance only the float64 comparison
# decides (SCAN_F64_FACTOR times the plain version's own error)
SCAN_F64_FACTOR = 2.0


def scan_shapes():
    """(kind, case, shape) at both models' refresh and step shapes."""
    rg = get_config("recurrentgemma-9b")
    xl = get_config("xlstm-350m")
    di = 2 * xl.d_model
    H = xl.n_heads
    out = []
    for tag, S in (("refresh", FAM_PROMPT), ("step", FAM_SQ)):
        out.append(("rglru", f"recurrentgemma_9b_{tag}",
                    (FAM_N, S, rg.lru_width)))
        out.append(("mlstm", f"xlstm_350m_{tag}",
                    (FAM_N, S, H, di // H // 2, di // H)))
        out.append(("slstm", f"xlstm_350m_{tag}",
                    (FAM_N, S, H, xl.d_model // H)))
    return out


def scan_inputs(kind, shape, dtype, seed=0):
    """Random inputs of one scan: activations in ``dtype``, state and
    gates float32, at the scales a pass gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shp, dt=torch.float32):
        return torch.randn(shp, generator=g, device="cuda").to(dt)

    if kind == "rglru":
        B, S, w = shape
        lam = torch.rand((w,), generator=g, device="cuda") * 0.5 + 0.4
        return rn(B, S, 2 * w), rn(B, S, w, dt=dtype), lam, rn(B, w)
    if kind == "mlstm":
        B, S, H, dk, dv = shape
        proj = rn(B, S, 2 * H * dk + H * dv + 2 * H, dt=dtype)
        return proj, rn(B, H, dk, dv), rn(B, H, dk), rn(B, H)
    B, S, H, hd = shape
    d = H * hd
    return (rn(B, S, 4 * d, dt=dtype), rn(4, H, hd, hd) / math.sqrt(hd),
            rn(B, d), rn(B, d), rn(B, d).abs() + 1.0, rn(B, d))


def scan_kernel(kind, shape, out_dtype):
    """The wrapper of ``kind``'s scan kernel on its inputs."""
    if kind == "rglru":
        return lambda *a: ops.rglru_scan(*a, out_dtype=out_dtype)
    if kind == "mlstm":
        _, _, H, dk, dv = shape
        return lambda *a: ops.mlstm_scan(*a, H=H, dk=dk, dv=dv,
                                         out_dtype=out_dtype)
    return lambda *a: ops.slstm_scan(*a, out_dtype=out_dtype)


def scan_plain(kind, shape, acc=torch.float32):
    """The plain version (``kernels.ref``) in ``acc``: the sequential
    form, as the kernel walks."""
    if kind == "rglru":
        return lambda *a: ref.rglru_scan_ref(*a, assoc=False, acc=acc)
    if kind == "mlstm":
        _, _, H, dk, dv = shape
        return lambda *a: ref.mlstm_scan_ref(*a, H=H, dk=dk, dv=dv, acc=acc)
    return lambda *a: ref.slstm_scan_ref(*a, acc=acc)


# leading time-axis inputs and trailing state inputs of each scan
SCAN_TIME = {"rglru": 2, "mlstm": 1, "slstm": 1}
SCAN_STATE = {"rglru": 1, "mlstm": 3, "slstm": 4}


def scan_split(kind, shape, args, S1):
    """The kernel over the first S1 steps, then over the rest from the
    state it returned (as a decode step resumes from a refresh's state),
    with float32 outputs: (hs of both, final state)."""
    kern = scan_kernel(kind, shape, torch.float32)
    T, n = SCAN_TIME[kind], SCAN_STATE[kind]
    first = kern(*[a[:, :S1].contiguous() for a in args[:T]], *args[T:])
    rest = kern(*[a[:, S1:].contiguous() for a in args[:T]],
                *args[T:len(args) - n], *first[1:])
    return (torch.cat([first[0], rest[0]], dim=1), *rest[1:])


def check_scan(kind, name, shape, dtype):
    """A scan kernel against its plain version on the same inputs:
    every output (the per-step values in float32 and the final state),
    max |kernel - plain| relative to that output's max, at 2e-5 (float32
    inputs) or 1e-4 (bfloat16); the plain version's own error against
    float64 is measured beside it (``SCAN_F64_FACTOR``). Also: the
    bfloat16 output is the float32 one rounded to nearest even, bit for
    bit; the first and last rows alone (B = 1) equal their rows in the
    batch bit for bit; the scan split at S / 2 and resumed from its
    state equals one scan bit for bit (``scan_split``); time, plain time
    and bound."""
    args = scan_inputs(kind, shape, dtype)
    got = scan_kernel(kind, shape, torch.float32)(*args)
    want = scan_plain(kind, shape)(*args)
    f64 = scan_plain(kind, shape, torch.float64)(*args)
    torch.cuda.synchronize()

    def rel(a, b):
        return max(float((x.double() - y.double()).abs().max()
                         / max(float(y.double().abs().max()), 1e-30))
                   for x, y in zip(a, b))

    err, err64, own64 = rel(got, want), rel(got, f64), rel(want, f64)
    tol = 1e-4 if dtype == torch.bfloat16 else 2e-5
    ok = err <= tol or err64 <= max(tol, SCAN_F64_FACTOR * own64)
    out_t = scan_kernel(kind, shape, dtype)(*args)
    bf16_exact = bool(torch.equal(out_t[0], got[0].to(dtype)))
    rows_alone = []
    for b in (0, shape[0] - 1):
        one = [a[b:b + 1] if a.dim() > 1 and a.shape[0] == shape[0]
               and not (kind == "slstm" and a is args[1]) else a
               for a in args]
        alone = scan_kernel(kind, shape, torch.float32)(*one)
        rows_alone.append(all(torch.equal(x[0], y[b])
                              for x, y in zip(alone, got)))
    split = scan_split(kind, shape, args, shape[1] // 2)
    split_equal = all(torch.equal(x, y) for x, y in zip(split, got))
    ok = ok and bf16_exact and all(rows_alone) and split_equal
    rec = {"phase": "recurrent", "kernel": f"{kind}_scan", "case": name,
           "shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "max_rel_err": err, "tol": tol, "max_rel_err_vs_f64": err64,
           "plain_rel_err_vs_f64": own64,
           "max_abs_err": float((got[0] - want[0]).abs().max()),
           "bf16_out_exact": bf16_exact, "rows_alone_equal": rows_alone,
           "split_equal": split_equal, "ok": ok}
    sets = [scan_inputs(kind, shape, dtype, seed=s)
            for s in range(n_copies(nbytes(*args, *got)))]
    kern = scan_kernel(kind, shape, dtype)
    t1, t2 = time_ms(kern, sets), time_ms(kern, sets)
    rec["kernel_ms"] = (t1 + t2) / 2
    rec["kernel_ms_turns"] = [t1, t2]
    rec["eager_ms"] = eager_ms(kern, sets)
    rec["plain_ms"] = time_ms(scan_plain(kind, shape), sets[:2], iters=2)
    rec["library_ms"] = None              # no single PyTorch call scans
    rec["bound_ms"], rec["bound_by"] = scan_bound(kind, shape, args,
                                                  out_t)
    emit(rec)
    if not ok:
        raise AssertionError(f"{kind}_scan {name}: {rec}")
    return rec


def recurrent_kernel_cases():
    """Each scan kernel at the refresh and step shapes of both models
    (bf16 inputs, as served) and in float32 at the step's; attention at
    D = 256 at recurrentgemma's step and refresh (16 heads over 1 KV head,
    window 2048), against its plain version and SDPA."""
    out = {}
    for kind, name, shape in scan_shapes():
        out[(kind, name)] = check_scan(kind, name, shape, torch.bfloat16)
        if name.endswith("step"):
            check_scan(kind, name + "_f32", shape, torch.float32)
    T = FAM_PROMPT + FAM_GEN
    rg = get_config("recurrentgemma-9b")
    fam = dict(n_valid=FAM_PROMPT, q_start=FAM_PROMPT, window=rg.local_window)
    H, Hkv, D = rg.n_heads, rg.n_kv_heads, rg.head_dim
    out["attn_step"] = check_attention(
        "recurrentgemma_9b_step_d256", (FAM_N, FAM_SQ, T + FAM_SQ, H, Hkv, D),
        torch.bfloat16, timed=True, **fam)
    check_attention("recurrentgemma_9b_refresh_d256", (FAM_N, T, T, H, Hkv,
                                                       D), torch.bfloat16,
                    timed=True, window=rg.local_window)
    return out


def phase_recurrent(device="cuda", archs=REC_SERVE):
    """The recurrent families, after the families' weights are freed:
    the scan kernels and D = 256 attention at their shapes
    (``recurrent_kernel_cases``, on the card), then recurrentgemma-9b
    (RG-LRU + local MQA attention, tied head) and xlstm-350m (mLSTM +
    sLSTM; also through the continuous engine) at full width and depth
    (``serve_family``)."""
    t_phase = time.perf_counter()
    cases = recurrent_kernel_cases() \
        if torch.device(device).type == "cuda" else {}
    out = {arch: serve_family(arch, device, "recurrent") for arch in archs}
    emit({"phase": "recurrent", "seconds": time.perf_counter() - t_phase})
    return out, cases


# ------------------------------------------------------------------ main

def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol
    (the identifier after its length digits, so the file name in the
    anonymous namespace's prefix does not match)."""
    m = re.search(r"\d((?:attn|conf|gemm|set_if|rglru|mlstm|slstm)_\w*?kernel)"
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


def phase_build():
    """Build every CUDA library of the port and its probe builds (one
    nvcc each, all started together), with ptxas and SASS reports."""
    t0 = time.perf_counter()
    # one nvcc per library, all started together: the port's kernel
    # libraries and their probe builds
    jobs = [("block_attention", ()), ("confidence", ()), ("graph_loop", ()),
            ("gemm", ()), ("recurrent", ()),
            ("block_attention", ("ATTN_PROBE=1",)),
            ("block_attention", ("ATTN_PROBE=2",)),
            ("confidence", ("CONF_PROBE=1",)),
            ("confidence", ("CONF_PROBE=2",)), ("gemm", ("GEMM_PROBE=1",))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: build.compile_library(*j), jobs))
    build.load("block_attention")
    build.load("confidence")
    build.load("graph_loop")
    build.load("gemm")
    build.load("recurrent")
    t_nvcc = time.perf_counter() - t0
    ptxas = [f for lib in libs[:5]
             for f in ptxas_report(lib.with_suffix(".log").read_text())]
    tool = cuobjdump_path()
    if tool:
        # one cuobjdump per library, all started together
        with ThreadPoolExecutor(5) as pool:
            reports = list(pool.map(lambda lib: sass_report(tool, lib),
                                    libs[:5]))
        sass = [dict(f, library=name) for (name, _), rep
                in zip(jobs[:5], reports) for f in rep]
    else:
        sass = "not available (no cuobjdump in the toolkit or Triton)"
    spills = [f for f in ptxas if f["spill_stores"] or f["spill_loads"]]
    emit({"phase": "build", "nvcc_s": t_nvcc,
          "reports_s": time.perf_counter() - t0 - t_nvcc,
          "libraries": [os.path.relpath(lib, ROOT) for lib in libs[:5]],
          "ptxas": ptxas, "spills": bool(spills),
          "cuobjdump": tool, "sass": sass})
    # every instantiation of the port's libraries, the D = 256 attention
    # kernel's included, fits its registers
    if spills:
        raise AssertionError(f"ptxas spills: {spills}")
    # the redesigned float32 GEMM (3xTF32 on mma.sync: HMMA) and sLSTM
    # scan (R in a cluster's shared memory: its dynamic bytes the plan's
    # at xlstm-350m's head dim, beside ptxas's registers)
    f32 = [f for f in sass if f["kernel"].startswith("gemm_f32")] \
        if tool else []
    xl = get_config("xlstm-350m")
    hd = xl.d_model // xl.n_heads
    plan = krec.slstm_plan(hd)
    di = 2 * xl.d_model
    rg = get_config("recurrentgemma-9b")
    emit({"phase": "build", "gemm_f32_sass": [
              {"kernel": f["kernel"], "HMMA": f["HMMA"]} for f in f32],
          "scan_ptxas": [{"kernel": f["kernel"], "registers": f["registers"],
                          "smem_static": f["smem_static"]}
                         for f in ptxas if "_scan_" in f["kernel"]],
          "slstm_plan": {"head_dim": hd, "cluster": plan.cluster,
                         "channels": plan.channels, "threads": plan.threads,
                         "smem_dynamic_bytes": plan.smem_bytes},
          # at the served batch (FAM_N rows), bf16 inputs
          "mlstm_plan": dataclasses.asdict(krec.mlstm_plan(
              FAM_N, xl.n_heads, di // xl.n_heads // 2, di // xl.n_heads,
              2)),
          "rglru_plan": dataclasses.asdict(krec.rglru_plan(
              FAM_N, rg.lru_width, 2))})
    if tool:
        # the bf16 GEMM reaches wgmma and TMA, and no mma.sync is left
        bf16 = [f for f in sass if f["kernel"].startswith("gemm_bf16")]
        if not bf16 or not all(f["HGMMA"] and f["UTMALDG"] and not f["HMMA"]
                               for f in bf16):
            raise AssertionError(f"gemm_bf16_kernel SASS: {bf16}")
        # every float32 instantiation runs on the tensor cores
        if not f32 or not all(f["HMMA"] for f in f32):
            raise AssertionError(f"gemm_f32_kernel SASS: {f32}")


# ------------------------------------------------------------ frontends

# the modality frontends: musicgen-medium at full size; llava-next-34b at
# full width cut to 4 of its 60 layers (full depth is 68.8 GB of bf16
# weights, and drawing them would take the script's time budget)
FRONT_SERVE = ("musicgen-medium", "llava-next-34b")
FRONT_DEPTH = {"llava-next-34b": 4}
FRONT_TEXT = 128                 # text tokens after the frontend prefix


def frontend_encode(cfg, params, device, use_kernels):
    """An encode at B = 1 of [``frontend_prefix_len`` precomputed frames
    or patches (``frontend_embed_dim`` wide, projected by
    ``frontend_proj``) || ``FRONT_TEXT`` text tokens]: its logits."""
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size - 2, (
        1, FRONT_TEXT)).astype(np.int32)).to(device)
    pe = torch.from_numpy(rng.standard_normal((
        1, cfg.frontend_prefix_len, cfg.frontend_embed_dim)).astype(
            np.float32)).to(device)
    return apply_model(cfg, params, tokens=toks, prefix_embeds=pe,
                       use_kernels=use_kernels).logits


def serve_frontend(arch, device):
    """One frontend config at full width (``family_model`` with
    ``FRONT_DEPTH``), bf16 random weights from seed 0: the frontend
    projection's product and the head's confidence at this vocabulary
    against their plain versions; an encode of the whole frontend prefix
    plus ``FRONT_TEXT`` tokens through the kernels (``frontend_proj``,
    every product, attention at S = prefix + text) against the plain
    route (``attend_ref``, ``torch.matmul``), max |d logits| beside
    ``FAM_REF_TOL`` * max |logits|, launches counted around it; then a
    streaming decode on the graph loop against the host loop
    (``family_decode``)."""
    t0 = time.perf_counter()
    cfg, params, info = family_model(arch, device, FRONT_DEPTH.get(arch))
    rec = {"phase": "frontends", **info,
           "frontend": {"embed_dim": cfg.frontend_embed_dim,
                        "prefix_len": cfg.frontend_prefix_len,
                        "text_tokens": FRONT_TEXT}}
    S = cfg.frontend_prefix_len + FRONT_TEXT
    if torch.device(device).type == "cuda":
        rec["kernel_cases"] = [
            check_gemm(f"{arch}_frontend_proj", cfg.frontend_prefix_len,
                       cfg.frontend_embed_dim, cfg.d_model)["max_abs_err"],
            check_confidence(f"{arch}_head_V{cfg.vocab_size}",
                             FAM_N * BLOCK, cfg.vocab_size, torch.bfloat16,
                             mask_id=cfg.mask_token_id,
                             timed=True)["max_abs_err"]]
    ops.reset_launches()
    with gemm_calls() as calls:
        got = frontend_encode(cfg, params, device, True)
    sync(device)
    launches = dict(ops.LAUNCHES)
    with plain_products():
        ops.reset_launches()
        want = frontend_encode(cfg, params, device, False)
        sync(device)
        plain_launches = dict(ops.LAUNCHES)
    # both bf16 routes beside a float32 pass (the plain route on the
    # weights widened): how far each is from it
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    with plain_products():
        truth = frontend_encode(cfg32, params_to(params, torch.float32),
                                device, False)
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    scale = w.abs().max().item()
    to_f32 = {"kernel_route": (g - truth).abs().max().item(),
              "plain_route": (w - truth).abs().max().item()}
    del truth
    rec["encode"] = {
        "S": S, "logits_max_abs_err": err, "logits_max_abs": scale,
        "tol": FAM_REF_TOL * scale, "rel_to_max": err / scale,
        "argmax_agreement": float((g.argmax(-1) == w.argmax(-1)).float()
                                  .mean()),
        "finite": bool(torch.isfinite(g).all()), "launches": launches,
        "max_abs_err_to_float32_pass": to_f32,
        "frontend_proj_products": sum(
            c[1:] == (cfg.frontend_embed_dim, cfg.d_model) for c in calls)}
    del got, want, g, w
    ok = rec["encode"]["finite"] and err <= FAM_REF_TOL * scale
    if torch.device(device).type == "cuda":
        ok = ok and (launches["block_attention"] == cfg.n_layers
                     and launches["gemm"] == gemm_per_pass(cfg) + 1
                     and rec["encode"]["frontend_proj_products"] == 1
                     and not any(plain_launches.values()))
    dcfg = DecodeConfig(method="streaming", gen_len=FAM_GEN,
                        block_size=BLOCK, window=WINDOW, use_kernels=True)
    dec = DiffusionDecoder(cfg, params, dcfg, device=device)
    rec["decode"], _ = family_decode(cfg, params, dcfg, dec,
                                     family_prompts(cfg, FAM_N, SEED),
                                     device)
    rec["graphs"] = dec.graph_cache_size()
    rec["weight_bound_ms_per_pass"] = 1e3 * rec["weights_gb"] * 1e9 \
        / HBM_BYTES_S
    rec["step_ms_over_bound"] = rec["decode"]["step_ms"] \
        / rec["weight_bound_ms_per_pass"]
    if torch.device(device).type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["checks"] = {"encode_within_tol": ok,
                     "graph_loop_equals_host_loop": rec["decode"]["ok"]}
    rec["ok"] = all(rec["checks"].values())
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    del cfg, params, dec
    free_device()
    if not rec["ok"]:
        raise AssertionError(f"frontends phase {arch} failed: "
                             f"{rec['checks']}")
    return rec


def phase_frontends(device="cuda", archs=FRONT_SERVE):
    """musicgen-medium (48 layers, d 1536, 24 MHA heads, V 2048, GELU;
    256 frames of 768) at full size and llava-next-34b (d 7168, 56 heads
    over 8, d_ff 20480, V 64000; 2880 patches of 1024) at full width,
    cut to ``FRONT_DEPTH`` (``serve_frontend``)."""
    t_phase = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {arch: serve_frontend(arch, device) for arch in archs}
    emit({"phase": "frontends", "seconds": time.perf_counter() - t_phase})
    return out


# ------------------------------------------------------------ placement

# llada-8b at full width cut to 2 layers, bf16, on a mesh of ranks
# (``serving.DecodeExecutor`` on torch.distributed)
PLACE_ARCH, PLACE_DEPTH, PLACE_DTYPE = "llada-8b", 2, "bfloat16"
PLACE_GLOO_N, PLACE_GLOO_GEN = 4, 32     # (b): batch 4 = 2 rows a rank
PLACE_TIMEOUT_S = 300


def place_model(device, tp: int = 1):
    cfg = get_config(PLACE_ARCH, dtype=PLACE_DTYPE, param_dtype=PLACE_DTYPE,
                     n_layers=PLACE_DEPTH, reps=0, tail=(), tp=tp)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        SEED), device)
    return cfg, params


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_kernels(dec, prompts):
    """Block 0 of ``dec``'s decode replayed under torch.profiler: the
    device kernels whose name says NCCL, and the blocking syncs inside
    the block."""
    state = dec.prefill(prompts.copy())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("decode_block"):
            dec.decode_block(state)
        torch.cuda.synchronize()
    _, kernels, _ = kernel_groups(prof, "decode_block")
    return {"nccl_kernels": sum(c for _, k, c in kernels
                                if "nccl" in k.lower()),
            "names": sorted({k[:60] for _, k, _ in kernels
                             if "nccl" in k.lower()}),
            "blocking_syncs_in_block": syncs_inside(prof, "decode_block")}


def placement_nccl(device, backend="nccl"):
    """(a) A one-rank NCCL world, mesh (1, 1): ``DiffusionDecoder`` with a
    ``DecodeExecutor`` on the graph loop (its captured block carries the
    loop condition's all_reduce over the data line, inside the IF
    nodes; the block's outputs come back in one all_gather) against the
    same decoder without one: tokens and counters identical, one host
    sync a block; then ``ContinuousEngine`` on the executor, prewarmed,
    each request bit-equal to its decode alone (``family_continuous``).
    ``backend`` gloo is the CPU dry run's."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import ContinuousEngine, DecodeExecutor
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        cfg, params = place_model(device)
        mesh = make_host_mesh(1, 1)
        ex = DecodeExecutor(cfg, params, mesh, device=device)
        dcfg = DecodeConfig(method="streaming", gen_len=FAM_GEN,
                            block_size=BLOCK, window=WINDOW)
        prompts = family_prompts(cfg, FAM_N, SEED)
        plain = DiffusionDecoder(cfg, params, dcfg, device=device)
        plain.generate(prompts.copy())
        ref = plain.generate(prompts.copy())
        dec = DiffusionDecoder(cfg, None, dcfg, executor=ex)
        dec.generate(prompts.copy())                 # captures
        sync(device)
        ops.reset_launches()
        t1 = time.perf_counter()
        got = dec.generate(prompts.copy())
        sync(device)
        wall = time.perf_counter() - t1
        launches = dict(ops.LAUNCHES)
        rec = {"phase": "placement", "case": "one_rank_nccl",
               "mesh": mesh.shape, "backend": ex.data.backend,
               "arch": PLACE_ARCH, "layers": PLACE_DEPTH,
               "tokens_identical": bool((got.tokens == ref.tokens).all()),
               "counters_identical": all(getattr(got, c) == getattr(ref, c)
                                         for c in COUNTERS),
               "host_syncs_per_block": got.host_syncs
               / len(got.steps_per_block),
               "graphs": dec.graph_cache_size(), "wall_s": wall,
               "tok_s": got.tokens_generated / wall, "launches": launches}
        cuda = torch.device(device).type == "cuda"
        rec["profile_block0"] = nccl_kernels(dec, prompts) if cuda else {
            "blocking_syncs_in_block": [None]}
        eng = ContinuousEngine(cfg, params, dcfg, max_slots=FAM_SLOTS,
                               max_gang=FAM_GANG, executor=ex)
        rec["prewarm"] = eng.prewarm([(FAM_PROMPT, FAM_GEN)],
                                     batch_sizes=FAM_CONT_SIZES)
        rec["continuous"] = family_continuous(
            cfg, params, eng, eng.scheduler.decoder_for(FAM_GEN), device)
        rec["continuous"]["pool_placement"] = list(eng.pool.placement)
        rec["checks"] = {
            "equals_no_executor": rec["tokens_identical"]
            and rec["counters_identical"],
            "one_sync_a_block": rec["host_syncs_per_block"] == 1.0
            and len(rec["profile_block0"]["blocking_syncs_in_block"]) == 1,
            "graph_loop": rec["graphs"] > 0,
            "kernels_launched": launched(launches) or not cuda,
            # (a row's bits are batch-invariant on the card: gemm.cu; the
            # CPU's matmul is not, so a CPU dry run skips this check)
            "continuous": rec["continuous"]["ok"] or not cuda}
        rec["ok"] = all(rec["checks"].values())
        rec["seconds"] = time.perf_counter() - t0
        emit(rec)
        del eng, dec, plain, ex, params
    finally:
        dist.destroy_process_group()
        free_device()
    if not rec["ok"]:
        raise AssertionError(f"placement one-rank NCCL: {rec['checks']}")
    return rec


def placement_gloo_rank(device="cuda"):
    """One rank of (b): the world from ``RANK``, ``WORLD_SIZE`` and
    ``REPRO_TORCH_INIT`` over gloo (CUDA tensors staged through host
    memory), both ranks on the one card. Every rank draws the same
    weights, makes the (2, 1) and (1, 2) meshes and decodes the same
    prompts on the host loop; rank 0 also decodes them alone and returns
    the comparison."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import DecodeExecutor
    # two processes and gloo's threads share the host's cores: each rank
    # keeps a quarter of them for its intra-op pool
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    dist.init_process_group("gloo", init_method=os.environ[
        "REPRO_TORCH_INIT"], rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    try:
        rank = dist.get_rank()
        cfg, params = place_model(device)
        dcfg = DecodeConfig(method="streaming", gen_len=PLACE_GLOO_GEN,
                            block_size=BLOCK, window=WINDOW, fused=False)
        prompts = family_prompts(cfg, PLACE_GLOO_N, SEED)
        ref = DiffusionDecoder(cfg, params, dcfg, device=device).generate(
            prompts.copy()) if rank == 0 else None
        out = {"ranks": dist.get_world_size(), "backend": "gloo",
               "n": PLACE_GLOO_N, "gen_len": PLACE_GLOO_GEN, "runs": []}
        for shape in ((2, 1), (1, 2)):
            mesh = make_host_mesh(*shape)
            c = dataclasses.replace(cfg, tp=shape[1])
            ex = DecodeExecutor(c, params, mesh, device=device)
            try:      # the graph loop would capture gloo: refused
                DiffusionDecoder(c, None, dataclasses.replace(
                    dcfg, fused=True), executor=ex)
                refused = False
            except ValueError:
                refused = True
            ops.reset_launches()
            t0 = time.perf_counter()
            r = DiffusionDecoder(c, None, dcfg, executor=ex).generate(
                prompts.copy())
            sync(device)
            run = {"mesh": mesh.shape, "wall_s": time.perf_counter() - t0,
                   "launches": dict(ops.LAUNCHES),
                   "graph_loop_refused": refused,
                   "shards": {"wq_heads": ex.params["layers"][0]["mixer"][
                       "wq"].shape[1], "vocab": ex.params["embed"].shape[0],
                       "d_ff": ex.params["layers"][0]["ffn"][
                           "w_down"].shape[0]}}
            if ref is not None:
                run.update(exact=bool((r.tokens == ref.tokens).all()),
                           agree=float((r.tokens == ref.tokens).mean()),
                           nfe=r.nfe, ref_nfe=ref.nfe,
                           valid=bool(((r.tokens >= 0) & (
                               r.tokens < cfg.vocab_size)).all()))
            out["runs"].append(run)
            del ex
        return out
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def check_gemm_f32_out(name, M, K, N):
    """The bf16 GEMM's float32 output and its chain (the row-parallel
    products on a model line of two, ``layers.row_parallel``): rounded,
    the float32 output is the bf16 output's bits; the first half of K
    from 0 and the second half continuing its float32 sums (``acc``)
    rounds to the same bits (bit-equal to the unsharded product);
    against the plain float32 product within 2e-5 of its max; the
    float32 and bf16 outputs timed in turns."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=g, device="cuda")
         / math.sqrt(K)).to(torch.bfloat16)
    y32 = ops.gemm(x, w, torch.float32)
    y16 = ops.gemm(x, w)
    h = K // 2
    chain = ops.gemm(x[:, h:].contiguous(), w[h:].contiguous(),
                     torch.float32, acc=ops.gemm(x[:, :h].contiguous(),
                                                 w[:h].contiguous(),
                                                 torch.float32))
    full = ref.gemm_ref(x, w, torch.float32)
    torch.cuda.synchronize()
    err = (y32 - full).abs().max().item()
    sets = [(x, w)]
    f32_out = lambda a, b: ops.gemm(a, b, torch.float32)  # noqa: E731
    t = [time_ms(f32_out, sets), time_ms(ops.gemm, sets),
         time_ms(ops.gemm, sets), time_ms(f32_out, sets)]
    rec = {"phase": "kernels", "kernel": "gemm", "case": name,
           "out": "float32", "shape": {"M": M, "K": K, "N": N},
           "rounds_to_bf16_out": bool(torch.equal(y32.to(torch.bfloat16),
                                                  y16)),
           "chain_of_two_bit_equal": bool(torch.equal(chain, y32)),
           "max_abs_err": err, "tol": 2e-5 * full.abs().max().item(),
           "f32_out_ms": (t[0] + t[3]) / 2, "bf16_out_ms": (t[1] + t[2]) / 2}
    rec["ok"] = (rec["rounds_to_bf16_out"] and rec["chain_of_two_bit_equal"]
                 and err <= rec["tol"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"gemm float32 out {name}: {rec}")
    return rec


def check_gemm_f32_chain(name, M, K, N):
    """The float32 kernel's ``acc`` chain (``layers.row_parallel`` on a
    model line of two): the second half of K continuing the first half's
    sums (a cut at a multiple of 8) is bit-equal to the whole product."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((M, K), generator=g, device="cuda")
    w = torch.randn((K, N), generator=g, device="cuda") / math.sqrt(K)
    h = K // 2
    whole = ops.gemm(x, w)
    chain = ops.gemm(x[:, h:].contiguous(), w[h:].contiguous(),
                     torch.float32, acc=ops.gemm(x[:, :h].contiguous(),
                                                 w[:h].contiguous(),
                                                 torch.float32))
    torch.cuda.synchronize()
    rec = {"phase": "kernels", "kernel": "gemm", "case": name + "_chain",
           "dtype": "float32", "shape": {"M": M, "K": K, "N": N},
           "cut": h, "chain_of_two_bit_equal": bool(torch.equal(chain,
                                                                whole))}
    rec["ok"] = h % 8 == 0 and rec["chain_of_two_bit_equal"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"gemm float32 chain {name}: {rec}")
    return rec


def placement_gloo(device):
    """(b) Two ranks sharing the one card over gloo, on the host loop:
    mesh (2, 1) bit-equal to the single-rank decode, mesh (1, 2) valid
    at agreement >= 0.95 with the same NFE; the shards' widths run
    through gemm.cu and block_attention.cu. Rank 1 is a process this
    phase starts (and stops on any failure); this process is rank 0."""
    t0 = time.perf_counter()
    f32_out = []
    if torch.device(device).type == "cuda":
        # the (1, 2) shards' row-parallel products at the decode's rows
        cfg = get_config(PLACE_ARCH)
        M = PLACE_GLOO_N * (BLOCK + min(WINDOW, PLACE_GLOO_GEN - BLOCK) + 1)
        f32_out = [check_gemm_f32_out("o_shard", M, cfg.d_model // 2,
                                      cfg.d_model),
                   check_gemm_f32_out("down_shard", M, cfg.d_ff // 2,
                                      cfg.d_model)]
    tmp = tempfile.mkdtemp()
    env = dict(os.environ, WORLD_SIZE="2",
               REPRO_TORCH_INIT="file://" + os.path.join(tmp, "rdv"))
    log_path = os.path.join(tmp, "rank1.log")
    with open(log_path, "w") as log:
        child = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             f"{ROOT!r}); import chip_smoke as c; c.PLACE_ARCH = "
             f"{PLACE_ARCH!r}; c.PLACE_DEPTH = {PLACE_DEPTH}; "
             f"c.PLACE_DTYPE = {PLACE_DTYPE!r}; "
             f"c.placement_gloo_rank({str(device)!r})"],
            env=dict(env, RANK="1"), cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        os.environ.update(RANK="0", WORLD_SIZE="2",
                          REPRO_TORCH_INIT=env["REPRO_TORCH_INIT"])
        out = placement_gloo_rank(device)
        code = child.wait(timeout=PLACE_TIMEOUT_S)
    finally:
        for k in ("RANK", "WORLD_SIZE", "REPRO_TORCH_INIT"):
            os.environ.pop(k, None)
        if child.poll() is None:
            child.kill()
            child.wait()
        free_device()
    with open(log_path) as f:
        child_log = f.read()
    shutil.rmtree(tmp, ignore_errors=True)
    by = {tuple(r["mesh"].values()): r for r in out["runs"]}
    rec = {"phase": "placement", "case": "two_rank_gloo", **out,
           "rank1_exit": code, "arch": PLACE_ARCH, "layers": PLACE_DEPTH,
           "gemm_f32_out": [r["ok"] for r in f32_out]}
    rec["checks"] = {
        "rank1_ok": code == 0,
        "data_2_exact": by[(2, 1)]["exact"]
        and by[(2, 1)]["nfe"] == by[(2, 1)]["ref_nfe"],
        "model_2_agrees": by[(1, 2)]["valid"] and by[(1, 2)]["agree"] >= 0.95
        and by[(1, 2)]["nfe"] == by[(1, 2)]["ref_nfe"],
        "graph_loop_refused_on_gloo": torch.device(device).type != "cuda"
        or all(r["graph_loop_refused"] for r in out["runs"]),
        "kernels_launched": torch.device(device).type != "cuda" or all(
            launched(r["launches"]) for r in out["runs"])}
    rec["ok"] = all(rec["checks"].values())
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"placement two-rank gloo: {rec['checks']}\n"
                             f"{child_log[-3000:]}")
    return rec


# (c), (d): the serve CLI's functions over HTTP; prompts of one length
# (one prewarmed bucket), 32 tokens each (one block), 4 in flight
PLACE_HTTP_PROMPT, PLACE_HTTP_N, PLACE_HTTP_AT_ONCE = 64, 6, 4
PLACE_HTTP_CANCEL = 4 * BLOCK            # the cancelled stream's tokens


def mesh_http_argv(device, mesh, engines=1, gloo=False, extra=()):
    """The serve CLI's flags for (c) to (f): ``PLACE_ARCH`` (the model
    itself is ``place_model``'s, cut to ``PLACE_DEPTH``); the graph loop
    prewarmed, or (``gloo``) the host loop over gloo; then ``extra``."""
    from repro_torch.launch.serve import parse_args
    argv = ["--arch", PLACE_ARCH, "--dtype", PLACE_DTYPE, "--device",
            str(device), "--train-steps", "0", "--seed", str(SEED),
            "--mesh", mesh, "--engines", str(engines), "--http",
            str(free_port()), "--gen-len", str(PLACE_GLOO_GEN), "--window",
            str(WINDOW), "--max-slots", str(PLACE_HTTP_AT_ONCE),
            "--metrics-interval-s", "0"]
    if gloo:
        argv += ["--backend", "gloo", "--host-loop"]
    else:
        argv += ["--prewarm", f"{PLACE_HTTP_PROMPT}:{PLACE_GLOO_GEN}"]
    return parse_args(argv + list(extra))


def mesh_http_prompts(cfg):
    tok = ByteTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(SEED + 29)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz .,0123456789"))
    texts = ["".join(rng.choice(alphabet, PLACE_HTTP_PROMPT))
             for _ in range(PLACE_HTTP_N + 1)]
    assert all(len(tok.encode(t)) == PLACE_HTTP_PROMPT for t in texts)
    return texts


async def mesh_http_traffic(frontend, prompts, cancel: bool,
                            audits: bool = False):
    """``prompts[:-1]`` over loopback, JSON and SSE in turns, at most
    ``PLACE_HTTP_AT_ONCE`` at once; with ``cancel``, then a stream of
    ``PLACE_HTTP_CANCEL`` tokens dropped after its first block and the
    last prompt as JSON; with ``audits``, then a wait until every served
    request is audited (its wall) and a ``GET /debug/flight``. Returns
    each request's document and wall."""
    import asyncio
    from repro_torch.server import client
    host, port = frontend.host, frontend.port
    gate = asyncio.Semaphore(PLACE_HTTP_AT_ONCE)

    async def one(i, p):
        async with gate:
            t0 = time.perf_counter()
            body = {"prompt": p, "max_tokens": PLACE_GLOO_GEN}
            if i % 2:
                stream = await client.SSEStream.open(host, port, body)
                events = [e async for e in stream.events()]
                await stream.close()
                doc = events[-1]
            else:
                st, _, doc = await client.complete(host, port, body)
                assert st == 200, doc
            return {"prompt": p, "doc": doc,
                    "wall_s": time.perf_counter() - t0}
    ops.reset_launches()
    out = {"served": list(await asyncio.gather(
        *(one(i, p) for i, p in enumerate(prompts[:-1]))))}
    if cancel:
        stream = await client.SSEStream.open(host, port, {
            "prompt": prompts[0], "max_tokens": PLACE_HTTP_CANCEL})
        async for first in stream.events():
            break
        stream.abort()
        out["cancel_first_block"] = first["block"]
        out["served"].append(await one(0, prompts[-1]))
    out["launches"] = dict(ops.LAUNCHES)
    if audits:
        import asyncio
        t0 = time.perf_counter()
        while sum(e.auditor.stats()["completed"] for e in frontend.engines
                  ) < len(out["served"]):
            if time.perf_counter() - t0 > PLACE_TIMEOUT_S:
                raise AssertionError("audits not done after "
                                     f"{PLACE_TIMEOUT_S} s")
            await asyncio.sleep(0.05)
        out["audits_wall_s"] = time.perf_counter() - t0
        st, _, body = await client.request(host, port, "GET",
                                           "/debug/flight")
        assert st == 200, body
        out["flight"] = json.loads(body)
    return out


def mesh_http_rank(device, configs):
    """One rank of (c) or (d): for each ``(argv, rendezvous)`` in
    ``configs``, the world of ``RANK``/``WORLD_SIZE`` at ``rendezvous``
    (None: a world of one), then the serve CLI's ``check_args``,
    ``init_ranks``, ``broadcast_params``, ``make_fleet`` and
    ``serve_fleet`` on ``place_model``'s weights; rank 0 drives
    ``mesh_http_traffic`` and checks every completion against the same
    prompt decoded alone on one rank. Returns rank 0's records."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    device = torch.device(device)
    out = []
    for args, rdv in configs:
        t0 = time.perf_counter()
        if rdv is not None:
            os.environ["REPRO_TORCH_INIT"] = rdv
        serve.check_args(args)
        serve.init_ranks(args, device)
        try:
            cfg, params = place_model(device)
            params = serve.broadcast_params(params)
            prompts = mesh_http_prompts(cfg)
            box = {}

            async def traffic(frontend):
                # (d) cancels; (e) and (f) audit instead
                box.update(await mesh_http_traffic(
                    frontend, prompts,
                    cancel=args.host_loop and not args.audit_rate,
                    audits=args.audit_rate > 0))
            fleet = serve.make_fleet(args, cfg, params, device)
            ops.reset_launches()      # (rank 0 again before its traffic)
            summary = serve.serve_fleet(args, fleet, until=traffic)
            if summary is not None:
                out.append(mesh_http_check(args, cfg, params, device,
                                           summary, box,
                                           time.perf_counter() - t0))
            else:
                # another rank's launches, which rank 0 reads in its log
                print(json.dumps({"rank": dist.get_rank(),
                                  "launches": dict(ops.LAUNCHES)}),
                      flush=True)
            del params
        finally:
            dist.destroy_process_group()
            free_device()
    return out


def mesh_http_check(args, cfg, params, device, summary, traffic, wall):
    """Rank 0's record of one served mesh: each completion against its
    prompt decoded alone on this rank without an executor (the CLI's
    decode settings, B = 1), bit for bit."""
    from repro_torch.launch.serve import decode_config
    dec = DiffusionDecoder(cfg, params, decode_config(args, cfg),
                           device=device)
    tok = ByteTokenizer(cfg.vocab_size)
    exact = []
    for r in traffic["served"]:
        got = dec.generate(np.asarray(tok.encode(r["prompt"]),
                                      np.int32)[None])
        gen, _ = eos_truncate(got.tokens[0], cfg.eos_token_id)
        exact.append(r["doc"]["tokens"] == [int(t) for t in
                                            gen[:PLACE_GLOO_GEN]]
                     and not r["doc"]["cancelled"])
    sync(device)
    walls = sorted(r["wall_s"] for r in traffic["served"])
    keys = ("served", "cancelled", "served_per_engine", "graphs",
            "post_warm_captures", "host_syncs_per_block", "mesh", "ranks",
            "engines", "ops")
    rec = {"mesh": args.mesh, "engines": args.engines,
           "loop": "host" if args.host_loop else "graph",
           **{k: summary[k] for k in keys},
           "requests": len(traffic["served"]), "exact": exact,
           "request_wall_s": {"p50": walls[len(walls) // 2],
                              "max": walls[-1]},
           "launches": traffic["launches"], "seconds": wall}
    if "cancel_first_block" in traffic:
        rec["cancel_first_block"] = traffic["cancel_first_block"]
    if args.audit_rate:
        rec.update({k: summary[k] for k in (
            "audit", "handoffs", "handoff_bytes", "handoff_hit_tokens",
            "ops_s")}, audits_wall_s=traffic["audits_wall_s"],
            flight=traffic["flight"], cache_chunk=args.cache_chunk)
    return rec


def placement_mesh_http_nccl(device):
    """(c) ``--mesh 1,1 --http`` in a world of one NCCL rank (gloo on the
    CPU dry run), graph loop, prewarmed."""
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    args = mesh_http_argv(device, "1,1")
    rec = {"phase": "placement", "case": "mesh_http_nccl",
           **mesh_http_rank(device, [(args, None)])[0]}
    rec["checks"] = {
        "exact": len(rec["exact"]) == PLACE_HTTP_N and all(rec["exact"]),
        "one_sync_a_block": rec["host_syncs_per_block"] == 1.0,
        "graphs": rec["graphs"] > 0 and rec["post_warm_captures"] == 0,
        "kernels_launched": launched(rec["launches"]) or not cuda}
    rec["ok"] = all(rec["checks"].values())
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"placement mesh_http_nccl: {rec['checks']}")
    return rec


def audits_clean(audit, served) -> bool:
    """Every served request audited, no divergence and no error (one
    engine's stats, or a fleet's list)."""
    rows = audit if isinstance(audit, list) else [audit]
    return (sum(a["completed"] for a in rows) == served
            and all(a["errors"] == 0 and not sum(a["divergences"].values())
                    for a in rows))


def flight_docs(flight) -> dict:
    """A flight dump's metrics.json and state.json."""
    out = {}
    for name in ("metrics", "state"):
        with open(os.path.join(flight["path"], f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


def placement_mesh_http_obs_nccl(device):
    """(e) ``--mesh 1,1 --http`` in a world of one NCCL rank (gloo on the
    CPU dry run), graph loop, prewarmed, with the auditor's host lane on
    every request, the flight recorder, the block profiler and the
    trace."""
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp()
    args = mesh_http_argv(device, "1,1", extra=[
        "--audit-rate", "1.0", "--audit-oracle", "host", "--flight-dir",
        os.path.join(tmp, "flight"), "--profile-blocks", "2",
        "--trace-dir", os.path.join(tmp, "trace")])
    try:
        rec = {"phase": "placement", "case": "mesh_http_obs_nccl",
               **mesh_http_rank(device, [(args, None)])[0]}
        docs = flight_docs(rec["flight"])
        prof = os.path.join(tmp, "trace", "torch_profile", "rank0",
                            "trace.json")
        attn = 0
        if os.path.exists(prof):
            with open(prof) as f:
                attn = sum("attn_" in e.get("name", "") for e in json.load(
                    f)["traceEvents"] if e.get("cat") == "kernel")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    served = len(rec["exact"])
    (engine,) = docs["metrics"]["engines"]
    (sched,) = docs["state"]["schedulers"]
    audited = rec["audit"]["completed"]
    rec.update(profile_attn_kernels=attn, flight_files=sorted(docs),
               audit_lane_s_per_request=rec["ops_s"][0].get(
                   "audit_tick", 0.0) / max(audited, 1))
    rec["checks"] = {
        "exact": served == PLACE_HTTP_N and all(rec["exact"]),
        "audits_clean": audits_clean(rec["audit"], served),
        "flight_dump": engine["metrics"]["requests"] == served
        and engine["audit"]["completed"] == audited
        and engine["telemetry"]["blocks"] > 0 and sched["max_slots"] > 0,
        "profile_names_attention": os.path.basename(prof) == "trace.json"
        and (attn > 0 or not cuda),
        "graphs": rec["graphs"] > 0 and rec["post_warm_captures"] == 0,
        "kernels_launched": launched(rec["launches"]) or not cuda}
    rec["ok"] = all(rec["checks"].values())
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"placement mesh_http_obs_nccl: {rec['checks']}")
    return rec


def placement_gloo_worlds(device, argvs):
    """Rank 0 of one gloo world of two ranks sharing the card per entry of
    ``argvs`` (the serve CLI's flags), in turn; rank 1 is one process this
    phase starts (and stops on any failure), running every world in the
    same order. Returns rank 0's records, rank 1's exit code and log, and
    rank 1's kernel launches in each world."""
    tmp = tempfile.mkdtemp()
    rdvs = ["file://" + os.path.join(tmp, f"rdv{i}")
            for i in range(len(argvs))]
    log_path = os.path.join(tmp, "rank1.log")
    os.environ.update(RANK="0", WORLD_SIZE="2")
    env = dict(os.environ, RANK="1")
    with open(log_path, "w") as log:
        child = subprocess.Popen(
            [sys.executable, "-c", "import sys, argparse; sys.path.insert("
             f"0, {ROOT!r}); import chip_smoke as c; c.PLACE_ARCH = "
             f"{PLACE_ARCH!r}; c.PLACE_DEPTH = {PLACE_DEPTH}; "
             f"c.PLACE_DTYPE = {PLACE_DTYPE!r}; c.mesh_http_rank("
             f"{str(device)!r}, [(argparse.Namespace(**a), r) for a, r in "
             f"{[(vars(a), r) for a, r in zip(argvs, rdvs)]!r}])"],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        runs = mesh_http_rank(device, list(zip(argvs, rdvs)))
        code = child.wait(timeout=PLACE_TIMEOUT_S)
    finally:
        for k in ("RANK", "WORLD_SIZE", "REPRO_TORCH_INIT"):
            os.environ.pop(k, None)
        if child.poll() is None:
            child.kill()
            child.wait()
        free_device()
    with open(log_path) as f:
        child_log = f.read()
    shutil.rmtree(tmp, ignore_errors=True)
    launches = [json.loads(line)["launches"] for line in
                child_log.splitlines() if line.startswith('{"rank": 1,')]
    return runs, code, child_log, launches


def placement_mesh_http_gloo(device, runs, code, child_log, seconds):
    """(d) Two gloo ranks sharing the card, host loop: ``--mesh 2,1
    --http`` and ``--mesh 1,1 --engines 2 --http``, one world each
    (``placement_gloo_worlds``)."""
    cuda = torch.device(device).type == "cuda"
    one, fleet = runs
    rec = {"phase": "placement", "case": "mesh_http_gloo", "backend": "gloo",
           "runs": runs, "rank1_exit": code}
    rec["checks"] = {
        "rank1_ok": code == 0,
        # the 6 requests, and the one after the cancel
        "exact": all(len(r["exact"]) == PLACE_HTTP_N + 1
                     and all(r["exact"]) for r in runs),
        "both_engines_served": len(fleet["served_per_engine"]) == 2
        and min(fleet["served_per_engine"]) >= 1,
        "one_cancel": all(r["cancelled"] == 1 and r["cancel_first_block"]
                          == 0 for r in runs),
        "cancel_replayed": all(sum(o.get("cancel", 0) for o in r["ops"])
                               >= 1 for r in runs),
        "kernels_launched": not cuda or all(launched(r["launches"])
                                            for r in runs)}
    rec["ok"] = all(rec["checks"].values())
    rec["seconds"] = seconds
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"placement mesh_http_gloo: {rec['checks']}\n"
                             f"{child_log[-3000:]}")
    return rec


def pool_argv(device, tmp):
    """(f)'s flags: the pool on two ranks, every serving layer on."""
    return mesh_http_argv(device, "1,1", gloo=True, extra=[
        "--pool", "prefill:1,decode:1", "--prefix-cache", "--audit-rate",
        "1.0", "--audit-oracle", "cold", "--trace-dir",
        os.path.join(tmp, "trace"), "--flight-dir",
        os.path.join(tmp, "flight")])


def spans_inside_http(trace_path, label):
    """From a Chrome trace: how many ``block N`` async spans the track
    group ``label`` holds, and how many of them lie inside their
    request's ``http`` span."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    pid = next(e["pid"] for e in events if e.get("ph") == "M"
               and e["name"] == "process_name" and e["args"]["name"] == label)
    http = {}
    for e in events:
        if e.get("name") == "http" and e.get("ph") in ("b", "e"):
            http.setdefault(e["id"], {})[e["ph"]] = e["ts"]
    blocks = [e for e in events if e.get("pid") == pid
              and e.get("ph") in ("b", "e")
              and str(e.get("name", "")).startswith("block ")]
    inside = sum(e["id"] in http and http[e["id"]].get("b", math.inf)
                 <= e["ts"] <= http[e["id"]].get("e", -math.inf)
                 for e in blocks)
    return {"block_events": len(blocks), "inside_http": inside,
            "requests": len({e["id"] for e in blocks})}


def placement_mesh_http_pool_gloo(device, tmp, run, code, child_log,
                                  seconds, rank1_launches):
    """(f) ``--mesh 1,1 --pool prefill:1,decode:1`` on the two gloo ranks
    (``placement_gloo_worlds``): the prefill engine on rank 0, the decode
    engine on rank 1, so every handoff crosses processes; the path's
    launches are both ranks' (the decode's kernels run on rank 1)."""
    cuda = torch.device(device).type == "cuda"
    try:
        spans = spans_inside_http(os.path.join(tmp, "trace", "trace.json"),
                                  "engine-1")
        docs = flight_docs(run["flight"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    served = len(run["exact"])
    ops_s, n = run["ops_s"], max(run["handoffs"], 1)
    both = {k: v + rank1_launches.get(k, 0)
            for k, v in run["launches"].items()}
    rec = {"phase": "placement", "case": "mesh_http_pool_gloo",
           "backend": "gloo", **run, "rank1_exit": code, "spans": spans,
           "rank1_launches": rank1_launches,
           "flight_engines": len(docs["metrics"]["engines"]),
           "handoff_bytes_each": run["handoff_bytes"] / n,
           "handoff_ops_s_each": (ops_s[0].get("take_handoffs", 0.0)
                                  + ops_s[1].get("adopt_handoff", 0.0)) / n}
    rec["checks"] = {
        "rank1_ok": code == 0,
        "exact": served == PLACE_HTTP_N and all(run["exact"]),
        # every prompt is new to the decode store: each is handed off,
        # with its whole aligned prompt found on rank 1 (a hit is at most
        # the aligned length)
        "handoffs": run["handoffs"] >= 1
        and run["handoff_hit_tokens"] == run["handoffs"] * (
            PLACE_HTTP_PROMPT // run["cache_chunk"] * run["cache_chunk"])
        and run["handoff_bytes"] > 0,
        "audits_clean": audits_clean(run["audit"], served),
        "spans_inside_http": spans["block_events"] > 0
        and spans["inside_http"] == spans["block_events"],
        "flight_dump": rec["flight_engines"] == 2,
        "kernels_launched": not cuda or launched(both)}
    rec["ok"] = all(rec["checks"].values())
    rec["seconds"] = seconds
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"placement mesh_http_pool_gloo: "
                             f"{rec['checks']}\n{child_log[-3000:]}")
    return rec


def phase_placement(device="cuda"):
    """Placement across ranks at llada-8b full width, 2 layers, bf16:
    (a) a one-rank NCCL world on the graph loop (``placement_nccl``) and
    (b) two ranks on the one card over gloo on the host loop
    (``placement_gloo``); then the same model served over HTTP by the
    serve CLI's functions, (c) in a one-rank NCCL world
    (``placement_mesh_http_nccl``), (e) there again with the auditor,
    the flight recorder, the profiler and the trace
    (``placement_mesh_http_obs_nccl``), and on two gloo ranks (d)
    (``placement_mesh_http_gloo``) and (f), a prefill/decode pool with
    every layer on (``placement_mesh_http_pool_gloo``). NCCL with more
    than one rank needs more than one card and does not run here."""
    t_phase = time.perf_counter()
    nccl = "nccl" if torch.device(device).type == "cuda" else "gloo"
    out = {"one_rank_nccl": placement_nccl(device, nccl),
           "two_rank_gloo": placement_gloo(device),
           "mesh_http_nccl": placement_mesh_http_nccl(device),
           "mesh_http_obs_nccl": placement_mesh_http_obs_nccl(device)}
    # (d) and (f): one rank-1 process runs their three worlds in turn
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    runs, code, log, rank1 = placement_gloo_worlds(device, [
        mesh_http_argv(device, "2,1", 1, gloo=True),
        mesh_http_argv(device, "1,1", 2, gloo=True),
        pool_argv(device, tmp)])
    seconds = time.perf_counter() - t0
    out["mesh_http_gloo"] = placement_mesh_http_gloo(
        device, runs[:2], code, log, seconds)
    out["mesh_http_pool_gloo"] = placement_mesh_http_pool_gloo(
        device, tmp, runs[2], code, log, seconds,
        rank1[2] if len(rank1) > 2 else {})
    emit({"phase": "placement", "seconds": time.perf_counter() - t_phase})
    return out


def timed(phase, *args):
    """``phase(*args)``, then a line with its seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    emit({"phase": "seconds", "name": phase.__name__,
          "s": time.perf_counter() - t0})
    return out


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

    timed(phase_build)
    step, conf = timed(phase_kernels)
    gemm_main, gemm_f32 = timed(phase_gemm)
    timed(phase_gemm_probe)
    timed(phase_probe)
    timed(phase_reference)
    timed(phase_reference_llada)
    tok = ByteTokenizer(get_config("llada-8b").vocab_size)
    prompts = np.stack([tok.encode(p) for p in make_prompts(
        N_PROMPTS, SEED)]).astype(np.int32)
    inv = timed(phase_invariance, prompts)
    timed(phase_methods, prompts)
    *model, serve = timed(phase_serve)
    timed(phase_profile, *model)
    timed(phase_dryrun, model[0], model[1].params)
    cont = timed(phase_continuous, model[0], model[1].params,
                 inv["batch_invariant"])
    timed(phase_prefix_cache, model[0], model[1].params)
    # the serve phase's decoders and their graphs go before the front end
    cfg, params = model[0], model[1].params
    del model
    torch.cuda.empty_cache()
    timed(phase_http, cfg, params)
    timed(phase_fleet, cfg, params)
    # the llada-8b weights go before the trained model's phase
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_train)
    # and the trained model's before the other families
    free_device()
    timed(phase_families_reference)
    timed(phase_families)
    # the families' weights are freed (serve_family) before this phase
    rec_serve, rec_cases = timed(phase_recurrent)
    free_device()
    timed(phase_frontends)
    timed(phase_placement)

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
    # gemm.cu's float32 kernel (3xTF32): RG-LRU's u @ [w_a | w_x] (the
    # reference's float32 dot), timed at recurrentgemma-9b's block-0
    # step, launches from the recurrent phase's timed decode of it
    f32 = gemm_f32["recurrentgemma_9b_u_wa_wx_f32"]
    f32_launches = rec_serve["recurrentgemma-9b"]["decode"]["launches"][
        "gemm_f32"]
    if not f32_launches:
        raise AssertionError("gemm_f32_kernel: no launch on recurrentgemma's "
                             "decode")
    kernels.append({
        "name": "gemm_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/models/recurrent.py:101",
        "launches": f32_launches, "max_abs_err": f32["max_abs_err"],
        "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"]})
    # no TPU kernel either: the JAX package scans with lax.scan; launches
    # from the recurrent phase's timed decode of the model that runs each,
    # times at the step's shape in bf16
    for kind, arch, line in (("rglru", "recurrentgemma-9b", 73),
                             ("mlstm", "xlstm-350m", 166),
                             ("slstm", "xlstm-350m", 231)):
        case = rec_cases[(kind, f"{arch.replace('-', '_')}_step")]
        kernels.append({
            "name": f"{kind}_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/recurrent.cu",
            "replaces": f"src/repro/models/recurrent.py:{line}",
            "launches": rec_serve[arch]["decode"]["launches"][
                f"{kind}_scan"],
            "max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
