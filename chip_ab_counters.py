#!/usr/bin/env python3
"""The confidence kernel's per-row arrival counters on the card: a fresh
buffer at every launch (the port's wrapper) against one buffer cached per
(device, rows) for the life of the process (the wrapper before several
engines shared the card, when two engines' graphs at one row count would
have raced on it).

    python3 chip_ab_counters.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package. Builds the port's kernels, makes llada-8b at full width and
depth (random bf16 weights from seed 0) and decodes ``chip_smoke.py``'s
serve configuration (streaming, gen_len 256, block 32, window 96, four
prompts of 128 bytes) through the CUDA-graph block loop. Each variant, in
the order per launch, cached, cached, per launch, per launch, cached:

- the confidence kernel alone at the decode's shape (B * 32 = 128 rows of
  the 126464-wide vocabulary, bf16, [MASK] banned), timed as
  ``chip_smoke.time_ms`` times it (a CUDA graph of 20 launches on inputs
  cycled past the L2), so the per-launch variant's graph holds a memset
  node before each launch;
- a fresh decoder (its own graphs, captured with the variant's
  counters): a first decode of blocks 0-5 captures, then a second decode
  from a new prefill times blocks 3, 4 and 5 on the host's clock (the
  call returns after the block's one sync) and by CUDA events around it.

Prints the card's name and power limit, one JSON line per variant and a
last line with the variants gathered. Exits non-zero without a card.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.core.decoder import DecodeConfig, DiffusionDecoder
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import build, confidence, ops
from repro_torch.models import get_config, init_params

ORDER = ("per_launch", "cached", "cached", "per_launch", "per_launch",
         "cached")
TIMED_BLOCKS = (3, 4, 5)
LIBRARIES = ("block_attention", "confidence", "graph_loop", "gemm")
per_launch = confidence._counters


def cached_counters():
    """The per-(device, rows) buffer kept for the process's life."""
    memo = {}

    def counters(device, N):
        key = (device.index, N)
        if key not in memo:
            memo[key] = torch.zeros(N, dtype=torch.int32, device=device)
        return memo[key]
    return counters


def run_variant(variant, cfg, params, tokens):
    confidence._counters = (cached_counters() if variant == "cached"
                            else per_launch)
    N, V = tokens.shape[0] * cs.BLOCK, cfg.vocab_size
    g = torch.Generator(device="cuda").manual_seed(1)
    xs = [(torch.randn(N, V, generator=g, device="cuda").to(torch.bfloat16),)
          for _ in range(cs.n_copies(N * V * 2))]
    conf_ms = cs.time_ms(
        lambda x: ops.confidence_argmax(x, mask_id=cfg.mask_token_id), xs)
    del xs
    dcfg = DecodeConfig(method="streaming", gen_len=cs.GEN_LEN,
                        block_size=cs.BLOCK, window=cs.WINDOW,
                        use_kernels=True)
    dec = DiffusionDecoder(cfg, params, dcfg, device="cuda")
    state = dec.prefill(tokens.copy())
    while state.block_idx <= TIMED_BLOCKS[-1]:
        dec.decode_block(state)                   # captures
    state = dec.prefill(tokens.copy())
    walls, spans = [], []
    while state.block_idx <= TIMED_BLOCKS[-1]:
        timed = state.block_idx in TIMED_BLOCKS
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        dec.decode_block(state)
        ev[1].record()
        wall = time.perf_counter() - t0
        if timed:
            ev[1].synchronize()
            walls.append(wall * 1e3)
            spans.append(ev[0].elapsed_time(ev[1]))
    del dec, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"block_wall_ms": walls, "block_span_ms": spans,
            "conf_ms": conf_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ab_counters: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.smi_line()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc each
        list(pool.map(lambda name: build.compile_library(name, ()),
                      LIBRARIES))
    for name in LIBRARIES:
        build.load(name)
    cfg = get_config("llada-8b", dtype="bfloat16", param_dtype="bfloat16")
    params = init_params(
        cfg, torch.Generator(device="cuda").manual_seed(cs.SEED), "cuda")
    tok = ByteTokenizer(cfg.vocab_size)
    tokens = np.stack([tok.encode(p) for p in cs.make_prompts(
        cs.N_PROMPTS, cs.SEED)]).astype(np.int32)
    out = {"per_launch": [], "cached": []}
    for variant in ORDER:
        rec = run_variant(variant, cfg, params, tokens)
        print(json.dumps({"variant": variant, **rec}), flush=True)
        out[variant].append(rec)
    confidence._counters = per_launch
    out["nvidia_smi"] = smi
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
