"""Minimal serving CLI of the port: continuous (default) or batch-mode
serving of a few prompts on ``init_params`` weights (what the JAX CLI
serves with ``--train-steps 0``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llada-8b \\
        --method streaming --n 4 --gen-len 256 --window 96 \\
        --max-slots 4 --prewarm 12:256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny \\
        --device cpu --dtype float32 --mode continuous --max-slots 2 --stream
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny \\
        --device cpu --dtype float32 --mode batch --method dkv --host-loop

Runs on CUDA unless ``--device cpu``; on CUDA attention and confidence
go through the kernels, and each block is one CUDA graph replay
(``--host-loop``: the per-step host loop instead). ``--prewarm P:G``
captures the graphs of prompt length P and generation length G for every
gang size before serving (a capture otherwise stalls the first block of
each new shape). ``--prefix-cache`` (with ``--cache-chunk`` and
``--cache-bytes``) reuses prompt KV across requests in continuous mode.
``--ckpt`` and training wait for ROADMAP A12, ``--http`` for A8.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.cache import PrefixKVCache, device_placement
from repro_torch.core.decoder import METHODS, DecodeConfig
from repro_torch.core.engine import ServingEngine
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import get_config, init_params
from repro_torch.serving import ContinuousEngine


def make_prompts(n: int, seed: int):
    """Fixed-width arithmetic prompts (``Q:07+42=? A:``), so every prompt
    has the same length and batch mode serves them as one batch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        op = "+" if rng.random() < 0.5 else "-"
        a, b = (int(v) for v in rng.integers(0, 100, 2))
        out.append(f"Q:{a:02d}{op}{b:02d}=? A:")
    return out


def parse_prewarm(s: str):
    """``"P:G[,P:G...]"`` -> [(prompt_len, gen_len), ...]."""
    buckets = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            p, g = (int(v) for v in part.split(":"))
        except ValueError:
            raise SystemExit(
                f"--prewarm wants 'P:G[,P:G...]' ints, got {part!r}")
        buckets.append((p, g))
    return buckets


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--method", default="streaming", choices=METHODS)
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "batch"])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--max-slots", type=int, default=8,
                    help="continuous mode: concurrent decode lanes")
    ap.add_argument("--stream", action="store_true",
                    help="continuous mode: print per-block chunks as they "
                    "commit")
    ap.add_argument("--prewarm", default="", metavar="P:G[,P:G...]",
                    help="continuous mode: capture these (prompt_len, "
                    "gen_len) buckets for every gang size before serving")
    ap.add_argument("--pad-pow2", action="store_true",
                    help="continuous mode: snap gang sizes to powers of two "
                    "(fewer captured shapes, pad rows cost compute)")
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--tau0", type=float, default=0.9)
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True, help="attention/confidence through the "
                    "kernels (required on CUDA)")
    ap.add_argument("--host-loop", action="store_true",
                    help="per-step host loop (validation oracle) instead "
                    "of the device loop")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix KV cache (repro_torch.cache): "
                    "chunk-aligned prompt prefill, radix-tree content "
                    "matching (continuous mode shares it across requests)")
    ap.add_argument("--cache-chunk", type=int, default=16,
                    help="prefix-cache chunk size in prompt tokens")
    ap.add_argument("--cache-bytes", type=int, default=256 << 20,
                    help="prefix-cache byte budget (LRU eviction beyond it)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.prefix_cache and args.method == "vanilla":
        raise SystemExit("--prefix-cache has no effect with --method "
                         "vanilla (no KV cache to reuse)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, dtype=args.dtype, param_dtype=args.dtype)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device)
    d = DecodeConfig(method=args.method, gen_len=args.gen_len,
                     block_size=cfg.block_size, window=args.window,
                     tau0=args.tau0, alpha=args.alpha,
                     use_kernels=args.use_kernels,
                     fused=not args.host_loop,
                     prefix_cache=args.prefix_cache,
                     cache_chunk=args.cache_chunk)
    if args.mode == "batch":
        eng = ServingEngine(cfg, params, d, mode="batch", device=device)
    else:
        store = None
        if args.prefix_cache:
            store = PrefixKVCache(chunk_tokens=args.cache_chunk,
                                  max_bytes=args.cache_bytes,
                                  placement=device_placement(device))
        eng = ContinuousEngine(cfg, params, d, max_slots=args.max_slots,
                               pad_pow2=args.pad_pow2, prefix_cache=store,
                               device=device)
    summary = {"arch": args.arch, "method": args.method, "mode": args.mode,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")}
    if args.prewarm:
        if args.mode != "continuous":
            raise SystemExit("--prewarm needs --mode continuous")
        summary["prewarm"] = eng.prewarm(parse_prewarm(args.prewarm))
    for prompt in make_prompts(args.n, args.seed):
        eng.submit(prompt, max_tokens=args.gen_len)
    if args.stream and args.mode == "continuous":
        eng.on_chunk(None, lambda ch: print(
            f"  uid={ch.uid} block={ch.block_idx} "
            f"{'[done] ' if ch.finished else ''}{ch.text!r}", flush=True))
    kops.reset_launches()
    t1 = time.perf_counter()
    done = eng.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    summary.update({"served": len(done), "init_s": t1 - t0,
                    "serve_s": t2 - t1, "tok_s": eng.throughput})
    if args.mode == "batch":
        steps = [s for r in eng.results for s in r.steps_per_block]
        summary.update({
            "nfe": sum(r.nfe for r in eng.results),
            "steps_per_block": float(np.mean(steps)) if steps else 0.0,
            "host_syncs": sum(r.host_syncs for r in eng.results)})
    else:
        # per-request sums (a gang's passes count once for each row)
        snap = eng.metrics.snapshot()
        summary.update({
            "nfe": snap["total_nfe"],
            "steps_per_block": snap["device_steps_per_block"],
            "host_syncs": snap["total_host_syncs"],
            "host_syncs_per_block": snap["host_syncs_per_block"],
            "latency_p50_s": snap["latency_p50_s"],
            "ttfb_p50_s": snap["ttfb_p50_s"],
            "mean_occupancy": snap["mean_occupancy"],
            "gang_merges": snap["gang_merges"],
            "graphs": eng.graph_cache_size(),
            "post_warm_captures": snap["post_warm_compiles"]})
        if args.prefix_cache:
            summary.update({
                "prefix_cache_hit_tokens": snap["prefix_cache_hit_tokens"],
                "prefix_cache_nodes": snap["prefix_cache_nodes"]})
    summary["launches"] = dict(kops.LAUNCHES)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
