"""Minimal serving CLI of the port: batch-mode serving of a few prompts
on ``init_params`` weights (what the JAX CLI serves with
``--train-steps 0``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llada-8b \\
        --method streaming --mode batch --n 4 --gen-len 256 --window 96
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny \\
        --device cpu --dtype float32 --method dkv --host-loop

Runs on CUDA unless ``--device cpu``; on CUDA attention and confidence
go through the kernels, and each block is one CUDA graph replay
(``--host-loop``: the per-step host loop instead). ``--ckpt`` and
training wait for ROADMAP A12, ``--mode continuous`` for ROADMAP A6.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.decoder import METHODS, DecodeConfig
from repro_torch.core.engine import ServingEngine
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import get_config, init_params


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--method", default="streaming", choices=METHODS)
    ap.add_argument("--mode", default="batch", choices=["batch"])
    ap.add_argument("--n", type=int, default=4)
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
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, dtype=args.dtype, param_dtype=args.dtype)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device)
    d = DecodeConfig(method=args.method, gen_len=args.gen_len,
                     block_size=cfg.block_size, window=args.window,
                     tau0=args.tau0, alpha=args.alpha,
                     use_kernels=args.use_kernels,
                     fused=not args.host_loop)
    eng = ServingEngine(cfg, params, d, mode=args.mode, device=device)
    for prompt in make_prompts(args.n, args.seed):
        eng.submit(prompt, max_tokens=args.gen_len)
    kops.reset_launches()
    t1 = time.perf_counter()
    done = eng.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    nfe = sum(r.nfe for r in eng.results)
    steps = [s for r in eng.results for s in r.steps_per_block]
    summary = {
        "arch": args.arch, "method": args.method, "mode": args.mode,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "served": len(done), "init_s": t1 - t0, "serve_s": t2 - t1,
        "tok_s": eng.throughput, "nfe": nfe,
        "steps_per_block": float(np.mean(steps)) if steps else 0.0,
        "host_syncs": sum(r.host_syncs for r in eng.results),
        "launches": dict(kops.LAUNCHES)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
