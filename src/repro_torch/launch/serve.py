"""Minimal serving CLI of the port: continuous (default) or batch-mode
serving of a few prompts on trained weights: ``--train-steps N`` (600 by
default, as in the JAX CLI) trains the model first with batch 32 and
sequence length 44, ``--ckpt PATH`` restores a checkpoint in the JAX
package's format (written by either package's trainer), and
``--train-steps 0`` serves the ``init_params`` weights of ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llada-8b \\
        --train-steps 0 --method streaming --n 4 --gen-len 256 \\
        --window 96 --max-slots 4 --prewarm 12:256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny \\
        --device cpu --dtype float32 --mode continuous --max-slots 2 --stream
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny \\
        --device cpu --dtype float32 --train-steps 0 --mode batch \\
        --method dkv --host-loop
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-100m \\
        --ckpt results/torch/ckpt/tiny100m --mode batch --n 32 --gen-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llada-8b \\
        --train-steps 0 --gen-len 256 --window 96 --prewarm 12:256 \\
        --http 8000 --audit-rate 0.05 --trace-dir /tmp/trace
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --train-steps 0 --mode batch --n 2 \\
        --gen-len 64 --window 96

``--arch`` takes every registered config, the recurrent families
(``recurrentgemma-9b``, ``xlstm-350m``, their ``-smoke`` variants)
included; as in the JAX CLI, ``--prefix-cache`` is refused for a layout
with recurrent layers (the decoder's assertion).

Runs on CUDA unless ``--device cpu``; on CUDA attention and confidence
go through the kernels, and each block is one CUDA graph replay
(``--host-loop``: the per-step host loop instead). ``--prewarm P:G``
captures the graphs of prompt length P and generation length G for every
gang size before serving (a capture otherwise stalls the first block of
each new shape). ``--prefix-cache`` (with ``--cache-chunk`` and
``--cache-bytes``) reuses prompt KV across requests in continuous mode.
``--http PORT`` serves ``POST /v1/completions`` (JSON or SSE),
``/healthz``, ``/metrics``, ``/debug/vars``, ``/debug/flight``,
``/debug/timeline`` and ``/console`` through ``repro_torch.server``
instead of the synthetic workload, in continuous mode, after
``--prewarm``'s captures; Ctrl-C drains what is in flight. The auditor,
flight recorder, metrics log and SLO watchdog (``--audit-rate``,
``--flight-dir``, ``--metrics-log``, ``--slo-*``) ride the HTTP loop;
``--trace-dir`` and ``--profile-blocks`` also serve the synthetic
continuous workload.

A fleet on one card, behind the HTTP front end's ``EngineRouter``
(each engine on its own CUDA stream; the weights are shared):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llada-8b \
        --train-steps 0 --gen-len 128 --window 96 --prewarm 256:128 \
        --http 8000 --engines 2 [--no-steal] [--host-threads-per-engine T]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llada-8b \
        --train-steps 0 --gen-len 128 --window 96 --prewarm 256:128 \
        --http 8000 --prefix-cache --pool prefill:1,decode:1

``--engines N`` serves with N engines (work stealing between them at
block boundaries unless ``--no-steal``); ``--pool prefill:N,decode:M``
primes prompts on N prefill-only engines into one shared prefix store
and decodes them on M engines. ``--host-threads-per-engine`` sizes the
process's intra-op pool (``repro_torch.launch.host``; default cores //
engines). ``--prewarm`` captures every engine's graphs, one engine after
another, before admission opens.

``--mesh DATA,MODEL`` places each continuous engine on a mesh of ranks
(``serving.DecodeExecutor``; SPMD, one process a rank): every rank takes
rank 0's weights (broadcast). The ranks come from the environment
(``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``, as
``torchrun`` sets them) or, with ``--force-host-devices N`` (the JAX
CLI's fake host devices), this launcher starts N CPU ranks itself over a
file rendezvous and polls them. ``--backend`` is the process groups'
backend: gloo on the CPU, NCCL on the card unless named (the graph loop
captures NCCL collectives only; gloo on the card needs ``--host-loop``).
Without ``--http`` every rank runs the same engine on the same synthetic
requests and rank 0 prints. With ``--http``, ``E x DATA x MODEL`` ranks
serve ``--engines E`` engines, engine ``i`` on ranks ``[i*D*M,
(i+1)*D*M)``: rank 0 alone binds the port and runs the front end and the
router, and drives every engine through an op log that the engine's
ranks replay (``serving.replica``; ``make_fleet``, ``serve_fleet``).
SIGINT to rank 0 (the launcher forwards it there) drains what is in
flight, then stops every rank:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny \\
        --device cpu --dtype float32 --train-steps 0 --http 8000 \\
        --mesh 2,1 --engines 2 --force-host-devices 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch llada-8b --train-steps 0 --http 8000 --mesh 2,1 \\
        --engines 2 --prewarm 256:128

Every serving layer runs on a mesh too, the port's SPMD way (rank 0
decides, each engine's ranks replay):

* ``--pool prefill:N,decode:K`` places the N prefill engines first, then
  the K decode engines, on ``(N+K) x DATA x MODEL`` ranks; each rank's
  store is keyed by the mesh shape, and a handoff carries the primed
  chunk KV from the prefill engine's ranks to the decode engine's as two
  ops (counted in the summary's ``handoff_bytes``);
* ``--audit-rate``: every rank of an engine runs its own auditor (the
  audit lanes decode on the engine's mesh); rank 0 reads the leader's
  stats and, with ``--flight-dir``, dumps on a divergence the leader
  found; ``GET /debug/flight`` dumps every engine's last state;
* ``--profile-blocks N``: every rank of engine 0 writes its own window
  to ``torch_profile/rank<r>/trace.json`` (also without ``--http``);
* ``--trace-dir``: an engine led from another rank records its spans on
  its leader, and rank 0's ``trace.json`` holds them, on rank 0's clock.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny \\
        --device cpu --dtype float32 --train-steps 0 --http 8000 \\
        --mesh 2,1 --pool prefill:1,decode:1 --prefix-cache \\
        --audit-rate 1.0 --flight-dir /tmp/flight --trace-dir /tmp/trace \\
        --profile-blocks 2 --force-host-devices 4
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch llada-8b --train-steps 0 --http 8000 --mesh 1,1 \\
        --pool prefill:1,decode:1 --prefix-cache --audit-rate 0.05 \\
        --prewarm 256:128
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.cache import PrefixKVCache, device_placement
from repro_torch.core.decoder import METHODS, DecodeConfig
from repro_torch.core.engine import ServingEngine
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import get_config, init_params
from repro_torch.models.model import params_to
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


def parse_pool(s: str):
    """``"prefill:N,decode:M"`` -> {"prefill": N, "decode": M}."""
    sizes = {"prefill": 0, "decode": 0}
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            role, n = part.split(":")
            sizes[role.strip()] += int(n)
        except (ValueError, KeyError):
            raise SystemExit(
                f"--pool wants 'prefill:N,decode:M', got {part!r}")
    if sizes["decode"] < 1:
        raise SystemExit("--pool needs at least one decode engine "
                         "(prefill-only engines can never finish a "
                         "request)")
    if sizes["prefill"] < 1:
        raise SystemExit("--pool without a prefill engine is plain "
                         "--engines; drop the flag")
    return sizes


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="There is no --compile-cache-dir: the JAX package's "
        "persistent compilation cache has no counterpart here, because "
        "the port's block programs are CUDA graphs captured in-process "
        "and not persisted; --prewarm captures them before serving.")
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
    ap.add_argument("--ckpt", default="", metavar="PATH",
                    help="serve the weights of this checkpoint (PATH.npz + "
                    "PATH.json, the JAX package's format)")
    ap.add_argument("--train-steps", type=int, default=600,
                    help="without --ckpt: train this many steps (batch 32, "
                    "seq_len 44, float32) before serving; 0 serves the "
                    "init_params weights of --seed")
    ap.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="serve over HTTP on this port instead of the "
                    "synthetic in-process workload (continuous mode; "
                    "Ctrl-C drains gracefully)")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--max-pending", type=int, default=64,
                    help="HTTP mode: bounded admission queue; beyond this, "
                    "POSTs get 429 + Retry-After")
    ap.add_argument("--trace-dir", default="", metavar="DIR",
                    help="record request span trees + decode timelines and "
                    "write Chrome-trace JSON (Perfetto-loadable) into DIR "
                    "at the end (continuous or HTTP mode)")
    ap.add_argument("--trace-flush-s", type=float, default=0.0,
                    metavar="S",
                    help="with --trace-dir and --http: also rewrite "
                    "trace.json atomically every S seconds, so a crashed "
                    "run keeps its trace up to the last flush")
    ap.add_argument("--audit-rate", type=float, default=0.0,
                    metavar="FRAC",
                    help="shadow-audit this fraction of completed requests: "
                    "re-decode on a low-priority lane through the host-loop "
                    "oracle and/or a cold (cache-bypass) path and compare "
                    "tokens bit for bit (repro_torch.obs.audit; 0 = off)")
    ap.add_argument("--audit-oracle", default="auto",
                    choices=["host", "cold", "both", "auto"],
                    help="audit lanes: 'host' flips the graph loop to the "
                    "host loop, 'cold' bypasses the prefix cache, 'both' "
                    "runs each, 'auto' picks every lane the engine config "
                    "supports")
    ap.add_argument("--flight-dir", default="", metavar="DIR",
                    help="flight recorder: on SLO breach, audit divergence, "
                    "crash, or GET /debug/flight, dump trace ring buffers "
                    "+ metrics snapshot + scheduler/gang state under DIR")
    ap.add_argument("--metrics-log", default="", metavar="PATH",
                    help="append every time-series recorder sample "
                    "(repro_torch.obs.series) as a JSON line to PATH (HTTP "
                    "mode; the in-memory ring behind /debug/timeline and "
                    "/console is always on)")
    ap.add_argument("--metrics-interval-s", type=float, default=0.5,
                    metavar="S",
                    help="recorder sampling interval (0 disables the "
                    "recorder)")
    ap.add_argument("--slo-ttfb-p50-ms", type=float, default=0.0,
                    help="SLO watchdog: rolling TTFB p50 target in ms "
                    "(breach dumps a flight recording; 0 = off)")
    ap.add_argument("--slo-token-latency-ms", type=float, default=0.0,
                    help="SLO watchdog: rolling per-token latency p50 "
                    "target in ms (0 = off)")
    ap.add_argument("--slo-goodput-tok-s", type=float, default=0.0,
                    help="SLO watchdog: rolling completed-tokens/s floor "
                    "(0 = off)")
    ap.add_argument("--profile-blocks", type=int, default=0, metavar="N",
                    help="capture a torch.profiler trace (CPU + CUDA) over "
                    "the first N decoded blocks, written under "
                    "--trace-dir/torch_profile (or results/torch/profile)")
    ap.add_argument("--log-level", default="info",
                    choices=["debug", "info", "warning", "error"])
    ap.add_argument("--log-json", action="store_true",
                    help="JSON-lines log records instead of text")
    ap.add_argument("--engines", type=int, default=1, metavar="N",
                    help="engine loops behind one HTTP front end (cache "
                    "affinity, then least-loaded routing; HTTP mode only "
                    "for N > 1): on one card each on its own CUDA stream, "
                    "with --mesh each on a submesh of ranks")
    ap.add_argument("--pool", default="", metavar="prefill:N,decode:M",
                    help="disaggregated engine pools: N prefill-only "
                    "engines prime prompt KV into ONE shared prefix "
                    "store and hand each request off to one of M decode "
                    "engines (implies --engines N+M; needs --http and "
                    "--prefix-cache)")
    ap.add_argument("--no-steal", action="store_true",
                    help="disable block-boundary work stealing between "
                    "engine loops (--engines > 1)")
    ap.add_argument("--host-threads-per-engine", type=int, default=0,
                    metavar="T",
                    help="PyTorch intra-op threads (process-wide); 0 = "
                    "cores // engines, or cores // ranks on the host with "
                    "--mesh (repro_torch.launch.host)")
    ap.add_argument("--mesh", default="", metavar="DATA,MODEL",
                    help="place each engine on a (data, model) mesh of "
                    "ranks (continuous mode; with --http, rank 0 serves "
                    "and the other ranks replay its ops)")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    metavar="N",
                    help="start N CPU ranks over gloo for --mesh "
                    "(needs --device cpu)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process group backend for --mesh (default: "
                    "gloo on the CPU, nccl on CUDA)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def check_args(args) -> None:
    """Every flag check, before any weights are made (``SystemExit``
    names what is wrong). ``--pool`` sets ``args.engines``."""
    mesh_dims = parse_mesh(args.mesh) if args.mesh else None
    if args.force_host_devices and mesh_dims is None:
        raise SystemExit("--force-host-devices starts the ranks of --mesh: "
                         "pass --mesh DATA,MODEL")
    if args.pool:
        pool_sizes = parse_pool(args.pool)
        if not args.http:
            raise SystemExit("--pool needs --http (the prefill->decode "
                             "handoff rides the EngineRouter in the "
                             "HTTP front end)")
        if not args.prefix_cache:
            raise SystemExit("--pool needs --prefix-cache (primed "
                             "prompt KV travels through the shared "
                             "prefix store)")
        n_pool = pool_sizes["prefill"] + pool_sizes["decode"]
        if args.engines not in (1, n_pool):
            raise SystemExit(f"--pool {args.pool} implies --engines "
                             f"{n_pool}, got --engines {args.engines}")
        args.engines = n_pool
    if mesh_dims is not None:
        if args.mode != "continuous":
            raise SystemExit("--mesh places the continuous engine: drop "
                             "--mode batch")
        need = args.engines * mesh_dims[0] * mesh_dims[1]
        if args.force_host_devices:
            if args.device != "cpu":
                raise SystemExit("--force-host-devices starts CPU ranks: "
                                 "pass --device cpu")
            n, have = args.force_host_devices, \
                f"--force-host-devices {args.force_host_devices}"
        else:
            n = int(os.environ.get("WORLD_SIZE", 1))
            have = f"a world of {n}"
        if n < need:
            raise SystemExit(f"--mesh {args.mesh} x --engines {args.engines} "
                             f"needs {need} ranks, {have}")
        on_cuda = args.device is None or str(args.device).startswith("cuda")
        if on_cuda and args.backend == "gloo" and not args.host_loop:
            raise SystemExit("--backend gloo stages CUDA tensors through "
                             "host memory, which the graph loop cannot "
                             "capture: pass --host-loop")
    if args.engines > 1 and not args.http:
        raise SystemExit("--engines N > 1 needs --http (the router lives "
                         "in the HTTP front end)")
    if args.prefix_cache and args.method == "vanilla":
        raise SystemExit("--prefix-cache has no effect with --method "
                         "vanilla (no KV cache to reuse)")
    if not args.http:
        for flag, on in (("--audit-rate", args.audit_rate > 0),
                         ("--flight-dir", bool(args.flight_dir)),
                         ("--slo-*", any(slo_targets(args).values())),
                         ("--trace-flush-s", args.trace_flush_s > 0),
                         ("--metrics-log", bool(args.metrics_log))):
            if on:
                raise SystemExit(f"{flag} needs --http (the audit/SLO/"
                                 "flight layer rides the HTTP serving "
                                 "loop)")
    if args.trace_flush_s > 0 and not args.trace_dir:
        raise SystemExit("--trace-flush-s needs --trace-dir (it "
                         "rewrites DIR/trace.json periodically)")
    if not 0.0 <= args.audit_rate <= 1.0:
        raise SystemExit(f"--audit-rate wants [0, 1], got "
                         f"{args.audit_rate}")
    if args.http and args.mode != "continuous":
        raise SystemExit("--http serves through the continuous engine: "
                         "drop --mode batch")
    if (args.trace_dir or args.profile_blocks) and args.mode != "continuous":
        raise SystemExit("--trace-dir and --profile-blocks need continuous "
                         "mode")
    if args.prewarm:
        parse_prewarm(args.prewarm)
        if args.mode != "continuous":
            raise SystemExit("--prewarm needs --mode continuous")


def slo_targets(args) -> dict:
    return {"ttfb_p50_s": args.slo_ttfb_p50_ms / 1e3,
            "token_latency_s": args.slo_token_latency_ms / 1e3,
            "goodput_tok_s": args.slo_goodput_tok_s}


def host_sharers(args) -> int:
    """The engines, or with a mesh the ranks (``--force-host-devices N``,
    or torchrun's ``LOCAL_WORLD_SIZE``), that share this host's cores."""
    if args.mesh:
        return args.force_host_devices or int(
            os.environ.get("LOCAL_WORLD_SIZE", 1))
    return args.engines


def host_budget(args):
    """The intra-op pool's budget, or None for PyTorch's own default (one
    engine alone on the host)."""
    from repro_torch.launch import host as host_budgeting
    sharers = host_sharers(args)
    if sharers > 1 or args.host_threads_per_engine > 0:
        return host_budgeting.compute_host_budget(
            sharers, args.host_threads_per_engine)
    return None


def pool_budgets(args, pool_sizes):
    """``--pool``'s budget record for each role (None where
    ``host_budget`` is): the host budget's threads, per process, whether
    the process runs every engine or, with a mesh, one."""
    if pool_sizes is None or host_budget(args) is None:
        return None
    from repro_torch.launch import host as host_budgeting
    return host_budgeting.compute_pool_budgets(
        pool_sizes, args.host_threads_per_engine,
        sharers=host_sharers(args) if args.mesh else None)


def pool_roles(pool_sizes):
    """One role an engine, the prefill pool first (as the JAX CLI orders
    them); None without ``--pool``."""
    if pool_sizes is None:
        return None
    return (["prefill"] * pool_sizes["prefill"]
            + ["decode"] * pool_sizes["decode"])


def make_profiler(args, rank=None):
    """``--profile-blocks``' window, under ``--trace-dir`` (or
    ``results/torch/profile``); ``rank``: this process's on a mesh."""
    from repro_torch.obs.profiler import BlockProfiler
    return BlockProfiler(
        args.trace_dir or os.path.join("results", "torch", "profile"),
        args.profile_blocks, rank=rank)


def decode_config(args, cfg) -> DecodeConfig:
    return DecodeConfig(method=args.method, gen_len=args.gen_len,
                        block_size=cfg.block_size, window=args.window,
                        tau0=args.tau0, alpha=args.alpha,
                        use_kernels=args.use_kernels,
                        fused=not args.host_loop,
                        prefix_cache=args.prefix_cache,
                        cache_chunk=args.cache_chunk)


def make_engine(args, cfg, params, device, *, executor=None, store=None,
                role: str = "both", budget=None) -> ContinuousEngine:
    """One continuous engine of the CLI's flags. Without ``store``, with
    ``--prefix-cache``, the engine gets a store of its own: the router's
    cache affinity relies on that split."""
    if args.prefix_cache and store is None:
        store = PrefixKVCache(chunk_tokens=args.cache_chunk,
                              max_bytes=args.cache_bytes,
                              placement=(executor.placement
                                         if executor is not None
                                         else device_placement(device)))
    return ContinuousEngine(
        cfg, params, decode_config(args, cfg), max_slots=args.max_slots,
        pad_pow2=args.pad_pow2, prefix_cache=store,
        prefill_only=(role == "prefill"), host_budget=budget,
        device=device, executor=executor)


def main(argv=None):
    args = parse_args(argv)
    from repro_torch.obs.log import setup_logging
    setup_logging(level=args.log_level, json_mode=args.log_json)
    check_args(args)
    mesh_dims = parse_mesh(args.mesh) if args.mesh else None
    if args.force_host_devices and "RANK" not in os.environ:
        return launch_ranks(argv, args.force_host_devices,
                            serving=bool(args.http))
    pool_sizes = parse_pool(args.pool) if args.pool else None
    prewarm_buckets = parse_prewarm(args.prewarm) if args.prewarm else []

    budget = host_budget(args)
    role_budgets = pool_budgets(args, pool_sizes)
    if budget is not None:
        from repro_torch.launch import host as host_budgeting
        host_budgeting.apply_host_budget(budget)
        print(f"host budget: {budget.describe()}")
    device = resolve_device(args.device)
    over = {"tp": mesh_dims[1]} if mesh_dims is not None else {}
    cfg = get_config(args.arch, dtype=args.dtype, param_dtype=args.dtype,
                     **over)
    executor = None
    if mesh_dims is not None:
        init_ranks(args, device)
    t0 = time.perf_counter()
    params = load_weights(args, cfg, device)
    summary = {"arch": args.arch, "method": args.method, "mode": args.mode,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")}
    if mesh_dims is not None:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.serving import DecodeExecutor
        params = broadcast_params(params)
        if args.http:
            import signal
            if torch.distributed.get_rank() != 0:
                # rank 0 drains on SIGINT and then stops every other rank
                signal.signal(signal.SIGINT, signal.SIG_IGN)
            out = serve_fleet(args, make_fleet(args, cfg, params, device))
            torch.distributed.destroy_process_group()
            if out is None:
                return None
            summary.update(out)
            print(json.dumps(summary))
            return summary
        mesh = make_host_mesh(*mesh_dims)
        if not mesh.member:                 # a rank the mesh leaves out
            torch.distributed.destroy_process_group()
            return None
        executor = DecodeExecutor(cfg, params, mesh, device=device)
    roles = pool_roles(pool_sizes)
    # pool fleets share ONE store: the prefill pool publishes chunk KV
    # into it and the decode pool's admission prefill finds the full hit
    shared_store = None
    if pool_sizes is not None:
        shared_store = PrefixKVCache(chunk_tokens=args.cache_chunk,
                                     max_bytes=args.cache_bytes,
                                     placement=device_placement(device),
                                     shared=True)

    if args.mode == "batch":
        eng = ServingEngine(cfg, params, decode_config(args, cfg),
                            mode="batch", device=device)
        engines = [eng]
    else:
        engines = [make_engine(
            args, cfg, params, device, executor=executor, store=shared_store,
            role=roles[i] if roles else "both",
            budget=(role_budgets[roles[i]] if role_budgets is not None
                    else budget)) for i in range(args.engines)]
        eng = engines[0]
    tracer = None
    if args.trace_dir:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    if args.profile_blocks > 0:
        # torch.profiler is process-wide: one engine owns the window (on
        # a mesh, one a rank: every rank runs this engine)
        eng.profiler = make_profiler(
            args, rank=torch.distributed.get_rank()
            if executor is not None else None)
    if prewarm_buckets:
        reports = prewarm_all(engines, prewarm_buckets)
        summary["prewarm"] = reports if len(reports) > 1 else reports[0]
    if args.http:
        summary.update(serve_http(args, engines, tracer, roles))
        print(json.dumps(summary))
        return summary
    if tracer is not None:
        eng.set_tracer(tracer, "engine-0")
    for prompt in make_prompts(args.n, args.seed):
        if tracer is not None:
            eng.submit(prompt, max_tokens=args.gen_len,
                       trace_id=tracer.new_trace_id())
        else:
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
    if executor is not None:
        summary.update({"mesh": dict(executor.mesh.shape),
                        "ranks": int(torch.distributed.get_world_size()),
                        "tokens_digest": tokens_digest(done)})
    if executor is None or torch.distributed.get_rank() == 0:
        # (every rank traced the same engine: rank 0 writes the file)
        export_trace(tracer, args.trace_dir)
        print(json.dumps(summary))
    if executor is not None:
        torch.distributed.destroy_process_group()
    return summary


def parse_mesh(s: str):
    try:
        data, model = (int(v) for v in s.split(","))
    except ValueError:
        raise SystemExit(f"--mesh wants 'data,model' ints, got {s!r}")
    return data, model


def tokens_digest(done) -> str:
    """A digest of every completion's tokens in uid order (two runs that
    serve the same tokens print the same one)."""
    import hashlib
    h = hashlib.sha256()
    for c in sorted(done, key=lambda c: c.uid):
        h.update(np.asarray(c.tokens, np.int64).tobytes())
    return h.hexdigest()[:16]


def init_ranks(args, device) -> None:
    """Join the world the environment names (``RANK``, ``WORLD_SIZE``,
    and ``REPRO_TORCH_INIT`` from ``launch_ranks`` or ``MASTER_ADDR``/
    ``MASTER_PORT``) with the backend of ``--backend`` (gloo on the CPU,
    NCCL on CUDA unless named)."""
    import torch.distributed as dist
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        # a device named without an index is the rank's own card
        # (torchrun's LOCAL_RANK; ranks sharing one card name it)
        torch.cuda.set_device(device.index if device.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    init = os.environ.get("REPRO_TORCH_INIT", "env://")
    if init == "env://" and "MASTER_ADDR" not in os.environ:
        if world != 1:
            raise SystemExit("--mesh over several ranks needs RANK, "
                             "WORLD_SIZE, MASTER_ADDR and MASTER_PORT "
                             "(torchrun) or --force-host-devices")
        import tempfile
        init = "file://" + os.path.join(tempfile.mkdtemp(), "rendezvous")
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)


def broadcast_params(params):
    """Every rank takes rank 0's weights (a trained or restored model is
    then the same on every rank whatever its own run gave). A gloo world
    gets CUDA tensors staged through host memory."""
    import torch.distributed as dist
    if isinstance(params, dict):
        return {k: broadcast_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(broadcast_params(v) for v in params)
    t = params.contiguous()
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.broadcast(host, src=0)
        return host.to(t.device)
    dist.broadcast(t, src=0)
    return t


def launch_ranks(argv, n: int, serving: bool = False,
                 timeout: float = 600.0) -> None:
    """Start ``n`` CPU ranks of this CLI (``RANK``/``WORLD_SIZE`` and a
    file rendezvous in a new temporary directory) and poll them: rank 0
    writes to this process's stdout and stderr, the others to logs.
    Raises as soon as a rank exits non-zero, or (unless ``serving``,
    where a server may run for hours) when a rank outlives ``timeout``
    seconds; every other rank is then killed, as on SIGTERM. ``serving``:
    SIGINT to this process goes to rank 0 alone, which drains and then
    stops the others (the ranks run in sessions of their own, so a
    terminal's Ctrl-C reaches only this process)."""
    import signal
    import subprocess
    import sys
    import tempfile
    import threading
    argv = list(argv if argv is not None else sys.argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        base = dict(os.environ, WORLD_SIZE=str(n),
                    REPRO_TORCH_INIT="file://" + os.path.join(tmp, "rdv"))
        logs = [None] + [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                         for r in range(1, n)]
        procs = []
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve", *argv],
                env=dict(base, RANK=str(r)), stdout=logs[r],
                stderr=subprocess.STDOUT if logs[r] else None,
                start_new_session=True))
            print(f"rank {r} of {n}: pid {procs[r].pid}", file=sys.stderr,
                  flush=True)
        main = threading.current_thread() is threading.main_thread()
        if main:
            # SIGTERM ends the launcher through the cleanup below, so its
            # ranks never outlive it
            old_term = signal.signal(signal.SIGTERM,
                                     lambda *_: sys.exit(128 + 15))
        forward = serving and main
        if forward:
            old = signal.signal(signal.SIGINT, lambda *_: procs[0].send_signal(
                signal.SIGINT))
        deadline = None if serving else time.monotonic() + timeout
        bad = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = next((r for r, c in enumerate(codes) if c), None)
                if bad is not None or all(c == 0 for c in codes):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    bad = next(r for r, c in enumerate(codes) if c is None)
                    break
                time.sleep(0.1)
        finally:
            if forward:
                signal.signal(signal.SIGINT, old)
            if main:
                signal.signal(signal.SIGTERM, old_term)
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tail = ""
        if bad is not None and logs[bad] is not None:
            logs[bad].seek(0)
            tail = logs[bad].read()[-4000:]
        for f in logs[1:]:
            f.close()
    if bad is not None:
        raise SystemExit(f"rank {bad} of {n} exited with "
                         f"{codes[bad] if codes[bad] is not None else 'a timeout'}"
                         f"; every rank was stopped\n{tail}")


def load_weights(args, cfg, device) -> dict:
    """The served params: restored from ``--ckpt``, else trained for
    ``--train-steps`` in float32 (the configs' ``param_dtype``) and cast
    to ``cfg``'s, else ``init_params`` of ``--seed``."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.ckpt:
        from repro_torch.training import checkpoint
        return checkpoint.restore(args.ckpt, init_params(cfg, gen, device),
                                  cfg)
    if args.train_steps > 0:
        from repro_torch.models.model import DTYPES
        from repro_torch.training.train import TrainConfig, train
        f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        params, _ = train(f32, TrainConfig(
            steps=args.train_steps, batch_size=32, seq_len=44,
            seed=args.seed), device=device)
        return params_to(params, DTYPES[cfg.param_dtype])
    return init_params(cfg, gen, device)


def prewarm_all(engines, buckets) -> list:
    """Prewarm every engine, one after another, before admission opens:
    every graph steady traffic reaches is captured now, and no engine
    captures inside another's serving window. One report per engine."""
    reports = []
    for i, eng in enumerate(engines):
        rep = eng.prewarm(buckets)
        print(f"engine-{i} prewarmed {rep['graphs']} graph(s) over "
              f"{len(rep['buckets'])} bucket(s) in {rep['seconds']:.1f}s")
        reports.append(rep)
    return reports


def export_trace(tracer, trace_dir: str) -> None:
    if tracer is not None:
        path = os.path.join(trace_dir, "trace.json")
        tracer.export(path)
        print(f"chrome trace written to {path} (open in ui.perfetto.dev)")


def serve_http(args, engines, tracer, roles=None, until=None) -> dict:
    """Serve ``engines`` (one, or a fleet behind ``EngineRouter`` with
    ``roles`` for pools) over HTTP until SIGINT, then drain (blocking);
    ``until`` (an async callable given the front end) drains it when it
    returns instead. Returns the fleet's serving counters for the
    summary line."""
    from repro_torch.server import run as run_http
    audit = None
    if args.audit_rate > 0:
        from repro_torch.obs import AuditConfig
        audit = AuditConfig(sample_rate=args.audit_rate,
                            oracle=args.audit_oracle)
    watchdog = None
    targets = slo_targets(args)
    if any(targets.values()):
        from repro_torch.obs import SLOWatchdog
        watchdog = SLOWatchdog(**{k: (v or None) for k, v in targets.items()})
    flight = None
    if args.flight_dir:
        from repro_torch.obs import FlightRecorder
        flight = FlightRecorder(args.flight_dir, tracer=tracer)
    flusher = None
    if tracer is not None and args.trace_flush_s > 0:
        from repro_torch.obs.trace import TraceFlusher
        flusher = TraceFlusher(tracer, os.path.join(args.trace_dir,
                                                    "trace.json"),
                               interval_s=args.trace_flush_s).start()
    try:
        run_http(engines if len(engines) > 1 else engines[0],
                 host=args.http_host, port=args.http,
                 max_pending=args.max_pending, tracer=tracer,
                 steal=not args.no_steal, audit=audit,
                 watchdog=watchdog, flight=flight, roles=roles,
                 metrics_interval_s=args.metrics_interval_s,
                 metrics_log=args.metrics_log or None, until=until)
    finally:
        if flusher is not None:
            flusher.stop(final_flush=False)
        export_trace(tracer, args.trace_dir)
    snaps = [e.metrics.snapshot() for e in engines]
    out = {"http": args.http, "engines": len(engines)}
    for key, snap_key in (("served", "requests"), ("tokens", "tokens"),
                          ("cancelled", "cancelled"),
                          ("deadline_misses", "deadline_misses"),
                          ("admission_rejects", "admission_rejects"),
                          ("post_warm_captures", "post_warm_compiles"),
                          ("steals", "steals_in"),
                          ("handoffs", "handoffs_in"),
                          ("handoff_bytes", "handoff_bytes"),
                          ("handoff_hit_tokens", "handoff_hit_tokens"),
                          ("prefix_cache_hit_tokens",
                           "prefix_cache_hit_tokens")):
        out[key] = sum(s[snap_key] for s in snaps)
    out["served_per_engine"] = [s["requests"] for s in snaps]
    blocks = sum(e.metrics.total_blocks for e in engines)
    out["host_syncs_per_block"] = (sum(s["total_host_syncs"] for s in snaps)
                                   / blocks if blocks else 0.0)
    out["graphs"] = sum(e.graph_cache_size() for e in engines)
    if flusher is not None:
        out["trace_flushes"] = flusher.flushes
    if engines[0].auditor is not None:
        out["audit"] = [e.auditor.stats() for e in engines] \
            if len(engines) > 1 else engines[0].auditor.stats()
    return out


@dataclasses.dataclass
class Fleet:
    """This rank's part of a fleet of engines placed on submeshes and
    served over HTTP (``make_fleet``): on rank 0, ``engines`` holds one
    ``serving.replica.EngineProxy`` an engine; on every rank of a
    submesh, ``replica`` executes its engine's ops, told by ``control``;
    a rank outside every submesh has neither. ``roles``: each engine's
    pool role (``--pool``), else None."""
    meshes: list
    engines: list
    replica: object = None
    control: object = None
    roles: object = None


def make_fleet(args, cfg, params, device) -> Fleet:
    """Place ``args.engines`` engines on consecutive submeshes of
    ``--mesh``'s shape (engine ``i`` on ranks ``[i*D*M, (i+1)*D*M)``; with
    ``--pool`` the prefill engines first) in an initialised world, with
    one control group each; every rank calls it, after
    ``broadcast_params``. With ``--pool`` each rank's engine gets a
    store keyed by the mesh shape, as the JAX CLI keys its one shared
    store (a handoff carries chunk KV between engines of that shape);
    with ``--profile-blocks`` every rank of engine 0 opens its own
    window. Rank 0 returns with its proxies once every engine has
    answered a first query."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_submeshes
    from repro_torch.serving import DecodeExecutor
    from repro_torch.serving.replica import (EngineProxy, Replica,
                                             make_control_groups)
    meshes = make_submeshes(args.engines, *parse_mesh(args.mesh))
    controls = make_control_groups(meshes)
    mine = next((i for i, m in enumerate(meshes) if m.member), None)
    pool_sizes = parse_pool(args.pool) if args.pool else None
    roles = pool_roles(pool_sizes)
    budget = host_budget(args)
    budgets = pool_budgets(args, pool_sizes)
    replica = None
    if mine is not None:
        executor = DecodeExecutor(cfg, params, meshes[mine], device=device)
        role = roles[mine] if roles else "both"
        store = None
        if roles:
            store = PrefixKVCache(chunk_tokens=args.cache_chunk,
                                  max_bytes=args.cache_bytes,
                                  placement=executor.shape_key, shared=True)
        engine = make_engine(args, cfg, params, device, executor=executor,
                             store=store, role=role,
                             budget=budgets[role] if budgets else budget)
        if args.profile_blocks > 0 and mine == 0:
            engine.profiler = make_profiler(args, rank=dist.get_rank())
        replica = Replica(engine)
    engines = []
    if dist.get_rank() == 0:
        engines = [EngineProxy(
            ctl, cfg=cfg, dcfg=decode_config(args, cfg),
            tokenizer=replica.engine.tok,
            replica=replica if i == mine else None,
            prefix_cache=args.cache_chunk if args.prefix_cache else None,
            host_budget=budgets[roles[i]] if budgets else budget,
            prefill_only=roles is not None and roles[i] == "prefill")
            for i, ctl in enumerate(controls)]
    return Fleet(meshes, engines, replica,
                 controls[mine] if mine is not None else None, roles)


def serve_fleet(args, fleet: Fleet, until=None):
    """Serve ``fleet`` (``make_fleet``). Rank 0: ``--prewarm`` on every
    engine, the HTTP front end (``serve_http``, with the router for
    ``--engines`` > 1) until SIGINT or ``until``, then ``stop`` to every
    engine; returns the summary's counters and the mesh. Every other
    rank replays its engine's ops until rank 0's ``stop`` and returns
    None. A proxy whose engine lost a rank drains the front end (CLI)
    and makes rank 0 raise once it has."""
    import torch.distributed as dist
    from repro_torch.obs.log import get_logger
    from repro_torch.serving.replica import follow
    log = get_logger(__name__)
    if not fleet.engines:
        if fleet.replica is not None:
            n = follow(fleet.replica, fleet.control)
            log.info("rank %d replayed %d op(s) of %s", dist.get_rank(), n,
                     fleet.control)
        return None
    broke = []

    def on_break(proxy):
        broke.append(proxy)
        if until is None:
            import signal
            os.kill(os.getpid(), signal.SIGINT)
    for p in fleet.engines:
        p.on_break = on_break
    out = {}
    buckets = parse_prewarm(args.prewarm) if args.prewarm else []
    tracer = None
    if args.trace_dir:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    try:
        if buckets:
            reports = prewarm_all(fleet.engines, buckets)
            out["prewarm"] = reports if len(reports) > 1 else reports[0]
        out.update(serve_http(args, fleet.engines, tracer, fleet.roles,
                              until=until))
    finally:
        for p in fleet.engines:
            p.stop()
    out.update({"mesh": dict(fleet.meshes[0].shape),
                "ranks": dist.get_world_size(),
                "ops": [dict(p.ops) for p in fleet.engines],
                "ops_s": [dict(p.op_s) for p in fleet.engines]})
    if broke:
        raise SystemExit("engine(s) " + ", ".join(
            str(fleet.engines.index(p)) for p in broke) + " lost a rank: "
            + "; ".join(str(p.broken) for p in broke))
    return out


if __name__ == "__main__":
    main()
