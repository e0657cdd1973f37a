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
``--mesh`` and ``--force-host-devices`` wait for ROADMAP A11.
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


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="There is no --compile-cache-dir: the JAX package's "
        "persistent compilation cache has no counterpart here, because "
        "the port's block programs are CUDA graphs captured in-process "
        "and not persisted; --prewarm captures them before serving "
        "(ROADMAP A9).")
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
    ap.add_argument("--log-json", action="store_true",
                    help="JSON-lines log records instead of text")
    ap.add_argument("--engines", type=int, default=1, metavar="N",
                    help="engine loops on the card, each on its own CUDA "
                    "stream, behind one HTTP front end (cache affinity, "
                    "then least-loaded routing; HTTP mode only for N > 1)")
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
                    "cores // engines (repro_torch.launch.host)")
    ap.add_argument("--mesh", default="", metavar="DATA,MODEL",
                    help="per-engine mesh placement (ROADMAP A11: not "
                    "ported, raises)")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    help="fake host devices (ROADMAP A11: not ported, "
                    "raises)")
    args = ap.parse_args(argv)

    from repro_torch.obs.log import setup_logging
    setup_logging(json_mode=args.log_json)
    # flag validation up front, before any weights are made
    if args.mesh or args.force_host_devices:
        raise NotImplementedError(
            "--mesh and --force-host-devices (mesh placement) are "
            "ROADMAP A11")
    if args.engines > 1 and not args.http:
        raise SystemExit("--engines N > 1 needs --http (the router lives "
                         "in the HTTP front end)")
    if args.prefix_cache and args.method == "vanilla":
        raise SystemExit("--prefix-cache has no effect with --method "
                         "vanilla (no KV cache to reuse)")
    pool_sizes = parse_pool(args.pool) if args.pool else None
    if pool_sizes is not None:
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
    slo_targets = {"ttfb_p50_s": args.slo_ttfb_p50_ms / 1e3,
                   "token_latency_s": args.slo_token_latency_ms / 1e3,
                   "goodput_tok_s": args.slo_goodput_tok_s}
    if not args.http:
        for flag, on in (("--audit-rate", args.audit_rate > 0),
                         ("--flight-dir", bool(args.flight_dir)),
                         ("--slo-*", any(slo_targets.values())),
                         ("--metrics-log", bool(args.metrics_log))):
            if on:
                raise SystemExit(f"{flag} needs --http (the audit/SLO/"
                                 "flight layer rides the HTTP serving "
                                 "loop)")
    if not 0.0 <= args.audit_rate <= 1.0:
        raise SystemExit(f"--audit-rate wants [0, 1], got "
                         f"{args.audit_rate}")
    if args.http and args.mode != "continuous":
        raise SystemExit("--http serves through the continuous engine: "
                         "drop --mode batch")
    if (args.trace_dir or args.profile_blocks) and args.mode != "continuous":
        raise SystemExit("--trace-dir and --profile-blocks need continuous "
                         "mode")
    prewarm_buckets = parse_prewarm(args.prewarm) if args.prewarm else []
    if prewarm_buckets and args.mode != "continuous":
        raise SystemExit("--prewarm needs --mode continuous")

    # a fleet (or an explicit --host-threads-per-engine) sizes the
    # process's intra-op pool; one engine keeps PyTorch's own default
    budget = pool_budgets = None
    if args.engines > 1 or args.host_threads_per_engine > 0:
        from repro_torch.launch import host as host_budgeting
        budget = host_budgeting.apply_host_budget(
            host_budgeting.compute_host_budget(
                args.engines, args.host_threads_per_engine))
        if pool_sizes is not None:
            pool_budgets = host_budgeting.compute_pool_budgets(
                pool_sizes, args.host_threads_per_engine)
        print(f"host budget: {budget.describe()}")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, dtype=args.dtype, param_dtype=args.dtype)
    t0 = time.perf_counter()
    params = load_weights(args, cfg, device)
    d = DecodeConfig(method=args.method, gen_len=args.gen_len,
                     block_size=cfg.block_size, window=args.window,
                     tau0=args.tau0, alpha=args.alpha,
                     use_kernels=args.use_kernels,
                     fused=not args.host_loop,
                     prefix_cache=args.prefix_cache,
                     cache_chunk=args.cache_chunk)
    roles = None
    if pool_sizes is not None:
        roles = (["prefill"] * pool_sizes["prefill"]
                 + ["decode"] * pool_sizes["decode"])
    # pool fleets share ONE store: the prefill pool publishes chunk KV
    # into it and the decode pool's admission prefill finds the full hit
    shared_store = None
    if pool_sizes is not None:
        shared_store = PrefixKVCache(chunk_tokens=args.cache_chunk,
                                     max_bytes=args.cache_bytes,
                                     placement=device_placement(device),
                                     shared=True)

    def make_engine(role: str = "both"):
        store = shared_store
        if args.prefix_cache and store is None:
            # one store per engine otherwise: the router's cache
            # affinity relies on that split
            store = PrefixKVCache(chunk_tokens=args.cache_chunk,
                                  max_bytes=args.cache_bytes,
                                  placement=device_placement(device))
        return ContinuousEngine(
            cfg, params, d, max_slots=args.max_slots,
            pad_pow2=args.pad_pow2, prefix_cache=store,
            prefill_only=(role == "prefill"),
            host_budget=(pool_budgets[role] if pool_budgets is not None
                         else budget),
            device=device)

    if args.mode == "batch":
        eng = ServingEngine(cfg, params, d, mode="batch", device=device)
        engines = [eng]
    else:
        engines = [make_engine(roles[i] if roles else "both")
                   for i in range(args.engines)]
        eng = engines[0]
    summary = {"arch": args.arch, "method": args.method, "mode": args.mode,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")}
    tracer = None
    if args.trace_dir:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    if args.profile_blocks > 0:
        # torch.profiler is process-wide: one engine owns the window
        from repro_torch.obs.profiler import BlockProfiler
        eng.profiler = BlockProfiler(
            args.trace_dir or os.path.join("results", "torch", "profile"),
            args.profile_blocks)
    if prewarm_buckets:
        reports = prewarm_all(engines, prewarm_buckets)
        summary["prewarm"] = reports if len(reports) > 1 else reports[0]
    if args.http:
        summary.update(serve_http(args, engines, tracer, slo_targets,
                                  roles))
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
    export_trace(tracer, args.trace_dir)
    print(json.dumps(summary))
    return summary


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


def serve_http(args, engines, tracer, slo_targets, roles=None) -> dict:
    """Serve ``engines`` (one, or a fleet behind ``EngineRouter`` with
    ``roles`` for pools) over HTTP until SIGINT, then drain (blocking).
    Returns the fleet's serving counters for the summary line."""
    from repro_torch.server import run as run_http
    audit = None
    if args.audit_rate > 0:
        from repro_torch.obs import AuditConfig
        audit = AuditConfig(sample_rate=args.audit_rate,
                            oracle=args.audit_oracle)
    watchdog = None
    if any(slo_targets.values()):
        from repro_torch.obs import SLOWatchdog
        watchdog = SLOWatchdog(
            **{k: (v or None) for k, v in slo_targets.items()})
    flight = None
    if args.flight_dir:
        from repro_torch.obs import FlightRecorder
        flight = FlightRecorder(args.flight_dir, tracer=tracer)
    try:
        run_http(engines if len(engines) > 1 else engines[0],
                 host=args.http_host, port=args.http,
                 max_pending=args.max_pending, tracer=tracer,
                 steal=not args.no_steal, audit=audit,
                 watchdog=watchdog, flight=flight, roles=roles,
                 metrics_interval_s=args.metrics_interval_s,
                 metrics_log=args.metrics_log or None)
    finally:
        export_trace(tracer, args.trace_dir)
    snaps = [e.metrics.snapshot() for e in engines]
    out = {"http": args.http, "engines": len(engines)}
    for key, snap_key in (("served", "requests"), ("tokens", "tokens"),
                          ("cancelled", "cancelled"),
                          ("admission_rejects", "admission_rejects"),
                          ("post_warm_captures", "post_warm_compiles"),
                          ("steals", "steals_in"),
                          ("handoffs", "handoffs_in")):
        out[key] = sum(s[snap_key] for s in snaps)
    if engines[0].auditor is not None:
        out["audit"] = [e.auditor.stats() for e in engines] \
            if len(engines) > 1 else engines[0].auditor.stats()
    return out


if __name__ == "__main__":
    main()
