"""Asyncio HTTP/1.1 front end over ``EngineLoop`` (a copy of
``repro.server.http``; on the card the decode thread is the only one that
runs CUDA work: every route here reads host-side counters).

Routes:
    POST /v1/completions   JSON body (see ``ServerRequest.from_json``);
                           ``stream:false`` → one JSON object (its
                           ``tokens`` the ids behind ``text``),
                           ``stream:true``  → SSE ``data:`` events at
                           block boundaries, then a final summary event
                           and a ``[DONE]`` sentinel.
    GET  /healthz          liveness + drain state + queue depth.
    GET  /metrics          Prometheus text format from ``ServeMetrics``.
    GET  /debug/vars       live per-engine state as JSON: queue depths,
                           in-flight gangs, steal/compile/audit counters
                           (operator inspection without scraping the
                           Prometheus text).
    GET  /debug/flight     trigger a flight-recorder dump (trace ring
                           buffers + metrics + scheduler state); 503
                           when no ``--flight-dir`` is configured.
    GET  /debug/timeline   windowed time-series JSON per engine plus
                           fleet/pool aggregates (repro_torch.obs.series);
                           ``?window=`` seconds of history at
                           ``?step=``-second buckets.
    GET  /console          self-contained fleet ops console (static
                           HTML, zero external deps) polling
                           /debug/timeline for live sparklines.

Request lifecycle guarantees:
* admission is bounded — a full queue answers ``429`` with
  ``Retry-After`` instead of building unbounded backlog;
* a streaming client that disconnects (EOF on its socket, or a failed
  write) cancels its request: the decode slot is freed at the next
  block boundary and concurrent requests are untouched (non-streaming
  requests run to completion — EOF after a full request is a legal
  half-close, not proof the client is gone);
* ``timeout_s`` deadlines return the partial completion with
  ``finish_reason="deadline"``;
* shutdown drains: the listener closes first, in-flight requests run
  to completion (bounded by ``timeout_s``), then the decode thread
  stops.
"""
from __future__ import annotations

import asyncio
import json
import math
import time
from typing import Optional

from repro_torch.obs.log import get_logger
from repro_torch.obs.metrics import Histogram, device_memory_stats
from repro_torch.server import wire
from repro_torch.server.loop import EngineLoop, Ticket
from repro_torch.server.types import (AdmissionRejected, BadRequest,
                                ServerRequest, finish_reason)

log = get_logger(__name__)


class HttpFrontend:
    """Accepts either a single ``EngineLoop`` or an ``EngineRouter``
    over several (one per device/mesh) — the router exposes the same
    submit/cancel surface, so all routes below are engine-count
    agnostic; only /healthz and /metrics fan in across engines."""

    def __init__(self, engine_loop, host: str = "127.0.0.1",
                 port: int = 8000, request_timeout_s: float = 10.0,
                 tracer=None, flight=None, watchdog=None):
        self.loop = engine_loop                       # loop OR router
        self.engines = getattr(engine_loop, "engines",
                               None) or [engine_loop.engine]
        self.engine = self.engines[0]                 # 1-engine alias
        self.host = host
        self.port = port
        self.request_timeout_s = request_timeout_s   # header-read budget
        self.tracer = tracer
        # quality auditing (repro_torch.obs.audit): the FlightRecorder backs
        # GET /debug/flight; the SLOWatchdog feeds repro_slo_* metrics
        # (both usually wired by _front / launch.serve)
        self.flight = flight
        self.watchdog = watchdog
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._draining = False

    # ------------------------------------------------------ lifecycle

    async def start(self) -> "HttpFrontend":
        # reads (and caches) each card's total memory now, before the
        # decode thread can be capturing a graph when /metrics asks
        device_memory_stats()
        self._server = await asyncio.start_server(
            self._client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.tracer is not None:
            self.tracer.name_thread("asyncio")       # pid 0 = front end
        if not self.loop.running:
            self.loop.start()
        return self

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self, drain: bool = True,
                       timeout_s: float = 30.0) -> None:
        """Graceful drain: stop accepting, let in-flight requests
        finish, then stop the decode thread. ``drain=False`` cancels
        everything instead."""
        self._draining = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if drain:
            deadline = asyncio.get_running_loop().time() + timeout_s
            while (self.loop.inflight or self._conns) \
                    and asyncio.get_running_loop().time() < deadline:
                await asyncio.sleep(0.02)
        await asyncio.to_thread(self.loop.close, drain, timeout_s)
        for task in list(self._conns):
            task.cancel()

    # ------------------------------------------------------ connection

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """Serve requests off one socket until the client (or a
        streaming response, or drain) ends the connection — HTTP/1.1
        keep-alive, so small-prompt clients don't pay TCP setup per
        request. An idle keep-alive socket that times out waiting for
        the *next* request is closed silently (only the first request
        earns a 408: before it, timing out means a slow client, not an
        idle one)."""
        task = asyncio.current_task()
        self._conns.add(task)
        first = True
        try:
            while True:
                try:
                    req = await asyncio.wait_for(
                        wire.read_request(reader),
                        timeout=self.request_timeout_s)
                except asyncio.TimeoutError:
                    if first:
                        writer.write(wire.error_response(
                            408, "request timeout"))
                    return
                except BadRequest as e:
                    writer.write(wire.error_response(400, e.message))
                    return
                if req is None:
                    return
                # drain closes after the in-flight response; a fresh
                # accept during drain still gets its 503 below
                keep = req.keep_alive and not self._draining
                if not await self._route(req, reader, writer, keep):
                    return
                first = False
        except (ConnectionResetError, BrokenPipeError):
            pass
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("connection handler failed")
            try:
                writer.write(wire.error_response(500, "internal error"))
            except Exception:
                pass
        finally:
            self._conns.discard(task)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, req: wire.HttpRequest, reader, writer,
                     keep: bool) -> bool:
        """Handle one request; returns whether the connection survives
        (False after a streaming response, whose end-of-body is the
        connection close itself)."""
        if req.path == "/healthz":
            if req.method != "GET":
                writer.write(wire.error_response(405, "use GET",
                                                 keep_alive=keep))
            else:
                writer.write(wire.response(200, self._health(),
                                           keep_alive=keep))
        elif req.path == "/metrics":
            if req.method != "GET":
                writer.write(wire.error_response(405, "use GET",
                                                 keep_alive=keep))
            else:
                writer.write(wire.response(
                    200, self._metrics_text(),
                    content_type="text/plain; version=0.0.4",
                    keep_alive=keep))
        elif req.path == "/debug/vars":
            if req.method != "GET":
                writer.write(wire.error_response(405, "use GET",
                                                 keep_alive=keep))
            else:
                writer.write(wire.response(200, self._debug_vars(),
                                           keep_alive=keep))
        elif req.path == "/debug/flight":
            if req.method != "GET":
                writer.write(wire.error_response(405, "use GET",
                                                 keep_alive=keep))
            elif self.flight is None:
                writer.write(wire.error_response(
                    503, "no flight recorder (start with --flight-dir)",
                    keep_alive=keep))
            else:
                path = await asyncio.to_thread(
                    self.flight.dump, "manual", True)
                writer.write(wire.response(
                    200, {"path": path, "dumps": self.flight.dumps,
                          "suppressed": self.flight.suppressed},
                    keep_alive=keep))
        elif req.path == "/debug/timeline":
            if req.method != "GET":
                writer.write(wire.error_response(405, "use GET",
                                                 keep_alive=keep))
            else:
                writer.write(wire.response(200, self._timeline(req),
                                           keep_alive=keep))
        elif req.path == "/console":
            if req.method != "GET":
                writer.write(wire.error_response(405, "use GET",
                                                 keep_alive=keep))
            else:
                from repro_torch.server.console import CONSOLE_HTML
                writer.write(wire.response(
                    200, CONSOLE_HTML,
                    content_type="text/html; charset=utf-8",
                    extra_headers={"Cache-Control": "no-cache"},
                    keep_alive=keep))
        elif req.path == "/v1/completions":
            if req.method != "POST":
                writer.write(wire.error_response(405, "use POST",
                                                 keep_alive=keep))
            else:
                keep = await self._completions(req, reader, writer, keep)
        else:
            writer.write(wire.error_response(404, f"no route {req.path}",
                                             keep_alive=keep))
        await writer.drain()
        return keep

    # ------------------------------------------------------ completions

    async def _completions(self, req: wire.HttpRequest,
                           reader, writer, keep: bool) -> bool:
        """Returns whether the connection can serve another request."""
        accept_ns = time.perf_counter_ns()
        if self._draining:
            writer.write(wire.error_response(
                503, "server is draining", {"Retry-After": "5"}))
            return False
        try:
            body = json.loads(req.body.decode("utf-8") or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            writer.write(wire.error_response(400, "body is not valid JSON",
                                             keep_alive=keep))
            return keep
        try:
            sreq = ServerRequest.from_json(body)
        except BadRequest as e:
            writer.write(wire.error_response(400, e.message,
                                             keep_alive=keep))
            return keep
        aioloop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()

        def deliver(event):           # called from the decode thread
            aioloop.call_soon_threadsafe(events.put_nowait, event)

        try:
            ticket = self.loop.submit(sreq, deliver)
        except AdmissionRejected as e:
            writer.write(wire.error_response(
                429, e.message,
                {"Retry-After": str(int(math.ceil(e.retry_after_s)))},
                keep_alive=keep))
            return keep
        if self.tracer is not None and ticket.trace_id:
            # outermost span of the request tree: socket accept ->
            # final response byte written (or disconnect drain)
            ticket.accept_ns = accept_ns
            self.tracer.async_begin(ticket.trace_id, "http",
                                    t_ns=accept_ns, path=req.path,
                                    stream=sreq.stream)
        if sreq.stream:
            await self._stream_response(ticket, events, reader, writer)
            return False       # chunked SSE ends with the connection
        await self._json_response(ticket, events, writer, keep)
        return keep

    async def _wait_disconnect(self, reader) -> None:
        """Resolves on EOF from the client. Only *streaming* responses
        treat this as a disconnect-cancel signal: mid-SSE, the client's
        sole way to give up is dropping the connection, and freeing the
        decode slot at the next block boundary is the whole point. A
        non-streaming client may legally half-close after sending its
        full request (shutdown(SHUT_WR)) while still reading — EOF
        there does NOT mean gone, so JSON responses always run to
        completion and are written regardless (a dead peer just makes
        the write fail, which the connection handler swallows)."""
        while True:
            try:
                data = await reader.read(4096)
            except (ConnectionError, asyncio.IncompleteReadError):
                return
            if not data:
                return

    def _end_http(self, ticket: Ticket, **args) -> None:
        """Close the request's outermost ("http") span."""
        if self.tracer is not None and ticket.trace_id:
            self.tracer.async_end(ticket.trace_id, "http", **args)

    def _end_http_on_done(self, ticket: Ticket,
                          events: asyncio.Queue, **args) -> None:
        """Disconnect path: the client is gone but the engine keeps the
        row until the next block boundary — the "request" span closes
        then, from the decode thread. Park a task on the (now
        client-less) event queue so "http" closes strictly after it and
        the span tree stays well-formed."""
        if self.tracer is None or not ticket.trace_id:
            return

        async def _wait():
            try:
                await self._await_done(events)
            finally:
                self._end_http(ticket, **args)

        task = asyncio.get_running_loop().create_task(_wait())
        self._conns.add(task)            # shutdown() waits for these
        task.add_done_callback(self._conns.discard)

    async def _json_response(self, ticket: Ticket, events,
                             writer, keep: bool = False) -> None:
        comp = await self._await_done(events)
        headers = {"X-Repro-Trace-Id": ticket.trace_id} \
            if ticket.trace_id else None
        try:
            writer.write(wire.response(
                200, self._completion_json(comp, ticket),
                extra_headers=headers, keep_alive=keep))
            await writer.drain()
        finally:
            # the completion is in hand, so "request" already closed —
            # end "http" even when the final write finds the peer gone
            self._end_http(ticket, status=200)

    @staticmethod
    async def _await_done(events: asyncio.Queue):
        while True:
            kind, payload = await events.get()
            if kind == "done":
                return payload

    async def _stream_response(self, ticket: Ticket, events, reader,
                               writer) -> None:
        writer.write(wire.sse_header(
            {"X-Repro-Trace-Id": ticket.trace_id}
            if ticket.trace_id else None))
        disconnect = asyncio.create_task(self._wait_disconnect(reader))
        nxt = None
        try:
            await writer.drain()
            while True:
                nxt = asyncio.create_task(events.get())
                done, _ = await asyncio.wait(
                    {disconnect, nxt},
                    return_when=asyncio.FIRST_COMPLETED)
                if nxt not in done:
                    self.loop.cancel(ticket, "disconnect")
                    self._end_http_on_done(ticket, events,
                                           disconnect=True)
                    return
                kind, payload = nxt.result()
                if kind == "chunk":
                    writer.write(wire.sse_event({
                        "uid": payload.uid, "block": payload.block_idx,
                        "text": payload.text,
                        "finished": payload.finished}))
                else:                        # ("done", Completion)
                    writer.write(wire.sse_event(
                        self._completion_json(payload, ticket)))
                    writer.write(wire.sse_event(wire.SSE_DONE_SENTINEL))
                    writer.write(wire.CHUNKED_EOF)
                    await writer.drain()
                    self._end_http(ticket, status=200)
                    return
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            self.loop.cancel(ticket, "disconnect")
            self._end_http_on_done(ticket, events, disconnect=True)
        finally:
            disconnect.cancel()
            if nxt is not None:
                nxt.cancel()

    def _completion_json(self, comp, ticket: Ticket) -> dict:
        doc = {
            "uid": comp.uid, "text": comp.text,
            # the token ids behind ``text`` (the JAX package's document
            # has text only): a client can hold them bit for bit
            "tokens": [int(t) for t in comp.tokens],
            "n_tokens": comp.n_tokens, "n_blocks": comp.n_blocks,
            "max_tokens": comp.max_tokens,
            "finish_reason": finish_reason(comp, ticket.cancel_reason),
            "cancelled": comp.cancelled,
            "latency_s": comp.latency_s, "ttfb_s": comp.ttfb_s,
            "queue_s": comp.queue_s, "nfe": comp.nfe,
            "cache_hit_tokens": comp.cache_hit_tokens,
        }
        if ticket.trace_id:
            doc["trace_id"] = ticket.trace_id
        if ticket.req.trace and self.tracer is not None \
                and ticket.trace_id:
            # opt-in span echo: everything recorded for this request so
            # far (the "http" span itself closes after this response is
            # written, so it is absent by construction)
            doc["trace"] = {
                "trace_id": ticket.trace_id,
                "events": self.tracer.request_events(ticket.trace_id)}
        return doc

    # ------------------------------------------------------ health/metrics

    def _health(self) -> dict:
        scheds = [e.scheduler for e in self.engines]
        return {"status": "draining" if self._draining else "ok",
                "engines": len(self.engines),
                "inflight": self.loop.inflight,
                "queue_depth": sum(e.metrics.queue_depth
                                   for e in self.engines),
                "live_rows": sum(s.live_rows for s in scheds),
                "idle": all(s.idle for s in scheds)}

    def _debug_vars(self) -> dict:
        """Live engine state for operators: one row per EngineLoop
        (queue depths, in-flight gangs, steal/compile/audit counters).
        Cross-thread reads — one tick stale at worst, never torn."""
        loops = getattr(self.loop, "loops", None) or [self.loop]
        doc = {"status": "draining" if self._draining else "ok",
               "engines": [lp.debug_vars() for lp in loops]}
        if self.watchdog is not None:
            doc["slo"] = self.watchdog.current()
        if self.flight is not None:
            doc["flight"] = {"dumps": self.flight.dumps,
                             "suppressed": self.flight.suppressed,
                             "dir": self.flight.flight_dir}
        if self.tracer is not None:
            doc["trace_drops"] = self.tracer.dropped
        return doc

    def _timeline(self, req: wire.HttpRequest = None) -> dict:
        """Windowed rate series per engine + fleet/pool aggregates
        (repro_torch.obs.series). The recorder rings are written by the
        decode threads and snapshotted here without a lock — same
        GIL-atomic deque contract as the tracer."""
        from repro_torch.obs.series import timeline_doc
        params = req.params() if req is not None else {}

        def num(key, default, lo, hi):
            try:
                return min(max(float(params.get(key, default)), lo), hi)
            except (TypeError, ValueError):
                return default

        window = num("window", 120.0, 1.0, 3600.0)
        step = num("step", 5.0, 0.1, window)
        loops = getattr(self.loop, "loops", None) or [self.loop]
        return timeline_doc(loops, window_s=window, step_s=step,
                            watchdog=self.watchdog)

    def _metrics_text(self) -> str:
        """Prometheus text. Top-level series aggregate over every
        engine (sums; occupancy wall-time-weighted; quantiles pooled
        over the raw per-request records, since percentiles don't
        average). Per-engine breakdowns live under a separate
        ``repro_engine_*`` family with an ``engine`` label — same
        family as the aggregate would double-count on scrape."""
        from repro_torch.serving.metrics import percentile
        snaps = [e.metrics.snapshot() for e in self.engines]

        def tot(key):
            return sum(s[key] for s in snaps)

        wall = max(sum(s["wall_time_s"] for s in snaps), 1e-9)
        occ = sum(s["mean_occupancy"] * s["wall_time_s"]
                  for s in snaps) / wall
        # engines decode concurrently: fleet tok/s is the sum of each
        # engine's tokens over its own scheduler wall time
        tput = sum(s["throughput_tok_s"] for s in snaps)
        out = []

        def emit(name, value, mtype, help_text):
            out.append(f"# HELP {name} {help_text}")
            out.append(f"# TYPE {name} {mtype}")
            out.append(f"{name} {value}")

        emit("repro_requests_total", tot("requests"), "counter",
             "Completed requests (including cancelled).")
        emit("repro_tokens_total", tot("tokens"), "counter",
             "Generated tokens across completed requests.")
        emit("repro_nfe_total", tot("total_nfe"), "counter",
             "Model forward evaluations.")
        emit("repro_admission_rejects_total", tot("admission_rejects"),
             "counter", "Requests rejected with 429 (queue full).")
        emit("repro_cancelled_total", tot("cancelled"), "counter",
             "Requests cancelled (explicit, disconnect, or deadline).")
        emit("repro_deadline_misses_total", tot("deadline_misses"),
             "counter", "Cancelled requests whose cause was timeout_s.")
        emit("repro_gang_merges_total", tot("gang_merges"), "counter",
             "Cross-gang straggler merges at block boundaries.")
        emit("repro_prefix_cache_hits_total", tot("prefix_cache_hits"),
             "counter", "Requests whose prefill reused cached prompt KV.")
        emit("repro_prefix_cache_hit_tokens_total",
             tot("prefix_cache_hit_tokens"), "counter",
             "Prompt tokens served from the cross-request prefix cache.")
        emit("repro_prefix_cache_evictions_total",
             tot("prefix_cache_evictions"), "counter",
             "Prefix-cache chunks evicted (LRU under the byte budget).")
        emit("repro_prefix_cache_bytes", tot("prefix_cache_bytes"),
             "gauge", "Resident prefix-cache chunk KV bytes.")
        emit("repro_prefix_cache_chunks", tot("prefix_cache_nodes"),
             "gauge", "Resident prefix-cache chunks (radix-tree nodes).")
        emit("repro_queue_depth", tot("queue_depth"), "gauge",
             "Requests queued (front end + scheduler), not in a slot.")
        emit("repro_inflight", self.loop.inflight, "gauge",
             "Requests admitted and not yet finished.")
        emit("repro_engines", len(self.engines), "gauge",
             "Engine loops behind this front end.")
        emit("repro_mean_occupancy", f"{occ:.6f}",
             "gauge", "Mean decode-slot occupancy (wall-time weighted).")
        emit("repro_throughput_tok_per_s", f"{tput:.6f}", "gauge",
             "Generated tokens per second of scheduler wall time.")
        # compile ledger (repro_torch.obs.CompileWatch) + host budget
        emit("repro_compile_misses_total", tot("compile_misses"),
             "counter", "New jit variants compiled across engines.")
        emit("repro_compile_hits_total", tot("compile_hits"), "counter",
             "Jit-dispatching calls fully served by compiled variants.")
        emit("repro_compile_seconds_total",
             f"{tot('compile_seconds'):.6f}", "counter",
             "Wall seconds attributed to variant-building calls.")
        emit("repro_post_warm_compiles_total", tot("post_warm_compiles"),
             "counter", "Variants compiled after pre-warm declared the "
             "engine warm (should stay 0).")
        emit("repro_prewarmed_engines", tot("prewarmed"), "gauge",
             "Engines whose startup pre-warm completed.")
        emit("repro_host_threads_per_engine",
             snaps[0]["host_threads"], "gauge",
             "Budgeted XLA:CPU intra-op threads per engine (0 = "
             "unbudgeted).")
        emit("repro_steals_total", tot("steals_in"), "counter",
             "Requests migrated between engines by block-boundary work "
             "stealing.")
        # engine busy time split by phase: prefill passes (prompt KV
        # priming, cached-chunk replays) vs decode_block walls — the
        # two never overlap on one engine, so the split partitions the
        # decode thread's model time and makes pool sizing visible
        emit("repro_prefill_busy_seconds_total",
             f"{tot('prefill_busy_s'):.6f}", "counter",
             "Wall seconds spent in prefill passes across engines.")
        emit("repro_decode_busy_seconds_total",
             f"{tot('decode_busy_s'):.6f}", "counter",
             "Wall seconds spent in decode_block calls across engines.")
        emit("repro_handoffs_total", tot("handoffs_in"), "counter",
             "Requests handed off prefill pool -> decode pool through "
             "the shared radix store.")
        loops = getattr(self.loop, "loops", None) or [self.loop]
        roles = {}
        for lp in loops:
            role = getattr(lp, "role", "both")
            roles[role] = roles.get(role, 0) + 1
        out.append("# HELP repro_pool_engines Engine loops per pool "
                   "role (prefill-only vs decode-capable).")
        out.append("# TYPE repro_pool_engines gauge")
        for role, n in sorted(roles.items()):
            out.append(f'repro_pool_engines{{role="{role}"}} {n}')
        # the JAX package's persistent compilation-cache counters: the
        # port's block programs are CUDA graphs captured in-process and
        # never persisted, so both series stay 0 (kept for scrapers)
        emit("repro_persistent_cache_hits_total", 0, "counter",
             "Persistent compilation cache hits (always 0: CUDA graphs "
             "are not persisted).")
        emit("repro_persistent_cache_misses_total", 0, "counter",
             "Persistent compilation cache misses (always 0: CUDA graphs "
             "are not persisted).")
        for metric, key in (("repro_latency_seconds", "latency"),
                            ("repro_ttfb_quantile_seconds", "ttfb")):
            vals = [getattr(r, f"{key}_s")
                    for e in self.engines for r in e.metrics.requests]
            out.append(f"# HELP {metric} Request {key} quantiles "
                       "(pooled across engines).")
            out.append(f"# TYPE {metric} summary")
            for q, pct in (("0.5", 50), ("0.99", 99)):
                out.append(f'{metric}{{quantile="{q}"}} '
                           f"{percentile(vals, pct):.6f}")
        # bucketed histograms (TTFB, queue wait, block wall, NFE/token):
        # one engine emits the bare family; a fleet emits one labeled
        # series per engine — PromQL sums across labels by ``le``, and
        # a pre-pooled unlabeled duplicate would double-count on scrape
        if len(self.engines) == 1:
            for h in self.engines[0].metrics.histograms:
                out.extend(h.prometheus())
        else:
            per_engine = zip(*(e.metrics.histograms
                               for e in self.engines))
            for series in per_engine:
                for i, h in enumerate(series):
                    lines = h.prometheus(f'engine="{i}"')
                    # HELP/TYPE once per family, not once per engine
                    out.extend(lines if i == 0 else lines[2:])
        # per-block decode dynamics (repro_torch.obs.telemetry) rollup
        tel = [e.telemetry.totals() for e in self.engines]

        def ttel(key):
            return sum(t[key] for t in tel)

        steps, caps = ttel("steps"), ttel("steps_cap")
        emit("repro_decode_blocks_total", ttel("blocks"), "counter",
             "decode_block calls across engines.")
        emit("repro_decode_steps_total", steps, "counter",
             "Device diffusion steps actually run.")
        emit("repro_decode_steps_cap_total", caps, "counter",
             "Tau-schedule maximum steps for the same blocks.")
        emit("repro_decode_steps_saved_ratio",
             f"{1.0 - steps / caps if caps else 0.0:.6f}", "gauge",
             "Fraction of scheduled steps skipped by early exit.")
        emit("repro_decode_straggler_fill_total", ttel("straggler_fill"),
             "counter", "Tokens force-committed at schedule end.")
        emit("repro_decode_early_exits_total", ttel("early_exits"),
             "counter", "Rows that hit the early-exit test.")
        conf = [0] * len(tel[0]["conf_hist"]) if tel else []
        for t in tel:
            for i, c in enumerate(t["conf_hist"]):
                conf[i] += c
        out.append("# HELP repro_decode_confidence_total Committed-token"
                   " confidence histogram (equal buckets over [0,1]).")
        out.append("# TYPE repro_decode_confidence_total counter")
        for i, c in enumerate(conf):
            lo, hi = i / len(conf), (i + 1) / len(conf)
            out.append(f'repro_decode_confidence_total'
                       f'{{bucket="{lo:.1f}-{hi:.1f}"}} {c}')
        # accelerator memory (absent on CPU backends)
        mem = device_memory_stats()
        for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
            rows = [(dev, st[key]) for dev, st in sorted(mem.items())
                    if key in st]
            if rows:
                out.append(f"# HELP repro_device_{key} Device memory "
                           f"({key}) as reported by the runtime.")
                out.append(f"# TYPE repro_device_{key} gauge")
                for dev, v in rows:
                    out.append(f'repro_device_{key}{{device="{dev}"}} '
                               f"{int(v)}")
        if self.tracer is not None:
            emit("repro_trace_drops_total", self.tracer.dropped,
                 "counter", "Trace events evicted from full rings.")
        # shadow-audit counters (repro_torch.obs.audit) — emitted whenever
        # any engine carries an auditor
        auditors = [e.auditor for e in self.engines
                    if getattr(e, "auditor", None) is not None]
        if auditors:
            stats = [a.stats() for a in auditors]

            def atot(key):
                return sum(s[key] for s in stats)

            emit("repro_audit_sampled_total", atot("sampled"), "counter",
                 "Completions sampled for shadow re-decode.")
            emit("repro_audit_completed_total", atot("completed"),
                 "counter", "Shadow audits finished (all lanes).")
            emit("repro_audit_dropped_total", atot("dropped"), "counter",
                 "Audit jobs dropped at the bounded backlog.")
            emit("repro_audit_errors_total", atot("errors"), "counter",
                 "Audit attempts that failed internally (logged and "
                 "dropped).")
            emit("repro_audit_backlog", atot("backlog"), "gauge",
                 "Audit jobs queued or in flight.")
            emit("repro_audit_regret_total", atot("regret"), "counter",
                 "Early-exited requests whose shadow audit diverged "
                 "(the EOS that truncated the schedule was wrong).")
            out.append("# HELP repro_audit_divergences_total Token "
                       "divergences found by shadow audits, by source "
                       "(dkv-structural is the documented non-batch-"
                       "invariant contract, not a defect).")
            out.append("# TYPE repro_audit_divergences_total counter")
            from repro_torch.obs.audit import SOURCES
            for src in SOURCES:
                n = sum(s["divergences"].get(src, 0) for s in stats)
                out.append("repro_audit_divergences_total"
                           f'{{source="{src}"}} {n}')
            n_b = len(stats[0]["conf_agree"])
            for name, key, help_text in (
                    ("repro_audit_conf_agree_total", "conf_agree",
                     "Audited tokens agreeing with the oracle, by "
                     "commit-confidence bucket (Eq. 4 calibration)."),
                    ("repro_audit_conf_tokens_total", "conf_total",
                     "Audited tokens by commit-confidence bucket.")):
                out.append(f"# HELP {name} {help_text}")
                out.append(f"# TYPE {name} counter")
                for i in range(n_b):
                    lo, hi = i / n_b, (i + 1) / n_b
                    n = sum(s[key][i] for s in stats)
                    out.append(f'{name}{{bucket="{lo:.1f}-{hi:.1f}"}} {n}')
        # SLO watchdog gauges/counters (repro_slo_*)
        if self.watchdog is not None and self.watchdog.enabled:
            slo = self.watchdog.current()
            for fam, rows, mtype, help_text in (
                    ("repro_slo_target", slo["targets"], "gauge",
                     "Configured SLO target per objective."),
                    ("repro_slo_value", slo["values"], "gauge",
                     "Rolling-window observed value per objective."),
                    ("repro_slo_breached", slo["breached"], "gauge",
                     "1 while the objective is currently out of SLO."),
                    ("repro_slo_breaches_total", slo["breaches_total"],
                     "counter", "Breach onsets per objective.")):
                if not rows:
                    continue
                out.append(f"# HELP {fam} {help_text}")
                out.append(f"# TYPE {fam} {mtype}")
                for obj, v in sorted(rows.items()):
                    out.append(f'{fam}{{objective="{obj}"}} {v}')
        if self.flight is not None:
            emit("repro_flight_dumps_total", self.flight.dumps, "counter",
                 "Flight-recorder dumps written.")
            emit("repro_flight_suppressed_total", self.flight.suppressed,
                 "counter", "Flight dumps suppressed by debounce/cap.")
        # time-series recorder (repro_torch.obs.series) — emitted whenever
        # any loop carries a MetricsRecorder
        loops_all = getattr(self.loop, "loops", None) or [self.loop]
        recorders = [lp.recorder for lp in loops_all
                     if getattr(lp, "recorder", None) is not None]
        if recorders:
            rstats = [r.stats() for r in recorders]
            emit("repro_series_samples_total",
                 sum(s["samples"] for s in rstats), "counter",
                 "Time-series samples taken across engine recorders.")
            emit("repro_series_dropped_total",
                 sum(s["dropped"] for s in rstats), "counter",
                 "Samples evicted from full recorder rings.")
            emit("repro_series_errors_total",
                 sum(s["errors"] for s in rstats), "counter",
                 "Recorder samples that failed internally (logged and "
                 "dropped).")
            emit("repro_series_ring_bytes",
                 sum(s["ring_bytes"] for s in rstats), "gauge",
                 "Estimated bytes resident in recorder rings.")
            emit("repro_series_log_lines_total",
                 max(s["log_lines"] for s in rstats), "counter",
                 "JSONL lines written to --metrics-log (shared sink).")
        if len(self.engines) > 1:
            for name, key, mtype, help_text, fmt in (
                    ("requests_total", "requests", "counter",
                     "Completed requests per engine.", "{}"),
                    ("tokens_total", "tokens", "counter",
                     "Generated tokens per engine.", "{}"),
                    ("gang_merges_total", "gang_merges", "counter",
                     "Cross-gang merges per engine.", "{}"),
                    ("cache_hits_total", "prefix_cache_hits", "counter",
                     "Prefix-cache request hits per engine.", "{}"),
                    ("cache_hit_tokens_total", "prefix_cache_hit_tokens",
                     "counter", "Prefix-cache tokens reused per engine.",
                     "{}"),
                    ("cache_evictions_total", "prefix_cache_evictions",
                     "counter", "Prefix-cache evictions per engine.", "{}"),
                    ("cache_bytes", "prefix_cache_bytes", "gauge",
                     "Resident prefix-cache bytes per engine.", "{}"),
                    ("throughput_tok_per_s", "throughput_tok_s", "gauge",
                     "Tokens/s per engine.", "{:.6f}"),
                    ("mean_occupancy", "mean_occupancy", "gauge",
                     "Decode-slot occupancy per engine.", "{:.6f}"),
                    ("busy_seconds_total", "busy_time_s", "counter",
                     "Wall seconds with >=1 live decode row per engine.",
                     "{:.6f}"),
                    ("queue_wait_seconds_total", "queue_wait_s",
                     "counter", "Summed submit-to-admission wait per "
                     "engine.", "{:.6f}"),
                    ("steals_in_total", "steals_in", "counter",
                     "Requests adopted via work stealing per engine.",
                     "{}"),
                    ("steals_out_total", "steals_out", "counter",
                     "Requests given up via work stealing per engine.",
                     "{}"),
                    ("prefill_busy_seconds_total", "prefill_busy_s",
                     "counter", "Wall seconds in prefill passes per "
                     "engine.", "{:.6f}"),
                    ("decode_busy_seconds_total", "decode_busy_s",
                     "counter", "Wall seconds in decode_block calls per "
                     "engine.", "{:.6f}"),
                    ("handoffs_in_total", "handoffs_in", "counter",
                     "Requests adopted from the prefill pool per "
                     "engine.", "{}"),
                    ("handoffs_out_total", "handoffs_out", "counter",
                     "Primed requests handed to the decode pool per "
                     "engine.", "{}"),
                    ("compile_misses_total", "compile_misses", "counter",
                     "Jit variants compiled per engine.", "{}"),
                    ("post_warm_compiles_total", "post_warm_compiles",
                     "counter", "Post-pre-warm compiles per engine "
                     "(should stay 0).", "{}"),
                    ("host_threads", "host_threads", "gauge",
                     "Budgeted intra-op threads per engine.", "{}")):
                out.append(f"# HELP repro_engine_{name} {help_text}")
                out.append(f"# TYPE repro_engine_{name} {mtype}")
                for i, s in enumerate(snaps):
                    out.append(f'repro_engine_{name}{{engine="{i}"}} '
                               + fmt.format(s[key]))
            out.append("# HELP repro_engine_live_rows Live decode rows "
                       "per engine.")
            out.append("# TYPE repro_engine_live_rows gauge")
            for i, e in enumerate(self.engines):
                out.append(f'repro_engine_live_rows{{engine="{i}"}} '
                           f"{e.scheduler.live_rows}")
        return "\n".join(out) + "\n"


def _flight_state(loops, watchdog=None):
    """State-provider closure body for the flight recorder: everything
    a post-mortem needs, JSON-safe."""
    engines = []
    for lp in loops:
        e = lp.engine
        row = {"metrics": e.metrics.snapshot(),
               "telemetry": e.telemetry.totals()}
        if e.auditor is not None:
            row["audit"] = e.auditor.stats()
        engines.append(row)
    state = {"engines": engines,
             "schedulers": [lp.engine.scheduler.debug_state()
                            for lp in loops],
             "loops": [lp.debug_vars() for lp in loops]}
    if watchdog is not None:
        state["slo"] = watchdog.current()
    if any(getattr(lp, "recorder", None) is not None for lp in loops):
        # the breach window's time series rides along in the dump
        # (timeline.json) so a post-mortem sees the minutes *before*
        # the trigger, not just the instant of it
        from repro_torch.obs.series import timeline_doc
        state["timeline"] = timeline_doc(loops, watchdog=watchdog)
    return state


def _front(engines, max_pending: int, tracer=None, steal: bool = True,
           audit=None, watchdog=None, flight=None, roles=None,
           metrics_interval_s: float = 0.5, metrics_log=None):
    """One EngineLoop per engine; >1 engine routes through
    ``EngineRouter`` (least-loaded by live rows, block-boundary work
    stealing unless ``steal=False``). ``tracer`` claims a named track
    group per engine. ``audit`` (an ``AuditConfig``) attaches a
    ``ShadowAuditor`` per engine; ``watchdog``/``flight`` wire SLO
    observation and crash/breach dumps into every loop. ``roles`` (one
    entry per engine, ``"prefill"``/``"decode"``/``None``) builds a
    disaggregated fleet — the router partitions pools by loop role.
    Every loop gets a ``MetricsRecorder`` (``metrics_interval_s`` <= 0
    disables); ``metrics_log`` additionally persists each sample as a
    JSONL line through one shared sink."""
    engines = engines if isinstance(engines, (list, tuple)) else [engines]
    loops = [EngineLoop(e, max_pending=max_pending, tracer=tracer,
                        index=i, role=roles[i] if roles else None)
             for i, e in enumerate(engines)]
    if audit is not None:
        from repro_torch.obs.audit import ShadowAuditor
        for e in engines:
            e.attach_auditor(ShadowAuditor(e, audit, tracer=tracer,
                                           flight=flight))
    sink = None
    if metrics_log and metrics_interval_s > 0:
        from repro_torch.obs.series import JsonlSink
        sink = JsonlSink(metrics_log)
    for lp in loops:
        lp.watchdog = watchdog
        lp.flight = flight
        if metrics_interval_s > 0:
            from repro_torch.obs.series import MetricsRecorder
            lp.recorder = MetricsRecorder(
                lp.engine, index=lp.index, role=lp.role,
                interval_s=metrics_interval_s, sink=sink,
                watchdog=watchdog, loop=lp)
    if flight is not None and flight.state_provider is None:
        flight.state_provider = lambda: _flight_state(loops, watchdog)
    if len(loops) == 1:
        return loops[0]
    from repro_torch.server.router import EngineRouter
    return EngineRouter(loops, steal=steal)


async def serve(engine, host: str = "127.0.0.1", port: int = 8000,
                max_pending: int = 64, tracer=None, steal: bool = True,
                audit=None, watchdog=None, flight=None, roles=None,
                metrics_interval_s: float = 0.5,
                metrics_log=None, until=None) -> None:
    """Run the HTTP front end until cancelled, then drain gracefully.
    ``engine`` may be one ``ContinuousEngine`` or a list (one per
    device/mesh; requests are routed least-loaded and rebalanced by
    work stealing unless ``steal=False``). ``audit``/``watchdog``/
    ``flight`` enable the repro_torch.obs.audit layer; ``roles`` builds
    disaggregated prefill/decode pools (see ``_front``);
    ``metrics_interval_s``/``metrics_log`` configure the per-engine
    time-series recorders behind /debug/timeline and /console.
    ``until``: an async callable given the started ``HttpFrontend``;
    the front end drains when it returns (in-process clients)."""
    if watchdog is not None and flight is not None \
            and watchdog.flight is None:
        watchdog.flight = flight
    frontend = HttpFrontend(
        _front(engine, max_pending, tracer, steal, audit=audit,
               watchdog=watchdog, flight=flight, roles=roles,
               metrics_interval_s=metrics_interval_s,
               metrics_log=metrics_log),
        host=host, port=port, tracer=tracer, flight=flight,
        watchdog=watchdog)
    await frontend.start()
    log.info("repro_torch.server listening on http://%s:%s (POST "
             "/v1/completions, GET /healthz, GET /metrics, GET "
             "/debug/vars, GET /debug/flight, GET /debug/timeline, "
             "GET /console; engines=%d)",
             frontend.host, frontend.port, len(frontend.engines))
    try:
        if until is None:
            await frontend.serve_forever()
        else:
            await until(frontend)
    except asyncio.CancelledError:
        pass
    finally:
        await frontend.shutdown(drain=True)


def run(engine, host: str = "127.0.0.1", port: int = 8000,
        max_pending: int = 64, tracer=None, steal: bool = True,
        audit=None, watchdog=None, flight=None, roles=None,
        metrics_interval_s: float = 0.5, metrics_log=None,
        until=None) -> None:
    """Blocking entry point used by ``repro.launch.serve --http``."""
    try:
        asyncio.run(serve(engine, host, port, max_pending, tracer=tracer,
                          steal=steal, audit=audit, watchdog=watchdog,
                          flight=flight, roles=roles,
                          metrics_interval_s=metrics_interval_s,
                          metrics_log=metrics_log, until=until))
    except KeyboardInterrupt:
        pass
