"""Block-wise diffusion decoding — the PyTorch counterpart of
``repro.core.decoder``.

Five methods (paper Tables 1/2/8):

  vanilla   — no cache; full-sequence forward each denoise step; fixed
              schedule (top-`K/M` most-confident masked tokens per step).
  dkv       — delayed KV cache (Ma et al. 2025): a token's K/V is frozen
              into a position-indexed cache one step after it decodes;
              masked tokens recompute theirs each step. Vanilla schedule.
  prefix    — Fast-dLLM's prefix cache: prompt + finished blocks cached;
              the block + FULL suffix recomputed each step. Vanilla
              schedule.
  fast      — Fast-dLLM: prefix cache + fixed-threshold tau0 parallel
              commit (argmax fallback guarantees progress).
  streaming — prefix cache + attenuation-guided suffix pruning (window
              w + trailing position token) + dynamic threshold tau(t)
              (Eq. 10) + EOS early exit.

``frozen_suffix`` (parallel methods) freezes the pruned-suffix KV at the
block refresh and lets the steps query only the block. ``prefix_cache``
(``repro_torch.cache``) computes the prompt KV once at prefill by
chunk-causal passes, shareable across requests through a
``PrefixKVCache`` store, and the block refreshes then rewrite only the
generated region (a *tail* refresh).

Placement across ranks (``executor``, a ``serving.DecodeExecutor``): the
decoder runs the executor's shard of the params on this rank's rows of
each gang (all of them where the gang does not split over the data
axes), and its host arrays keep every row, the same on every rank of the
mesh. The loop condition is a maximum over the data line, so every rank
runs the same steps; the block's outputs come back in one gather over
the data line, then the block's one host sync (the host loop gathers
each step's confidences the same way). On the card the graph loop
captures those collectives with the block, so it takes NCCL groups; a
gloo mesh on the card runs the host loop (``fused=False``), and the
decoder refuses the graph loop there rather than take the host loop
quietly.

Two loops per block, as in the JAX package:

  device loop (``fused=True``, the default) — the semantics of the JAX
      package's ``_fused_fn``. The block is a program over static device
      buffers (``_BlockBuffers``): a prologue (counters reset, block
      refresh, loop condition), one step body (a denoise step, then the
      loop condition ``pred`` again) and an epilogue (straggler
      finalize, EOS early exit). Step counter, commit counts, histogram,
      commit confidences, the dkv valid-size trace, fill and hit counts
      all live on the device. On the card the program is one CUDA graph
      per (B, T, Sq, block start) (``core.graph_loop``): the bodies sit
      in ``steps_cap - 1`` conditional IF nodes (``steps_cap`` for vanilla
      and dkv, which have no refresh) gated by ``pred``, so a block is one
      copy in, one replay and one fetch: one host sync. On the CPU the
      same body runs under ``if bool(pred)``, a host tensor, so the
      count is the same there.
  host loop (``fused=False``) — the validation oracle: every step
      fetches (conf, toks) (parallel methods) or the (B, K, V) block
      logits (fixed-schedule methods) and selection, the Eq. 10
      threshold, the commit, the tally, the straggler fill and early exit
      run on the host. Never the default and never a fallback.

Cache binding rule (the graphs bake in buffer addresses): the decoder owns
one KV buffer per (B, T), the *bound* buffer, and every graph of that
shape reads and writes it. For every method but dkv the block refresh
rewrites every cache slot the steps read, so ``prefill`` hands each state
the bound buffer, and a state whose cache is another buffer (a deep copy)
or none (a parked ``take_rows(alloc_cache=False)`` state) adopts the
bound one at its next block; ``take_rows``/``merge_rows`` gather no KV
for them. A dkv cache carries state across blocks, so a dkv state owns
its buffer (``take_rows`` gathers its rows into a new one): the device
loop copies it into the bound buffer before the replay and back after.
A prefix-cached state's prompt KV is likewise never rewritten by a
refresh, so it owns its buffer too and takes the same copies. No state
ever replays a graph on a buffer other than the one that holds its
cache.

On the card, attention, the confidence and (through ``ops.linear``)
every product of the model run through the kernels
(``use_kernels=True``); a CUDA decoder without them raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import graph_loop
from repro_torch.core import schedule as sched
from repro_torch.core.suffix import suffix_query_region
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ATTN, ATTN_LOCAL, ModelConfig
from repro_torch.models.model import (apply_model, cache_map,
                                      cache_take_rows, init_cache,
                                      serving_layout)
from repro_torch.obs.telemetry import CONF_BUCKETS, BlockStats

METHODS = ("vanilla", "dkv", "prefix", "fast", "streaming")


def round_up_blocks(max_tokens: int, block_size: int) -> int:
    """Generation-length bucket for a request: next block multiple."""
    return -(-max_tokens // block_size) * block_size


def eos_truncate(gen: np.ndarray, eos_id: int):
    """Canonical EOS policy for a generated row: the first EOS ends the
    output and the tail is EOS-filled. Returns ``(tokens, n_generated)``."""
    eos_pos = np.where(gen == eos_id)[0]
    n = int(eos_pos[0]) if len(eos_pos) else len(gen)
    if len(eos_pos):
        gen = gen.copy()
        gen[eos_pos[0]:] = eos_id
    return gen, n


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    method: str = "streaming"
    gen_len: int = 256
    block_size: int = 32
    steps_per_block: int = 0       # 0 -> block_size (one token per step)
    tau0: float = 0.9              # base confidence threshold
    alpha: float = 0.3             # Eq. 10 adaptation strength
    window: int = 96               # suffix tokens kept (streaming); -1=full
    trailing_position: bool = True
    early_exit: bool = True
    use_kernels: bool = True       # attention/confidence through the kernels
                                   # (their plain versions on CPU tensors);
                                   # False is the CPU tests' plain route
    fused: bool = True             # device loop (one host sync per block);
                                   # False = the host loop (per-step syncs)
    frozen_suffix: bool = False    # parallel methods: freeze the suffix KV
                                   # at the refresh; steps query the block
    # Cross-request prefix KV reuse (repro_torch.cache): the prompt KV is
    # computed once at prefill by chunk-causal passes (chunk i attends to
    # chunks 0..i only, bidirectionally within the chunk), so each chunk's
    # KV is content-addressable and shareable across requests; block
    # refreshes then rewrite only the generated region and attend to the
    # frozen prompt KV. Cached and cold prefill are bit-identical.
    prefix_cache: bool = False
    cache_chunk: int = 16          # prompt chunk size for repro_torch.cache

    def __post_init__(self):
        assert self.method in METHODS, self.method
        assert self.gen_len % self.block_size == 0
        assert self.cache_chunk > 0
        # the frozen-suffix refresh writes position-indexed over the whole
        # buffer with nothing cached-valid; a frozen prompt region would
        # need a third refresh variant (as in the JAX package)
        assert not (self.prefix_cache and self.frozen_suffix), \
            "prefix_cache and frozen_suffix are mutually exclusive"

    @property
    def effective_window(self) -> int:
        if self.method == "streaming":
            return self.window
        return -1                   # baselines see the full suffix

    @property
    def parallel(self) -> bool:
        return self.method in ("fast", "streaming")

    @property
    def frozen(self) -> bool:
        return self.frozen_suffix and self.parallel

    @property
    def has_refresh(self) -> bool:
        return self.method not in ("vanilla", "dkv")


@dataclasses.dataclass
class DecodeState:
    """Resumable decode progress for a batch of rows that all sit at the
    same block boundary. Produced by ``DiffusionDecoder.prefill`` and
    advanced one block at a time by ``decode_block``. Token buffers are
    host numpy arrays between blocks; ``cache`` lives on the device."""
    x: np.ndarray                     # (B, T) tokens; mask id where open
    committed: np.ndarray             # (B, T) bool
    done: np.ndarray                  # (B,) early-exited rows
    prompt_len: int
    n_blocks: int
    block_idx: int = 0                # next block to decode
    cache: Any = None
    valid_mask: Optional[np.ndarray] = None    # dkv only: (B, T) bool
    cached_mask: Optional[np.ndarray] = None   # dkv only: (B, T) bool
    prefix_hit_tokens: Optional[np.ndarray] = None  # prefix_cache: (B,)
    nfe: int = 0
    q_tokens: int = 0
    kv_tokens: int = 0
    steps_per_block: list = dataclasses.field(default_factory=list)
    early_exits: int = 0
    host_syncs: int = 0               # blocking device->host fetch points
    logit_syncs: int = 0              # of those, full (B, K, V) logit copies
    prefill_time: float = 0.0
    decode_time: float = 0.0
    block_stats: list = dataclasses.field(default_factory=list)

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def total_len(self) -> int:
        return self.x.shape[1]

    @property
    def finished(self) -> bool:
        return self.block_idx >= self.n_blocks or bool(self.done.all())

    def row_finished(self, b: int) -> bool:
        return bool(self.done[b]) or self.block_idx >= self.n_blocks


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray             # (B, gen_len) committed tokens
    nfe: int                       # model forward evaluations
    steps_per_block: list
    wall_time: float
    query_tokens_processed: int    # sum of query lengths over all NFEs
    kv_tokens_attended: int        # sum of (kv length * query len) proxy
    tokens_generated: int          # non-EOS tokens (paper's TPS metric)
    early_exits: int
    prefill_time: float = 0.0
    host_syncs: int = 0
    logit_syncs: int = 0
    block_stats: list = dataclasses.field(default_factory=list)

    @property
    def tokens_per_nfe(self) -> float:
        return self.tokens_generated / max(self.nfe, 1)


class _BlockBuffers:
    """The static buffers of one (B, T): the block's inputs (tokens,
    commit mask, done rows, dkv masks), its device-side outputs, the
    loop condition and the bound KV buffer. On the card, host mirrors in
    pinned memory carry the copy in and the one fetch out."""

    INPUTS = ("x", "committed", "done", "valid_mask", "cached_mask")
    OUTPUTS = INPUTS + ("step", "counts", "hist", "cconf", "vsums",
                        "fill_n", "n_hit")

    def __init__(self, dec: "DiffusionDecoder", batch: int, T: int):
        d, dev = dec.dcfg, dec.device
        K, cap = d.block_size, dec.steps_cap
        B = dec._local(batch)                 # this rank's rows
        i32, f32, b8 = torch.int32, torch.float32, torch.bool

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.x, self.committed = z((B, T), i32), z((B, T), b8)
        self.done = z((B,), b8)
        self.valid_mask, self.cached_mask = z((B, T), b8), z((B, T), b8)
        self.fvalid = z((B, T), b8)           # frozen_suffix's key validity
        self.step, self.pred = z((), i32), z((), b8)
        self.counts, self.vsums = z((cap,), i32), z((cap,), i32)
        self.hist = z((CONF_BUCKETS,), i32)
        self.cconf, self.lconf = z((B, K), f32), z((B, K), f32)
        self.toks = z((B, K), i32)
        self.fill_n, self.n_hit = z((), i32), z((), i32)
        self.cache = None if d.method == "vanilla" else dec._new_cache(
            batch, T)
        self.pinned = dev.type == "cuda"
        self.host = {n: torch.empty(getattr(self, n).shape,
                                    dtype=getattr(self, n).dtype,
                                    pin_memory=self.pinned)
                     for n in self.OUTPUTS}
        # the KV is state carried across blocks for dkv and prefix-cached
        # states; the masks for dkv only
        self.carries = dec.cache_carries_state
        self.masks = d.method == "dkv"

    def load(self, state: DecodeState, rows: slice) -> None:
        """Copy a state's host arrays (its ``rows``: this rank's) in
        (asynchronously from pinned memory on the card) and, for a state
        that owns its buffer (dkv, prefix cache), its KV into the bound
        buffer."""
        names = self.INPUTS if self.masks else self.INPUTS[:3]
        for n in names:
            src = self.host[n]
            src.numpy()[...] = getattr(state, n)[rows]
            getattr(self, n).copy_(src, non_blocking=self.pinned)
        if self.carries and state.cache is not self.cache:
            cache_map(lambda b, s: b.copy_(s), self.cache, state.cache)

    def fetch(self, state: DecodeState, executor=None
              ) -> Dict[str, np.ndarray]:
        """The block's one fetch: every output to host memory, then a
        single wait (the only one of the block on the card). A state that
        owns its buffer gets its cache copied back out of the bound
        buffer first. With an executor the outputs come through its one
        gather over the data line (``gather_block``)."""
        if self.carries and state.cache is not self.cache:
            cache_map(lambda b, s: s.copy_(b), self.cache, state.cache)
        names = self.OUTPUTS if self.masks else tuple(
            n for n in self.OUTPUTS if n not in ("valid_mask", "cached_mask"))
        if executor is not None:
            return executor.gather_block(
                {n: getattr(self, n) for n in names}, state.batch,
                row_keys=self.INPUTS + ("cconf",),
                sum_keys=("counts", "hist", "vsums", "fill_n", "n_hit"))
        for n in names:
            self.host[n].copy_(getattr(self, n), non_blocking=self.pinned)
        if self.pinned:
            torch.cuda.current_stream(self.x.device).synchronize()
        return {n: self.host[n].numpy().copy() for n in names}


class _BlockProgram:
    """One block's device program for a fixed (B, T, Sq, block start):
    prologue, step body, epilogue over a ``_BlockBuffers``; on the card
    also its captured graph. The body is the JAX package's while-loop
    body (``decoder.py:_fused_fn``), line for line."""

    def __init__(self, dec: "DiffusionDecoder", bufs: _BlockBuffers,
                 qpos: np.ndarray, bstart: int):
        d, dev = dec.dcfg, dec.device
        B, T = bufs.x.shape
        K = d.block_size
        self.dec, self.b = dec, bufs
        self.B, self.K = B, K
        self.bstart = bstart
        self.blk = slice(bstart, bstart + K)
        self.qpos_b = dec._upload(np.broadcast_to(qpos[None], (B, len(qpos)))
                                  .astype(np.int32))
        self.valid_len = torch.full((B,), bstart, dtype=torch.int32,
                                    device=dev)
        # prefix cache: the refresh starts at the prompt boundary (the
        # prompt KV was computed at prefill and is attended, never
        # recomputed)
        self.pstart = T - d.gen_len if d.prefix_cache else 0
        self.pstart_valid = torch.full((B,), self.pstart, dtype=torch.int32,
                                       device=dev)
        arange = torch.arange(T, dtype=torch.int32, device=dev)
        self.pos_T = arange[None].expand(B, T)
        self.prefix_pos = arange[None, self.pstart:bstart].expand(
            B, bstart - self.pstart)
        self.prefix_valid = (arange < bstart)[None].expand(B, T)
        self.bpos = (bstart + torch.arange(K, dtype=torch.int32, device=dev)
                     )[None].expand(B, K)
        self.n_iter = dec.steps_cap - 1 if d.has_refresh else dec.steps_cap
        self.graph = None

    # -------------------------------------------------- pieces of a step

    def _model(self, toks, pos, mode, **kw):
        dec = self.dec
        return apply_model(dec.cfg, dec.params, tokens=toks, positions=pos,
                           mode=mode, use_kernels=dec.dcfg.use_kernels,
                           mesh=dec.mesh, **kw)

    def _conf_toks(self, out):
        if self.dec.dcfg.parallel:
            return self.dec._conf_from_hidden(out)
        return self.dec._conf_from_logits(out)

    def _commit(self, conf, toks) -> None:
        """Eq. 9 / fixed-rate selection, token write and tally for the
        step on the device counter (all rows select; only the loop
        condition and the tally exclude early-exited rows)."""
        d, b, blk = self.dec.dcfg, self.b, self.blk
        blk_committed = b.committed[:, blk]
        blk_masked = ~blk_committed
        if d.parallel:
            if d.method == "streaming":
                r_mask = blk_masked.float().mean(dim=1)
                tau = sched.dynamic_threshold(d.tau0, d.alpha, r_mask)
            else:
                tau = torch.full((self.B,), d.tau0, dtype=torch.float32,
                                 device=conf.device)
            commit = sched.select_tokens(conf, blk_masked, tau)
        else:
            commit = sched.fixed_rate_select(conf, blk_masked,
                                             self.dec.n_commit)
        b.x[:, blk] = torch.where(commit, toks, b.x[:, blk])
        b.committed[:, blk] = blk_committed | commit
        act = (commit & ~b.done[:, None]).to(torch.int32)
        step = b.step.long().reshape(1)
        b.counts.index_add_(0, step, act.sum().to(torch.int32).reshape(1))
        b_idx = (conf * CONF_BUCKETS).to(torch.int32).clamp(
            0, CONF_BUCKETS - 1)
        b.hist.index_add_(0, b_idx.reshape(-1).long(), act.reshape(-1))
        b.cconf.copy_(torch.where(commit, conf, b.cconf))
        b.lconf.copy_(conf)
        b.toks.copy_(toks)
        b.step.add_(1)

    def _open(self) -> None:
        """The loop condition, written to ``pred`` on the device: across
        ranks, whether a row of any rank's is open (a maximum over the
        data line), so every rank runs the same steps."""
        b = self.b
        open_rows = (~b.committed[:, self.blk]) & ~b.done[:, None]
        any_open = open_rows.any()
        ex = self.dec.executor
        if ex is not None and ex.data.active:
            any_open = ex.data.all_reduce(any_open.to(torch.int32).reshape(1),
                                          op=dist.ReduceOp.MAX)[0] > 0
        b.pred.copy_((b.step < self.dec.steps_cap) & any_open)

    # ---------------------------------------------------- the program

    def prologue(self) -> None:
        d, b = self.dec.dcfg, self.b
        for t in (b.step, b.counts, b.hist, b.cconf, b.lconf, b.toks,
                  b.vsums, b.fill_n, b.n_hit):
            t.zero_()
        if d.has_refresh:
            self._refresh()
        self._open()

    def _refresh(self) -> None:
        """Block-start refresh (paper §3.3): one pass over [prefix ||
        query region] that produces the block's confidences and rewrites
        the cache (with frozen_suffix position-indexed, suffix included;
        with the prefix cache over [generated prefix || query region]
        only, appended after the prompt KV)."""
        d, b, K = self.dec.dcfg, self.b, self.K
        prefix_len = self.bstart
        full_pos = torch.cat([self.prefix_pos, self.qpos_b], dim=1)
        full_toks = torch.gather(b.x, 1, full_pos.long())
        if d.prefix_cache:
            out = self._model(full_toks, full_pos, "append", cache=b.cache,
                              kv_valid=self.pstart_valid,
                              skip_head=d.parallel)
        elif d.frozen:
            out = self._model(full_toks, full_pos, "append", cache=b.cache,
                              kv_valid=torch.zeros((self.B,), dtype=torch.int32,
                                                   device=b.x.device),
                              append_at=full_pos, cache_upto=prefix_len,
                              skip_head=True)
            b.fvalid.copy_(self.prefix_valid)
            b.fvalid.scatter_(1, self.qpos_b[:, K:].long(), True)
        else:
            out = self._model(full_toks, full_pos, "encode", cache=b.cache,
                              cache_upto=prefix_len, skip_head=d.parallel)
        boff = prefix_len - self.pstart
        self._commit(*self._conf_toks(out.logits[:, boff:boff + K]))

    def body(self) -> None:
        """One denoise step, then the loop condition."""
        d, b, K = self.dec.dcfg, self.b, self.K
        if d.method == "vanilla":
            out = self._model(b.x, self.pos_T, "encode")
            conf, toks = self.dec._conf_from_logits(out.logits[:, self.blk])
        elif d.method == "dkv":
            q_toks = torch.gather(b.x, 1, self.qpos_b.long())
            mix = torch.gather(b.cached_mask, 1, self.qpos_b.long())
            out = self._model(q_toks, self.qpos_b, "append", cache=b.cache,
                              kv_valid=b.valid_mask, append_at=self.qpos_b,
                              self_kv_mix=mix)
            conf, toks = self.dec._conf_from_logits(out.logits[:, :K])
            # tokens committed earlier (whose fresh KV this step was
            # decoded-input based) are now frozen
            newly = b.committed & ~b.cached_mask
            b.cached_mask |= newly
            b.valid_mask |= newly
            b.vsums.index_copy_(0, b.step.long().reshape(1),
                                b.valid_mask.sum().to(torch.int32)
                                .reshape(1))
        elif d.frozen:
            out = self._model(b.x[:, self.blk], self.bpos, "step",
                              cache=b.cache, kv_valid=b.fvalid,
                              skip_head=True)
            conf, toks = self._conf_toks(out.logits)
        else:
            q_toks = torch.gather(b.x, 1, self.qpos_b.long())
            out = self._model(q_toks, self.qpos_b, "step", cache=b.cache,
                              kv_valid=self.valid_len, skip_head=d.parallel)
            conf, toks = self._conf_toks(out.logits[:, :K])
        self._commit(conf, toks)
        self._open()

    def epilogue(self) -> None:
        """Straggler finalize (steps cap reached): commit the last step's
        argmax, but never over rows that early-exited in a prior block
        (their tail is EOS-truncated territory); then early exit."""
        d, b, blk = self.dec.dcfg, self.b, self.blk
        live = ~b.done[:, None]
        fill = (~b.committed[:, blk]) & live & (b.step > 0)
        b.fill_n.copy_(fill.sum())
        b.cconf.copy_(torch.where(fill, b.lconf, b.cconf))
        blk_x = torch.where(fill, b.toks, b.x[:, blk])
        b.x[:, blk] = blk_x
        b.committed[:, blk] = True
        # Early exit (paper §3.3): a block that decoded an EOS makes all
        # *subsequent* blocks skippable for that row.
        if d.early_exit:
            hit = (blk_x == self.dec.cfg.eos_token_id).any(dim=1) & ~b.done
            b.n_hit.copy_(hit.sum())
            b.done |= hit

    def run(self) -> None:
        """Run the block: replay the graph on the card, or run the same
        parts with the loop condition read from a host tensor."""
        if self.graph is not None:
            self.graph.replay()
            return
        self.prologue()
        for _ in range(self.n_iter):
            if not bool(self.b.pred):
                break
            self.body()
        self.epilogue()


class DiffusionDecoder:
    """Block diffusion decoder over device tensors. Runs on ``device``
    (cuda unless named); ``params`` must already live there."""

    def __init__(self, cfg: ModelConfig, params, dcfg: DecodeConfig,
                 device=None, executor=None, prompt_cache=None):
        if dcfg.prefix_cache:
            assert all(s.mixer in (ATTN, ATTN_LOCAL) for s in cfg.layout), \
                ("prefix_cache needs an attention-only layout (recurrent "
                 "states have no chunkable time axis)")
            if prompt_cache is not None:
                assert prompt_cache.chunk_tokens == dcfg.cache_chunk, \
                    (prompt_cache.chunk_tokens, dcfg.cache_chunk)
        # the cross-request chunk store (repro_torch.cache.PrefixKVCache).
        # May be None in prefix_cache mode: the chunk-aligned prefill and
        # the tail refresh still run, but nothing is shared across requests
        self.prompt_cache = prompt_cache
        self.executor = executor
        self.mesh = None
        if executor is not None:
            # the placement layer owns the placed params and the mesh; a
            # decoder bound to an executor never touches raw params
            if device is not None and torch.device(device) != \
                    executor.device:
                raise ValueError(f"device {device} but the executor places "
                                 f"on {executor.device}")
            device = executor.device
            params = executor.params
            self.mesh = executor.mesh
            gloo = [g.backend for g in (executor.data, executor.model)
                    if g.active and g.backend != "nccl"]
            if dcfg.fused and executor.device.type == "cuda" and gloo:
                raise ValueError(
                    "the graph loop captures the block's collectives, which "
                    f"needs NCCL groups (this mesh's: {gloo[0]}); run a "
                    "gloo mesh on the card with DecodeConfig(fused=False)")
            executor.attach(self)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and not dcfg.use_kernels:
            raise ValueError(
                "on CUDA the decoder runs attention and confidence through "
                "the kernels: set DecodeConfig(use_kernels=True)")
        self.cfg = cfg
        self.dcfg = dcfg
        self.params = params
        # the tied head and the recurrent mixers' weights: built here, once
        self.head = serving_layout(cfg, params)
        # a vocabulary-sharded head's logits are gathered into whole rows
        # over the model line before the confidence (ROADMAP B 2 would
        # reduce over the shards instead)
        self._head_gather = None
        if executor is not None and self.head.shape[1] < cfg.vocab_size:
            model = executor.model
            self._head_gather = lambda t: model.all_gather(t, -1)
        self.steps_cap = dcfg.steps_per_block or dcfg.block_size
        self.n_commit = max(1, dcfg.block_size // self.steps_cap)
        self._buffers: Dict[tuple, _BlockBuffers] = {}
        self._programs: Dict[tuple, _BlockProgram] = {}
        self._pool = None
        self.capture_time = 0.0      # seconds spent warming up + capturing

    # ------------------------------------------------------ shared pieces

    def _conf_from_hidden(self, h_blk):
        """Fused head path (parallel methods): hidden (B, K, d) ->
        (conf (B, K), toks (B, K)) without a monolithic (B, K, V)
        logits array. Kernel route when use_kernels."""
        cfg = self.cfg
        fn = kops.head_confidence_argmax if self.dcfg.use_kernels \
            else sched.head_confidence_and_tokens
        return fn(h_blk, self.head, mask_id=cfg.mask_token_id,
                  logit_softcap=cfg.logit_softcap, gather=self._head_gather)

    def _conf_from_logits(self, blk_logits):
        """Full-vocab path (fixed-schedule methods): ban [MASK], Eq. 4.
        Through the confidence kernel when use_kernels (its plain version
        on the CPU, the same operations as below), so that on the card a
        row's confidence does not depend on how many rows are reduced."""
        if self.dcfg.use_kernels:
            return kops.confidence_argmax(blk_logits,
                                          mask_id=self.cfg.mask_token_id)
        blk = blk_logits.float().clone()
        blk[..., self.cfg.mask_token_id] = -1e30
        return sched.confidence_and_tokens(blk)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host -> device copy (never aliases the host array)."""
        return torch.tensor(np.ascontiguousarray(arr), device=self.device)

    def _rows(self, batch: int) -> slice:
        """This rank's rows of a gang of ``batch`` (every row without an
        executor)."""
        if self.executor is None:
            return slice(0, batch)
        return self.executor.rows(batch)

    def _local(self, batch: int) -> int:
        r = self._rows(batch)
        return r.stop - r.start

    def _new_cache(self, batch: int, total_len: int):
        """An empty cache for a gang of ``batch``: this rank's shard."""
        if self.executor is not None:
            return self.executor.init_cache(batch, total_len)
        return init_cache(self.cfg, batch, total_len, self.device)

    def _host_rows(self, t: torch.Tensor, batch: int) -> torch.Tensor:
        """Every row of a per-row device result, on the host."""
        if self.executor is not None:
            t = self.executor.gather_rows(t, batch)
        return t.cpu()

    def _full_cache(self, cache, batch: int):
        """Every row of a gang's cache (across ranks, gathered over the
        data line from this rank's rows)."""
        if self.executor is None:
            return cache
        return self.executor.gather_cache(cache, batch)

    def _local_cache(self, full, batch: int):
        """This rank's rows of a cache that holds every row of a gang."""
        if self.executor is None:
            return full
        return self.executor.local_cache(full, batch)

    def _take_cache(self, cache, batch: int, rows):
        """A new cache of ``rows`` of a gang of ``batch`` (a copy, of this
        rank's rows of the new gang)."""
        return self._local_cache(cache_take_rows(
            self._full_cache(cache, batch), rows), len(rows))

    # ------------------------------------------------------ resumable API

    @property
    def batch_invariant(self) -> bool:
        """True when per-row outputs do not depend on the batch size:
        for every method except dkv, whose step-level KV freezing
        accumulates ulp-level drift under batch reshaping (as in the JAX
        package). On the card it rests on the kernels: the GEMM's sum
        order depends on (N, K) only (``kernels/gemm.py``), the
        confidence kernel's split count on (V, dtype) only, and the
        attention kernel sums each row alone."""
        return self.dcfg.method != "dkv"

    @property
    def cache_carries_state(self) -> bool:
        """True when the KV buffer holds state a block refresh does not
        rewrite: dkv's position-indexed cache (with its masks), or the
        prefix-cached prompt region. Such a state owns its buffer
        (compaction and merges gather its rows); any other shares the
        bound one."""
        return self.dcfg.method == "dkv" or (
            self.dcfg.prefix_cache and self.dcfg.method != "vanilla")

    def graph_cache_size(self) -> int:
        """Block programs built so far, one per (B, T, Sq, block start):
        on the card, the number of captured CUDA graphs. A second
        generation at the same shapes adds none."""
        return len(self._programs)

    def _block_buffers(self, B: int, T: int) -> _BlockBuffers:
        """The static buffers of a gang of (B, T), at this rank's rows."""
        if (B, T) not in self._buffers:
            self._buffers[(B, T)] = _BlockBuffers(self, B, T)
        return self._buffers[(B, T)]

    def _bound_cache(self, B: int, T: int):
        """The bound KV buffer of (B, T) (None for vanilla, which has no
        cache)."""
        if self.dcfg.method == "vanilla":
            return None
        return self._block_buffers(B, T).cache

    def _no_cache_arg(self, cache, what: str) -> None:
        if cache is not None and not self.cache_carries_state:
            raise ValueError(
                f"{what}: {self.dcfg.method} states run on the decoder's "
                "bound KV buffer and take no buffer of their own")

    def prefill(self, prompt: np.ndarray, cache=None) -> DecodeState:
        """Admit a batch of prompts. The returned state sits at block 0
        ready for ``decode_block``; its cache is the bound buffer of its
        shape, except for a state that owns its buffer (``cache``, a
        pool's, or a new one): dkv fills it by one full-sequence pass
        (only the prompt KV is valid), the prefix cache by the
        chunk-aligned prompt prefill (``prime_prompt_kv``)."""
        self._no_cache_arg(cache, "prefill")
        cfg, d = self.cfg, self.dcfg
        B, P = prompt.shape
        T = P + d.gen_len
        x = np.full((B, T), cfg.mask_token_id, np.int32)
        x[:, :P] = prompt
        committed = np.zeros((B, T), bool)
        committed[:, :P] = True
        state = DecodeState(x=x, committed=committed,
                            done=np.zeros((B,), bool), prompt_len=P,
                            n_blocks=d.gen_len // d.block_size)
        if d.method == "vanilla":
            return state
        if not self.cache_carries_state:
            state.cache = self._bound_cache(B, T)
            return state
        state.cache = cache if cache is not None else self._new_cache(B, T)
        if self.executor is not None:
            self.executor.constrain_cache(state.cache, B, T)
        if d.prefix_cache:
            # dkv rides the same path: its masks mark the prompt valid and
            # frozen exactly as the full-sequence prefill would, but the
            # masked region's pass is skipped (those KV were never valid)
            self.prime_prompt_kv(state)
            if d.method == "dkv":
                state.valid_mask = np.zeros((B, T), bool)
                state.valid_mask[:, :P] = True
                state.cached_mask = state.valid_mask.copy()
            return state
        tp0 = time.perf_counter()
        pos = torch.arange(T, dtype=torch.int32, device=self.device)[None]
        loc = self._rows(B)
        with torch.no_grad():
            apply_model(cfg, self.params, tokens=self._upload(x[loc]),
                        positions=pos.expand(self._local(B), T),
                        mode="encode", cache=state.cache, skip_head=True,
                        use_kernels=d.use_kernels, mesh=self.mesh)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        state.prefill_time = time.perf_counter() - tp0
        state.nfe += 1
        state.host_syncs += 1
        state.q_tokens += B * T
        state.kv_tokens += B * T * T
        state.valid_mask = np.zeros((B, T), bool)
        state.valid_mask[:, :P] = True
        state.cached_mask = state.valid_mask.copy()
        return state

    def prime_prompt_kv(self, state: DecodeState) -> DecodeState:
        """Prefix-cache prompt prefill (the chunk-aligned path): look up
        the longest cached prefix per row, copy its KV into the state's
        buffer, run the model only over the uncached chunks plus the
        unaligned remainder, and publish the freshly computed chunks back
        to the store. Also the re-prime of a resumed (preempted) state,
        whose parked state dropped its KV: its own chunks are usually
        still in the store, so a resume costs O(tail).

        Exactness: an assembled chunk carries the bytes its original
        prefill pass wrote, and a computed chunk sees only [assembled
        prefix || its own tokens], so cached and cold prefill are
        bit-identical by construction. Rows with a deeper hit than the
        gang's common depth get their extra chunks recomputed in-batch,
        bit-equal to the stored ones because the decoder is
        batch-invariant (on the card: ``kernels/gemm.py``)."""
        from repro_torch.cache import slicing
        d = self.dcfg
        assert d.prefix_cache and d.method != "vanilla"
        assert state.cache is not None
        B, P = state.batch, state.prompt_len
        C = d.cache_chunk
        n_chunks = P // C
        store = self.prompt_cache
        tp0 = time.perf_counter()
        hits: list = [[] for _ in range(B)]
        if store is not None and n_chunks:
            hits = [store.match(state.x[b, :P]) for b in range(B)]
        try:
            # the gang computes chunks from the common hit depth; the
            # scheduler's hit-aware admission keeps gangs hit-homogeneous
            n_hit = min(len(h) for h in hits)
            loc = self._rows(B)
            Bl = loc.stop - loc.start
            if n_hit:
                slicing.assemble_batch(
                    state.cache, [[n.payload for n in hits[b][:n_hit]]
                                  for b in range(loc.start, loc.stop)])
            spans = [(c * C, (c + 1) * C) for c in range(n_hit, n_chunks)]
            if P > n_chunks * C:
                spans.append((n_chunks * C, P))   # unaligned remainder
            with torch.no_grad():
                for t0, t1 in spans:
                    pos = torch.arange(t0, t1, dtype=torch.int32,
                                       device=self.device)
                    apply_model(
                        self.cfg, self.params,
                        tokens=self._upload(state.x[loc, t0:t1]),
                        positions=pos[None].expand(Bl, t1 - t0),
                        mode="append", cache=state.cache,
                        kv_valid=torch.full((Bl,), t0, dtype=torch.int32,
                                            device=self.device),
                        skip_head=True, use_kernels=d.use_kernels,
                        mesh=self.mesh)
                    state.nfe += 1
                    state.q_tokens += B * (t1 - t0)
                    state.kv_tokens += B * (t1 - t0) * t1
            if spans:
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                state.host_syncs += 1
            # publish the chunks this gang computed (above what each row
            # already had cached); rows repeating an earlier row's prompt
            # (pad lanes replicate row 0) skip the extraction entirely
            if store is not None:
                seen: set = set()
                # across ranks every rank publishes every row (its model
                # shard of the heads), so the stores stay alike
                rows_kv = self._full_cache(state.cache, B)
                for b in range(B):
                    key = state.x[b, :P].tobytes()
                    start = len(hits[b])
                    if n_chunks > start and key not in seen:
                        kvs = [slicing.extract_row(rows_kv, b, c * C,
                                                   (c + 1) * C)
                               for c in range(start, n_chunks)]
                        store.insert(state.x[b, :P], start, kvs,
                                     parent_chain=hits[b])
                    seen.add(key)
        finally:
            # pins must die with this call even if a pass raises: a
            # leaked pin makes its chunk unevictable forever
            if store is not None:
                for h in hits:
                    store.unpin(h)
        state.prefix_hit_tokens = np.full((B,), n_hit * C, np.int32)
        state.prefill_time += time.perf_counter() - tp0
        return state

    def take_rows(self, state: DecodeState, rows, cache=None,
                  alloc_cache: bool = True) -> DecodeState:
        """Extract rows into a standalone state (batch compaction /
        preemption). dkv gathers the rows' KV and masks into a buffer
        the new state owns (its cache carries across blocks), whatever
        ``alloc_cache`` says. A prefix-cached state's prompt KV travels
        with its rows the same way, gathered into a buffer of its own;
        a parked one (``alloc_cache=False``) drops it instead and
        ``prime_prompt_kv`` re-primes it on resume, usually from the
        store. Every other method runs on the bound buffer of the new
        (B, T): ``alloc_cache=True`` hands it over now,
        ``alloc_cache=False`` holds no KV and adopts it at its next
        block. No KV rows are gathered for them, and ``cache`` is
        refused (the binding rule, module docstring)."""
        self._no_cache_arg(cache, "take_rows")
        rows = list(rows)
        sub = DecodeState(
            x=state.x[rows].copy(), committed=state.committed[rows].copy(),
            done=state.done[rows].copy(), prompt_len=state.prompt_len,
            n_blocks=state.n_blocks, block_idx=state.block_idx,
            steps_per_block=list(state.steps_per_block))
        if state.prefix_hit_tokens is not None:
            sub.prefix_hit_tokens = state.prefix_hit_tokens[rows].copy()
        # index_select copies: the sub-state never aliases the gang it
        # left, whose buffer goes back to the pool
        if self.dcfg.method == "dkv":
            sub.cache = self._take_cache(state.cache, state.batch, rows)
            sub.valid_mask = state.valid_mask[rows].copy()
            sub.cached_mask = state.cached_mask[rows].copy()
        elif self.cache_carries_state:
            if alloc_cache:
                sub.cache = self._take_cache(state.cache, state.batch, rows)
        elif alloc_cache:
            sub.cache = self._bound_cache(len(rows), state.total_len)
        return sub

    def merge_rows(self, parts, cache=None) -> DecodeState:
        """Fuse rows from several states sitting at the SAME block
        boundary into one state (the scheduler's cross-gang straggler
        merge). ``parts`` is a list of ``(state, rows)``. Excludes dkv,
        whose cache drifts under reshaping. A prefix-cached state's
        prompt KV is gathered from every part into a buffer the merged
        state owns; for every other method the next block refresh
        rewrites the cache, so the merged state takes the bound buffer
        of its new (B, T) and nothing is gathered. A row keeps its bits
        when ``batch_invariant``, or when the merged state has the batch
        of every part: the scheduler's ``_reshapes_exactly`` decides, as
        for ``take_rows``."""
        assert self.dcfg.method != "dkv"
        self._no_cache_arg(cache, "merge_rows")
        ref = parts[0][0]
        for st, _ in parts[1:]:
            assert (st.prompt_len, st.n_blocks, st.block_idx) == \
                (ref.prompt_len, ref.n_blocks, ref.block_idx), \
                "cross-gang merge requires identical (bucket, block) state"
        sub = DecodeState(
            x=np.concatenate([st.x[rows] for st, rows in parts]),
            committed=np.concatenate(
                [st.committed[rows] for st, rows in parts]),
            done=np.concatenate([st.done[rows] for st, rows in parts]),
            prompt_len=ref.prompt_len, n_blocks=ref.n_blocks,
            block_idx=ref.block_idx,
            # per-block step counts diverge across source gangs; keep
            # the elementwise max (metrics-only, like take_rows' copy)
            steps_per_block=[max(vals) for vals in zip(
                *(st.steps_per_block for st, _ in parts))]
            if ref.steps_per_block else [])
        if all(st.prefix_hit_tokens is not None for st, _ in parts):
            sub.prefix_hit_tokens = np.concatenate(
                [st.prefix_hit_tokens[rows] for st, rows in parts])
        if self.cache_carries_state:
            gathered = [cache_take_rows(self._full_cache(st.cache, st.batch),
                                        rows) for st, rows in parts]
            sub.cache = self._local_cache(
                cache_map(lambda *ts: torch.cat(ts), *gathered), sub.batch)
        else:
            sub.cache = self._bound_cache(sub.batch, ref.total_len)
        return sub

    def row_output(self, state: DecodeState, b: int):
        """Finalized generation for one row: tokens after the prompt,
        truncated at the first EOS. Returns (tokens (gen_len,), n)."""
        return eos_truncate(state.x[b, state.prompt_len:].copy(),
                            self.cfg.eos_token_id)

    def _query_region(self, state: DecodeState):
        d = self.dcfg
        region = suffix_query_region(
            gen_start=state.prompt_len, gen_len=d.gen_len,
            block_size=d.block_size, block_idx=state.block_idx,
            window=d.effective_window if d.trailing_position
            else max(d.effective_window, 0))
        qpos = region.positions                       # (Sq,)
        if not d.trailing_position and region.trailing_pos >= 0:
            qpos = qpos[:-1]
        return region, qpos

    def _account(self, state: DecodeState, steps: int, Sq: int,
                 prefix_len: int, vsums=None) -> None:
        """NFE and the query-token / kv-token counters of one block, as
        the JAX package counts them."""
        d = self.dcfg
        B, T, K = state.batch, state.x.shape[1], d.block_size
        state.steps_per_block.append(steps)
        state.nfe += steps
        if d.method == "vanilla":
            state.q_tokens += steps * B * T
            state.kv_tokens += steps * B * T * T
        elif d.method == "dkv":
            state.q_tokens += steps * B * Sq
            for vs in vsums[:steps]:         # valid cache slots, all rows
                state.kv_tokens += B * Sq * (int(vs) // B + Sq)
        elif steps > 0:
            # with the prefix cache the refresh covers only the generated
            # prefix + query (the prompt is attended, not recomputed)
            ref_q = (prefix_len - state.prompt_len if d.prefix_cache
                     else prefix_len) + Sq
            state.q_tokens += B * ref_q
            state.kv_tokens += B * ref_q * (prefix_len + Sq)
            if d.frozen:
                state.q_tokens += (steps - 1) * B * K
                state.kv_tokens += (steps - 1) * B * K * (prefix_len + Sq + K)
            else:
                state.q_tokens += (steps - 1) * B * Sq
                state.kv_tokens += (steps - 1) * B * Sq * (prefix_len + Sq)

    # ------------------------------------------------------ block step

    @torch.no_grad()
    def decode_block(self, state: DecodeState) -> DecodeState:
        """Run the full denoise loop for ``state.block_idx`` and advance
        to the next block boundary (mutates and returns ``state``).
        No-op on a finished state."""
        if state.finished:
            return state
        if self.dcfg.fused:
            return self._decode_block_fused(state)
        return self._decode_block_host(state)

    def _program(self, bufs: _BlockBuffers, qpos, bstart) -> _BlockProgram:
        B, T = bufs.x.shape
        key = (B, T, len(qpos), bstart)
        if key not in self._programs:
            prog = _BlockProgram(self, bufs, qpos, bstart)
            if self.device.type == "cuda":
                self._capture(prog)
            self._programs[key] = prog
        return self._programs[key]

    def _capture(self, prog: _BlockProgram) -> None:
        """Warm the program up eagerly on a side stream (libraries, the
        attention kernel's shared-memory attribute, the confidence
        kernel's counters), then capture it as one graph. The warm-up
        writes only the static buffers and slots of the bound cache that
        a block rewrites before reading; ``load`` refills the rest."""
        graph_loop.require_support()
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # one capture at a time across engine threads, warm-up included
        with graph_loop.capture_guard():
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                prog.prologue()
                prog.body()
                prog.epilogue()
            current.wait_stream(side)
            current.synchronize()
            prog.graph = graph_loop.BlockGraph(prog.prologue, prog.body,
                                               prog.epilogue, prog.b.pred,
                                               prog.n_iter, self._pool)
        self.capture_time += time.perf_counter() - t0

    def _decode_block_fused(self, state: DecodeState) -> DecodeState:
        d = self.dcfg
        t_block = time.perf_counter()
        B = state.batch
        T = state.x.shape[1]
        region, qpos = self._query_region(state)
        Sq = len(qpos)
        bufs = self._block_buffers(B, T)
        prog = self._program(bufs, qpos, region.block_start)
        if not self.cache_carries_state:
            state.cache = bufs.cache          # the binding rule (docstring)
        live_rows = int((~state.done).sum())
        bufs.load(state, self._rows(B))
        prog.run()
        out = bufs.fetch(state, self.executor)

        state.x, state.committed, state.done = (out["x"], out["committed"],
                                                out["done"])
        if d.method == "dkv":
            state.valid_mask = out["valid_mask"]
            state.cached_mask = out["cached_mask"]
        steps, n_hit = int(out["step"]), int(out["n_hit"])
        if prog.graph is not None:
            prog.graph.add_launches(steps - 1 if d.has_refresh else steps)
        state.host_syncs += 1
        state.early_exits += n_hit
        self._account(state, steps, Sq, region.block_start, out["vsums"])
        state.block_idx = region.block_idx + 1
        wall = time.perf_counter() - t_block
        state.block_stats.append(BlockStats(
            method=d.method, block_idx=region.block_idx, batch=B,
            live_rows=live_rows, steps=steps, steps_cap=self.steps_cap,
            committed_per_step=[int(v) for v in out["counts"][:steps]],
            straggler_fill=int(out["fill_n"]),
            conf_hist=[int(v) for v in out["hist"]],
            window=Sq, early_exits=n_hit, wall_s=wall,
            commit_conf=out["cconf"]))
        state.decode_time += wall
        return state

    # ------------------------------------------------------- host loop

    def _decode_block_host(self, state: DecodeState) -> DecodeState:
        """The per-step host loop (the JAX package's
        ``_decode_block_host``): the device runs each pass, every step
        fetches its confidences (or block logits) and selection, commit,
        tally, straggler fill and early exit run on the host. The
        validation oracle of the device loop. Across ranks the device
        takes this rank's rows (``loc``) and each step's per-row results
        are gathered over the data line before the host reads them."""
        cfg, d = self.cfg, self.dcfg
        t_block = time.perf_counter()
        B, P = state.batch, state.prompt_len
        loc = self._rows(B)
        Bl = loc.stop - loc.start
        K = d.block_size
        T = state.x.shape[1]
        dev = self.device
        if not self.cache_carries_state:
            state.cache = self._bound_cache(B, T)   # the binding rule
        x, committed, done = state.x, state.committed, state.done
        valid_mask, cached_mask = state.valid_mask, state.cached_mask
        cache = state.cache
        rows = np.arange(Bl)[:, None]

        region, qpos = self._query_region(state)
        Sq = len(qpos)
        qpos_b = np.broadcast_to(qpos[None], (Bl, Sq))
        qpos_d = self._upload(qpos_b)
        bstart, bend = region.block_start, region.block_start + K
        prefix_len = bstart
        valid = None
        step = 0
        toks = last_conf = None
        vsums = []
        live = ~done[:, None]
        live_rows = int((~done).sum())
        committed_per_step: list = []
        conf_hist = np.zeros((CONF_BUCKETS,), np.int64)
        cconf = np.zeros((B, K), np.float32)

        def model(toks_np, pos, mode, **kw):
            return apply_model(cfg, self.params, tokens=self._upload(toks_np),
                               positions=pos, mode=mode,
                               use_kernels=d.use_kernels, mesh=self.mesh,
                               **kw).logits

        with torch.no_grad():
            while step < self.steps_cap:
                blk_masked = ~committed[:, bstart:bend]
                if not (blk_masked & live).any():
                    break
                step += 1
                out = None                    # logits or hidden states
                xl = x[loc]                   # this rank's rows
                if d.method == "vanilla":
                    out = model(xl, self._upload(np.broadcast_to(
                        np.arange(T, dtype=np.int32)[None], (Bl, T))),
                        "encode")[:, bstart:bend]
                elif d.method == "dkv":
                    out = model(xl[rows, qpos_b], qpos_d, "append",
                                cache=cache,
                                kv_valid=self._upload(valid_mask[loc]),
                                append_at=qpos_d,
                                self_kv_mix=self._upload(
                                    cached_mask[loc][rows, qpos_b]))[:, :K]
                    newly = committed & ~cached_mask
                    cached_mask |= newly
                    valid_mask |= newly
                    vsums.append(int(valid_mask.sum()))
                elif step == 1 and d.prefix_cache:
                    # tail refresh: [generated prefix || query] only; the
                    # prompt KV is attended via kv_valid = P
                    upto = prefix_len - P
                    full_pos = np.broadcast_to(np.concatenate(
                        [np.arange(P, prefix_len, dtype=np.int32), qpos])[None],
                        (Bl, upto + Sq))
                    out = model(xl[rows, full_pos], self._upload(full_pos),
                                "append", cache=cache,
                                kv_valid=torch.full((Bl,), P,
                                                    dtype=torch.int32,
                                                    device=dev),
                                skip_head=d.parallel)[:, upto:upto + K]
                    valid = torch.full((Bl,), prefix_len, dtype=torch.int32,
                                       device=dev)
                elif step == 1:
                    full_pos = np.broadcast_to(np.concatenate(
                        [np.arange(prefix_len, dtype=np.int32), qpos])[None],
                        (Bl, prefix_len + Sq))
                    pos_d = self._upload(full_pos)
                    if d.frozen:
                        out = model(xl[rows, full_pos], pos_d, "append",
                                    cache=cache,
                                    kv_valid=torch.zeros((Bl,),
                                                         dtype=torch.int32,
                                                         device=dev),
                                    append_at=pos_d, cache_upto=prefix_len,
                                    skip_head=True)
                        vb = np.zeros((Bl, T), bool)
                        vb[:, :prefix_len] = True
                        vb[:, qpos[K:]] = True
                        valid = self._upload(vb)
                    else:
                        out = model(xl[rows, full_pos], pos_d, "encode",
                                    cache=cache, cache_upto=prefix_len,
                                    skip_head=d.parallel)
                        valid = torch.full((Bl,), prefix_len,
                                           dtype=torch.int32, device=dev)
                    out = out[:, prefix_len:prefix_len + K]
                elif d.frozen:
                    out = model(xl[:, bstart:bend], self._upload(
                        np.broadcast_to(np.arange(bstart, bend,
                                                  dtype=np.int32)[None],
                                        (Bl, K))), "step", cache=cache,
                        kv_valid=valid, skip_head=True)
                else:
                    out = model(xl[rows, qpos_b], qpos_d, "step",
                                cache=cache, kv_valid=valid,
                                skip_head=d.parallel)[:, :K]

                if d.parallel:
                    # only (B, K) conf + tokens cross to the host
                    conf_d, toks_d = self._conf_from_hidden(out)
                    conf, toks = (self._host_rows(t, B)
                                  for t in (conf_d, toks_d))
                    state.host_syncs += 1
                else:
                    # the full (B, K, V) block logits cross to the host
                    blk = self._host_rows(out.float(), B)
                    state.host_syncs += 1
                    state.logit_syncs += 1
                    if d.use_kernels:
                        # the device loop's reduction (the confidence
                        # kernel on the card), so both loops select from
                        # the same bits; on the CPU the same operations
                        # as below
                        conf, toks = (self._host_rows(t, B) for t in
                                      self._conf_from_logits(out))
                    else:
                        blk[..., cfg.mask_token_id] = -1e30
                        conf, toks = sched.confidence_and_tokens(blk)

                masked_t = torch.from_numpy(blk_masked)
                if d.parallel:
                    if d.method == "streaming":
                        tau = sched.dynamic_threshold(
                            d.tau0, d.alpha, masked_t.float().mean(dim=1))
                    else:
                        tau = torch.full((B,), d.tau0, dtype=torch.float32)
                    commit = sched.select_tokens(conf, masked_t, tau)
                else:
                    commit = sched.fixed_rate_select(conf, masked_t,
                                                     self.n_commit)
                commit, conf, toks = (commit.numpy(), conf.numpy(),
                                      toks.numpy())
                sel = np.where(commit)
                x[sel[0], bstart + sel[1]] = toks[sel]
                cconf[sel] = conf[sel]
                last_conf = conf
                committed[:, bstart:bend] |= commit
                act = commit & live
                committed_per_step.append(int(act.sum()))
                b_idx = np.clip((conf * CONF_BUCKETS).astype(np.int32),
                                0, CONF_BUCKETS - 1)
                np.add.at(conf_hist, b_idx[act], 1)

        # finalize block: commit any stragglers (steps cap reached) —
        # rows that early-exited in a prior block keep their tail
        blk_masked = ~committed[:, bstart:bend] & live
        straggler_fill = int(blk_masked.sum()) if step > 0 else 0
        if blk_masked.any() and toks is not None:
            x[:, bstart:bend] = np.where(blk_masked, toks, x[:, bstart:bend])
            cconf = np.where(blk_masked, last_conf, cconf)
        committed[:, bstart:bend] = True
        hits_blk = 0
        if d.early_exit:
            hit = (x[:, bstart:bend] == cfg.eos_token_id).any(axis=1) & ~done
            hits_blk = int(hit.sum())
            state.early_exits += hits_blk
            done |= hit

        self._account(state, step, Sq, prefix_len, vsums)
        state.block_idx = region.block_idx + 1
        wall = time.perf_counter() - t_block
        state.block_stats.append(BlockStats(
            method=d.method, block_idx=region.block_idx, batch=B,
            live_rows=live_rows, steps=step, steps_cap=self.steps_cap,
            committed_per_step=committed_per_step,
            straggler_fill=straggler_fill,
            conf_hist=[int(v) for v in conf_hist],
            window=Sq, early_exits=hits_blk, wall_s=wall,
            commit_conf=cconf))
        state.decode_time += wall
        return state

    # ------------------------------------------------------ main loop

    def finalize(self, state: DecodeState) -> GenerateResult:
        """Aggregate a finished (or early-stopped) state into the
        monolithic GenerateResult: rows truncated at their first EOS."""
        P = state.prompt_len
        gen = state.x[:, P:].copy()
        tokens_generated = 0
        for b in range(state.batch):
            gen[b], n = eos_truncate(gen[b], self.cfg.eos_token_id)
            tokens_generated += n
        wall = state.prefill_time + state.decode_time
        return GenerateResult(gen, state.nfe, list(state.steps_per_block),
                              wall, state.q_tokens, state.kv_tokens,
                              tokens_generated, state.early_exits,
                              state.prefill_time, state.host_syncs,
                              state.logit_syncs, list(state.block_stats))

    def generate(self, prompt: np.ndarray) -> GenerateResult:
        """Monolithic generation: prefill + every block to completion
        (the ``mode="batch"`` serving path)."""
        t0 = time.perf_counter()
        state = self.prefill(prompt)
        while not state.finished:
            self.decode_block(state)
        res = self.finalize(state)
        res.wall_time = time.perf_counter() - t0
        return res
