"""Block-wise diffusion decoding — the PyTorch counterpart of
``repro.core.decoder``.

Methods (paper Tables 1/2/8) ported so far:

  vanilla   — no cache; full-sequence forward each denoise step; fixed
              schedule (top-`K/M` most-confident masked tokens per step).
  prefix    — Fast-dLLM's prefix cache: prompt + finished blocks cached;
              the block + FULL suffix recomputed each step. Vanilla
              schedule.
  fast      — Fast-dLLM: prefix cache + fixed-threshold tau0 parallel
              commit (argmax fallback guarantees progress).
  streaming — prefix cache + attenuation-guided suffix pruning (window
              w + trailing position token) + dynamic threshold tau(t)
              (Eq. 10) + EOS early exit.

``dkv``, ``frozen_suffix``, ``prefix_cache``, executor placement,
``take_rows``/``merge_rows`` and the host loop (``fused=False``, the JAX
package's validation oracle) raise ``NotImplementedError`` naming their
ROADMAP item.

The per-block loop is the semantics of the JAX package's fused loop
(``_fused_fn``) on device tensors: block refresh, denoise steps over the
query region, Eq. 4 confidence, Eq. 10 threshold, Eq. 9 selection,
straggler finalize and EOS early exit all stay on the device. The host
reads the loop condition once per step (one scalar) and fetches the
block's results once at its end; each such read counts in
``host_syncs``. (A fixed-trip CUDA-graph loop with one sync per block
is ROADMAP A5.)

On the card, attention and the parallel methods' confidence run through
the kernels (``use_kernels=True``); a CUDA decoder without them raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import schedule as sched
from repro_torch.core.suffix import suffix_query_region
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import apply_model, init_cache
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
    fused: bool = True             # device-resident loop; False (the host
                                   # loop) is ROADMAP A4
    frozen_suffix: bool = False    # ROADMAP A5.2
    prefix_cache: bool = False     # ROADMAP A7

    def __post_init__(self):
        assert self.method in METHODS, self.method
        assert self.gen_len % self.block_size == 0

    @property
    def effective_window(self) -> int:
        if self.method == "streaming":
            return self.window
        return -1                   # baselines see the full suffix

    @property
    def parallel(self) -> bool:
        return self.method in ("fast", "streaming")


def _check_ported(dcfg: DecodeConfig) -> None:
    if dcfg.method == "dkv":
        raise NotImplementedError("dkv decoding is ROADMAP A5.1")
    if not dcfg.fused:
        raise NotImplementedError("the host loop (fused=False) is ROADMAP A4")
    if dcfg.frozen_suffix:
        raise NotImplementedError("frozen_suffix is ROADMAP A5.2")
    if dcfg.prefix_cache:
        raise NotImplementedError("prefix_cache is ROADMAP A7")


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
    nfe: int = 0
    q_tokens: int = 0
    kv_tokens: int = 0
    steps_per_block: list = dataclasses.field(default_factory=list)
    early_exits: int = 0
    host_syncs: int = 0               # blocking device->host reads
    prefill_time: float = 0.0
    decode_time: float = 0.0
    block_stats: list = dataclasses.field(default_factory=list)

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def finished(self) -> bool:
        return self.block_idx >= self.n_blocks or bool(self.done.all())


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
    block_stats: list = dataclasses.field(default_factory=list)

    @property
    def tokens_per_nfe(self) -> float:
        return self.tokens_generated / max(self.nfe, 1)


class DiffusionDecoder:
    """Block diffusion decoder over device tensors. Runs on ``device``
    (cuda unless named); ``params`` must already live there."""

    def __init__(self, cfg: ModelConfig, params, dcfg: DecodeConfig,
                 device=None, executor=None, prompt_cache=None):
        _check_ported(dcfg)
        if executor is not None or prompt_cache is not None:
            raise NotImplementedError(
                "executor / mesh placement is ROADMAP A11 and the "
                "cross-request prompt cache ROADMAP A7")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and not dcfg.use_kernels:
            raise ValueError(
                "on CUDA the decoder runs attention and confidence through "
                "the kernels: set DecodeConfig(use_kernels=True)")
        self.cfg = cfg
        self.dcfg = dcfg
        self.params = params

    # ------------------------------------------------------ shared pieces

    def _head(self):
        p = self.params
        return p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]

    def _conf_from_hidden(self, h_blk):
        """Fused head path (parallel methods): hidden (B, K, d) ->
        (conf (B, K), toks (B, K)) without a monolithic (B, K, V)
        logits array. Kernel route when use_kernels."""
        cfg = self.cfg
        fn = kops.head_confidence_argmax if self.dcfg.use_kernels \
            else sched.head_confidence_and_tokens
        return fn(h_blk, self._head(), mask_id=cfg.mask_token_id,
                  logit_softcap=cfg.logit_softcap)

    def _conf_from_logits(self, blk_logits):
        """Full-vocab path (fixed-schedule methods): ban [MASK], Eq. 4,
        in plain torch."""
        blk = blk_logits.float().clone()
        blk[..., self.cfg.mask_token_id] = -1e30
        return sched.confidence_and_tokens(blk)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host -> device copy (never aliases the host array)."""
        return torch.tensor(arr, device=self.device)

    # ------------------------------------------------------ resumable API

    def prefill(self, prompt: np.ndarray) -> DecodeState:
        """Admit a batch of prompts and allocate their KV buffer. The
        returned state sits at block 0 ready for ``decode_block``."""
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
        if d.method != "vanilla":
            state.cache = init_cache(cfg, B, T, self.device)
        return state

    def take_rows(self, state, rows, cache=None, alloc_cache=True):
        raise NotImplementedError("take_rows is ROADMAP A6")

    def merge_rows(self, parts, cache=None):
        raise NotImplementedError("merge_rows is ROADMAP A6")

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

    # ------------------------------------------------------ block step

    @torch.no_grad()
    def decode_block(self, state: DecodeState) -> DecodeState:
        """Run the full denoise loop for ``state.block_idx`` and advance
        to the next block boundary (mutates and returns ``state``).
        No-op on a finished state."""
        if state.finished:
            return state
        cfg, d = self.cfg, self.dcfg
        t_block = time.perf_counter()
        dev = self.device
        B, P = state.batch, state.prompt_len
        K = d.block_size
        T = P + d.gen_len
        steps_cap = d.steps_per_block or K
        n_commit = max(1, K // steps_cap)
        parallel = d.parallel

        region, qpos = self._query_region(state)
        Sq = len(qpos)
        bstart = region.block_start
        prefix_len = bstart
        blk = slice(bstart, bstart + K)

        x = self._upload(state.x)
        committed = self._upload(state.committed)
        done = self._upload(state.done)
        live = ~done[:, None]
        live_rows = int((~state.done).sum())
        qpos_b = self._upload(np.broadcast_to(qpos[None], (B, Sq)))
        counts = torch.zeros((steps_cap,), dtype=torch.int32, device=dev)
        hist = torch.zeros((CONF_BUCKETS,), dtype=torch.int32, device=dev)
        cconf = torch.zeros((B, K), dtype=torch.float32, device=dev)
        lconf = cconf
        toks = torch.zeros((B, K), dtype=torch.int32, device=dev)

        def commit_tokens(conf, toks):
            """Eq. 9 / fixed-rate selection + token write for one step
            (all rows participate; only the loop condition excludes
            early-exited rows)."""
            blk_committed = committed[:, blk]
            blk_masked = ~blk_committed
            if parallel:
                if d.method == "streaming":
                    r_mask = blk_masked.float().mean(dim=1)
                    tau = sched.dynamic_threshold(d.tau0, d.alpha, r_mask)
                else:
                    tau = torch.full((B,), d.tau0, dtype=torch.float32,
                                     device=dev)
                commit = sched.select_tokens(conf, blk_masked, tau)
            else:
                commit = sched.fixed_rate_select(conf, blk_masked, n_commit)
            x[:, blk] = torch.where(commit, toks, x[:, blk])
            committed[:, blk] = blk_committed | commit
            return commit

        def tally(step, commit, conf):
            """Telemetry: commits per device step and a histogram of the
            committed tokens' confidence (live rows only)."""
            act = (commit & live).to(torch.int32)
            counts[step] += act.sum()
            b_idx = (conf * CONF_BUCKETS).to(torch.int32).clamp(
                0, CONF_BUCKETS - 1)
            hist.index_add_(0, b_idx.reshape(-1).long(), act.reshape(-1))

        def loop_open(step):
            """The loop condition, read on the host as one scalar."""
            if step >= steps_cap:
                return False
            state.host_syncs += 1
            return bool(((~committed[:, blk]) & live).any())

        def model(toks_in, pos, mode, **kw):
            return apply_model(cfg, self.params, tokens=toks_in,
                               positions=pos, mode=mode,
                               use_kernels=d.use_kernels, **kw).logits

        def conf_toks(out):
            if parallel:
                return self._conf_from_hidden(out)
            return self._conf_from_logits(out)

        if d.method == "vanilla":
            pos_T = torch.arange(T, dtype=torch.int32, device=dev)[None] \
                .expand(B, T)
            step = 0
            while loop_open(step):
                logits = model(x, pos_T, "encode")
                conf, toks = self._conf_from_logits(logits[:, blk])
                commit = commit_tokens(conf, toks)
                tally(step, commit, conf)
                cconf = torch.where(commit, conf, cconf)
                lconf = conf
                step += 1
        else:
            # block-start refresh (paper §3.3): one pass over [prefix ||
            # query region] that produces the block's confidences and
            # rewrites the cache; the steps then attend to the prefix KV
            pref_pos = torch.arange(prefix_len, dtype=torch.int32,
                                    device=dev)[None].expand(B, prefix_len)
            full_pos = torch.cat([pref_pos, qpos_b], dim=1)
            full_toks = torch.gather(x, 1, full_pos.long())
            out = model(full_toks, full_pos, "encode", cache=state.cache,
                        cache_upto=prefix_len, skip_head=parallel)
            valid = torch.full((B,), prefix_len, dtype=torch.int32,
                               device=dev)
            conf, toks = conf_toks(out[:, prefix_len:prefix_len + K])
            commit = commit_tokens(conf, toks)
            tally(0, commit, conf)
            cconf = torch.where(commit, conf, cconf)
            lconf = conf
            step = 1
            while loop_open(step):
                q_toks = torch.gather(x, 1, qpos_b.long())
                out = model(q_toks, qpos_b, "step", cache=state.cache,
                            kv_valid=valid, skip_head=parallel)
                conf, toks = conf_toks(out[:, :K])
                commit = commit_tokens(conf, toks)
                tally(step, commit, conf)
                cconf = torch.where(commit, conf, cconf)
                lconf = conf
                step += 1
        steps = step

        # straggler finalize (steps cap reached): commit the last step's
        # argmax — but never overwrite rows that early-exited in a prior
        # block (their tail is EOS-truncated territory)
        blk_x = x[:, blk]
        fill = (~committed[:, blk]) & live & (steps > 0)
        fill_n = fill.to(torch.int32).sum()
        cconf = torch.where(fill, lconf, cconf)
        blk_x = torch.where(fill, toks, blk_x)
        x[:, blk] = blk_x
        committed[:, blk] = True
        # Early exit (paper §3.3): a block that decoded an EOS makes all
        # *subsequent* blocks skippable for that row.
        if d.early_exit:
            hit = (blk_x == cfg.eos_token_id).any(dim=1) & ~done
            n_hit = hit.to(torch.int32).sum()
            done = done | hit
        else:
            n_hit = torch.zeros((), dtype=torch.int32, device=dev)

        # the block's one results fetch
        state.x = x.cpu().numpy()
        state.committed = committed.cpu().numpy()
        state.done = done.cpu().numpy()
        n_hit, fill_n = int(n_hit), int(fill_n)
        counts = counts.cpu().numpy()
        hist = hist.cpu().numpy()
        state.host_syncs += 1
        state.early_exits += n_hit

        state.steps_per_block.append(steps)
        state.nfe += steps
        if d.method == "vanilla":
            state.q_tokens += steps * B * T
            state.kv_tokens += steps * B * T * T
        elif steps > 0:
            ref_q = prefix_len + Sq
            state.q_tokens += B * ref_q
            state.kv_tokens += B * ref_q * (prefix_len + Sq)
            state.q_tokens += (steps - 1) * B * Sq
            state.kv_tokens += (steps - 1) * B * Sq * (prefix_len + Sq)
        state.block_idx = region.block_idx + 1
        wall = time.perf_counter() - t_block
        state.block_stats.append(BlockStats(
            method=d.method, block_idx=region.block_idx, batch=B,
            live_rows=live_rows, steps=steps, steps_cap=steps_cap,
            committed_per_step=[int(v) for v in counts[:steps]],
            straggler_fill=fill_n,
            conf_hist=[int(v) for v in hist],
            window=Sq, early_exits=n_hit, wall_s=wall,
            commit_conf=cconf.cpu().numpy()))
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
                              list(state.block_stats))

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
