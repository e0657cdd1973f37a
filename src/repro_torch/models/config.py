"""Model configuration system.

A ModelConfig fully describes a backbone: dimensions, the per-layer
layout (mixer kind + ffn kind), and numeric options (rope, qk-norm,
softcaps, local windows, MoE routing). Configs are plain dataclasses so
they can be constructed programmatically (reduced smoke variants) and
registered by name for the launcher (``--arch <id>``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

# Mixer kinds.
ATTN = "attn"              # global bidirectional/causal attention
ATTN_LOCAL = "attn_local"  # sliding-window attention
MLSTM = "mlstm"            # xLSTM matrix-memory LSTM
SLSTM = "slstm"            # xLSTM scalar-memory LSTM
RGLRU = "rglru"            # RecurrentGemma RG-LRU recurrent block

# FFN kinds.
SWIGLU = "swiglu"
GELU = "gelu"
MOE = "moe"
NONE = "none"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = ATTN
    ffn: str = SWIGLU


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # Layer layout: `pattern` repeated `reps` times followed by `tail`.
    # pattern * reps + tail must have length n_layers.
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    reps: int = 0                      # 0 -> n_layers // len(pattern)
    tail: Tuple[LayerSpec, ...] = ()

    # Attention options.
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_softcap: float = 0.0          # 0 disables (gemma2: 50.0)
    logit_softcap: float = 0.0         # final logits (gemma2: 30.0)
    local_window: int = 4096           # for ATTN_LOCAL layers
    attn_scale: Optional[float] = None  # None -> 1/sqrt(head_dim)

    # MoE options.
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                  # per-expert hidden dim
    moe_capacity_factor: float = 1.25
    moe_impl: str = "auto"             # dense | ep | auto
    moe_dispatch_chunk: int = 8192     # tokens per EP dispatch chunk
    moe_2d_dispatch: bool = False      # shard a2a payload over model axis
                                       # (EXPERIMENTS.md §Perf HC3b)

    # Recurrent options.
    rglru_conv_width: int = 4
    lru_width: int = 0                 # 0 -> d_model

    # Embedding / head.
    tie_embeddings: bool = False
    embed_scale: bool = False          # gemma-style sqrt(d_model) scaling
    norm_eps: float = 1e-6

    # Diffusion decoding defaults (paper Table 12: block_size=32).
    block_size: int = 32
    mask_token_id: int = 0             # set per-config; defaults filled below
    eos_token_id: int = 1

    # Modality frontend stub: if >0, inputs may be precomputed embeddings
    # with this feature dim (audio frames / vision patches).
    frontend_embed_dim: int = 0
    frontend_prefix_len: int = 0       # patches/frames prepended at prefill

    # Distribution.
    tp: int = 1                        # tensor-parallel degree (model axis)
    seq_parallel: bool = False         # Megatron-style sequence parallelism:
                                       # residual stream sharded (B, S/model, d)
                                       # between blocks -> psums become
                                       # reduce-scatter + all-gather pairs
                                       # (EXPERIMENTS.md §Perf HC2)
    scan_unroll: int = 1               # lax.scan unroll factor (dry-run
                                       # flops accounting uses full unroll)
    dtype: str = "float32"             # compute dtype
    param_dtype: str = "float32"
    remat: bool = False                # activation checkpointing per layer

    # Long-context policy: force ATTN -> ATTN_LOCAL at serve time
    # (sub-quadratic variant for long_500k on dense archs).
    force_local_attention: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.reps == 0:
            object.__setattr__(self, "reps",
                               (self.n_layers - len(self.tail)) // len(self.pattern))
        assert self.reps * len(self.pattern) + len(self.tail) == self.n_layers, (
            self.name, self.reps, len(self.pattern), len(self.tail), self.n_layers)
        if self.mask_token_id == 0:
            # reserve the last two vocab ids: [MASK] and EOS
            object.__setattr__(self, "mask_token_id", self.vocab_size - 1)
            object.__setattr__(self, "eos_token_id", self.vocab_size - 2)

    # ---- derived ----
    @property
    def layout(self) -> Tuple[LayerSpec, ...]:
        return tuple(self.pattern) * self.reps + tuple(self.tail)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def effective_layout(self, serve_long: bool = False) -> Tuple[LayerSpec, ...]:
        if not (serve_long or self.force_local_attention):
            return self.layout
        return tuple(
            LayerSpec(ATTN_LOCAL, s.ffn) if s.mixer == ATTN else s
            for s in self.layout
        )

    def param_count(self) -> int:
        """Approximate parameter count (nominal, un-padded heads)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for spec in self.layout:
            if spec.mixer in (ATTN, ATTN_LOCAL):
                n += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            elif spec.mixer == MLSTM:
                n += 2 * d * 2 * d + 2 * d * d  # up x2, down (factor-2 block)
            elif spec.mixer == SLSTM:
                n += 4 * d * d + 4 * d * (d // max(self.n_heads, 1))
            elif spec.mixer == RGLRU:
                w = self.lru_width or d
                n += 2 * d * w + w * d + 3 * w
            if spec.ffn in (SWIGLU, GELU):
                mult = 3 if spec.ffn == SWIGLU else 2
                n += mult * d * self.d_ff
            elif spec.ffn == MOE:
                n += self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        n += sum(2 * d for _ in self.layout)  # norms
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: top-k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for s in self.layout if s.ffn == MOE)
        all_exp = moe_layers * self.n_experts * 3 * self.d_model * self.moe_d_ff
        act_exp = moe_layers * self.moe_top_k * 3 * self.d_model * self.moe_d_ff
        return full - all_exp + act_exp


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in _REGISTRY:
        # import configs package lazily so registration side effects run
        import repro_torch.configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_configs() -> Sequence[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
