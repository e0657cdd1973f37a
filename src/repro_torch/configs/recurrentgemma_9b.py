"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2
[arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000. Griffin layout:
(recurrent, recurrent, local-attn) x 12 + (recurrent, recurrent) tail.
Local attention window 2048. kv=1 is duplicated to 16 heads under TP
(exact for GQA, DESIGN.md §5). GeGLU approximated by SwiGLU (noted in
DESIGN.md §7). Suffix pruning is implicit for the RG-LRU layers and
explicit for the local-attention layers' query region.
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import (ATTN_LOCAL, RGLRU, SWIGLU,
                                       LayerSpec, ModelConfig, register)

_R = LayerSpec(RGLRU, SWIGLU)
_A = LayerSpec(ATTN_LOCAL, SWIGLU)


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", arch_type="hybrid", n_layers=38,
        d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
        vocab_size=256_000, head_dim=256, lru_width=4096,
        pattern=(_R, _R, _A), reps=12, tail=(_R, _R),
        local_window=2048, tie_embeddings=True, embed_scale=True)


@register("recurrentgemma-9b-smoke")
def recurrentgemma_9b_smoke() -> ModelConfig:
    return smoke_variant(recurrentgemma_9b(), n_layers=3, tail=(),
                         n_kv_heads=1, head_dim=64, local_window=64)
