"""gemma2-27b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000. Alternating
(local window 4096, global) attention; attention softcap 50, final
logit softcap 30; query scale 1/sqrt(144) (query_pre_attn_scalar);
tied + scaled embeddings. The native local layers mean the long_500k
serve step only needs the global layers switched to windowed.
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import (ATTN, ATTN_LOCAL, SWIGLU, LayerSpec,
                                 ModelConfig, register)


@register("gemma2-27b")
def gemma2_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", arch_type="dense", n_layers=46, d_model=4608,
        n_heads=32, n_kv_heads=16, d_ff=36864, vocab_size=256_000,
        head_dim=128, pattern=(LayerSpec(ATTN_LOCAL, SWIGLU),
                               LayerSpec(ATTN, SWIGLU)), reps=23,
        local_window=4096, attn_softcap=50.0, logit_softcap=30.0,
        attn_scale=1.0 / 12.0, tie_embeddings=True, embed_scale=True)


@register("gemma2-27b-smoke")
def gemma2_27b_smoke() -> ModelConfig:
    return smoke_variant(gemma2_27b(), n_layers=2, local_window=64,
                         attn_scale=None)
