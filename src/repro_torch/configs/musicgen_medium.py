"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048. The EnCodec codec
frontend is a stub: input_specs() provides precomputed conditioning
frame embeddings (frontend_embed_dim=768, e.g. T5 text conditioning +
melody frames); the decoder transformer over the 2048-way codebook is
fully implemented. MusicGen's MHA has n_kv == n_heads (no GQA); 24
heads !% 16 -> the TP plan zero-pads to 32/32 heads (DESIGN.md §5).
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import GELU, LayerSpec, ModelConfig, register


@register("musicgen-medium")
def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", arch_type="audio", n_layers=48,
        d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048,
        pattern=(LayerSpec("attn", GELU),),
        frontend_embed_dim=768, frontend_prefix_len=256)


@register("musicgen-medium-smoke")
def musicgen_medium_smoke() -> ModelConfig:
    return smoke_variant(musicgen_medium(), n_layers=2, n_kv_heads=4)
