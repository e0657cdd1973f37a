"""The paper's own dLLM backbones (for fidelity runs / paper-config
FLOPs accounting): LLaDA-8B (Nie et al. 2025) and Dream-7B (Ye et al.
2025). Both are bidirectional-attention diffusion decoders; Dream is
Qwen2.5-initialized.
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import SWIGLU, LayerSpec, ModelConfig, register


@register("llada-8b")
def llada_8b() -> ModelConfig:
    return ModelConfig(
        name="llada-8b", arch_type="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=12288, vocab_size=126_464,
        pattern=(LayerSpec("attn", SWIGLU),), block_size=32)


@register("dream-7b")
def dream_7b() -> ModelConfig:
    return ModelConfig(
        name="dream-7b", arch_type="dense", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152_064,
        head_dim=128, pattern=(LayerSpec("attn", SWIGLU),), block_size=32)


@register("llada-8b-smoke")
def llada_8b_smoke() -> ModelConfig:
    return smoke_variant(llada_8b(), n_layers=2, n_kv_heads=4)
