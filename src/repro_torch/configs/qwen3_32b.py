"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, per-head
RMS qk-norm, head_dim=128.
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import SWIGLU, LayerSpec, ModelConfig, register


@register("qwen3-32b")
def qwen3_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", arch_type="dense", n_layers=64, d_model=5120,
        n_heads=64, n_kv_heads=8, d_ff=25600, vocab_size=151_936,
        head_dim=128, pattern=(LayerSpec("attn", SWIGLU),),
        qk_norm=True, rope_theta=1_000_000.0)


@register("qwen3-32b-smoke")
def qwen3_32b_smoke() -> ModelConfig:
    return smoke_variant(qwen3_32b(), n_layers=2)
