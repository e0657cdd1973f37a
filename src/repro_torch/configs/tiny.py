"""Tiny CPU-trainable configs for examples / e2e benchmarks."""
from repro_torch.models.config import MOE, LayerSpec, ModelConfig, register


@register("tiny")
def tiny() -> ModelConfig:
    return ModelConfig(
        name="tiny", arch_type="dense", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, d_ff=768, vocab_size=320, block_size=8)


@register("tiny-moe")
def tiny_moe() -> ModelConfig:
    return ModelConfig(
        name="tiny-moe", arch_type="moe", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, d_ff=0, vocab_size=320, block_size=8,
        pattern=(LayerSpec("attn", MOE),),
        n_experts=4, moe_top_k=2, moe_d_ff=256)


@register("tiny-100m")
def tiny_100m() -> ModelConfig:
    """~100M-param model for the end-to-end training example."""
    return ModelConfig(
        name="tiny-100m", arch_type="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=320, block_size=32)
