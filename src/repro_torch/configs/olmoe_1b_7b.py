"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (kv=16) expert d_ff=1024, MoE 64e top-8,
vocab=50304, qk-norm. Every layer's FFN is MoE. On one card the port
runs the dense path (every expert for every token); on a mesh with a
data extent above one, the expert-parallel dispatch
(``models.moe.apply_moe_ep``).
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import MOE, LayerSpec, ModelConfig, register


@register("olmoe-1b-7b")
def olmoe_1b_7b() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", arch_type="moe", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=0, vocab_size=50304,
        pattern=(LayerSpec("attn", MOE),), qk_norm=True,
        n_experts=64, moe_top_k=8, moe_d_ff=1024)


@register("olmoe-1b-7b-smoke")
def olmoe_1b_7b_smoke() -> ModelConfig:
    return smoke_variant(olmoe_1b_7b(), n_layers=2, n_kv_heads=4)
