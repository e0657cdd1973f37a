"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table)
[arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048, MoE 384e top-8,
vocab=163840. Per the assignment sheet all 61 layers are uniform MoE
with GQA attention (the production model's MLA + first-dense-layer +
shared expert are deviations noted in DESIGN.md §7). The port runs the
dense MoE path on one card and the expert-parallel one on a mesh
(``models.moe``). ``remat`` recomputes each layer in the backward pass.
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import MOE, LayerSpec, ModelConfig, register


@register("kimi-k2-1t-a32b")
def kimi_k2() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", arch_type="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, d_ff=0, vocab_size=163_840,
        head_dim=128, pattern=(LayerSpec("attn", MOE),),
        n_experts=384, moe_top_k=8, moe_d_ff=2048,
        rope_theta=50_000.0, remat=True)


@register("kimi-k2-1t-a32b-smoke")
def kimi_k2_smoke() -> ModelConfig:
    return smoke_variant(kimi_k2(), n_layers=2, remat=False)
