"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, tied
embeddings. (Phi-4-mini's partial RoPE is applied as full RoPE — noted
in DESIGN.md §7.) 24 heads -> TP pads to 32q/16kv.
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import SWIGLU, LayerSpec, ModelConfig, register


@register("phi4-mini-3.8b")
def phi4_mini() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", arch_type="dense", n_layers=32, d_model=3072,
        n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=200_064,
        head_dim=128, pattern=(LayerSpec("attn", SWIGLU),),
        rope_theta=10_000.0, tie_embeddings=True)


@register("phi4-mini-3.8b-smoke")
def phi4_mini_smoke() -> ModelConfig:
    return smoke_variant(phi4_mini(), n_layers=2)
