"""llava-next-34b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 (Yi-34B-style
backbone). The vision tower + projector are a stub: input_specs()
supplies precomputed anyres patch embeddings (frontend_embed_dim=1024,
up to 2880 patches = base 576 + 4 tiles x 576) prepended to the text
tokens; the language decoder that consumes them is fully implemented.
56 heads -> TP pads to 64q/16kv.
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import SWIGLU, LayerSpec, ModelConfig, register


@register("llava-next-34b")
def llava_next_34b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", arch_type="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20480, vocab_size=64_000,
        head_dim=128, pattern=(LayerSpec("attn", SWIGLU),),
        rope_theta=5_000_000.0,
        frontend_embed_dim=1024, frontend_prefix_len=2880)


@register("llava-next-34b-smoke")
def llava_next_34b_smoke() -> ModelConfig:
    return smoke_variant(llava_next_34b(), n_layers=2)
