"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000. Nemotron's
squared-ReLU MLP approximated by GELU (no gate — matches the 2-matrix
layout; noted in DESIGN.md §7). 24 heads -> TP pads to 32q/16kv.
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import GELU, LayerSpec, ModelConfig, register


@register("minitron-4b")
def minitron_4b() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", arch_type="dense", n_layers=32, d_model=3072,
        n_heads=24, n_kv_heads=8, d_ff=9216, vocab_size=256_000,
        head_dim=128, pattern=(LayerSpec("attn", GELU),),
        rope_theta=10_000.0)


@register("minitron-4b-smoke")
def minitron_4b_smoke() -> ModelConfig:
    return smoke_variant(minitron_4b(), n_layers=2)
