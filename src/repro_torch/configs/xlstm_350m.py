"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 vocab=50304. xLSTM[7:1] layout: every 8th
block is sLSTM (the paper's best ratio); d_ff=0 — xLSTM blocks carry
their own up/down projections (factor-2 mLSTM, 4/3 sLSTM), no separate
FFN. Suffix pruning is implicit (block-causal, DESIGN.md §6); the
temporal component of Streaming-dLLM applies unchanged.
"""
from repro_torch.configs.common import smoke_variant
from repro_torch.models.config import (MLSTM, NONE, SLSTM, LayerSpec,
                                       ModelConfig, register)

_PATTERN = tuple([LayerSpec(MLSTM, NONE)] * 7 + [LayerSpec(SLSTM, NONE)])


@register("xlstm-350m")
def xlstm_350m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", arch_type="ssm", n_layers=24, d_model=1024,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
        head_dim=256, pattern=_PATTERN, reps=3)


@register("xlstm-350m-smoke")
def xlstm_350m_smoke() -> ModelConfig:
    return smoke_variant(xlstm_350m(), pattern=(LayerSpec(MLSTM, NONE),
                                                LayerSpec(SLSTM, NONE)),
                         n_layers=2, head_dim=64)
