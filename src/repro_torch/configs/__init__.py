"""Registered architectures of the port, each module a copy of the JAX
package's: the paper's backbones (``llada-8b``, ``dream-7b``), the
attention families (``qwen3-32b``, ``phi4-mini-3.8b``, ``minitron-4b``,
``gemma2-27b``), the MoE families on the dense path (``olmoe-1b-7b``,
``kimi-k2-1t-a32b``), the recurrent families (``recurrentgemma-9b``:
RG-LRU + local attention; ``xlstm-350m``: mLSTM + sLSTM), each with its
``-smoke`` variant, and the tiny CPU configs (``tiny``, ``tiny-moe``,
``tiny-100m``). The modality frontends (llava-next, musicgen) are
ROADMAP A13 step 4."""
from repro_torch.configs import (dream_llada, gemma2_27b,  # noqa: F401
                                 kimi_k2, minitron_4b, olmoe_1b_7b,
                                 phi4_mini, qwen3_32b, recurrentgemma_9b,
                                 tiny, xlstm_350m)
