"""Registered architectures of the port, each module a copy of the JAX
package's: the paper's backbones (``llada-8b``, ``dream-7b``), the
attention families (``qwen3-32b``, ``phi4-mini-3.8b``, ``minitron-4b``,
``gemma2-27b``), the MoE families on the dense path (``olmoe-1b-7b``,
``kimi-k2-1t-a32b``), the recurrent families (``recurrentgemma-9b``:
RG-LRU + local attention; ``xlstm-350m``: mLSTM + sLSTM), each with its
``-smoke`` variant, the modality frontends (``llava-next-34b``: vision
patches; ``musicgen-medium``: audio frames; each a stub of precomputed
embeddings through ``frontend_proj``), and the tiny CPU configs
(``tiny``, ``tiny-moe``, ``tiny-100m``)."""
from repro_torch.configs import (dream_llada, gemma2_27b,  # noqa: F401
                                 kimi_k2, llava_next_34b, minitron_4b,
                                 musicgen_medium, olmoe_1b_7b, phi4_mini,
                                 qwen3_32b, recurrentgemma_9b, tiny,
                                 xlstm_350m)
