"""Registered architectures of the port: the dense attention + SwiGLU
backbones its main path serves (``tiny``, ``tiny-100m``, ``llada-8b``,
``dream-7b``, ``llada-8b-smoke``). The other families of the JAX
package (MoE, recurrent, gemma2, qwen3, ...) wait for ROADMAP A13."""
from repro_torch.configs import dream_llada, tiny  # noqa: F401
