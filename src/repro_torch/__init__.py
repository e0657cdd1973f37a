"""PyTorch/CUDA port of the Streaming-dLLM system (``repro``).

Module names mirror the JAX package so each module's counterpart is easy
to find (``repro_torch.core.decoder`` <-> ``repro.core.decoder``). The
port imports ``torch`` and never ``jax`` or anything of ``repro``.
Attention and the commit confidence run through hand-written Hopper
kernels on the card (``repro_torch.kernels``); their plain PyTorch
versions serve CPU tensors only.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
