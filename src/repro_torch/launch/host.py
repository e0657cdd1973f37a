"""Host resource budgeting for multi-engine serving (the PyTorch
counterpart of ``repro.launch.host``).

N ``EngineLoop`` threads in one process share PyTorch's intra-op thread
pool, sized to every visible core by default; engines that run eager
work on the host at once (the CPU path, the host loop, the audit lane's
host oracle) then fight over it. The fix is to *budget*: size the pool
to one engine's share of the host, ``cores // engines``, overridable
with ``--host-threads-per-engine``.

Mechanics: ``apply_host_budget`` calls ``torch.set_num_threads``. The
intra-op pool is process-wide, like the JAX package's ``PJRT_NPROC``,
so every engine of the process runs under one size and pools cannot
differ; ``compute_pool_budgets`` keeps a record per pool all the same,
which each engine carries into ``/metrics`` and its trace track.
``budget_env`` composes ``OMP_NUM_THREADS`` / ``MKL_NUM_THREADS`` for a
child process without touching this one.

The JAX package's ``enable_compile_cache`` has no counterpart: the
port's block programs are CUDA graphs captured in-process and never
persisted (``--prewarm`` captures them before admission opens), and the
two ``repro_persistent_cache_*`` series stay at 0. Faking host devices
(``force_host_device_count``) belongs to the mesh placement, ROADMAP
A11.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

_THREAD_ENV_KEYS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


@dataclasses.dataclass(frozen=True)
class HostBudget:
    """Effective per-engine host compute budget. ``intra_op`` is the
    size of PyTorch's intra-op pool each engine's eager work may use; it
    is surfaced in ``/metrics`` (``repro_host_threads_per_engine``) and
    the engine's trace track so a trace always records what it ran
    under."""
    engines: int
    cores: int
    intra_op: int
    source: str          # "derived" | "override" | "pool/<either>"

    def describe(self) -> str:
        return (f"{self.intra_op} intra-op thread(s)/engine "
                f"({self.source}; {self.engines} engine(s) on "
                f"{self.cores} core(s))")


def compute_host_budget(engines: int, threads_per_engine: int = 0,
                        cores: Optional[int] = None) -> HostBudget:
    """Partition host compute across engines: ``cores // engines``
    intra-op threads each (floor 1), unless ``threads_per_engine``
    overrides it."""
    engines = max(1, engines)
    if cores is None:
        cores = os.cpu_count() or 1
    if threads_per_engine > 0:
        return HostBudget(engines, cores, threads_per_engine, "override")
    return HostBudget(engines, cores, max(1, cores // engines), "derived")


def compute_pool_budgets(pool_sizes: Dict[str, int],
                         threads_per_engine: int = 0,
                         cores: Optional[int] = None) \
        -> Dict[str, HostBudget]:
    """Per-pool budget records for a disaggregated fleet
    (``--pool prefill:N,decode:M``). The intra-op pool is process-wide,
    so the thread count comes from the *total* engine count and is the
    same for every pool; what differs per pool is the record (engine
    count, ``source="pool/..."``). Apply the total budget with
    ``apply_host_budget``."""
    total = sum(max(0, n) for n in pool_sizes.values())
    base = compute_host_budget(total, threads_per_engine, cores)
    return {role: HostBudget(n, base.cores, base.intra_op,
                             f"pool/{base.source}")
            for role, n in pool_sizes.items()}


def apply_host_budget(budget: HostBudget) -> HostBudget:
    """Size this process's intra-op pool to ``budget.intra_op`` (process-
    wide: every engine thread shares it)."""
    torch.set_num_threads(budget.intra_op)
    return budget


def budget_env(budget: Optional[HostBudget] = None, *,
               base: Optional[dict] = None) -> dict:
    """Environment dict for a *subprocess*: the thread knobs that size
    its intra-op pool to ``budget`` (as ``apply_host_budget`` sizes this
    one), composed without mutating this process; every other key of
    ``base`` is kept."""
    env = dict(base if base is not None else os.environ)
    if budget is not None:
        for key in _THREAD_ENV_KEYS:
            env[key] = str(budget.intra_op)
    return env
