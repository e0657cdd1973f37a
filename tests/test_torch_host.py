"""Host thread budgets of the port (``repro_torch.launch.host``),
mirroring the budget units of ``tests/test_prewarm.py``: derivation,
floor, override, ``budget_env`` composing a child's environment without
mutating this process, pool budgets, and ``apply_host_budget`` sizing
PyTorch's process-wide intra-op pool."""
import os

import torch

from repro_torch.launch import host as hostmod


def test_budget_derivation_partitions_cores():
    b = hostmod.compute_host_budget(4, cores=16)
    assert (b.engines, b.cores, b.intra_op, b.source) == \
        (4, 16, 4, "derived")
    assert "4 intra-op" in b.describe()


def test_budget_floors_at_one_thread():
    assert hostmod.compute_host_budget(8, cores=2).intra_op == 1
    assert hostmod.compute_host_budget(1, cores=1).intra_op == 1
    assert hostmod.compute_host_budget(0, cores=4).engines == 1


def test_budget_override_wins():
    b = hostmod.compute_host_budget(4, threads_per_engine=3, cores=16)
    assert (b.intra_op, b.source) == (3, "override")


def test_budget_env_composes_without_mutating_process():
    before = dict(os.environ)
    b = hostmod.compute_host_budget(2, cores=2)     # -> 1 thread/engine
    env = hostmod.budget_env(b, base={"CUDA_VISIBLE_DEVICES": "0"})
    assert env == {"CUDA_VISIBLE_DEVICES": "0", "OMP_NUM_THREADS": "1",
                   "MKL_NUM_THREADS": "1"}
    assert dict(os.environ) == before               # pure composition
    # no budget: the base passes through untouched
    assert hostmod.budget_env(base={"A": "1"}) == {"A": "1"}


def test_pool_budgets_share_one_thread_count():
    pools = hostmod.compute_pool_budgets({"prefill": 1, "decode": 3},
                                         cores=16)
    assert {r: (b.engines, b.intra_op, b.source)
            for r, b in pools.items()} == {
        "prefill": (1, 4, "pool/derived"),
        "decode": (3, 4, "pool/derived")}
    over = hostmod.compute_pool_budgets({"prefill": 1, "decode": 1},
                                        threads_per_engine=2, cores=16)
    assert {b.intra_op for b in over.values()} == {2}
    assert over["decode"].source == "pool/override"


def test_apply_host_budget_sizes_the_intra_op_pool():
    before = torch.get_num_threads()
    try:
        b = hostmod.compute_host_budget(2, threads_per_engine=2)
        assert hostmod.apply_host_budget(b) is b
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(before)
