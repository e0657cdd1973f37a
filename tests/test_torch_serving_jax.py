"""The port's continuous scheduler against the JAX package's on one
submission script (``_torch_serving_script.py``: staggered arrivals in
two buckets, a preempt, a cancel, fake-EOS early exits), for ``prefix``
and ``streaming``: the same gang sizes, block indices and lanes tick by
tick, the same chunks (uid, block, tokens, text, finished, eos) and the
same completions (tokens, NFE, blocks, cancelled, early exit). ``fast``,
dkv and the reference's backfill input are in
``test_torch_serving_jax_fast.py``."""
import pytest

import _torch_serving_script as S

METHODS = ["prefix", "streaming"]


def check_reached(method, trace, comps):
    """The script reached what it is for: a cancel, early exits,
    concurrent gangs, every request served, and the preempted uid 1
    resumed beside the rest of its old gang and merged with it."""
    assert any(c[4] for c in comps) and any(c[5] for c in comps)
    assert any(len(t) >= 2 for t in trace)
    assert [c[0] for c in comps] == list(range(1, 9))
    assert any((2, 3, (2, 1)) in t for t in trace), method


@pytest.mark.parametrize("method", METHODS)
def test_scheduler_trace_matches_jax(method):
    """Gang sizes, block indices and lanes tick by tick."""
    assert S.port_run(method)[0] == S.jax_run(method)[0]


@pytest.mark.parametrize("method", METHODS)
def test_chunks_and_completions_match_jax(method):
    trace, chunks, comps = S.port_run(method)
    _, jchunks, jcomps = S.jax_run(method)
    assert chunks == jchunks
    assert comps == jcomps
    check_reached(method, trace, comps)
