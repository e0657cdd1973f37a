"""Placement across ranks (``serving.DecodeExecutor`` on
``torch.distributed``) on the CPU: the counterpart of
``tests/test_sharded_decode.py`` and of ``tests/test_moe.py``'s
expert-parallel checks.

One world of four gloo ranks runs this file as a program once per file
(``_rank_main``: a file rendezvous in a temporary directory, so parallel
test workers never collide; the world has a timeout of its own). Every
rank builds the same weights and prompts and makes every mesh in the
same order (a new process group is a collective of the whole world);
rank 0 belongs to every mesh, compares each placed decode with its own
single-rank decode in its process, and prints one JSON report, which
the tests assert over:

* token identity between the single-rank decode and the data-sharded
  decode (data = 2 and 4) for the batch-invariant methods, the same NFE
  for every method, on both loops (the graph loop's body and the host
  loop), with the block's one host sync kept;
* every run valid with agreement >= 0.95, the model-sharded (2, 2) mesh
  included (a reduction split over the model line may move ulps; a
  placement bug craters agreement to chance);
* the divisibility fallback: batch 3 on data = 2 is replicated, never
  padded, and exact;
* the prefix cache exact on data = 2, with hits and a mesh placement;
* a sharded ``ContinuousEngine`` end to end;
* MoE expert parallelism (``apply_moe_ep`` and ``_replicated``) against
  the dense path on ``tiny-moe`` (capacity 8: no drops; capacity 0.05:
  finite);
* the other families placed on (2, 2): RG-LRU, mLSTM and sLSTM mixers
  and the frontends tensor parallel, the MoE expert parallel;
* the frontend training loss with its head's vocabulary sharded over
  the model line (the streamed CE's gather) against one rank's.

Also the serve CLI with ``--mesh 2,1 --force-host-devices 2``: two CPU
ranks serve the same tokens as one.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 300
_REPORT = {}


def _report():
    if not _REPORT:
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                       WORLD_SIZE=str(WORLD),
                       REPRO_TORCH_INIT="file://" + os.path.join(tmp, "rdv"))
            logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                    for r in range(WORLD)]
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve())],
                env=dict(env, RANK=str(r)), cwd=ROOT, stdout=logs[r],
                stderr=subprocess.STDOUT) for r in range(WORLD)]
            try:
                codes = [p.wait(timeout=TIMEOUT) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            out = []
            for f in logs:
                f.seek(0)
                out.append(f.read())
                f.close()
        assert codes == [0] * WORLD, "\n".join(
            f"rank {r}: {c}\n{o[-3000:]}" for r, (c, o)
            in enumerate(zip(codes, out)))
        _REPORT.update(json.loads(out[0].strip().splitlines()[-1]))
    return _REPORT


def test_world_ran_every_mesh():
    rep = _report()
    assert rep["world"] == WORLD
    combos = {(r["method"], r["fused"], r["data"], r["model"])
              for r in rep["runs"]}
    for m in ("vanilla", "dkv", "prefix", "fast", "streaming"):
        for fused in (True, False):
            for mesh in ((2, 1), (4, 1), (2, 2)):
                assert (m, fused) + mesh in combos
    # (2, 2) splits tiny's 8 heads, d_ff 768 and vocabulary 320 in two
    assert rep["shards"] == {"wq_heads": 4, "w_down_rows": 384,
                             "embed_rows": 160}


def test_data_sharded_token_identity():
    """data = 2/4, model = 1: per-row math is untouched (the batch split
    only), so the batch-invariant methods are bit-identical, every
    method spends the same NFE, and a block keeps its one host sync."""
    for r in _report()["runs"]:
        if r["model"] != 1:
            continue
        assert r["nfe"] == r["ref_nfe"], r
        assert r["host_syncs"] == r["ref_host_syncs"], r
        if r["method"] != "dkv":
            assert r["exact"], r


def test_dkv_and_model_parallel_structural():
    """Every placed decode is valid and agrees with the single-rank one
    on >= 95 % of tokens, with the same NFE."""
    for r in _report()["runs"]:
        assert r["valid"], r
        assert r["agree"] >= 0.95, r
        assert r["nfe"] == r["ref_nfe"], r


def test_divisibility_fallback_replicates_exactly():
    fb = _report()["fallback"]
    assert fb["replicated"], "batch 3 on data=2 must fall back"
    assert fb["sharded_even"], "batch 4 on data=2 must shard"
    assert fb["exact"], "replicated fallback must stay bit-identical"


def test_prefix_cache_exact_on_data_sharded_mesh():
    pc = _report()["prefix_cache"]
    assert pc["exact"], "warm prefill must equal cold on the mesh"
    assert pc["hit_tokens"] > 0, "second run must hit the store"
    assert pc["store_placement"][0] == "mesh"
    assert pc["engine_exact"]
    assert all(h > 0 for h in pc["engine_hits"]), \
        "engine rows must reuse the chunks the direct runs inserted"


def test_sharded_engine_end_to_end():
    eng = _report()["engine"]
    assert eng["batch_multiple"] == 2
    assert eng["pad_3"] == 4, "gang sizes round up to the data extent"
    assert eng["served"] == 3
    assert eng["exact"], "sharded engine rows must match single-rank"
    assert eng["pool_placement"] == ["mesh", "cpu", 0, 1], \
        "pool must be placement-bound to the executor's mesh"


def test_ep_matches_dense_multirank():
    """The expert-parallel all-to-all path and the replicated-token path
    equal the dense oracle (capacity high enough that nothing drops)."""
    moe = _report()["moe"]["8.0"]
    assert moe["err"] < 1e-4, moe
    assert moe["err_rep"] < 1e-4, moe
    assert moe["aux_err"] < 1e-4, moe


def test_capacity_drops_are_graceful():
    """With capacity factor ~0, EP output degrades but never NaNs."""
    assert _report()["moe"]["0.05"]["finite"]


@pytest.mark.parametrize("name", ["recurrentgemma-9b-smoke",
                                  "xlstm-350m-smoke", "tiny-moe",
                                  "llava-next-34b-smoke",
                                  "musicgen-medium-smoke"])
def test_families_placed_on_data_and_model(name):
    r = _report()["families"][name]
    assert r["valid"], r
    assert r["agree"] >= 0.95, r
    assert r["nfe"] == r["ref_nfe"], r


def test_vocab_sharded_streamed_loss_matches_one_rank():
    """``loss_given_noise`` with a frontend prefix (the streamed CE) on
    llava-next-34b-smoke's weights sharded over (2, 2), the head's
    vocabulary split in two, against the same loss on one rank: within
    1e-5 (float32; the row-parallel sums run in another order)."""
    r = _report()["sharded_loss"]
    assert r["head_cols"] * 2 == r["vocab"]
    for key in ("loss", "ce", "masked_acc"):
        one, placed = r[key]
        assert abs(placed - one) <= 1e-5 * max(1.0, abs(one)), (key, r)
    assert r["n_masked"][0] == r["n_masked"][1] > 0


def test_serve_cli_on_two_cpu_ranks():
    """``--mesh 2,1 --force-host-devices 2``: the launcher starts two
    gloo ranks; rank 0 prints the summary, and it serves the tokens of
    the same run on one rank, with the same NFE."""
    argv = ["--arch", "tiny", "--device", "cpu", "--dtype", "float32",
            "--train-steps", "0", "--n", "3", "--gen-len", "16",
            "--max-slots", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = []
    for extra in (["--mesh", "2,1", "--force-host-devices", "2"],
                  ["--mesh", "1,1"]):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv,
             *extra], capture_output=True, text=True, env=env, cwd=ROOT,
            timeout=TIMEOUT)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    two, one = outs
    assert two["mesh"] == {"data": 2, "model": 1} and two["ranks"] == 2
    assert one["ranks"] == 1
    assert two["served"] == one["served"] == 3
    assert two["tokens_digest"] == one["tokens_digest"]
    assert two["nfe"] == one["nfe"]


# ------------------------------------------------------------ one rank

def _rank_main():
    """One rank of the world (``RANK``, ``WORLD_SIZE``,
    ``REPRO_TORCH_INIT`` from ``_report``); rank 0 prints the report."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=os.environ["REPRO_TORCH_INIT"],
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    rank = dist.get_rank()

    from repro_torch.cache import PrefixKVCache
    from repro_torch.core.decoder import METHODS, DecodeConfig, DiffusionDecoder
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import SpecBuilder, shard_tree
    from repro_torch.models.config import get_config
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import (apply_moe_dense, apply_moe_ep,
                                        apply_moe_ep_replicated, init_moe)
    from repro_torch.serving import ContinuousEngine, DecodeExecutor

    def weights(cfg, seed):
        return init_params(cfg, torch.Generator().manual_seed(seed), "cpu")

    cfg = get_config("tiny")
    params = weights(cfg, 3)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 200, (4, 10)).astype(np.int32)
    out = {"world": dist.get_world_size(), "runs": []}

    def dcfg(method, **kw):
        return DecodeConfig(**{"method": method, "gen_len": 16,
                               "block_size": 8, "window": 8, **kw})

    def compare(ref, r, c=cfg):
        return {"exact": bool((ref.tokens == r.tokens).all()),
                "agree": float((ref.tokens == r.tokens).mean()),
                "valid": bool(((r.tokens >= 0)
                               & (r.tokens < c.vocab_size)).all()),
                "nfe": int(r.nfe), "ref_nfe": int(ref.nfe)}

    meshes = [make_host_mesh(d, m) for d, m in ((2, 1), (4, 1), (2, 2))]
    execs = [DecodeExecutor(cfg, params, m, device="cpu") if m.member
             else None for m in meshes]
    # (2, 2): each rank holds half the heads, d_ff and vocabulary
    if execs[2] is not None:
        lp = execs[2].params
        out["shards"] = {"wq_heads": lp["layers"][0]["mixer"]["wq"].shape[1],
                         "w_down_rows": lp["layers"][0]["ffn"]["w_down"]
                         .shape[0], "embed_rows": lp["embed"].shape[0]}
    for method in METHODS:
        for fused in (True, False):
            d = dcfg(method, fused=fused)
            ref = DiffusionDecoder(cfg, params, d, device="cpu").generate(
                prompts.copy())
            for mesh, ex in zip(meshes, execs):
                if ex is None:
                    continue
                r = DiffusionDecoder(cfg, None, d, executor=ex).generate(
                    prompts.copy())
                out["runs"].append(dict(
                    method=method, fused=fused, data=mesh.shape["data"],
                    model=mesh.shape["model"], host_syncs=int(r.host_syncs),
                    ref_host_syncs=int(ref.host_syncs), **compare(ref, r)))

    # divisibility fallback: batch 3 does not divide data=2, so the
    # executor replicates (never pads silently) and stays exact
    ex2 = execs[0]
    d = dcfg("streaming")
    ref3 = DiffusionDecoder(cfg, params, d, device="cpu").generate(
        prompts[:3].copy())
    if ex2 is not None:
        r3 = DiffusionDecoder(cfg, None, d, executor=ex2).generate(
            prompts[:3].copy())
        out["fallback"] = {
            "exact": bool((ref3.tokens == r3.tokens).all()),
            "replicated": ex2.batch_sharding(2, 3)[0] is None,
            "sharded_even": ex2.batch_sharding(2, 4)[0] is not None,
        }

        # the sharded continuous engine: gang rounding (an odd request
        # count on data=2), the placement-bound pool, per-row identity
        tok = ByteTokenizer(cfg.vocab_size)
        eng = ContinuousEngine(cfg, params, d, max_slots=8, tokenizer=tok,
                               executor=ex2)
        uids = [eng.submit(prompts[i], max_tokens=16) for i in range(3)]
        comps = {c.uid: c for c in eng.run_to_completion()}
        out["engine"] = {
            "batch_multiple": eng.scheduler.batch_multiple,
            "pad_3": eng.scheduler._pad_batch(3),
            "served": len(comps),
            "exact": bool(all((comps[uids[i]].tokens
                               == ref3.tokens[i][:16]).all()
                              for i in range(3))),
            "pool_placement": list(eng.pool.placement),
        }

        # the prefix cache on data=2: cached = cold, the store bound to
        # the mesh, and the engine reusing the chunks the decoders put in
        dpc = dcfg("streaming", prefix_cache=True, cache_chunk=5)
        store = PrefixKVCache(chunk_tokens=5, placement=ex2.placement)
        cold = DiffusionDecoder(cfg, None, dpc, executor=ex2,
                                prompt_cache=store).generate(prompts.copy())
        warm = DiffusionDecoder(cfg, None, dpc, executor=ex2,
                                prompt_cache=store).generate(prompts.copy())
        eng_pc = ContinuousEngine(cfg, params, dpc, max_slots=8,
                                  tokenizer=tok, executor=ex2,
                                  prefix_cache=store)
        uids_pc = [eng_pc.submit(prompts[i], max_tokens=16)
                   for i in range(4)]
        comps_pc = {c.uid: c for c in eng_pc.run_to_completion()}
        out["prefix_cache"] = {
            "exact": bool((cold.tokens == warm.tokens).all()),
            "hit_tokens": store.stats()["lookup_hit_tokens"],
            "store_placement": list(store.placement),
            "engine_exact": bool(all(
                (comps_pc[uids_pc[i]].tokens == cold.tokens[i][:16]).all()
                for i in range(4))),
            "engine_hits": [comps_pc[uids_pc[i]].cache_hit_tokens
                            for i in range(4)],
        }

    # MoE expert parallelism against the dense path on (data 2, model 2)
    mesh = meshes[2]
    out["moe"] = {}
    for cf in (8.0, 0.05):
        mcfg = get_config("tiny-moe", moe_capacity_factor=cf)
        gen = torch.Generator().manual_seed(0)
        p = init_moe(gen, mcfg, torch.float32)
        x = torch.randn((4, 8, mcfg.d_model), generator=gen)
        y_dense, aux_d = apply_moe_dense(mcfg, p, x)
        spec = SpecBuilder(mcfg, mesh).layer(mcfg.layout[0])["ffn"]
        p_loc = shard_tree(p, spec, mesh)
        rows = slice(mesh.coords["data"] * 2, mesh.coords["data"] * 2 + 2)
        y_ep, aux_e = apply_moe_ep(mcfg, p_loc, x[rows], mesh)
        y_ep = mesh.data_group.all_gather(y_ep, 0)
        y_rep, _ = apply_moe_ep_replicated(mcfg, p_loc, x, mesh)
        out["moe"][str(cf)] = {
            "err": float((y_ep - y_dense).abs().max()),
            "err_rep": float((y_rep - y_dense).abs().max()),
            "aux_err": abs(float(aux_e) - float(aux_d)),
            "finite": bool(torch.isfinite(y_ep).all()
                           and torch.isfinite(y_rep).all()),
        }

    # the other families placed on (data 2, model 2): tensor-parallel
    # recurrent mixers and frontends, expert-parallel MoE
    out["families"] = {}
    fam_prompts = prompts[:, :8] % 200
    for name in ("recurrentgemma-9b-smoke", "xlstm-350m-smoke", "tiny-moe",
                 "llava-next-34b-smoke", "musicgen-medium-smoke"):
        # capacity 8: no token is dropped, so EP computes the dense path
        over = {"moe_capacity_factor": 8.0} if name == "tiny-moe" else {}
        fcfg = dataclasses.replace(get_config(name, tp=2, **over),
                                   block_size=8)
        fp = weights(fcfg, 1)
        fd = dcfg("streaming", window=4, early_exit=False)
        ref = DiffusionDecoder(fcfg, fp, fd, device="cpu").generate(
            fam_prompts.copy())
        ex = DecodeExecutor(fcfg, fp, mesh, device="cpu")
        r = DiffusionDecoder(fcfg, None, fd, executor=ex).generate(
            fam_prompts.copy())
        out["families"][name] = compare(ref, r, fcfg)

    # the training loss with a vocabulary-sharded head on (data 2, model
    # 2): the frontend step's streamed CE gathers each chunk's logits
    # over the model line into whole rows (values only: the port trains
    # on one rank, the dry run counts the rest)
    from repro_torch.training.loss import loss_given_noise
    lcfg = get_config("llava-next-34b-smoke", tp=2)
    lp = weights(lcfg, 2)
    g = torch.Generator().manual_seed(5)
    B, S = 2, 12
    toks = torch.randint(0, lcfg.vocab_size - 4, (B, S), generator=g)
    pe = torch.randn((B, lcfg.frontend_prefix_len, lcfg.frontend_embed_dim),
                     generator=g)
    t = 0.05 + 0.95 * torch.rand((B, 1), generator=g)
    m = torch.rand((B, S), generator=g) < t
    sh = shard_tree(lp, SpecBuilder(lcfg, mesh).params(), mesh)
    with torch.no_grad():
        whole = loss_given_noise(lcfg, lp, toks, t, m, prefix_embeds=pe)
        part = loss_given_noise(lcfg, sh, toks, t, m, prefix_embeds=pe,
                                mesh=mesh)
    out["sharded_loss"] = {
        "head_cols": sh["lm_head"].shape[1], "vocab": lcfg.vocab_size,
        "loss": [float(whole[0]), float(part[0])],
        **{k: [float(whole[1][k]), float(part[1][k])]
           for k in ("ce", "masked_acc", "n_masked")}}

    if rank == 0:
        json.dump(out, sys.stdout)
        sys.stdout.write("\n")
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main()
