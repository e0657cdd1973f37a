"""The port's training substrate on the CPU (``repro_torch.training``,
``repro_torch.data.synthetic``, ``bridge.params_to_jax``, the training
CLI and the serve CLI's ``--ckpt`` / ``--train-steps``), case for case
with ``tests/test_training.py``, plus what only the port has: the
explicit training route, the noise draw, the bridge's round trips and
the checkpoint's bfloat16 and error paths. Against the JAX package:
``tests/test_torch_training_jax.py``."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.bridge import jax_layout, params_from_jax, params_to_jax
from repro_torch.data.synthetic import (ArithmeticDataset, exact_match,
                                        make_sample)
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels import ops
from repro_torch.models import apply_model, get_config, init_params
from repro_torch.models.config import ATTN, ATTN_LOCAL, LayerSpec
from repro_torch.training import checkpoint, loss as loss_mod, tree
from repro_torch.training.loss import (chunked_ce, diffusion_loss,
                                       draw_noise, loss_given_noise)
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, lr_schedule)
from repro_torch.training.train import TrainConfig, train

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CFG = get_config("tiny")


def _params(cfg=CFG, seed=0):
    return init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _leaves(p):
    return tree.flatten(p)[0]


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ------------------------------------------------------------ optimizer

def test_adamw_matches_reference_scalar():
    """One param, one step, vs hand-computed AdamW."""
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                      grad_clip=0.0, warmup_steps=0, total_steps=10**9,
                      min_lr_frac=1.0)
    p = [torch.tensor([2.0])]
    st_ = adamw_init(cfg, p)
    p1, st1, _ = adamw_update(cfg, [torch.tensor([0.5])], st_, p)
    m1, v1 = 0.1 * 0.5, 0.01 * 0.25
    upd = (m1 / (1 - 0.9)) / (np.sqrt(v1 / (1 - 0.99)) + 1e-8)
    np.testing.assert_allclose(p1[0].numpy(), 2.0 - 0.1 * upd, rtol=1e-5)
    assert st1.step == 1


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(grad_clip=1.0, warmup_steps=0, min_lr_frac=1.0)
    p = [torch.zeros(4)]
    _, _, m = adamw_update(cfg, [torch.full((4,), 1e6)], adamw_init(cfg, p),
                           p)
    assert float(m["grad_norm"]) > 1e6 - 1  # reported pre-clip


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [lr_schedule(cfg, s) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0 and lrs[1] == 0.5
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < lrs[2] and abs(lrs[4] - 0.1) < 1e-6


def test_adamw_keeps_moments_in_state_dtype():
    cfg = AdamWConfig(state_dtype="bfloat16", warmup_steps=0)
    p = [torch.ones(3)]
    new, st_, _ = adamw_update(cfg, [torch.ones(3)], adamw_init(cfg, p), p)
    assert st_.m[0].dtype == st_.v[0].dtype == torch.bfloat16
    assert new[0].dtype == torch.float32


# ------------------------------------------------------------ loss

def test_chunked_ce_matches_direct():
    params = _params()
    g = torch.Generator().manual_seed(1)
    B, S = 2, 37  # not a multiple of the chunk -> exercises padding
    hidden = torch.randn((B, S, CFG.d_model), generator=g)
    tokens = torch.randint(0, CFG.vocab_size, (B, S), generator=g)
    w = torch.randn((B, S), generator=g).abs()
    nll, correct = chunked_ce(CFG, params, hidden, tokens, w, chunk=16)
    logits = hidden @ params["lm_head"]
    lse = torch.logsumexp(logits, -1)
    tl = torch.gather(logits, -1, tokens[..., None])[..., 0]
    np.testing.assert_allclose(float(nll), float(((lse - tl) * w).sum()),
                               rtol=1e-4)
    hit = ((logits.argmax(-1) == tokens) * w).sum()
    np.testing.assert_allclose(float(correct), float(hit), rtol=1e-6)


def test_diffusion_loss_masks_only_loss_region():
    params = _params()
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 200, (4, 24), generator=g)
    lm = torch.zeros((4, 24), dtype=torch.bool)
    lm[:, 12:] = True
    loss, m = diffusion_loss(CFG, params, toks, lm,
                             torch.Generator().manual_seed(2))
    assert bool(torch.isfinite(loss)) and int(m["n_masked"]) >= 4


def test_streamed_ce_equals_the_direct_loss(monkeypatch):
    """Past the vocabulary x length bound the loss streams the head
    (``chunked_ce``); both give the same loss and accuracy."""
    params = _params()
    ds = ArithmeticDataset(ByteTokenizer(CFG.vocab_size), seq_len=28)
    b = ds.batch(0, 4)
    lm = torch.as_tensor(b.loss_mask)
    t, mask = draw_noise(lm, torch.Generator().manual_seed(3))
    toks = torch.as_tensor(b.tokens)
    direct, md = loss_given_noise(CFG, params, toks, t, mask)
    monkeypatch.setattr(loss_mod, "STREAM_CE_ABOVE", 0)
    streamed, ms = loss_given_noise(CFG, params, toks, t, mask)
    np.testing.assert_allclose(float(streamed), float(direct), rtol=1e-5)
    np.testing.assert_allclose(float(ms["masked_acc"]),
                               float(md["masked_acc"]), rtol=1e-6)


@settings(deadline=None, max_examples=20)
@given(st.integers(0, 2**31 - 1))
def test_noise_draw_stays_in_the_loss_region(seed):
    """The draw: t in [0.05, 1), masked positions inside the loss region
    only, every row with a loss region masked somewhere (the forced first
    position), and the same draw for the same generator seed."""
    g = torch.Generator().manual_seed(seed)
    lm = torch.rand((6, 20), generator=g) < 0.2
    lm[0] = False
    lm[1, 7] = True
    t, mask = draw_noise(lm, torch.Generator().manual_seed(seed))
    assert t.shape == (6, 1) and bool(((t >= 0.05) & (t < 1.0)).all())
    assert not bool((mask & ~lm).any())
    assert bool((mask.any(1) == lm.any(1)).all())
    t2, mask2 = draw_noise(lm, torch.Generator().manual_seed(seed))
    assert torch.equal(t, t2) and torch.equal(mask, mask2)


def test_noise_draw_forces_the_first_loss_position():
    """With a loss region of one position, a draw that masks nothing
    there (probability 1 - t) still masks it: the forced position."""
    lm = torch.zeros((1, 10), dtype=torch.bool)
    lm[0, 6] = True
    for seed in range(50):
        _, mask = draw_noise(lm, torch.Generator().manual_seed(seed))
        assert torch.equal(mask, lm), seed


def test_loss_decreases_fast():
    params, hist = train(CFG, TrainConfig(steps=40, batch_size=16,
                                          seq_len=28, log_every=39),
                         verbose=False, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert [h["step"] for h in hist] == [0, 39]
    for key in ("loss", "ce", "masked_acc", "grad_norm", "lr", "n_masked",
                "aux", "elapsed_s"):
        assert all(np.isfinite(h[key]) for h in hist), key


def test_train_logs_at_the_reference_cadence_and_checkpoints(tmp_path):
    path = str(tmp_path / "ck")
    params, hist = train(CFG, TrainConfig(
        steps=7, batch_size=4, seq_len=20, log_every=3,
        checkpoint_path=path), verbose=False, device="cpu")
    assert [h["step"] for h in hist] == [0, 3, 6]
    assert checkpoint.load_metadata(path) == {"steps": 7, "config": "tiny"}
    _assert_bit_equal(checkpoint.restore(path, _params(seed=9), CFG), params)


def test_train_is_deterministic_per_seed():
    kw = dict(steps=3, batch_size=4, seq_len=20, log_every=1)
    a, ha = train(CFG, TrainConfig(**kw), verbose=False, device="cpu")
    b, hb = train(CFG, TrainConfig(**kw), verbose=False, device="cpu")
    _assert_bit_equal(a, b)
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    c, _ = train(CFG, TrainConfig(seed=1, **kw), verbose=False, device="cpu")
    assert not torch.equal(a["embed"], c["embed"])


def test_train_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import train as train_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: train(CFG, TrainConfig(steps=1), verbose=False),
                 lambda: train_cli.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ------------------------------------------------------------ route

def test_training_route_is_an_explicit_argument():
    """``train=True``: plain attention and ``x @ w`` on every device, a
    gradient reaching every weight; it refuses the kernel route and
    caches. On the CPU both routes give the same logits, in grad mode or
    not: the route follows the argument alone."""
    params = _params()
    toks = torch.randint(0, 300, (2, 12), generator=torch.Generator()
                         .manual_seed(0))
    serve = apply_model(CFG, params, tokens=toks).logits
    leaves, td = tree.flatten(params)
    leaves = [p.clone().requires_grad_(True) for p in leaves]
    out = apply_model(CFG, tree.unflatten(td, leaves), tokens=toks,
                      train=True).logits
    assert torch.equal(out.detach(), serve)
    grads = torch.autograd.grad(out.square().mean(), leaves)
    assert all(bool(g.abs().sum() > 0) for g in grads)
    for kw in (dict(use_kernels=True), dict(mode="step", cache=[])):
        with pytest.raises(ValueError, match="train=True"):
            apply_model(CFG, params, tokens=toks, train=True, **kw)
    x, w = torch.randn(3, 8), torch.randn(8, 5)
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.linear(x, w, train=True), x @ w)
    assert ops.LAUNCHES == before


def test_only_the_trainer_takes_the_training_route():
    """No serving caller changes route: ``train=True`` is written in
    ``training/`` only; everywhere else the argument is passed through."""
    for f in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.keyword) and node.arg == "train" \
                    and isinstance(node.value, ast.Constant):
                assert node.value.value is False or \
                    f.parent.name == "training", (f, node.lineno)


# ------------------------------------------------------------ bridge

def _layered_cfg():
    """Two pattern positions (one local) over two reps and a GELU tail."""
    return dataclasses.replace(
        CFG, n_layers=5, reps=0,
        pattern=(LayerSpec(ATTN, "swiglu"), LayerSpec(ATTN_LOCAL, "swiglu")),
        tail=(LayerSpec(ATTN, "gelu"),), local_window=4)


@pytest.mark.parametrize("which", ["tiny", "pattern_and_tail", "tied"])
def test_params_to_jax_round_trips_bit_for_bit(which):
    cfg = {"tiny": CFG, "pattern_and_tail": _layered_cfg(),
           "tied": dataclasses.replace(CFG, tie_embeddings=True)}[which]
    params = _params(cfg)
    jtree = params_to_jax(params, cfg)
    assert len(jtree["scan"]) == len(cfg.pattern)
    assert len(jtree["tail"]) == len(cfg.tail)
    assert ("lm_head" in jtree) == (not cfg.tie_embeddings)
    leaf = jtree["scan"][0]["mixer"]["wq"]
    assert isinstance(leaf, np.ndarray) and leaf.shape[0] == cfg.reps
    # layer r * n_pos + j is rep r of group j
    np.testing.assert_array_equal(
        jtree["scan"][-1]["ffn"]["w_up"][cfg.reps - 1],
        params["layers"][cfg.reps * len(cfg.pattern) - 1]["ffn"]["w_up"])
    _assert_bit_equal(params_from_jax(jtree, "cpu"), params)


def test_params_to_jax_refuses_a_mismatched_layout():
    with pytest.raises(ValueError, match="layers"):
        params_to_jax(_params(), _layered_cfg())


# ------------------------------------------------------------ checkpoint

def test_checkpoint_roundtrip(tmp_path):
    params = _params()
    path = str(tmp_path / "ck")
    checkpoint.save(path, params, CFG, {"note": "x"})
    back = checkpoint.restore(path, _params(seed=1), CFG)
    _assert_bit_equal(back, params)
    assert checkpoint.load_metadata(path)["note"] == "x"


@pytest.mark.parametrize("which", ["pattern_and_tail", "tied"])
def test_checkpoint_roundtrip_other_layouts(tmp_path, which):
    cfg = _layered_cfg() if which == "pattern_and_tail" else \
        dataclasses.replace(CFG, tie_embeddings=True)
    params = _params(cfg)
    path = str(tmp_path / "ck")
    checkpoint.save(path, params, cfg)
    _assert_bit_equal(checkpoint.restore(path, _params(cfg, 1), cfg), params)


def test_checkpoint_files_follow_the_reference_format(tmp_path):
    """``leaf_{i}`` in ``jax.tree.flatten`` order (sorted keys: embed,
    lm_head, out_norm, then the scan group's ffn/mixer/norm leaves), and
    the .json's keys."""
    import json
    params = _params()
    path = str(tmp_path / "ck")
    checkpoint.save(path, params, CFG, {"a": 1})
    meta = json.loads(pathlib.Path(path + ".json").read_text())
    assert set(meta) == {"treedef", "n_leaves", "dtypes", "metadata"}
    assert meta["n_leaves"] == 12 and meta["dtypes"] == ["float32"] * 12
    assert meta["treedef"].startswith(
        "PyTreeDef({'embed': *, 'lm_head': *, 'out_norm': *, 'scan': "
        "({'ffn': {'w_down': *, 'w_gate': *, 'w_up': *}, 'mixer': ")
    with np.load(path + ".npz") as z:
        assert sorted(z.files) == sorted(f"leaf_{i}" for i in range(12))
        np.testing.assert_array_equal(z["leaf_0"], params["embed"].numpy())
        np.testing.assert_array_equal(z["leaf_1"], params["lm_head"].numpy())
        w_down = np.stack([p["ffn"]["w_down"].numpy()
                           for p in params["layers"]])
        np.testing.assert_array_equal(z["leaf_3"], w_down)


def test_bfloat16_checkpoint_keeps_its_bits(tmp_path):
    """A bfloat16 leaf is written as 2-byte void, as the JAX package
    writes it, and read back bit for bit through the .json's dtypes; a
    template of another dtype gets the reference's cast."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16", param_dtype="bfloat16")
    params = _params(cfg)
    path = str(tmp_path / "ck")
    checkpoint.save(path, params, cfg)
    with np.load(path + ".npz") as z:
        assert z["leaf_0"].dtype.kind == "V" and z["leaf_0"].itemsize == 2
    _assert_bit_equal(checkpoint.restore(path, _params(cfg, 1), cfg), params)
    f32 = checkpoint.restore(path, _params(CFG, 1), CFG)
    assert f32["embed"].dtype == torch.float32
    assert torch.equal(f32["embed"], params["embed"].float())


def test_restore_checks_structure_shapes_and_dtypes(tmp_path):
    import json
    path = str(tmp_path / "ck")
    checkpoint.save(path, _params(), CFG)
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(path, _params(_layered_cfg()), _layered_cfg())
    wide = dataclasses.replace(CFG, d_ff=512)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(path, _params(wide), wide)
    meta = json.loads(pathlib.Path(path + ".json").read_text())
    meta["dtypes"][0] = "int32"
    pathlib.Path(path + ".json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="float32 where the .json says"):
        checkpoint.restore(path, _params(), CFG)


def test_restore_lands_on_the_template_device(tmp_path):
    path = str(tmp_path / "ck")
    checkpoint.save(path, _params(), CFG)
    back = checkpoint.restore(path, _params(seed=1), CFG)
    assert all(t.device.type == "cpu" for t in _leaves(back))


def test_tree_flatten_rebuilds_containers():
    t = {"b": (1, [2, None, 3]), "a": {"y": 4, "x": 5}, "c": ()}
    leaves, td = tree.flatten(t)
    assert leaves == [5, 4, 1, 2, 3]
    assert tree.unflatten(td, leaves) == t
    assert tree.treedef_str(td) == (
        "PyTreeDef({'a': {'x': *, 'y': *}, 'b': (*, [*, None, *]), "
        "'c': ()})")
    with pytest.raises(ValueError):
        tree.unflatten(td, leaves + [6])


def test_jax_layout_with_meta_leaves_copies_nothing():
    params = _params()
    shape_of = lambda ls: torch.empty((len(ls), *ls[0].shape),  # noqa: E731
                                      device="meta")
    lay = jax_layout(params, CFG, lambda t: t, shape_of)
    assert lay["embed"] is params["embed"]
    assert lay["scan"][0]["mixer"]["wq"].device.type == "meta"


# ------------------------------------------------------------ data

def test_tokenizer_roundtrip():
    tok = ByteTokenizer(320)
    s = "Q:12+34=? A:46"
    assert tok.decode(tok.encode(s)) == s
    assert tok.decode(tok.encode(s, add_eos=True)) == s


@settings(deadline=None, max_examples=30)
@given(st.integers(0, 2**31 - 1))
def test_samples_are_correct_arithmetic(seed):
    rng = np.random.default_rng(seed)
    s = make_sample(rng, 99)
    expr = s.prompt[2:s.prompt.index("=")]
    op = "+" if "+" in expr else "-"
    a, b = expr.split(op)
    val = int(a) + int(b) if op == "+" else int(a) - int(b)
    assert str(val) == s.answer


def test_dataset_deterministic():
    tok = ByteTokenizer(320)
    ds1 = ArithmeticDataset(tok, seq_len=28, seed=5)
    ds2 = ArithmeticDataset(tok, seq_len=28, seed=5)
    b1, b2 = ds1.batch(3, 8), ds2.batch(3, 8)
    assert (b1.tokens == b2.tokens).all()
    assert (b1.loss_mask == b2.loss_mask).all()
    b3 = ds1.batch(4, 8)
    assert not (b1.tokens == b3.tokens).all()


def test_eval_exact_match_metric():
    tok = ByteTokenizer(320)
    ds = ArithmeticDataset(tok, seq_len=28)
    samples = ds.eval_set(4)
    perfect = np.stack([
        np.pad(tok.encode(s.answer, add_eos=True), (0, 16))[:16]
        for s in samples])
    assert exact_match(tok, perfect, samples) == 1.0
    wrong = np.full((4, 16), ord("z"), np.int32)
    assert exact_match(tok, wrong, samples) == 0.0


# ------------------------------------------------------------ CLIs

def test_train_cli_lower_only_names_a14():
    from repro_torch.launch import train as train_cli
    with pytest.raises(NotImplementedError, match="A14"):
        train_cli.main(["--device", "cpu", "--lower-only"])


def _serve_args(**kw):
    base = dict(ckpt="", train_steps=0, seed=0)
    return types.SimpleNamespace(**{**base, **kw})


def test_serve_train_steps_0_serves_init_params():
    """``--train-steps 0`` gives exactly the weights the CLI served
    before it could train: ``init_params`` of ``--seed``."""
    from repro_torch.launch import serve
    got = serve.load_weights(_serve_args(seed=3), CFG, torch.device("cpu"))
    _assert_bit_equal(got, _params(seed=3))


def test_serve_weights_from_ckpt_and_from_training(tmp_path):
    from repro_torch.launch import serve
    path = str(tmp_path / "ck")
    params = _params(seed=4)
    checkpoint.save(path, params, CFG)
    got = serve.load_weights(_serve_args(ckpt=path, train_steps=600), CFG,
                             torch.device("cpu"))
    _assert_bit_equal(got, params)
    bf16 = dataclasses.replace(CFG, dtype="bfloat16", param_dtype="bfloat16")
    trained = serve.load_weights(_serve_args(train_steps=2), bf16,
                                 torch.device("cpu"))
    ref, _ = train(CFG, TrainConfig(steps=2, batch_size=32, seq_len=44),
                   verbose=False, device="cpu")
    assert trained["embed"].dtype == torch.bfloat16
    assert torch.equal(trained["embed"], ref["embed"].to(torch.bfloat16))


def test_train_then_serve_cli_in_subprocesses(tmp_path):
    """``python -m repro_torch.launch.train`` writes a checkpoint that
    ``python -m repro_torch.launch.serve --ckpt`` serves."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ck = str(tmp_path / "tiny")
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", *a], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=180)
    proc = run("repro_torch.launch.train", "--device", "cpu", "--dtype",
               "float32", "--arch", "tiny", "--steps", "5", "--batch", "4",
               "--seq-len", "20", "--ckpt", ck)
    assert proc.returncode == 0, proc.stderr
    assert "done: loss" in proc.stdout
    assert os.path.exists(ck + ".npz") and os.path.exists(ck + ".json")
    proc = run("repro_torch.launch.serve", "--device", "cpu", "--dtype",
               "float32", "--arch", "tiny", "--ckpt", ck, "--train-steps",
               "0", "--mode", "batch", "--n", "2", "--gen-len", "8")
    assert proc.returncode == 0, proc.stderr
    import json
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["served"] == 2 and out["nfe"] > 0


# ------------------------------------------------------------ isolation

def test_training_modules_are_walked_by_the_isolation_test():
    """``test_torch_decode.py``'s import and AST checks walk every module
    of the port; the training, data and launch modules are among them,
    and importing them in a fresh interpreter loads no jax and nothing of
    the JAX package."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("training", "training.tree", "training.checkpoint",
                "training.optimizer", "training.loss", "training.train",
                "data.synthetic", "launch.train"):
        assert f"repro_torch.{mod}" in names
    code = ("import sys\n"
            "import repro_torch.training, repro_torch.launch.train\n"
            "import repro_torch.data.synthetic, repro_torch.training.train\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
