"""Synthetic arithmetic corpus (copy of ``repro.data.synthetic``) — the
GSM8K stand-in for CPU-scale e2e validation of the paper's
accuracy/throughput tables.

Each sample is ``Q:<a>+<b>=? A:<a+b>`` (addition/subtraction/multiply,
few-shot prefixable). Deterministic per seed. The evaluation metric is
exact-match on the answer span — our analogue of GSM8K accuracy, so the
methods table (vanilla / dkv / prefix / fast / streaming) reports both a
real quality metric and throughput, like paper Tables 1/2.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


@dataclasses.dataclass
class Sample:
    prompt: str
    answer: str


def make_sample(rng: np.random.Generator, max_operand: int = 99) -> Sample:
    """Fixed-width prompts (zero-padded operands) so every prompt in a
    batch has identical length — the serving engine then needs no
    padding-aware attention for the evaluation harness."""
    width = len(str(max_operand))
    op = rng.choice(["+", "-"])
    a = int(rng.integers(0, max_operand + 1))
    b = int(rng.integers(0, max_operand + 1))
    val = {"+": a + b, "-": a - b}[op]
    return Sample(f"Q:{a:0{width}d}{op}{b:0{width}d}=? A:", str(val))


def few_shot_prompt(rng: np.random.Generator, shots: int,
                    max_operand: int = 99) -> str:
    parts = []
    for _ in range(shots):
        s = make_sample(rng, max_operand)
        parts.append(s.prompt + s.answer)
    return "\n".join(parts) + ("\n" if parts else "")


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray      # (B, S) int32
    loss_mask: np.ndarray   # (B, S) bool — answer region (SFT-style)


class ArithmeticDataset:
    """Packed, padded training batches; deterministic per (seed, step)."""

    def __init__(self, tokenizer: ByteTokenizer, seq_len: int = 128,
                 shots: int = 0, max_operand: int = 99, seed: int = 0):
        self.tok = tokenizer
        self.seq_len = seq_len
        self.shots = shots
        self.max_operand = max_operand
        self.seed = seed

    def sample_ids(self, rng) -> Tuple[np.ndarray, np.ndarray]:
        # LLaDA SFT recipe: the response region is padded to full length
        # with EOS so the model learns to emit EOS-fill after the answer
        # (this is what makes early exit well-defined at decode time).
        s = make_sample(rng, self.max_operand)
        prefix = few_shot_prompt(rng, self.shots, self.max_operand)
        p = self.tok.encode(prefix + s.prompt)
        a = self.tok.encode(s.answer, add_eos=True)
        ids = np.full(self.seq_len, self.tok.eos_id, np.int32)
        body = np.concatenate([p, a])[: self.seq_len]
        ids[:len(body)] = body
        mask = np.ones(self.seq_len, bool)
        mask[:len(p)] = False
        return ids, mask

    def batch(self, step: int, batch_size: int) -> Batch:
        rng = np.random.default_rng((self.seed, step))
        toks = np.full((batch_size, self.seq_len), self.tok.pad_id, np.int32)
        lm = np.zeros((batch_size, self.seq_len), bool)
        for i in range(batch_size):
            ids, mask = self.sample_ids(rng)
            toks[i, :len(ids)] = ids
            lm[i, :len(mask)] = mask
        return Batch(toks, lm)

    def eval_set(self, n: int, seed: int = 10_000) -> List[Sample]:
        rng = np.random.default_rng((self.seed, seed))
        out = []
        for _ in range(n):
            out.append(make_sample(rng, self.max_operand))
        return out


def exact_match(tok: ByteTokenizer, generated: np.ndarray,
                samples: List[Sample]) -> float:
    hits = 0
    for row, s in zip(generated, samples):
        text = tok.decode(row)
        pred = text.split("\n")[0].strip()
        hits += int(pred == s.answer)
    return hits / max(len(samples), 1)
