"""Synthetic classification-as-LM tasks (MNLI/QQP/AGNews stand-ins).

A copy of ``repro.data.synthetic`` (numpy only): the same seed gives the
same tokens, labels and batches as the JAX package.

The paper's GLUE datasets are replaced by a *planted-pattern* sequence classification task with controllable difficulty:

* each class c has a signature token subset; a fraction ``signal`` of the
  sequence tokens is drawn from the class subset, the rest uniformly;
* the model is trained as a causal LM that must emit the class's label token
  at the final position (prompt ends with a fixed [CLS]-like query token);
* accuracy = argmax over the ``num_classes`` label-token logits at that
  position — the natural analogue of the paper's classification accuracy.

This keeps every architecture path (LM head, decoder stacks) identical to
real fine-tuning while giving a learnable, partitionable labelled dataset.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticTask:
    name: str
    vocab_size: int
    seq_len: int
    num_classes: int
    tokens: np.ndarray  # (N, seq_len) int32; last position is the query token
    labels: np.ndarray  # (N,) int32 class ids

    @property
    def label_tokens(self) -> np.ndarray:
        # label token for class c is (1 + c); token 0 is the query token
        return np.arange(1, self.num_classes + 1)

    def lm_batch(self, idx: np.ndarray):
        """Inputs/labels for the LM objective: predict the label token at the
        final position; other positions are next-token (masked out)."""
        toks = self.tokens[idx]
        labels = self.labels[idx]
        inputs = toks
        targets = np.concatenate([toks[:, 1:], np.zeros((len(idx), 1), np.int32)], axis=1)
        targets[:, -1] = 1 + labels
        mask = np.zeros_like(targets, dtype=np.float32)
        mask[:, -1] = 1.0
        return {
            "tokens": inputs.astype(np.int32),
            "targets": targets.astype(np.int32),
            "mask": mask,
            "labels": labels.astype(np.int32),
        }


def make_task(
    name: str = "mnli-syn",
    *,
    num_examples: int = 4096,
    vocab_size: int = 512,
    seq_len: int = 32,
    num_classes: int = 4,
    signal: float = 0.35,
    seed: int = 0,
) -> SyntheticTask:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_examples).astype(np.int32)
    # class signatures: disjoint token ranges in the upper half of the vocab
    half = vocab_size // 2
    sig_width = max(1, half // num_classes)
    tokens = rng.integers(
        1 + num_classes, vocab_size, size=(num_examples, seq_len)
    ).astype(np.int32)
    n_signal = max(1, int(signal * (seq_len - 1)))
    for i in range(num_examples):
        c = labels[i]
        lo = half + c * sig_width
        hi = min(vocab_size, lo + sig_width)
        pos = rng.choice(seq_len - 1, size=n_signal, replace=False)
        tokens[i, pos] = rng.integers(lo, hi, size=n_signal)
    tokens[:, -1] = 0  # query token
    return SyntheticTask(name, vocab_size, seq_len, num_classes, tokens, labels)
