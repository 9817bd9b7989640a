"""Text-classification data (counterpart of ``hyperspace_tpu/data/text.py``,
numpy only, array-equal to it for the same seed).

The loader reads a ``label<TAB>text`` TSV when one is present
(whitespace tokenization, vocabulary built by frequency) and otherwise
synthesizes a corpus with class-dependent unigram distributions.
Sequences are padded to ``max_len`` with id 0 (PAD) and carried with a
mask.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

PAD_ID = 0


@dataclasses.dataclass
class TextDataset:
    tokens: np.ndarray  # [N, L] int32, 0 = pad
    mask: np.ndarray  # [N, L] bool
    labels: np.ndarray  # [N] int32
    vocab_size: int
    num_classes: int

    def split(self, train_frac: float = 0.8, seed: int = 0):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self.labels))
        n_tr = int(len(perm) * train_frac)
        tr, te = perm[:n_tr], perm[n_tr:]
        pick = lambda idx: TextDataset(
            self.tokens[idx], self.mask[idx], self.labels[idx],
            self.vocab_size, self.num_classes)
        return pick(tr), pick(te)


def _pad(seqs: list[list[int]], max_len: int):
    n = len(seqs)
    toks = np.zeros((n, max_len), np.int32)
    mask = np.zeros((n, max_len), bool)
    for i, s in enumerate(seqs):
        s = s[:max_len]
        toks[i, : len(s)] = s
        mask[i, : len(s)] = True
    return toks, mask


def load_tsv(path: str, max_len: int = 64, max_vocab: int = 30000) -> TextDataset:
    """``label<TAB>text`` lines; builds a frequency-capped vocab (1 = UNK)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t", 1)
            if len(parts) == 2:
                rows.append((parts[0], parts[1].lower().split()))
    labels_map: dict[str, int] = {}
    freq: dict[str, int] = {}
    for lab, toks in rows:
        labels_map.setdefault(lab, len(labels_map))
        for t in toks:
            freq[t] = freq.get(t, 0) + 1
    vocab = {t: i + 2 for i, (t, _) in enumerate(
        sorted(freq.items(), key=lambda kv: -kv[1])[: max_vocab - 2])}
    seqs = [[vocab.get(t, 1) for t in toks] for _, toks in rows]
    toks, mask = _pad(seqs, max_len)
    labels = np.asarray([labels_map[lab] for lab, _ in rows], np.int32)
    return TextDataset(toks, mask, labels, len(vocab) + 2, len(labels_map))


def synthetic_text(
    num_samples: int = 2048,
    vocab_size: int = 512,
    num_classes: int = 4,
    max_len: int = 32,
    min_len: int = 8,
    class_sharpness: float = 3.0,
    seed: int = 0,
) -> TextDataset:
    """Class-dependent unigram corpora (ids 0/1 reserved for PAD/UNK)."""
    rng = np.random.default_rng(seed)
    usable = vocab_size - 2
    logits = class_sharpness * rng.normal(size=(num_classes, usable))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, num_classes, num_samples).astype(np.int32)
    seqs = []
    for y in labels:
        ln = int(rng.integers(min_len, max_len + 1))
        seqs.append(list(rng.choice(usable, size=ln, p=probs[y]) + 2))
    toks, mask = _pad(seqs, max_len)
    return TextDataset(toks, mask, labels, vocab_size, num_classes)


def load_text(name: str, root: str | None = None, **synth_kw) -> tuple[TextDataset, str]:
    if root is not None:
        path = os.path.join(root, f"{name}.tsv")
        if os.path.exists(path):
            return load_tsv(path), "disk"
    return synthetic_text(**synth_kw), "synthetic"
