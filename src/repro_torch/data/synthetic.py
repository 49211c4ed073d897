"""Synthetic data: own numpy copy of ``repro.data.synthetic``'s
histopathology images (its Dirichlet non-IID sharding included) and of its
LM token streams (``make_lm_stream``). Bit-identical to it for the same
seed (the tests hold the two against each other).

Images are class-conditional random textures: each of the 3 classes has a
distinct spatial frequency / color signature plus per-image noise.
Augmentations reproduce §4.1: random 90° rotations, horizontal flips, color
jitter (±0.1). Macenko stain normalization is approximated by per-channel
standardization to a reference stain vector.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

_STAIN_REF = np.array([0.65, 0.70, 0.29])  # H&E-ish reference channel weights


def _class_texture(rng, size: int, cls: int) -> np.ndarray:
    """Distinct spatial-frequency signature per class."""
    freq = [2, 5, 9][cls]
    phase = rng.uniform(0, 2 * np.pi, (2,))
    xx, yy = np.meshgrid(np.linspace(0, 2 * np.pi, size),
                         np.linspace(0, 2 * np.pi, size))
    base = np.sin(freq * xx + phase[0]) * np.cos(freq * yy + phase[1])
    blobs = rng.normal(0, 1, (size // 8, size // 8))
    blobs = np.kron(blobs, np.ones((8, 8)))[:size, :size]
    mix = [0.7, 0.5, 0.3][cls]
    return mix * base + (1 - mix) * blobs


def make_histo_dataset(n: int, *, size: int = 32, n_classes: int = 3,
                       class_probs: Optional[Sequence[float]] = None,
                       noise: float = 0.8, seed: int = 0):
    """Returns (images [N,H,W,3] float32, labels [N] int32)."""
    rng = np.random.default_rng(seed)
    probs = (np.full(n_classes, 1.0 / n_classes)
             if class_probs is None else np.asarray(class_probs, float))
    probs = probs / probs.sum()
    labels = rng.choice(n_classes, size=n, p=probs).astype(np.int32)
    images = np.empty((n, size, size, 3), np.float32)
    for i, y in enumerate(labels):
        tex = _class_texture(rng, size, int(y))
        chan_w = _STAIN_REF * (1.0 + 0.3 * np.eye(3)[y % 3])
        img = tex[..., None] * chan_w[None, None, :]
        img = img + noise * rng.normal(0, 1, (size, size, 3))
        images[i] = img
    return macenko_normalize(images), labels


def macenko_normalize(images: np.ndarray) -> np.ndarray:
    """Approximate Macenko stain normalization: per-channel standardization
    against the reference stain vector (the paper's preprocessing)."""
    mu = images.mean(axis=(1, 2), keepdims=True)
    sd = images.std(axis=(1, 2), keepdims=True) + 1e-6
    return ((images - mu) / sd * _STAIN_REF[None, None, None, :]).astype(np.float32)


def augment(images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Paper §4.1: rotations (±15° ≈ k90 + jitter), h-flips, color jitter ±0.1."""
    out = images.copy()
    n = len(out)
    flip = rng.random(n) < 0.5
    out[flip] = out[flip, :, ::-1]
    rot = rng.integers(0, 4, n)
    for k in range(1, 4):
        idx = rot == k
        out[idx] = np.rot90(out[idx], k=k, axes=(1, 2))
    jitter = 1.0 + rng.uniform(-0.1, 0.1, (n, 1, 1, 3)).astype(np.float32)
    return out * jitter


def paper_splits(n_total: int, fractions=(0.10, 0.30, 0.30, 0.30)) -> List[int]:
    """§4.1 federated-average unbalanced split: 10/30/30/30."""
    sizes = [int(round(f * n_total)) for f in fractions]
    sizes[-1] = n_total - sum(sizes[:-1])
    return sizes


def shard_to_nodes(images, labels, sizes: Sequence[int], *, seed: int = 0,
                   class_bias: Optional[Sequence[Sequence[float]]] = None):
    """Partition a dataset into per-node shards, optionally class-biased.

    class_bias[i] = unnormalized class sampling weights for node i — the
    paper's "biased data allocations".
    """
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    images, labels = images[order], labels[order]
    shards = []
    pool = np.ones(len(labels), bool)
    for i, sz in enumerate(sizes):
        idx_pool = np.flatnonzero(pool)
        if class_bias is not None:
            w = np.asarray(class_bias[i], float)[labels[idx_pool]]
            w = w / w.sum()
            pick = rng.choice(idx_pool, size=min(sz, len(idx_pool)),
                              replace=False, p=w)
        else:
            pick = idx_pool[:sz]
        pool[pick] = False
        shards.append((images[pick], labels[pick]))
    return shards


def dirichlet_shards(images, labels, n_nodes: int, alpha: float = 0.5,
                     seed: int = 0):
    """Standard non-IID federated benchmark sharding (Dirichlet over classes)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    node_of = np.empty(len(labels), np.int32)
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_nodes)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for node, part in enumerate(np.split(idx, cuts)):
            node_of[part] = node
    return [(images[node_of == i], labels[node_of == i]) for i in range(n_nodes)]


def batches(images, labels, batch_size: int, rng: np.random.Generator,
            *, augment_data: bool = True):
    """One epoch of shuffled minibatches (drops remainder)."""
    order = rng.permutation(len(labels))
    for start in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[start:start + batch_size]
        x = images[idx]
        if augment_data:
            x = augment(x, rng)
        yield x, labels[idx]


# ---------------------------------------------------------------------------
# LM token streams (assigned-architecture training)
# ---------------------------------------------------------------------------

def make_lm_stream(n_seqs: int, seq_len: int, vocab: int, *, seed: int = 0,
                   topic_bias: float = 0.0, n_topics: int = 8):
    """Zipf token sequences; topic_bias>0 skews each node toward one topic.
    A copy of the reference's ``make_lm_stream`` (the same numpy draws)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    base = 1.0 / ranks ** 1.1
    topic = seed % n_topics
    boost = np.ones(vocab)
    span = vocab // n_topics
    boost[topic * span:(topic + 1) * span] += topic_bias * 10
    p = base * boost
    p /= p.sum()
    toks = rng.choice(vocab, size=(n_seqs, seq_len + 1), p=p).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
