"""Traffic kind ``lm_tokens``: Zipf(``zipf``) token streams over the
vocabulary, node i's topic ``i mod n_topics`` (a contiguous 1/n_topics of
the vocabulary) raised by ``topic_bias · 10``; each node holds
``pool_seqs`` training sequences and ``val_seqs`` validation sequences of
``seq_len + 1`` tokens, inputs and next-token labels.
"""
from __future__ import annotations

import torch


def tokens(count, length, vocab, zipf, topic, bias, n_topics, gen, device):
    """``count`` rows of ``length + 1`` token ids."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** -zipf
    span = vocab // n_topics
    p[topic * span:(topic + 1) * span] *= 1.0 + bias * 10
    ids = torch.multinomial((p / p.sum()).to(torch.float32),
                            count * (length + 1), replacement=True,
                            generator=gen)
    return ids.reshape(count, length + 1)


def make(spec: dict, model: dict, n_nodes: int, gen, device):
    pools, vals = [], []
    for i in range(n_nodes):
        ids = tokens(spec["pool_seqs"] + spec["val_seqs"], spec["seq_len"],
                     model["vocab_size"], spec["zipf"], i % spec["n_topics"],
                     spec["topic_bias"], spec["n_topics"], gen, device)
        vals.append(ids[:spec["val_seqs"]])
        pools.append((ids[spec["val_seqs"]:],))
    return pools, batch((torch.stack(vals),)), [spec["pool_seqs"]] * n_nodes


def batch(rows):
    (ids,) = rows
    return {"tokens": ids[..., :-1], "labels": ids[..., 1:]}


def val_of(val, node: int):
    return {k: v[node] for k, v in val.items()}
