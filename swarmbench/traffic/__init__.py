"""The traffic generator: every cell's inputs from its seed, on the device.

A cell's ``traffic`` (in ``workloads/<cell>.json``) names a ``kind`` and
its parameters. Each kind is a module of this package, found by name
(``traffic/<kind>.py``), with three functions:

``make(spec, model, n_nodes, gen, device)``
    ``(pools, val, data_sizes)``: each node's training pool as a tuple of
    tensors with one row a sample, the gate's validation rows stacked over
    the nodes as the program takes them, and each node's FedAvg weight.
``batch(rows)``
    the program's batch from the pools' tuples drawn ``[T, N, B, ...]``.
``val_of(val, node)``
    node ``node``'s validation rows as the reference takes them.

:class:`Traffic` reads them. Each round draws its ``[T, N, B]`` rows from
the pools by a seeded index on the device: every seed gives the same
sizes, and other rows.
"""
from __future__ import annotations

import importlib

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one stream (data, weights, draws) of a seed."""
    return torch.Generator(device=device).manual_seed(seed * 8 + stream)


def kind_module(kind: str):
    """The module of traffic kind ``kind`` (``traffic/<kind>.py``)."""
    try:
        return importlib.import_module(f"swarmbench.traffic.{kind}")
    except ModuleNotFoundError as err:
        raise SystemExit(f"no traffic kind named {kind!r}") from err


class Traffic:
    """A cell's pools and validation rows on the device, and the draw of
    each round's batches."""

    def __init__(self, traffic: dict, model: dict, n_nodes: int, seed: int,
                 device):
        self.spec, self.n, self.device = traffic, n_nodes, device
        self.kind = kind_module(traffic["kind"])
        self.draws = generator(seed, 1, device)
        self.pools, self.val, self.data_sizes = self.kind.make(
            traffic, model, n_nodes, generator(seed, 0, device), device)

    def draw(self, steps: int):
        """One round's batches ``[T, N, B, ...]``, drawn on the device."""
        b = self.spec["batch_per_node"]
        drawn = []
        for pool in self.pools:
            idx = torch.randint(0, pool[0].shape[0], (steps, b),
                                generator=self.draws, device=self.device)
            drawn.append(tuple(t[idx] for t in pool))
        return self.kind.batch(tuple(torch.stack(col, 1)
                                     for col in zip(*drawn)))

    @staticmethod
    def batch(batches, step: int, node: int):
        """Node ``node``'s batch of step ``step`` of a drawn round."""
        if isinstance(batches, dict):
            return {k: v[step, node] for k, v in batches.items()}
        return tuple(v[step, node] for v in batches)

    def val_of(self, node: int):
        return self.kind.val_of(self.val, node)
