"""The port's own copies of the reference's jax-free pieces — synthetic data,
configs — are bit-identical to the originals."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jax_base  # noqa: E402
from repro.configs import paper_histo as jax_paper  # noqa: E402
from repro.data import synthetic as jax_syn  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import paper_histo as port_paper  # noqa: E402
from repro_torch.data import synthetic as port_syn  # noqa: E402
from repro_torch.optim import EarlyStopper  # noqa: E402
from repro.optim import EarlyStopper as JaxEarlyStopper  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("size,seed,probs", [(16, 0, None), (24, 3, (0.5, 0.3, 0.2)),
                                             (32, 7, None)])
def test_make_histo_dataset_bit_identical(size, seed, probs):
    a = jax_syn.make_histo_dataset(12, size=size, seed=seed, class_probs=probs,
                                   noise=1.1)
    b = port_syn.make_histo_dataset(12, size=size, seed=seed, class_probs=probs,
                                    noise=1.1)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_augment_and_normalize_bit_identical():
    imgs = np.random.default_rng(1).normal(0, 1, (9, 8, 8, 3)).astype(np.float32)
    assert np.array_equal(jax_syn.macenko_normalize(imgs),
                          port_syn.macenko_normalize(imgs))
    a = jax_syn.augment(imgs, np.random.default_rng(5))
    b = port_syn.augment(imgs, np.random.default_rng(5))
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("bias", [None, [[1, 0.2, 0.2], [0.2, 1, 0.2],
                                         [0.2, 0.2, 1], [1, 1, 1]]])
def test_splits_shards_and_batches_bit_identical(bias):
    x, y = jax_syn.make_histo_dataset(200, size=8, seed=2)
    sizes = jax_syn.paper_splits(200)
    assert sizes == port_syn.paper_splits(200)
    a = jax_syn.shard_to_nodes(x, y, sizes, seed=4, class_bias=bias)
    b = port_syn.shard_to_nodes(x, y, sizes, seed=4, class_bias=bias)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    xs, ys = a[1]
    ba = list(jax_syn.batches(xs, ys, 16, np.random.default_rng(9)))
    bb = list(port_syn.batches(xs, ys, 16, np.random.default_rng(9)))
    assert len(ba) == len(bb) > 0
    for (xa, ya), (xb, yb) in zip(ba, bb):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


@pytest.mark.parametrize("name", ["SwarmConfig", "TrainConfig"])
def test_config_fields_and_defaults_equal(name):
    ref = getattr(jax_base, name)
    port = getattr(port_base, name)
    fr = [(f.name, f.default) for f in dataclasses.fields(ref)]
    fp = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert fr == fp


def test_paper_histo_config_equal():
    assert (dataclasses.asdict(jax_paper.PAPER_FULL)
            == dataclasses.asdict(port_paper.PAPER_FULL))
    assert (dataclasses.asdict(jax_paper.CONFIG)
            == dataclasses.asdict(port_paper.CONFIG))


def test_early_stopper_matches():
    seq = [0.5, 0.6, 0.55, 0.58, 0.59, 0.6, 0.61, 0.3]
    for mode in ("max", "min"):
        a, b = JaxEarlyStopper(patience=2, mode=mode), EarlyStopper(
            patience=2, mode=mode)
        assert [a.update(m) for m in seq] == [b.update(m) for m in seq]
