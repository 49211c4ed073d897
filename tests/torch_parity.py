"""Shared helpers for the port's parity tests (``test_torch_*.py``): build the
same small CNN, weights and data in both packages from one numpy seed."""
import jax
import numpy as np
import torch

from repro.models.cnn import init_cnn as jax_init_cnn
from repro_torch.convert import from_reference
from repro_torch.core.flat import FlatLayout
from repro_torch.models.cnn import HistoCNN

# tests/test_experiments.py's TINY protocol config
TINY = dict(n_train=160, n_test=64, steps=6, image_size=16, batch_size=8,
            noise=0.6, growth=4, stem=8, feat_dim=32, hidden=16,
            n_blocks=1, layers_per_block=2)
WIDTHS = dict(growth=4, stem=8, feat_dim=32, hidden=16, n_blocks=1,
              layers_per_block=2)


def tiny_model(**widths):
    w = dict(WIDTHS, **widths)
    model = HistoCNN(**w)
    return model, FlatLayout.of_module(model), w


def jax_params(seed, widths):
    """A reference init as a numpy tree (the reference's own He init)."""
    tree = jax_init_cnn(jax.random.key(seed), None, **widths)
    return jax.tree.map(np.asarray, tree)


def carried(layout, tree):
    """Reference numpy tree → the port's flat f32 params [P]."""
    return from_reference(layout, tree)


def images(rng, b, size):
    return rng.normal(0, 1, (b, size, size, 3)).astype(np.float32)


def torch_cpu():
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
