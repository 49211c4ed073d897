"""The port's topology, merge strategies and commit kernel forms against the
reference: topology and strategies at 1e-6; both plain forms of the fused
commit against the reference's Pallas ``fused_merge_all`` (interpret mode) at
2e-5 (f32) / 2e-2 (bf16), with rejected rows exactly equal to the input."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jeng  # noqa: E402
from repro.core import merge_impl as jmi  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_merge import fused_merge_all as jax_fused_merge_all  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import merge_impl as tmi  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.kernels import fused_merge as tfm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)
MASKS = [[1, 1, 1, 1], [1, 0, 1, 1], [0, 1, 0, 1], [1, 0, 0, 0]]


@pytest.mark.parametrize("n", [2, 4, 5])
def test_host_topology_equal(n):
    sizes = np.arange(1, n + 1) * 10.0
    assert np.array_equal(ttopo.fedavg_weights(sizes), jtopo.fedavg_weights(sizes))
    for kind in ("full", "ring", "dynamic"):
        for active in (None, [True] * (n - 1) + [False]):
            a = ttopo.build_matrix(kind, n, weights=sizes, self_weight=0.6,
                                   active=active)
            b = jtopo.build_matrix(kind, n, weights=sizes, self_weight=0.6,
                                   active=active)
            assert np.array_equal(a, b)
            assert ttopo.spectral_gap(a) == jtopo.spectral_gap(b)


@pytest.mark.parametrize("kind", ["full", "ring", "dynamic"])
@pytest.mark.parametrize("mask", MASKS)
def test_mixing_matrix_traced_matches(kind, mask):
    sizes = [16.0, 48.0, 48.0, 48.0]
    for weights in (None, sizes):
        want = jtopo.mixing_matrix_traced(kind, jnp.asarray(mask, bool),
                                          weights=weights, self_weight=0.5)
        got = ttopo.mixing_matrix_traced(kind, torch.tensor(mask, dtype=torch.bool),
                                         weights=weights, self_weight=0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jeng.active_weights_traced(sizes, jnp.asarray(mask, bool))
    got = teng.active_weights_traced(sizes, torch.tensor(mask, dtype=torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.array_equal(teng.active_weights(sizes, mask),
                          jeng.active_weights(sizes, mask))
    cfg = dict(n_nodes=4, topology=kind, merge="fedavg")
    assert np.array_equal(
        teng.mixing_matrix(SwarmConfig(**cfg), sizes, mask),
        jeng.mixing_matrix(JSwarmConfig(**cfg), sizes, mask))


def _stack(rng, n=4):
    """A stacked two-leaf reference tree and its flat [N, P] counterpart."""
    tree = {"a": rng.normal(0, 1, (n, 6, 9)).astype(np.float32),
            "b": rng.normal(0, 1, (n, 300)).astype(np.float32)}
    flat = np.concatenate([tree["a"].reshape(n, -1), tree["b"]], axis=1)
    return tree, torch.from_numpy(flat)


def _flat(tree):
    n = tree["a"].shape[0]
    return np.concatenate([np.asarray(tree["a"]).reshape(n, -1),
                           np.asarray(tree["b"]).reshape(n, -1)], axis=1)


def test_merge_functions_match():
    rng = np.random.default_rng(0)
    tree, flat = _stack(rng)
    ftree, fflat = _stack(rng)
    ftree = jax.tree.map(np.abs, ftree)
    fflat = fflat.abs()
    W = rng.dirichlet(np.ones(4), size=4).astype(np.float32)
    w = rng.dirichlet(np.ones(4)).astype(np.float32)
    cases = [
        (jmi.mix(tree, W), tmi.mix(flat, torch.from_numpy(W))),
        (jmi.fisher_merge(tree, ftree), tmi.fisher_merge(flat, fflat)),
        (jmi.gradmatch_merge(tree, ftree, w),
         tmi.gradmatch_merge(flat, fflat, torch.from_numpy(w))),
        (jmi.topo_weighted_merge(tree, ftree, W),
         tmi.topo_weighted_merge(flat, fflat, torch.from_numpy(W))),
        (jmi.mask_fishers(ftree, jnp.asarray([1, 0, 1, 1], bool)),
         tmi.mask_fishers(fflat, torch.tensor([1, 0, 1, 1], dtype=torch.bool))),
    ]
    for want, got in cases:
        np.testing.assert_allclose(got.numpy(), _flat(want), **TOL)


@pytest.mark.parametrize("merge", ["mean", "fedavg", "fisher", "gradmatch"])
@pytest.mark.parametrize("topology", ["full", "ring"])
@pytest.mark.parametrize("mask", [[1, 1, 1, 1], [1, 0, 1, 1]])
def test_strategy_propose_matches(merge, topology, mask):
    """The engine's propose (strategy, finalized mass, topology rows) from the
    same params and accumulated statistics."""
    rng = np.random.default_rng(1)
    tree, flat = _stack(rng)
    sizes = [16.0, 48.0, 48.0, 48.0]
    kw = dict(n_nodes=4, merge=merge, topology=topology, lora_only=False)
    jcfg, tcfg = JSwarmConfig(**kw), SwarmConfig(**kw)
    je = jeng.SwarmEngine(jcfg, None, None, data_sizes=sizes)
    te = teng.SwarmEngine(tcfg, None, None, data_sizes=sizes)
    stats_j, stats_t = je.init_stats(tree), te.init_stats(flat)
    if stats_j is not None:   # two Δθ² accumulation steps
        for k in range(2):
            new_tree = jax.tree.map(
                lambda x: x + rng.normal(0, 0.1, x.shape).astype(np.float32),
                tree)
            new_flat = torch.from_numpy(_flat(new_tree))
            stats_j = je.strategy.accumulate(stats_j, tree, new_tree, k)
            stats_t = te.strategy.accumulate(stats_t, flat, new_flat, k)
            tree, flat = new_tree, new_flat
        np.testing.assert_allclose(stats_t.numpy(), _flat(stats_j), **TOL)
    a_j, a_t = jnp.asarray(mask, bool), torch.tensor(mask, dtype=torch.bool)
    cj, Wj, ij = je.propose(tree, a_j, stats=stats_j)
    ct, Wt, it = te.propose(flat, a_t, stats=stats_t)
    np.testing.assert_allclose(ct.numpy(), _flat(cj), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **TOL)
    assert (ij is None) == (it is None)
    if it is not None:
        np.testing.assert_allclose(it.numpy(), _flat(ij), rtol=2e-6, atol=2e-6)


def test_get_strategy_dispatch():
    for merge, cls in [("mean", tmi.MixStrategy), ("fedavg", tmi.MixStrategy),
                       ("fisher", tmi.FisherStrategy),
                       ("gradmatch", tmi.GradMatchStrategy)]:
        assert type(tmi.get_strategy(SwarmConfig(merge=merge))) is cls
    with pytest.raises(ValueError):
        tmi.get_strategy(SwarmConfig(merge="nope"))


def _kernel_inputs(n, d, dtype, seed, with_imp):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    W = rng.dirichlet(np.ones(n), size=n).astype(np.float32)
    f = (np.abs(rng.normal(1, 0.4, (n, d))).astype(np.float32)
         if with_imp else None)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    return rng, xj, xt, W, f


@pytest.mark.parametrize("n,d,dtype", [
    (2, 512, jnp.float32), (4, 1000, jnp.float32), (8, 4096, jnp.float32),
    (4, 777, jnp.float32), (4, 2048, jnp.bfloat16), (64, 777, jnp.float32)])
@pytest.mark.parametrize("with_imp", [False, True])
def test_plain_commit_matches_pallas_kernel(n, d, dtype, with_imp):
    rng, xj, xt, W, f = _kernel_inputs(n, d, dtype, n * 1000 + d, with_imp)
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16
           else dict(rtol=2e-5, atol=2e-5))
    for gates in (np.ones(n, bool), np.zeros(n, bool), rng.random(n) > 0.5):
        want = jax_fused_merge_all(xj, W, gates,
                                   None if f is None else jnp.asarray(f),
                                   block=512, interpret=True)
        got = tref.fused_merge_all_plain(
            xt, torch.from_numpy(W), torch.from_numpy(gates),
            None if f is None else torch.from_numpy(f))
        assert got.dtype == xt.dtype and got.shape == xt.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)
        # rejected rows: the exact input bits
        assert torch.equal(got[~torch.from_numpy(gates)],
                           xt[~torch.from_numpy(gates)])
        # the wrapper takes the plain version for a CPU tensor
        wrapped = tfm.fused_merge_all(
            xt, torch.from_numpy(W), torch.from_numpy(gates),
            None if f is None else torch.from_numpy(f))
        assert torch.equal(wrapped, got)


def test_fused_merge_ref_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, 300)).astype(np.float32)
    w = rng.dirichlet(np.ones(4)).astype(np.float32)
    for gate, idx in [(True, 0), (False, 3)]:
        want = jref.fused_merge_ref(jnp.asarray(x), jnp.asarray(w), idx, gate)
        got = tref.fused_merge_ref(torch.from_numpy(x), torch.from_numpy(w),
                                   idx, gate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

