"""The port's serving plane (`repro_torch.serve`, `repro_torch.launch.
serve`) against the reference's (`repro.serve`): the cases of
tests/test_serve.py on the port — bucket policy and queue (own copies held
equal to the originals), ``aggregate_logits`` against the JAX function in
every mode with and without a node mask, the engine against host
``generate``, isolation under continuous batching, the bucket-grid
dispatch promise, hot-swap under load from a checkpoint of either
package, deadlines, backpressure, drain timeout and node crash — and the
port engine's token streams equal to the JAX engine's on the smoke
minicpm-2b (vocab 64) and hymba-1.5b at the reference's seeds. CPU, f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.core.session import SwarmSession as JSession  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serve import BucketPolicy as JBucketPolicy  # noqa: E402
from repro.serve import RequestQueue as JRequestQueue  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import aggregate_logits as j_aggregate  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.core.session import SwarmSession  # noqa: E402
from repro_torch.launch.serve import generate, tree_leaves  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.models.attention import write_rows  # noqa: E402
from repro_torch.serve import (AGG_MODES, BucketPolicy,  # noqa: E402
                               HotSwapSlot, RequestQueue, ServeEngine,
                               aggregate_logits)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

N = 3
V = 16


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _models(arch="minicpm-2b", **kw):
    jcfg = jsmoke(jget_config(arch)).replace(**kw)
    tcfg = smoke_variant(get_config(arch)).replace(**kw)
    return jbuild(jcfg), build_model(tcfg)


def _stacked(jm, tm, n=N, seed=0):
    """The reference's stacked init (tests/test_serve.py's _stacked_params)
    and the same weights as the port's [n, P] ensemble."""
    tree = jax.vmap(jm.init)(jax.random.split(jax.random.key(seed), n))
    tree = jax.tree.map(np.asarray, tree)
    return tree, lm_params_from_reference(tm.layout, tree, lead=1)


def _engine(tm, params, **kw):
    return ServeEngine(tm, params, device="cpu", **kw)


def _toy_model():
    """Constant-logits model: argmax(params['x']) regardless of input — the
    emitted token IS the param version. The cache records every written
    token, so the masked commit is exercised too."""
    layout = FlatLayout([("x", (V,))])

    def decode(params, tokens, caches, cache_pos, commit=None):
        b, s = tokens.shape
        pos = torch.as_tensor(cache_pos).reshape(-1, 1) + torch.arange(s)
        write_rows(caches["written"], tokens.to(torch.int32),
                   pos.expand(b, s), commit)
        logits = params["x"][None, None, :].expand(b, s, V)
        return logits, caches

    return Model(cfg=None, init=None, loss_fn=None, decode=decode,
                 init_cache=lambda b, max_len, device: {
                     "written": torch.zeros((b, max_len), dtype=torch.int32,
                                            device=device)},
                 layout=layout)


def _peaked(token: int, n=N):
    x = np.zeros((n, V), np.float32)
    x[:, token] = 5.0
    return torch.from_numpy(x)


def _per_node_peaked(peaks):
    x = np.zeros((len(peaks), V), np.float32)
    for i, (tok, height) in enumerate(peaks):
        x[i, tok] = height
    return torch.from_numpy(x)


def _policy(batch=(1,), seq=(8,)):
    return BucketPolicy(batch_buckets=batch, seq_buckets=seq)


# ---------------------------------------------------------------------------
# bucket policy + queue (own copies)
# ---------------------------------------------------------------------------

def test_bucket_policy_matches_reference():
    for cls in (BucketPolicy, JBucketPolicy):
        p = cls(batch_buckets=(1, 2, 4), seq_buckets=(8, 16))
        assert p.batch_bucket(1) == 1 and p.batch_bucket(3) == 4
        assert p.seq_bucket(8) == 8 and p.seq_bucket(9) == 16
        with pytest.raises(ValueError):
            p.batch_bucket(5)
        with pytest.raises(ValueError):
            p.seq_bucket(17)
        padded, length = p.pad_prompt(np.arange(1, 6))
        assert padded.tolist() == [1, 2, 3, 4, 5, 0, 0, 0] and length == 5
        with pytest.raises(ValueError):
            cls(batch_buckets=(4, 2))
    assert BucketPolicy() == BucketPolicy(
        **JBucketPolicy().__dict__)


def test_queue_matches_reference():
    for cls in (RequestQueue, JRequestQueue):
        q = cls(now=lambda: 0.0, max_pending=2)
        a = q.submit([1, 2], 4)
        b = q.submit([3], 4, deadline_s=1.0)
        rej = q.submit([5], 1)
        assert rej.status == "rejected" and rej.done
        assert [r.rid for r in q.pending] == [a.rid, b.rid]
        assert [r.rid for r in q.expire(now=2.0)] == [b.rid]
        assert b.status == "deadline_exceeded"
        assert len(q) == 1 and q.pop() is a
        with pytest.raises(ValueError):
            q.submit([], 4)
        with pytest.raises(ValueError):
            q.submit([1], 0)
        with pytest.raises(ValueError):
            cls(max_pending=0)


# ---------------------------------------------------------------------------
# aggregation modes vs the JAX function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", AGG_MODES)
def test_aggregate_matches_reference(mode, masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 7, 11)).astype(np.float32)
    logits[:, 3] = logits[0, 3]            # a slot where every node agrees
    mask = np.array([True, False, True, True, False]) if masked else None
    want = np.asarray(j_aggregate(jnp.asarray(logits), mode, top_k=2,
                                  node_mask=None if mask is None
                                  else jnp.asarray(mask)))
    got = aggregate_logits(torch.from_numpy(logits), mode, top_k=2,
                           node_mask=None if mask is None
                           else torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        aggregate_logits(torch.from_numpy(logits), "vote",
                         node_mask=None if mask is None
                         else torch.from_numpy(mask))


def test_consensus_majority_beats_confidence():
    logits = np.zeros((3, 1, V), np.float32)
    logits[0, 0, 3] = 2.0
    logits[1, 0, 3] = 2.0
    logits[2, 0, 9] = 50.0
    out = aggregate_logits(torch.from_numpy(logits), "consensus")
    assert (out == 3).all()


# ---------------------------------------------------------------------------
# the engine against host generate and against the JAX engine
# ---------------------------------------------------------------------------

def test_engine_matches_host_generate():
    """Identical-replica consensus through the engine == host-loop greedy
    decode, token for token; and == the reference's generate."""
    jm, tm = _models(vocab_size=64)
    tree1, flat1 = _stacked(jm, tm, n=1)
    eng = _engine(tm, flat1.expand(N, -1).contiguous(), mode="consensus",
                  max_len=32, max_slots=2, policy=_policy((1, 2), (8, 16)))
    prompt = np.arange(1, 8) % 64
    req = eng.submit(prompt, max_new=6)
    eng.drain()
    ref = generate(tm, flat1[0], torch.from_numpy(prompt)[None], 6, 32,
                   device="cpu")[0]
    assert req.tokens == ref.tolist()
    assert all((v == v[0]).all() for v in req.node_tokens)
    from repro.launch.serve import generate as jgenerate
    jref = np.asarray(jgenerate(jm, jax.tree.map(lambda x: x[0], tree1),
                                jnp.asarray(prompt)[None], 6, 32))[0]
    assert req.tokens == jref.tolist()


def _streams(eng, prompts, max_new, stagger):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts[:stagger]]
    eng.step()
    reqs += [eng.submit(p, max_new=max_new) for p in prompts[stagger:]]
    eng.drain()
    return [[np.asarray(v).tolist() for v in r.node_tokens] for r in reqs]


@pytest.mark.parametrize("arch,mode", [("minicpm-2b", "consensus"),
                                       ("minicpm-2b", "per_node"),
                                       ("hymba-1.5b", "average")])
def test_token_streams_equal_jax_engine(arch, mode):
    """The port engine's per-node token streams equal the JAX engine's on
    the reference's seeds, under continuous batching with staggered
    admission. Hymba (recurrent state) is served with prompt lengths equal
    to its seq buckets, as pads would enter its state."""
    kw = dict(vocab_size=64) if arch == "minicpm-2b" else {}
    jm, tm = _models(arch, **kw)
    tree, flat = _stacked(jm, tm)
    if arch == "hymba-1.5b":
        prompts = [np.arange(1, 1 + n) % 64 for n in (8, 16, 8)]
    else:
        prompts = [np.arange(1, 1 + n) % 64 for n in (5, 9, 3, 7)]
    policy = dict(batch_buckets=(1, 2, 4), seq_buckets=(8, 16))
    jeng = JServeEngine(jm, tree, mode=mode, max_len=32, max_slots=4,
                        policy=JBucketPolicy(**policy))
    teng = _engine(tm, flat, mode=mode, max_len=32, max_slots=4,
                   policy=BucketPolicy(**policy))
    assert _streams(teng, prompts, 5, 2) == _streams(jeng, prompts, 5, 2)


def test_continuous_batching_is_isolation_preserving():
    jm, tm = _models(vocab_size=64)
    _, params = _stacked(jm, tm)
    prompts = [np.arange(1, 1 + n) % 64 for n in (5, 9, 3, 7)]
    solo = []
    for p in prompts:
        eng = _engine(tm, params, mode="average", max_len=32, max_slots=1,
                      policy=_policy((1,), (8, 16)))
        req = eng.submit(p, max_new=5)
        eng.drain()
        solo.append(req.tokens)
    eng = _engine(tm, params, mode="average", max_len=32, max_slots=4,
                  policy=_policy((1, 2, 4), (8, 16)))
    first = [eng.submit(p, max_new=5) for p in prompts[:2]]
    eng.step()
    later = [eng.submit(p, max_new=5) for p in prompts[2:]]
    eng.drain()
    assert [r.tokens for r in first + later] == solo


def test_steady_state_serving_stays_on_the_bucket_grid():
    """A second wave through already-used shapes dispatches no new
    (kind, shape) key, and every key lies on the bucket grid."""
    jm, tm = _models(vocab_size=64)
    _, params = _stacked(jm, tm)
    eng = _engine(tm, params, max_len=32, max_slots=2,
                  policy=_policy((1, 2), (8,)))
    for wave in range(2):
        for n in (4, 6, 5):
            eng.submit(np.arange(1, 1 + n), max_new=4)
        eng.drain()
        if wave == 0:
            warm = dict(eng.trace_counts)
    assert dict(eng.trace_counts) == warm
    grid = {("decode", b) for b in (1, 2)} | {("prefill", 8, b)
                                              for b in (1, 2)}
    assert set(warm) <= grid and all(v == 1 for v in warm.values())


def _fresh_lane(tm, params, padded, max_len):
    """One node's cache after a prefill of ``padded`` on a fresh lane."""
    lane = tm.init_cache(1, max_len, "cpu")
    tm.decode(tm.layout.unflatten(params), torch.from_numpy(
        padded.astype(np.int64))[None], lane, 0)
    return tree_leaves(lane)


def test_prefill_program_serves_other_slots_and_lengths():
    """The prefill program built at slot 0 and length L, dispatched again
    at slot 1 and length L' < L (same seq bucket): it writes lane 1 (and
    leaves lane 0), and both first tokens equal the JAX engine's."""
    jm, tm = _models(vocab_size=64)
    tree, flat = _stacked(jm, tm)
    prompts = [np.arange(1, 8) % 64, np.arange(5, 9) % 64]   # L 7, L' 4
    policy = dict(batch_buckets=(2,), seq_buckets=(8,))
    jeng = JServeEngine(jm, tree, max_len=32, max_slots=2,
                        policy=JBucketPolicy(**policy))
    teng = _engine(tm, flat, max_len=32, max_slots=2,
                   policy=BucketPolicy(**policy))
    reqs = []
    for eng in (jeng, teng):
        reqs.append([eng.submit(p, max_new=4) for p in prompts])
        eng._admit([])                     # the two prefills, no decode
    assert [r.node_tokens[0].tolist() for r in reqs[1]] \
        == [np.asarray(r.node_tokens[0]).tolist() for r in reqs[0]]
    assert teng._live.tolist() == [True, True]
    assert dict(teng.trace_counts) == {("prefill", 8, 2): 1}
    assert teng.programs[("prefill", 8, 2), 0].eager_calls == 2
    for slot, prompt in enumerate(prompts):
        padded, _ = teng.policy.pad_prompt(prompt)
        for n in range(N):
            want = _fresh_lane(tm, flat[n], padded, 32)
            got = [t[n, slot] for t in tree_leaves(teng._table)]
            assert all(torch.equal(g, w[0]) for g, w in zip(got, want))


def test_cache_table_storage_is_fixed_across_grow_and_shrink():
    """The cache table is allocated once at the bucket ``max_slots`` needs;
    growing and shrinking the bucket moves no storage."""
    jm, tm = _models(vocab_size=64)
    _, params = _stacked(jm, tm)
    eng = _engine(tm, params, max_len=32, max_slots=4,
                  policy=_policy((1, 2, 4), (8,)))
    leaves = tree_leaves(eng._table)
    ptrs = [t.data_ptr() for t in leaves]
    assert all(t.shape[:2] == (N, 4) for t in leaves)
    for n in (4, 6, 5):
        eng.submit(np.arange(1, 1 + n), max_new=3)
    eng.step()
    assert eng._bucket == 4 and eng.live_count == 3
    eng.drain()
    assert eng._bucket == 1
    assert [t.data_ptr() for t in tree_leaves(eng._table)] == ptrs


def test_hot_swap_slot_pool_keeps_addresses():
    """Buffer 0 adopts the constructor's tensor; ``publish`` copies into a
    buffer no version holds, and the pool grows only when every buffer is
    held (a swap during a swap); addresses never move."""
    first = _peaked(3)
    slot = HotSwapSlot(first)
    assert len(slot.pool) == 2 and slot.pool[0] is first
    ptrs = [b.data_ptr() for b in slot.pool]
    v1 = slot.publish(_peaked(9))
    assert slot.index(v1) == 1 and slot.live.data_ptr() == ptrs[1]
    slot.retire(pinned=[])
    v2 = slot.publish(_peaked(5))                  # back into buffer 0
    assert slot.index(v2) == 0 and len(slot.pool) == 2
    v3 = slot.publish(_peaked(7))                  # v1, v2 held: grow
    assert slot.index(v3) == 2 and len(slot.pool) == 3
    assert [b.data_ptr() for b in slot.pool[:2]] == ptrs
    assert [int(slot.buffer(v).argmax(-1)[0]) for v in slot.versions] \
        == [9, 5, 7]
    slot.retire(pinned=[v1])                       # v2 dropped
    assert slot.versions == (v1, v3)
    v4 = slot.publish(_peaked(2))
    assert slot.index(v4) == 0 and len(slot.pool) == 3
    assert torch.equal(slot.live, _peaked(2))


def test_trace_counts_equal_builds():
    """``trace_counts[key]`` counts builds: one per key on the grid, each
    on every pool buffer; a swap during a swap grows the pool, and a key
    dispatched on the new buffer is built again."""
    eng = _engine(_toy_model(), _peaked(3), mode="consensus", max_len=32,
                  max_slots=2, policy=_policy((1, 2), (8,)))
    eng.submit([1, 2, 3], max_new=2)
    eng.submit([4, 5], max_new=2)
    eng.drain()
    warm = dict(eng.trace_counts)
    assert warm == {("prefill", 8, 1): 1, ("prefill", 8, 2): 1,
                    ("decode", 2): 1}
    assert set(eng.programs) == {(k, i) for k in warm for i in (0, 1)}
    old = eng.submit([1, 2, 3], max_new=5)
    eng.step()
    eng.swap(_peaked(9))                  # into buffer 1
    v2 = eng.swap(_peaked(5))             # v0 and v1 held: buffer 2
    assert eng.slot.index(v2) == 2
    new = eng.submit([6, 7], max_new=3)
    eng.drain()
    assert old.tokens == [3] * 5 and new.tokens == [5] * 3
    assert dict(eng.trace_counts) == {("prefill", 8, 1): 1,
                                      ("prefill", 8, 2): 2,
                                      ("decode", 1): 1, ("decode", 2): 2}
    assert sum(eng.trace_counts.values()) == len(
        {(k, i) for k, i in eng.programs if i < 2}) // 2 + len(
        [1 for k, i in eng.programs if i == 2])


# ---------------------------------------------------------------------------
# hot-swap
# ---------------------------------------------------------------------------

def test_hot_swap_slot_is_double_buffered():
    slot = HotSwapSlot(_peaked(3))
    assert slot.version == 0 and slot.versions == (0,)
    v1 = slot.publish(_peaked(9))
    assert (slot.version, slot.versions) == (1, (0, 1))
    assert slot.live.argmax(-1).tolist() == [9] * N
    slot.retire(pinned=[0])
    assert slot.versions == (0, 1)
    slot.retire(pinned=[])
    assert slot.versions == (v1,)
    with pytest.raises(ValueError):
        slot.publish(torch.zeros((N, V + 1)))
    with pytest.raises(ValueError):
        slot.publish(torch.zeros((N, V), dtype=torch.float64))


def _toy_checkpoint(tmp_path, source):
    """A training swarm whose params peak at token 9, checkpointed by the
    reference's or the port's ``SwarmSession.save``."""
    path = str(tmp_path / f"{source}.msgpack")
    if source == "jax":
        def train_step(params, opt_state, batch, step):
            return ({"x": params["x"] + batch}, opt_state,
                    {"loss": jnp.sum(batch)})

        sess = JSession(JSwarmConfig(n_nodes=N, sync_every=1, merge="mean",
                                     topology="full"),
                        train_step, lambda p, v: 1.0 - 0.0 * jnp.sum(p["x"]),
                        params={"x": jnp.asarray(_peaked(9).numpy())},
                        stacked=True)
    else:
        sess = SwarmSession(
            SwarmConfig(n_nodes=N, sync_every=1, merge="mean",
                        topology="full"),
            lambda p, o, b, s: (p, o, {}), lambda p, v: torch.ones(N),
            params=list(_peaked(9)), layout=FlatLayout([("x", (V,))]),
            device="cpu")
    sess.save(path)
    return path


@pytest.mark.parametrize("source", ["port", "jax"])
def test_hot_swap_under_load(tmp_path, source):
    """A mid-flight swap from a real ``session.save`` checkpoint: no new
    dispatch shape, one param version per request, the live ensemble
    bit-identical to the checkpoint, no dropped request."""
    eng = _engine(_toy_model(), _peaked(3), mode="consensus", max_len=32,
                  max_slots=2, policy=_policy((1, 2), (8,)))
    eng.submit([1, 2, 3], max_new=3)
    eng.drain()
    eng.submit([1, 2, 3], max_new=3)
    eng.submit([1, 2], max_new=3)
    eng.drain()
    warm = dict(eng.trace_counts)

    old = eng.submit([1, 2, 3, 4], max_new=6)
    eng.step()
    assert eng.live_count == 1
    ckpt = _toy_checkpoint(tmp_path, source)
    v1 = eng.ingest_checkpoint(ckpt)
    assert v1 == 1 and eng.slot.versions == (0, 1)
    new = eng.submit([5, 6], max_new=4)
    eng.step()
    assert eng.live_count == 2
    done = eng.drain()
    assert {r.rid for r in done} == {old.rid, new.rid}
    assert old.param_version == 0 and old.tokens == [3] * 6
    assert new.param_version == 1 and new.tokens == [9] * 4
    assert dict(eng.trace_counts) == warm
    assert torch.equal(eng.slot.live, _peaked(9))
    assert eng.slot.versions == (1,)


def test_ingest_of_a_jax_bf16_lm_checkpoint(tmp_path):
    """A reference ``SwarmSession.save`` of a bf16 LM ensemble hot-swaps in
    bit for bit: bf16 leaves by their bits, and the SSM's f32 A_log, D and
    dt_bias (which the reference keeps in f32) unrounded."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jm, tm = _models("hymba-1.5b", **bf16)
    tree = jax.vmap(jm.init)(jax.random.split(jax.random.key(4), N))
    # values a bf16 rounding would change
    tree["layers"]["ssm"]["A_log"] = tree["layers"]["ssm"]["A_log"] + 1e-3
    sess = JSession(JSwarmConfig(n_nodes=N, sync_every=1, merge="mean",
                                 topology="full"),
                    lambda p, o, b, s: (p, o, {"loss": 0.0}),
                    lambda p, v: 1.0, params=tree, stacked=True)
    path = str(tmp_path / "lm_bf16.msgpack")
    sess.save(path)
    want = lm_params_from_reference(tm.layout,
                                    jax.tree.map(np.asarray, tree), lead=1)
    slot = HotSwapSlot(torch.zeros_like(want), layout=tm.layout)
    assert slot.ingest(path, expect_nodes=N) == 1
    assert torch.equal(slot.live.view(torch.int16), want.view(torch.int16))
    a_log = tm.layout.unflatten(slot.live)["layers.ssm.A_log"]
    assert a_log.dtype == torch.float32
    np.testing.assert_array_equal(
        a_log.numpy(), np.asarray(tree["layers"]["ssm"]["A_log"]))


def test_swap_of_an_lm_ensemble_mid_flight():
    """swap() of a second LM ensemble while a request is in flight: the
    request finishes on its pinned version, a new one runs on the new."""
    jm, tm = _models(vocab_size=64)
    _, a = _stacked(jm, tm, seed=0)
    _, b = _stacked(jm, tm, seed=1)
    prompt = np.arange(1, 8) % 64

    def solo(params):
        eng = _engine(tm, params, max_len=32, max_slots=1,
                      policy=_policy((1,), (8,)))
        r = eng.submit(prompt, max_new=5)
        eng.drain()
        return r.tokens

    eng = _engine(tm, a, max_len=32, max_slots=2, policy=_policy((1, 2), (8,)))
    first = eng.submit(prompt, max_new=5)
    eng.step()
    assert eng.swap(b) == 1
    second = eng.submit(prompt, max_new=5)
    eng.drain()
    assert first.tokens == solo(a) and second.tokens == solo(b)
    assert (first.param_version, second.param_version) == (0, 1)


# ---------------------------------------------------------------------------
# degradation: deadlines, backpressure, lane crashes, guard rails
# ---------------------------------------------------------------------------

def test_status_lifecycle_and_backpressure():
    eng = _engine(_toy_model(), _peaked(3), max_len=32, max_slots=1,
                  policy=_policy(), max_pending=1)
    ok = eng.submit([1, 2], max_new=3)
    rej = [eng.submit([3, 4], max_new=2) for _ in range(2)]
    assert ok.status == "pending" and not ok.done
    assert all(r.status == "rejected" and r.done for r in rej)
    assert all(r.finish_t == r.submit_t and r.tokens == [] for r in rej)
    assert [r.rid for r in eng.completed] == [r.rid for r in rej]
    eng.step()
    assert ok.status == "live"
    done = eng.drain()
    assert [r.rid for r in done] == [ok.rid] and ok.status == "done"


def test_deadlines_queued_and_mid_decode():
    t = [0.0]
    eng = _engine(_toy_model(), _peaked(3), max_len=32, max_slots=1,
                  policy=_policy(), now=lambda: t[0])
    queued = eng.submit([1, 2], max_new=4, deadline_s=1.0)
    t[0] = 2.0
    assert [r.rid for r in eng.step()] == [queued.rid]
    assert queued.status == "deadline_exceeded" and queued.tokens == []
    req = eng.submit([1, 2], max_new=10, deadline_s=1.0)
    eng.step()
    emitted = len(req.tokens)
    assert req.status == "live" and emitted >= 1
    t[0] = 3.5
    assert [r.rid for r in eng.step()] == [req.rid]
    assert req.status == "deadline_exceeded" and len(req.tokens) == emitted
    assert eng.live_count == 0
    nxt = eng.submit([3, 4], max_new=2)
    eng.drain()
    assert nxt.status == "done"
    with pytest.raises(ValueError):
        eng.submit([1], max_new=1, deadline_s=0.0)


def test_drain_timeout_names_stuck_work():
    eng = _engine(_toy_model(), _peaked(3), max_len=64, max_slots=1,
                  policy=_policy())
    live = eng.submit([1, 2], max_new=50)
    queued = eng.submit([3, 4], max_new=50)
    with pytest.raises(TimeoutError) as exc:
        eng.drain(max_ticks=3)
    msg = str(exc.value)
    assert f"(0, {live.rid})" in msg and str(queued.rid) in msg


def test_node_crash_reaggregates_consensus_mid_flight():
    eng = _engine(_toy_model(),
                  _per_node_peaked([(3, 5.0), (3, 5.0), (9, 4.0)]),
                  mode="consensus", max_len=32, max_slots=1, policy=_policy())
    eng.submit([1, 2, 3], max_new=2)
    eng.drain()
    warm = dict(eng.trace_counts)
    req = eng.submit([1, 2, 3], max_new=6)
    eng.step()
    assert req.tokens == [3, 3]
    eng.fail_node(0)
    eng.fail_node(1)
    assert eng.node_mask.tolist() == [False, False, True]
    eng.step()
    eng.restore_node(0)
    eng.drain()
    assert req.status == "done" and req.tokens == [3, 3, 9, 3, 3, 3]
    assert dict(eng.trace_counts) == warm


def test_guard_rails():
    model = _toy_model()
    eng = _engine(model, _peaked(3), max_len=10, max_slots=1,
                  policy=_policy())
    with pytest.raises(ValueError, match="at least one"):
        eng.set_node_mask([False] * N)
    with pytest.raises(ValueError, match="entries"):
        eng.set_node_mask([True] * (N + 1))
    mask = eng.node_mask
    mask[0] = False
    assert eng.node_mask.all()
    with pytest.raises(ValueError):
        eng.submit(np.arange(9), max_new=1)
    with pytest.raises(ValueError):
        eng.submit(np.arange(8), max_new=3)
    with pytest.raises(ValueError):
        _engine(model, _peaked(1), max_slots=4, policy=_policy((1, 2)))
    with pytest.raises(ValueError):
        _engine(model, _peaked(1), mode="vote")
