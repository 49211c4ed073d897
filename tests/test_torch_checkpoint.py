"""Session checkpoints of the port in the reference's msgpack layout: a
port save restores in the reference and a reference save in the port, leaf
for leaf and bit for bit (params, AdamW moments, fisher statistics, the
int8 wire reference, membership, rng, counters); save → restore → more
rounds is bit-identical to never stopping; and the port's own msgpack codec
agrees byte for byte with the ``msgpack`` package."""
import os

import jax
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.core.session import SwarmSession as JSession  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.checkpointing import codec, io  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core.session import (SwarmSession,  # noqa: E402
                                      load_checkpoint_params)
from repro_torch.optim import adamw_init  # noqa: E402

tp.torch_cpu()
KW = dict(n_nodes=4, sync_every=2, topology="ring", merge="fisher",
          lora_only=False, val_threshold=0.8, wire_dtype="int8",
          wire_block=128)


def _keyed(tree):
    """{keystr: numpy leaf} of a reference pytree."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_state(js_state, ts, layout):
    """The port's state equals the reference's, leaf for leaf, in bits."""
    want = _keyed(js_state)
    got = {io._key(path): np.asarray(v)
           for path, v in io._walk(ts._checkpoint_tree(ts.state), ())}
    assert set(got) == set(want) and len(want) > 50
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert got[key].shape == value.shape, key
        assert got[key].tobytes() == value.tobytes(), key


def _port_restore(path, kw=KW):
    _, _, ttrain, teval, layout = tp.session_fns()
    flat = from_reference(layout, tp.jax_params(0, tp.WIDTHS))
    cfg = SwarmConfig(**kw)
    return SwarmSession.restore(path, cfg, ttrain, teval(cfg), params=flat,
                                opt_state=adamw_init(flat),
                                data_sizes=tp.SIZES, layout=layout,
                                device="cpu"), layout


def _rounds(sess, data, rounds, jax_side=False):
    xs, ys, val = data
    for r in rounds:
        batch = (xs[r], ys[r])
        if jax_side:
            batch = tuple(jax.numpy.asarray(b) for b in batch)
            val = tuple(jax.numpy.asarray(v) for v in val)
        sess.round(batch, val)


def test_port_save_restores_in_the_reference(tmp_path):
    js, ts, layout = tp.sessions(KW, seed=1)
    _rounds(ts, tp.round_data(7, t=2, r=1), [0])
    ts.leave(3)
    path = str(tmp_path / "port.msgpack")
    ts.save(path)
    jtrain, jeval, _, _, _ = tp.session_fns()
    tree = tp.jax_params(1, tp.WIDTHS)
    restored = JSession.restore(path, JSwarmConfig(**KW), jtrain, jeval,
                                params=tree, opt_state=jadamw_init(tree),
                                data_sizes=tp.SIZES)
    _assert_same_state(restored.state, ts, layout)
    assert restored.active.tolist() == [True, True, True, False]
    assert int(restored.state.round) == 1 and int(restored.state.step) == 2


def test_reference_save_restores_in_the_port(tmp_path):
    js, _, layout = tp.sessions(KW, seed=2)
    _rounds(js, tp.round_data(8, t=2, r=2), [0, 1], jax_side=True)
    js.leave(0)
    path = str(tmp_path / "ref.msgpack")
    js.save(path)
    ts, _ = _port_restore(path)
    _assert_same_state(js.state, ts, layout)
    np.testing.assert_array_equal(ts.state.rng, np.asarray(js.state.rng))
    assert ts.state.round == 2 and ts.state.step == 4
    assert ts.active.tolist() == [False, True, True, True]


def test_save_restore_continue_is_bit_identical(tmp_path):
    """save → restore → 2 more rounds == 4 uninterrupted rounds, the wire
    reference, the fisher stats and the AdamW moments included."""
    data = tp.round_data(9, t=2, r=4)
    _, straight, _ = tp.sessions(KW, seed=3)
    _rounds(straight, data, range(4))
    _, first, _ = tp.sessions(KW, seed=3)
    _rounds(first, data, range(2))
    path = str(tmp_path / "mid.msgpack")
    first.save(path)
    resumed, _ = _port_restore(path)
    _rounds(resumed, data, range(2, 4))
    a, b = straight.state, resumed.state
    for field in ("params", "stats", "wire", "active"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    for k in ("mu", "nu", "count"):
        assert torch.equal(a.opt_state[k], b.opt_state[k]), k
    assert (a.round, a.step) == (b.round, b.step) == (4, 8)
    np.testing.assert_array_equal(a.rng, b.rng)


def test_load_checkpoint_params_and_cfg_refusal(tmp_path):
    _, ts, layout = tp.sessions(KW, seed=4)
    path = str(tmp_path / "serve.msgpack")
    ts.save(path)
    params = load_checkpoint_params(path, torch.zeros_like(ts.state.params),
                                    layout=layout, expect_nodes=4)
    assert torch.equal(params, ts.state.params)
    with pytest.raises(ValueError, match="n_nodes=4"):
        load_checkpoint_params(path, ts.state.params, layout=layout,
                               expect_nodes=8)
    with pytest.raises(ValueError, match="wire_dtype"):
        _port_restore(path, dict(KW, wire_dtype="bf16"))


def test_single_leaf_session_round_trip(tmp_path):
    """Without a layout the params are one ``.params`` array."""
    cfg = SwarmConfig(n_nodes=4, merge="fedavg", topology="full",
                      lora_only=False, wire_dtype="int8", wire_block=128)
    sess = SwarmSession(cfg, None, None, params=torch.arange(6.0),
                        device="cpu")
    sess.quarantine_wire()
    path = str(tmp_path / "flat.msgpack")
    sess.save(path)
    leaves = io._read_payload(path)["leaves"]
    assert {".params", ".wire", ".active", ".rng", ".round",
            ".step"} == set(leaves)
    back = load_checkpoint_params(path, torch.zeros(4, 6))
    assert torch.equal(back, sess.state.params)


def test_legacy_slash_keys_still_load(tmp_path):
    _, ts, layout = tp.sessions(KW, seed=5)
    path = str(tmp_path / "legacy.msgpack")
    ts.save(path)
    payload = io._read_payload(path)
    legacy = {}
    for key, entry in payload["leaves"].items():
        parts = key.replace("][", "/").replace("[", "/").replace("]", "")
        legacy[parts.replace("'", "")] = entry
    assert ".params/blocks/0/layers/1/bn/scale" in legacy
    with open(path, "wb") as f:
        f.write(codec.packb({"leaves": legacy,
                             "metadata": payload["metadata"]}))
    resumed, _ = _port_restore(path)
    assert torch.equal(resumed.state.params, ts.state.params)
    assert torch.equal(resumed.state.wire, ts.state.wire)


def test_corrupt_files_raise_and_writes_are_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / "c.msgpack")
    io.save_pytree(path, {"w": np.arange(4.0)}, metadata={"v": 1})
    good = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(good[: len(good) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        io.load_metadata(path)
    with open(path, "wb") as f:
        f.write(codec.packb([1, 2, 3]))
    with pytest.raises(ValueError, match="envelope"):
        io.load_metadata(path)
    with open(path, "wb") as f:
        f.write(good)

    def torn(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(io.os, "replace", torn)
    with pytest.raises(Exception, match="disk full"):
        io.save_pytree(path, {"w": np.zeros(4)})
    monkeypatch.undo()
    assert open(path, "rb").read() == good      # the old file survives
    assert os.listdir(tmp_path) == ["c.msgpack"]  # and no temp file
    with pytest.raises(ValueError, match="shape mismatch"):
        io.load_pytree(path, {"w": np.zeros(5)})
    with pytest.raises(FileNotFoundError):
        io.load_metadata(str(tmp_path / "missing.msgpack"))


OBJECTS = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63), 0.0, -1.5, 3.0e300, 1e-310,
    "", "a" * 31, "b" * 32, "é" * 200, "c" * 70000, b"", b"x" * 255,
    b"y" * 256, b"z" * 70000, list(range(15)), list(range(16)),
    list(range(70000)), {str(i): i for i in range(15)},
    {str(i): [i, {"k": b"v"}] for i in range(16)},
    {"leaves": {".params['w']": {"dtype": "float32", "shape": [4, 3],
                                 "data": np.arange(12, dtype=np.float32)
                                 .tobytes()}},
     "metadata": {"cfg": {"lora_alpha": 32.0, "overlap_sync": False},
                  "format": 1}},
]


@pytest.mark.parametrize("obj", OBJECTS, ids=range(len(OBJECTS)))
def test_codec_matches_the_msgpack_package(obj):
    ours = codec.packb(obj)
    assert ours == msgpack.packb(obj, use_bin_type=True)
    assert msgpack.unpackb(ours, raw=False) == obj
    assert codec.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


def test_codec_reads_single_floats_and_rejects_the_rest():
    assert codec.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    assert codec.packb((1, 2)) == msgpack.packb((1, 2))
    with pytest.raises(ValueError, match="type byte"):
        codec.unpackb(msgpack.packb(msgpack.ExtType(1, b"ab")))
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(codec.packb({"a": b"x" * 300})[:-1])
    with pytest.raises(ValueError, match="trailing"):
        codec.unpackb(codec.packb(1) + b"\x00")
    with pytest.raises(TypeError):
        codec.packb({"a": {1, 2}})
