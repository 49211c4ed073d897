"""Msgpack checkpoints in the reference's file layout.

Port of ``repro.checkpointing.io``. One ``<name>.msgpack`` file holds

    {"leaves": {keypath: {"dtype": str, "shape": [int], "data": bin}},
     "metadata": {...}}

packed with ``use_bin_type=True``. Keys are the strings
``jax.tree_util.keystr`` gives the reference's leaves (``.params['stem']
['w']``, ``['a'][0]``): a tree here is nested dicts (``['key']``), lists or
tuples (``[i]``) and :class:`Fields` (a dataclass's fields, ``.name``),
with numpy arrays as leaves; a None subtree has no leaves. So a file written
here loads in the reference and the other way round. Legacy files whose
keys are ``/``-joined still load.

Writes are atomic (a temp file in the destination directory, fsync,
``os.replace``), so a crash mid-save leaves the previous checkpoint or the
new one, never a torn file. Reads and writes retry transient ``OSError`` s
with bounded backoff (`repro_torch.faults.retry`); a truncated or foreign
file raises ``ValueError``. The codec is the port's own
(`repro_torch.checkpointing.codec`): the ``msgpack`` package is not needed.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np

from repro_torch.checkpointing import codec
from repro_torch.faults.retry import with_retry


class Fields(dict):
    """A dataclass's fields in a checkpoint tree: its keys print as
    attributes (``.params``), as ``jax.tree_util.keystr`` prints a
    registered dataclass's fields, in the order given."""


def _walk(tree, path: Tuple) -> Iterator[Tuple[Tuple, Any]]:
    """(key path, leaf) pairs in the reference's flatten order: dict keys
    sorted, sequence entries by index, dataclass fields in field order."""
    if tree is None:
        return
    if isinstance(tree, Fields):
        for name, sub in tree.items():
            yield from _walk(sub, path + (("attr", name),))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], path + (("key", key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _walk(sub, path + (("idx", i),))
    else:
        yield path, tree


def _key(path) -> str:
    """``jax.tree_util.keystr`` of a key path."""
    out = []
    for kind, k in path:
        out.append(f".{k}" if kind == "attr" else f"[{k!r}]")
    return "".join(out)


def _legacy_key(path) -> str:
    """The pre-keystr ``/``-joined key format (read-only)."""
    return "/".join(f".{k}" if kind == "attr" else str(k) for kind, k in path)


def _flatten(tree) -> dict:
    flat = {}
    for path, leaf in _walk(tree, ()):
        key = _key(path)
        if key in flat:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        arr = np.asarray(leaf)
        flat[key] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                     "data": arr.tobytes()}
    return flat


def _atomic_write_bytes(path: str, blob: bytes) -> None:
    """Write-all-or-nothing: temp file in the SAME directory (so the final
    rename never crosses a filesystem), flush + fsync, then `os.replace`
    over the destination. Readers only ever observe a complete file."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_pytree(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Write ``tree`` (numpy leaves) and ``metadata`` to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blob = codec.packb({"leaves": _flatten(tree), "metadata": metadata or {}})
    with_retry(lambda: _atomic_write_bytes(path, blob), retry_on=(OSError,),
               describe=f"checkpoint write {path!r}")


def _read_payload(path: str) -> dict:
    """Read + decode a checkpoint file with transient-IO retry and a clear
    error for truncated/corrupt/non-checkpoint content."""
    def read() -> bytes:
        with open(path, "rb") as f:
            return f.read()

    blob = with_retry(read, retry_on=(OSError,), raise_last=True,
                      describe=f"checkpoint read {path!r}")
    try:
        payload = codec.unpackb(blob)
    except (ValueError, KeyError, TypeError, IndexError) as exc:
        raise ValueError(
            f"corrupt or truncated checkpoint {path!r}: not a complete "
            f"msgpack payload ({type(exc).__name__}: {exc}). Writes are "
            "atomic (temp-file + os.replace), so a torn file usually means "
            "a partial copy or an interrupted legacy writer") from exc
    if not isinstance(payload, dict) or "leaves" not in payload \
            or "metadata" not in payload:
        raise ValueError(
            f"corrupt or truncated checkpoint {path!r}: decoded payload is "
            "missing the leaves/metadata envelope")
    return payload


def _entry_array(entry: dict) -> np.ndarray:
    return np.frombuffer(entry["data"], dtype=entry["dtype"]).reshape(
        entry["shape"])


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (numpy leaves, shapes
    checked); leaves come back as numpy arrays of the saved dtype."""
    leaves: Dict[str, dict] = _read_payload(path)["leaves"]

    def restore(tree, p):
        if tree is None:
            return None
        if isinstance(tree, Fields):
            return Fields((name, restore(sub, p + (("attr", name),)))
                          for name, sub in tree.items())
        if isinstance(tree, dict):
            return {k: restore(sub, p + (("key", k),))
                    for k, sub in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(restore(sub, p + (("idx", i),))
                              for i, sub in enumerate(tree))
        key = _key(p)
        entry = leaves.get(key)
        if entry is None:
            entry = leaves.get(_legacy_key(p))
        if entry is None:
            raise KeyError(f"checkpoint {path!r} has no leaf {key!r}")
        want = list(np.shape(tree))
        if want != list(entry["shape"]):
            raise ValueError(f"shape mismatch at {key}: {tuple(want)} vs "
                             f"{tuple(entry['shape'])}")
        return _entry_array(entry)

    return restore(like, ())


def load_metadata(path: str) -> dict:
    return _read_payload(path)["metadata"]


def save_json(path: str, obj: Any) -> None:
    """A copy of the reference's ``save_json`` (indent 2, numbers through
    ``float``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=float)
