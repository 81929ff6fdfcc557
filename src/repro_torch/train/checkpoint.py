"""Checkpointing into the object store (a port of
``repro.train.checkpoint``).

Each leaf goes in as a raw npy blob under ``ckpt:<tag>/<step>/<leaf key>``,
with a manifest tying the step to the leaf set and ``ckpt:<tag>/LATEST``
naming the newest step. Leaf keys, manifest and blobs are the reference's
byte for byte: a key is ``"/".join(str(p) for p in path)`` of
``jax.tree_util.tree_flatten_with_path``, e.g. ``['blocks']/['p0']/['wq']``,
leaves in sorted key order; a bfloat16 leaf is stored as float32 (which
holds every bf16 value exactly) with ``"bfloat16"`` in the manifest's
``dtypes``. So a checkpoint written by either package restores in the
other, given the blobs in its store.
"""
from __future__ import annotations

import io
import json
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.storage import ObjectStore
from repro_torch.models.param import map_tree


def _leaf_key(tag: str, step: int, path: str) -> str:
    return f"ckpt:{tag}/{step}/{path}"


def _flat(tree, keys: Tuple[str, ...] = ()) -> Iterator[Tuple[str, str, Any]]:
    """(reference leaf key, '/'-joined tree path, leaf) in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], keys + (k,))
        else:
            path = keys + (k,)
            yield "/".join(f"[{p!r}]" for p in path), "/".join(path), tree[k]


def save(store: ObjectStore, tag: str, step: int, tree: Any) -> str:
    """Put every leaf of ``tree`` (nested dicts of tensors) and the
    manifest; returns the manifest's key."""
    manifest = {"step": step, "leaves": [], "dtypes": {}}
    for pstr, _, leaf in _flat(tree):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:   # upcast losslessly
            manifest["dtypes"][pstr] = "bfloat16"
            t = t.float()
        buf = io.BytesIO()
        np.save(buf, t.numpy(), allow_pickle=False)
        store.put(buf.getvalue(), key=_leaf_key(tag, step, pstr))
        manifest["leaves"].append(pstr)
    key = f"ckpt:{tag}/{step}/MANIFEST"
    store.put(json.dumps(manifest).encode(), key=key)
    store.put(json.dumps({"latest": step}).encode(), key=f"ckpt:{tag}/LATEST")
    return key


def latest_step(store: ObjectStore, tag: str) -> Optional[int]:
    key = f"ckpt:{tag}/LATEST"
    if key not in store:
        return None
    return json.loads(store.get_raw(key).decode())["latest"]


def restore(store: ObjectStore, tag: str, step: int, like: Any) -> Any:
    """Restore into the structure, dtypes and devices of ``like`` (nested
    dicts of tensors)."""
    got = {}
    for pstr, path, proto in _flat(like):
        raw = store.get_raw(_leaf_key(tag, step, pstr))
        arr = np.load(io.BytesIO(raw), allow_pickle=False)
        got[path] = torch.from_numpy(arr).to(device=proto.device,
                                             dtype=proto.dtype)
    return map_tree(lambda path, _: got[path], like)
