"""Checkpoint/resume for env + trainer state as one ``.npz`` file.

The reference's only persistence is a final ``torch.save`` of the SAC actor
(reference: src/SAL.py:1017) and envs are re-seeded rather than snapshotted
(base_classes.py:202).  Here the entire simulation is a pytree, so whole
training runs checkpoint and resume exactly: every leaf is gathered to the
host (across processes too) and written under its key path by process 0,
atomically (temporary file + ``os.replace``), to ``<path>/checkpoint.npz``
(or to ``path`` itself when it ends in ``.npz``); restore reads it back
against a ``like`` template that supplies the tree structure, dtypes and
shardings.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import jax


def _flatten(tree):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(p) for p, _ in leaves], \
        [leaf for _, leaf in leaves], treedef


def _file(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(".npz") else \
        os.path.join(path, "checkpoint.npz")


def _host(leaf):
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(leaf, tiled=True))
    return np.asarray(jax.device_get(leaf))


def _storable(arr: np.ndarray) -> np.ndarray:
    """npz keeps only numpy's own dtypes: bfloat16 and the other ml_dtypes
    are stored as same-width unsigned ints (their name rides __dtypes__)."""
    if type(arr.dtype).__module__.startswith("numpy") \
            and arr.dtype.type.__module__ == "numpy":
        return arr
    return arr.view(f"u{arr.dtype.itemsize}")


def save(path: str, tree: Any, overwrite: bool = True):
    """Save an arbitrary pytree (EnvState batch, PPOState, SACState, ...).
    Returns ``path`` (pass it to :func:`restore`)."""
    f_path = _file(path)
    if os.path.exists(f_path) and not overwrite:
        raise FileExistsError(f_path)
    keys, leaves, _ = _flatten(tree)
    host = [_host(leaf) for leaf in leaves]
    arrays = {f"{i:05d}": _storable(a) for i, a in enumerate(host)}
    arrays["__keys__"] = np.asarray(keys, dtype=str)
    arrays["__dtypes__"] = np.asarray([a.dtype.name for a in host], dtype=str)
    if jax.process_index() == 0:
        os.makedirs(os.path.dirname(f_path), exist_ok=True)
        tmp = f"{f_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, f_path)
    return path


def restore(path: str, like: Any = None) -> Any:
    """Restore a pytree.  With ``like`` (a template with the right
    structure, dtypes and shardings) the result has its structure and each
    leaf is placed like the template's; without it, a flat
    ``{key path: array}`` dict is returned."""
    with np.load(_file(path)) as z:
        keys = [str(k) for k in z["__keys__"]]
        arrays = [z[f"{i:05d}"].view(jax.numpy.dtype(str(dt)))
                  for i, dt in enumerate(z["__dtypes__"])]
    if like is None:
        return dict(zip(keys, arrays))
    want, tmpl, treedef = _flatten(like)
    if want != keys:
        raise ValueError(f"checkpoint {path} does not match the template: "
                         f"{len(keys)} saved leaves vs {len(want)} expected")
    out = []
    for arr, t in zip(arrays, tmpl):
        if isinstance(t, jax.Array):
            arr = arr.astype(t.dtype)
            out.append(jax.make_array_from_callback(
                arr.shape, t.sharding, lambda idx, a=arr: a[idx]))
        elif isinstance(t, np.ndarray):
            out.append(arr.astype(t.dtype))
        else:                      # Python scalars and other plain leaves
            out.append(type(t)(arr.item()) if arr.ndim == 0 else arr)
    return jax.tree_util.tree_unflatten(treedef, out)
