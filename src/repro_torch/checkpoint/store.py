"""Host-snapshot helpers of the sharded checkpoint store.

The peer replicator (``checkpoint.replicate``) snapshots state trees with
these three helpers. The store's on-disk save/restore (the JAX package's
npz format with its bf16 view trick) comes with the trainer slice.

A state tree is a nested ``dict`` / ``list`` / ``tuple`` of torch tensors
or numpy arrays. Leaves are keyed by their '/'-joined path, dict keys in
sorted order and ``None`` subtrees dropped, as the JAX package's
``tree_flatten_with_path`` keys them.
"""
from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

PyTree = Any


def _flatten(tree: PyTree) -> dict[str, Any]:
    flat: dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            flat["/".join(path)] = node

    walk(tree, ())
    return flat


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """Returns (storable host array, logical dtype string). bf16 tensors are
    stored as their uint16 bit patterns, as the JAX package stores them."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]
