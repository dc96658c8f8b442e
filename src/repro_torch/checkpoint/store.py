"""Sharded, per-legion checkpoint store (the §VII / MANA analogue).

The JAX package's on-disk format, file for file, so either package restores
what the other wrote::

    <dir>/step_000120/
        manifest.json                 # step, legion map, dtypes, checksums
        legion_00/member_000.npz      # one file per (legion, member)
        legion_00/member_001.npz
        legion_01/member_000.npz
        ...

  * **No global barrier**: each legion directory is self-contained and
    written independently; the manifest is finalised by an atomic rename.
  * **Restart-only-failed**: ``restore_member`` loads exactly one member's
    shard set; a replacement node never touches other members' files.
  * **Async**: ``AsyncCheckpointer`` snapshots tensors to host memory
    (blocking only on the copy), then writes in a background thread.

A state tree is a nested ``dict`` / ``list`` / ``tuple`` of torch tensors or
numpy arrays. Leaves are stored in npz under their '/'-joined path (dict
keys in sorted order, ``None`` subtrees dropped, as the JAX package's
``tree_flatten_with_path`` keys them). bfloat16 has no numpy dtype, so bf16
leaves are stored as their uint16 bit patterns and the manifest records the
logical dtype; a restore gives them back as bf16 tensors, bit for bit.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import tracing

PyTree = Any


# ---------------------------------------------------------------------------
# pytree <-> flat dict
# ---------------------------------------------------------------------------

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


def _unflatten(template: PyTree, flat: dict[str, Any], path: tuple = ()) -> PyTree:
    """``template``'s structure with each leaf replaced by ``flat[path]``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, path + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = [_unflatten(v, flat, path + (str(i),)) for i, v in enumerate(template)]
        return type(template)(*items) if hasattr(template, "_fields") else type(template)(items)
    return flat["/".join(path)]


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


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    """A host tensor of the logical dtype (bf16 from its bit patterns)."""
    arr = np.array(arr, copy=True, order="C")      # owned and writable, as torch wants
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def _snapshot(x):
    """A host copy of a leaf that later in-place updates cannot reach."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

@dataclass
class CheckpointManifest:
    step: int
    n_legions: int
    members: dict[str, list[int]]          # legion id -> member node ids
    files: dict[str, dict] = field(default_factory=dict)  # relpath -> {dtypes, checksums}
    meta: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "step": self.step,
            "n_legions": self.n_legions,
            "members": self.members,
            "files": self.files,
            "meta": self.meta,
        }, indent=1, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "CheckpointManifest":
        d = json.loads(s)
        return CheckpointManifest(
            step=d["step"], n_legions=d["n_legions"], members=d["members"],
            files=d["files"], meta=d.get("meta", {}),
        )


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:06d}")


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and \
           os.path.exists(os.path.join(directory, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def _write_npz_atomic(path: str, arrays: dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)  # keeps the name: it already ends in .npz
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(
    directory: str,
    step: int,
    shards: dict[tuple[int, int], PyTree],
    *,
    meta: dict | None = None,
    verify: bool = True,
) -> CheckpointManifest:
    """shards: {(legion_id, node_id): state pytree} -> one npz per member."""
    sdir = _step_dir(directory, step)
    os.makedirs(sdir, exist_ok=True)
    members: dict[str, list[int]] = {}
    files: dict[str, dict] = {}
    for (legion, node), tree in sorted(shards.items()):
        members.setdefault(str(legion), []).append(node)
        rel = member_relpath(legion, node)
        arrays: dict[str, np.ndarray] = {}
        dtypes: dict[str, str] = {}
        sums: dict[str, str] = {}
        for key, leaf in _flatten(tree).items():
            arr, logical = _to_numpy(leaf)
            arrays[key] = arr
            dtypes[key] = logical
            if verify:
                sums[key] = _checksum(arr)
        _write_npz_atomic(os.path.join(sdir, rel), arrays)
        files[rel] = {"dtypes": dtypes, "checksums": sums}
    manifest = CheckpointManifest(
        step=step, n_legions=len(members), members=members, files=files,
        meta=meta or {},
    )
    tmp = os.path.join(sdir, ".manifest.tmp")
    with open(tmp, "w") as f:
        f.write(manifest.to_json())
    os.replace(tmp, os.path.join(sdir, "manifest.json"))
    return manifest


def _load_npz(path: str, info: dict, template: PyTree | None, verify: bool) -> PyTree:
    with np.load(path) as z:
        flat = {}
        for key in z.files:
            arr = z[key]
            if verify and info["checksums"]:
                want = info["checksums"].get(key)
                if want and _checksum(arr) != want:
                    raise IOError(f"checksum mismatch for {key} in {path}")
            flat[key] = _from_numpy(arr, info["dtypes"][key])
    if template is None:
        # rebuild a nested dict from '/'-joined keys (only dict-of-dict trees)
        out: dict = {}
        for key, t in flat.items():
            parts = key.split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = t
        return out
    want = set(_flatten(template))
    if want != set(flat):
        raise ValueError(f"checkpoint tree mismatch: {sorted(want ^ set(flat))}")
    return _unflatten(template, flat)


def _read_manifest(sdir: str) -> CheckpointManifest:
    with open(os.path.join(sdir, "manifest.json")) as f:
        return CheckpointManifest.from_json(f.read())


def member_relpath(legion: int, node: int) -> str:
    return os.path.join(f"legion_{legion:02d}", f"member_{node:03d}.npz")


def restore_member(
    directory: str,
    step: int,
    legion: int,
    node: int,
    *,
    template: PyTree | None = None,
    verify: bool = True,
    manifest: CheckpointManifest | None = None,
) -> PyTree:
    """Load exactly one member's shard (host tensors): the restart-only-failed
    path. ``manifest`` lets a caller that already parsed the step's
    manifest thread it through instead of re-reading it per member."""
    sdir = _step_dir(directory, step)
    if manifest is None:
        manifest = _read_manifest(sdir)
    rel = member_relpath(legion, node)
    if rel not in manifest.files:
        raise FileNotFoundError(f"no shard for legion={legion} node={node} at step {step}")
    return _load_npz(os.path.join(sdir, rel), manifest.files[rel], template, verify)


def restore(
    directory: str,
    step: int,
    *,
    template: PyTree | None = None,
    verify: bool = True,
) -> tuple[CheckpointManifest, dict[tuple[int, int], PyTree]]:
    manifest = _read_manifest(_step_dir(directory, step))
    shards = {}
    for legion_s, nodes in manifest.members.items():
        for node in nodes:
            legion = int(legion_s)
            shards[(legion, node)] = restore_member(
                directory, step, legion, node, template=template,
                verify=verify, manifest=manifest)
    return manifest, shards


# ---------------------------------------------------------------------------
# async writer
# ---------------------------------------------------------------------------

class AsyncCheckpointer:
    """Snapshot to host synchronously, serialise in a background thread.

    ``save_async`` returns as soon as every leaf is copied to host memory;
    the npz writes and the manifest rename happen off-thread. ``wait()``
    drains pending writes (call before reading back or at shutdown) and
    raises the first error a write hit.
    """

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: list[BaseException] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_shards, meta = item
            try:
                save(self.directory, step, host_shards, meta=meta)
                self._gc()
            except BaseException as e:  # surfaced on wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        # Retention counts manifest-complete steps only: a partial dir (no
        # manifest.json, a crashed write) never takes a keep slot, and it is
        # swept. The write queue is serial, so a manifest-less dir here is a
        # dead leftover, never an in-flight save.
        complete, partial = [], []
        for name in os.listdir(self.directory):
            if not name.startswith("step_"):
                continue
            step = int(name.split("_")[1])
            if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                complete.append(step)
            else:
                partial.append(step)
        doomed = sorted(complete)[:-self.keep] if self.keep > 0 else []
        for s in doomed + partial:
            sdir = _step_dir(self.directory, s)
            for root, _, names in os.walk(sdir, topdown=False):
                for n in names:
                    os.unlink(os.path.join(root, n))
                if root != sdir:
                    os.rmdir(root)
            os.rmdir(sdir)

    def save_async(self, step: int, shards: dict[tuple[int, int], PyTree],
                   *, meta: dict | None = None) -> float:
        """Returns seconds spent blocking (the device-to-host snapshot only)."""
        with tracing.span("checkpoint.snapshot", step=step) as sp:
            host = {key: _unflatten(tree, {k: _snapshot(v) for k, v in _flatten(tree).items()})
                    for key, tree in shards.items()}
            self._q.put((step, host, meta))
        return sp.seconds

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err.pop()

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)
