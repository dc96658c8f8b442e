"""The port's checkpoint store and LegionCheckpointer vs the JAX package's.

The on-disk format is the reference's, file for file: the ``step_XXXXXX``
layout, the npz keys, dtypes and bytes of every leaf, the manifest JSON
(checksums included). Each package restores what the other wrote, bf16
leaves bit for bit. The cases of ``tests/test_checkpoint.py`` are run on
the port as well.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jax_store  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core import LegionCheckpointer, LegioPolicy, VirtualCluster  # noqa: E402


def jax_tree(seed: float):
    return {
        "params": {"w": jnp.full((4, 4), seed, jnp.bfloat16),
                   "b": jnp.arange(4, dtype=jnp.float32) * seed},
        "step": jnp.asarray(int(seed), jnp.int32),
    }


def tree(seed: float):
    """``jax_tree(seed)`` in torch."""
    return {
        "params": {"w": torch.full((4, 4), seed, dtype=torch.bfloat16),
                   "b": torch.arange(4, dtype=torch.float32) * seed},
        "step": torch.tensor(int(seed), dtype=torch.int32),
    }


def random_tree(seed: int):
    """A trainer-shaped state with random bf16/f32/int leaves (numpy seeded)."""
    rng = np.random.default_rng(seed)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    return {
        "params": {"embed": bf(17, 8), "layers": {"w": bf(2, 8, 8), "norm": bf(2, 8)}},
        "opt": {"step": torch.tensor(3, dtype=torch.int32),
                "mu": {"embed": torch.from_numpy(rng.standard_normal((17, 8)).astype(np.float32))}},
        "meta": {"shards": torch.tensor([int(seed), -1], dtype=torch.int32)},
    }


def shards_for(nodes):
    return {(n // 2, n): tree(float(n + 1)) for n in nodes}


def leaf_bits(x):
    """A leaf's logical dtype and raw bytes, whichever package made it."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.dtype).removeprefix("torch."), x.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.tobytes()


def flat_bits(tree_):
    return {k: leaf_bits(v) for k, v in store._flatten(tree_).items()}


def jax_flat_bits(tree_):
    return {k: leaf_bits(v) for k, v in jax_store._flatten(tree_).items()}


def npz_contents(path):
    with np.load(path) as z:
        return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}


# ---------------------------------------------------------------------------
# the format, both directions
# ---------------------------------------------------------------------------

def test_same_files_and_manifest(tmp_path):
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_store.save(ref, 12, {k: jax_tree(float(k[1] + 1)) for k in shards_for(range(4))},
                   meta={"k": 2})
    store.save(port, 12, shards_for(range(4)), meta={"k": 2})
    files = lambda d: sorted(os.path.relpath(os.path.join(r, n), d)  # noqa: E731
                             for r, _, ns in os.walk(d) for n in ns)
    assert files(ref) == files(port) == [
        "step_000012/legion_00/member_000.npz", "step_000012/legion_00/member_001.npz",
        "step_000012/legion_01/member_002.npz", "step_000012/legion_01/member_003.npz",
        "step_000012/manifest.json"]
    with open(os.path.join(ref, "step_000012", "manifest.json")) as f:
        ref_manifest = f.read()
    with open(os.path.join(port, "step_000012", "manifest.json")) as f:
        assert f.read() == ref_manifest          # text, checksums and all
    for rel in files(ref):
        if rel.endswith(".npz"):
            assert npz_contents(os.path.join(port, rel)) == npz_contents(os.path.join(ref, rel))
    assert json.loads(ref_manifest)["files"]["legion_00/member_000.npz"]["dtypes"] == {
        "params/b": "float32", "params/w": "bfloat16", "step": "int32"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_restores_reference_checkpoint(tmp_path, seed):
    """The reference writes trainer-shaped random state; the port reads it
    back bit for bit, with and without a template."""
    d = str(tmp_path)
    port_shards = {(n // 2, n): random_tree(seed * 10 + n) for n in range(4)}
    ref_shards = {k: {"params": _to_jax(v["params"]), "opt": _to_jax(v["opt"]),
                      "meta": _to_jax(v["meta"])} for k, v in port_shards.items()}
    jax_store.save(d, 5, ref_shards)
    manifest, got = store.restore(d, 5)
    assert manifest.step == 5 and set(got) == set(ref_shards)
    for key in ref_shards:
        assert flat_bits(got[key]) == jax_flat_bits(ref_shards[key])
        assert got[key]["params"]["embed"].dtype == torch.bfloat16
    one = store.restore_member(d, 5, 1, 3, template=random_tree(0))
    assert flat_bits(one) == jax_flat_bits(ref_shards[(1, 3)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_restores_port_checkpoint(tmp_path, seed):
    d = str(tmp_path)
    shards = {(n // 2, n): random_tree(seed * 10 + n) for n in range(4)}
    store.save(d, 8, shards)
    manifest, got = jax_store.restore(d, 8)
    assert manifest.step == 8 and set(got) == set(shards)
    for key in shards:
        assert jax_flat_bits(got[key]) == flat_bits(shards[key])
        assert got[key]["params"]["embed"].dtype == jnp.bfloat16
    assert jax_store.latest_step(d) == store.latest_step(d) == 8


def _to_jax(t):
    if isinstance(t, dict):
        return {k: _to_jax(v) for k, v in t.items()}
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's cases on the port
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    store.save(d, 10, shards_for(range(4)))
    manifest, shards = store.restore(d, 10)
    assert manifest.step == 10
    assert set(shards) == {(0, 0), (0, 1), (1, 2), (1, 3)}
    got = shards[(1, 2)]
    np.testing.assert_array_equal(got["params"]["w"].float().numpy(), np.full((4, 4), 3.0))
    assert got["params"]["w"].dtype == torch.bfloat16     # bf16 preserved


def test_restore_only_failed_member(tmp_path):
    d = str(tmp_path)
    store.save(d, 7, shards_for(range(6)))
    one = store.restore_member(d, 7, legion=2, node=5)
    assert int(one["step"]) == 6
    one_t = store.restore_member(d, 7, legion=2, node=5, template=tree(0.0))
    assert tuple(one_t["params"]["w"].shape) == (4, 4)
    with pytest.raises(ValueError, match="tree mismatch"):
        store.restore_member(d, 7, legion=2, node=5, template={"step": tree(0.0)["step"]})


def test_missing_member_raises(tmp_path):
    d = str(tmp_path)
    store.save(d, 7, shards_for(range(2)))
    with pytest.raises(FileNotFoundError):
        store.restore_member(d, 7, legion=9, node=99)


def test_checksum_detects_corruption(tmp_path):
    d = str(tmp_path)
    store.save(d, 3, shards_for(range(2)))
    path = os.path.join(d, "step_000003", "legion_00", "member_001.npz")
    with np.load(path) as z:
        arrays = {k: z[k].copy() for k in z.files}
    key = [k for k in arrays if k.endswith("w")][0]
    arrays[key] = arrays[key] + 1
    np.savez(path, **arrays)
    with pytest.raises(IOError):
        store.restore_member(d, 3, legion=0, node=1)
    store.restore_member(d, 3, legion=0, node=1, verify=False)


def test_latest_step_and_partial_dirs(tmp_path):
    d = str(tmp_path)
    assert store.latest_step(d) is None
    store.save(d, 1, shards_for(range(2)))
    store.save(d, 5, shards_for(range(2)))
    os.makedirs(os.path.join(d, "step_000009"))    # crashed write: no manifest
    assert store.latest_step(d) == 5


def test_async_checkpointer_snapshots_and_gc(tmp_path):
    d = str(tmp_path)
    ck = store.AsyncCheckpointer(d, keep=2)
    live = shards_for(range(2))
    for step in (1, 2, 3, 4):
        assert ck.save_async(step, live) < 5.0
        for t in live.values():
            t["params"]["b"].add_(100.0)           # in-place training after the snapshot
    ck.wait()
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert steps == ["step_000003", "step_000004"]
    _, got = store.restore(d, 3)
    np.testing.assert_array_equal(got[(0, 1)]["params"]["b"].numpy(),
                                  np.arange(4, dtype=np.float32) * 2.0 + 200.0)
    ck.close()


def test_gc_sweeps_partial_dirs_and_never_counts_them(tmp_path):
    d = str(tmp_path)
    ck = store.AsyncCheckpointer(d, keep=2)
    ck.save_async(1, shards_for(range(2)))
    ck.wait()
    os.makedirs(os.path.join(d, "step_000007"))
    stranded = os.path.join(d, "step_000009", "legion_00")
    os.makedirs(stranded)
    with open(os.path.join(stranded, "member_000.npz"), "wb") as f:
        f.write(b"garbage")
    ck.save_async(2, shards_for(range(2)))
    ck.save_async(3, shards_for(range(2)))
    ck.wait()
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert steps == ["step_000002", "step_000003"]
    ck.close()


def test_restore_member_threads_preparsed_manifest(tmp_path):
    d = str(tmp_path)
    store.save(d, 4, shards_for(range(4)))
    manifest = store._read_manifest(os.path.join(d, "step_000004"))
    one = store.restore_member(d, 4, legion=1, node=3, manifest=manifest)
    assert int(one["step"]) == 4
    manifest.files.pop(store.member_relpath(1, 3))
    with pytest.raises(FileNotFoundError):
        store.restore_member(d, 4, legion=1, node=3, manifest=manifest)


def test_legion_dirs_are_self_contained(tmp_path):
    d = str(tmp_path)
    store.save(d, 2, shards_for(range(4)))
    assert sorted(os.listdir(os.path.join(d, "step_000002"))) == [
        "legion_00", "legion_01", "manifest.json"]


# ---------------------------------------------------------------------------
# LegionCheckpointer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_writes", [False, True])
def test_legion_checkpointer_save_and_restart(tmp_path, async_writes):
    cl = VirtualCluster(8, policy=LegioPolicy(legion_size=4, data_plane="sim"))
    ck = LegionCheckpointer(str(tmp_path), async_writes=async_writes)
    cl.checkpointer = ck                    # wires the cluster's replicator in
    assert ck.replicator is cl.replicator
    state = {n: random_tree(n) for n in cl.topo.nodes}
    ck.save(4, cl.topo, state.__getitem__)
    ck.wait()
    assert ck.latest_step() == 4
    files = ck.files_for_step(4)
    assert len(files) == 9 and files[-1].endswith("manifest.json")
    with open(files[-1]) as f:
        assert json.load(f)["meta"] == {"k": cl.topo.k}
    legion = next(lg.index for lg in cl.topo.legions if 5 in lg.members)
    got = ck.restore_failed_member(legion, 5)
    assert flat_bits(got) == flat_bits(state[5])
    assert [(r.node, r.legion, r.step, r.source) for r in ck.restarts] == [
        (5, legion, 4, "checkpoint")]
    _, everything = ck.restore_all()
    assert len(everything) == 8
    ck.close()
    with pytest.raises(FileNotFoundError):
        LegionCheckpointer(str(tmp_path / "empty"), async_writes=False).restore_failed_member(0, 1)
