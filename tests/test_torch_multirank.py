"""The port's multi-rank runtime on the CPU: gloo ranks against the reference.

Three groups of processes are started once for the module, all at once:

- four ranks (``tests/torch_multirank_ranks.py campaign``) run seeded fault
  campaigns on the torch plane over the process group, with the port's sim
  plane beside them in each process as a second witness; the same campaigns
  run in this process through the JAX package's ``Session`` (under
  ``test_torch_runtime``'s stand-in for its uncommitted data-plane module),
  and every rank is held to those records;
- eight ranks (``... reshard``) run tests/test_dataplane.py's reshard case,
  a campaign that reshards twice, and the in-program functions;
- one rank (``... world1``) starts through ``init_from_env`` at world size 1;
- one JAX process with eight forced host devices runs the reference's
  ``param_specs``, in-program functions, ``DevicePool`` and ``CompileCache``
  on the same inputs (the flag must be set before jax imports).

Rendezvous go through files in a fresh directory (and world 1 through a
port chosen at run time), never a fixed port. The placement rules are also
checked in this process on meshes of torch's ``fake`` backend, where no
collective runs. Tolerances: integers and the int8 hop exact, f32 2e-5.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "torch_multirank_ranks.py"
TIMEOUT_S = 240
TOL = 2e-5

sys.path.insert(0, str(RANKS.parent))
import torch_multirank_ranks as rank_program  # noqa: E402

_ORACLE = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
assert len(jax.devices()) == 8, jax.devices()
from repro.core.agreement import agree_bitmap_inprogram
from repro.core.collectives import hierarchical_psum_scatter, make_hierarchical_allreduce
from repro.core.mesh_manager import CompileCache, DevicePool, MeshManager
from repro.dist.compat import shard_map
from repro.dist.sharding import param_specs

workdir = sys.argv[1]
inp = dict(np.load(workdir + "/inputs.npz"))
devs = np.array(jax.devices())
ids = np.vectorize(lambda d: d.id)
out = {}

def specs(tree, n):
    mesh = Mesh(devs[:n].reshape(n, 1), ("data", "model"))
    return {k: tuple(v) for k, v in param_specs(None, tree, mesh).items()}

out["specs_one"] = specs({k: inp[k] for k in ("wq", "bias")}, 7)
state2 = {k: inp[k] for k in ("w_in", "wo", "embed", "norm")}
out["specs_two"] = {n: specs(state2, n) for n in (7, 6)}

bm = jnp.asarray(inp["bitmaps"])
out["agree"] = {
    "data8": np.asarray(agree_bitmap_inprogram(Mesh(devs, ("data",)), bm)),
    "pod2_data4": np.asarray(agree_bitmap_inprogram(Mesh(devs.reshape(2, 4), ("pod", "data")), bm)),
    "model8": np.asarray(agree_bitmap_inprogram(Mesh(devs, ("model",)), bm)),
}
x = jnp.asarray(inp["x_allreduce"])
m241 = Mesh(devs.reshape(2, 4, 1), ("pod", "data", "model"))
m81 = Mesh(devs.reshape(8, 1), ("data", "model"))
out["allreduce"] = {
    "pod_data_model": np.asarray(make_hierarchical_allreduce(m241, P(("pod", "data")))(x)),
    "data_model": np.asarray(make_hierarchical_allreduce(m81, P("data"))(x)),
}
m24 = Mesh(devs.reshape(2, 4), ("pod", "data"))
def scatter(dim, spec):
    f = shard_map(lambda b: hierarchical_psum_scatter(b, legion_axis="pod", member_axis="data",
                                                      scatter_dim=dim),
                  mesh=m24, in_specs=spec, out_specs=spec)
    return np.asarray(jax.jit(f)(jnp.asarray(inp[f"x_scatter{dim}"])))
out["psum_scatter"] = {0: scatter(0, P(("pod", "data"))), 1: scatter(1, P(("pod", "data"), None))}

pools = {}
for n_nodes, chips, spares in ((8, 1, 0), (7, 1, 1), (4, 2, 0), (16, 1, 0), (5, 2, 1), (3, 2, 0)):
    pool = DevicePool(n_nodes=n_nodes, chips_per_node=chips, n_spares=spares)
    mm = MeshManager(pool)
    survivors = [n for n in range(pool.total_nodes) if n % 3 != 1]
    pools[(n_nodes, chips, spares)] = {
        "node_devices": [[d.id for d in pool.node_devices(n)] for n in range(pool.total_nodes)],
        "total_nodes": pool.total_nodes, "physical": pool.physical,
        "survivor_mesh": ids(mm.survivor_mesh(survivors).devices).tolist(),
    }
out["pools"] = pools

cache = CompileCache()
m71 = Mesh(devs[:7].reshape(7, 1), ("data", "model"))
tree = {"b": jnp.zeros((2, 3), jnp.float32), "a": jnp.zeros((4,), jnp.int32)}
out["cache_key"] = cache.key("step", m71, tree, (jnp.zeros((5,), jnp.bfloat16),))
double = jax.jit(lambda v: v * 2)
for shape in ((3,), (3,), (4,)):
    cache.lower_and_compile("double", m71, double, jnp.ones(shape, jnp.float32))
stats = cache.stats()
out["cache_stats"] = {"entries": stats["entries"], "hits": stats["hits"]}
with open(workdir + "/oracle.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def _inputs() -> dict:
    rng = np.random.default_rng(19)
    bitmaps = np.ones((8, 16), np.int32)
    bitmaps[rng.integers(0, 8, 5), rng.integers(0, 16, 5)] = 0
    return {
        "wq": np.arange(128, dtype=np.float32).reshape(8, 16),
        "bias": np.arange(16, dtype=np.float32) - 8,
        "w_in": rng.standard_normal((42, 12)).astype(np.float32),
        "wo": rng.standard_normal((12, 42)).astype(np.float32),
        "embed": rng.standard_normal((10, 4)).astype(np.float32),
        "norm": rng.standard_normal((12,)).astype(np.float32),
        "bitmaps": bitmaps,
        "x_allreduce": rng.standard_normal((16, 5)).astype(np.float32),
        "x_scatter0": rng.standard_normal((64, 3)).astype(np.float32),
        "x_scatter1": rng.standard_normal((32, 8)).astype(np.float32),
        "g_int": ((np.arange(32) % 11) - 5).astype(np.float32),
        "g_f32": rng.standard_normal((64, 8)).astype(np.float32),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every rank and the oracle at once, wait for all, load their
    pickles: {"oracle": ..., "campaign": [rank 0..3], "reshard": [0..7],
    "world1": [0]}."""
    workdir = tmp_path_factory.mktemp("multirank")
    inputs = _inputs()
    np.savez(workdir / "inputs.npz", **inputs)
    base = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for case, world in (("campaign", 4), ("reshard", 8)):
        for rank in range(world):
            procs[(case, rank)] = subprocess.Popen(
                [sys.executable, str(RANKS), case, str(rank), str(world), str(workdir)],
                env=base, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    procs[("world1", 0)] = subprocess.Popen(
        [sys.executable, str(RANKS), "world1", "0", "1", str(workdir)],
        env=dict(base, RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                 MASTER_PORT=str(_free_port())),
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs[("oracle", 0)] = subprocess.Popen(
        [sys.executable, "-c", _ORACLE, str(workdir)],
        env=dict(base, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failures = []
    try:
        for key, proc in procs.items():
            out, _ = proc.communicate(timeout=TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(f"{key} exited {proc.returncode}:\n{out[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert not failures, "\n".join(failures)
    loaded = {"inputs": inputs}
    with open(workdir / "oracle.pkl", "rb") as f:
        loaded["oracle"] = pickle.load(f)
    for case, world in (("campaign", 4), ("reshard", 8), ("world1", 1)):
        loaded[case] = []
        for rank in range(world):
            with open(workdir / f"{case}.rank{rank}.pkl", "rb") as f:
                loaded[case].append(pickle.load(f))
    return loaded


# ---------------------------------------------------------------------------
# 1. campaign parity at world size 4
# ---------------------------------------------------------------------------

def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _check_op(t: dict, s: dict, ctx: str, exact: bool) -> None:
    assert t["stages"] == s["stages"], f"{ctx}: stage lists (and wire bytes) diverged"
    assert t["sim_seconds"] == s["sim_seconds"], f"{ctx}: clock diverged"
    assert set(t["data"]) == set(s["data"]), f"{ctx}: membership diverged"
    for node, want in s["data"].items():
        got = t["data"][node]
        if exact:
            assert _same_bytes(got, want), f"{ctx}: node {node} diverged"
        else:
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"{ctx} node {node}")


@pytest.fixture(scope="module")
def reference_campaigns(runs):
    """The world-4 campaigns through the JAX package's ``Session``, on the
    sim contract of docs/dataplane.md (the stand-in ``repro.dist.dataplane``
    of test_torch_runtime, in place only while they run)."""
    import repro.core as ref_core
    import repro.mpi as ref_mpi
    from test_torch_runtime import _stand_in_module

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "repro.dist.dataplane", _stand_in_module())
        return {name: rank_program.run_campaign(ref_core, ref_mpi, spec)
                for name, spec in rank_program.campaigns(runs["inputs"]).items()}


def _check_campaign(got: list[dict], want: list[dict], ctx: str, *, exact: bool) -> None:
    """One campaign's records against another's: topologies, every op's
    stages, clock and results, the gathers, residuals and repair rounds."""
    assert len(got) == len(want) == rank_program.STEPS, ctx
    for g, w in zip(got, want):
        c = f"{ctx} step {w['step']}"
        assert g["nodes"] == w["nodes"], f"{c}: topologies diverged"
        assert g["repair_rounds"] == w["repair_rounds"], f"{c}: repair rounds diverged"
        for op in ("allreduce", "bcast", "reduce"):
            if op in w:
                _check_op(g[op], w[op], f"{c} {op}", exact=exact)
        if "gather" in w:
            assert set(g["gather"]) == set(w["gather"]), f"{c}: gather membership"
            for node, want_v in w["gather"].items():
                assert _same_bytes(g["gather"][node], want_v), f"{c} gather {node}"
        if "residuals" in w:
            assert set(g["residuals"]) == set(w["residuals"]) and w["residuals"], c
            for m, want_r in w["residuals"].items():
                assert _same_bytes(g["residuals"][m], want_r), f"{c}: residual of {m}"


@pytest.mark.parametrize("mode", ["shrink", "substitute", "overlap"])
def test_campaign_parity_world4(runs, reference_campaigns, mode):
    """Integer-exact payloads: on every rank, every op's result, stage list
    (with its wire bytes) and clock byte-equal to the JAX package's records,
    and to the port's sim plane's; repairs landed."""
    want = reference_campaigns[mode]
    assert want[-1]["repair_rounds"] >= 2
    for rank, out in enumerate(runs["campaign"]):
        got = out["campaigns"][mode]
        _check_campaign(got["torch"], want, f"rank {rank} {mode} vs reference", exact=True)
        _check_campaign(got["sim"], want, f"rank {rank} {mode} sim vs reference", exact=True)


def test_campaign_int8_hop_bytes_world4(runs, reference_campaigns):
    """int8 on the cross-legion hop: the error-feedback residuals (what the
    hop sent, subtracted from what it was given) byte-equal to the JAX
    package's numpy twins' at every step on every rank; the sums of the
    decompressed partials within f32 2e-5 (their order across ranks is the
    backend's)."""
    want = reference_campaigns["int8"]
    for rank, out in enumerate(runs["campaign"]):
        got = out["campaigns"]["int8"]
        _check_campaign(got["torch"], want, f"rank {rank} int8 vs reference", exact=False)
        _check_campaign(got["sim"], want, f"rank {rank} int8 sim vs reference", exact=True)


def test_campaign_f32_world4(runs, reference_campaigns):
    """Random f32 payloads: stages and clock equal, results within 2e-5 of
    the JAX package's sequential fold on every rank."""
    want = reference_campaigns["f32"]
    for rank, out in enumerate(runs["campaign"]):
        got = out["campaigns"]["f32"]
        _check_campaign(got["torch"], want, f"rank {rank} f32 vs reference", exact=False)
        _check_campaign(got["sim"], want, f"rank {rank} f32 sim vs reference", exact=True)


def test_control_plane_equal_across_ranks(runs):
    """Every rank computed the same schedules, clocks, topologies and (the
    payloads being replicated) the same result bytes where they are integer
    exact, the same residual bytes, and f32 within 2e-5."""
    first = runs["campaign"][0]
    for rank, out in enumerate(runs["campaign"][1:], start=1):
        for name, sides in first["campaigns"].items():
            _check_campaign(out["campaigns"][name]["torch"], sides["torch"],
                            f"rank {rank} {name} vs rank 0",
                            exact=name in rank_program.CAMPAIGN_MODES)


def test_auto_plane_and_trainer_steps_world4(runs):
    """The auto plane takes the group; the trainer builds and steps over the
    four ranks (the smoke config, one node a rank), every rank reporting the
    same finite steps (tests/test_torch_multirank_train.py holds it to the
    reference)."""
    first = runs["campaign"][0]["trainer"]["reports"]
    assert [(r["step"], r["active_shards"]) for r in first] == [(0, 4), (1, 4)]
    assert all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in first)
    for rank, out in enumerate(runs["campaign"]):
        assert out["auto"] == ("TorchDataPlane", 4, rank)
        assert out["trainer"]["distributed"]
        assert out["trainer"]["reports"] == first, rank


# ---------------------------------------------------------------------------
# 2. the reshard at world size 8 (tests/test_dataplane.py's case)
# ---------------------------------------------------------------------------

def _placements(spec: tuple, names=("data", "model")) -> list[str]:
    """The reference's PartitionSpec, translated: per mesh dim the tensor dim
    that names it (Shard) or Replicate."""
    out = []
    for axis in names:
        dims = [d for d, e in enumerate(spec)
                if e is not None and axis in (e if isinstance(e, tuple) else (e,))]
        out.append(f"Shard(dim={dims[0]})" if dims else "Replicate()")
    return out


def _expected_local(whole: np.ndarray, placements: list[str], coord: tuple,
                    sizes: tuple) -> np.ndarray:
    """The block of ``whole`` a rank at mesh coordinate ``coord`` holds."""
    block = whole
    for c, size, p in zip(coord, sizes, placements):
        if p.startswith("Shard"):
            d = int(p[len("Shard(dim="):-1])
            chunk = whole.shape[d] // size
            block = np.take(block, range(c * chunk, (c + 1) * chunk), axis=d)
    return block


def _check_leaves(rank_out: dict, specs: dict, inputs: dict, ranks: list[int], rank: int):
    """Each leaf placed by the reference's spec on the (len(ranks), 1) mesh,
    holding its block (nothing on a rank outside the mesh)."""
    for name, seen in rank_out.items():
        want = _placements(specs[name])
        assert seen["placements"] == want, (rank, name, seen["placements"], want)
        assert seen["shape"] == inputs[name].shape
        assert seen["mesh_ranks"] == [[r] for r in ranks]
        if rank not in ranks:
            assert seen["coord"] is None and seen["local"].size == 0
            continue
        assert tuple(seen["coord"]) == (ranks.index(rank), 0)
        np.testing.assert_array_equal(
            seen["local"], _expected_local(inputs[name], want, seen["coord"], (len(ranks), 1)),
            err_msg=f"rank {rank} {name}")


def test_reshard_after_shrink_places_leaves_on_survivors(runs):
    """A mid-campaign death of node 3 rebuilds the mesh from the 7 surviving
    ranks, places every leaf as the reference's param_specs on a (7, 1) mesh
    says, holds the right block on every rank, and charges the pass's wall
    time (the slowest rank's, the same on every rank) to the clock."""
    oracle, inputs = runs["oracle"], runs["inputs"]
    survivors = [0, 1, 2, 4, 5, 6, 7]
    clocks = set()
    for rank, out in enumerate(runs["reshard"]):
        one = out["one"]
        assert 3 not in one["nodes"]
        assert one["reshards"], "no ReshardReport logged after repair"
        rep = one["reshards"][-1]
        assert rep.n_devices == 7 and rep.mesh_shape == (7, 1), rep
        assert rep.wall_seconds > 0.0
        assert rep.leaves == 2 and rep.moved_bytes == (128 + 16) * 4
        assert one["t1"] > one["t0"]
        clocks.add(one["sim_seconds"])
        _check_leaves(one["leaves"], oracle["specs_one"], inputs, survivors, rank)
    assert len(clocks) == 1, clocks


def test_reshard_twice_reassembles_placed_state(runs):
    """Two deaths: the second pass starts from leaves already placed on the
    7-rank mesh, assembles them and places them on the 6 survivors."""
    oracle, inputs = runs["oracle"], runs["inputs"]
    for rank, out in enumerate(runs["reshard"]):
        two = out["two"]
        assert [r.mesh_shape for r in two["reshards"]] == [(7, 1), (6, 1)]
        _check_leaves(two["leaves"], oracle["specs_two"][6], inputs, [0, 1, 2, 4, 6, 7], rank)


# ---------------------------------------------------------------------------
# 3. the in-program functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["data8", "pod2_data4", "model8"])
def test_agree_bitmap_inprogram(runs, mesh):
    want = runs["oracle"]["agree"][mesh]
    assert 0 < want.sum() < want.size
    for out in runs["reshard"]:
        got = out["agree"][mesh]
        assert _same_bytes(got, want.astype(np.int32)), (mesh, got, want)


@pytest.mark.parametrize("mesh", ["pod_data_model", "data_model"])
def test_make_hierarchical_allreduce(runs, mesh):
    want = runs["oracle"]["allreduce"][mesh]
    rows = want.shape[0] // 8
    for rank, out in enumerate(runs["reshard"]):
        np.testing.assert_allclose(out["allreduce"][mesh], want[rank * rows:(rank + 1) * rows],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dim", [0, 1])
def test_hierarchical_psum_scatter(runs, dim):
    want = runs["oracle"]["psum_scatter"][dim]
    rows = want.shape[0] // 8
    for rank, out in enumerate(runs["reshard"]):
        got = out["psum_scatter"][dim]
        np.testing.assert_allclose(got, want[rank * rows:(rank + 1) * rows], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# world size 1 through init_from_env: the one-rank path's bytes
# ---------------------------------------------------------------------------

def test_world1_group_path_equals_one_rank_path(runs):
    (out,) = runs["world1"]
    assert out["backend"] == "gloo" and out["device"] == "cpu"
    assert (out["group"]["distributed"], out["group"]["world"]) == (True, 1)
    assert (out["one"]["distributed"], out["one"]["world"]) == (False, 1)
    assert out["group"]["reshards"] == [] == out["one"]["reshards"]
    for step, (a, b) in enumerate(zip(out["group"]["results"], out["one"]["results"])):
        assert a["stages"] == b["stages"] and a["sim_seconds"] == b["sim_seconds"]
        for node, want in b["data"].items():
            assert _same_bytes(a["data"][node], want), (step, node)


# ---------------------------------------------------------------------------
# 4. param_specs / sanitize_spec on fake-backend meshes, in this process
# ---------------------------------------------------------------------------

MESHES = [((8, 1), ("data", "model")), ((7, 1), ("data", "model")),
          ((2, 4), ("data", "model"))]
ARCHS = ["llama3.2-3b", "hymba-1.5b", "mamba2-130m", "mixtral-8x22b", "grok-1-314b",
         "chameleon-34b", "whisper-tiny", "gemma-7b", "starcoder2-7b", "deepseek-67b"]


@pytest.fixture
def fake_meshes():
    """DeviceMeshes of an 8-rank fake group: no collective runs, and the
    group is gone when the test ends (a plane built later must not see it)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield {shape: DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                                 mesh_dim_names=names) for shape, names in MESHES}
    finally:
        dist.destroy_process_group()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    else:
        yield ".".join(path), tree


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(fake_meshes, arch):
    """Every leaf of each config's smoke params, on (8, 1), (7, 1) and
    (2, 4) meshes: the same spec, the same warnings, the same placements."""
    import jax
    from repro.configs.registry import get_smoke_config as ref_smoke
    from repro.dist import sharding as ref_sharding
    from repro.dist.compat import abstract_mesh
    from repro.models import api as ref_api

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist import sharding
    from repro_torch.models import api

    cfg = get_smoke_config(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref_params = jax.eval_shape(lambda: ref_api.init_params(ref_smoke(arch), jax.random.PRNGKey(0)))
    for (shape, names), mesh in zip(MESHES, fake_meshes.values()):
        ref_sharding._replication_warned.clear()
        sharding._replication_warned.clear()
        with warnings.catch_warnings(record=True) as ref_w:
            warnings.simplefilter("always")
            ref_mesh = abstract_mesh(shape, names)
            want = dict(_flat(ref_sharding.param_specs(None, ref_params, ref_mesh)))
        with warnings.catch_warnings(record=True) as port_w:
            warnings.simplefilter("always")
            got = dict(_flat(sharding.param_specs(None, params, mesh)))
        assert set(got) == set(want)
        for leaf, spec in want.items():
            assert got[leaf] == tuple(spec), (arch, shape, leaf, got[leaf], spec)
            assert [repr(p) for p in sharding.placements(got[leaf], mesh)] == \
                _placements(tuple(spec), names), (arch, shape, leaf)
        assert sorted(str(w.message) for w in port_w) == sorted(str(w.message) for w in ref_w)


def test_sanitize_spec_matches_reference(fake_meshes):
    """The reference's own sanitize cases, tuple axes included, and its
    once-per-(param, dim, axes) warning."""
    from jax.sharding import PartitionSpec as P
    from repro.dist import sharding as ref_sharding
    from repro.dist.compat import abstract_mesh

    from repro_torch.dist import sharding

    class Shape:   # anything with a shape and dim names is a mesh to the rules
        def __init__(self, shape, names):
            self.shape, self.mesh_dim_names = shape, names

    cases = [((16, 16), ("data", "model"), (None, "data", None, "model", None),
              (56, 128, 4096, 8, 128)),
             ((16, 16), ("data", "model"), ("model", None), (50280, 768)),
             ((16, 16), ("data", "model"), ("model", None), (32768, 768)),
             ((2, 16, 16), ("pod", "data", "model"), (("pod", "data"), None), (64, 8)),
             ((2, 16, 16), ("pod", "data", "model"), (("pod", "data"), None), (16, 8)),
             ((4, 2), ("data", "model"), ("data", "model"), (7, 6))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for shape, names, spec, dims in cases:
            want = ref_sharding.sanitize_spec(P(*spec), dims, abstract_mesh(shape, names),
                                              param="p")
            got = sharding.sanitize_spec(spec, dims, Shape(shape, names), param="p")
            assert got == tuple(want), (spec, dims, got, want)
    mesh = fake_meshes[(2, 4)]
    sharding._replication_warned.clear()
    with pytest.warns(UserWarning, match=r"dim 0 of blk\.wq.*'data'"):
        got = sharding.sanitize_spec(("data", "model"), (7, 8), mesh, param="blk.wq")
    assert got == (None, "model")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sharding.sanitize_spec(("data", "model"), (7, 8), mesh, param="blk.wq")
    assert [repr(p) for p in sharding.placements((("data", "model"),), mesh)] == \
        ["Shard(dim=0)", "Shard(dim=0)"]
    with pytest.raises(ValueError, match="not dims of mesh"):
        sharding.placements(("pod",), mesh)


# ---------------------------------------------------------------------------
# 5. DevicePool, MeshManager's rank grid and the CompileCache keys
# ---------------------------------------------------------------------------

def test_device_pool_matches_reference(runs):
    """DevicePool's arithmetic equals the JAX package's; the survivors' grid
    equals its mesh where the pool is physical, and elsewhere is the
    surviving nodes' rows of ranks, deduplicated and sorted (the JAX
    package's MeshManager takes its first devices there instead)."""
    from repro_torch.core import DevicePool, MeshManager

    assert {want["physical"] for want in runs["oracle"]["pools"].values()} == {True, False}
    for (n_nodes, chips, spares), want in runs["oracle"]["pools"].items():
        pool = DevicePool(n_nodes=n_nodes, chips_per_node=chips, n_spares=spares, world_size=8)
        assert [pool.node_devices(n) for n in range(pool.total_nodes)] == want["node_devices"]
        assert (pool.total_nodes, pool.physical) == (want["total_nodes"], want["physical"])
        survivors = [n for n in range(pool.total_nodes) if n % 3 != 1]
        rows = sorted({tuple(want["node_devices"][n]) for n in survivors})
        expect = want["survivor_mesh"] if want["physical"] else [list(r) for r in rows]
        assert MeshManager(pool).survivor_ranks(survivors) == expect, (n_nodes, chips, spares)


@pytest.mark.parametrize("nodes, survivors, ranks", [
    (8, [0, 1, 2, 4, 5, 6, 7], [0, 1, 2, 4, 5, 6, 7]),
    (16, [0, 2, 3, 5, 8, 10, 11, 13], [0, 2, 3, 5]),
    (16, [1, 4, 9, 12, 15], [1, 4, 7])])
def test_plane_and_mesh_manager_build_one_mesh(fake_meshes, nodes, survivors, ranks):
    """The data plane's reshard mesh and the trainer's MeshManager are one
    definition: over 8 fake ranks, physical or wrapped around, both put
    the survivors' ranks (node % world) in the same (n, 1) grid."""
    import types

    from repro_torch.core import DevicePool, MeshManager
    from repro_torch.dist import TorchDataPlane

    plane = TorchDataPlane("cpu")
    assert (plane.distributed, plane.world) == (True, 8)
    by_plane = plane.mesh_for(types.SimpleNamespace(nodes=survivors))
    by_manager = MeshManager(DevicePool(n_nodes=nodes), device_type="cpu").survivor_mesh(survivors)
    for mesh in (by_plane, by_manager):
        assert mesh.mesh.tolist() == [[r] for r in ranks]
        assert mesh.mesh_dim_names == ("data", "model")


def test_mesh_manager_places_on_the_survivor_mesh(fake_meshes):
    """survivor_mesh over 8 fake ranks after node 3's death, then reshard
    by param_specs: every leaf's placements, and rank 0's block."""
    from repro_torch.core import DevicePool, MeshManager
    from repro_torch.dist import param_specs

    mm = MeshManager(DevicePool(n_nodes=8), device_type="cpu")
    assert mm.pool.world_size == 8
    mesh = mm.survivor_mesh([0, 1, 2, 4, 5, 6, 7])
    assert mesh.mesh.tolist() == [[0], [1], [2], [4], [5], [6], [7]]
    assert mesh.mesh_dim_names == ("data", "model")
    inputs = _inputs()
    tree = {"blk": {k: torch.from_numpy(inputs[k]) for k in ("w_in", "wo", "embed", "norm")}}
    placed = mm.reshard(tree, mesh, param_specs(None, tree, mesh))
    for name, leaf in placed["blk"].items():
        want = _placements(tuple(param_specs(None, {name: inputs[name]}, mesh)[name]))
        assert [repr(p) for p in leaf.placements] == want, name
        np.testing.assert_array_equal(
            leaf.to_local().numpy(), _expected_local(inputs[name], want, (0, 0), (7, 1)))


def test_compile_cache_keys_match_reference(runs, monkeypatch):
    from repro_torch.core import CompileCache

    class Mesh71:
        shape, mesh_dim_names = (7, 1), ("data", "model")

    # the eager backend traces as inductor does but generates no code: the
    # cache's bookkeeping is the subject here, not the compiler's seconds
    compile_ = torch.compile
    monkeypatch.setattr(torch, "compile", lambda fn: compile_(fn, backend="eager"))
    cache = CompileCache()
    tree = {"b": torch.zeros((2, 3)), "a": torch.zeros((4,), dtype=torch.int32)}
    key = cache.key("step", Mesh71(), tree, (torch.zeros((5,), dtype=torch.bfloat16),))
    assert key == runs["oracle"]["cache_key"]
    hits = [cache.lower_and_compile("double", Mesh71(), lambda v: v * 2, torch.ones(shape))[1]
            for shape in ((3,), (3,), (4,))]
    assert hits == [False, True, False]
    stats = cache.stats()
    assert {k: stats[k] for k in ("entries", "hits")} == runs["oracle"]["cache_stats"]
    assert stats["compile_seconds"] > 0


# ---------------------------------------------------------------------------
# 6. errors, and the trainer's memory without the cycle collector
# ---------------------------------------------------------------------------

def test_init_from_env_raises_without_a_card_or_env(monkeypatch):
    from repro_torch.dist import init_from_env

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_from_env("cuda")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT not set"):
        init_from_env("cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        init_from_env("cpu", backend="mpi-ish")


def test_dropped_trainer_is_freed_without_gc():
    """The state getters hold the trainer weakly: dropping the trainer frees
    its parameters at once, with the cycle collector off."""
    import gc
    import weakref

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import FaultInjector, LegioPolicy, VirtualCluster
    from repro_torch.core.trainer import ResilientTrainer

    cl = VirtualCluster(4, policy=LegioPolicy(legion_size=2),
                        injector=FaultInjector.at([(1, 2)]), device="cpu")
    trainer = ResilientTrainer(get_smoke_config("llama3.2-3b"), TrainConfig(), cl,
                               per_shard_batch=1, seq_len=16)
    trainer.run(2)
    assert trainer.pool.world_size == 1 and trainer.compile_cache.stats()["entries"] == 0
    gc.disable()
    try:
        alive, leaf = weakref.ref(trainer), weakref.ref(trainer.params["embed"])
        del trainer
        assert alive() is None and leaf() is None
    finally:
        gc.enable()
    getter, setter = cl.dataplane.registered["trainer.params"]
    assert getter() is None
    setter({})      # a setter of a dropped trainer does nothing


def test_h100_links_named_apart_from_the_default():
    """The default link model stays the reference's (so both packages charge
    the same simulated seconds); the H100 one is its own instance."""
    from repro.core.collectives import LinkModel as RefLinkModel

    from repro_torch.core.collectives import H100_LINKS, LinkModel

    fields = ("alpha_intra", "beta_intra", "alpha_cross", "beta_cross", "level_slowdown")
    ref, port = RefLinkModel(), LinkModel()
    assert [getattr(port, f) for f in fields] == [getattr(ref, f) for f in fields]
    assert (H100_LINKS.beta_intra, H100_LINKS.beta_cross) == (450.0e9, 50.0e9)
    assert H100_LINKS.tree_time(8, 1 << 20, cross=False) < port.tree_time(8, 1 << 20, cross=False)
