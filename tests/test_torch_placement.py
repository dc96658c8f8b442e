"""The port's placement rules and activation constraints against the reference.

- ``_batch_dim_axes`` and ``batch_specs``: the reference's cases
  (tests/test_sharding.py), held exactly on both packages' abstract meshes.
- ``cell_shardings`` and ``input_specs`` for every arch x applicable shape x
  both production meshes (abstract, no devices): spec for spec, shape and
  dtype for shape and dtype, against the reference's NamedShardings and
  ShapeDtypeStructs.
- The activation helpers return their input itself off a mesh.
- On torch's ``fake`` process group of 8 ranks (a (2, 2, 2) pod/data/model
  mesh, in a subprocess so the group never meets another test's), each
  helper places a DTensor as the reference's spec says (this process
  computes those specs with the reference's own functions), and the
  kernels' entry points refuse a DTensor.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.dist import compat as ref_compat  # noqa: E402
from repro.dist import sharding as ref_sharding  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import registry as port_registry  # noqa: E402
from repro_torch.dist import compat, sharding  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _both_meshes(shape, axes):
    return ref_compat.abstract_mesh(shape, axes), compat.abstract_mesh(shape, axes)


@pytest.mark.parametrize("mesh_shape,axes,batch,expected", [
    ((2, 1), ("data", "model"), 4, "data"),
    ((2, 1), ("data", "model"), 1, None),          # long_500k: replicated
    ((2, 1), ("data", "model"), 3, None),
    ((2, 4, 1), ("pod", "data", "model"), 16, ("pod", "data")),
    ((2, 4, 1), ("pod", "data", "model"), 4, "data"),  # pod dropped first
])
def test_batch_axes_divisibility(mesh_shape, axes, batch, expected):
    ref_mesh, port_mesh = _both_meshes(mesh_shape, axes)
    assert ref_sharding._batch_dim_axes(ref_mesh, batch) == expected
    assert sharding._batch_dim_axes(port_mesh, batch) == expected


def test_batch_specs_shapes():
    ref_mesh, port_mesh = _both_meshes((1, 1), ("data", "model"))
    ref = ref_sharding.batch_specs(None, ref_mesh, {
        "tokens": jax.ShapeDtypeStruct((8, 16), jax.numpy.int32),
        "labels": jax.ShapeDtypeStruct((8, 16), jax.numpy.int32)}, 8)
    port = sharding.batch_specs(None, port_mesh, {
        "tokens": torch.empty((8, 16), dtype=torch.int32, device="meta"),
        "labels": torch.empty((8, 16), dtype=torch.int32, device="meta")}, 8)
    assert ref["tokens"] == P("data", None)
    assert port["tokens"] == ("data", None)
    assert {k: tuple(v) for k, v in ref.items()} == port


# ---------------------------------------------------------------------------
# every cell's placements and stand-ins
# ---------------------------------------------------------------------------

def _ref_flat(tree) -> dict:
    """{path: leaf} of a reference tree (NamedSharding and SDS leaves)."""
    out = {}
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    for path, leaf in leaves:
        key = tuple(str(getattr(e, "key", getattr(e, "name", getattr(e, "idx", e))))
                    for e in path)
        out[key] = leaf
    return out


def _port_flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, OptState):
        out = {}
        for name in tree._fields:
            out.update(_port_flat(getattr(tree, name), path + (name,)))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, sharding.NamedSharding):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, path + (str(i),)))
        return out
    return {path: tree}


def _cells():
    out = []
    for arch in port_registry.ARCH_IDS:
        for shape_name in port_base.SHAPES:
            ok, _ = port_base.shape_applicable(port_registry.get_config(arch),
                                               port_base.SHAPES[shape_name])
            if ok:
                out.append((arch, shape_name))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape_name", _cells())
def test_cell_shardings_and_input_specs_match_reference(arch, shape_name, mesh_name):
    ref_mesh, port_mesh = _both_meshes(*MESHES[mesh_name])
    ref_cfg, port_cfg = ref_registry.get_config(arch), port_registry.get_config(arch)
    ref_shape, port_shape = ref_base.SHAPES[shape_name], port_base.SHAPES[shape_name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # sanitize_spec's notices
        ref_specs = ref_steps.input_specs(ref_cfg, ref_shape)
        port_specs = steps.input_specs(port_cfg, port_shape)
        ref_sh = ref_steps.cell_shardings(ref_cfg, ref_shape, ref_mesh, ref_specs)
        port_sh = steps.cell_shardings(port_cfg, port_shape, port_mesh, port_specs)

    # stand-ins: shape and dtype, leaf by leaf; the cache position is a
    # host int in the port, the reference's () int32 scalar
    ref_in, port_in = _ref_flat(ref_specs), _port_flat(port_specs)
    assert sorted(ref_in) == sorted(port_in)
    for key, ref_leaf in ref_in.items():
        leaf = port_in[key]
        if isinstance(leaf, int):
            assert key[-1] == "pos" and (tuple(ref_leaf.shape), str(ref_leaf.dtype)) == ((), "int32")
            continue
        assert leaf.device.type == "meta", key
        assert tuple(leaf.shape) == tuple(ref_leaf.shape), key
        assert str(leaf.dtype).removeprefix("torch.") == str(ref_leaf.dtype), key

    # placements: (in dict, out tuple), spec for spec
    for ref_tree, port_tree in zip(ref_sh, port_sh):
        ref_flat, port_flat = _ref_flat(ref_tree), _port_flat(port_tree)
        assert sorted(ref_flat) == sorted(port_flat)
        for key, ref_ns in ref_flat.items():
            assert isinstance(port_flat[key], sharding.NamedSharding), key
            assert port_flat[key].spec == tuple(ref_ns.spec), key
    assert port_sh[0]["params"]["embed"].mesh is port_mesh
    if port_shape.kind == "train":
        assert port_sh[0]["opt"].step.spec == ()


# ---------------------------------------------------------------------------
# the activation helpers
# ---------------------------------------------------------------------------

def test_helpers_return_their_input_off_a_mesh():
    x = torch.zeros(4, 8, 6)
    tree = {"attn": {"wq": torch.zeros(6, 4)}, "attn_norm": torch.zeros(6)}
    assert sharding.current_mesh() is None
    assert sharding.shard_activations(x) is x
    assert sharding.shard_heads(x, "batch", head_axis=2) is x
    assert sharding.gather_fsdp(tree) is tree
    mesh = compat.abstract_mesh((2, 2), ("data", "model"))
    with compat.use_mesh(mesh):
        assert sharding.current_mesh() is mesh
        # plain tensors inside a mesh, and mode "none", stay as they are
        assert sharding.shard_activations(x) is x
        assert sharding.shard_heads(x, "batch_seq") is x
        assert sharding.gather_fsdp(tree, "none") is tree
    assert sharding.current_mesh() is None


_HELPERS = r"""
import json, sys
import torch
from torch.distributed.tensor import distribute_tensor, Replicate
from repro_torch.dist import compat, sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_named_mesh

cases = json.loads(sys.argv[1])
dryrun.fake_group(8)
mesh = make_named_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
out = {}

def dt(shape):
    return distribute_tensor(torch.zeros(shape, device="meta"), mesh,
                             [Replicate()] * 3, src_data_rank=None)

def spec_of(x):
    return [[p.dim if hasattr(p, "dim") else None for p in x.placements]]

with compat.use_mesh(mesh):
    for name, case in cases.items():
        x = dt(case["shape"])
        if case["helper"] == "shard_activations":
            y = sharding.shard_activations(x, case["mode"])
        elif case["helper"] == "shard_heads":
            y = sharding.shard_heads(x, case["mode"], head_axis=case["axis"])
        else:
            y = sharding.gather_fsdp({"mlp": {case["leaf"]: x}}, case["mode"])["mlp"][case["leaf"]]
        out[name] = {"placements": [str(p) for p in y.placements],
                     "expected": [str(p) for p in sharding.placements(
                         tuple(tuple(e) if isinstance(e, list) else e for e in case["spec"]), mesh)],
                     "none_is_input": sharding.shard_activations(x, "none") is x}
    # the hand-written kernels refuse a DTensor, naming themselves
    from repro_torch.kernels import ops
    refused = {}
    for name, call in (("flash_attention", lambda t: ops.flash_attention(t, t, t)),
                       ("absmax", ops.absmax)):
        try:
            call(dt((2, 8, 2, 4)))
            refused[name] = "accepted"
        except TypeError as e:
            refused[name] = str(e)
print(json.dumps({"cases": out, "refused": refused}))
"""


def _ref_cases() -> dict:
    """The reference's spec for each helper call, from its own functions."""
    mesh = ref_compat.abstract_mesh((2, 2, 2), ("pod", "data", "model"))

    def sanitized(spec, shape):
        return [list(e) if isinstance(e, tuple) else e
                for e in ref_sharding.sanitize_spec(P(*spec), shape, mesh)]

    cases = {}
    for mode in ("batch", "batch_seq"):
        for shape in ((8, 6, 4), (4, 6, 4), (3, 6, 4), (8, 6)):
            b = ref_sharding._batch_dim_axes(mesh, shape[0])
            seq = "model" if (mode == "batch_seq" and len(shape) >= 3) else None
            spec = (b, seq, *((None,) * (len(shape) - 2)))
            cases[f"act-{mode}-{shape}"] = {"helper": "shard_activations", "mode": mode,
                                            "shape": shape, "spec": sanitized(spec, shape)}
    for shape, axis in (((8, 6, 4, 2), 2), ((8, 2, 6, 5, 3), 3), ((4, 6, 3, 2), 2)):
        spec = [None] * len(shape)
        spec[0] = ref_sharding._batch_dim_axes(mesh, shape[0])
        spec[axis] = "model"
        cases[f"heads-{shape}-{axis}"] = {"helper": "shard_heads", "mode": "batch",
                                          "axis": axis, "shape": shape,
                                          "spec": sanitized(spec, shape)}
    for leaf, shape in (("w_in", (6, 4)), ("w_out", (4, 6)), ("we_in", (2, 6, 4)),
                        ("conv_w", (4, 6)), ("w_in", (5, 3))):
        rule = ref_sharding._param_rule(leaf, len(shape))
        spec = [None if e == "data" else e for e in rule]
        cases[f"fsdp-{leaf}-{shape}"] = {"helper": "gather_fsdp", "mode": "batch",
                                         "leaf": leaf, "shape": shape,
                                         "spec": sanitized(spec, shape)}
    return cases


def test_helpers_place_dtensors_as_the_reference_specs():
    cases = _ref_cases()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _HELPERS, json.dumps(cases)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    got = record["cases"]
    assert sorted(got) == sorted(cases)
    for kernel, message in record["refused"].items():
        assert f"the {kernel} kernel takes plain tensors" in message, message
    for name, rec in got.items():
        assert rec["placements"] == rec["expected"], (name, cases[name]["spec"])
        assert rec["none_is_input"], name
