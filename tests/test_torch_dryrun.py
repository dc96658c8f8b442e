"""The port's dry-run against the reference's.

- The two mini cells of tests/test_dryrun_mini.py (llama's smoke config at
  4 layers, a (2, 2, 2) pod/data/model mesh): the port runs them on torch's
  ``fake`` process group of 8 ranks, the reference compiles them on 8
  forced host devices, each in its own subprocess. Per-device argument
  bytes must be equal; the reference's other asserts are mirrored.
- ``roofline_terms`` and ``model_flops`` exact against the reference's,
  with the reference's ``TPU_V5E`` as the chip for both.
- The CLI once on both production meshes in one process (``--both-meshes
  --override n_layers=1``: the fake group of 512 ranks, then of 256), each
  record's argument bytes against the sum the specs give; the same for the
  four decode cells that once failed on a DTensor view (mixtral-8x22b and
  grok-1-314b on (2, 16, 16), whisper-tiny on both meshes).
- On a mesh of one rank the steps run on DTensors of real values and give
  bit for bit the plain steps' results: the constraints and the per-device
  blocks change no arithmetic.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch import hlo_stats as ref_hlo  # noqa: E402
from repro.launch.hw import TPU_V5E  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.configs import registry as port_registry  # noqa: E402
from repro_torch.dist import compat  # noqa: E402
from repro_torch.launch import hlo_stats, hw, steps  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 600

_PORT_MINI = textwrap.dedent("""
    import json
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_named_mesh

    dryrun.fake_group(8)
    mesh = make_named_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    cfg = get_smoke_config("llama3.2-3b").replace(n_layers=4)
    out = {}
    for shape in (ShapeSpec("mini_train", 64, 8, "train"),
                  ShapeSpec("mini_decode", 64, 8, "decode")):
        m = dryrun.dryrun_step(cfg, shape, mesh)
        out[shape.name] = {"flops": m["cost"].flops, "wire": m["cost"].coll.total_wire_bytes,
                           "arg_bytes": m["argument_bytes"], "peak": m["peak_bytes"]}
    print(json.dumps(out))
""")

# the reference's mini cells (tests/test_dryrun_mini.py), argument bytes only
_REF_MINI = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from repro.configs.base import ShapeSpec, TrainConfig
    from repro.configs.registry import get_smoke_config
    from repro.dist.compat import make_mesh, use_mesh
    from repro.launch.steps import cell_shardings, input_specs, step_fn_for

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = get_smoke_config("llama3.2-3b").replace(n_layers=4)
    out = {}
    for shape in (ShapeSpec("mini_train", 64, 8, "train"),
                  ShapeSpec("mini_decode", 64, 8, "decode")):
        specs = input_specs(cfg, shape)
        in_sh, out_sh = cell_shardings(cfg, shape, mesh, specs)
        fn = step_fn_for(cfg, shape, TrainConfig())
        with use_mesh(mesh):
            jitted = jax.jit(fn, in_shardings=tuple(in_sh[k] for k in specs),
                             out_shardings=out_sh)
            compiled = jitted.lower(*specs.values()).compile()
        out[shape.name] = {"arg_bytes": compiled.memory_analysis().argument_size_in_bytes}
    print(json.dumps(out))
""")


def _env(jax: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    if jax:
        env.pop("JAX_PLATFORMS", None)
    return env


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def mini():
    """(port, reference) records of the two mini cells, run side by side."""
    port = subprocess.Popen([sys.executable, "-c", _PORT_MINI], env=_env(False),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ref = subprocess.Popen([sys.executable, "-c", _REF_MINI], env=_env(True),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return _result(port), _result(ref)


@pytest.mark.parametrize("cell", ["mini_train", "mini_decode"])
def test_mini_argument_bytes_equal_the_reference(mini, cell):
    port, ref = mini
    assert port[cell]["arg_bytes"] == ref[cell]["arg_bytes"]
    assert port[cell]["peak"] >= port[cell]["arg_bytes"]


def test_mini_train_cell_runs(mini):
    r = mini[0]["mini_train"]
    assert r["flops"] > 1e6            # fwd+bwd+opt actually ran
    assert r["wire"] > 0               # gradient reduction present


def test_mini_decode_cell_runs(mini):
    port = mini[0]
    assert port["mini_decode"]["flops"] > 0
    # decode step is one token: orders less compute than the train step
    assert port["mini_decode"]["flops"] < port["mini_train"]["flops"] / 10


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flops,bytes_,wire", [
    (197e12, 0.0, 0.0), (197e11, 819e9, 0.0), (1e12, 1e9, 5e10), (0.0, 0.0, 0.0),
    (3.3e14, 2.2e11, 1.7e9),
])
def test_roofline_terms_match_the_reference(flops, bytes_, wire):
    port = hlo_stats.roofline_terms(flops, bytes_, wire, chip=TPU_V5E)
    assert port == ref_hlo.roofline_terms(flops, bytes_, wire, chip=TPU_V5E)
    # the reference's own case, on the port
    t = hlo_stats.roofline_terms(197e11, 819e9, 0.0, chip=TPU_V5E)
    assert t["dominant"] == "memory_s" and t["roofline_fraction"] == pytest.approx(0.1)


def test_roofline_terms_default_to_the_h100():
    assert hw.DEFAULT_CHIP is hw.H100_SXM
    t = hlo_stats.roofline_terms(989e12, 0.0, 0.0)
    assert t["compute_s"] == 1.0 and t["dominant"] == "compute_s"
    assert hlo_stats.roofline_terms(0.0, 3.35e12, 450e9)["collective_s"] == 1.0


@pytest.mark.parametrize("arch", port_registry.ARCH_IDS)
def test_model_flops_match_the_reference(arch):
    for name in port_base.SHAPES:
        assert hlo_stats.model_flops(port_registry.get_config(arch), port_base.SHAPES[name]) == \
            ref_hlo.model_flops(ref_registry.get_config(arch), ref_base.SHAPES[name])
    moe = port_registry.get_config("mixtral-8x22b")
    train = port_base.SHAPES["train_4k"]
    assert hlo_stats.model_flops(moe, train) == \
        6.0 * moe.active_params() * train.global_batch * train.seq_len


# ---------------------------------------------------------------------------
# the CLI on a production mesh
# ---------------------------------------------------------------------------

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def cli_both_meshes(tmp_path_factory) -> Path:
    """The CLI's records of one cell on both production meshes, from one
    process: the fake group of 512 ranks, then of 256."""
    out = tmp_path_factory.mktemp("dryrun_cli")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-3b",
         "--shape", "decode_32k", "--both-meshes", "--override", "n_layers=1",
         "--out", str(out)],
        env=_env(False), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return out


def _spec_bytes(cfg, shape, mesh) -> int:
    """Bytes of the local blocks the cell's input specs give a device."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        specs = steps.input_specs(cfg, shape)
        in_sh, _ = steps.cell_shardings(cfg, shape, mesh, specs)
    return steps.spec_bytes(specs, in_sh)


@pytest.mark.parametrize("mesh_tag,mesh_desc,n_devices", [
    ("pod2", "2x16x16 (pod,data,model) = 512 chips", 512),
    ("pod1", "16x16 (data,model) = 256 chips", 256),
])
def test_cli_writes_a_production_record(cli_both_meshes, mesh_tag, mesh_desc, n_devices):
    rec = json.loads((cli_both_meshes / f"llama3.2-3b_decode_32k_{mesh_tag}.json").read_text())
    assert rec["mesh"] == mesh_desc and rec["n_devices"] == n_devices
    assert rec["overrides"] == {"n_layers": 1} and not rec["skipped"]
    cfg = port_registry.get_config("llama3.2-3b").replace(n_layers=1)
    mesh = compat.abstract_mesh(*MESHES[mesh_tag])
    ma = rec["memory_analysis"]
    assert ma["argument_bytes"] == _spec_bytes(cfg, port_base.SHAPES["decode_32k"], mesh)
    assert ma["peak_bytes_per_device"] >= ma["argument_bytes"]
    assert rec["cost_analysis"]["flops_per_device"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    for dropped in ("compile_s", "xla_flops_unscaled", "temp_bytes"):
        assert dropped not in json.dumps(rec)


# the decode cells whose routing (MoE: one group of 128 tokens split over
# pod and data) or new K/V (whisper: 6 heads on 16) DTensor could not view
REPAIRED = {"mixtral-8x22b": ["--multi-pod"], "grok-1-314b": ["--multi-pod"],
            "whisper-tiny": ["--both-meshes"]}


@pytest.fixture(scope="module")
def cli_repaired(tmp_path_factory) -> Path:
    """The CLI's records of the repaired decode cells at one layer, one
    process an arch, all at once."""
    out = tmp_path_factory.mktemp("dryrun_repaired")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
         "decode_32k", *flags, "--override", "n_layers=1", "--out", str(out)],
        env=dict(_env(False), OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for arch, flags in REPAIRED.items()]
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, stdout[-2000:] + stderr[-3000:]
    return out


@pytest.mark.parametrize("arch,mesh_tag", [("mixtral-8x22b", "pod2"), ("grok-1-314b", "pod2"),
                                           ("whisper-tiny", "pod2"), ("whisper-tiny", "pod1")])
def test_repaired_decode_cells_complete(cli_repaired, arch, mesh_tag):
    rec = json.loads((cli_repaired / f"{arch}_decode_32k_{mesh_tag}.json").read_text())
    assert not rec["skipped"] and rec["overrides"] == {"n_layers": 1}
    cfg = port_registry.get_config(arch).replace(n_layers=1)
    mesh = compat.abstract_mesh(*MESHES[mesh_tag])
    ma = rec["memory_analysis"]
    assert ma["argument_bytes"] == ma["spec_argument_bytes"] == \
        _spec_bytes(cfg, port_base.SHAPES["decode_32k"], mesh)
    assert rec["cost_analysis"]["flops_per_device"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0


# ---------------------------------------------------------------------------
# the steps on DTensors of one rank against the plain steps
# ---------------------------------------------------------------------------

_ONE_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ShapeSpec, TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist.compat import use_mesh
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_named_mesh
    from repro_torch.models import api

    dryrun.fake_group(1)
    mesh = make_named_mesh((1, 1), ("data", "model"), device="cpu")
    out = {}

    def real(cfg, specs, seed):
        gen = torch.Generator().manual_seed(seed)
        params = api.init_params(cfg, gen, device="cpu")
        rng = np.random.default_rng(seed)

        def fill(leaf, path):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if path[0] == "params":
                t = params
                for k in path[1:]:
                    t = t[k]
                return t.clone()
            if leaf.dtype == torch.int32:
                return torch.from_numpy(rng.integers(0, cfg.vocab_size, leaf.shape,
                                                     dtype=np.int32))
            return torch.from_numpy(rng.standard_normal(leaf.shape).astype(np.float32)
                                    ).to(leaf.dtype) * 0.1

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if isinstance(tree, tuple) and hasattr(tree, "_fields"):
                return type(tree)(*(walk(v, path + (f,)) for f, v in zip(tree._fields, tree)))
            return fill(tree, path)

        return {k: walk(v, (k,)) for k, v in specs.items()}

    def flat(tree):
        leaves = torch.utils._pytree.tree_leaves(tree)
        return [l.full_tensor() if isinstance(l, DTensor) else l for l in leaves
                if isinstance(l, torch.Tensor)]

    for arch in sys.argv[1:]:
        cfg = get_smoke_config(arch).replace(n_layers=2)
        for shape in (ShapeSpec("t", 32, 2, "train"), ShapeSpec("p", 32, 2, "prefill"),
                      ShapeSpec("d", 32, 2, "decode")):
            specs = steps.input_specs(cfg, shape)
            args = real(cfg, specs, 7)
            if shape.kind == "train":
                args["opt"] = steps.adamw_init(args["params"])
            in_sh, _ = steps.cell_shardings(cfg, shape, mesh, specs)
            placed = {}
            for k, v in args.items():
                def put(leaf, sh):
                    if not isinstance(leaf, torch.Tensor):
                        return leaf
                    return DTensor.from_local(leaf.clone(), mesh, sh.placements, run_check=False)
                placed[k] = dryrun._zip_map(put, v, in_sh[k])
            fn = steps.step_fn_for(cfg, shape, TrainConfig())
            plain = flat(fn(**args))
            with use_mesh(mesh), implicit_replication():
                dt = flat(fn(**placed))
            same = len(plain) == len(dt) and all(
                a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(plain, dt))
            out[f"{arch}/{shape.kind}"] = {"same": same, "n": len(plain)}
    print(json.dumps(out))
""")


def test_steps_on_a_one_rank_mesh_match_the_plain_steps():
    archs = ["llama3.2-3b", "hymba-1.5b", "mamba2-130m"]
    proc = subprocess.run([sys.executable, "-c", _ONE_RANK, *archs], env=_env(False),
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(got) == sorted(f"{a}/{k}" for a in archs for k in ("train", "prefill", "decode"))
    for name, rec in got.items():
        assert rec["n"] > 0 and rec["same"], name


# the smoke mixtral prefill cell cold, a train cell of the same token count,
# the prefill cell again (DTensor's sharding cache then warm), in one fresh
# process on the mini mesh
_COLD_WARM = textwrap.dedent("""
    import json
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_named_mesh

    dryrun.fake_group(8)
    mesh = make_named_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    cfg = get_smoke_config("mixtral-8x22b")
    out = []
    for kind in ("prefill", "train", "prefill"):
        m = dryrun.dryrun_step(cfg, ShapeSpec(f"mini_{kind}", 64, 8, kind), mesh)
        out.append({"kind": kind, "bytes": m["cost"].bytes, "flops": m["cost"].flops,
                    "wire": m["cost"].coll.total_wire_bytes, "peak": m["peak_bytes"]})
    print(json.dumps(out))
""")


def test_moe_prefill_counts_the_same_cold_and_warm():
    """The ops DTensor's sharding propagation runs on a cache miss are not
    the device's: the prefill cell's bytes, FLOPs, wire bytes and peak are
    the same in a fresh process and after a train cell has warmed the
    cache."""
    proc = subprocess.run([sys.executable, "-c", _COLD_WARM], env=_env(False),
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cold, train, warm = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (cold["kind"], train["kind"], warm["kind"]) == ("prefill", "train", "prefill")
    assert cold["bytes"] > 0 and cold["flops"] > 0 and cold["wire"] > 0
    for key in ("bytes", "flops", "wire", "peak"):
        assert cold[key] == warm[key], key
