"""The port's examples (``examples_torch/``) against the reference's
(``examples/``), on the CPU.

- Every twin imports cleanly and exposes ``main()``, and the two folders
  hold the same file names (``tests/test_examples.py``'s contract).
- Each twin in its smallest documented form with ``--device cpu`` prints
  what its reference prints, line for line, the reference run under the
  stand-in ``repro.dist.dataplane`` of ``test_torch_runtime.py``. Model
  weights are the reference's (its ``init_params`` at the same seed,
  carried across with ``params_from_reference``). Masked: the wall-clock
  figures (a repair's ``wall=``, the screen's seconds); the checkpoint
  directory is the same path for both runs. Losses agree within the
  case's tolerance plus one unit of the printed last place; every other
  character is equal. ``resilient_training`` runs twice: in fp32, held to
  1e-4 as ``test_torch_train.py`` holds the trainer, and as written, in
  bf16, held to ``test_torch_train.py``'s bf16 loss tolerance (2e-2): the
  two libraries round bf16 differently, and after 20 steps the losses are
  some 3.5e-4 apart.
- Without a card a twin that builds a cluster raises unless given
  ``--device cpu``; nothing falls back to the CPU.

The training twin's two runs are in ``test_torch_examples_training.py``,
so that another test worker takes them.

Import-and-compare only at the CI sizes: a walkthrough is budgeted at
~60 s, as ``tests/test_examples.py`` says.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import inspect
import pathlib
import re
import shutil
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_runtime import _stand_in_module  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
TWINS = REPO / "examples_torch"
TWIN_FILES = sorted(TWINS.glob("*.py"))

# each example's smallest documented form: the CI forms where the reference
# names one, its defaults otherwise
ARGV = {
    "chaos_campaign": ["--preset", "rack_outage", "--preset", "transient_flap",
                       "--recovery", "substitute"],
    "continuous_serving": [],
    "elastic_respawn": [],
    "fleet_screening": [],
    "hierarchical_repair": [],
    "quickstart": [],
    "resilient_serving": [],
    "resilient_training": ["--tiny"],
    "spare_pool": [],
    "transparent_mpi": [],
}
# the twins that build a cluster, a session, a server or a trainer
NEED_DEVICE = sorted(set(ARGV) - {"hierarchical_repair"})
# case -> (example, its model's dtype where the case sets one, loss tolerance);
# the training twin's cases are in test_torch_examples_training.py
CASES = {name: (name, None, 1e-4) for name in ARGV if name != "resilient_training"}
TRAINING_CASES = {"resilient_training": ("resilient_training", "float32", 1e-4),
                  "resilient_training/bf16": ("resilient_training", None, 2e-2)}
MASKS = [(re.compile(r"wall=[\d.]+m?s"), "wall=*"),
         (re.compile(r"(\d+ repairs), [\d.]+s"), r"\1, *s")]
_FLOAT = re.compile(r"-?\d+\.\d+")


def _load(path: pathlib.Path, prefix: str):
    spec = importlib.util.spec_from_file_location(f"{prefix}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call_main(mod, argv: list[str], monkeypatch):
    """``main(argv)``, or ``main()`` with ``sys.argv`` set where it takes
    no arguments (the reference's examples read ``sys.argv``)."""
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    if inspect.signature(mod.main).parameters:
        return mod.main(argv)
    return mod.main()


def test_twins_mirror_the_examples():
    assert [p.name for p in TWIN_FILES] == sorted(p.name for p in EXAMPLES.glob("*.py"))
    assert sorted(ARGV) == [p.stem for p in TWIN_FILES]


@pytest.mark.parametrize("path", TWIN_FILES, ids=lambda p: p.stem)
def test_twin_imports_and_has_main(path):
    mod = _load(path, "twin")
    assert callable(getattr(mod, "main", None)), f"{path.name} must expose a main() entry point"


@pytest.fixture
def one_thread():
    """The twins' eager ops are small: on a busy host, torch's intra-op
    threads only contend (the training twin ran 14x slower beside five
    other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's ``init_params`` gives the reference's weights at the same
    seed: the model-backed twins then compute what the reference does."""
    from repro.configs.base import ModelConfig as JaxModelConfig
    from repro.models import api as jax_api
    from repro_torch.models import api
    from repro_torch.models.convert import params_from_reference

    def init(cfg, generator=None, device="cuda"):
        seed = 0 if generator is None else generator.initial_seed()
        jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
        tree = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(seed)))
        return params_from_reference(cfg, tree, device=device)

    monkeypatch.setattr(api, "init_params", init)


def _masked(out: str) -> list[str]:
    lines = out.splitlines()
    for pattern, repl in MASKS:
        lines = [pattern.sub(repl, line) for line in lines]
    return lines


def _same_line(got: str, want: str, tol: float) -> bool:
    """Equal, or a loss line whose numbers agree within ``tol`` (relative)
    plus one unit of the printed last place and whose text is equal."""
    if got == want:
        return True
    if "loss" not in want or _FLOAT.sub("#", got) != _FLOAT.sub("#", want):
        return False
    for a, b in zip(_FLOAT.findall(got), _FLOAT.findall(want)):
        ulp = 10.0 ** -len(b.split(".")[1])
        if abs(float(a) - float(b)) > tol * max(1.0, abs(float(b))) + ulp:
            return False
    return True


def _load_case(path: pathlib.Path, prefix: str, dtype: str | None):
    mod = _load(path, prefix)
    if dtype is not None:
        mod.MODEL_TINY = mod.MODEL_TINY.replace(dtype=dtype, param_dtype=dtype)
    return mod


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_prints_what_the_reference_prints(case, monkeypatch, capsys, reference_weights,
                                               one_thread, tmp_path):
    compare(*CASES[case], monkeypatch, capsys, tmp_path)


def compare(name: str, dtype: str | None, tol: float, monkeypatch, capsys, tmp_path) -> None:
    """The reference example ``name`` under the stand-in, then its twin with
    ``--device cpu``: the same exit code and the same lines (module
    docstring)."""
    argv = ARGV[name]
    ckpt = tmp_path / "legio_ckpt"
    mkdtemp = tempfile.mkdtemp

    def fixed_dir(*args, prefix=None, **kwargs):
        """The examples' checkpoint directory, the same path for both runs."""
        if prefix != "legio_ckpt_":
            return mkdtemp(*args, prefix=prefix, **kwargs)
        shutil.rmtree(ckpt, ignore_errors=True)
        ckpt.mkdir()
        return str(ckpt)

    monkeypatch.setattr(tempfile, "mkdtemp", fixed_dir)
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "repro.dist.dataplane", _stand_in_module())
        want_rc = _call_main(_load_case(EXAMPLES / f"{name}.py", "reference", dtype), argv, mp)
    want = _masked(capsys.readouterr().out)
    twin = _load_case(TWINS / f"{name}.py", "twin", dtype)
    got_rc = _call_main(twin, argv + (["--device", "cpu"] if name in NEED_DEVICE else []),
                        monkeypatch)
    got = _masked(capsys.readouterr().out)
    assert got_rc == want_rc
    assert len(got) == len(want) > 0, "\n".join(got)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same_line(g, w, tol), f"line {i}:\n  twin:      {g}\n  reference: {w}"


@pytest.mark.parametrize("name", NEED_DEVICE)
def test_twin_needs_the_card_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    twin = _load(TWINS / f"{name}.py", "twin")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _call_main(twin, ARGV[name], monkeypatch)
