"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/lib<name>_<hash>.so`` at
the root of the checkout, compiled for ``sm_90a`` with a plain C interface
(no PyTorch headers, so a build takes seconds). The hash covers the source,
every header in ``csrc/`` and the flags, so an edited source rebuilds. A
build writes to a temporary name and renames it into place, so two
processes building at once never load a half-written library.

Nothing here runs at import time; the first launch of a kernel builds it.
A failed build raises: nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# the compiler's output of each build in this process (ptxas registers, spills)
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the one under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives at the current sources."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> list[Path]:
    """Compile every library of ``names`` that is not built yet, all at once.

    One ``nvcc`` per source, started together and all waited for. Returns
    the library paths; raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = [library_path(n) for n in names]
    procs = []
    for name, target in zip(names, targets):
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
