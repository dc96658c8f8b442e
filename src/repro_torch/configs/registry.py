"""Architecture registry: --arch <id> resolution for launchers/tests/benchmarks."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ALL_SHAPES,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    shape_applicable,
)

# arch id -> module name under repro_torch.configs
_ARCH_MODULES: dict[str, str] = {
    "mixtral-8x22b": "mixtral_8x22b",
    "grok-1-314b": "grok_1_314b",
    "chameleon-34b": "chameleon_34b",
    "deepseek-67b": "deepseek_67b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma-7b": "gemma_7b",
    "llama3.2-3b": "llama3_2_3b",
    "mamba2-130m": "mamba2_130m",
    "whisper-tiny": "whisper_tiny",
    "hymba-1.5b": "hymba_1_5b",
}

# architectures only the port runs: resolvable by id, outside the grid the
# port shares with the JAX package (``ARCH_IDS``, ``iter_cells``)
_PORT_ONLY_MODULES: dict[str, str] = {
    "granite-4.0-h-small": "granite_4_0_h_small",
}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)
PORT_ONLY_IDS: tuple[str, ...] = tuple(_PORT_ONLY_MODULES)


def _module(arch: str):
    name = _ARCH_MODULES.get(arch) or _PORT_ONLY_MODULES.get(arch)
    if name is None:
        known = ", ".join(ARCH_IDS + PORT_ONLY_IDS)
        raise KeyError(f"unknown arch {arch!r}; available: {known}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def iter_cells(include_skipped: bool = False):
    """Yield (arch, shape, applicable, reason) for the assigned 10x4 grid."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            ok, reason = shape_applicable(cfg, shape)
            if ok or include_skipped:
                yield arch, shape, ok, reason
