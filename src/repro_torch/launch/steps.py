"""Step functions, stand-in inputs and their placements, for the dry-run and
the card.

Every (arch × shape) cell runs exactly one of three step kinds:

  train    -> ``train_step(params, opt, batch)``   (fwd + bwd + AdamW)
  prefill  -> ``prefill_step(params, batch)``      (forward + cache build)
  decode   -> ``serve_step(params, cache, tokens)`` (one token, KV cache of
              seq_len — ``decode_*`` / ``long_*`` run THIS, not train_step)

``input_specs`` returns stand-ins on the ``meta`` device for every input
(params and optimizer state included: nothing is allocated), keyed by the
step function's keyword names, as the reference's ShapeDtypeStructs are.
The decode cache's position is a host int in the port (the reference's
int32 scalar); :func:`argument_bytes` counts it as those 4 bytes.

``cell_shardings`` gives the placement of every input and output as a
:class:`~repro_torch.dist.sharding.NamedSharding` (mesh, spec), in the
reference's structure. The train step updates the parameters and moments
in place (``adamw_update_``: the reference's donated buffers), so its
outputs are its inputs.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec, TrainConfig
from repro_torch.core.trainer import make_train_step
from repro_torch.dist.sharding import (
    NamedSharding,
    _batch_dim_axes,
    batch_specs,
    cache_specs,
    leaf_spec,
)
from repro_torch.models import api
from repro_torch.models.common import torch_dtype
from repro_torch.optim import OptState, adamw_init

PyTree = Any
META = torch.device("meta")


# ---------------------------------------------------------------------------
# Stand-in state (meta tensors — no allocation)
# ---------------------------------------------------------------------------

def _meta(spec_tree):
    if isinstance(spec_tree, dict):
        return {k: _meta(v) for k, v in spec_tree.items()}
    shape, dtype = spec_tree
    return torch.empty(shape, dtype=torch_dtype(dtype), device=META)


def abstract_params(cfg: ModelConfig) -> PyTree:
    return _meta(api.param_specs(cfg))


def abstract_opt(cfg: ModelConfig, params: PyTree | None = None) -> OptState:
    params = params if params is not None else abstract_params(cfg)
    return adamw_init(params)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return api.init_cache(cfg, batch, max_len, device=META)


def abstract_batch(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Model inputs for a train/prefill step (tokens/labels/embeds)."""
    B, S = shape.global_batch, shape.seq_len

    def sds(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=META)

    batch: dict = {}
    if cfg.is_encoder_decoder:
        # stub audio frontend: precomputed frame embeddings
        batch["embeds"] = sds((B, cfg.encoder_seq_len, cfg.d_model), torch.bfloat16)
        batch["tokens"] = sds((B, S), torch.int32)
    elif cfg.frontend == "patch":
        # stub patch frontend: precomputed early-fusion embeddings
        batch["embeds"] = sds((B, S, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = sds((B, S), torch.int32)
    if shape.kind == "train":
        batch["labels"] = sds((B, S), torch.int32)
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta stand-ins for every input of the cell's step fn."""
    params = abstract_params(cfg)
    if shape.kind == "train":
        return {
            "params": params,
            "opt": abstract_opt(cfg, params),
            "batch": abstract_batch(cfg, shape),
        }
    if shape.kind == "prefill":
        return {"params": params, "batch": abstract_batch(cfg, shape)}
    # decode: one new token against a seq_len-deep cache
    return {
        "params": params,
        "cache": abstract_cache(cfg, shape.global_batch, shape.seq_len),
        "tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32, device=META),
    }


def argument_bytes(tree: PyTree) -> int:
    """Bytes of the inputs a device holds: each tensor leaf's local block
    (``to_local()`` of a DTensor), and 4 for a host int (the cache position,
    an int32 scalar in the reference)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for leaf in torch.utils._pytree.tree_leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, int):
            total += 4
    return total


def spec_bytes(specs: dict, in_sh: dict) -> int:
    """Bytes of the blocks the cell's specs give a device, from shapes alone:
    a dim split over mesh axes holds its size over their product; a host int
    counts 4, as in :func:`argument_bytes`."""
    import math

    from repro_torch.dist.sharding import mesh_sizes

    def walk(leaf, sh) -> int:
        if isinstance(leaf, dict):
            return sum(walk(leaf[k], sh[k]) for k in leaf)
        if isinstance(leaf, tuple):
            return sum(walk(a, b) for a, b in zip(leaf, sh))
        if isinstance(leaf, int):
            return 4
        sizes = mesh_sizes(sh.mesh)
        n = leaf.element_size()
        for d, size in enumerate(leaf.shape):
            entry = sh.spec[d] if d < len(sh.spec) else None
            axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            n *= size // math.prod(sizes[a] for a in axes)
        return n

    return sum(walk(specs[k], in_sh[k]) for k in specs)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def train_step_fn(cfg: ModelConfig, tc: TrainConfig | None = None) -> Callable:
    """(params, opt, batch) -> (params, opt, metrics): the trainer's one-rank
    step (``core.trainer.make_train_step``) at gradient scale 1: gradients ->
    ``clip_by_global_norm`` -> AdamW at ``cosine_schedule(step)``, applied
    in place leaf by leaf, ``grad_norm`` in the metrics."""
    step = make_train_step(cfg, tc or TrainConfig())
    return lambda params, opt, batch: step(params, opt, batch, 1.0)


def _keys(cfg: ModelConfig) -> tuple[str, ...]:
    if cfg.is_encoder_decoder or cfg.frontend == "patch":
        return ("embeds",)
    return ()


def prefill_step_fn(cfg: ModelConfig, max_len: int) -> Callable:
    def prefill_step(params, batch):
        kw = {}
        if "embeds" in _keys(cfg):
            kw["embeds"] = batch["embeds"]
        tokens = batch.get("tokens")
        if tokens is None:
            # patch-frontend prefill: positions come from embeds
            B, S = batch["embeds"].shape[0], batch["embeds"].shape[1]
            tokens = torch.zeros((B, S), dtype=torch.int32, device=batch["embeds"].device)
        logits, cache = api.prefill(cfg, params, tokens, max_len, **kw)
        return logits, cache

    return prefill_step


def serve_step_fn(cfg: ModelConfig) -> Callable:
    def serve_step(params, cache, tokens):
        return api.decode_step(cfg, params, cache, tokens)

    return serve_step


def step_fn_for(cfg: ModelConfig, shape: ShapeSpec,
                tc: TrainConfig | None = None) -> Callable:
    if shape.kind == "train":
        return train_step_fn(cfg, tc)
    if shape.kind == "prefill":
        return prefill_step_fn(cfg, shape.seq_len)
    return serve_step_fn(cfg)


# ---------------------------------------------------------------------------
# Placements of a cell's inputs and outputs
# ---------------------------------------------------------------------------

def _param_shardings(mesh, tree: PyTree, path: tuple = ()) -> PyTree:
    if isinstance(tree, dict):
        return {k: _param_shardings(mesh, v, path + (str(k),)) for k, v in tree.items()}
    return NamedSharding(mesh, leaf_spec(path, tuple(tree.shape), mesh))


def _named(mesh, specs: dict) -> dict:
    return {k: NamedSharding(mesh, s) for k, s in specs.items()}


def cell_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                   specs: dict) -> tuple[dict, Any]:
    """(in shardings keyed like input_specs, out shardings) for a cell."""
    p_shard = _param_shardings(mesh, specs["params"])
    repl = NamedSharding(mesh, ())

    if shape.kind == "train":
        o = specs["opt"]
        opt_shard = OptState(step=repl, mu=_param_shardings(mesh, o.mu),
                             nu=_param_shardings(mesh, o.nu))
        b_shard = _named(mesh, batch_specs(cfg, mesh, specs["batch"], shape.global_batch))
        in_sh = {"params": p_shard, "opt": opt_shard, "batch": b_shard}
        # outputs: (params, opt, metrics); ``repl`` stands for every
        # (scalar) metric leaf, as the reference's pytree prefix
        return in_sh, (p_shard, opt_shard, repl)

    if shape.kind == "prefill":
        b_shard = _named(mesh, batch_specs(cfg, mesh, specs["batch"], shape.global_batch))
        cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
        c_shard = _named(mesh, cache_specs(cfg, mesh, cache, shape.global_batch))
        logits_sh = _logits_sharding(cfg, mesh, shape)
        return {"params": p_shard, "batch": b_shard}, (logits_sh, c_shard)

    # decode
    c_shard = _named(mesh, cache_specs(cfg, mesh, specs["cache"], shape.global_batch))
    t_shard = _named(mesh, batch_specs(cfg, mesh, {"tokens": specs["tokens"]},
                                       shape.global_batch))["tokens"]
    logits_sh = _logits_sharding(cfg, mesh, shape)
    return ({"params": p_shard, "cache": c_shard, "tokens": t_shard},
            (logits_sh, c_shard))


def _logits_sharding(cfg: ModelConfig, mesh, shape: ShapeSpec) -> NamedSharding:
    b = _batch_dim_axes(mesh, shape.global_batch)
    return NamedSharding(mesh, (b, None, None))
