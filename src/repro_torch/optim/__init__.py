"""Optimizer-side pieces: AdamW with its cosine schedule and global-norm
clipping, and the gradient compressors of the compression hop with their
error-feedback wrapper."""
from repro_torch.optim.adamw import (
    OptState,
    adamw_init,
    adamw_update,
    adamw_update_,
    apply_updates,
    clip_by_global_norm,
    clip_by_global_norm_,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim.compression import (
    compress_int8,
    compress_topk,
    compressed_bytes,
    decompress_int8,
    decompress_topk,
    make_compressor,
)

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "adamw_update_",
    "apply_updates",
    "clip_by_global_norm",
    "clip_by_global_norm_",
    "compress_int8",
    "compress_topk",
    "compressed_bytes",
    "cosine_schedule",
    "decompress_int8",
    "decompress_topk",
    "global_norm",
    "make_compressor",
]
