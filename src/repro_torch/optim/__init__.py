"""Optimizer-side pieces. This slice holds the gradient compressors of the
compression hop; AdamW comes with the trainer slice."""
from repro_torch.optim.compression import (
    compress_int8,
    compress_topk,
    compressed_bytes,
    decompress_int8,
    decompress_topk,
)

__all__ = [
    "compress_int8",
    "compress_topk",
    "compressed_bytes",
    "decompress_int8",
    "decompress_topk",
]
