from repro_torch.models.api import (
    count_params,
    decode_step,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "count_params",
    "decode_step",
    "init_cache",
    "init_params",
    "prefill",
]
