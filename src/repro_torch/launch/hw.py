"""Target-hardware constants for the roofline terms.

Datasheet figures, not measurements. ``H100_SXM`` is the card the port
runs on (NVIDIA H100 SXM5 80 GB datasheet: dense bf16 tensor-core peak,
HBM3 bandwidth and capacity; NVLink 4's 450 GB/s a direction, the
``beta_intra`` of ``core.collectives.H100_LINKS``). ``TPU_V5E`` is the JAX
package's target, kept as data so both packages' roofline terms can be
computed from the same figures.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float   # FLOP/s per chip
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link
    hbm_bytes: float         # HBM capacity per chip
    vmem_bytes: float


TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16e9,
    vmem_bytes=128 * 2 ** 20,
)

H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,            # NVLink, one direction
    hbm_bytes=80e9,
    vmem_bytes=228 * 2 ** 10,  # the on-chip scratch: shared memory per SM
)

DEFAULT_CHIP = H100_SXM
