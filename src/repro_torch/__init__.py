"""repro_torch — the Legio runtime and its model paths in PyTorch, for NVIDIA Hopper.

A second package beside the JAX package ``repro``, with the same subpackage
layout. It imports ``torch`` and never ``jax``, and nothing of ``repro``:
what it needs from there it keeps as its own copy. It holds:

  * ``configs``  — the ten architecture configs, field for field;
  * ``models``   — RMSNorm/RoPE, attention, the dense and hybrid decoders,
    the Mamba-2 SSD layer and model, the KV/conv/state caches, and
    ``convert`` to carry the JAX package's weights across;
  * ``kernels``  — the hand-written CUDA kernels for sm_90a (flash
    attention, the SSD scan, the int8 absmax/quantize pair), built with
    ``nvcc`` at first use, each beside its plain PyTorch version;
  * ``serve`` / ``launch.serve`` — the serving subsystem (router,
    micro-batcher, the continuous-batching ``ServeEngine`` with requeue,
    dedup, decode-state migration and admission control, traffic and
    metrics) and the model-backed server (prefill + greedy decode) under it;
  * ``core`` / ``mpi`` / ``dist`` / ``checkpoint`` / ``optim`` / ``data`` —
    the Legio runtime: the control plane (topology, detection, agreement,
    the fault pipeline, recovery strategies), the §V hierarchical
    collectives over a data plane that keeps payloads on the card, the
    ``Session``/``Comm`` facade, peer replicas and the gradient
    compressors of the cross-legion hop, the resilient trainer, and the
    fault zoo (``core.faultmodel``, ``core.chaos``).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a visible GPU they raise rather than fall back.
"""
