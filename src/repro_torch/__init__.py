"""repro_torch — the Legio runtime's model path in PyTorch, for NVIDIA Hopper.

A second package beside the JAX package ``repro``, with the same subpackage
layout. It imports ``torch`` and never ``jax``, and nothing of ``repro``:
what it needs from there it keeps as its own copy. This slice holds the
serving path of the dense transformer:

  * ``configs``  — the ten architecture configs, field for field;
  * ``models``   — RMSNorm/RoPE, attention, the dense decoder, the KV cache,
    and ``convert`` to carry the JAX package's weights across;
  * ``kernels``  — the hand-written CUDA flash-attention kernel for sm_90a,
    built with ``nvcc`` at first use, and its plain PyTorch version;
  * ``serve`` / ``launch.serve`` — the request queue and the model-backed
    server (prefill + greedy decode).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a visible GPU they raise rather than fall back.
"""
