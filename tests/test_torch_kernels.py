"""Port flash attention vs the JAX package's Pallas kernel, on the CPU.

The port's ``ops.flash_attention`` on CPU tensors runs the kernel's plain
PyTorch version; the reference runs ``flash_attention_pallas`` in interpret
mode, as the JAX package's own tests do. Inputs are made with numpy from a
seed and handed to both. Tolerances are the reference's own
(``tests/test_kernels.py``): f32 2e-5, bf16 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models.attention import mha_reference as jax_mha_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_qkv(seed, B, Sq, Sk, H, K, hd, dtype):
    """Same values for both packages: f32 normals rounded once to ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s, dtype=np.float32)
              for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd))]
    jx = [jnp.asarray(a).astype(JNP[dtype]) for a in arrays]
    pt = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    return jx, pt


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Sq,Sk,H,K,hd,causal,window,softcap",
    [
        (1, 128, 128, 4, 4, 32, True, 0, 0.0),     # MHA causal
        (2, 128, 128, 8, 2, 32, True, 0, 0.0),     # GQA 4x
        (1, 256, 256, 4, 1, 64, True, 0, 0.0),     # MQA
        (1, 128, 128, 4, 2, 32, True, 64, 0.0),    # sliding window
        (1, 128, 128, 4, 2, 32, True, 0, 30.0),    # grok-style softcap
        (2, 64, 192, 4, 4, 32, False, 0, 0.0),     # cross-attention shape
    ],
)
def test_flash_attention_matches_pallas(B, Sq, Sk, H, K, hd, causal, window,
                                        softcap, dtype):
    (jq, jk, jv), (tq, tk, tv) = make_qkv(0, B, Sq, Sk, H, K, hd, dtype)
    ref = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                 logit_softcap=softcap, block_q=64, block_k=64,
                                 interpret=True)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              logit_softcap=softcap)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = ATOL[dtype]
    np.testing.assert_allclose(as_np(out), as_np(ref), atol=tol, rtol=tol)


def test_flash_attention_q_offset():
    """Queries at absolute positions past the KV start (decode-time block)."""
    (jq, jk, jv), (tq, tk, tv) = make_qkv(1, 1, 64, 128, 4, 4, 32, "float32")
    ref = flash_attention_pallas(jq, jk, jv, causal=True, q_offset=64,
                                 block_q=64, block_k=64, interpret=True)
    out = ops.flash_attention(tq, tk, tv, causal=True, q_offset=64)
    np.testing.assert_allclose(as_np(out), as_np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128), (256, 256)])
def test_flash_attention_block_shapes(bq, bk):
    """The reference's block sweep: every tiling agrees with the port."""
    (jq, jk, jv), (tq, tk, tv) = make_qkv(2, 1, 256, 256, 4, 2, 32, "float32")
    ref = flash_attention_pallas(jq, jk, jv, causal=True, block_q=bq,
                                 block_k=bk, interpret=True)
    out = ops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(as_np(out), as_np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 40, 0), (False, 0, 0), (True, 0, 37),
])
def test_flash_attention_ragged(causal, window, q_offset):
    """Sq, Sk not multiples of the tile: the port masks the tails.

    The Pallas kernel asserts divisibility, so the reference here is the JAX
    package's ``mha_reference``.
    """
    (jq, jk, jv), (tq, tk, tv) = make_qkv(3, 2, 100, 100 + q_offset, 6, 2, 24,
                                          "float32")
    ref = jax_mha_reference(jq, jk, jv, causal=causal, window=window,
                            q_offset=q_offset)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              q_offset=q_offset)
    np.testing.assert_allclose(as_np(out), as_np(ref), atol=2e-5, rtol=2e-5)
    oracle = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                 q_offset=q_offset)
    np.testing.assert_allclose(as_np(out), as_np(oracle), atol=2e-5, rtol=2e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches or raises; it never computes on the CPU."""
    _, (tq, tk, tv) = make_qkv(4, 1, 64, 64, 2, 2, 32, "float32")
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(tq, tk, tv)
    assert flash_attention_cuda.launches == before


@pytest.mark.parametrize("bad", ["hd", "dtype", "gqa", "window"])
def test_inputs_the_kernel_does_not_take_raise(bad):
    shapes = dict(B=1, Sq=16, Sk=16, H=4, K=2, hd=32, dtype="float32")
    if bad == "hd":
        shapes["hd"] = 12
    if bad == "gqa":
        shapes["K"] = 3
    _, (tq, tk, tv) = make_qkv(5, **shapes)
    if bad == "dtype":
        tq, tk, tv = tq.half(), tk.half(), tv.half()
    kwargs = {"window": -1} if bad == "window" else {}
    with pytest.raises(ValueError):
        flash_attention_plain(tq, tk, tv, **kwargs)

