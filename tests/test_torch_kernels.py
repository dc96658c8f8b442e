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
    BLOCK_K,
    BLOCK_Q,
    flash_attention_cuda,
    flash_attention_plain,
    kernel_for,
    tiles,
)
from repro_torch.models.attention import kv_block_range  # noqa: E402
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


@pytest.mark.parametrize("dtype,hd", [("bfloat16", 64), ("bfloat16", 128), ("float32", 64)])
def test_first_live_tile_fully_masked_at_the_kernels_tiles(dtype, hd):
    """A window that starts inside a KV tile with q_offset > 0: at the tiles
    of the kernel that takes these inputs (128 x 128 for the wgmma kernel),
    the block's last query rows see nothing of their first live tile, so
    the finite NEG_INF wipe (p = 1 terms cancelled by the next visible key's
    correction) is what keeps them right. Held against the JAX kernel."""
    B, Sq, Sk, H, K, window, q_offset = 1, 128, 384, 4, 2, 100, 256
    block_q, block_k = tiles(TORCH[dtype], hd)
    masked_first_tile = False
    for q_start in range(0, Sq, block_q):
        lo, _ = kv_block_range(q_start, min(block_q, Sq - q_start), Sk, block_k,
                               causal=True, window=window, q_offset=q_offset)
        last = q_offset + min(q_start + block_q, Sq) - 1
        masked_first_tile |= (lo + 1) * block_k - 1 <= last - window
    assert masked_first_tile
    (jq, jk, jv), (tq, tk, tv) = make_qkv(6, B, Sq, Sk, H, K, hd, dtype)
    ref = flash_attention_pallas(jq, jk, jv, causal=True, window=window, q_offset=q_offset,
                                 block_q=128, block_k=128, interpret=True)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window, q_offset=q_offset)
    tol = ATOL[dtype]
    np.testing.assert_allclose(as_np(out), as_np(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,hd,kernel", [
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"), ("bfloat16", 32, "mma_sync"),
    ("bfloat16", 256, "mma_sync"), ("bfloat16", 24, "mma_sync"), ("float32", 128, "fp32"),
])
def test_the_head_dim_rule_picks_one_kernel_and_its_tiles(dtype, hd, kernel):
    """The wrapper's rule: the wgmma kernel for bf16 at hd 64 or 128, the
    mma.sync kernel for other bf16 head dims, the fp32 kernel for fp32; the
    plain version walks the chosen kernel's tiles."""
    assert kernel_for(TORCH[dtype], hd) == kernel
    assert tiles(TORCH[dtype], hd) == ((BLOCK_Q, BLOCK_K) if kernel == "wgmma" else (64, 32))


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

