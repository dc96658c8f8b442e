"""Port int8 absmax/quantize vs the JAX package's Pallas kernels, on the CPU.

On CPU tensors the port's ``ops.absmax`` / ``ops.quantize_int8`` (and
``optim.compression.compress_int8`` above them) run the kernels' plain
PyTorch versions. The reference runs ``absmax_pallas`` and
``quantize_int8_with_scale`` in interpret mode with the scale computed on the
host, as the JAX package's own kernel tests do, and ``compress_int8_np``
is the sim data plane's twin. All three must agree bit for bit: scale bytes
and int8 payload bytes (tolerance: none).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quantize import absmax_pallas, quantize_int8_with_scale  # noqa: E402
from repro.optim.compression import compress_int8_np as ref_compress_int8_np  # noqa: E402
from repro.optim.compression import compress_topk_np, decompress_topk_np  # noqa: E402
from repro.optim.compression import compressed_bytes as ref_bytes  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quantize import (  # noqa: E402
    absmax_cuda,
    absmax_plain,
    int8_scale,
    quantize_int8_cuda,
    quantize_plain,
)
from repro_torch.kernels.ref import absmax_ref, quantize_int8_ref  # noqa: E402
from repro_torch.optim import compression as C  # noqa: E402

# the JAX package's kernel-test shapes (tests/test_kernels.py QUANT_SHAPES)
QUANT_SHAPES = [(4,), (130,), (1000,), (64, 257), (3, 5, 7)]
LENGTHS = [(1,), (127,), (128,), (129,), (100_003,)]


def tie_values() -> np.ndarray:
    """absmax 15.875 = 127 * 2^-3 makes the scale exactly 0.125, so every
    (k + 0.5) * 0.125 divides to an exact half: round half to even decides."""
    halves = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)) * np.float32(0.125)
    return np.concatenate([np.float32([15.875]), halves]).astype(np.float32)


def reciprocal_trap_values() -> np.ndarray:
    """Values within a few ulps of (k + 0.5) * scale for a scale that is no
    power of two: there ``x / s`` and ``x * (1 / s)`` round to different
    integers, so a quantizer that multiplies by the reciprocal fails here."""
    absmax = np.float32(11.6982651)
    s = np.maximum(absmax, np.float32(1e-12)) / np.float32(127.0)
    x = ((np.arange(-126, 126, dtype=np.float32) + np.float32(0.5)) * s).astype(np.float32)
    near = [x]
    for direction in (np.inf, -np.inf):
        y = x
        for _ in range(3):
            y = np.nextafter(y, np.float32(direction)).astype(np.float32)
            near.append(y)
    return np.concatenate([np.float32([absmax]), *near])


def subnormal_values() -> np.ndarray:
    rng = np.random.default_rng(11)
    tiny = rng.uniform(-1, 1, 64).astype(np.float32) * np.float32(1e-39)
    return np.concatenate([tiny, np.float32([3.0, -1e-40])])


CASES = {
    **{f"normal{shape}": (shape, None) for shape in QUANT_SHAPES + LENGTHS},
    "zeros": ((32,), np.zeros(32, np.float32)),
    "minus_2_5": ((1,), np.float32([-2.5])),
    "half_even_ties": (None, tie_values()),
    "reciprocal_trap": (None, reciprocal_trap_values()),
    "subnormals_mixed": (None, subnormal_values()),
    "subnormals_only": (None, subnormal_values()[:64]),
}


def case_input(name: str) -> np.ndarray:
    shape, values = CASES[name]
    if values is not None:
        return values
    rng = np.random.default_rng(sum(shape) * 7919 + len(shape))
    return (rng.standard_normal(shape) * 3.0).astype(np.float32)


def reference_pallas(g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """absmax kernel + host scale + quantize kernel, interpret mode."""
    am = np.float32(np.asarray(absmax_pallas(jnp.asarray(g), interpret=True)))
    scale = np.float32(np.maximum(am, np.float32(1e-12)) / np.float32(127.0))
    q = np.asarray(quantize_int8_with_scale(jnp.asarray(g), jnp.float32(scale),
                                            interpret=True))
    return scale, q


@pytest.mark.parametrize("name", list(CASES))
def test_port_quantize_matches_pallas_and_numpy_twin_bitwise(name):
    g = case_input(name)
    got = C.compress_int8(torch.from_numpy(g.copy()))
    scale, q = got.scale.numpy(), got.q.numpy()
    want_scale, want_q = reference_pallas(g)
    twin = ref_compress_int8_np(g)
    assert q.shape == g.shape and q.dtype == np.int8
    assert scale.tobytes() == want_scale.tobytes() == np.float32(twin.scale).tobytes()
    assert q.tobytes() == want_q.tobytes() == twin.q.tobytes()


def test_the_tie_case_has_ties_and_rounds_them_to_even():
    g = tie_values()
    q = C.compress_int8(torch.from_numpy(g)).q.numpy()
    exact = g[1:] / np.float32(0.125)
    assert np.all(exact - np.floor(exact) == 0.5)
    assert np.all(q[1:] % 2 == 0)      # every tie went to the even neighbour
    assert q[0] == 127


def test_the_reciprocal_trap_case_bites():
    g = reciprocal_trap_values()
    s = np.float32(np.abs(g).max()) / np.float32(127.0)
    assert (np.round(g / s) != np.round(g * (np.float32(1) / s))).sum() > 10


def test_minus_2_5_maps_to_minus_127():
    assert C.compress_int8(torch.tensor([-2.5])).q.tolist() == [-127]


def test_empty_tensor():
    """No launch, scale 1e-12 / 127 (the reference's empty-input scale) and
    an empty payload; the Pallas pair with the host scale agrees."""
    g = np.zeros((0,), np.float32)
    got = C.compress_int8(torch.from_numpy(g))
    want_scale, want_q = reference_pallas(g)
    assert got.scale.numpy().tobytes() == want_scale.tobytes()
    assert got.scale.numpy().tobytes() == (np.float32(1e-12) / np.float32(127.0)).tobytes()
    assert got.q.shape == (0,) and got.q.dtype == torch.int8 and want_q.shape == (0,)
    assert absmax_plain(torch.from_numpy(g)).item() == 0.0


@pytest.mark.parametrize("stale", [0.5, 0.01])
def test_values_past_127_scales_clip(stale):
    """An error-fed payload quantized with a scale from an earlier absmax
    (values past +-127 * scale) clips to +-127, as the Pallas kernel does."""
    rng = np.random.default_rng(5)
    g = (rng.standard_normal(777) * 4.0).astype(np.float32)
    scale = np.float32(np.float32(np.abs(g).max()) * np.float32(stale) / np.float32(127.0))
    got = quantize_plain(torch.from_numpy(g), torch.tensor(scale))
    want = np.asarray(quantize_int8_with_scale(jnp.asarray(g), jnp.float32(scale),
                                               interpret=True))
    twin = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    assert got.numpy().tobytes() == want.tobytes() == twin.tobytes()
    assert (np.abs(got.numpy().astype(np.int32)) == 127).sum() > 0


def test_int8_scale_divides_like_numpy():
    """The scale is an f32 division, never a multiplication by 1/127: over
    many absmax values it equals numpy's bit for bit."""
    am = np.random.default_rng(9).uniform(1e-6, 1e3, 200).astype(np.float32)
    got = torch.stack([int8_scale(torch.tensor(a)) for a in am]).numpy()
    want = np.maximum(am, np.float32(1e-12)) / np.float32(127.0)
    assert got.tobytes() == want.astype(np.float32).tobytes()
    # the plain quantize divides by a 0-d tensor exactly as numpy divides
    x = torch.from_numpy(am)
    s = np.float32(0.0123456)
    assert (x / torch.tensor(s)).numpy().tobytes() == (am / s).tobytes()


def test_roundtrip_error_bound():
    """Dequantized values sit within half a quantization step (the
    reference's ``test_quantize_roundtrip_error_bound``)."""
    g = np.random.default_rng(5).normal(size=(513,)).astype(np.float32)
    c = C.compress_int8(torch.from_numpy(g))
    back = C.decompress_int8(c).numpy()
    assert np.max(np.abs(back - g)) <= float(c.scale) * 0.5 + 1e-7
    twin = C.decompress_int8_np(ref_compress_int8_np(g))
    assert back.tobytes() == twin.tobytes()


@pytest.mark.parametrize("fraction", [0.05, 0.3])
def test_topk_matches_numpy_twin_with_ties(fraction):
    """Stable descending argsort: among equal |g| the lowest index wins, as
    numpy's stable argsort (and ``lax.top_k``) decide."""
    rng = np.random.default_rng(3)
    g = rng.integers(-4, 5, size=300).astype(np.float32)   # many ties
    got = C.compress_topk(torch.from_numpy(g), fraction)
    twin = compress_topk_np(g, fraction)
    assert got.indices.numpy().tobytes() == twin.indices.tobytes()
    assert got.values.numpy().tobytes() == twin.values.tobytes()
    back = C.decompress_topk(got, g.shape).numpy()
    assert back.tobytes() == decompress_topk_np(twin, g.shape).tobytes()


def test_compressed_bytes_accepts_tensors():
    g = np.zeros((64, 33), np.float32)
    t = torch.from_numpy(g)
    for scheme in ("int8", "topk", "none"):
        assert C.compressed_bytes(t, scheme, 0.05) == ref_bytes(g, scheme, 0.05)
        assert C.compressed_bytes(g, scheme, 0.05) == ref_bytes(g, scheme, 0.05)


def test_ops_dispatch_cpu_to_plain_and_ref():
    x = torch.from_numpy(case_input("normal(130,)"))
    am = ops.absmax(x)
    assert am.numpy().tobytes() == absmax_ref(x).numpy().tobytes()
    s = int8_scale(am)
    assert ops.quantize_int8(x, s).numpy().tobytes() == quantize_int8_ref(x, s).numpy().tobytes()


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_inputs():
    x = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        absmax_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_int8_cuda(x, torch.tensor(1.0))
    with pytest.raises(ValueError, match="float32"):
        absmax_plain(torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="scale"):
        quantize_plain(x, torch.tensor(1.0, dtype=torch.float64))
    assert absmax_cuda.launches == 0 and quantize_int8_cuda.launches == 0
