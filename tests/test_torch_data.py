"""The port's counter-based data pipeline vs the JAX package's, on the CPU.

Every shard must be the same pure function of (seed, step, shard) in both
packages, byte for byte: DROP, REBALANCE and restart-only-failed rest on
it. The port computes the threefry streams in numpy (``data.threefry``);
each primitive is held bitwise against the installed jax (0.9.0,
``jax_threefry_partitionable=True``), then ``make_batch`` over a sweep of
seeds, steps, shards, batch sizes, sequence lengths (past t = 20, where
``3**t`` leaves int32, and past t = 64, where ``jnp.power``'s 6-bit
exponent wraps) and vocabularies.
"""
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro_torch.data import pipeline, threefry  # noqa: E402
from repro_torch.data.pipeline import ShardAssignment  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 12345, 2 ** 31 - 1]
SEQ_LENS = [1, 19, 20, 33, 1024]
VOCABS = [64, 512, 50257, 128256]
COUNTERS = [0, 1, 7, 999, 1000]


def as_bytes(x):
    return np.asarray(x).tobytes()


# ---------------------------------------------------------------------------
# threefry primitives, one by one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert as_bytes(jax.random.PRNGKey(seed)) == threefry.prng_key(seed).tobytes()


@pytest.mark.parametrize("data", [0, 1, 999, 1000, 2 ** 31 - 1, 2 ** 32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    assert as_bytes(want) == threefry.fold_in(threefry.prng_key(seed), data).tobytes()


@pytest.mark.parametrize("num", [2, 3, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    pkey = threefry.fold_in(threefry.prng_key(seed), 5)
    assert as_bytes(jax.random.split(key, num)) == threefry.split(pkey, num).tobytes()


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (8, 1025)])
def test_random_bits(shape):
    key = jax.random.PRNGKey(12345)
    assert as_bytes(jax.random.bits(key, shape)) == \
        threefry.random_bits(threefry.prng_key(12345), shape).tobytes()


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 2), (0, 64), (0, 50257), (0, 128256),
                                   (0, 2 ** 31 - 1), (-5, 17), (3, 3), (4, 2)])
def test_randint(lo, hi):
    key = jax.random.PRNGKey(7)
    want = jax.random.randint(key, (4, 33), lo, hi)
    got = threefry.randint(threefry.prng_key(7), (4, 33), lo, hi)
    assert got.dtype == np.int32
    assert as_bytes(want) == got.tobytes()


@pytest.mark.parametrize("shape", [(1,), (8, 1025)])
def test_uniform(shape):
    key = jax.random.PRNGKey(3)
    got = threefry.uniform(threefry.prng_key(3), shape)
    assert got.dtype == np.float32
    assert as_bytes(jax.random.uniform(key, shape)) == got.tobytes()


def test_key_bounds_are_checked():
    with pytest.raises(ValueError):
        threefry.prng_key(2 ** 31)
    with pytest.raises(ValueError):
        threefry.randint(threefry.prng_key(0), (2,), 0, 2 ** 31)


# ---------------------------------------------------------------------------
# make_batch over the sweep
# ---------------------------------------------------------------------------

SWEEP = [(seed, COUNTERS[(i + j) % 5], COUNTERS[(2 * i + j + 1) % 5], 1 + (i + 3 * j) % 8,
          seq, VOCABS[(i + j) % 4])
         for i, seed in enumerate(SEEDS) for j, seq in enumerate(SEQ_LENS)]


@pytest.mark.parametrize("seed,step,shard,batch,seq_len,vocab", SWEEP)
def test_make_batch_byte_equal(seed, step, shard, batch, seq_len, vocab):
    want = jax_pipeline.make_batch(seed, step, shard, batch=batch, seq_len=seq_len,
                                   vocab_size=vocab)
    got = pipeline.make_batch(seed, step, shard, batch=batch, seq_len=seq_len,
                              vocab_size=vocab, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32 and tuple(got[k].shape) == (batch, seq_len)
        assert got[k].numpy().tobytes() == as_bytes(want[k]), k


@pytest.mark.parametrize("step,shard", [(0, 0), (1000, 1000), (17, 999)])
def test_host_batch_numpy_equal(step, shard):
    want = jax_pipeline.host_batch_numpy(1, step, shard, batch=3, seq_len=70, vocab_size=97)
    got = pipeline.host_batch_numpy(1, step, shard, batch=3, seq_len=70, vocab_size=97)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes()


def test_global_batch_and_shard_batch_equal():
    want = jax_pipeline.global_batch_for_step(0, 5, global_batch=8, seq_len=16,
                                              vocab_size=97, n_shards=4)
    got = pipeline.global_batch_for_step(0, 5, global_batch=8, seq_len=16,
                                         vocab_size=97, n_shards=4, device="cpu")
    for k in want:
        assert got[k].numpy().tobytes() == as_bytes(want[k])
    asg = [ShardAssignment(node=0, shards=(0, 3)), ShardAssignment(node=1, shards=()),
           ShardAssignment(node=2, shards=(2,))]
    from repro.data.pipeline import ShardAssignment as JAsg
    jasg = [JAsg(node=a.node, shards=a.shards) for a in asg]
    want = jax_pipeline.shard_batch(jasg, 4, 9, per_shard_batch=2, seq_len=24, vocab_size=53)
    got = pipeline.shard_batch(asg, 4, 9, per_shard_batch=2, seq_len=24, vocab_size=53,
                               device="cpu")
    assert sorted(got) == sorted(want) == [0, 2]
    for node in want:
        for k in want[node]:
            assert got[node][k].numpy().tobytes() == as_bytes(want[node][k])


def test_stream_properties():
    """test_data.py's properties on the port: determinism, alignment, range."""
    a = pipeline.make_batch(3, 7, 2, batch=4, seq_len=64, vocab_size=31, device="cpu")
    b = pipeline.make_batch(3, 7, 2, batch=4, seq_len=64, vocab_size=31, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 31
    c = pipeline.make_batch(3, 7, 3, batch=4, seq_len=64, vocab_size=31, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        got = pipeline.make_batch(0, 0, 0, batch=1, seq_len=4, vocab_size=64)
        assert got["tokens"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.make_batch(0, 0, 0, batch=1, seq_len=4, vocab_size=64)


def test_chip_smoke_digest_pinned_from_jax():
    """chip_smoke.py checks make_batch on the card machine (no jax there)
    against this digest; here it is pinned to jax's own tokens."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    want = jax_pipeline.make_batch(0, 0, 0, batch=1, seq_len=1024, vocab_size=128256)
    tokens = np.asarray(want["tokens"])
    assert tokens.dtype == jnp.int32
    assert hashlib.sha256(tokens.tobytes()).hexdigest() == chip_smoke.MAKE_BATCH_SHA256
    got = pipeline.make_batch(0, 0, 0, batch=1, seq_len=1024, vocab_size=128256, device="cpu")
    assert hashlib.sha256(got["tokens"].numpy().tobytes()).hexdigest() == \
        chip_smoke.MAKE_BATCH_SHA256
