"""The port's AdamW, global-norm clip and cosine schedule vs the JAX package's.

Both run on identical inputs (gradients made with numpy from a seed and
carried across, and, for the update, the reference's own learning rate),
so the only differences left are the last-bit ones of two math libraries.
The elementwise update agrees within 1 ulp in float32 (measured: exactly)
and bf16 parameters exactly; the reductions (the global norm) and the
schedule's cos are each library's own, with the tolerances stated. The
optimizer's first step is where a difference would be amplified (m̂/√v̂ =
±1 elementwise), so the update is held on gradients that are identical,
never on gradients each package computed for itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TC = dict(learning_rate=3e-2, warmup_steps=4, total_steps=40)


def trees(dtype, seed=0):
    """(params, grads) as numpy trees of float32 values exact in ``dtype``."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (97, 33), "layers": {"w": (2, 33, 65), "norm": (2, 33)},
              "final_norm": (33,)}

    def draw(scale):
        def leaf(shape):
            x = rng.standard_normal(shape).astype(np.float32) * scale
            return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))
        return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))

    return draw(1.0), draw(1e-2)


def to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def to_torch(tree, dtype):
    return adamw.tree_map(lambda a: torch.from_numpy(np.array(a)).to(getattr(torch, dtype)),
                          tree)


def leaves_np(tree):
    """Every leaf as float32 numpy, in sorted-key order (both packages)."""
    return [x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
            for x in adamw.tree_leaves(tree)]


def assert_within_ulp(a_tree, b_tree, maxulp):
    for a, b in zip(leaves_np(a_tree), leaves_np(b_tree)):
        np.testing.assert_array_max_ulp(a, b, maxulp=maxulp)


@pytest.mark.parametrize("tc", [TC, dict(learning_rate=3e-4, warmup_steps=100, total_steps=1000),
                                dict(learning_rate=1e-3, warmup_steps=10, total_steps=100)])
def test_cosine_schedule(tc):
    """Within 2 ulp at every step: each side takes its own float32 cos (the
    port's is correctly rounded, XLA's is an ulp off at some angles), and
    ``1 + cos`` near the end of the decay magnifies an ulp of cos."""
    lj = jax_adamw.cosine_schedule(JaxTrainConfig(**tc))
    lp = adamw.cosine_schedule(TrainConfig(**tc))
    exact = 0
    for s in range(0, tc["total_steps"] + 5):
        want = np.asarray(lj(jnp.asarray(s, jnp.int32)), np.float32)
        got = lp(torch.tensor(s, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_max_ulp(want, got, maxulp=2)
        exact += int(want == got)
    assert exact >= tc["total_steps"] - 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm(dtype, max_norm):
    """The norm is a float32 sum over every element, in each library's own
    order: within 2e-6 relative (measured: at most 9 ulp). The clipped
    gradients then agree to the same relative error (float32) or within one
    bf16 step; without clipping (max_norm 1e3) they are the inputs, exactly."""
    grads, _ = trees(dtype)
    cj, nj = jax_adamw.clip_by_global_norm(to_jax(grads, dtype), max_norm)
    cp, np_ = adamw.clip_by_global_norm(to_torch(grads, dtype), max_norm)
    np.testing.assert_allclose(np_.numpy(), np.asarray(nj), rtol=2e-6)
    clipped = float(nj) > max_norm
    for a, b, g in zip(leaves_np(cj), leaves_np(cp), leaves_np(grads)):
        if not clipped:
            np.testing.assert_array_equal(b, g)
            np.testing.assert_array_equal(a, g)
        elif dtype == "float32":
            np.testing.assert_allclose(b, a, rtol=4e-6, atol=0)
        else:
            np.testing.assert_allclose(b, a, rtol=2 ** -7, atol=0)
    # the in-place form writes the same values and returns the same norm
    gp = to_torch(grads, dtype)
    norm = adamw.clip_by_global_norm_(gp, max_norm)
    assert norm.item() == np_.item()
    for a, b in zip(leaves_np(gp), leaves_np(cp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_steps_on_identical_gradients(dtype):
    """40 steps, each fed the same clipped gradients and the reference's lr."""
    tcj, tcp = JaxTrainConfig(**TC), TrainConfig(**TC)
    params, grads = trees(dtype)
    jp, jg = to_jax(params, dtype), to_jax(grads, dtype)
    pp, pg = to_torch(params, dtype), to_torch(grads, dtype)
    inplace = adamw.tree_map(torch.clone, pp)
    jo, po, io = jax_adamw.adamw_init(jp), adamw.adamw_init(pp), adamw.adamw_init(inplace)
    lr_fn = jax_adamw.cosine_schedule(tcj)
    for _ in range(40):
        jgc, _ = jax_adamw.clip_by_global_norm(jg, tcj.grad_clip)
        pgc = to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), jgc), dtype)
        lr = lr_fn(jo.step)
        plr = torch.from_numpy(np.asarray(lr))
        ju, jo = jax_adamw.adamw_update(jgc, jo, jp, tcj, lr)
        jp = jax_adamw.apply_updates(jp, ju)
        pu, po = adamw.adamw_update(pgc, po, pp, tcp, plr)
        pp = adamw.apply_updates(pp, pu)
        io = adamw.adamw_update_(pgc, io, inplace, tcp, plr)
        assert int(po.step) == int(io.step) == int(jo.step)
        for mj, mp, mi in ((jo.mu, po.mu, io.mu), (jo.nu, po.nu, io.nu), (jp, pp, inplace)):
            assert_within_ulp(mj, mp, 1)
            for a, b in zip(leaves_np(mp), leaves_np(mi)):
                np.testing.assert_array_equal(a, b)     # in place == pure, bit for bit
        if dtype == "bfloat16":
            for a, b in zip(leaves_np(jp), leaves_np(pp)):
                np.testing.assert_array_equal(a, b)


def test_adamw_update_is_pure():
    params, grads = trees("float32")
    pp, pg = to_torch(params, "float32"), to_torch(grads, "float32")
    before = [x.clone() for x in adamw.tree_leaves(pp) + adamw.tree_leaves(pg)]
    opt = adamw.adamw_init(pp)
    adamw.adamw_update(pg, opt, pp, TrainConfig(**TC), torch.tensor(1e-2))
    after = adamw.tree_leaves(pp) + adamw.tree_leaves(pg)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(opt.step) == 0 and all(
        int(torch.count_nonzero(m)) == 0 for m in adamw.tree_leaves(opt.mu))


def test_adamw_minimizes_quadratic():
    """test_optim.py's quadratic, on the port."""
    tc = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    lr = adamw.cosine_schedule(tc)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.adamw_init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        updates, opt = adamw.adamw_update(grads, opt, params, tc, lr(opt.step))
        params = adamw.apply_updates(params, updates)
    assert float(params["w"].abs().max()) < 0.05


def test_state_dtype_bfloat16_moments():
    """Moments kept in bf16 are updated in fp32 and stored rounded, as there."""
    params, grads = trees("float32")
    tcj, tcp = JaxTrainConfig(**TC), TrainConfig(**TC)
    jp, jg = to_jax(params, "float32"), to_jax(grads, "float32")
    pp, pg = to_torch(params, "float32"), to_torch(grads, "float32")
    jo = jax_adamw.adamw_init(jp, state_dtype="bfloat16")
    po = adamw.adamw_init(pp, state_dtype="bfloat16")
    lr = jnp.asarray(1e-2, jnp.float32)
    _, jo = jax_adamw.adamw_update(jg, jo, jp, tcj, lr)
    _, po = adamw.adamw_update(pg, po, pp, tcp, torch.tensor(1e-2))
    assert adamw.tree_leaves(po.mu)[0].dtype == torch.bfloat16
    for a, b in zip(leaves_np(jo.mu) + leaves_np(jo.nu), leaves_np(po.mu) + leaves_np(po.nu)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# make_compressor: error-feedback compression over a pytree
# (tests/test_optim.py's cases, each against the reference's own compressor)
# ---------------------------------------------------------------------------

def test_make_compressor_none_is_identity():
    from repro.optim.compression import make_compressor as jax_make_compressor
    from repro_torch.optim import make_compressor

    g = {"a": torch.tensor([1.0, -2.0]), "b": {"c": torch.tensor([[3.0]])}}
    comp, decomp = make_compressor("none")
    payload, residual = comp(g, None)
    assert payload is g and residual is None and decomp(payload, g) is g
    jg = {"a": jnp.asarray([1.0, -2.0])}
    jcomp, _ = jax_make_compressor("none")
    assert jcomp(jg, None)[0] is jg
    with pytest.raises(ValueError, match="scheme"):
        make_compressor("fp4")


def test_error_feedback_accumulates():
    """With error feedback the compressed sum converges to the true sum; every
    step's payload and residual equal the reference's."""
    from repro.optim.compression import make_compressor as jax_make_compressor
    from repro_torch.optim import make_compressor

    comp, decomp = make_compressor("topk", fraction=0.25)
    jcomp, jdecomp = jax_make_compressor("topk", fraction=0.25)
    g = {"w": torch.tensor([1.0, 0.5, 0.25, 0.125])}
    jg = {"w": jnp.asarray([1.0, 0.5, 0.25, 0.125])}
    residual = jresidual = None
    total = torch.zeros(4)
    for _ in range(16):
        payload, residual = comp(g, residual)
        jpayload, jresidual = jcomp(jg, jresidual)
        assert payload["w"].indices.tolist() == np.asarray(jpayload["w"].indices).tolist()
        np.testing.assert_array_equal(payload["w"].values.numpy(), np.asarray(jpayload["w"].values))
        np.testing.assert_array_equal(residual["w"].numpy(), np.asarray(jresidual["w"]))
        back = decomp(payload, g)["w"]
        np.testing.assert_array_equal(back.numpy(), np.asarray(jdecomp(jpayload, jg)["w"]))
        total = total + back
    # every coordinate eventually flushes through the top-k channel
    np.testing.assert_allclose((total / 16).numpy(), g["w"].numpy(), atol=0.15)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compressor_tree(dtype):
    from repro.optim.compression import make_compressor as jax_make_compressor
    from repro_torch.optim import make_compressor

    comp, decomp = make_compressor("int8")
    jcomp, jdecomp = jax_make_compressor("int8")
    a, b = np.float32([1.0, -2.0]), np.float32([[3.0]])
    g = {"a": torch.from_numpy(a).to(getattr(torch, dtype)),
         "b": torch.from_numpy(b).to(getattr(torch, dtype))}
    jg = {"a": jnp.asarray(a, dtype), "b": jnp.asarray(b, dtype)}
    payload, residual = comp(g, None)
    jpayload, jresidual = jcomp(jg, None)
    back, jback = decomp(payload, g), jdecomp(jpayload, jg)
    for k in ("a", "b"):
        assert payload[k].q.numpy().tobytes() == np.asarray(jpayload[k].q).tobytes()
        assert payload[k].scale.item() == float(jpayload[k].scale)
        np.testing.assert_array_equal(residual[k].numpy(), np.asarray(jresidual[k]))
        assert back[k].dtype == g[k].dtype
        np.testing.assert_array_equal(back[k].float().numpy(), np.asarray(jback[k], np.float32))
        np.testing.assert_allclose(back[k].float().numpy(), g[k].float().numpy(), atol=0.05)
    # the residual feeds the next call
    payload2, _ = comp(g, residual)
    jpayload2, _ = jcomp(jg, jresidual)
    assert payload2["a"].q.numpy().tobytes() == np.asarray(jpayload2["a"].q).tobytes()
