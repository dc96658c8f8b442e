"""Port SSD scan vs the JAX package's Pallas kernel and SSD layer, on the CPU.

The port's ``ops.ssd_scan`` on CPU tensors runs the kernel's plain PyTorch
version; the reference runs ``ssd_scan_pallas`` in interpret mode and
``ssd_chunked_reference``, as the JAX package's own tests do. Inputs are
made with numpy from a seed and handed to both. Tolerances are the
reference's own (``tests/test_kernels.py``): f32 2e-4, bf16 3e-2 for the
sweep, 1e-4 for the sequential ground truth and the state handoff.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import ssd as jax_ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    CB_MIN_STATE,
    check_inputs,
    launch_plan,
    ssd_scan_cuda,
    ssd_scan_plain,
)
from repro_torch.models import ssd  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_inputs(seed, B, S, H, P, G, N):
    """x, dt, A, B, C, h0 as numpy f32, drawn as the reference's tests draw
    theirs; ``to_jax``/``to_torch`` round x, B and C once to the test's dtype."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32)))
    A = -np.exp(rng.standard_normal((H,), dtype=np.float32) * 0.5)
    Bm = rng.standard_normal((B, S, G, N), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((B, S, G, N), dtype=np.float32) * 0.3
    h0 = rng.standard_normal((B, H, P, N), dtype=np.float32) * 0.1
    return x, dt, A, Bm, Cm, h0


def to_jax(arrays, dtype="float32"):
    x, dt, A, Bm, Cm, h0 = (jnp.asarray(a) for a in arrays)
    return x.astype(JNP[dtype]), dt, A, Bm.astype(JNP[dtype]), Cm.astype(JNP[dtype]), h0


def to_torch(arrays, dtype="float32"):
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in arrays)
    return x.to(TORCH[dtype]), dt, A, Bm.to(TORCH[dtype]), Cm.to(TORCH[dtype]), h0


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,P,G,N,Q",
    [
        (2, 128, 4, 16, 2, 32, 32),
        (1, 256, 8, 32, 2, 64, 64),
        (1, 64, 4, 16, 1, 32, 64),       # S < 2 chunks
        (2, 96, 4, 16, 4, 32, 32),       # G == H
    ],
)
def test_ssd_scan_matches_pallas_and_reference(B, S, H, P, G, N, Q, dtype):
    arrays = make_inputs(0, B, S, H, P, G, N)
    jx, jdt, jA, jB, jC, jh0 = to_jax(arrays, dtype)
    y_pl, s_pl = ssd_scan_pallas(jx, jdt, jA, jB, jC, chunk=Q, initial_state=jh0,
                                 interpret=True)
    y_ref, s_ref = jax_ssd.ssd_chunked_reference(jx, jdt, jA, jB, jC, chunk=min(Q, S),
                                                 initial_state=jh0)
    tx, tdt, tA, tB, tC, th0 = to_torch(arrays, dtype)
    y, s = ops.ssd_scan(tx, tdt, tA, tB, tC, chunk=Q, initial_state=th0)
    assert y.dtype == TORCH[dtype] and s.dtype == torch.float32
    assert y.shape == (B, S, H, P) and s.shape == (B, H, P, N)
    tol = TOL[dtype]
    for ref_y, ref_s in ((y_pl, s_pl), (y_ref, s_ref)):
        np.testing.assert_allclose(as_np(y), as_np(ref_y), atol=tol, rtol=tol)
        np.testing.assert_allclose(s.numpy(), as_np(ref_s), atol=tol, rtol=tol)


def test_ssd_scan_vs_sequential_decode():
    """Ground truth: the chunked scan over a padded length (40 at chunk 16)
    equals the token-by-token recurrence, the reference's and the port's."""
    B, S, H, P, G, N = 1, 40, 2, 8, 1, 16
    x, dt, A, Bm, Cm, _ = make_inputs(1, B, S, H, P, G, N)
    y, h = ops.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=16)
    jstate = jnp.zeros((B, H, P, N))
    tstate = torch.zeros((B, H, P, N))
    jys, tys = [], []
    for t in range(S):
        yt, jstate = jax_ssd.ssd_decode_step(*(jnp.asarray(a[:, t]) for a in (x, dt)),
                                             jnp.asarray(A),
                                             *(jnp.asarray(a[:, t]) for a in (Bm, Cm)), jstate)
        jys.append(yt)
        yt, tstate = ssd.ssd_decode_step(*(torch.from_numpy(a[:, t]) for a in (x, dt)),
                                         torch.from_numpy(A),
                                         *(torch.from_numpy(a[:, t]) for a in (Bm, Cm)), tstate)
        tys.append(yt)
    for y_seq, h_seq in ((np.stack([np.asarray(v) for v in jys], 1), np.asarray(jstate)),
                         (torch.stack(tys, 1).numpy(), tstate.numpy())):
        np.testing.assert_allclose(y.numpy(), y_seq, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), h_seq, atol=1e-4, rtol=1e-4)


def test_ssd_state_handoff():
    """Splitting a sequence across two scans == one scan (prefill -> decode)."""
    B, S, H, P, G, N = 1, 64, 2, 8, 1, 16
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a) for a in make_inputs(2, B, S, H, P, G, N))
    y_full, h_full = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    y1, h1 = ops.ssd_scan(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], chunk=32)
    y2, h2 = ops.ssd_scan(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], chunk=32,
                          initial_state=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-4, rtol=1e-4)
    # and the reference agrees on the split
    jx, jdt, jA, jB, jC = (jnp.asarray(a.numpy()) for a in (x, dt, A, Bm, Cm))
    _, jh1 = ssd_scan_pallas(jx[:, :32], jdt[:, :32], jA, jB[:, :32], jC[:, :32],
                             chunk=32, interpret=True)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh1), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_reference_matches_jax(dtype):
    B, S, H, P, G, N = 2, 64, 4, 16, 2, 16
    arrays = make_inputs(3, B, S, H, P, G, N)
    for h0 in (None, arrays[5]):
        jx, jdt, jA, jB, jC, _ = to_jax(arrays, dtype)
        tx, tdt, tA, tB, tC, _ = to_torch(arrays, dtype)
        jy, js = jax_ssd.ssd_chunked_reference(
            jx, jdt, jA, jB, jC, chunk=16,
            initial_state=None if h0 is None else jnp.asarray(h0))
        ty, ts = ssd.ssd_chunked_reference(
            tx, tdt, tA, tB, tC, chunk=16,
            initial_state=None if h0 is None else torch.from_numpy(h0))
        assert ty.dtype == TORCH[dtype] and ts.dtype == torch.float32
        tol = TOL[dtype]
        np.testing.assert_allclose(as_np(ty), as_np(jy), atol=tol, rtol=tol)
        np.testing.assert_allclose(ts.numpy(), as_np(js), atol=tol, rtol=tol)
    # the oracle module routes to the same function
    ry, rs = ssd_scan_ref(tx, tdt, tA, tB, tC, chunk=16)
    np.testing.assert_array_equal(as_np(ry), as_np(ssd.ssd_chunked_reference(
        tx, tdt, tA, tB, tC, chunk=16)[0]))


def test_segsum_matches_jax():
    la = np.random.default_rng(4).standard_normal((3, 12), dtype=np.float32)
    np.testing.assert_allclose(ssd.segsum(torch.from_numpy(la)).numpy(),
                               np.asarray(jax_ssd.segsum(jnp.asarray(la))), atol=1e-6)


def test_ssd_decode_step_matches_jax():
    B, H, P, G, N = 2, 4, 8, 2, 16
    x, dt, A, Bm, Cm, h0 = make_inputs(5, B, 1, H, P, G, N)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    jy, js = jax_ssd.ssd_decode_step(*(jnp.asarray(a) for a in args), jnp.asarray(h0))
    ty, ts = ssd.ssd_decode_step(*(torch.from_numpy(a) for a in args), torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=1e-5)


def test_plain_version_reads_strided_views_as_the_model_hands_them():
    """``mamba_block`` passes x, B and C as views into one projection."""
    B, S, H, P, G, N = 2, 48, 4, 8, 1, 16
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in make_inputs(6, B, S, H, P, G, N))
    xbc = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, G * N),
                     Cm.reshape(B, S, G * N)], dim=-1)
    xs, bs, cs = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    views = (xs.reshape(B, S, H, P), bs.reshape(B, S, G, N), cs.reshape(B, S, G, N))
    assert not views[0].is_contiguous()
    y_v, h_v = ssd_scan_plain(views[0], dt, A, views[1], views[2], chunk=16, initial_state=h0)
    y_c, h_c = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=16, initial_state=h0)
    np.testing.assert_array_equal(y_v.numpy(), y_c.numpy())
    np.testing.assert_array_equal(h_v.numpy(), h_c.numpy())


def test_ssd_scan_cuda_raises_on_cpu_tensors():
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a) for a in make_inputs(7, 1, 16, 2, 8, 1, 16))
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=16)
    assert ssd_scan_cuda.launches == before


@pytest.mark.parametrize("case", ["dt_dtype", "bc_dtype", "groups", "chunk", "state_shape"])
def test_check_inputs_rejects_what_the_kernel_does_not_take(case):
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in make_inputs(8, 1, 16, 4, 8, 2, 16))
    kw = dict(chunk=16, initial_state=h0)
    if case == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    elif case == "bc_dtype":
        Bm = Bm.to(torch.bfloat16)
    elif case == "groups":
        A, x, dt = A[:3], x[:, :, :3], dt[:, :, :3]
        kw["initial_state"] = None
    elif case == "chunk":
        kw["chunk"] = 0
    else:
        kw["initial_state"] = h0[:, :, :4]
    with pytest.raises(ValueError):
        check_inputs(x, dt, A, Bm, Cm, **kw)


# ---- the kernel's three steps, each held against its formula in numpy ----

SWEEP = [(2, 128, 4, 16, 2, 32, 32), (1, 256, 8, 32, 2, 64, 64),
         (1, 64, 4, 16, 1, 32, 64), (2, 96, 4, 16, 4, 32, 32)]


def numpy_stages(x, dt, A, Bm, Cm, h0, Q):
    """cum, S_c, h_{c-1}, the final state and y of the chunk-parallel form,
    straight from the formulas in float64, one (batch, chunk, head) at a time."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    n = S // Q
    x, dt, Bm, Cm = (a.astype(np.float64) for a in (x, dt, Bm, Cm))
    cum = np.zeros((B, n, Q, H))
    states = np.zeros((B, n, H, P, N))
    h_prev = np.zeros((B, n, H, P, N))
    final = np.zeros((B, H, P, N))
    y = np.zeros((B, S, H, P))
    for b in range(B):
        for h in range(H):
            g = h // (H // G)
            state = np.zeros((P, N)) if h0 is None else h0[b, h].astype(np.float64)
            for c in range(n):
                rows = slice(c * Q, (c + 1) * Q)
                xs, ds, bs, cs = x[b, rows, h], dt[b, rows, h], Bm[b, rows, g], Cm[b, rows, g]
                cu = np.cumsum(ds * A[h])
                cum[b, c, :, h] = cu
                s_c = sum(np.exp(cu[-1] - cu[j]) * ds[j] * np.outer(xs[j], bs[j])
                          for j in range(Q))
                states[b, c, h] = s_c
                h_prev[b, c, h] = state
                for i in range(Q):
                    w = [(cs[i] @ bs[j]) * np.exp(cu[i] - cu[j]) * ds[j] for j in range(i + 1)]
                    y[b, c * Q + i, h] = (np.asarray(w) @ xs[:i + 1]
                                          + np.exp(cu[i]) * (state @ cs[i]))
                state = np.exp(cu[-1]) * state + s_c
            final[b, h] = state
    return cum, states, h_prev, final, y


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SWEEP)
def test_ssd_stages_match_their_formulas(B, S, H, P, G, N, Q):
    """chunk_views' cum, chunk_states, state_passing and chunk_output, each
    against the direct evaluation, so a step that is wrong on the card can
    be found on the CPU."""
    x, dt, A, Bm, Cm, h0 = make_inputs(9, B, S, H, P, G, N)
    cum_n, states_n, hprev_n, final_n, y_n = numpy_stages(x, dt, A, Bm, Cm, h0, min(Q, S))
    tx, tdt, tA, tB, tC, th0 = (torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0))
    xc, dtc, Bh, Ch, lac, cum = ssd.chunk_views(tx, tdt, tA, tB, tC, chunk=Q)
    np.testing.assert_allclose(cum.numpy(), cum_n, atol=1e-5, rtol=1e-5)
    states = ssd.chunk_states(xc, dtc, Bh, cum)
    np.testing.assert_allclose(states.numpy(), states_n, atol=1e-4, rtol=1e-4)
    h_prevs, final = ssd.state_passing(states, cum, th0)
    np.testing.assert_allclose(h_prevs.numpy(), hprev_n, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(final.numpy(), final_n, atol=1e-4, rtol=1e-4)
    y = ssd.chunk_output(xc, dtc, Bh, Ch, lac, cum, h_prevs)
    np.testing.assert_allclose(y.reshape(B, S, H, P).numpy(), y_n, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S,chunk,n_chunks,Q", [(128, 32, 4, 32), (40, 16, 3, 16),
                                                (24, 256, 1, 24), (2048, 256, 8, 256)])
def test_launch_plan_shapes_and_padding(S, chunk, n_chunks, Q):
    """The scratch the wrapper allocates: cum (B,H,n,Q), chunk states
    (B,H,n,P,N), with n = ceil(S / Q) and Q = min(chunk, S)."""
    B, H, P, G, N = 2, 4, 8, 2, 16
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in make_inputs(10, B, S, H, P, G, N))
    plan = launch_plan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0)
    assert plan.dims == (B, S, H, P, G, N, Q) and plan.n_chunks == n_chunks
    assert plan.cum_shape == (B, H, n_chunks, Q)
    assert plan.chunk_states_shape == (B, H, n_chunks, P, N)
    assert plan.y_shape == (B, S, H, P) and plan.state_shape == (B, H, P, N)
    assert plan.strides == (S * H * P, H * P, S * H, H, S * G * N, G * N)
    assert plan.cb_shape is None  # N = 16: the output kernel forms C·Bᵀ itself


@pytest.mark.parametrize("N", [32, 64, 128])
def test_launch_plan_shares_cb_per_group_from_n_64(N):
    """From N = 64 on, C·Bᵀ is formed once per (chunk, group) into a
    (B, n, G, Q, Q) scratch that the group's heads share."""
    B, S, H, P, G, Q = 2, 96, 4, 8, 2, 32
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a) for a in make_inputs(13, B, S, H, P, G, N))
    plan = launch_plan(x, dt, A, Bm, Cm, chunk=Q, initial_state=None)
    assert plan.cb_shape == ((B, 3, G, Q, Q) if N >= CB_MIN_STATE else None)


def test_launch_plan_passes_the_strides_of_the_models_views():
    """mamba_block hands x, B and C as views into one projection: the plan
    passes their batch and sequence strides, not packed ones."""
    B, S, H, P, G, N = 2, 48, 4, 8, 1, 16
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a) for a in make_inputs(11, B, S, H, P, G, N))
    width = H * P + 2 * G * N
    xbc = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, G * N),
                     Cm.reshape(B, S, G * N)], dim=-1)
    xs, bs, cs = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    plan = launch_plan(xs.reshape(B, S, H, P), dt, A, bs.reshape(B, S, G, N),
                       cs.reshape(B, S, G, N), chunk=16, initial_state=None)
    assert plan.strides == (S * width, width, S * H, H, S * width, width)


@pytest.mark.parametrize("case", ["x_heads", "bc_strides", "dt_heads", "h0_layout"])
def test_launch_plan_rejects_layouts_the_kernels_do_not_read(case):
    B, S, H, P, G, N = 1, 32, 4, 8, 1, 16
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in make_inputs(12, B, S, H, P, G, N))
    if case == "x_heads":       # P not contiguous
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "bc_strides":  # B and C with different strides
        Cm = torch.cat([Cm, Cm], dim=1)[:, ::2]
    elif case == "dt_heads":
        dt = dt.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        h0 = h0.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        launch_plan(x, dt, A, Bm, Cm, chunk=16, initial_state=h0)
