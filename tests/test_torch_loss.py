"""The chunked cross-entropy's logit GEMMs (``models/common.py``).

On the card a chunk's logits of bf16 operands come from ``_LogitsF32``: one
GEMM with fp32 sums (``aten::mm.dtype``), and a backward that feeds the fp32
logit gradient to the GEMMs as two bf16 terms. Everything else upcasts the
operands to fp32. On the CPU the Function's GEMMs run as the upcast does
(the CPU has no kernel for ``aten::mm.dtype``; the products are the same),
so these tests hold its arithmetic, the split included, against float64 and
against the upcast path, and check that every input other than bf16 on the
card keeps the upcast. Inputs are drawn with numpy from a seed.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import common  # noqa: E402

M, D, V = 256, 512, 8192            # rows, width, vocabulary of the accuracy test


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).bfloat16()


def _counts() -> tuple[int, int]:
    return common._LogitsF32.forwards, common._LogitsF32.backwards


@pytest.fixture(scope="module")
def xent_grad():
    """bf16 ``h`` (M, D), ``w`` (V, D) and the fp32 gradient of the mean NLL
    with respect to ``h @ w.T``: softmax less one-hot, over M."""
    rng = np.random.default_rng(0)
    h = _bf16(rng.standard_normal((M, D)))
    w = _bf16(rng.standard_normal((V, D)) * 0.02)
    y = torch.from_numpy(rng.integers(0, V, M))
    d = torch.softmax(h.float() @ w.float().T, dim=-1)
    d[torch.arange(M), y] -= 1.0
    return h, w, d / M


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return ((x.double() - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("rounded_once", [False, True], ids=["split", "rounded-once"])
@pytest.mark.parametrize("which", ["dh", "dw"])
def test_split_gradient_is_as_accurate_as_fp32(xent_grad, which, rounded_once):
    """The fp32 gradients of the split, before the cast to bf16, are within
    2x the fp32 upcast's relative Frobenius error against float64 (measured
    3.9e-7 against 3.3e-7 for dH). The same gradient rounded once to bf16
    (``lo`` then 0) misses that tolerance by far (1.3e-4)."""
    h, w, d = xent_grad
    ref = d.double() @ w.double() if which == "dh" else d.double().T @ h.double()
    upcast = d @ w.float() if which == "dh" else d.T @ h.float()
    tol = 2 * _rel(upcast, ref)
    fed = d.bfloat16().float() if rounded_once else d
    dh, dw = common._logit_grads(fed, h, w)
    got = dh if which == "dh" else dw
    assert got.dtype == torch.float32
    err = _rel(got, ref)
    if rounded_once:
        assert err > 10 * tol, (err, tol)
    else:
        assert err <= tol, (err, tol)


def _within_one_bf16_step(got: torch.Tensor, want: torch.Tensor) -> None:
    """Two bf16 tensors that round fp32 values a few fp32 sums apart: each
    element within one bf16 step of the larger magnitude, plus 2**-12 of the
    largest element, since the split and the order of the fp32 sums move an
    element whose terms cancel by more than its own step (measured: 2 steps
    of a 2e-4 element, in a gradient whose largest element is 3e-2)."""
    a, b = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.ldexp(torch.ones_like(a), exp - 8)
    slack = step + 2**-12 * b.abs().max()
    assert bool(((a - b).abs() <= slack).all()), (a - b).abs().max().item()


@pytest.mark.parametrize("z_loss_weight,softcap", [(0.0, 0.0), (1e-4, 0.0), (0.0, 30.0),
                                                   (1e-4, 30.0)],
                         ids=["plain", "z-loss", "softcap", "z-loss-softcap"])
def test_function_path_matches_upcast_through_the_loss(monkeypatch, z_loss_weight, softcap):
    """``cross_entropy_chunked`` with every chunk through ``_LogitsF32`` (the
    selection forced, as on the card) against the upcast: the same loss and
    metrics, bf16 gradients within one rounding step; two forwards (the
    checkpoint's recompute) and one backward a chunk."""
    rng = np.random.default_rng(1)
    B, S, Dm, Vm, chunk = 2, 64, 128, 1024, 16
    h = _bf16(rng.standard_normal((B, S, Dm)))
    w = _bf16(rng.standard_normal((Vm, Dm)) * 0.05)
    y = torch.from_numpy(rng.integers(0, Vm, (B, S)).astype(np.int32))

    def run():
        hh, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        loss, metrics = common.cross_entropy_chunked(
            hh, ww, y, chunk=chunk, z_loss_weight=z_loss_weight, logits_softcap=softcap)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, hh.grad, ww.grad

    base = _counts()
    want = run()
    assert _counts() == base
    monkeypatch.setattr(common, "_tensor_core_logits", lambda h, u: True)
    got = run()
    chunks = S // chunk
    assert _counts() == (base[0] + 2 * chunks, base[1] + chunks)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    for k in want[1]:
        torch.testing.assert_close(got[1][k], want[1][k], rtol=1e-6, atol=0)
    for g, r in zip(got[2:], want[2:]):
        assert g.dtype == r.dtype == torch.bfloat16
        _within_one_bf16_step(g, r)


@pytest.fixture
def one_rank_mesh():
    """A one-rank mesh of torch's ``fake`` group, gone when the test ends
    (a data plane built later in this worker must not find it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", torch.arange(1))
    finally:
        dist.destroy_process_group()


def _dtensors(mesh, *xs):
    from torch.distributed.tensor import Replicate, distribute_tensor

    return [distribute_tensor(x, mesh, [Replicate()], src_data_rank=None) for x in xs]


@pytest.mark.parametrize("case", ["cpu-bf16", "cpu-fp32", "meta-bf16", "dtensor-bf16"])
def test_everything_but_bf16_on_the_card_keeps_the_upcast(request, case):
    """The CPU, fp32 configs, meta tensors and the dry-run's DTensors take the
    upcast: the selection says no and the Function is never called, in the
    forward, the recompute or the backward."""
    device, dtype = ("cpu", torch.float32) if case == "cpu-fp32" else (
        "meta" if case.startswith(("meta", "dtensor")) else "cpu", torch.bfloat16)
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((2, 32, 64), dtype=np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.standard_normal((256, 64), dtype=np.float32)).to(device, dtype)
    y = torch.from_numpy(rng.integers(0, 256, (2, 32)).astype(np.int32)).to(device)
    ctx = contextlib.nullcontext()
    if case == "dtensor-bf16":
        from torch.distributed.tensor.experimental import implicit_replication

        h, w, y = _dtensors(request.getfixturevalue("one_rank_mesh"), h, w, y)
        ctx = implicit_replication()
    assert not common._tensor_core_logits(h, w)
    h.requires_grad_(True)
    w.requires_grad_(True)
    base = _counts()
    with ctx:
        loss, _ = common.cross_entropy_chunked(h, w, y, chunk=8, z_loss_weight=1e-4,
                                               logits_softcap=30.0)
        loss.backward()
    assert _counts() == base
    assert h.grad is not None and h.grad.dtype == dtype and w.grad.shape == w.shape
