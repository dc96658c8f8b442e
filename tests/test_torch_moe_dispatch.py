"""The served MoE dispatch and combine (``kernels/moe_dispatch.py``, the
served path of ``models/moe.py``) against the eager path they replace.

Each case routes seeded tokens through ``moe_ffn`` of a smoke config cut to
the case's experts: mixtral-like (8 experts, top-2), granite-like (72, top-10,
a shared expert), a decode group (8 tokens, capacity = top-k), forced drops
(capacity factor 0.5) and a token count that is not a multiple of the group.
The eager path's own buffer, expert outputs and routed output are read by
wrapping ``moe._expert_ffn`` and ``moe._dispatch_combine``; the served path's
by wrapping ``ops.moe_gather`` and ``ops.moe_combine``.

On the CPU:
  * the plain gather equals the eager buffer rearranged expert-major, and
    the served expert outputs equal the eager ones (``torch.equal``);
  * the plain combine equals the eager gather and ``einsum``;
  * ``moe_ffn`` under ``no_grad`` (the served path) equals ``moe_ffn`` with
    autograd recording (the eager path), output and metrics.

Tests marked ``card`` hold the kernels to the same on a CUDA device and skip
without one: the gather and the expert outputs bit for bit, the combine
within one bf16 ulp of the eager ``einsum`` and bit-equal to an fp32 sum in
choice order, one launch of each kernel a served call and none under
autograd. This file imports no JAX, so on a machine with a card they run as

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_moe_dispatch.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.kernels import moe_dispatch as kernels  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402

CASES = {   # name: (smoke config, overrides, tokens)
    "mixtral": ("mixtral-8x22b", dict(n_experts=8, experts_per_token=2), 256),
    "granite": ("granite-4.0-h-small", dict(n_experts=72, experts_per_token=10), 128),
    "decode": ("granite-4.0-h-small", dict(n_experts=72, experts_per_token=10), 8),
    "drops": ("mixtral-8x22b", dict(n_experts=8, experts_per_token=2,
                                    moe_capacity_factor=0.5), 256),
    "ragged": ("mixtral-8x22b", dict(n_experts=8, experts_per_token=2), 100),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def case_inputs(name, dtype, device):
    arch, overrides, T = CASES[name]
    cfg = get_smoke_config(arch).replace(dtype=dtype, param_dtype=dtype, **overrides)
    gen = torch.Generator(device=device).manual_seed(len(name))
    tdt = getattr(torch, dtype)
    p = {k: v[0] for k, v in moe.init_moe_params(cfg, 1, gen, device, tdt).items()}
    x = torch.randn((T, cfg.d_model), generator=gen, device=device).to(tdt)
    return cfg, p, x


class Recorder:
    """Wraps the eager path's ``_expert_ffn`` and ``_dispatch_combine`` and
    the served path's ``ops.moe_gather`` and ``ops.moe_combine`` to keep
    what each took and gave."""

    def __init__(self, monkeypatch):
        self.seen = {}
        for owner, name in ((moe, "_expert_ffn"), (moe, "_dispatch_combine"),
                            (ops, "moe_gather"), (ops, "moe_combine")):
            monkeypatch.setattr(owner, name, self._wrap(name, getattr(owner, name)))

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.seen[name] = (args, out)
            return out
        return wrapped


def ffn(cfg, p, x, *, grad):
    """``moe_ffn`` under ``no_grad`` (served), or with every leaf recording."""
    if not grad:
        with torch.no_grad():
            return moe.moe_ffn(cfg, p, x)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    y, m = moe.moe_ffn(cfg, p, x.detach().clone().requires_grad_(True))
    return y.detach(), moe.MoEMetrics(*(t.detach() for t in m))


def expert_major(t, E):
    """The eager path's (n, E, C, D) as the served path's (E*n*C, D)."""
    return t.transpose(0, 1).reshape(-1, t.shape[-1])


def both_paths(monkeypatch, cfg, p, x):
    rec = Recorder(monkeypatch)
    eager = ffn(cfg, p, x, grad=True)
    seen_eager = dict(rec.seen)
    rec.seen.clear()
    served = ffn(cfg, p, x, grad=False)
    assert set(rec.seen) == {"moe_gather", "moe_combine"}, "the served path did not engage"
    assert set(seen_eager) == {"_expert_ffn", "_dispatch_combine"}
    return eager, served, seen_eager, rec.seen


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", list(CASES))
def test_served_path_equals_eager_path(monkeypatch, name, dtype):
    cfg, p, x = case_inputs(name, dtype, torch.device("cpu"))
    (y0, m0), (y1, m1), eager, served = both_paths(monkeypatch, cfg, p, x)
    E = cfg.n_experts
    xe, ye = eager["_expert_ffn"][0][2], eager["_expert_ffn"][1]
    (x_flat, slot_token), buffer = served["moe_gather"]
    (ye_served, rows, w), y_routed = served["moe_combine"]
    # the gather's buffer is the eager one, expert-major
    assert torch.equal(buffer, expert_major(xe, E))
    assert torch.equal(kernels.moe_gather_plain(x_flat, slot_token), buffer)
    # the expert GEMMs on it give the eager outputs
    assert torch.equal(ye_served, expert_major(ye, E))
    # the combine is the eager gather and einsum
    T = x.shape[0]
    eager_routed = eager["_dispatch_combine"][1].reshape(-1, x.shape[1])[:T]
    assert torch.equal(y_routed, eager_routed)
    assert torch.equal(kernels.moe_combine_plain(ye_served, rows, w), eager_routed)
    # and the layer's output and metrics
    assert torch.equal(y1, y0)
    for a, b in zip(m1, m0):
        assert torch.equal(a, b)
    if name == "drops":
        assert m1.dropped_fraction.item() > 0 and bool((rows < 0).any())
    if name == "decode":
        assert moe._capacity(cfg, T) == cfg.experts_per_token
    if name == "granite":
        assert cfg.shared_d_ff > 0


def test_maps_cover_each_kept_choice_once():
    gen = torch.Generator().manual_seed(5)
    n, g, k, E, C = 3, 16, 3, 6, 7
    logits = torch.randn((n, g, E), generator=gen)
    cfg = get_smoke_config("mixtral-8x22b").replace(n_experts=E, experts_per_token=k)
    expert_idx, slot, keep, _, _, _, _ = moe._route_group(cfg, logits, C)
    rows, slot_token = kernels.expert_major_rows(expert_idx, slot, keep, C, E)
    assert rows.dtype == slot_token.dtype == torch.int32
    assert slot_token.shape == (E * n * C,)
    kept = rows[keep].long()
    assert kept.unique().numel() == kept.numel()
    assert bool((rows[~keep] == -1).all())
    # each kept choice's row names its token; every other row stays empty
    token = torch.arange(n * g).reshape(n, g, 1).expand(n, g, k)
    assert torch.equal(slot_token[kept].long(), token[keep])
    assert int((slot_token >= 0).sum()) == kept.numel()


@pytest.mark.parametrize("bad, match", [
    ("rows_dtype", "int32"), ("w_dtype", "bfloat16"), ("shape", "takes"),
])
def test_combine_refuses(bad, match):
    ye = torch.zeros((6, 8), dtype=torch.bfloat16)
    rows = torch.zeros((3, 2), dtype=torch.int32)
    w = torch.zeros((3, 2), dtype=torch.bfloat16)
    if bad == "rows_dtype":
        rows = rows.long()
    elif bad == "w_dtype":
        w = w.float()
    else:
        w = w[:2]
    with pytest.raises(ValueError, match=match):
        kernels.moe_combine_plain(ye, rows, w)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.moe_gather_cuda(x, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.moe_combine_cuda(x, torch.zeros((2, 1), dtype=torch.int32), x[:2, :1])


# ---- on the card ---------------------------------------------------------------


def within_one_ulp(a, b):
    """bf16 ``a`` and ``b`` differ by at most one ulp of the larger."""
    a, b = a.float(), b.float()
    top = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top)) - 7), 0.0)
    return bool(((a - b).abs() <= ulp).all())


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_on_card(monkeypatch, card, name, dtype):
    cfg, p, x = case_inputs(name, dtype, card)
    counts = (kernels.moe_gather_cuda, kernels.moe_combine_cuda)
    before = [fn.launches for fn in counts]
    (y0, _), (y1, _), eager, served = both_paths(monkeypatch, cfg, p, x)
    torch.cuda.synchronize()
    E = cfg.n_experts
    xe, ye = eager["_expert_ffn"][0][2], eager["_expert_ffn"][1]
    (x_flat, slot_token), buffer = served["moe_gather"]
    (ye_served, rows, w), y_routed = served["moe_combine"]
    assert [fn.launches - b for fn, b in zip(counts, before)] == [1, 1]
    assert torch.equal(buffer, kernels.moe_gather_plain(x_flat, slot_token))
    assert torch.equal(buffer, expert_major(xe, E))
    assert torch.equal(ye_served, expert_major(ye, E))
    assert torch.equal(y_routed, kernels.moe_combine_ordered(ye_served, rows, w))
    T = x.shape[0]
    eager_routed = eager["_dispatch_combine"][1].reshape(-1, x.shape[1])[:T]
    if dtype == "bfloat16":
        assert within_one_ulp(y_routed, eager_routed)
        assert within_one_ulp(y_routed, kernels.moe_combine_plain(ye_served, rows, w))
    # under autograd the eager path runs: no launch
    before = [fn.launches for fn in counts]
    ffn(cfg, p, x, grad=True)
    assert [fn.launches - b for fn, b in zip(counts, before)] == [0, 0]


@pytest.mark.card
def test_gather_takes_any_row_size_on_card(card):
    gen = torch.Generator(device=card).manual_seed(9)
    for D, dtype in ((8, torch.bfloat16), (12, torch.bfloat16), (3, torch.bfloat16),
                     (5, torch.float32), (4096, torch.bfloat16)):
        # contiguous, one element past the 16-byte grid
        x = torch.randn(37 * D + 1, generator=gen, device=card).to(dtype)[1:].view(37, D)
        slot_token = torch.randint(-1, 37, (53,), generator=gen, device=card,
                                   dtype=torch.int32)
        assert torch.equal(kernels.moe_gather_cuda(x, slot_token),
                           kernels.moe_gather_plain(x, slot_token))
        rows = torch.randint(-1, 53, (29, 3), generator=gen, device=card, dtype=torch.int32)
        ye = torch.randn((53, D), generator=gen, device=card).to(dtype)
        w = torch.rand((29, 3), generator=gen, device=card).to(dtype)
        assert torch.equal(kernels.moe_combine_cuda(ye, rows, w),
                           kernels.moe_combine_ordered(ye, rows, w))
