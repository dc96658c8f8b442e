"""The optimizer kernels (``repro_torch.kernels.adamw``) and the in-place
optimizer's dispatch (``optim.adamw.clip_by_global_norm_``,
``adamw_update_``).

On the CPU: the launch tables and the lookup the kernels do (every element
of every leaf in exactly one chunk), the argument checks, and the CPU path
of the in-place optimizer held bit for bit to the eager code it ran before
the kernels (a copy of it below), in every dtype pairing with the clip
engaged and not. Tests marked ``card`` hold the kernels to that eager code
on a CUDA device and skip without one; this file imports no JAX, so on a
machine with a card they run as

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_optim_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.kernels import adamw as kernels  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TC = TrainConfig(learning_rate=3e-2, warmup_steps=2, total_steps=20, weight_decay=0.1)
SHAPES = {"embed": (97, 33), "layers": {"w": (2, 33, 65), "norm": (2, 33)},
          "final_norm": (33,), "empty": (0, 4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# ---- the launch tables and the kernels' lookup --------------------------------

@pytest.mark.parametrize("numels, chunk", [
    ([1], 8),
    ([16, 17, 0, 8, 7, 0, 0, 40], 8),
    ([65536 * 3 + 5, 0, 65536, 1], kernels.CHUNK),
    ([5, 9, 33, 0, 64, 3, 1, 100, 16], 16),
    ([0, 0], 8),
])
def test_chunks_cover_every_element_exactly_once(numels, chunk):
    t = kernels.launch_table(numels, chunk)
    assert len(t.chunk0) == len(t.leaves) + 1
    assert t.chunk0[0] == 0 and list(t.chunk0) == sorted(t.chunk0)
    seen = [torch.zeros(n, dtype=torch.int32) for n in numels]
    for c in range(t.chunk0[-1]):
        leaf, begin, end = kernels.chunk_bounds(t, numels, c, chunk)
        assert begin % 8 == 0 and 0 <= begin < end <= numels[leaf] and end - begin <= chunk
        seen[leaf][begin:end] += 1
    for n, s in zip(numels, seen):
        assert torch.equal(s, torch.ones(n, dtype=torch.int32))
    # every non-empty leaf once, in order; the empty ones left out
    assert list(t.leaves) == [i for i, n in enumerate(numels) if n]


def test_launch_table_refuses_bad_arguments():
    for chunk in (0, -8, 12):
        with pytest.raises(ValueError, match="multiple of 8"):
            kernels.launch_table([4], chunk)
    with pytest.raises(ValueError, match="elements"):
        kernels.launch_table([4, -1])
    with pytest.raises(ValueError, match="holds 3"):
        kernels.launch_table([5, 0, 9, 33, 1], 8, max_leaves=3)
    assert kernels.launch_table([0] * 70, 8, max_leaves=3) == kernels.Table((), (0,))


def _leaf(dtype=torch.bfloat16, moments=torch.float32, shape=(4, 6)):
    return (torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=moments),
            torch.zeros(shape, dtype=moments), torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("case, match", [
    ("float16 parameter", "float32 or bfloat16"),
    ("float64 gradient", "float32 or bfloat16"),
    ("moments of two dtypes", "differ in dtype"),
    ("non-contiguous first moment", "not contiguous"),
    ("non-contiguous second moment", "not contiguous"),
    ("non-contiguous parameter", "not contiguous"),
    ("gradient of another shape", "not shaped like"),
])
def test_adamw_leaf_check_refuses(case, match):
    g, m, v, p = _leaf()
    if case == "float16 parameter":
        p = p.half()
    elif case == "float64 gradient":
        g = g.double()
    elif case == "moments of two dtypes":
        v = v.bfloat16()
    elif case == "non-contiguous first moment":
        m = torch.zeros((6, 4)).t()
    elif case == "non-contiguous second moment":
        v = torch.zeros((6, 4)).t()
    elif case == "non-contiguous parameter":
        p = torch.zeros((6, 4), dtype=torch.bfloat16).t()
    else:
        g = torch.zeros((4, 5), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        kernels.check_adamw_leaf(g, m, v, p)


def test_adamw_leaf_check_takes_what_the_kernel_takes():
    """Every dtype pairing, and a gradient that is not contiguous (read
    through ``g.contiguous()``, since the kernel only reads it)."""
    for dtype in (torch.float32, torch.bfloat16):
        for moments in (torch.float32, torch.bfloat16):
            kernels.check_adamw_leaf(*_leaf(dtype, moments))
    g, m, v, p = _leaf()
    kernels.check_adamw_leaf(torch.zeros((6, 4), dtype=torch.bfloat16).t(), m, v, p)
    kernels.check_adamw_leaf(*_leaf(shape=(0, 3)))        # empty: checked, then skipped


def test_grads_check_refuses():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.check_grads([torch.zeros(3, dtype=torch.float16)])
    with pytest.raises(ValueError, match="not contiguous"):
        kernels.check_grads([torch.zeros(3), torch.zeros((4, 3)).t()])
    kernels.check_grads([torch.zeros(3), torch.zeros((2, 3), dtype=torch.bfloat16),
                         torch.zeros(0)])


def test_cuda_wrappers_refuse_cpu_tensors():
    before = (kernels.clip_by_global_norm_cuda.launches, kernels.adamw_update_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.clip_by_global_norm_cuda([torch.ones(4)], 1.0)
    g, m, v, p = _leaf()
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.adamw_update_cuda([g], [m], [v], [p], lr=one, bc1=one, bc2=one, beta1=0.9,
                                  beta2=0.95, eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError, match="as many leaves"):
        kernels.adamw_update_cuda([g], [m], [v], [], lr=one, bc1=one, bc2=one, beta1=0.9,
                                  beta2=0.95, eps=1e-8, weight_decay=0.1)
    after = (kernels.clip_by_global_norm_cuda.launches, kernels.adamw_update_cuda.launches)
    assert after == before


# ---- the eager in-place optimizer as it was before the kernels ------------------

def eager_clip_(grads, max_norm):
    norm = adamw.global_norm(grads)
    scale = adamw._clip_scale(norm, max_norm)
    with torch.no_grad():
        for g in adamw.tree_leaves(grads):
            g.copy_((g.float() * scale).to(g.dtype))
    return norm


def eager_adamw_(grads, state, params, tc, lr):
    step = state.step + 1
    bc1, bc2 = adamw._bias_corrections(step, tc)
    with torch.no_grad():
        def leaf(g, m, v, p):
            p.add_(adamw._leaf_update(g, m, v, p, tc, lr, bc1, bc2))
        adamw.tree_map(leaf, grads, state.mu, state.nu, params)
    return adamw.OptState(step=step, mu=state.mu, nu=state.nu)


def draw_tree(gen, dtype, scale, device="cpu", shapes=SHAPES):
    def draw(shape):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(device)
    return adamw.tree_map(draw, shapes)


def run_steps(clip, update, dtype, state_dtype, max_norm, device="cpu", steps=4,
              shapes=SHAPES):
    """``steps`` steps of clip then update from one seed; the norms, the
    clipped gradients, the moments and the parameters after each step."""
    gen = torch.Generator().manual_seed(0)
    params = draw_tree(gen, dtype, 1.0, device, shapes)
    opt = adamw.adamw_init(params, state_dtype=state_dtype)
    lr_fn = adamw.cosine_schedule(TC)
    out = []
    for _ in range(steps):
        grads = draw_tree(gen, dtype, 0.5, device, shapes)
        norm = clip(grads, max_norm)
        opt = update(grads, opt, params, TC, lr_fn(opt.step))
        out.append([norm.clone()] + [t.clone() for t in leaves_of(grads, opt.mu, opt.nu, params)])
    return out


def leaves_of(*trees):
    return [leaf for tree in trees for leaf in adamw.tree_leaves(tree)]


def bits(t):
    return t.reshape(-1).view(torch.uint8)


def assert_bit_equal(a_runs, b_runs):
    for a_step, b_step in zip(a_runs, b_runs, strict=True):
        for a, b in zip(a_step, b_step, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e4], ids=["clipped", "unclipped"])
def test_cpu_path_unchanged_bit_for_bit(dtype, state_dtype, max_norm):
    got = run_steps(adamw.clip_by_global_norm_, adamw.adamw_update_, dtype, state_dtype,
                    max_norm)
    want = run_steps(eager_clip_, eager_adamw_, dtype, state_dtype, max_norm)
    assert_bit_equal(got, want)
    engaged = max(float(step[0]) for step in want) > max_norm
    assert engaged == (max_norm == 1.0)


# ---- on the card ---------------------------------------------------------------

# odd lengths, a leaf longer than three chunks and an empty one
CARD_SHAPES = dict(SHAPES, big=(3 * kernels.CHUNK + 13,))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e4], ids=["clipped", "unclipped"])
def test_kernels_bit_equal_to_eager_on_card(card, dtype, state_dtype, max_norm):
    """Each step of a run through the kernels against the eager code on
    copies of the same inputs: the clipped gradients bit-equal to the eager
    clip at the kernel's norm, the norm within 1e-6 of the eager one, and
    the moments and parameters after AdamW bit-equal to the eager update's."""
    before = (kernels.clip_by_global_norm_cuda.launches, kernels.adamw_update_cuda.launches)
    copy = lambda tree: adamw.tree_map(torch.clone, tree)  # noqa: E731
    engaged = []

    def clip(grads, max_norm):
        want = copy(grads)
        norm = adamw.clip_by_global_norm_(grads, max_norm)
        eager_norm = adamw.global_norm(want).item()
        assert abs(norm.item() - eager_norm) <= 1e-6 * eager_norm
        scale = adamw._clip_scale(norm, max_norm)
        engaged.append(scale.item() < 1.0)
        for w in adamw.tree_leaves(want):
            w.copy_((w.float() * scale).to(w.dtype))
        assert_bit_equal([adamw.tree_leaves(grads)], [adamw.tree_leaves(want)])
        return norm

    def update(grads, state, params, tc, lr):
        e_state = adamw.OptState(state.step, copy(state.mu), copy(state.nu))
        e_params = copy(params)
        eager_adamw_(grads, e_state, e_params, tc, lr)
        state = adamw.adamw_update_(grads, state, params, tc, lr)
        assert_bit_equal([leaves_of(state.mu, state.nu, params)],
                         [leaves_of(e_state.mu, e_state.nu, e_params)])
        return state

    runs = run_steps(clip, update, dtype, state_dtype, max_norm, card, shapes=CARD_SHAPES)
    assert all(engaged) if max_norm == 1.0 else not any(engaged)
    assert kernels.clip_by_global_norm_cuda.launches - before[0] == 3 * len(runs)
    assert kernels.adamw_update_cuda.launches - before[1] == len(runs)


@pytest.mark.card
def test_adamw_kernel_bit_equal_on_identical_inputs(card):
    """One step from identical gradients, moments and parameters, with a
    gradient that is a strided view (read through ``contiguous()``) and
    leaves off the 16-byte grid (the scalar loop)."""
    gen = torch.Generator(device=card).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        for mdt in (torch.float32, torch.bfloat16):
            base = torch.randn(3 * kernels.CHUNK + 21, generator=gen, device=card)
            p = base.to(dtype)
            odd = torch.randn(1001, generator=gen, device=card).to(dtype)[1:]   # off the grid
            g = torch.randn((300, 700), generator=gen, device=card).to(dtype).t()  # strided
            params = {"a": p, "b": odd, "c": torch.randn((700, 300), generator=gen,
                                                         device=card).to(dtype)}
            grads = {"a": (base * 1e-2).to(dtype), "b": odd * 0.5, "c": g}
            mu = {k: (torch.randn(v.shape, generator=gen, device=card) * 1e-3).to(mdt)
                  for k, v in params.items()}
            nu = {k: (torch.rand(v.shape, generator=gen, device=card) * 1e-4).to(mdt)
                  for k, v in params.items()}
            mu["b"] = torch.zeros(1001, device=card, dtype=mdt)[1:].copy_(mu["b"])
            nu["b"] = torch.zeros(1001, device=card, dtype=mdt)[1:].copy_(nu["b"])
            state = adamw.OptState(step=torch.tensor(5, dtype=torch.int32, device=card),
                                   mu=mu, nu=nu)
            copy = lambda t: adamw.tree_map(torch.clone, t)  # noqa: E731
            e_params, e_state = copy(params), adamw.OptState(state.step, copy(mu), copy(nu))
            lr = torch.tensor(1e-3, device=card)
            adamw.adamw_update_(grads, state, params, TC, lr)
            eager_adamw_(grads, e_state, e_params, TC, lr)
            for tree, etree in ((params, e_params), (mu, e_state.mu), (nu, e_state.nu)):
                for k in tree:
                    assert torch.equal(bits(tree[k]), bits(etree[k])), (dtype, mdt, k)


@pytest.mark.card
def test_norm_is_deterministic_on_card(card):
    gen = torch.Generator(device=card).manual_seed(2)
    grads = [torch.randn(n, generator=gen, device=card).bfloat16()
             for n in (5 * kernels.CHUNK + 3, 1, 4096)]
    norms = {kernels.clip_by_global_norm_cuda([g.clone() for g in grads], 1e9).item()
             for _ in range(5)}
    assert len(norms) == 1
    want = adamw.global_norm({str(i): g for i, g in enumerate(grads)}).item()
    assert abs(norms.pop() - want) <= 1e-6 * want
