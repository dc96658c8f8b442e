"""Every family's served logits come from ``models/common.py::logits_f32``.

Prefill and decode of each serving family (dense and MoE transformers, the
layer pattern, Mamba-2, the encoder-decoder) at the smoke size on the CPU:

  * the logits are exactly the upcast product ``h.float() @ W.float().T`` of
    the final hidden state and the family's unembedding, divided by the
    config's ``logits_scaling`` and soft-capped (transformers) or left as
    they are (Mamba-2, encoder-decoder);
  * with ``_LogitsF32`` selected, as on the card, each call is one forward
    of it and the logits are the upcast's to the bit (on the CPU its GEMM
    upcasts);
  * no model file but ``common.py`` forms an unembedding product.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import api, common, encdec, mamba, transformer

MODELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "models"
B, S, MAX_LEN, DECODE = 2, 16, 20, 2     # S: one SSD chunk of the smoke configs

# arch -> the module whose prefill and decode it runs
FAMILIES = {
    "llama3.2-3b": transformer,           # dense, tied
    "mixtral-8x22b": transformer,         # MoE, its own unembedding
    "grok-1-314b": transformer,           # MoE, logits soft-capped at 30
    "granite-4.0-h-small": transformer,   # layer pattern, logits divided by 16
    "mamba2-130m": mamba,
    "whisper-tiny": encdec,
}


def _unembed(cfg, params):
    return transformer.unembed_matrix(cfg, params) if cfg.family not in ("ssm", "encdec") \
        else params["embed"]


def _upcast(cfg, h, w):
    """The product each family formed before ``logits_f32``."""
    logits = h.float() @ w.float().T
    if cfg.family in ("ssm", "encdec"):
        return logits
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return common.softcap(logits, cfg.logits_softcap)


def _serve(arch, monkeypatch):
    """Prefill and ``DECODE`` decode steps of ``arch``'s smoke config; returns
    the config, the parameters and, for each call, (logits, the hidden state
    and unembedding handed to ``logits_f32``, the ``_LogitsF32`` forwards
    the call moved)."""
    cfg = get_smoke_config(arch)
    params = api.init_params(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, S + DECODE), generator=g)
    kw = {}
    if cfg.family == "encdec":
        kw["embeds"] = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                                   generator=g).to(common.torch_dtype(cfg.dtype))
    seen = []

    def spy(h, unembed, **k):
        seen.append((h.clone(), unembed))
        return common.logits_f32(h, unembed, **k)

    monkeypatch.setattr(FAMILIES[arch], "logits_f32", spy)
    calls = []

    def call(fn, *a, **k):
        before = common._LogitsF32.forwards
        logits, cache = fn(*a, **k)
        calls.append((logits, *seen[-1], common._LogitsF32.forwards - before))
        return logits, cache

    with torch.no_grad():
        _, cache = call(api.prefill, cfg, params, toks[:, :S], MAX_LEN, **kw)
        for t in range(DECODE):
            _, cache = call(api.decode_step, cfg, params, cache, toks[:, S + t:S + t + 1])
    assert len(seen) == 1 + DECODE
    return cfg, params, calls


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_served_logits_are_the_upcast_product(arch, monkeypatch):
    """(B, 1, V) fp32 logits of every call, ``torch.equal`` to the upcast of
    the final hidden state against the family's own unembedding; the CPU
    never selects ``_LogitsF32``."""
    cfg, params, calls = _serve(arch, monkeypatch)
    for logits, h, w, forwards in calls:
        assert w is _unembed(cfg, params)
        assert logits.dtype == torch.float32 and logits.shape == (B, 1, cfg.vocab_size)
        assert torch.equal(logits, _upcast(cfg, h, w))
        assert forwards == 0


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_served_logits_through_the_function_as_on_the_card(arch, monkeypatch):
    """With ``_LogitsF32`` selected, as ``logits_f32`` selects it for bf16 on
    the card, each prefill and decode step is one forward of it, and every
    call's logits are the upcast run's to the bit."""
    _, _, want = _serve(arch, monkeypatch)
    monkeypatch.setattr(common, "_tensor_core_logits", lambda h, u: True)
    _, _, got = _serve(arch, monkeypatch)
    for (logits, *_, forwards), (ref, *_) in zip(got, want):
        assert forwards == 1
        assert torch.equal(logits, ref)


@pytest.mark.parametrize("module", ["transformer.py", "mamba.py", "encdec.py"])
def test_no_family_forms_its_own_unembedding_product(module):
    """The families call ``logits_f32`` and keep no ``_logits`` or upcast of
    their own."""
    src = (MODELS / module).read_text()
    assert "logits_f32(" in src
    assert not re.search(r"def _logits\b", src)
    assert not re.search(r"\.float\(\)\s*\.T\b", src)
    assert not re.search(r"\bembed\"\]\.float\(\)|unembed\w*\([^)]*\)\.float\(\)", src)
