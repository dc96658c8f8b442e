"""``granite-serve`` on the CPU at the program's smoke size: its plain
reference (``reference/granite.py``) against ``repro_torch``, ``correct``
false for the planted token and for the control, and ``mfu.serve.granite``
(the model FLOPs of a layer pattern, which ``flops.py`` does not count)
against a hand count and on a traced run.

In fp32 the program and the reference compute the same model, so ``gap`` is
round-off. The smoke limit sits between the program's bf16 readings and
the control's and the fault's on this CPU over seeds 1-4 and 3000000013-15:
``gap`` 3.8e-4 to 6.0e-4 for the program, 1.7e-3 to 4.3e-3 for the control,
3.7e-3 to 5.5e-3 with a token altered. The cell's own limits are set for its
own sizes from runs on the card (``PERF.md``).
"""
import pytest

from bench import harness, roofline
from bench.tests import support

CELL = "granite-serve"
SMOKE_LIMITS = {"gap": 1e-3}


def failed(out):
    return sorted(c.name for c in out["checks"] if not c.ok)


def test_reference_is_the_program_in_fp32():
    out = support.cpu_run(CELL, dtype="float32", seed=3000000012, limits=SMOKE_LIMITS)
    assert out["readings"]["gap"] < 1e-4
    assert failed(out) == []


def test_program_in_bf16_is_correct():
    out = support.cpu_run(CELL, seed=3000000013, limits=SMOKE_LIMITS)
    assert failed(out) == [], out["checks"]


@pytest.mark.parametrize("kind", ["token", "control"])
def test_fault_and_control_are_not_correct(kind):
    kw = {"control": True} if kind == "control" else {"fault": "token"}
    out = support.cpu_run(CELL, seed=3000000014, limits=SMOKE_LIMITS, **kw)
    assert failed(out) == ["gap"], out["checks"]


def test_batch_flops_by_hand():
    cfg = harness.load_json(harness.BENCH / "configs" / "granite-4.0-h-small-10l.json")["model"]
    mfu = harness.metric_reader("mfu.serve.granite")
    # in_proj to z, x, B, C, dt (2*8192 + 2*128 + 128) and out_proj; wq, wk,
    # wv, wo; 10 of the experts, the shared expert and the router
    mamba, attn, ffn = 4096 * 16768 + 8192 * 4096, 2 * 4096 * 4096 + 2 * 4096 * 1024, \
        10 * 3 * 4096 * 768 + 3 * 4096 * 1536 + 4096 * 72
    assert mfu.token_params(cfg) == (mamba, attn, ffn)
    body = 9 * mamba + attn + 10 * ffn
    assert body == 2_097_479_680
    unembed = 100352 * 4096
    # one row's SSD scan in one layer: 16 chunks of 256 from a zero state,
    # C.B^T once (N = 128 deep), W.x (P = 64), C.h and the state update
    tri = 256 * 257 // 2
    ssd = 2 * tri * 128 * 16 + 128 * (16 * 2 * tri * 64 + 2 * 256 * 64 * 128 * (1 + 2 * 15))
    prefill = (2 * (body * 4096 + unembed) + 9 * ssd
               + 4 * 128 * 32 * (4096 * 4097 // 2))
    decode = 2 * (body + unembed) + 9 * 6 * 128 * 64 * 128 + 4 * 128 * 32 * 4097
    assert mfu.batch_flops(cfg, 1, 4096, 2) == prefill + decode
    assert abs(mfu.batch_flops(cfg, 8, 4096, 2) / 139e12 - 1) < 0.02   # "about 139 TFLOP"


def test_mfu_on_a_traced_run():
    out = support.cpu_run(CELL, trace=True, seed=2**31 + 19)
    trace, ctx = out["trace"], out["ctx"]
    value = harness.metric_reader("mfu.serve.granite").read(trace, ctx)
    assert value is not None and 0 < value < 100
    rounds = [dict(r, flops=sum(harness.metric_reader("mfu.serve.granite").batch_flops(
        ctx.config["model"], n, ctx.traffic["prompt_len"], ctx.traffic["generated"])
        for n in r["rows"])) for r in trace["rounds"]]
    assert value == pytest.approx(100 * harness.steady_rate(trace, rounds)
                                  / roofline.PEAK_BF16_FLOPS)
