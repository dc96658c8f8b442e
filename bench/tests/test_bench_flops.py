"""The frozen FLOP arithmetic against figures counted by hand."""
from bench import flops, harness, roofline


def config(name):
    return harness.load_json(harness.BENCH / "configs" / f"{name}.json")["model"]


def test_mixtral_token_params():
    cfg = config("mixtral-8x22b-1l")
    attn = 6144 * 6144 + 2 * 6144 * 1024 + 6144 * 6144
    assert attn == 88_080_384
    experts = 2 * 3 * 6144 * 16384
    assert experts == 603_979_776
    assert flops.layer_matmul_params(cfg) == attn + experts + 6144 * 8
    assert flops.unembed_params(cfg) == 201_326_592
    assert flops.token_matmul_params(cfg) == 893_435_904


def test_hymba_token_params():
    cfg = config("hymba-1.5b")
    # wq, wk, wv, wo; in_proj to z, x, B, C, dt (2*3200 + 2*16 + 50); out_proj; the MLP
    per_layer = (1600 * 1600 + 2 * 1600 * 320 + 1600 * 1600 + 1600 * 6482 + 3200 * 1600
                 + 3 * 1600 * 5504)
    assert per_layer * 32 == 1_537_740_800
    assert flops.token_matmul_params(cfg) == 1_537_740_800 + 32001 * 1600 == 1_588_942_400


def test_live_pairs_by_hand():
    assert roofline.live_pairs(4, 4, True, 0, 0) == 10
    assert roofline.live_pairs(4, 4, True, 2, 0) == 7          # 1 + 2 + 2 + 2
    assert roofline.live_pairs(1, 4097, True, 1024, 4096) == 1024
    assert roofline.live_pairs(2048, 2048, True, 4096, 0) == 2048 * 2049 // 2


def test_hymba_attention_and_ssd_terms_by_hand():
    cfg = config("hymba-1.5b")
    S, W = 4096, 1024
    pairs = W * (W + 1) // 2 + (S - W) * W          # the first W rows ramp up
    assert roofline.live_pairs(S, S, True, W, 0) == pairs
    assert flops.attention_flops(cfg, 1, S, S, 0) == 32 * 4 * 64 * 25 * pairs
    # SSD, one layer, one row, 16 chunks of 256 from a zero state: C.B^T once
    # per group (N = 16 deep), W.x (P = 64 wide) over each chunk's lower
    # triangle in each of the 50 heads, C.h and the state update (P x N)
    tri = 256 * 257 // 2
    cb = 2 * tri * 16
    rest_per_head = 16 * 2 * tri * 64 + 2 * 256 * 64 * 16 * (1 + 2 * 15)
    assert flops.ssd_forward_flops(cfg, 1, S) == 32 * (cb * 16 + 50 * rest_per_head)


def test_step_and_batch_totals():
    mix, hym = config("mixtral-8x22b-1l"), config("hymba-1.5b")
    step = flops.train_step_flops(mix, 8, 2048)
    assert step == 6 * 893_435_904 * 16384 + 3 * 4 * 128 * 48 * (2048 * 2049 // 2) * 8
    body = 1_537_740_800
    prefill = (2 * body * 8 * 4096 + 2 * 51_201_600 * 8 + flops.attention_flops(hym, 8, 4096, 4096, 0)
               + flops.ssd_forward_flops(hym, 8, 4096))
    decode = (2 * 1_588_942_400 * 8 + 32 * 4 * 64 * 25 * 1024 * 8
              + 32 * 6 * 50 * 64 * 16 * 8)
    assert flops.serve_batch_flops(hym, 8, 4096, 2) == prefill + decode
    assert abs(prefill / 1.0e14 - 1) < 0.1                     # "about 1.0e14 a node"
