"""The yardstick's FLOP and byte counts against counts worked out by hand
at the cells' shapes (B = 64, T = 750, L = 119840)."""

import pytest

from portbench.harness import bench, kernels


def _config(name):
    return (bench.read_json(bench.HERE / "configs" / f"{name}.json"),
            bench.load_file(bench.HERE / "configs" / f"{name}.py", name))


def test_ecapa_forward_flops_by_hand():
    cfg, mod = _config("ecapa_tdnn_512")
    stem = 2 * 750 * 512 * 60 * 5                         # conv k=5, 60 -> 512
    conv1 = conv3 = 2 * 750 * 512 * 512                   # 1x1 convs
    chain = 7 * 2 * 750 * 64 * 64 * 3                     # seven k=3 convs
    se = 2 * 512 * 128 + 2 * 128 * 512                    # one frame
    mfa = 2 * 750 * 1536 * 1536
    context = 2 * 750 * 1536 * 128 + 2 * 2 * 1536 * 128   # x per frame, [mean|std] once
    attn3 = 2 * 750 * 128 * 1536
    head = 2 * 3072 * 256 + 2 * 256 * 2
    want = stem + 3 * (conv1 + chain + conv3 + se) + mfa + context + attn3 \
        + head
    assert want == 7_108_682_752
    assert mod.forward_flops(cfg, 750) == want


def test_resnet18_forward_flops_by_hand():
    cfg, mod = _config("resnet18_air")
    conv = lambda hw, cout, cin, k: 2 * hw * cout * cin * k
    s1, s2, s3, s4 = 18 * 750, 9 * 375, 5 * 188, 3 * 94   # (F, T) per stage
    want = (conv(s1, 16, 1, 27)                           # stem (9, 3) / (3, 1)
            + conv(s1, 64, 16, 9) + conv(s1, 64, 64, 9) + conv(s1, 64, 16, 1)
            + 2 * conv(s1, 64, 64, 9)
            + conv(s2, 128, 64, 9) + conv(s2, 128, 128, 9)
            + conv(s2, 128, 64, 1) + 2 * conv(s2, 128, 128, 9)
            + conv(s3, 256, 128, 9) + conv(s3, 256, 256, 9)
            + conv(s3, 256, 128, 1) + 2 * conv(s3, 256, 256, 9)
            + conv(s4, 512, 256, 9) + conv(s4, 512, 512, 9)
            + conv(s4, 512, 256, 1) + 2 * conv(s4, 512, 512, 9)
            + conv(94, 256, 512, 9)                       # conv5 (3, 3) -> 1 row
            + 2 * 94 * 256 + 2 * 512 * 256 + 2 * 256 * 2)
    assert mod.forward_flops(cfg, 750) == want


def test_kernel_bytes_and_operations_by_hand():
    b1 = kernels.lfcc_b1(64, 119840, 320, 160, 512, 20)
    assert b1["bytes"] == 4 * 64 * 119840 + 4 * 64 * 750 * 20
    b2 = kernels.res2_chain_b2(64, 750, 512, 8, 3, "bfloat16")
    assert b2["bytes"] == 2 * 64 * 750 * 512 * 2 + 7 * (64 * 64 * 3 * 2
                                                        + 3 * 64 * 4)
    assert b2["flops"] == 7 * (2 * 64 * 750 * 64 * 64 * 3 + 4 * 64 * 750 * 64)
    b3 = kernels.attn_pool_b3(64, 750, 1536, 128, "bfloat16")
    assert b3["bytes"] == (64 * 750 * 1536 * 2
                           + 4 * (4 * 1536 * 128 + 3 * 128 + 1536)
                           + 4 * 64 * 3072)
    b4a = kernels.softmax_stats_b4a(64, 750, 1536, 128, "bfloat16")
    assert b4a["flops"] == 2 * 64 * 750 * 128 * 1536 + 7 * 64 * 750 * 1536
    assert b4a["bytes"] == (64 * 750 * 1664 * 2 + 4 * (128 * 1536 + 1536)
                            + 2 * 4 * 64 * 1536)
    b4b = kernels.softmax_stats_b4b(64, 750, 1536, 128, "bfloat16")
    assert b4b["flops"] == 3 * 2 * 64 * 750 * 128 * 1536 \
        + 12 * 64 * 750 * 1536
    # B4a is counted once at the TF32 rate, not as three TF32 products
    assert b4a["peak"] == b4b["peak"] == "tf32"


def test_least_time_is_the_larger_bound():
    b2 = kernels.res2_chain_b2(64, 750, 512, 8, 3, "bfloat16")
    t = kernels.least_seconds(b2)
    assert t == pytest.approx(b2["bytes"] / 3.35e12)      # bytes bound it
    assert t > b2["flops"] / 989e12
    b4b = kernels.softmax_stats_b4b(64, 750, 1536, 128, "bfloat16")
    assert kernels.least_seconds(b4b) == pytest.approx(
        b4b["flops"] / 495e12)                              # operations bound it


def test_ecapa_kernel_work_units():
    cfg, mod = _config("ecapa_tdnn_512")
    score = mod.kernel_work(cfg, 64, train=False)
    one = kernels.res2_chain_b2(64, 750, 512, 8, 3, "bfloat16")
    assert set(score) == {"B2_bf16", "B3"}
    assert score["B2_bf16"]["bytes"] == 3 * one["bytes"]    # three blocks a batch
    assert set(mod.kernel_work(cfg, 64, train=True)) == {"B4a", "B4b"}
    cfg_r, mod_r = _config("resnet18_air")
    assert mod_r.kernel_work(cfg_r, 64, train=True) == {}
