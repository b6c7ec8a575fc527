"""The copied work counts against hand counts at one shape each."""
import pytest

from benchmark import work


def test_k1_flagship_stage0_shifted():
    # batch 1, stage 0 of Swin-V2-T: 16 windows of 16x16 tokens, 3 heads of 32, bf16
    nbytes, flops = work.k1_bytes_flops(16, 3, 256, 32, 16, 2)
    assert nbytes == 4 * 16 * 3 * 256 * 32 * 2 + 3 * 256 * 256 * 4 + 16 * 256 * 256 * 4
    assert flops == 2 * (2 * 16 * 3 * 256 * 256 * 32)


def test_k6_beit_large_512():
    nbytes, flops = work.k6_bytes_flops(6, 16, 1025, 64, 2, 4)
    assert nbytes == 4 * 6 * 16 * 1025 * 64 * 2 + 16 * 1025 * 1025 * 4
    assert flops == 4 * 6 * 16 * 1025 * 1025 * 64


def test_k2_one_frame():
    rows, kept, slots, C = 1080 * 1920, 1_500_000, 256 * 256 * 32, 3
    assert work.k2_bytes(rows, kept, slots, C) == rows * 4 + kept * 12 + slots * 12


def test_bound_picks_the_larger():
    t, which = work.bound(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and which == "bytes"
    t, which = work.bound(1.0, 989e12)
    assert t == pytest.approx(1.0) and which == "operations"


def test_swin2_windows_flagship():
    bcfg = {"img_size": 256, "patch_size": 4, "embed_dim": 96, "depths": [2, 2, 6, 2],
            "num_heads": [3, 6, 12, 24], "window_size": 16}
    calls = work.swin2_windows(bcfg, 6)
    assert len(calls) == 12
    assert calls[0] == (96, 3, 256, 32, 0) and calls[1] == (96, 3, 256, 32, 16)
    assert calls[2] == (24, 6, 256, 32, 0) and calls[3] == (24, 6, 256, 32, 4)
    # stage 2 is one window: no shift; stage 3 clamps the window to 8x8
    assert calls[4:10] == [(6, 12, 256, 32, 0)] * 6
    assert calls[10:] == [(6, 24, 64, 32, 0)] * 2


def test_beit_attention_shape():
    bcfg = {"img_size": 512, "patch_size": 16, "embed_dim": 1024, "num_heads": 16}
    assert work.beit_attention(bcfg, 2) == (2, 16, 1025, 64)
