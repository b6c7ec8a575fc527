"""The copied work counts against hand counts at one shape each; the
trunk families' call lists against the counts the cells read before
they moved there, and against the program's own Swin-V2 blocks."""
from types import SimpleNamespace

import pytest
import torch

from benchmark import reference, run, spec, work
from benchmark.reference import beit, swin2
from benchmark.trace import Event, Trace


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


def _cfg(net: int, **backbone) -> dict:
    return {"net_size": [net, net], "backbone": backbone}


FLAGSHIP = _cfg(256, family="swin2", img_size=256, patch_size=4, embed_dim=96,
                depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24], window_size=16)
BEIT_L = _cfg(512, family="beit", img_size=512, patch_size=16, embed_dim=1024, depth=24,
              num_heads=16)


def test_swin2_windows_flagship():
    calls = swin2.k1_calls(FLAGSHIP, 6)
    assert len(calls) == 12
    assert calls[0] == (96, 3, 256, 32, 0) and calls[1] == (96, 3, 256, 32, 16)
    assert calls[2] == (24, 6, 256, 32, 0) and calls[3] == (24, 6, 256, 32, 4)
    # stage 2 is one window: no shift; stage 3 clamps the window to 8x8
    assert calls[4:10] == [(6, 12, 256, 32, 0)] * 6
    assert calls[10:] == [(6, 24, 64, 32, 0)] * 2


def test_beit_attention_shape():
    assert beit.k6_calls(BEIT_L, 2) == [(2, 16, 1025, 64, 4)] * 24


# The counts as the harness made them before the trunk families held them
# (``work.swin2_windows``, ``work.beit_attention``), kept to pin the cells'
# readings.
def old_swin2_windows(bcfg: dict, batch: int):
    grid = bcfg["img_size"] // bcfg["patch_size"]
    out = []
    for i, depth in enumerate(bcfg["depths"]):
        res = grid >> i
        ws = min(bcfg["window_size"], res)
        windows = (res // ws) ** 2
        heads = bcfg["num_heads"][i]
        d = bcfg["embed_dim"] * 2**i // heads
        for j in range(depth):
            shifted = j % 2 == 1 and ws < res
            out.append((batch * windows, heads, ws * ws, d, windows if shifted else 0))
    return out


def old_beit_attention(bcfg: dict, batch: int):
    g = bcfg["img_size"] // bcfg["patch_size"]
    return batch, bcfg["num_heads"], g * g + 1, bcfg["embed_dim"] // bcfg["num_heads"]


# The cells whose counts moved into their families, each with its family,
# named here so that a cell added to BENCHMARK.json does not reach the test.
PINNED = {"beitl512.rig6.20hz.grid": "beit", "swin2t.backlog.b6.grid": "swin2"}


def _slice(kernel: str, launches: int, seconds: float):
    per = seconds / launches * 1e6
    return Trace(device=[Event(kernel, i * per, (i + 1) * per) for i in range(launches)])


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_cell_counts_unchanged(workload):
    """Each cell's K1 and K6 bounds a request, and its readers' shares, as
    the old counts gave them; a reader of a kernel the trunk does not run
    reads nothing."""
    cell = spec.load(run.ROOT, workload)
    cfg, batch = cell.config, cell.traffic["batch"]
    assert cfg["backbone"]["family"] == PINNED[workload]
    k1, k6 = (reference.kernel_calls(cfg, k, batch) for k in ("k1", "k6"))
    seconds = 0.05
    if PINNED[workload] == "swin2":
        assert k6 is None and k1 == old_swin2_windows(cfg["backbone"], batch)
        old = sum(work.bound(*work.k1_bytes_flops(*c, itemsize=2))[0]
                  for c in old_swin2_windows(cfg["backbone"], batch))
        r = SimpleNamespace(trace=_slice("window_attention_kernel", 240, seconds),
                            config=cfg, batch=batch)
        assert spec.reader("k1_roofline")(r) == pytest.approx(
            100.0 * old * (240 / 12) / seconds, rel=1e-12)
        r.trace = _slice("global_attention_kernel", 24, seconds)
        assert spec.reader("k6_roofline")(r) is None
    else:
        assert k1 is None and k6 == [old_beit_attention(cfg["backbone"], batch) + (4,)] * 24
        old = work.bound(*work.k6_bytes_flops(*old_beit_attention(cfg["backbone"], batch),
                                              2, 4))[0]
        r = SimpleNamespace(trace=_slice("global_attention_kernel", 480, seconds),
                            config=cfg, batch=batch)
        assert spec.reader("k6_roofline")(r) == pytest.approx(
            100.0 * old * 480 / seconds, rel=1e-12)
        r.trace = _slice("window_attention_kernel", 12, seconds)
        assert spec.reader("k1_roofline")(r) is None


SWIN2_B = dict(family="swin2", patch_size=4, embed_dim=128, depths=[2, 2, 18, 2],
               num_heads=[4, 8, 16, 32], window_size=24)


@pytest.mark.parametrize("net, windows, tokens", [
    (256, [9, 4, 1, 1], [576, 576, 256, 64]),
    (384, [16, 4, 1, 1], [576, 576, 576, 144]),
])
def test_k1_counts_padded_windows(net, windows, tokens):
    """Swin-V2-B's K1 launches a frame as the program's ``SwinV2Block``
    runs them: stages padded up to whole windows, a mask where a block
    shifts or pads."""
    from soccdpt_torch.models.backbones.swin2 import SwinV2Block

    cfg = _cfg(net, img_size=384, **SWIN2_B)
    calls = swin2.k1_calls(cfg, 1)
    at = 0
    for i, depth in enumerate(SWIN2_B["depths"]):
        res = (net // 4) >> i
        for j in range(depth):
            with torch.device("meta"):
                block = SwinV2Block(128 * 2**i, SWIN2_B["num_heads"][i], (res, res), 24,
                                    j % 2 == 1, 0, 4.0)
            Bw, H, N, d, nW = calls[at + j]
            assert (Bw, N) == (windows[i], tokens[i]) == (
                (block.padded[0] // block.ws) ** 2, block.ws ** 2)
            assert (H, d) == (SWIN2_B["num_heads"][i], 32)
            mask = block.attn_mask
            assert nW == (0 if mask is None else mask.shape[0])
            if i == 2 and net == 256:
                assert block.shift == 0 and mask is None
        at += depth
    assert at == len(calls)
