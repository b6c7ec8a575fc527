"""The Next-ViT backbone (``dpt_next_vit_large_384``'s ``next_vit_large_6m``)
of the port against the JAX package, on the CPU.

One weight set goes from the JAX variables tree into the port
(``load_jax_variables``; ``perturbed_variables`` moves every leaf off its
init). Inputs come from numpy seeds; both stacks run in f32. The test
config ``nextvittest_64`` has all four stages, NCB and NTB blocks, a
stride-2 patch embed at each stage, E_MHSA with and without the pooling
of its keys and values (``sr_ratio`` 2 and 1), and grouped MHCA convs.

Tolerances are tests/test_torch_swin1.py's (stated there, with why): 1e-4
on features; 3e-5 of each leaf's norm on running statistics; 2e-3 of each
leaf's norm (plus 1e-6 of the largest) on gradients, 5e-2 leaf by leaf
and 2e-3 for the median in training mode, where a ReLU unit at its kink
moves every leaf before it; 1e-4 on the V3 loss; the composition ladder
on the served path.
"""
import dataclasses

import numpy as np
import pytest
import torch

from soccdpt_tpu.models.backbones.next_vit import NEXT_VIT_CONFIGS as JAX_CFGS
from soccdpt_tpu.models.backbones.next_vit import _make_divisible

from soccdpt_torch.models.backbones import make_backbone
from soccdpt_torch.models.backbones.next_vit import NEXT_VIT_CONFIGS, make_divisible

from test_torch_swin1 import (
    check_backbone,
    check_full_width_tree,
    check_loss_and_gradients,
    check_served,
)


@pytest.mark.parametrize("divisor", [8, 32])
def test_make_divisible_is_the_jax_one(divisor):
    for v in np.linspace(1.0, 1600.0, 401):
        assert make_divisible(float(v), divisor) == _make_divisible(float(v), divisor)


@pytest.mark.parametrize("name", sorted(NEXT_VIT_CONFIGS))
def test_plan_is_the_jax_one(name):
    cfg = NEXT_VIT_CONFIGS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_CFGS[name])
    assert cfg.plan() == JAX_CFGS[name].plan()


def test_large_plan_and_hooks():
    """40 blocks; the hooks are each stage's last, at widths 96, 256, 512,
    1024."""
    factory, chans = make_backbone("next_vit_large_6m")
    plan = NEXT_VIT_CONFIGS["next_vit_large_6m"].plan()
    assert len(plan) == 40 and factory.keywords["hooks"] == (2, 6, 36, 39)
    assert chans == (96, 256, 512, 1024)
    assert [b[0] for b in plan].count("ntb") == 8
    with torch.device("meta"):
        bb = factory()
    # E_MHSA pools the flattened sequence: kernel sr^2 at stages 1-2, none at 3
    assert [bb.features6.e_mhsa.sr_ratio, bb.features11.e_mhsa.sr_ratio,
            bb.features39.e_mhsa.sr_ratio] == [4, 2, 1]
    assert not hasattr(bb.features39.e_mhsa, "norm")
    assert bb.features3.mhca.group_conv3x3.groups == 192 // 32


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_next_vit_features_match_jax(train):
    """Training mode: features, the batch statistics of every BatchNorm
    after the forward, and every parameter's gradient."""
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    check_backbone("nextvittest_64", x, train)


def test_ntb_drop_path_rates_split_by_the_mix_ratio():
    """With a stochastic-depth rate, an NTB scales it by ``mix_block_ratio``
    on the attention branch and by its complement on the conv branch; the
    draws come from the generator."""
    cfg = dataclasses.replace(NEXT_VIT_CONFIGS["nextvittest_64"], drop_path_rate=0.2)
    factory, _ = make_backbone("nextvittest_64")
    bb = factory(cfg=cfg).train()
    ntb = bb.features2
    assert ntb.mix_block_ratio == 0.75 and ntb.drop_path_rate == pytest.approx(0.2 * 2 / 9)
    img = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        f1 = bb(img, generator=torch.Generator().manual_seed(2))
        f2 = bb(img, generator=torch.Generator().manual_seed(2))
        f3 = bb(img, generator=torch.Generator().manual_seed(3))
    assert torch.equal(f1[3], f2[3]) and not torch.equal(f1[3], f3[3])


def test_full_width_tree_is_the_jax_one():
    """``dpt_next_vit_large_384`` V3 at 384 px."""
    assert 60e6 < check_full_width_tree("dpt_next_vit_large_384") < 80e6


@pytest.mark.parametrize("version", [1, 2, 3])
def test_served_matches_jax(version):
    check_served("dpt_nextvittest_64", version)


def test_loss_and_gradients_match_jax():
    """The seg head's last conv scaled by 0.01: at the 0.1 of the other
    families, Next-ViT's seg logits reach -66, where f32's sigmoid
    saturates and the BCE's gradient is rounding noise."""
    check_loss_and_gradients("dpt_nextvittest_64", seg_scale=0.01)
