"""ViT3D, the volumetric refiner over the occupancy grid, of the port against
the JAX package (``soccdpt_tpu/models/backbones/vit_3d.py``), on the CPU.

One weight set goes from the JAX variables tree into the port
(``load_jax_variables``; ``perturbed_variables`` moves every leaf off its
init, the zero class token and biases included). The grid comes from a
numpy seed. Both stacks run in f32. Small shapes: a (16, 16, 8) grid of 3
classes cut into (4, 4, 4) patches, width 32, 4 heads, 2 blocks.

Tolerances: 1e-5 (atol and rtol) on the refined grid's probabilities and
the class logits (two blocks of f32 attention and MLP); every leaf's
gradient of a weighted sum of the refined grid to 2e-3 of its norm (plus
1e-6 of the largest leaf's norm), as tests/test_torch_swin1.py holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.models.backbones.vit_3d import ViT3D as JaxViT3D

from soccdpt_torch.models.backbones import make_backbone
from soccdpt_torch.models.backbones.vit_3d import ViT3D
from soccdpt_torch.weights import load_jax_variables, named_flax_params, to_jax_variables

from test_torch_modules import perturbed_variables, to_np
from test_torch_swin1 import GRAD_ATOL, GRAD_RTOL, _tree
from test_torch_training import _assert_same_leaves

TOL = 1e-5
GRID = (16, 16, 8)
SMALL = dict(patch_size=(4, 4, 4), embed_dim=32, depth=2, num_heads=4, num_classes=3)


def _stacks(mode, seed=0):
    grid = np.random.default_rng(seed).uniform(0.0, 1.0, (2, *GRID, 3)).astype(np.float32)
    jmod = JaxViT3D(mode=mode, **SMALL)
    variables = perturbed_variables(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(grid)), seed)
    port = load_jax_variables(ViT3D(grid_size=GRID, mode=mode, **SMALL), variables)
    return grid, jmod, variables, port


@pytest.mark.parametrize("mode", ["refine", "classify"])
def test_vit3d_matches_jax(mode):
    grid, jmod, variables, port = _stacks(mode)
    want = np.asarray(jmod.apply(variables, jnp.asarray(grid)))
    with torch.no_grad():
        got = port(torch.from_numpy(grid))
    shape = (2, *GRID, 3) if mode == "refine" else (2, 3)
    assert tuple(got.shape) == want.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), want, atol=TOL, rtol=TOL)
    if mode == "refine":
        assert 0.0 < float(got.min()) and float(got.max()) < 1.0


def test_vit3d_gradients_match_jax():
    grid, jmod, variables, port = _stacks("refine", seed=1)
    w = np.random.default_rng(2).standard_normal((2, *GRID, 3)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jmod.apply({"params": p}, jnp.asarray(grid)) * w))(
        variables["params"])
    (port(torch.from_numpy(grid)) * torch.from_numpy(w)).sum().backward()
    assert all(p.grad is not None for _, p in named_flax_params(port))
    _assert_same_leaves(to_jax_variables(port, grads=True)["params"], _tree(want),
                        GRAD_RTOL, GRAD_ATOL, what="gradient")


def test_vit3d_tree_keeps_flax_shapes():
    """The attention's ``DenseGeneral`` kernels keep flax's shapes, so the
    tree goes across as it is, and back."""
    _, _, variables, port = _stacks("refine")
    assert tuple(port.attn_0.query.kernel.shape) == (32, 4, 8)
    assert tuple(port.attn_0.out.kernel.shape) == (4, 8, 32)
    back = to_jax_variables(port)["params"]
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_make_backbone_builds_vit3d():
    """At the grid the occupancy pipeline makes, 256 x 256 x 32 in (16, 16, 8)
    patches: 1,024 tokens and a class token."""
    factory, chans = make_backbone("vit_3d")
    assert chans == ()
    with torch.device("meta"):
        mod = factory()
    assert isinstance(mod, ViT3D) and mod.mode == "refine"
    assert tuple(mod.pos_embed.shape) == (1, 1025, 256)
    assert tuple(mod.unpatch.weight.shape) == (16 * 16 * 8 * 3, 256)
    with pytest.raises(ValueError, match="multiple"):
        ViT3D(grid_size=(20, 16, 8))
    with pytest.raises(ValueError, match="mode"):
        ViT3D(mode="segment")
