"""The real occupancy head and ``occupancy_grid_to_points`` against the
JAX package, on the CPU.

The JAX head evaluates its four 3-D convs as depth-folded 2-D convs and
pools through reshapes (TPU rewrites of the same function); the port
runs plain ``Conv3d`` and ``max_pool3d``. One weight set goes through
``load_jax_variables`` ((3, 3, 3, Cin, Cout) kernels to (Cout, Cin, 3,
3, 3)). Both run in f32.

Tolerances: 1e-5 on the head alone (probabilities, four small convs
summing in another order); on the served path the ladder of
tests/test_torch_serving.py, and for the refined grid 1e-3 of mean
absolute difference, since a point that lands one cell apart moves the
head's input, not just one cell of its output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.core.config import CameraConfig as JaxCamera
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.core.config import OccupancyConfig as JaxOcc
from soccdpt_tpu.models.heads import OccupancyHead as JaxOccupancyHead
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model
from soccdpt_tpu.ops.geometry import occupancy_grid_to_points as jax_grid_to_points
from soccdpt_tpu.serving import make_serving_fn as jax_make_serving_fn

from soccdpt_torch.core.config import CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.models.heads import OccupancyHead
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.ops.geometry import occupancy_grid_to_points
from soccdpt_torch.serving import make_serving_fn
from soccdpt_torch.weights import init_random_, load_jax_variables

from test_torch_modules import perturbed_variables, to_np

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
TINY = dict(model_type="dpt_swin2_test_64", version=3, features=64, occupancy_head=True)


def _grid(seed, shape=(2, 16, 16, 8, 3)):
    """An accumulated grid as the voxelizer leaves it: mostly empty cells,
    some holding the summed scores of a few points."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 3.0, shape) * (rng.random(shape[:-1] + (1,)) < 0.3)
    return g.astype(np.float32)


def _jax_head(seed=0):
    jhead = JaxOccupancyHead(num_classes=3, identity=False)
    g = _grid(seed)
    variables = perturbed_variables(jhead.init(jax.random.PRNGKey(seed), jnp.asarray(g)), seed)
    return jhead, variables, g


def test_occupancy_head_matches_jax():
    jhead, variables, g = _jax_head()
    want = np.asarray(jhead.apply(variables, jnp.asarray(g)))
    port = load_jax_variables(OccupancyHead(3, identity=False), variables)
    with torch.no_grad():
        got = to_np(port(torch.from_numpy(g)))
    assert got.shape == want.shape == (2, 16, 16, 8, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0 and np.ptp(got) > 0.05
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_occupancy_head_matches_the_jax_folded_layout():
    """The JAX head also takes the voxelizer's (B, X, Y, C*Z) layout, which
    its served path hands it; the port's served path hands over the plain
    5-D grid. Same values either way."""
    jhead, variables, g = _jax_head(1)
    folded = np.ascontiguousarray(g.transpose(0, 1, 2, 4, 3)).reshape(2, 16, 16, 24)
    want = np.asarray(jhead.apply(variables, jnp.asarray(folded)))
    port = load_jax_variables(OccupancyHead(3, identity=False), variables)
    with torch.no_grad():
        got = to_np(port(torch.from_numpy(g)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_occupancy_head_identity_passes_through():
    g = torch.from_numpy(_grid(2))
    head = OccupancyHead(3, identity=True)
    assert head(g) is g and not list(head.parameters())


def test_occupancy_head_bf16_convs_give_f32_probabilities():
    """bf16 compute: the convs run in bf16, the logits, the upsample and
    the sigmoid in f32, and the result stays near the f32 one (2e-2: eight
    bits through four convs, squashed by the sigmoid)."""
    head = init_random_(OccupancyHead(3, identity=False), seed=3)
    g = torch.from_numpy(_grid(3))
    with torch.no_grad():
        want = head(g)
        got = head(g, torch.bfloat16)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(g.shape)
    assert float((got - want).abs().max()) < 2e-2


def test_loader_raises_on_a_missing_head_conv():
    _, variables, _ = _jax_head()
    params = {k: v for k, v in variables["params"].items() if k != "conv3"}
    with pytest.raises(KeyError, match="conv3"):
        load_jax_variables(OccupancyHead(3, identity=False), {"params": params})


@pytest.fixture(scope="module")
def stacks():
    jcfg = JaxModelConfig(camera=JaxCamera(**CAM), occupancy=JaxOcc(**OCC), **TINY)
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC), **TINY)
    jmodel = jax_build_model(jcfg)
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)), compute_occ=True, output_size=(48, 64)
    )
    variables = perturbed_variables(variables, 0)
    assert "occupancy_conv" in variables["params"]
    head = variables["params"]["depth_net"]["head"]["conv3"]
    head["kernel"] = head["kernel"] * 0.002
    head["bias"] = np.full_like(head["bias"], 0.3)
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    return jcfg, cfg, variables, model, frames


def test_serving_with_the_occupancy_head_matches_jax(stacks):
    jcfg, cfg, variables, model, frames = stacks
    want = jax_make_serving_fn(jcfg, variables, compute_occ=True)(jnp.asarray(frames))
    got = make_serving_fn(cfg, model, compute_occ=True, device="cpu")(frames)
    for g, w, atol, name in zip(
        got[:3], want[:3], (1e-4, 1e-4, 5e-3), ("inv_depth", "seg", "points")
    ):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=name)
    grid, wgrid = got[3].numpy(), np.asarray(want[3])
    assert grid.shape == wgrid.shape == (2, 16, 16, 8, 3)
    assert grid.min() >= 0.0 and grid.max() <= 1.0
    assert np.ptp(wgrid) > 0.05, "degenerate fixture: the head's output is flat"
    assert np.abs(grid - wgrid).mean() < 1e-3


def test_serving_without_a_grid_skips_the_head(stacks):
    _, cfg, _, model, frames = stacks
    got = make_serving_fn(cfg, model, compute_occ=False, device="cpu")(frames)
    assert got[3] is None


@pytest.mark.parametrize("threshold", [0.5, 0.9])
def test_occupancy_grid_to_points_equals_jax(threshold):
    grid = np.random.default_rng(8).random((16, 16, 8, 3)).astype(np.float32)
    occ, jocc = OccupancyConfig(**OCC), JaxOcc(**OCC)
    want = jax_grid_to_points(grid, jocc, threshold)
    got = occupancy_grid_to_points(grid, occ, threshold)
    assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 4
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(occupancy_grid_to_points(torch.from_numpy(grid), occ, threshold), want)


def test_occupancy_grid_to_points_of_an_empty_grid():
    occ = OccupancyConfig(**OCC)
    got = occupancy_grid_to_points(np.zeros((16, 16, 8, 3), np.float32), occ)
    np.testing.assert_array_equal(got, jax_grid_to_points(np.zeros((16, 16, 8, 3)), JaxOcc(**OCC)))
    assert got.shape == (0, 4)
