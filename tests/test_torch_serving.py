"""The whole served path: the JAX package's ``make_serving_fn`` against the
port's, uint8 frames in, (inv_depth, seg, points, grid) out, under one
weight set carried by ``load_jax_variables``. Tiny setup of
tests/test_models.py (``dpt_swin2_test_64``, a 48x64 camera, a 16x16x8
grid with ``pc_scale=(1,1,1)`` and ``pc_shift=(2,2,0)``), f32.

Tolerance ladder of tests/test_composition_oracle.py: atol 1e-4 on
inv_depth and seg (accumulated float error of two f32 stacks), 5e-3 m on
points (depth = 1/inv amplifies the inv error by depth^2; the depth
head's last conv is biased so inv stays near 0.3), and less than 1 % of
the grid's mass mismatched (a point within float error of a voxel face
may land one cell apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.core.config import CameraConfig as JaxCamera
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.core.config import OccupancyConfig as JaxOcc
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model
from soccdpt_tpu.serving import make_serving_fn as jax_make_serving_fn

from soccdpt_torch.core.config import CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.kernels.segment_sum import segment_sum
from soccdpt_torch.kernels.window_attention import window_attention
from soccdpt_torch.models.soccdpt import SOccDPT_V3, build_model
from soccdpt_torch.serving import make_serving_fn
from soccdpt_torch.weights import load_jax_variables

from test_torch_modules import perturbed_variables

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
TINY = dict(model_type="dpt_swin2_test_64", version=3, features=64)


@pytest.fixture(scope="module")
def stacks():
    jcfg = JaxModelConfig(camera=JaxCamera(**CAM), occupancy=JaxOcc(**OCC), **TINY)
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC), **TINY)
    jmodel = jax_build_model(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)), return_raw=True)
    variables = perturbed_variables(variables, 0)
    # keep inv_depth near 0.3 (the composition oracle biases the same conv;
    # the perturbed decoder here reaches |x| ~ 100, so the kernel shrinks more)
    head = variables["params"]["depth_net"]["head"]["conv3"]
    head["kernel"] = head["kernel"] * 0.002
    head["bias"] = np.full_like(head["bias"], 0.3)
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    return jcfg, cfg, variables, model, frames


@pytest.mark.parametrize("compute_occ", [False, True])
def test_serving_matches_jax(stacks, compute_occ):
    jcfg, cfg, variables, model, frames = stacks
    want = jax_make_serving_fn(jcfg, variables, compute_occ=compute_occ)(jnp.asarray(frames))
    launches = window_attention.launches, segment_sum.launches
    got = make_serving_fn(cfg, model, compute_occ=compute_occ, device="cpu")(frames)
    assert (window_attention.launches, segment_sum.launches) == launches  # CPU: plain versions

    shapes = [(2, 48, 64), (2, 3, 48, 64), (2, 48, 64, 3)]
    for g, w, shape, atol, name in zip(
        got[:3], want[:3], shapes, (1e-4, 1e-4, 5e-3), ("inv_depth", "seg", "points")
    ):
        assert tuple(g.shape) == shape, name
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=name)
    assert float(got[0].min()) > 0.1  # the band that bounds the depth amplification

    if not compute_occ:
        assert got[3] is None and want[3] is None
        return
    grid, wgrid = got[3].numpy(), np.asarray(want[3])
    assert grid.shape == (2, 16, 16, 8, 3)
    total = wgrid.sum()
    assert grid.sum() > 50.0 and total > 50.0, "degenerate fixture: the grid is empty"
    assert np.abs(grid - wgrid).sum() / total < 0.01


def test_serving_bf16_runs_close_to_f32(stacks):
    """bf16 compute on the CPU: same shapes, finite, f32 outputs, and on
    average close to f32. The bound is on the mean absolute difference
    (2e-2): bf16 keeps 8 bits, and this randomly perturbed decoder reaches
    |x| ~ 100, so single seg logits near a steep sigmoid move by more."""
    _, cfg, _, model, frames = stacks
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model16 = SOccDPT_V3(cfg16)
    model16.load_state_dict(model.state_dict())
    got = make_serving_fn(cfg16, model16, device="cpu")(frames)
    ref = make_serving_fn(cfg, model, device="cpu")(frames)
    for g, r in zip(got[:2], ref[:2]):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert float((g - r).abs().mean()) < 2e-2


@pytest.mark.parametrize("version", [1, 3])
def test_a_request_after_train_is_served_in_eval_mode(version):
    """The JAX package serves with ``deterministic=True`` on every call. A
    model put in training mode after its serving fn was bound must serve
    bit for bit what it served before, leave its BatchNorm statistics as
    they were (V1's seg decoder and every version's seg head hold them),
    and be left in training mode."""
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC),
                      **dict(TINY, version=version))
    model = build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        head = model.depth_net.head
        head.conv3.weight.mul_(0.01)
        head.conv3.bias.fill_(0.3)
    serve = make_serving_fn(cfg, model, compute_occ=True, device="cpu")
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    before = serve(frames)
    stats = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    assert len(stats) >= (8 if version == 1 else 2)
    model.train()
    after = serve(frames)
    for g, w, name in zip(after, before, ("inv_depth", "seg", "points", "grid")):
        assert torch.equal(g, w), name
    for n, b in model.named_buffers():
        if n in stats:
            assert torch.equal(b, stats[n]), n
    assert all(m.training for m in model.modules())
