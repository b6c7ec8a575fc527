"""The deployment path of the port against the JAX package's, on the CPU:
``soccdpt_torch.cli.export`` (a ``torch.export`` program) and
``soccdpt_torch.cli.run_exported``, against ``soccdpt_tpu.cli.export``
(serialized StableHLO) of the same reference-layout ``.pth``; and the
``soccdpt::`` custom ops (K1, K6, the decoder's upsample) that the
program calls.

The ``.pth`` is written by ``chip_smoke.reference_state_dict`` from a
port model drawn from a numpy seed, its depth head's last conv scaled as
the served phases of chip_smoke.py scale it (so inverse depth sits in a
band where depth = 1/inv, and so the points, are well conditioned). Both
packages export in bf16, as the JAX CLI does (``soccdpt_tpu/cli/export.py:35-37``),
and run on one seeded input.

Tolerance, port against JAX: each output's error is at most
``BF16_REL_L2`` = 2^-5 of its L2 norm and at most ``BF16_MAX`` = 2^-4 of
its largest magnitude. bf16 keeps 8 bits of mantissa (a step of 2^-8 of
the value); two stacks that round in different places through a trunk, a
decoder and two heads drift apart by a few steps (measured: 0.3 % of the
norm for inverse depth and points, 1.1 % for the segmentation), so the
bound is eight steps of the norm and sixteen of the largest value. The
port's program against the port's eager model: bit for bit.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jax_export
from torch.library import opcheck

from soccdpt_tpu.cli.export import export_model as jax_export_model

from soccdpt_torch.cli.export import export_model
from soccdpt_torch.cli.run_exported import load_program
from soccdpt_torch.cli.train import load_weights
from soccdpt_torch.core.config import ModelConfig
from soccdpt_torch.kernels import ops
from soccdpt_torch.kernels.global_attention import global_attention_plain
from soccdpt_torch.kernels.window_attention import window_attention_plain
from soccdpt_torch.models.bias_cache import build_inference_cache
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.weights import to_jax_variables

from chip_smoke import reference_state_dict

REPO = Path(__file__).resolve().parents[1]
MODEL = "dpt_swin2_test_64"
BLOCKS = 8  # swin2test_64: depths (2, 2, 2, 2)
BF16_REL_L2, BF16_MAX = 2.0**-5, 2.0**-4


def _input(batch, seed=0):
    return np.random.default_rng(seed).standard_normal((batch, 3, 64, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    source = build_model(ModelConfig(model_type=MODEL), device="cpu", seed=3)
    with torch.no_grad():
        source.depth_net.head.conv3.weight.mul_(0.01)
        source.depth_net.head.conv3.bias.fill_(0.3)
    sd = reference_state_dict(to_jax_variables(source), 3, "swin")
    path = str(tmp_path_factory.mktemp("pth") / "ref.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


@pytest.fixture(scope="module")
def programs(pth, tmp_path_factory):
    """{with_points: (the port's program, the JAX package's artifact)},
    both with a dynamic batch."""
    out = tmp_path_factory.mktemp("exports")
    return {
        wp: (export_model(MODEL, 3, str(out / f"p{wp}.pt2"), load=pth, with_points=wp,
                          device="cpu"),
             jax_export_model(MODEL, 3, str(out / f"j{wp}.stablehlo"), load=pth,
                              with_points=wp))
        for wp in (False, True)
    }


def _eager(pth):
    model = build_model(ModelConfig(model_type=MODEL, compute_dtype="bfloat16"), device="cpu")
    load_weights(model, pth, 3)
    return build_inference_cache(model.eval())


@pytest.mark.parametrize("with_points", [False, True], ids=["raw", "with_points"])
def test_exported_program_matches_jax_s_export(programs, with_points):
    port_path, jax_path = programs[with_points]
    x = _input(2)
    with open(jax_path, "rb") as fh:
        want = jax_export.deserialize(fh.read()).call(jnp.asarray(x))
    with torch.no_grad():
        got = load_program(port_path, torch.device("cpu"))(torch.from_numpy(x))
    assert len(got) == len(want) == (3 if with_points else 2)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        assert np.linalg.norm(g - w) <= BF16_REL_L2 * np.linalg.norm(w)
        assert np.abs(g - w).max() <= BF16_MAX * np.abs(w).max()


@pytest.mark.parametrize("with_points", [False, True], ids=["raw", "with_points"])
def test_one_program_serves_batch_1_and_2_as_the_eager_model(programs, pth, with_points):
    program = load_program(programs[with_points][0], torch.device("cpu"))
    model = _eager(pth)
    for batch in (1, 2):
        x = torch.from_numpy(_input(batch, seed=batch))
        with torch.no_grad():
            got = program(x)
            want = (model(x, compute_occ=False)[:3] if with_points
                    else model(x, return_raw=True))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[0].shape[0] == batch and got[0].dtype == want[0].dtype


def test_the_program_calls_the_window_attention_op(programs):
    """Every Swin-V2 block's attention is one ``soccdpt::window_attention``
    node, not inlined math, and K6's op is on no node of a Swin model."""
    program = torch.export.load(programs[False][0])
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("soccdpt.window_attention.default") == BLOCKS
    assert not any("global_attention" in t or "softmax" in t for t in targets)


def test_the_program_calls_the_upsample_op(programs):
    """The decoder's four refinenets and both heads upsample through one
    ``soccdpt::upsample2x`` node each, none through aten's bilinear
    upsample: the program launches the kernel where it runs on the card."""
    program = torch.export.load(programs[False][0])
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("soccdpt.upsample2x.default") == 6
    assert not any("upsample_bilinear2d" in t for t in targets)


def test_a_fixed_batch_program_takes_that_batch_only(pth, tmp_path):
    path = export_model(MODEL, 3, str(tmp_path / "b1.pt2"), load=pth, batch=1, device="cpu")
    program = load_program(path, torch.device("cpu"))
    with torch.no_grad():
        assert tuple(program(torch.from_numpy(_input(1)))[0].shape) == (1, 64, 64)
        with pytest.raises(Exception):
            program(torch.from_numpy(_input(2)))


def test_run_exported_in_a_fresh_process(programs, tmp_path):
    """``python -m soccdpt_torch.cli.run_exported`` on the CPU: the shapes
    line, the kernels launched (none on the CPU: the plain versions run),
    the panel and the frames/s line; and the process imports no model
    code."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    png = tmp_path / "panel.png"
    cmd = [sys.executable, "-m", "soccdpt_torch.cli.run_exported", "-m", programs[False][0],
           "--batch", "2", "--size", "64", "--iters", "2", "--device", "cpu", "--vis", str(png)]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp_path,
                         timeout=300).stdout.splitlines()
    assert "outputs: (2, 64, 64) (2, 3, 64, 64)" in out
    assert ("kernel launches in one forward: window_attention 0, global_attention 0, "
            "upsample2x 0, unproject_slots 0") in out
    assert f"saved {png}" in out and png.stat().st_size > 0
    assert out[-1].endswith("ms/forward)") and " Hz (" in out[-1]
    probe = ("import sys; from soccdpt_torch.cli import run_exported; "
             f"run_exported.main(['-m', {programs[False][0]!r}, '--batch', '1', '--size', '64', "
             "'--iters', '1', '--device', 'cpu']); "
             "print(sorted(m for m in sys.modules if m.startswith('soccdpt_torch.')))")
    done = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=300)
    modules = ast.literal_eval(done.stdout.splitlines()[-1])
    assert "soccdpt_torch.kernels.ops" in modules
    assert not [m for m in modules if m.startswith(("soccdpt_torch.models", "soccdpt_torch.ops"))]


# --- the custom ops -----------------------------------------------------------


def _k1_args(dtype, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    Bw, H, N, d = 4, 2, 16, 16
    q, k, v = (torch.randn(Bw, H, N, d, generator=g).to(dtype) for _ in range(3))
    mask = torch.randn(2, N, N, generator=g) if masked else None
    return q, k, v, torch.rand(H, 1, 1, generator=g) + 1.0, torch.randn(H, N, N, generator=g), mask


def _k6_args(dtype, biased, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, 2, 24, 16, generator=g).to(dtype) for _ in range(3))
    return q, k, v, torch.randn(2, 24, 24, generator=g) if biased else None, 0.25


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_window_attention_op_passes_opcheck_and_is_the_plain_version(dtype, masked):
    args = _k1_args(dtype, masked)
    opcheck(torch.ops.soccdpt.window_attention.default, args)
    out = torch.ops.soccdpt.window_attention(*args)
    assert torch.equal(out, window_attention_plain(*args))
    with torch.device("meta"):
        fake = torch.ops.soccdpt.window_attention(*(a.to("meta") if a is not None else None
                                                    for a in args))
    assert fake.shape == out.shape and fake.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("biased", [False, True], ids=["nobias", "bias"])
def test_global_attention_ops_pass_opcheck_and_are_the_plain_version(dtype, biased):
    args = _k6_args(dtype, biased)
    opcheck(torch.ops.soccdpt.global_attention.default, args)
    opcheck(torch.ops.soccdpt.global_attention_with_lse.default, args)
    out = torch.ops.soccdpt.global_attention(*args)
    assert torch.equal(out, global_attention_plain(*args))
    out2, lse = torch.ops.soccdpt.global_attention_with_lse(*args)
    assert torch.equal(out2, out) and lse.shape == (2, 2, 24) and lse.dtype == torch.float32


def test_ops_module_registers_every_op_and_counts_launches():
    for op in ("window_attention", "global_attention", "global_attention_with_lse",
               "upsample2x", "unproject_slots"):
        assert hasattr(torch.ops.soccdpt, op)
    before = ops.launches()
    torch.ops.soccdpt.window_attention(*_k1_args(torch.float32, False))
    assert ops.launches() == before  # the CPU runs the plain version: no launch
