"""The timing CLIs and helpers of the port, on the CPU, held to the JAX
package's: ``cli/eval_timing.py`` (row keys, parameter counts),
``cli/eval_patchwise.py`` (patches of a step), ``cli/bench.py`` (its JSON
line), and ``utils/timing.py`` / ``utils/fake_init.py``.

Times taken here are the CPU's, never a device's: these tests check what
the tools compute and count, not how fast anything runs.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.cli.eval_patchwise import measure_step_memory as jax_measure_step_memory
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model

from soccdpt_torch.cli import bench, eval_patchwise, eval_timing
from soccdpt_torch.core.config import ModelConfig
from soccdpt_torch.models.soccdpt import SOccDPT_V3
from soccdpt_torch.utils.fake_init import structural_init
from soccdpt_torch.utils.timing import measure_forward_hz

TINY = "dpt_swin2_test_64"
JAX_ROW_KEYS = {"model_type", "params_M", "hz", "ms_per_forward", "batch", "contract"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "hz_std", "ms_per_forward",
              "ms_std", "raw_net_hz", "raw_net_ms", "device"}


def jax_param_count(version):
    """The JAX CLI's count: the leaves of ``variables["params"]``."""
    cfg = JaxModelConfig(model_type=TINY, version=version, compute_dtype="bfloat16")
    model = jax_build_model(cfg)
    shapes = jax.eval_shape(
        lambda rng: model.init(rng, jnp.zeros((1, 3, 64, 64)), deterministic=True,
                               return_raw=True),
        jax.random.PRNGKey(0))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("version,contract", [(3, "raw"), (3, "full"), (3, "occ"), (1, "raw"),
                                              (2, "raw")])
def test_eval_timing_rows_carry_the_jax_keys_and_parameter_count(version, contract, capsys):
    rows = eval_timing.main(["-t", TINY, "-v", str(version), "--contract", contract, "--json",
                             "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows and len(rows) == 1
    row = rows[0]
    assert JAX_ROW_KEYS <= set(row)
    assert row["model_type"] == TINY and row["contract"] == contract and row["batch"] == 1
    assert row["device"] == "cpu"
    assert row["hz"] > 0 and row["ms_per_forward"] > 0
    assert row["params_M"] == round(jax_param_count(version) / 1e6, 2)


def test_eval_timing_help_says_use_pallas_has_no_counterpart(capsys):
    with pytest.raises(SystemExit):
        eval_timing.main(["--help"])
    assert "--use_pallas has no counterpart" in " ".join(capsys.readouterr().out.split())


@pytest.fixture(scope="module")
def jax_patchwise_half():
    return jax_measure_step_memory(TINY, 3, batch_size=1, patchwise_pct=0.5, encoder_pct=0.5,
                                   gt_hw=(48, 64))


def test_measure_step_memory_patches_match_jax(jax_patchwise_half):
    got = eval_patchwise.measure_step_memory(TINY, 3, batch_size=1, patchwise_pct=0.5,
                                             encoder_pct=0.5, gt_hw=(48, 64), device="cpu")
    assert got == {"n_patches": jax_patchwise_half["n_patches"]}
    assert got["n_patches"] == 2


@pytest.mark.parametrize("patchwise_pct,n_patches", [(1.0, 1), (0.25, 4)])
def test_measure_step_memory_counts_patches(patchwise_pct, n_patches):
    """As tests/test_cli.py holds the JAX function (one patch at 1.0);
    the CPU reports no memory, which is not measured there."""
    got = eval_patchwise.measure_step_memory(TINY, 3, batch_size=1, patchwise_pct=patchwise_pct,
                                             encoder_pct=1.0, gt_hw=(48, 64), device="cpu")
    assert got == {"n_patches": n_patches}


def test_eval_patchwise_sweep_prints_a_row_per_configuration(capsys):
    eval_patchwise.main(["-t", TINY, "--batch_sizes", "1", "--patchwise", "1.0", "0.5",
                         "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows == [{"batch_size": 1, "patchwise_pct": 1.0, "n_patches": 1},
                    {"batch_size": 1, "patchwise_pct": 0.5, "n_patches": 2}]


def test_eval_patchwise_reports_a_failing_configuration_as_an_error_row(capsys):
    eval_patchwise.main(["-t", TINY, "-v", "7", "--batch_sizes", "1", "--patchwise", "1.0",
                         "--device", "cpu"])
    (row,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert row["batch_size"] == 1 and row["patchwise_pct"] == 1.0
    assert row["error"].startswith("ValueError")


def test_bench_prints_one_json_line_with_the_keys(capsys):
    cfg = ModelConfig(model_type=TINY, version=3, compute_dtype="bfloat16")
    row = bench.bench(cfg, batch=1, n_iters=3, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == row
    assert BENCH_KEYS <= set(row)
    assert row["metric"] == "inference_hz_per_chip_swin2_tiny_256_full_contract"
    assert row["unit"] == "frames/s" and row["batch"] == 1 and row["device"] == "cpu"
    assert row["value"] > 0 and row["raw_net_hz"] > 0
    assert row["vs_baseline"] == round(row["value"] / 47.0, 2)


def test_measure_forward_hz_counts_calls_and_frames():
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.001)
        return x

    hz, seconds = measure_forward_hz(fn, torch.zeros(3), batch=4, n_iters=5, repeats=2)
    assert len(calls) == 2 + 5 * 2  # two warm-up calls, then the repeats
    assert seconds >= 0.001 and hz == pytest.approx(4 / seconds)
    with pytest.raises(ValueError):
        measure_forward_hz(fn, torch.zeros(3), batch=1, n_iters=0)


def test_structural_init_fills_every_parameter_from_seed_0():
    cfg = ModelConfig(model_type=TINY, version=3)
    a, b = structural_init(SOccDPT_V3(cfg)), structural_init(SOccDPT_V3(cfg))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    rng = np.random.default_rng(0)
    name, first = next(iter(a.named_parameters()))
    want = rng.standard_normal(tuple(first.shape), dtype=np.float32) * np.float32(0.02)
    np.testing.assert_array_equal(first.detach().numpy(), want)
    flat = torch.cat([p.detach().reshape(-1) for p in a.parameters()])
    assert abs(float(flat.std()) - 0.02) < 1e-3 and abs(float(flat.mean())) < 1e-3


def test_the_timing_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(model_type=TINY, version=3, compute_dtype="bfloat16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_timing.main(["-t", TINY])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_patchwise.main(["-t", TINY, "--batch_sizes", "1", "--patchwise", "1.0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.bench(cfg, n_iters=1)
