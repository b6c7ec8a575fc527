"""The port's reader of reference torch checkpoints
(``soccdpt_torch/core/torch_import.py``) against the JAX package's
(``soccdpt_tpu/core/torch_import.py`` followed by ``merge_into``).

One reference-layout state dict goes through both readers: the JAX side
merges it into a fresh JAX variables tree, the port into a port model that
holds the same fresh tree (``load_jax_variables``); then every leaf of the
port model (``to_jax_variables``) must equal the JAX tree's. The state
dicts are the synthetic ones of tests/test_torch_import.py (its
``_to_torch_sd``) and, for every version and family, the inverse of the
reader that ``chip_smoke.py`` writes its checkpoints with
(``reference_state_dict``). Tolerance: exact, but for a BEiT table that the
readers resize (bilinear, ``align_corners=True``; the JAX package through
its resize matrices, the port through ``F.interpolate``): 1e-5, a few f32
ulps of the table's largest entries (about 4 in magnitude).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.core import torch_import as jti
from soccdpt_tpu.core.config import MODEL_TYPES as JAX_MODEL_TYPES
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model

from soccdpt_torch.core import torch_import as ti
from soccdpt_torch.core.config import MODEL_TYPES, ModelConfig
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.weights import load_jax_variables, to_jax_variables

from chip_smoke import reference_state_dict
from test_torch_import import TEST_CAMERA, _to_torch_sd
from test_torch_modules import perturbed_variables

TINY_TYPES = {"dpt_vittest_64": ("vittest_64", 64, 64),
              "dpt_beittest_64": ("beittest_64", 64, 64),
              "dpt_hybridtest_64": ("hybridtest_64", 64, 64),
              "dpt_swin1test_64": ("swin1test_64", 64, 64),
              "dpt_levittest_64": ("levittest_64", 64, 64),
              "dpt_nextvittest_64": ("nextvittest_64", 64, 64)}
for _name, _spec in TINY_TYPES.items():
    JAX_MODEL_TYPES.setdefault(_name, _spec)
    MODEL_TYPES.setdefault(_name, _spec)

FAMILY = {"dpt_swin2_test_64": "swin", "dpt_vittest_64": "vit", "dpt_beittest_64": "vit",
          "dpt_hybridtest_64": "hybrid", "dpt_swin1test_64": "swin",
          "dpt_levittest_64": "levit", "dpt_nextvittest_64": "next_vit"}


def _variables(model_type, version, seed):
    cfg = JaxModelConfig(model_type=model_type, version=version, features=32)
    v = jax_build_model(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 3, 64, 64)),
                                  return_raw=True)
    return perturbed_variables(v, seed)


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = np.asarray(v)
    return out


def check_port_against_jax(model_type, version, sd, jax_import, port_import, atol=0.0):
    fresh = _variables(model_type, version, seed=9)
    jp, js = jax_import(sd)
    want = {"params": jti.merge_into(fresh["params"], jp, verbose=False),
            "batch_stats": jti.merge_into(fresh.get("batch_stats", {}), js, verbose=False)}
    cfg = ModelConfig(model_type=model_type, version=version, features=32)
    port = load_jax_variables(build_model(cfg, device="cpu"), fresh)
    pp, ps = port_import(sd)
    reports = ti.load_imported(port, pp, ps, verbose=False)
    got = to_jax_variables(port)
    for coll in ("params", "batch_stats"):
        g, w = _flat(got[coll]), _flat(want[coll])
        assert set(g) == set(w), coll
        for path in w:
            np.testing.assert_allclose(g[path], w[path], rtol=0, atol=atol,
                                       err_msg=f"{coll}:{'/'.join(path)}")
    return reports, fresh


def test_v3_swin_keys_of_the_jax_tests():
    """tests/test_torch_import.py's own synthetic V3 state dict."""
    cfg = JaxModelConfig(model_type="dpt_swin2_test_64", version=3, features=64,
                         camera=TEST_CAMERA)
    v = jax_build_model(cfg).init(jax.random.PRNGKey(7), jnp.zeros((1, 3, 64, 64)),
                                  return_raw=True)
    v = jax.device_get(v)
    sd = _to_torch_sd(v["params"], v["batch_stats"])
    fresh = perturbed_variables(jax_build_model(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 3, 64, 64)), return_raw=True), 1)
    jp, js = jti.import_soccdpt_v3(sd)
    want = {"params": jti.merge_into(fresh["params"], jp, verbose=False),
            "batch_stats": jti.merge_into(fresh["batch_stats"], js, verbose=False)}
    port = build_model(ModelConfig(model_type="dpt_swin2_test_64", version=3, features=64),
                       device="cpu")
    load_jax_variables(port, fresh)
    reports = ti.load_imported(port, *ti.import_soccdpt_v3(sd), verbose=False)
    got = to_jax_variables(port)
    for coll in ("params", "batch_stats"):
        g, w = _flat(got[coll]), _flat(want[coll])
        assert set(g) == set(w)
        for path in w:
            np.testing.assert_array_equal(g[path], w[path], err_msg="/".join(path))
        # every leaf came from the file: the fresh tree differs everywhere
        assert reports[coll]["loaded"] == reports[coll]["total"] == len(w)
        assert not reports[coll]["unused"] and not reports[coll]["mismatched"]


@pytest.mark.parametrize("model_type,version", [
    ("dpt_swin2_test_64", 1), ("dpt_swin2_test_64", 2), ("dpt_swin2_test_64", 3),
    ("dpt_vittest_64", 3), ("dpt_hybridtest_64", 3),
    ("dpt_swin1test_64", 1), ("dpt_swin1test_64", 2), ("dpt_swin1test_64", 3),
    ("dpt_levittest_64", 1), ("dpt_levittest_64", 2), ("dpt_levittest_64", 3),
    ("dpt_nextvittest_64", 1), ("dpt_nextvittest_64", 2), ("dpt_nextvittest_64", 3),
])
def test_every_leaf_lands_as_in_jax(model_type, version):
    """A state dict written from a whole JAX tree (V1's two DPTs, V2's
    trunk and heads under the reference's ``seg_ead`` spelling, V3) lands
    every leaf, as the JAX reader does. The hybrid's ViT patch-embed keys
    are claimed twice by the JAX converters (``patch_embed`` and
    ``patch_embed_proj``): both readers report the first two unused.
    Swin-V1 keys (a full qkv bias, ``relative_position_bias_table``) go
    through the Swin converter; LeViT's carry ``scratch.stem_transpose`` and
    its flat ``blocks`` numbered as the readers number them by default (the
    stage depths of ``levit_384``, of which the test model's are a prefix);
    Next-ViT's carry the official module names."""
    family = FAMILY[model_type]
    source = _variables(model_type, version, seed=0)
    sd = reference_state_dict(source, version, family)
    reports, fresh = check_port_against_jax(
        model_type, version, sd,
        lambda s: jti.import_soccdpt(s, version, family),
        lambda s: ti.import_soccdpt(s, version, family))
    unused = 2 if family == "hybrid" else 0
    for coll in ("params", "batch_stats"):
        r = reports[coll]
        assert r["loaded"] == r["total"] == len(_flat(fresh.get(coll, {}))), coll
        assert len(r["unused"]) == (unused if coll == "params" else 0), r["unused"]
        assert not r["mismatched"]


def test_beit_tables_resized_and_kept_on_a_mismatch():
    """BEiT: tables written for a 6x6 grid. Through ``convert_vit_dpt_keys``
    with the model's 8x8 grid they are resized and land (1e-5); through
    ``import_soccdpt``, which resizes to the 24x24 grid of the 384 models,
    the shapes do not fit and every block keeps its own table, on both
    sides (the reference's ``strict=False``)."""
    source = _variables("dpt_beittest_64", 3, seed=0)
    sd = reference_state_dict(source, 3, "vit")
    rng = np.random.default_rng(4)
    tables = [k for k in sd if k.endswith("relative_position_bias_table")]
    assert len(tables) == 4
    for k in tables:
        sd[k] = rng.standard_normal((11 * 11 + 3, sd[k].shape[1])).astype(np.float32)

    def reader(module):
        def run(s):
            p, st = module.convert_vit_dpt_keys(s, "depth_net.", "vit", (8, 8))
            hp, hs = module.convert_seg_head_keys(s)
            flat_p = {("depth_net",) + k: v for k, v in p.items()}
            flat_p.update({("seg_head",) + k: v for k, v in hp.items()})
            flat_s = {("depth_net",) + k: v for k, v in st.items()}
            flat_s.update({("seg_head",) + k: v for k, v in hs.items()})
            return module._nest(flat_p), module._nest(flat_s)
        return run

    reports, _ = check_port_against_jax("dpt_beittest_64", 3, sd, reader(jti), reader(ti),
                                        atol=1e-5)
    assert not reports["params"]["mismatched"] and not reports["params"]["unused"]

    reports, fresh = check_port_against_jax(
        "dpt_beittest_64", 3, sd, lambda s: jti.import_soccdpt(s, 3, "vit"),
        lambda s: ti.import_soccdpt(s, 3, "vit"))
    mism = reports["params"]["mismatched"]
    assert sorted(p[-2] for p, _, _ in mism) == [f"block{i}" for i in range(4)]
    assert all(src == (47 * 47 + 3, 2) and tgt == (15 * 15 + 3, 2) for _, src, tgt in mism)


def test_merge_keeps_a_mismatch_and_reports_as_jax(capsys):
    target = {"a": {"kernel": np.zeros((2, 2), np.float32), "bias": np.zeros(2, np.float32)}}
    imported = {"a": {"kernel": np.ones((3, 3), np.float32), "bias": np.ones(2, np.float32)},
                "b": {"kernel": np.ones(1, np.float32)}}
    want = jti.merge_into(target, imported)
    want_out = capsys.readouterr().out
    got = ti.merge_into(target, imported)
    assert capsys.readouterr().out == want_out
    # a mismatched key counts among the unused ones too
    assert "loaded 1/2 leaves; 2 unused imported keys; 1 shape mismatches" in want_out
    np.testing.assert_array_equal(got["a"]["kernel"], np.zeros((2, 2)))
    np.testing.assert_array_equal(got["a"]["bias"], want["a"]["bias"])
    _, report = ti.merge_report(target, imported)
    assert report["unused"] == [("a", "kernel"), ("b", "kernel")]
    assert report["mismatched"] == [(("a", "kernel"), (3, 3), (2, 2))]


@pytest.mark.parametrize("wrap", ["raw", "optimizer", "state_dict"])
def test_load_torch_state_dict_unwraps_as_jax(tmp_path, wrap):
    sd = {"a.weight": torch.randn(3, 2), "a.bias": torch.randn(3),
          "idx": torch.arange(4)}
    obj = {"raw": sd, "optimizer": {"model": sd, "optimizer": {"lr": 1e-3}},
           "state_dict": {"state_dict": sd, "epoch": 3}}[wrap]
    path = str(tmp_path / "ckpt.pth")
    torch.save(obj, path)
    got, want = ti.load_torch_state_dict(path), jti.load_torch_state_dict(path)
    assert set(got) == set(want) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("family", ["levit", "next_vit"])
def test_unported_families_raise(family):
    """Every family of the JAX package is read now: an empty state dict
    converts to empty trees, as in JAX, and only an unknown family raises."""
    assert ti.convert_backbone_dpt_keys({}, family=family) == ({}, {})
    assert jti.convert_backbone_dpt_keys({}, family=family) == ({}, {})
    with pytest.raises(ValueError, match="unknown importer family"):
        ti.convert_backbone_dpt_keys({}, family="resnext")
    assert ti.family_of("levit_384") == jti.family_of("levit_384") == "levit"
    assert ti.family_of("next_vit_large_6m") == jti.family_of("next_vit_large_6m") == "next_vit"
    assert ti.family_of("swinl12_384") == jti.family_of("swinl12_384") == "swin"
    assert ti.family_of("vitb_rn50_384") == jti.family_of("vitb_rn50_384") == "hybrid"


def test_levit_blocks_by_the_stage_depths():
    """LeViT's reference keys number the flat ``blocks`` by the model's own
    stage depths: renumbered as timm numbers ``levittest_64``'s (2, 2, 2),
    both readers, given those depths, land every leaf."""
    source = _variables("dpt_levittest_64", 3, seed=0)
    sd = reference_state_dict(source, 3, "levit")
    default = {name: n for n, (name, _) in ti._levit_block_names((4, 4, 4)).items()}
    own = {name: n for n, (name, _) in ti._levit_block_names((2, 2, 2)).items()}
    assert ti._levit_block_names((2, 2, 2)) == jti._levit_block_names((2, 2, 2))
    renumber = {default[name]: own[name] for name in own}
    moved = {}
    for key, val in sd.items():
        m = re.match(r"(.*pretrained\.model\.blocks\.)(\d+)(\..*)$", key)
        moved[key if not m else f"{m.group(1)}{renumber[int(m.group(2))]}{m.group(3)}"] = val
    assert len(moved) == len(sd) and moved != sd

    def reader(module):
        def run(s):
            p, st = module.convert_levit_dpt_keys(s, "depth_net.", (2, 2, 2))
            hp, hs = module.convert_seg_head_keys(s)
            flat_p = {("depth_net",) + k: v for k, v in p.items()}
            flat_p.update({("seg_head",) + k: v for k, v in hp.items()})
            flat_s = {("depth_net",) + k: v for k, v in st.items()}
            flat_s.update({("seg_head",) + k: v for k, v in hs.items()})
            return module._nest(flat_p), module._nest(flat_s)
        return run

    reports, fresh = check_port_against_jax("dpt_levittest_64", 3, moved, reader(jti), reader(ti))
    for coll in ("params", "batch_stats"):
        r = reports[coll]
        assert r["loaded"] == r["total"] == len(_flat(fresh.get(coll, {}))), coll
        assert not r["unused"] and not r["mismatched"]
