"""Reference torch checkpoints into the port: the reader of the
reference's ``.pth`` keys (the port of ``soccdpt_tpu/core/torch_import.py``).

The reference saves raw ``state_dict`` files (train_SOccDPT.py:437-449)
and loads with ``strict=False`` + optimizer-dict unwrap
(base_model.py:5-37). The converters here map those key layouts onto the
JAX package's flax paths and layouts, as the JAX module does, for the
families of the JAX package: Swin-V2 (and the Swin-V1 keys it shares),
ViT/BEiT, the ViT-hybrid, LeViT (with the DPT's ``scratch.stem_transpose``)
and Next-ViT. ``load_imported`` then merges the result into a
port model leniently (``merge_into``'s ``strict=False`` semantics) and
lands it through ``weights.to_jax_variables`` and
``weights.load_jax_variables``, which map flax paths onto the port's
submodules by name; batch statistics become the BatchNorm buffers.

Weight-layout conventions (torch -> flax):
  conv   (O, I, kh, kw)  -> (kh, kw, I, O)
  dense  (out, in)       -> (in, out)
  norm   weight/bias     -> scale/bias
  bn     running_mean/var -> batch_stats mean/var

numpy and torch only: no JAX.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """``torch.load`` onto the CPU with the optimizer unwrap (reference
    base_model.py:14-21): a ``{"model", "optimizer"}`` checkpoint gives its
    model, a ``{"state_dict"}`` one its state dict. Tensors come back as
    numpy arrays (floating ones in f32); entries that are not tensors are
    left out. Only tensors and plain containers are unpickled."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "optimizer" in ckpt and "model" in ckpt:
        ckpt = ckpt["model"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {
        k: (v.detach().float() if v.is_floating_point() else v.detach()).numpy()
        for k, v in ckpt.items() if isinstance(v, torch.Tensor)
    }


def _conv(w):
    return np.transpose(w, (2, 3, 1, 0))


def _dense(w):
    return np.transpose(w, (1, 0))


def _id(w):
    return np.asarray(w)


def convert_swin2_dpt_keys(
    sd: Dict[str, np.ndarray],
    torch_prefix: str = "",
) -> Tuple[Dict[Tuple[str, ...], np.ndarray], Dict[Tuple[str, ...], np.ndarray]]:
    """Convert one torch DPT-with-Swin2 tree to (params, batch_stats)
    keyed by flax path tuples relative to the DPT module root."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}

    def put(path, val):
        params[tuple(path)] = val

    for key, val in sd.items():
        if torch_prefix:
            if not key.startswith(torch_prefix):
                continue
            key = key[len(torch_prefix):]

        # ---- backbone: pretrained.model.* (timm SwinTransformerV2) ----
        m = re.match(r"pretrained\.model\.(.*)$", key)
        if m:
            sub = m.group(1)
            bb = ("backbone",)
            if sub == "patch_embed.proj.weight":
                put(bb + ("patch_embed", "kernel"), _conv(val))
            elif sub == "patch_embed.proj.bias":
                put(bb + ("patch_embed", "bias"), _id(val))
            elif sub == "patch_embed.norm.weight":
                put(bb + ("patch_norm", "scale"), _id(val))
            elif sub == "patch_embed.norm.bias":
                put(bb + ("patch_norm", "bias"), _id(val))
            else:
                b = re.match(r"layers\.(\d+)\.blocks\.(\d+)\.(.*)$", sub)
                d = re.match(r"layers\.(\d+)\.downsample\.(.*)$", sub)
                if b:
                    i, j, rest = int(b.group(1)), int(b.group(2)), b.group(3)
                    blk = bb + (f"stage{i}_block{j}",)
                    table = {
                        "attn.qkv.weight": (blk + ("attn", "qkv", "kernel"), _dense),
                        # Swin v1 (swinl12_384): full qkv bias + learned
                        # rel-pos table instead of v2's q/v bias + CPB MLP
                        "attn.qkv.bias": (blk + ("attn", "qkv", "bias"), _id),
                        "attn.relative_position_bias_table": (
                            blk + ("attn", "rel_pos_table"), _id),
                        "attn.q_bias": (blk + ("attn", "q_bias"), _id),
                        "attn.v_bias": (blk + ("attn", "v_bias"), _id),
                        "attn.logit_scale": (blk + ("attn", "logit_scale"), _id),
                        "attn.proj.weight": (blk + ("attn", "proj", "kernel"), _dense),
                        "attn.proj.bias": (blk + ("attn", "proj", "bias"), _id),
                        "attn.cpb_mlp.0.weight": (
                            blk + ("attn", "cpb_mlp_0", "kernel"), _dense),
                        "attn.cpb_mlp.0.bias": (
                            blk + ("attn", "cpb_mlp_0", "bias"), _id),
                        "attn.cpb_mlp.2.weight": (
                            blk + ("attn", "cpb_mlp_1", "kernel"), _dense),
                        "norm1.weight": (blk + ("norm1", "scale"), _id),
                        "norm1.bias": (blk + ("norm1", "bias"), _id),
                        "norm2.weight": (blk + ("norm2", "scale"), _id),
                        "norm2.bias": (blk + ("norm2", "bias"), _id),
                        "mlp.fc1.weight": (blk + ("mlp_fc1", "kernel"), _dense),
                        "mlp.fc1.bias": (blk + ("mlp_fc1", "bias"), _id),
                        "mlp.fc2.weight": (blk + ("mlp_fc2", "kernel"), _dense),
                        "mlp.fc2.bias": (blk + ("mlp_fc2", "bias"), _id),
                    }
                    if rest in table:
                        path, fn = table[rest]
                        put(path, fn(val))
                    # relative_position_index / relative_coords_table are
                    # static buffers — recomputed, not imported.
                elif d:
                    i, rest = int(d.group(1)), d.group(2)
                    ds = bb + (f"downsample{i}",)
                    if rest == "reduction.weight":
                        put(ds + ("reduction", "kernel"), _dense(val))
                    elif rest == "norm.weight":
                        put(ds + ("norm", "scale"), _id(val))
                    elif rest == "norm.bias":
                        put(ds + ("norm", "bias"), _id(val))
            continue

        # ---- scratch reassemble + refinenets ----
        m = re.match(r"scratch\.layer(\d)_rn\.weight$", key)
        if m:
            put((f"layer{m.group(1)}_rn", "kernel"), _conv(val))
            continue
        m = re.match(
            r"scratch\.refinenet(\d)\.resConfUnit(\d)\.conv(\d)\.(weight|bias)$",
            key,
        )
        if m:
            rn, rcu, conv, wb = m.groups()
            path = (
                f"refinenet{rn}",
                f"res_conv_unit{rcu}",
                f"conv{conv}",
                "kernel" if wb == "weight" else "bias",
            )
            put(path, _conv(val) if wb == "weight" else _id(val))
            continue
        # RCU BatchNorm (bn=True decoders, e.g. DPTSegmentationModel's
        # use_bn=True refinenets — reference blocks.py:383-385, dpt.py:240)
        m = re.match(
            r"scratch\.refinenet(\d)\.resConfUnit(\d)\.bn(\d)\."
            r"(weight|bias|running_mean|running_var)$",
            key,
        )
        if m:
            rn, rcu, bn, leaf = m.groups()
            base = (f"refinenet{rn}", f"res_conv_unit{rcu}", f"bn{bn}")
            _bn_leaf(base, leaf, val, params, stats)
            continue
        m = re.match(r"scratch\.refinenet(\d)\.out_conv\.(weight|bias)$", key)
        if m:
            rn, wb = m.groups()
            put(
                (f"refinenet{rn}", "out_conv", "kernel" if wb == "weight" else "bias"),
                _conv(val) if wb == "weight" else _id(val),
            )
            continue

        # ---- depth head: scratch.output_conv.{0,2,4} (dpt.py:199-219) ----
        m = re.match(r"scratch\.output_conv\.(\d)\.(weight|bias)$", key)
        if m:
            idx, wb = int(m.group(1)), m.group(2)
            conv_name = {0: "conv1", 2: "conv2", 4: "conv3"}.get(idx)
            if conv_name:
                put(
                    ("head", conv_name, "kernel" if wb == "weight" else "bias"),
                    _conv(val) if wb == "weight" else _id(val),
                )
            continue

    return params, stats


def convert_seg_head_keys(
    sd: Dict[str, np.ndarray], torch_prefix: str = "seg_head."
) -> Tuple[Dict[Tuple[str, ...], np.ndarray], Dict[Tuple[str, ...], np.ndarray]]:
    """V2/V3 seg-head nn.Sequential (reference SOccDPT.py:660-674):
    0=conv3x3(no bias), 1=BN, 4=conv1x1."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}
    for key, val in sd.items():
        if not key.startswith(torch_prefix):
            continue
        sub = key[len(torch_prefix):]
        if sub == "0.weight":
            params[("conv1", "kernel")] = _conv(val)
        elif sub == "1.weight":
            params[("bn", "scale")] = _id(val)
        elif sub == "1.bias":
            params[("bn", "bias")] = _id(val)
        elif sub == "1.running_mean":
            stats[("bn", "mean")] = _id(val)
        elif sub == "1.running_var":
            stats[("bn", "var")] = _id(val)
        elif sub == "4.weight":
            params[("conv2", "kernel")] = _conv(val)
        elif sub == "4.bias":
            params[("conv2", "bias")] = _id(val)
    return params, stats


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    out: Dict = {}
    for path, val in flat.items():
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = val
    return out


def family_of(backbone: str) -> str:
    """Backbone name (reference encoder names, blocks.py:31-136) ->
    importer family key."""
    if "rn50" in backbone or "hybrid" in backbone:
        return "hybrid"
    if backbone.startswith(("vit", "beit")):
        return "vit"
    if backbone.startswith("levit"):
        return "levit"
    if "next_vit" in backbone or backbone.startswith("nextvit"):
        return "next_vit"
    return "swin"  # swin v1 and v2 share a converter


def convert_backbone_dpt_keys(
    sd: Dict[str, np.ndarray],
    torch_prefix: str = "",
    family: str = "swin",
    grid_hw: Tuple[int, int] = (24, 24),
    depths: Tuple[int, ...] = (4, 4, 4),
) -> Tuple[Dict[Tuple[str, ...], np.ndarray], Dict[Tuple[str, ...], np.ndarray]]:
    """Family-dispatching DPT converter (reference loader.py:37-124
    dispatches 11 model types; each family has its own timm layout).
    ``depths`` are LeViT's stage depths, which number its flat blocks."""
    if family == "swin":
        return convert_swin2_dpt_keys(sd, torch_prefix)
    if family == "vit":
        return convert_vit_dpt_keys(sd, torch_prefix, "vit", grid_hw)
    if family == "hybrid":
        return convert_hybrid_dpt_keys(sd, torch_prefix, grid_hw)
    if family == "levit":
        return convert_levit_dpt_keys(sd, torch_prefix, depths)
    if family == "next_vit":
        return convert_next_vit_dpt_keys(sd, torch_prefix)
    raise ValueError(f"unknown importer family {family!r}")


def import_soccdpt_v3(
    sd: Dict[str, np.ndarray], family: str = "swin"
) -> Tuple[Dict, Dict]:
    """Full SOccDPT_V3 checkpoint -> (params, batch_stats) nested dicts
    matching models.soccdpt.SOccDPT_V3's tree."""
    dpt_p, dpt_s = convert_backbone_dpt_keys(
        sd, torch_prefix="depth_net.", family=family
    )
    seg_p, seg_s = convert_seg_head_keys(sd, torch_prefix="seg_head.")
    flat_p = {("depth_net",) + k: v for k, v in dpt_p.items()}
    flat_p.update({("seg_head",) + k: v for k, v in seg_p.items()})
    flat_s = {("depth_net",) + k: v for k, v in dpt_s.items()}
    flat_s.update({("seg_head",) + k: v for k, v in seg_s.items()})
    return _nest(flat_p), _nest(flat_s)


def import_dpt_depth_model(sd: Dict[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """Standalone DPTDepthModel (MiDaS dpt_swin2_tiny_256.pt layout)."""
    p, s = convert_swin2_dpt_keys(sd, torch_prefix="")
    return _nest(p), _nest(s)


def convert_seg_output_conv_keys(
    sd: Dict[str, np.ndarray], torch_prefix: str
) -> Tuple[Dict[Tuple[str, ...], np.ndarray], Dict[Tuple[str, ...], np.ndarray]]:
    """DPTSegmentationModel head at ``scratch.output_conv.{0,1,4}``
    (conv3x3-noBias, BN, conv1x1 — reference dpt.py:242-252) -> the flax
    SegHead tree (conv1 / bn / conv2)."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}
    for key, val in sd.items():
        if not key.startswith(torch_prefix):
            continue
        sub = key[len(torch_prefix):]
        m = re.match(r"scratch\.output_conv\.(\d)\.(.+)$", sub)
        if not m:
            continue
        idx, leaf = int(m.group(1)), m.group(2)
        if idx == 0 and leaf == "weight":
            params[("head", "conv1", "kernel")] = _conv(val)
        elif idx == 1:
            if leaf == "weight":
                params[("head", "bn", "scale")] = _id(val)
            elif leaf == "bias":
                params[("head", "bn", "bias")] = _id(val)
            elif leaf == "running_mean":
                stats[("head", "bn", "mean")] = _id(val)
            elif leaf == "running_var":
                stats[("head", "bn", "var")] = _id(val)
        elif idx == 4:
            if leaf == "weight":
                params[("head", "conv2", "kernel")] = _conv(val)
            elif leaf == "bias":
                params[("head", "conv2", "bias")] = _id(val)
    return params, stats


def import_soccdpt_v1(
    sd: Dict[str, np.ndarray], family: str = "swin"
) -> Tuple[Dict, Dict]:
    """SOccDPT_V1: two full DPTs (reference SOccDPT.py:470-523) —
    ``depth_net.*`` (depth head at scratch.output_conv) and ``seg_net.*``
    (seg head at scratch.output_conv)."""
    d_p, d_s = convert_backbone_dpt_keys(sd, "depth_net.", family)
    s_p, s_s = convert_backbone_dpt_keys(sd, "seg_net.", family)
    # the seg DPT's output_conv is a seg head, not the depth head the
    # generic converter assumed — override those leaves
    for k in [k for k in s_p if k[0] == "head"]:
        del s_p[k]
    sh_p, sh_s = convert_seg_output_conv_keys(sd, torch_prefix="seg_net.")
    s_p.update(sh_p)
    s_s.update(sh_s)

    flat_p = {("depth_net",) + k: v for k, v in d_p.items()}
    flat_p.update({("seg_net",) + k: v for k, v in s_p.items()})
    flat_s = {("depth_net",) + k: v for k, v in d_s.items()}
    flat_s.update({("seg_net",) + k: v for k, v in s_s.items()})
    return _nest(flat_p), _nest(flat_s)


def import_soccdpt_v2(
    sd: Dict[str, np.ndarray], family: str = "swin"
) -> Tuple[Dict, Dict]:
    """SOccDPT_V2 (reference SOccDPT.py:526-623): shared trunk under
    ``pretrained.*`` (identity head), plus ``depth_head.{0,2,4}`` and the
    seg head (saved as ``seg_ead`` due to the reference's typo; both
    spellings accepted)."""
    t_p, t_s = convert_backbone_dpt_keys(sd, "pretrained.", family)
    flat_p = {("pretrained",) + k: v for k, v in t_p.items()}
    flat_s = {("pretrained",) + k: v for k, v in t_s.items()}

    for key, val in sd.items():
        m = re.match(r"depth_head\.(\d)\.(weight|bias)$", key)
        if m:
            idx, wb = int(m.group(1)), m.group(2)
            conv = {0: "conv1", 2: "conv2", 4: "conv3"}.get(idx)
            if conv:
                flat_p[("depth_head", conv, "kernel" if wb == "weight" else "bias")] = (
                    _conv(val) if wb == "weight" else _id(val)
                )

    for prefix in ("seg_head.", "seg_ead."):
        p, s = convert_seg_head_keys(sd, torch_prefix=prefix)
        flat_p.update({("seg_head",) + k: v for k, v in p.items()})
        flat_s.update({("seg_head",) + k: v for k, v in s.items()})
    return _nest(flat_p), _nest(flat_s)


def import_soccdpt(
    sd: Dict[str, np.ndarray], version: int, family: str = "swin"
) -> Tuple[Dict, Dict]:
    return {1: import_soccdpt_v1, 2: import_soccdpt_v2, 3: import_soccdpt_v3}[
        version
    ](sd, family)


# ---------------------------------------------------------------------------
# ViT / BEiT family (MiDaS dpt_large_384 / dpt_beit_*_384 layouts)
# ---------------------------------------------------------------------------


def _conv_t(w):
    """torch ConvTranspose2d (in, out, kh, kw) -> flax (kh, kw, in, out).

    flax ``nn.ConvTranspose`` runs a fractionally-strided *correlation*
    with the stored kernel, while torch's ConvTranspose2d computes the
    conv gradient — spatially mirrored. The kernel must be flipped along
    both spatial axes or every imported up-conv is wrong (caught by
    test_vit_act_postprocess_pyramid_vs_reference; verified against
    torch for k=s and overlapping k>s cases)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def _resize_rel_pos_table(
    table: np.ndarray, src_hw: Tuple[int, int], dst_hw: Tuple[int, int]
) -> np.ndarray:
    """Bilinearly resize a BEiT relative-position-bias table between
    window geometries (the reference patches timm to do this at runtime,
    backbones/beit.py:30-83; here it happens once at import). The last 3
    rows (cls entries) pass through."""
    sh, sw = 2 * src_hw[0] - 1, 2 * src_hw[1] - 1
    dh, dw = 2 * dst_hw[0] - 1, 2 * dst_hw[1] - 1
    heads = table.shape[1]
    spatial = table[: sh * sw].reshape(sh, sw, heads)
    if (sh, sw) != (dh, dw):
        import torch

        from ..ops.resize import resize_hw

        spatial = resize_hw(
            torch.from_numpy(np.ascontiguousarray(spatial[None], np.float32)),
            (dh, dw), "bilinear", True,
        )[0].numpy()
    return np.concatenate(
        [spatial.reshape(dh * dw, heads), table[sh * sw:]], axis=0
    )


def convert_vit_dpt_keys(
    sd: Dict[str, np.ndarray],
    torch_prefix: str = "",
    family: str = "vit",
    grid_hw: Tuple[int, int] = (24, 24),
) -> Tuple[Dict[Tuple[str, ...], np.ndarray], Dict[Tuple[str, ...], np.ndarray]]:
    """MiDaS DPT-with-ViT/BEiT layout -> flax path dict.

    Backbone under ``pretrained.model.*`` (timm VisionTransformer/Beit),
    pyramid ops under ``pretrained.act_postprocess{1..4}`` (readout
    project Linear at index 0.project.0, 1x1 conv at index 3,
    up/down conv at index 4 — reference backbones/utils.py:154-269),
    scratch/refinenets/head handled by the shared converter.
    """
    params, stats = convert_swin2_dpt_keys(sd, torch_prefix=torch_prefix)
    # drop backbone keys the swin2 converter mis-claimed (it only matches
    # swin-specific names, so usually nothing; keep scratch/head results)
    params = {k: v for k, v in params.items() if k[0] != "backbone"}

    bb = ("backbone",)
    for key, val in sd.items():
        if torch_prefix:
            if not key.startswith(torch_prefix):
                continue
            key = key[len(torch_prefix):]

        m = re.match(r"pretrained\.model\.(.*)$", key)
        if m:
            sub = m.group(1)
            if sub == "cls_token":
                params[bb + ("cls_token",)] = _id(val)
            elif sub == "pos_embed":
                params[bb + ("pos_embed",)] = _id(val)
            elif sub == "patch_embed.proj.weight":
                params[bb + ("patch_embed", "kernel")] = _conv(val)
            elif sub == "patch_embed.proj.bias":
                params[bb + ("patch_embed", "bias")] = _id(val)
            else:
                b = re.match(r"blocks\.(\d+)\.(.*)$", sub)
                if not b:
                    continue
                i, rest = int(b.group(1)), b.group(2)
                blk = bb + (f"block{i}",)
                table = {
                    "norm1.weight": (blk + ("norm1", "scale"), _id),
                    "norm1.bias": (blk + ("norm1", "bias"), _id),
                    "norm2.weight": (blk + ("norm2", "scale"), _id),
                    "norm2.bias": (blk + ("norm2", "bias"), _id),
                    "attn.qkv.weight": (blk + ("qkv", "kernel"), _dense),
                    "attn.qkv.bias": (blk + ("qkv", "bias"), _id),
                    "attn.q_bias": (blk + ("q_bias",), _id),
                    "attn.v_bias": (blk + ("v_bias",), _id),
                    "attn.proj.weight": (blk + ("proj", "kernel"), _dense),
                    "attn.proj.bias": (blk + ("proj", "bias"), _id),
                    "mlp.fc1.weight": (blk + ("mlp_fc1", "kernel"), _dense),
                    "mlp.fc1.bias": (blk + ("mlp_fc1", "bias"), _id),
                    "mlp.fc2.weight": (blk + ("mlp_fc2", "kernel"), _dense),
                    "mlp.fc2.bias": (blk + ("mlp_fc2", "bias"), _id),
                    "gamma_1": (blk + ("gamma_1",), _id),
                    "gamma_2": (blk + ("gamma_2",), _id),
                }
                if rest in table:
                    path, fn = table[rest]
                    params[path] = fn(val)
                elif rest == "attn.relative_position_bias_table":
                    n = int(np.sqrt(val.shape[0] - 3))
                    src = ((n + 1) // 2, (n + 1) // 2)
                    params[blk + ("rel_pos_table",)] = _resize_rel_pos_table(
                        np.asarray(val), src, grid_hw
                    )
            continue

        m = re.match(r"pretrained\.act_postprocess(\d)\.(.*)$", key)
        if m:
            lvl, rest = int(m.group(1)), m.group(2)
            if rest == "0.project.0.weight":
                params[bb + (f"readout{lvl}", "project", "kernel")] = _dense(val)
            elif rest == "0.project.0.bias":
                params[bb + (f"readout{lvl}", "project", "bias")] = _id(val)
            elif rest == "3.weight":
                params[bb + (f"proj{lvl}", "kernel")] = _conv(val)
            elif rest == "3.bias":
                params[bb + (f"proj{lvl}", "bias")] = _id(val)
            elif rest == "4.weight":
                if lvl == 1:
                    params[bb + ("up4x", "kernel")] = _conv_t(val)
                elif lvl == 2:
                    params[bb + ("up2x", "kernel")] = _conv_t(val)
                elif lvl == 4:
                    params[bb + ("down2x", "kernel")] = _conv(val)
            elif rest == "4.bias":
                name = {1: "up4x", 2: "up2x", 4: "down2x"}.get(lvl)
                if name:
                    params[bb + (name, "bias")] = _id(val)
    return params, stats


def import_dpt_vit_depth_model(
    sd: Dict[str, np.ndarray],
    family: str = "vit",
    grid_hw: Tuple[int, int] = (24, 24),
) -> Tuple[Dict, Dict]:
    """Standalone ViT/BEiT DPTDepthModel (MiDaS dpt_large_384 /
    dpt_beit_*_384 layouts)."""
    p, s = convert_vit_dpt_keys(sd, "", family, grid_hw)
    return _nest(p), _nest(s)


def convert_hybrid_dpt_keys(
    sd: Dict[str, np.ndarray],
    torch_prefix: str = "",
    grid_hw: Tuple[int, int] = (24, 24),
) -> Tuple[Dict[Tuple[str, ...], np.ndarray], Dict[Tuple[str, ...], np.ndarray]]:
    """MiDaS dpt_hybrid_384 layout -> flax paths: timm
    ``vit_base_r50_s16_384`` ResNetV2 trunk under
    ``pretrained.model.patch_embed.backbone`` (``preact=False`` v1.5
    bottlenecks: conv{1,2,3}+norm{1,2,3}, downsample conv+norm, stem
    conv+norm; weight-standardized convs — standardization happens at
    use on both sides, so raw kernels import 1:1), the ViT trunk, and
    the level-3/4 act_postprocess ops (levels 1/2 are the raw ResNet
    stage outputs — identity in both implementations)."""
    params, stats = convert_vit_dpt_keys(sd, torch_prefix, "vit", grid_hw)
    bb = ("backbone",)
    norm_map = {"norm1": "gn1", "norm2": "gn2", "norm3": "gn3"}
    for key, val in sd.items():
        if torch_prefix:
            if not key.startswith(torch_prefix):
                continue
            key = key[len(torch_prefix):]
        m = re.match(r"pretrained\.model\.patch_embed\.(.*)$", key)
        if not m:
            continue
        sub = m.group(1)
        if sub == "backbone.stem.conv.weight":
            params[bb + ("stem_conv", "kernel")] = _conv(val)
        elif sub in ("backbone.stem.norm.weight", "backbone.stem.norm.bias"):
            leaf = "scale" if sub.endswith("weight") else "bias"
            params[bb + ("stem_gn", leaf)] = _id(val)
        elif sub == "proj.weight":
            params[bb + ("patch_embed_proj", "kernel")] = _conv(val)
        elif sub == "proj.bias":
            params[bb + ("patch_embed_proj", "bias")] = _id(val)
        else:
            b = re.match(
                r"backbone\.stages\.(\d+)\.blocks\.(\d+)\.(.*)$", sub
            )
            if not b:
                continue
            s_i, b_i, rest = int(b.group(1)), int(b.group(2)), b.group(3)
            blk = bb + (f"stage{s_i}_block{b_i}",)
            cm = re.match(r"conv(\d)\.weight$", rest)
            nm = re.match(r"norm(\d)\.(weight|bias)$", rest)
            if cm:
                params[blk + (f"conv{cm.group(1)}", "kernel")] = _conv(val)
            elif nm:
                name = norm_map[f"norm{nm.group(1)}"]
                leaf = "scale" if nm.group(2) == "weight" else "bias"
                params[blk + (name, leaf)] = _id(val)
            elif rest == "downsample.conv.weight":
                params[blk + ("downsample_conv", "kernel")] = _conv(val)
            elif rest in ("downsample.norm.weight", "downsample.norm.bias"):
                leaf = "scale" if rest.endswith("weight") else "bias"
                params[blk + ("downsample_gn", leaf)] = _id(val)
    return params, stats


def import_dpt_hybrid_depth_model(
    sd: Dict[str, np.ndarray], grid_hw: Tuple[int, int] = (24, 24)
) -> Tuple[Dict, Dict]:
    p, s = convert_hybrid_dpt_keys(sd, "", grid_hw)
    return _nest(p), _nest(s)


def _bn_leaf(base, leaf, val, params, stats):
    """torch BatchNorm leaf -> flax params/batch_stats entries."""
    if leaf == "weight":
        params[base + ("scale",)] = _id(val)
    elif leaf == "bias":
        params[base + ("bias",)] = _id(val)
    elif leaf == "running_mean":
        stats[base + ("mean",)] = _id(val)
    elif leaf == "running_var":
        stats[base + ("var",)] = _id(val)


# ---------------------------------------------------------------------------
# LeViT family (MiDaS dpt_levit_224 layout, timm 0.6.12 LeViT)
# ---------------------------------------------------------------------------


def _levit_block_names(depths: Tuple[int, ...] = (4, 4, 4)) -> Dict[int, Tuple[str, str]]:
    """timm ``model.blocks`` flat index -> (flax module name, kind).

    timm's block list per stage: depth x [Residual(Attention),
    Residual(FFN)], then between stages [AttentionSubsample,
    Residual(FFN)] (the hook indices of reference dpt.py:85 count this
    same flat sequence)."""
    names: Dict[int, Tuple[str, str]] = {}
    blk = 0
    for s, depth in enumerate(depths):
        for d in range(depth):
            names[blk] = (f"s{s}_attn{d}", "attn")
            blk += 1
            names[blk] = (f"s{s}_mlp{d}", "mlp")
            blk += 1
        if s < len(depths) - 1:
            names[blk] = (f"downsample{s}_attn", "sub")
            blk += 1
            names[blk] = (f"downsample{s}_mlp", "mlp")
            blk += 1
    return names


def convert_levit_dpt_keys(
    sd: Dict[str, np.ndarray],
    torch_prefix: str = "",
    depths: Tuple[int, ...] = (4, 4, 4),
) -> Tuple[Dict[Tuple[str, ...], np.ndarray], Dict[Tuple[str, ...], np.ndarray]]:
    """MiDaS dpt_levit_224 layout -> flax paths.

    Backbone under ``pretrained.model.*`` (timm 0.6.12 LeViT:
    ``patch_embed.{0,2,4,6}`` ConvNorm stem, ``blocks.N`` flat sequence
    of Linear_BN modules with ``c``/``bn`` children, per-head fused
    ``qkv`` / subsample ``kv``+``q``, ``attention_biases`` tables whose
    first-seen offset order equals the ``|dh|*gw+|dw|`` index); the
    reference's ConvTranspose upsampling head under
    ``scratch.stem_transpose`` (reference backbones/levit.py:60-132).
    Scratch/refinenets/output head via the shared converter. The
    transposed-conv kernels are flipped into flax's layout (``_conv_t``);
    the port's ``StemTranspose`` pads as flax's ``"SAME"`` does, to even
    output sizes, where the reference's torch module (padding 1) gives
    2H - 1.
    """
    params, stats = convert_swin2_dpt_keys(sd, torch_prefix=torch_prefix)
    params = {k: v for k, v in params.items() if k[0] != "backbone"}
    names = _levit_block_names(depths)
    bb = ("backbone",)
    for key, val in sd.items():
        if torch_prefix:
            if not key.startswith(torch_prefix):
                continue
            key = key[len(torch_prefix):]

        m = re.match(r"pretrained\.model\.(.*)$", key)
        if m:
            sub = m.group(1)
            pe = re.match(r"patch_embed\.(\d)\.(c|bn)\.(.+)$", sub)
            if pe:
                idx, mod, leaf = int(pe.group(1)) // 2, pe.group(2), pe.group(3)
                stem = bb + (f"stem{idx}",)
                if mod == "c" and leaf == "weight":
                    params[stem + ("conv", "kernel")] = _conv(val)
                elif mod == "bn":
                    _bn_leaf(stem + ("bn",), leaf, val, params, stats)
                continue
            b = re.match(r"blocks\.(\d+)\.(.*)$", sub)
            if not b:
                continue
            n, rest = int(b.group(1)), b.group(2)
            if n not in names:
                continue
            name, kind = names[n]
            blk = bb + (name,)
            if kind == "mlp":
                mm = re.match(r"m\.(0|2)\.(c|bn)\.(.+)$", rest)
                if mm:
                    fc = "fc1" if mm.group(1) == "0" else "fc2"
                    if mm.group(2) == "c" and mm.group(3) == "weight":
                        params[blk + (fc, "linear", "kernel")] = _dense(val)
                    elif mm.group(2) == "bn":
                        _bn_leaf(blk + (fc, "bn"), mm.group(3), val, params, stats)
            else:
                # attention blocks are Residual-wrapped ("m." prefix); the
                # AttentionSubsample between stages is not
                if kind == "attn":
                    if not rest.startswith("m."):
                        continue
                    r = rest[2:]
                else:
                    r = rest
                if r == "attention_biases":
                    params[blk + ("attn_bias",)] = _id(val)
                    continue
                am = re.match(r"(qkv|kv|proj\.1|q\.1)\.(c|bn)\.(.+)$", r)
                if am:
                    mod = {"qkv": "qkv", "kv": "kv", "proj.1": "proj", "q.1": "q"}[am.group(1)]
                    if am.group(2) == "c" and am.group(3) == "weight":
                        params[blk + (mod, "linear", "kernel")] = _dense(val)
                    elif am.group(2) == "bn":
                        _bn_leaf(blk + (mod, "bn"), am.group(3), val, params, stats)
            continue

        st = re.match(r"scratch\.stem_transpose\.(0|2)\.(c|bn)\.(.+)$", key)
        if st:
            idx = "1" if st.group(1) == "0" else "2"
            base = ("stem_transpose",)
            if st.group(2) == "c" and st.group(3) == "weight":
                params[base + (f"up{idx}", "kernel")] = _conv_t(val)
            elif st.group(2) == "bn":
                _bn_leaf(base + (f"bn{idx}",), st.group(3), val, params, stats)
    return params, stats


# ---------------------------------------------------------------------------
# Next-ViT family (MiDaS dpt_next_vit_large_384 layout, official bytedance
# module names, which the backbone's scopes mirror)
# ---------------------------------------------------------------------------


def convert_next_vit_dpt_keys(
    sd: Dict[str, np.ndarray], torch_prefix: str = ""
) -> Tuple[Dict[Tuple[str, ...], np.ndarray], Dict[Tuple[str, ...], np.ndarray]]:
    """Official Next-ViT layout under ``pretrained.model.*``
    (``stem.{0..3}`` ConvBNReLU, ``features.{N}`` NCB/NTB blocks whose
    child names -- patch_embed / mhca.group_conv3x3 / mhca.projection /
    e_mhsa.{q,k,v,proj} / norm(1|2) / mlp.conv(1|2) -- the backbone
    reuses verbatim) -> flax paths. Leaf kind is dispatched on tensor
    rank: 4-D weight = conv, 2-D = linear, 1-D = BN scale. The final
    classifier ``norm``/``head`` keys are ignored. Scratch/refinenets/
    output head via the shared converter."""
    params, stats = convert_swin2_dpt_keys(sd, torch_prefix=torch_prefix)
    params = {k: v for k, v in params.items() if k[0] != "backbone"}
    for key, val in sd.items():
        if torch_prefix:
            if not key.startswith(torch_prefix):
                continue
            key = key[len(torch_prefix):]
        m = re.match(r"pretrained\.model\.(stem|features)\.(\d+)\.(.*)$", key)
        if not m:
            continue
        root, n, rest = m.groups()
        parts = rest.split(".")
        leaf, mods = parts[-1], tuple(parts[:-1])
        path = ("backbone", f"{root}{n}") + mods
        val = np.asarray(val)
        if leaf == "weight":
            if val.ndim == 4:
                params[path + ("kernel",)] = _conv(val)
            elif val.ndim == 2:
                params[path + ("kernel",)] = _dense(val)
            else:
                params[path + ("scale",)] = _id(val)
        elif leaf == "bias":
            params[path + ("bias",)] = _id(val)
        elif leaf == "running_mean":
            stats[path + ("mean",)] = _id(val)
        elif leaf == "running_var":
            stats[path + ("var",)] = _id(val)
    return params, stats


# ---------------------------------------------------------------------------
# The lenient merge, and the landing in a port model
# ---------------------------------------------------------------------------


def flat_paths(tree: Mapping, path: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """A nested dict's leaves by their key paths (the inverse of ``_nest``)."""
    out: Dict[Tuple[str, ...], Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(flat_paths(val, path + (key,)))
        else:
            out[path + (key,)] = val
    return out


def merge_report(target: Mapping, imported: Mapping) -> Tuple[Dict, Dict[str, Any]]:
    """``merge_into`` without its print: the merged tree and what the
    merge did (``loaded``, ``total``, ``unused`` imported paths,
    ``mismatched`` (path, imported shape, target shape))."""
    flat_t, flat_i = flat_paths(target), flat_paths(imported)
    merged, used, mismatched = {}, set(), []
    for key, tgt in flat_t.items():
        src = flat_i.get(key)
        if src is not None and np.shape(src) == np.shape(tgt):
            merged[key] = np.asarray(src, dtype=np.asarray(tgt).dtype)
            used.add(key)
        else:
            merged[key] = tgt
            if src is not None:
                mismatched.append((key, np.shape(src), np.shape(tgt)))
    report = {"loaded": len(used), "total": len(flat_t),
              "unused": sorted(set(flat_i) - used), "mismatched": mismatched}
    return _nest(merged), report


def _print_report(report: Dict[str, Any]) -> None:
    print(
        f"[torch_import] loaded {report['loaded']}/{report['total']} leaves; "
        f"{len(report['unused'])} unused imported keys; "
        f"{len(report['mismatched'])} shape mismatches"
    )
    for k, ss, ts in report["mismatched"][:10]:
        print("  mismatch", "/".join(k), ss, "->", ts)


def merge_into(params: Mapping, imported: Mapping, verbose: bool = True) -> Dict:
    """Lenient merge of an imported nested dict into a tree of the same
    paths (strict=False semantics, reference base_model.py:30-33): a leaf
    takes the imported value where the path and the shape match, else keeps
    its own. Prints the JAX package's line: loaded N/M leaves, U unused
    imported keys, S shape mismatches."""
    merged, report = merge_report(params, imported)
    if verbose:
        _print_report(report)
    return merged


def load_imported(model, params: Mapping, batch_stats: Mapping,
                  verbose: bool = True) -> Dict[str, Dict[str, Any]]:
    """Merge imported ``params`` and ``batch_stats`` (``import_soccdpt``'s
    pair) into ``model`` in place, leniently, as the JAX CLIs merge them
    into their fresh state: every leaf of the model that has no imported
    counterpart of its shape keeps its value. Prints ``merge_into``'s line
    for each collection and returns each one's ``merge_report``.
    ``weights.load_jax_variables`` keeps its strict contract: the merged
    trees hold every leaf of the model."""
    from ..weights import load_jax_variables, to_jax_variables

    current = to_jax_variables(model)
    reports, merged = {}, {}
    for coll, imported in (("params", params), ("batch_stats", batch_stats)):
        merged[coll], reports[coll] = merge_report(current[coll], imported)
        if verbose:
            _print_report(reports[coll])
    load_jax_variables(model, merged)
    return reports
