"""What a cell runs and feeds: the program's model built from a
configuration file, the weights and frames the benchmark makes from
``--seed`` on the device, and the program's config objects.

Every input is drawn from a ``torch.Generator`` of its own, seeded from
``--seed`` and a purpose, so the weights do not depend on the traffic and
the same seed gives the same inputs on every run.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from . import reference

WEIGHTS, FRAMES, SAMPLE = 0, 1, 4  # purposes of a seed's generators


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) << 3) | purpose)


# affine norms: BatchNorm and InstanceNorm of any rank share _NormBase
NORMS = (nn.LayerNorm, nn.GroupNorm, nn.RMSNorm, nn.modules.batchnorm._NormBase)


def _rule(mod: nn.Module, name: str, t: torch.Tensor, family_rule):
    """(mean, std) of a leaf: the trunk family's own rule where it gives
    one, then fan-in-scaled kernels, affine norm scales near 1, running
    variances near 1, small biases."""
    if family_rule is not None:
        rule = family_rule(mod, name, t)
        if rule is not None:
            return rule
    if name == "weight" and isinstance(mod, nn.ConvTranspose2d):
        return 0.0, 1.0 / math.sqrt(t.shape[0])
    if name == "weight" and isinstance(mod, (nn.Linear, nn.Conv2d)):
        return 0.0, 1.0 / math.sqrt(t[0].numel())
    if name == "weight" and isinstance(mod, NORMS):
        return 1.0, 0.05
    if name == "running_var":
        return 1.0, 0.1
    return 0.0, 0.05


def weight_table(cfg: dict):
    """The leaves of configuration ``cfg`` under the program's names, in
    the order they are drawn: ``[(name, shape, mean, std)]`` of the
    floating ones (the file's ``weights`` entries override the rules) and
    ``{name: (shape, dtype)}`` of the integer ones."""
    with torch.device("meta"):
        skeleton = reference.SOccDPTV3(cfg)
    family_rule = getattr(reference.trunk_module(cfg), "weight_rule", None)
    table, ints = [], {}
    for mpath, mod in skeleton.named_modules():
        leaves = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for pname, t in leaves:
            full = f"{mpath}.{pname}" if mpath else pname
            if not t.is_floating_point():
                ints[full] = (t.shape, t.dtype)
                continue
            mean, std = _rule(mod, pname, t, family_rule)
            spec = cfg.get("weights", {}).get(full, {})
            table.append((full, t.shape, float(spec.get("mean", mean)),
                          float(spec.get("std", std))))
    return table, ints


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for configuration ``cfg`` under the program's names,
    f32 on ``device``, drawn in one call and scaled leaf by leaf in a few
    grouped ones (``weight_table``)."""
    table, ints = weight_table(cfg)
    names, shapes, means, stds = zip(*table)
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device), device=device)
    parts = list(flat.split(sizes))
    torch._foreach_mul_(parts, list(stds))
    torch._foreach_add_(parts, list(means))
    state = {n: p.view(s) for n, p, s in zip(names, parts, shapes)}
    state.update({n: torch.zeros(s, dtype=dt, device=device) for n, (s, dt) in ints.items()})
    return state


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from soccdpt_torch.core.config import CameraConfig, ModelConfig, OccupancyConfig

    occ = {k: tuple(v) for k, v in cfg["occupancy"].items()}
    return ModelConfig(
        model_type=cfg["model_type"], version=cfg["version"], num_classes=cfg["num_classes"],
        features=cfg["features"], head_features_2=cfg["head_features_2"],
        sigmoid=cfg["sigmoid"], camera=CameraConfig(**cfg["camera"]),
        occupancy=OccupancyConfig(**occ), compute_dtype=cfg["compute_dtype"])


def program_model(cfg: dict, state: Dict[str, torch.Tensor], device) -> nn.Module:
    """The program's SOccDPT of ``cfg`` on ``device``, holding ``state``."""
    from soccdpt_torch.models.soccdpt import SOccDPT_versions

    mcfg = model_config(cfg)
    with torch.device(device):
        model = SOccDPT_versions[mcfg.version](mcfg)
    model = model.to(device)
    model.load_state_dict(state, strict=True)
    return model


def frames(seed: int, ticks: int, batch: int, cfg: dict, device) -> torch.Tensor:
    """(ticks, batch, H, W, 3) uint8 camera frames on ``device``."""
    cam = cfg["camera"]
    return torch.randint(0, 256, (ticks, batch, cam["height"], cam["width"], 3),
                         generator=generator(seed, FRAMES, device), device=device,
                         dtype=torch.uint8)
