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


def _rule(mod: nn.Module, name: str, t: torch.Tensor):
    """(mean, std) of a leaf: fan-in-scaled kernels, norm scales near 1,
    BEiT's LayerScale near its 0.1, position tables wide enough that an
    attention that dropped its bias could not pass, small biases."""
    if name == "weight" and isinstance(mod, nn.ConvTranspose2d):
        return 0.0, 1.0 / math.sqrt(t.shape[0])
    if name == "weight" and isinstance(mod, (nn.Linear, nn.Conv2d)):
        return 0.0, 1.0 / math.sqrt(t[0].numel())
    if name == "weight" and isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
        return 1.0, 0.05
    if name == "rel_pos_table":
        return 0.0, 0.5
    if name in ("gamma_1", "gamma_2"):
        return 0.1, 0.02
    if name == "logit_scale":
        return math.log(10.0), 0.05
    if name == "running_var":
        return 1.0, 0.1
    return 0.0, 0.05


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for configuration ``cfg`` under the program's names,
    f32 on ``device``, drawn in one call and scaled leaf by leaf in a few
    grouped ones; the file's ``weights`` entries set a leaf's mean and
    standard deviation."""
    with torch.device("meta"):
        skeleton = reference.SOccDPTV3(cfg)
    names, shapes, means, stds, ints = [], [], [], [], {}
    for mpath, mod in skeleton.named_modules():
        leaves = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for pname, t in leaves:
            full = f"{mpath}.{pname}" if mpath else pname
            if not t.is_floating_point():
                ints[full] = torch.zeros(t.shape, dtype=t.dtype, device=device)
                continue
            mean, std = _rule(mod, pname, t)
            spec = cfg.get("weights", {}).get(full, {})
            names.append(full)
            shapes.append(t.shape)
            means.append(float(spec.get("mean", mean)))
            stds.append(float(spec.get("std", std)))
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device), device=device)
    parts = list(flat.split(sizes))
    torch._foreach_mul_(parts, stds)
    torch._foreach_add_(parts, means)
    state = {n: p.view(s) for n, p, s in zip(names, parts, shapes)}
    state.update(ints)
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
