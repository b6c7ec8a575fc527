"""Ranks of the port's data- and tensor-parallel tests: gloo process groups
on the CPU, spawned by ``torch.multiprocessing``.

This module imports no JAX and no test module that does: a spawned child
imports it afresh, and JAX is set up for the pytest process alone. Each
rank runs one thread, joins a group on a ``FileStore`` under the test's own
directory (so the suite's worker processes never share one), runs a
scenario and writes what it saw to ``<out>/<scenario>_rank<r>.pt``.

A case is a dict of plain values:

* ``model``: the ``ModelConfig`` fields; ``train``: the ``TrainConfig`` ones;
* ``mesh``: the mesh shape, ``(dp,)`` or ``(dp, tp)``; ``None`` on one
  process, where the trainer builds no group;
* ``steps``: training steps on ``batch`` (an ``.npz`` of the global batch);
* ``variables``: an ``.npz`` of flax-layout variables to start from
  (``params/...``, ``batch_stats/...``), else the weights of seed 0;
* ``restore``: a checkpoint to resume from before the steps; ``save``: where
  to write one after them (rank 0 writes, every rank gathers).

Dropout and stochastic depth are off: one process and several ranks draw
other numbers for the same rows.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from soccdpt_torch.core.checkpoint import restore_checkpoint, save_checkpoint
from soccdpt_torch.core.config import ModelConfig, TrainConfig
from soccdpt_torch.parallel import mesh as mesh_lib
from soccdpt_torch.train.trainer import Trainer
from soccdpt_torch.weights import load_jax_variables, to_jax_variables


def flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.array(val)  # a copy: a CPU leaf may alias the weight
    return out


def nest_npz(path: str) -> Dict[str, Dict]:
    """``{"params": tree, "batch_stats": tree}`` of an ``.npz`` of
    ``/``-joined flax paths."""
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    with np.load(path) as npz:
        for key in npz.files:
            *scopes, leaf = key.split("/")
            node = tree
            for scope in scopes:
                node = node.setdefault(scope, {})
            node[leaf] = npz[key]
    return tree


def no_dropout(model: torch.nn.Module) -> None:
    for mod in model.modules():
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
        if hasattr(mod, "drop_path_rates"):
            mod.drop_path_rates = [0.0] * len(mod.drop_path_rates)


def run_case(case: Dict[str, Any]) -> Dict[str, Any]:
    """Train as ``case`` says and return the losses and the state after."""
    mesh = None
    if case.get("mesh") is not None:
        axes = (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS)[: len(case["mesh"])]
        mesh = mesh_lib.make_mesh(case["mesh"], axes)
    trainer = Trainer(ModelConfig(**case["model"]), TrainConfig(**case["train"]),
                      device="cpu", mesh=mesh)
    state = trainer.init_state(0)
    no_dropout(trainer.model)
    if case.get("variables"):
        load_jax_variables(trainer.model, nest_npz(case["variables"]))
    if case.get("restore"):
        state = trainer.restore_state(restore_checkpoint(case["restore"]))
    restored = _snapshot(trainer, trainer.gather_state(state))
    with np.load(case["batch"]) as npz:
        batch = {k: npz[k] for k in npz.files}
    losses: List[float] = []
    for _ in range(case.get("steps", 1)):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    full = trainer.gather_state(state)
    if case.get("save"):
        from soccdpt_torch.cli.train import training_checkpoint

        if trainer.mesh.rank == 0:
            save_checkpoint(case["save"], training_checkpoint(trainer.model, full))
        if trainer.mesh.distributed:
            dist.barrier()
    out = _snapshot(trainer, full)
    out.update(losses=losses, restored=restored, sharded=dict(trainer.shards),
               mesh=dict(trainer.mesh.shape), rank=trainer.mesh.rank,
               local_mu={path: m.clone() for path, m in state.mu.items()})
    return out


def _snapshot(trainer: Trainer, full) -> Dict[str, Any]:
    variables = to_jax_variables(trainer.model)
    return {"params": flat(variables["params"]), "stats": flat(variables["batch_stats"]),
            "mu": {p: m.clone() for p, m in full.mu.items()},
            "nu": {p: m.clone() for p, m in full.nu.items()},
            "count": full.count, "step": full.step, "learning_rate": full.learning_rate}


def run_cli(argv_sets: List[List[str]], workdir: str) -> Dict[str, Any]:
    """``cli/train.py::main`` on each argument list in turn; a raise is
    kept as its message. ``out["meshes"][i]`` counts the meshes that the
    ``i``-th run built on this rank."""
    from soccdpt_torch.cli import train as ptrain

    os.chdir(workdir)
    built = []
    make_mesh = mesh_lib.make_mesh

    def counted(*args, **kwargs):
        built.append(1)
        return make_mesh(*args, **kwargs)

    mesh_lib.make_mesh = counted
    out: Dict[str, Any] = {"meshes": {}}
    for i, argv in enumerate(argv_sets):
        built.clear()
        try:
            out[i] = ptrain.main(argv)
        except ValueError as exc:
            out[i] = f"ValueError: {exc}"
        out["meshes"][i] = len(built)
    return out


SCENARIOS = {"cases": lambda cases: [run_case(c) for c in cases], "cli": run_cli}


def rank_main(rank: int, world: int, store: str, out: str, scenario: str, args) -> None:
    torch.set_num_threads(1)
    # a rank left waiting fails the test in minutes instead of hanging it
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        result = SCENARIOS[scenario](*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out, f"{scenario}_rank{rank}.pt"))


def spawn(world: int, tmp, scenario: str, *args) -> List[Any]:
    """Run ``scenario`` on ``world`` gloo ranks; returns each rank's result.
    A rank that raises fails the call with its traceback."""
    tmp = str(tmp)
    store = os.path.join(tmp, f"store_{scenario}_{world}")
    if os.path.exists(store):
        os.remove(store)
    torch.multiprocessing.start_processes(
        rank_main, args=(world, store, tmp, scenario, args), nprocs=world,
        start_method="spawn")
    return [torch.load(os.path.join(tmp, f"{scenario}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def single(case: Dict[str, Any]) -> Dict[str, Any]:
    """``case`` on this process, with no process group."""
    return run_case(dict(case, mesh=None))


def save_batch(path: str, batch: Dict[str, np.ndarray]) -> str:
    np.savez(path, **batch)
    return path


def save_variables(path: str, variables: Dict[str, Dict]) -> str:
    arrays = {}
    for coll in ("params", "batch_stats"):
        for key, value in flat(variables.get(coll, {})).items():
            arrays[f"{coll}/{key.replace('.', '/')}"] = np.asarray(value, np.float32)
    np.savez(path, **arrays)
    return path


def uneven_masks(batch: Dict[str, np.ndarray], seed: int = 0) -> Dict[str, np.ndarray]:
    """``batch`` with masks whose counts differ from row to row: the second
    half of the batch loses a share of its pixels, so every split of the
    rows gives the ranks other mask counts."""
    rng = np.random.default_rng(seed)
    out = dict(batch)
    n = len(batch["image"])
    for key, share in (("mask_disp", 0.6), ("mask_seg", 0.3)):
        mask = np.array(batch[key], bool)
        for i in range(n // 2, n):
            mask[i] &= rng.random(mask[i].shape) > share * (i - n // 2 + 1) / (n - n // 2)
        out[key] = mask
    return out

