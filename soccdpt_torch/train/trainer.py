"""Training loop for SOccDPT (the port of ``soccdpt_tpu/train/trainer.py``).

* the loss is evaluated at GT resolution: the scale-and-shift-invariant
  depth loss from the net-resolution inverse depth (bicubic,
  ``align_corners=False``) against the GT disparity, and the masked BCE
  of the nearest-resized segmentation, weighted by ``loss_weights``, all
  in f32 whatever the network's dtype;
* patch-wise parameter-subset training through ``requires_grad`` masks
  (``train/patchwise.py``), in both of the JAX package's modes;
* AdamW with the JAX package's hyperparameters and a host-side
  reduce-on-plateau controller of the learning rate;
* ``amp`` means bf16 compute with f32 master weights and no loss scaling.

The JAX trainer is functional: a step maps a state to a new state. Here
the parameters and the BatchNorm statistics live in ``trainer.model`` and
a step updates them in place (one copy of 340 M weights fewer at
BEiT-large); ``TrainState`` carries the rest: the step count, the
learning rate and Adam's moments.

Adam under patch masks follows the JAX step's arithmetic, not
``torch.optim.AdamW``'s: the JAX step hands ``optax.adamw`` zeroed
gradients for the frozen leaves and zeroes their updates afterwards, so a
frozen leaf's moments still decay by beta1 and beta2 at every patch step,
one step count advances for every leaf, and neither the Adam update nor
the decoupled weight decay moves a frozen leaf. ``torch.optim.AdamW``
skips a parameter without a gradient altogether and counts steps per
parameter, which is something else from the second patch on.

Data and tensor parallelism follow the JAX trainer's mesh
(``parallel/mesh.py``): the global batch is split over the ``data`` axis
(the ranks along ``model`` hold the same rows), and after each patch
step's backward the gradients of the mask's active leaves are summed over
the ranks that hold the other rows. The loss's divisors and BatchNorm's
moments are the global batch's (``train/losses.py``,
``models/layers.py::batch_norm_nhwc``), so the loss, the gradients and the
running statistics are those of one process on the global batch. Adam's
moments and update are sharded over ``model`` by the JAX package's rule
(``parallel/sharding.py``): a rank holds and updates its slice of a
sharded leaf, and the slices are gathered into the full weight with an
in-place ``copy_``, which bumps the weight's version counter, so the caches
keyed on ``(data_ptr, _version)`` see the new weights. The model keeps its
full weights for the forward. The model is not wrapped in
``DistributedDataParallel``: the patch steps change which parameters take
gradients at every step, and DDP fixes its buckets when it is built.
Without a process group none of this runs and a step is the
single-process step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.nn.modules.batchnorm import _BatchNorm

from ..core.config import ModelConfig, TrainConfig
from ..core.device import resolve_device
from ..models.bias_cache import build_inference_cache
from ..models.soccdpt import build_model
from ..ops.resize import resize_nchw
from ..parallel import comm
from ..parallel import mesh as mesh_lib
from ..parallel.sharding import param_sharding_rules, shard_slice
from ..weights import load_jax_variables, moments_to_torch, named_flax_params
from .losses import masked_bce_loss, ssi_loss_from_net
from .patchwise import Mask, encoder_mask, patch_masks, select_trainable

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BATCH_KEYS = ("image", "disparity", "mask_disp", "seg", "mask_seg")


@dataclasses.dataclass
class TrainState:
    """What a step carries besides the model: ``step`` counts patch steps;
    ``count`` is Adam's one step count for every leaf; ``mu`` and ``nu``
    are its moments by flax path (on a rank of a tensor-parallel mesh, a
    sharded leaf's slice)."""

    step: int
    learning_rate: float
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (mode=min, patience=2, factor=0.1)."""

    def __init__(self, base_lr: float, patience: int = 2, factor: float = 0.1):
        self.lr = base_lr
        self.patience = patience
        self.factor = factor
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr


class MaskedAdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) over a
    fixed list of parameters, with the JAX step's arithmetic under a patch
    mask (see the module docstring). The moments and the count live in the
    ``TrainState`` it is given. With ``shards`` (``{flax path: dim}``) a
    sharded leaf's moments are this rank's slice along that dim, the update
    runs on the slices of the gradient and the weight, and the updated
    slices are gathered over ``mesh.model_group`` into the full weight."""

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    @torch.no_grad()
    def update(
        self,
        state: TrainState,
        params: List[Tuple[str, torch.nn.Parameter]],
        mask: Mask,
        shards: Optional[Dict[str, int]] = None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ) -> None:
        """One step in place: every leaf's moments decay; the leaves the
        mask names take their gradient (zeros where they have none) and
        move."""
        shards = shards or {}
        state.count += 1
        torch._foreach_mul_(list(state.mu.values()), ADAM_B1)
        torch._foreach_mul_(list(state.nu.values()), ADAM_B2)
        active = [(path, p) for path, p in params if mask[path]]
        if not active:
            return
        ps, grads = [], []
        for path, p in active:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            ps.append(shard_slice(p, shards.get(path), mesh))
            grads.append(shard_slice(g, shards.get(path), mesh))
        mu = [state.mu[path] for path, _ in active]
        nu = [state.nu[path] for path, _ in active]
        torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
        denom = torch._foreach_div(nu, 1.0 - ADAM_B2**state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        update = torch._foreach_div(mu, 1.0 - ADAM_B1**state.count)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, ps, alpha=self.weight_decay)
        if not shards:
            torch._foreach_add_(ps, update, alpha=-state.learning_rate)
            return
        new = torch._foreach_add(ps, update, alpha=-state.learning_rate)
        for (path, p), w in zip(active, new):
            dim = shards.get(path)
            if dim is None:
                p.copy_(w)
            else:
                # an in-place copy: the weight keeps its storage and its
                # version counter moves, as the inference caches expect
                p.copy_(comm.all_gather_dim(w, dim, mesh.model_group))


def make_optimizer(tcfg: TrainConfig) -> MaskedAdamW:
    """Adam with the reference's hyperparameters; the learning rate is read
    from the state at every step, so the plateau controller can change it
    without touching the moments."""
    return MaskedAdamW(tcfg.weight_decay)


class Trainer:
    """``init_state`` builds the model (weights from a numpy seed, on the
    card unless ``device`` says otherwise) and the masks; ``train_step``
    takes one optimizer step per patch mask on a batch. ``mesh`` (default:
    :meth:`default_mesh` of ``tcfg.tp``) says which rows of the global
    batch of ``tcfg.batch_size`` this rank holds and how the optimizer
    state is sharded."""

    def __init__(
        self,
        mcfg: ModelConfig,
        tcfg: TrainConfig,
        device: Union[str, torch.device, None] = None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ) -> None:
        if tcfg.amp and mcfg.compute_dtype != "bfloat16":
            mcfg = dataclasses.replace(mcfg, compute_dtype="bfloat16")
        if mcfg.occupancy_head:
            # training differentiates the raw outputs, which stop before the
            # occupancy head: the JAX trainer's tree holds no leaf of it either
            mcfg = dataclasses.replace(mcfg, occupancy_head=False)
        if tcfg.patchwise_mode not in ("inplace", "snapshot"):
            raise ValueError(f"unknown patchwise_mode {tcfg.patchwise_mode!r}")
        self.mcfg = mcfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else self.default_mesh(tcfg)
        if not self.mesh.active:
            raise ValueError(f"rank {self.mesh.rank} lies outside the mesh "
                             f"{dict(self.mesh.shape)}")
        self.tx = make_optimizer(tcfg)
        self.scheduler = PlateauScheduler(tcfg.learning_rate)
        self.model: Optional[torch.nn.Module] = None
        self.params: List[Tuple[str, torch.nn.Parameter]] = []  # in flax leaf order
        self.shards: Dict[str, int] = {}  # flax path -> dim sharded over "model"
        self.trainable_mask: Optional[Mask] = None
        self.masks: List[Mask] = []

    # -- initialization ------------------------------------------------

    @staticmethod
    def default_mesh(tcfg: TrainConfig) -> mesh_lib.Mesh:
        """(data, model) mesh from ``tcfg.tp`` over the ranks of the default
        process group (``parallel/mesh.py::mesh_for_batch``)."""
        return mesh_lib.mesh_for_batch(tcfg.batch_size, tcfg.tp)

    def param_shardings(self) -> Dict[str, Optional[int]]:
        """``{flax path: the torch dim sharded over model, or None}`` on this
        trainer's mesh (``parallel/sharding.py``)."""
        return param_sharding_rules(self.model, self.mesh, min_size=self.tcfg.tp_min_size)

    def init_state(self, seed: int = 0) -> TrainState:
        """Build the model in training mode, the encoder freeze and the
        patch-wise partition, and zeroed Adam moments (this rank's slices
        of the sharded leaves)."""
        self.model = build_model(
            self.mcfg, device=self.device, seed=seed, remat=self.tcfg.remat_backbone
        ).train()
        if self.mesh.dp > 1:
            # the ranks along "model" hold the same rows: a data axis of one
            # leaves BatchNorm the single-process moments
            for mod in self.model.modules():
                if isinstance(mod, _BatchNorm):
                    mod.process_group = self.mesh.data_group
        self.trainable_mask = encoder_mask(self.model, self.tcfg.encoder_percentage)
        self.masks = patch_masks(self.trainable_mask, self.tcfg.patchwise_percentage)
        self.params = named_flax_params(self.model)
        self.shards = {path: d for path, d in self.param_shardings().items() if d is not None}

        def zeros():
            return {path: torch.zeros_like(shard_slice(p, self.shards.get(path), self.mesh))
                    for path, p in self.params}

        return TrainState(step=0, learning_rate=self.tcfg.learning_rate, count=0,
                          mu=zeros(), nu=zeros())

    def reshard_state(self, state: TrainState) -> TrainState:
        """A state with full moments (fresh, or restored from a checkpoint
        written on any mesh) placed on this trainer: on its device, each
        sharded leaf's moments cut to this rank's slice."""
        shapes = {path: p.shape for path, p in self.params}

        def place(moments):
            if set(moments) != set(shapes):
                raise KeyError(f"moments do not match the parameters: "
                               f"{sorted(set(moments) ^ set(shapes))[:10]}")
            out = {}
            for path, m in moments.items():
                if m.shape != shapes[path]:
                    raise ValueError(f"{path}: moment of shape {tuple(m.shape)}, the "
                                     f"parameter's is {tuple(shapes[path])}")
                m = m.to(self.device, torch.float32)
                out[path] = shard_slice(m, self.shards.get(path), self.mesh).clone()
            return out

        return dataclasses.replace(state, mu=place(state.mu), nu=place(state.nu))

    def gather_state(self, state: TrainState) -> TrainState:
        """The state with full moments, gathered over the ranks along
        ``model``: what a checkpoint holds, whatever the mesh. Every rank
        calls it."""
        if not self.shards:
            return state

        def full(moments):
            return {path: comm.all_gather_dim(m, self.shards[path], self.mesh.model_group)
                    if path in self.shards else m for path, m in moments.items()}

        return dataclasses.replace(state, mu=full(state.mu), nu=full(state.nu))

    def restore_state(self, checkpoint: Dict) -> TrainState:
        """Resume from a checkpoint dict on this trainer's mesh: the
        weights, the BatchNorm statistics, Adam's moments and counts and the
        step. ``checkpoint`` is what ``cli/train.py::training_checkpoint``
        wrote (through ``core/checkpoint.py::restore_checkpoint``), or a
        JAX-package checkpoint converted to ``.npz``
        (``core/checkpoint.py::restore_jax_export``)."""
        if self.model is None:
            raise RuntimeError("call init_state() before restore_state()")
        opt = checkpoint["opt_state"]
        if opt is None:
            raise ValueError("the checkpoint holds no optimizer state: take its weights "
                             "with cli/train.py::load_weights")
        if "variables" in checkpoint:
            load_jax_variables(self.model, checkpoint["variables"])
            mu, nu = (moments_to_torch(self.model, opt[k]) for k in ("mu", "nu"))
        else:
            self.model.load_state_dict({**checkpoint["params"], **checkpoint["batch_stats"]})
            build_inference_cache(self.model)
            mu, nu = opt["mu"], opt["nu"]
        self.scheduler.lr = float(opt["learning_rate"])
        return self.reshard_state(TrainState(
            step=int(checkpoint["step"]), learning_rate=float(opt["learning_rate"]),
            count=int(opt["count"]), mu=mu, nu=nu))

    # -- train step ----------------------------------------------------

    def loss(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training objective of a device batch and its two parts. On a
        data-parallel mesh they are this rank's rows' shares of the global
        batch's, which add up to it over the ranks that hold the rows."""
        tcfg = self.tcfg
        global_sum = self._sum_over_data if self.mesh.distributed else None
        inv_depth, seg = self.model(batch["image"], return_raw=True, generator=generator)
        gt_hw = tuple(batch["disparity"].shape[-2:])
        l_disp = ssi_loss_from_net(
            inv_depth.float(),
            batch["disparity"].float(),
            batch["mask_disp"].float(),
            do_compute_scale_and_shift=tcfg.compute_scale_and_shift,
            global_sum=global_sum,
        )
        seg_pred = resize_nchw(seg.float(), gt_hw, "nearest")
        l_seg = masked_bce_loss(seg_pred, batch["seg"].float(), batch["mask_seg"].float(),
                                global_sum=global_sum)
        w_depth, w_seg = tcfg.loss_weights
        return w_depth * l_disp + w_seg * l_seg, {"loss_disp": l_disp, "loss_seg": l_seg}

    def _sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce_(t.clone(), self.mesh.data_group)

    def _patch_step(self, state, batch, mask, generator):
        select_trainable(self.model, mask)
        self.model.zero_grad(set_to_none=True)
        loss, aux = self.loss(batch, generator)
        loss.backward()
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
        if self.mesh.distributed:
            # each rank back-propagated its rows' share of the global loss, so
            # the sum of the gradients is the global batch's. That includes
            # K7's dbias, which it sums over this rank's rows: summed over
            # the ranks, it is the sum over the global batch that the JAX
            # package's kernel gives.
            grads = [p.grad for path, p in self.params if mask[path] and p.grad is not None]
            comm.all_reduce_buckets_(grads, self.mesh.data_group)
            # the logged losses are the global batch's: the sums of the shares
            summed = comm.all_reduce_(torch.stack(list(metrics.values())), self.mesh.data_group)
            metrics = dict(zip(metrics, summed.unbind()))
        self.tx.update(state, self.params, mask, self.shards, self.mesh)
        state.step += 1
        return metrics

    def train_step(
        self,
        state: TrainState,
        batch: Dict[str, Union[np.ndarray, torch.Tensor]],
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step per patch mask over the same batch; returns
        the state (updated in place, like the model) and the last patch
        step's metrics, as device tensors.

        ``patchwise_mode="inplace"`` (default): sequential patch steps,
        each seeing the previous patch's updates. ``"snapshot"``: every
        patch is trained from the same start weights and the updates are
        applied together at the end; the optimizer state and the BatchNorm
        statistics still thread through the patches in turn.
        ``generator`` feeds dropout and stochastic depth.
        """
        if self.model is None:
            raise RuntimeError("call init_state() before train_step()")
        # the JAX step is deterministic=False whatever ran before it (an
        # eval round leaves the model in eval mode)
        self.model.train()
        device_batch = self.to_device_batch(batch)
        metrics: Dict[str, torch.Tensor] = {}
        if not (self.tcfg.patchwise_mode == "snapshot" and len(self.masks) > 1):
            for mask in self.masks:
                metrics = self._patch_step(state, device_batch, mask, generator)
            return state, metrics

        # a leaf is active in exactly one patch: after its step, keep its
        # new value aside and put the start value back
        updated: List[Tuple[torch.nn.Parameter, torch.Tensor]] = []
        for mask in self.masks:
            active = [p for path, p in self.params if mask[path]]
            start = [p.detach().clone() for p in active]
            metrics = self._patch_step(state, device_batch, mask, generator)
            with torch.no_grad():
                for p, w0 in zip(active, start):
                    updated.append((p, p.detach().clone()))
                    p.copy_(w0)
        with torch.no_grad():
            for p, new in updated:
                p.copy_(new)
        return state, metrics

    def to_device_batch(
        self, batch: Dict[str, Union[np.ndarray, torch.Tensor]]
    ) -> Dict[str, torch.Tensor]:
        """This rank's rows (``parallel/mesh.py::shard_batch``: a global batch
        is cut to them, a batch that is already this rank's share passes),
        host to device with few bytes (the JAX trainer's
        ``shard_batch``): boolean and 0/1 masks travel as uint8 and are cast
        in the loss; with ``tcfg.gt_downscale = k > 1`` the GT tensors are
        subsampled k-fold per axis on the host first (the SSI loss is scale
        and shift invariant and the masked BCE is a mean, so the loss
        statistics hold on the subsampled pixels). On a card the host
        arrays go through pinned memory and ``non_blocking`` copies.
        Tensors already on the device pass through untouched."""
        batch = mesh_lib.shard_batch({k: batch[k] for k in BATCH_KEYS if k in batch},
                                     self.mesh, self.tcfg.batch_size)
        out = {}
        ds = max(int(self.tcfg.gt_downscale), 1)
        for k in BATCH_KEYS:
            if k not in batch:
                continue
            arr = batch[k]
            if isinstance(arr, torch.Tensor) and arr.device.type == self.device.type:
                out[k] = arr
                continue
            arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
            if ds > 1 and k != "image":
                arr = arr[..., ::ds, ::ds]
            if arr.dtype == bool:
                arr = arr.astype(np.uint8)
            elif k in ("seg", "mask_disp", "mask_seg") and np.all((arr == 0) | (arr == 1)):
                arr = arr.astype(np.uint8)
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # -- LR control ----------------------------------------------------

    def on_plateau_metric(self, state: TrainState, metric: float) -> TrainState:
        state.learning_rate = self.scheduler.step(metric)
        return state
