"""Detector fine-tuning: SGD with warm-up, an EMA of the weights, checkpoints.

Counterpart of ``yolo_puncture_tpu/train/trainer.py`` (the ultralytics recipe:
SGD momentum 0.937, weight decay 5e-4, linear warm-up then a linear decay from
lr0 to lr0·lrf).  One step: the model's train-mode forward (BatchNorm on the
batch's statistics, its running statistics moved the flax way, ``nn/common.py
BatchNorm2d``), ``train/losses.py detection_loss``, the gradients, then the
optimizer chain of the JAX package as ``torch.optim.SGD``:

  * the optional global-norm clip (``optax.clip_by_global_norm``'s formula);
  * weight decay on the ≥ 2-D weights only, added to the gradient before the
    momentum (``optax.add_decayed_weights``; torch's coupled ``weight_decay``);
  * Nesterov momentum; the learning rate of ``lr_schedule`` set before each step
    (it is 0 at step 0 while warming up).

A parameter the loss does not reach gets a zero gradient, so that it still
decays and carries momentum as under optax.  Checkpoints are ``torch.save`` of
the payload the JAX trainer gives orbax (parameters, BatchNorm statistics,
step, momentum buffers, EMA) in ``{ckpt_dir}/step_{N}.pt``; ``resume`` reads
them.  ``TrainState`` holds the model's fp32 master weights (``nn/common.py
MasterWeights``): for an fp32 model its own tensors, which each step updates in
place; for a bf16 model (``dtype=torch.bfloat16``, flax's fp32 parameters under
a bf16 ``dtype``) fp32 copies that SGD, the momentum, weight decay, clipping and
the EMA act on, rounded into the model after each step, and whose fp32 values
the checkpoints hold.

``mesh`` (``parallel/mesh.py make_mesh``: one process per rank) makes the step
data-parallel, and it computes the single-process step on the global batch, as
the JAX trainer's jitted step with a sharded batch does:
``data_parallel_step`` gives each rank its slice of the global batch and runs
the step inside ``with mesh:``, where ``detection_loss``'s normalisers and
``BatchNorm2d``'s training statistics are the global batch's; the gradients of
the fp32 masters are summed over ``data`` (``reduce_gradients``; over every rank
for the layers ``shard_model`` split over ``model``) before the norm, the clip
and SGD, and the reported losses are summed too.  Every rank starts from the
first rank's weights (``replicate``) and applies the same update, so the
parameters, BatchNorm statistics, momentum and EMA stay the same on every rank.
Only the first rank prints and writes checkpoints, which hold full tensors and
load with no mesh.  ``fit`` hands every rank the whole global batch, of which
it keeps its slice: each rank loads and augments all of it, so the data
pipeline costs each rank as much as it costs one process.  Without a mesh the
step is the single-process one, unchanged.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from yolo_puncture_tpu_torch.nn.common import MasterWeights
from yolo_puncture_tpu_torch.parallel import mesh as pmesh
from yolo_puncture_tpu_torch.train.losses import DEFAULT_HYP, detection_loss


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]         # the fp32 master weights by state-dict name (an fp32 model's own tensors)
    batch_stats: Dict[str, torch.Tensor]    # its BatchNorm running statistics (live)
    opt_state: Dict[str, torch.Tensor]      # SGD momentum buffers by parameter name
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None   # exponential moving average of the parameters


def lr_schedule(lr0: float, lrf: float, total_steps: int, warmup_steps: int):
    """step → lr: linear warm-up from 0 over ``warmup_steps``, then linear from
    lr0 to lr0·lrf at ``total_steps``; in fp32, as the JAX package computes it."""
    f32 = np.float32

    def fn(step):
        step = f32(step)
        if step < warmup_steps:
            return float(f32(lr0) * step / f32(max(warmup_steps, 1)))
        frac = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
        return float(f32(lr0) * (f32(1) - frac) + f32(lr0) * f32(lrf) * frac)

    return fn


def _stat_names(model: torch.nn.Module):
    return [n for n, _ in model.named_buffers() if n.endswith(("running_mean", "running_var"))]


class Trainer:
    def __init__(
        self,
        model,
        nc: int,
        imgsz: int = 640,
        lr0: float = 0.01,
        lrf: float = 0.01,
        momentum: float = 0.937,
        weight_decay: float = 5e-4,
        total_steps: int = 10_000,
        warmup_steps: int = 300,
        hyp: Optional[Dict[str, float]] = None,
        mesh=None,
        ema_decay: float = 0.9999,
        use_ema: bool = True,
        seed: int = 0,
        clip_norm: float = 0.0,
    ):
        self.model = model
        self.mesh = mesh
        self.nc = nc
        self.imgsz = imgsz
        self.hyp = hyp or dict(DEFAULT_HYP)
        self.schedule = lr_schedule(lr0, lrf, total_steps, warmup_steps)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.ema_decay = ema_decay
        self.use_ema = use_ema
        self.clip_norm = clip_norm
        self._seed = seed
        self.opt = None
        self.weights = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init_state(self, example_batch=None) -> TrainState:
        """The model's weights as they are (its constructor's seeded init or loaded
        weights, fp32 as ``fp32_value`` gives them: the JAX trainer draws them from
        ``PRNGKey(seed)`` here), zero momentum, step 0."""
        self.weights = MasterWeights(self.model)
        named = self.weights.named
        if self.mesh is not None:
            pmesh.replicate(self.mesh, list(named.values()) + [b for _, b in self.model.named_buffers()])
            self.weights.copy_to_module()
        decay = [p for p in named.values() if p.ndim >= 2]
        no_decay = [p for p in named.values() if p.ndim < 2]
        self.opt = torch.optim.SGD(
            [{"params": decay, "weight_decay": self.weight_decay}, {"params": no_decay, "weight_decay": 0.0}],
            lr=0.0, momentum=self.momentum, nesterov=True)
        for p in named.values():
            self.opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        buffers = dict(self.model.named_buffers())
        return TrainState(
            params=named,
            batch_stats={n: buffers[n] for n in _stat_names(self.model)},
            opt_state={n: self.opt.state[p]["momentum_buffer"] for n, p in named.items()},
            step=0,
            ema_params={n: p.detach().clone() for n, p in named.items()} if self.use_ema else None,
        )

    @staticmethod
    def _quantize_for_transfer(batch):
        """Images and masks in [0, 1] as uint8 (the JAX trainer ships them so and
        divides by 255 in the step): lossless for the augmentation's output and
        {0, 1} masks, ≤ 1/510 for other floats; images outside [0, 1] go as they are."""
        im = batch.get("images")
        out = None
        if isinstance(im, np.ndarray) and im.dtype == np.float32 and im.size and 0.0 <= im.min() and im.max() <= 1.0:
            out = dict(batch)
            out["images"] = np.round(im * 255.0).astype(np.uint8)
        gm = batch.get("gt_masks")
        if isinstance(gm, np.ndarray) and gm.dtype == np.float32 and gm.size and 0.0 <= gm.min() and gm.max() <= 1.0:
            out = out if out is not None else dict(batch)
            out["gt_masks"] = np.round(gm).astype(np.uint8)
        return out if out is not None else batch

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        dev = self.device
        out = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}
        if out["images"].dtype == torch.uint8:
            out["images"] = out["images"].float() / 255.0
        if "gt_masks" in out and out["gt_masks"].dtype == torch.uint8:
            out["gt_masks"] = out["gt_masks"].float()
        return out

    def loss_and_grads(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One train-mode forward and backward: (total, losses), the gradients in
        the fp32 masters' ``.grad`` (zeros where the loss does not reach)."""
        if self.weights is None:
            self.weights = MasterWeights(self.model)
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        masters = self.weights.masters
        for p in masters:
            p.grad = None
        out = self.model(batch["images"])
        total, losses = detection_loss(out, batch, nc=self.nc, hyp=self.hyp)
        total.backward()
        self.weights.collect_grads()
        for p in masters:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return total, losses

    @property
    def is_writer(self) -> bool:
        """Whether this process prints and writes checkpoints: the first rank of a mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if self.opt is None:
            raise RuntimeError("init_state first")
        # quantised on the global batch, so that every rank decides as one process would
        batch = self._quantize_for_transfer(batch)
        if self.mesh is not None:
            return pmesh.data_parallel_step(self.mesh, self._step)(state, batch)
        return self._step(state, batch)

    def _step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = self._to_device(batch)
        total, losses = self.loss_and_grads(batch)
        if self.mesh is not None:
            pmesh.reduce_gradients(self.mesh, state.params, pmesh.sharded_parameter_names(self.model))
            summed = self.mesh.data_sum(torch.stack([v.detach() for v in losses.values()]))
            losses = dict(zip(losses, summed))
        grads = [p.grad for p in state.params.values()]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip_norm:
            # optax.clip_by_global_norm: g · clip / ‖g‖ where ‖g‖ ≥ clip
            scale = torch.where(grad_norm < self.clip_norm, grad_norm.new_ones(()), self.clip_norm / grad_norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(state.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.weights.copy_to_module()
        if state.ema_params is not None:
            # ultralytics' ModelEMA ramp: d = decay · (1 − e^(−step/2000))
            d = float(np.float32(self.ema_decay) * (1.0 - np.exp(np.float32(-(state.step + 1) / 2000.0))))
            with torch.no_grad():
                ema = list(state.ema_params.values())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [p.detach() for p in state.params.values()], alpha=1.0 - d)
        self.model.eval()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["lr"] = lr
        metrics["grad_norm"] = grad_norm.detach()
        state.step += 1
        return state, metrics

    def fit(
        self,
        dataset,
        epochs: int = 1,
        batch_size: int = 8,
        log_every: int = 10,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 1000,
        resume: Optional[str] = None,
        close_mosaic: int = 10,
    ) -> TrainState:
        state = None
        step = 0
        restored = self.load_checkpoint(resume) if resume else None
        for epoch in range(epochs):
            # no mosaic in the last ``close_mosaic`` epochs of a run longer than that
            if close_mosaic and epochs > close_mosaic and epochs - epoch <= close_mosaic \
                    and getattr(dataset, "mosaic", 0):
                dataset.mosaic = 0.0
            for batch in dataset.batches(batch_size):
                if state is None:
                    state = self.init_state(batch)
                    if restored is not None:
                        self.restore(state, restored)
                        step = state.step
                state, metrics = self.train_step(state, batch)
                step += 1
                if step % log_every == 0 and self.is_writer:
                    m = {k: float(v) for k, v in metrics.items()}
                    print(
                        f"epoch {epoch} step {step}: total={m['total']:.3f} "
                        f"box={m['box']:.3f} cls={m['cls']:.3f} dfl={m['dfl']:.3f}"
                        + (f" seg={m['seg']:.3f}" if "seg" in m else "")
                    )
                if ckpt_dir and step % ckpt_every == 0:
                    self.save_checkpoint(state, ckpt_dir)
        if ckpt_dir and state is not None:
            self.save_checkpoint(state, ckpt_dir)
        return state

    # -- checkpoints ---------------------------------------------------------

    @staticmethod
    def _host(tree):
        return None if tree is None else {k: v.detach().cpu().clone() for k, v in tree.items()}

    def save_checkpoint(self, state: TrainState, ckpt_dir: str) -> Optional[str]:
        """``{ckpt_dir}/step_{N}.pt``; under a mesh only the first rank writes (the
        others return None)."""
        if not self.is_writer:
            return None
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(ckpt_dir, f"step_{int(state.step)}.pt"))
        payload = {
            "params": self._host(state.params),
            "batch_stats": self._host(state.batch_stats),
            "step": int(state.step),
            "opt_state": self._host(state.opt_state),    # SGD momentum: a resume must not reset it
        }
        if state.ema_params is not None:
            payload["ema_params"] = self._host(state.ema_params)
        torch.save(payload, path)
        return path

    @staticmethod
    def load_checkpoint(path: str) -> Dict[str, Any]:
        """A checkpoint file, or the newest ``step_N.pt`` of a directory."""
        return torch.load(latest_checkpoint(path), map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, restored: Dict[str, Any]) -> TrainState:
        """Copy a loaded payload into ``state``'s live tensors: parameters (the
        masters, then rounded into the model) and statistics, the step, the EMA (or
        the parameters where the payload has none), and the momentum buffers where
        it has them."""
        with torch.no_grad():
            for tree, src in ((state.params, restored["params"]), (state.batch_stats, restored.get("batch_stats", {}))):
                for n, t in src.items():
                    tree[n].copy_(t)
            if state.ema_params is not None:
                for n, t in (restored.get("ema_params") or restored["params"]).items():
                    state.ema_params[n].copy_(t)
            for n, t in (restored.get("opt_state") or {}).items():
                state.opt_state[n].copy_(t)
        if self.weights is not None:
            self.weights.copy_to_module()
        state.step = int(restored.get("step", 0))
        return state


def latest_checkpoint(path: str) -> str:
    """``path`` itself, or for a directory its ``step_N.pt`` with the largest N."""
    if not os.path.isdir(path):
        return path
    found = sorted(glob.glob(os.path.join(path, "step_*.pt")),
                   key=lambda p: int(re.search(r"step_(\d+)\.pt$", p).group(1)))
    if not found:
        raise FileNotFoundError(f"no step_N.pt checkpoint in {path}")
    return found[-1]
