"""Training driver: the loop, meters, checkpoints and auto-resume.

Counterpart of efficientsam3_tpu/train/trainer.py. The caller gives a
``train_step(model, optimizer, batch) -> metrics`` (``train/stage3.py``'s
``stage3_train_step``) and a batch iterator; the driver owns the loop,
logging (meters, and a JSONL + TensorBoard sink with ``log_dir``),
periodic and final checkpoints (partial with ``save_param_prefixes``),
auto-resume from the latest saved step, and graceful preemption: on
SIGTERM / SIGUSR1 it finishes the step in flight, checkpoints and stops.

A checkpoint holds the saved parameters, every BatchNorm statistic and the
optimizer's state, so a resumed run continues exactly; a partial one drops
the parameters outside the prefixes (the frozen heads), whose values the
resuming model must already hold.

Data parallelism: with ``mesh`` (a ``parallel.make_mesh`` mesh holding
``batch_axis``) the Trainer broadcasts the parameters and buffers from the
axis's first rank once, gives each rank its slice of every batch, and runs
the step under ``parallel.sharding.data_parallel``: BatchNorm statistics
and the Stage-3 box count are the global batch's, and every gradient is
averaged over the group at the end of the backward, before the step's
grad norm and clip, so the update is the JAX package's on the global
batch. The steps call the model's sub-methods, so this is not
``DistributedDataParallel``. Checkpoints and the metrics sink are written
by the first rank; logged metrics are the group's mean.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from efficientsam3_tpu_torch.parallel.sharding import data_parallel, replicate, shard_batch
from efficientsam3_tpu_torch.utils.checkpoint import (
    latest_step,
    load_checkpoint,
    load_model_state,
    model_state,
    save_checkpoint,
)
from efficientsam3_tpu_torch.utils.observability import LOG, MeterBank, MetricsWriter


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int
    log_every: int = 50
    checkpoint_every: int = 1000
    checkpoint_dir: Optional[str] = None
    save_param_prefixes: Optional[tuple] = None  # partial checkpoints
    mesh: Optional[object] = None
    batch_axis: str = "dp"
    log_dir: Optional[str] = None  # JSONL + TensorBoard metrics
    handle_preemption_signals: bool = True


class Trainer:
    def __init__(self, train_step: Callable, cfg: TrainerConfig,
                 eval_fn: Optional[Callable] = None):
        if cfg.mesh is not None and cfg.batch_axis not in cfg.mesh.mesh_dim_names:
            raise ValueError(f"batch axis {cfg.batch_axis!r} not in the mesh's axes "
                             f"{cfg.mesh.mesh_dim_names}")
        self.train_step = train_step
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.meters = MeterBank()
        self.preempted = False
        if cfg.handle_preemption_signals:
            self._install_signal_handlers()
        self.lead = not dist.is_initialized() or dist.get_rank() == 0
        self.writer = (MetricsWriter(cfg.log_dir)
                       if cfg.log_dir is not None and self.lead else None)

    def _install_signal_handlers(self):
        """SIGTERM / SIGUSR1 set the preemption flag; ``run`` then stops
        after the step in flight and checkpoints. Only from the main
        thread; skipped elsewhere."""
        if threading.current_thread() is not threading.main_thread():
            return

        def _flag(signum, frame):
            LOG.info("preemption signal %d: will checkpoint and stop", signum)
            self.preempted = True

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            signal.signal(sig, _flag)

    @staticmethod
    def _state(model, optimizer) -> dict:
        return dict(model_state(model), opt_state=optimizer.state_dict())

    def resume(self, model, optimizer) -> int:
        """Load the latest checkpoint into model and optimizer; its step, or
        0 when there is none."""
        if self.cfg.checkpoint_dir is None:
            return 0
        state, step = load_checkpoint(self.cfg.checkpoint_dir, map_location="cpu")
        if state is None:
            return 0
        load_model_state(model, state, f"checkpoint step {step}")
        optimizer.load_state_dict(state["opt_state"])
        LOG.info("resumed from step %d", step)
        return step

    def _save(self, step, model, optimizer):
        save_checkpoint(self.cfg.checkpoint_dir, step, self._state(model, optimizer),
                        param_prefixes=self.cfg.save_param_prefixes)

    def run(self, model, optimizer, batches: Iterable[dict]) -> int:
        """Train until max_steps (or preemption) from the latest checkpoint;
        returns the step reached."""
        cfg = self.cfg
        step = start = self.resume(model, optimizer)
        grad_mean = None
        if cfg.mesh is not None:
            group = cfg.mesh.get_group(cfg.batch_axis)
            replicate(cfg.mesh, cfg.batch_axis)(model)
            place = shard_batch(cfg.mesh, cfg.batch_axis)
            grad_mean = _GradMean(model, group)
        t_last = time.perf_counter()
        try:
            for batch in batches:
                stop = self.preempted  # read once: a signal may set it while we agree
                if grad_mean is not None:  # every rank stops on the same step
                    stop = grad_mean.any_rank(stop)
                if stop:
                    self.preempted = True
                if step >= cfg.max_steps or stop:
                    break
                if grad_mean is None:
                    metrics = self.train_step(model, optimizer, batch)
                else:
                    with data_parallel(group):
                        metrics = self.train_step(model, optimizer, place(batch))
                step += 1
                if step % cfg.log_every == 0:
                    if grad_mean is not None:
                        metrics = grad_mean.mean_metrics(metrics)
                    metrics = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    sps = cfg.log_every / (now - t_last)
                    t_last = now
                    self.meters.update(steps_per_s=sps, **metrics)
                    self.meters.log(step, cfg.max_steps)
                    if self.writer is not None:
                        self.writer.write(step, dict(metrics, steps_per_s=sps))
                if (cfg.checkpoint_dir is not None and step % cfg.checkpoint_every == 0
                        and self.lead):
                    self._save(step, model, optimizer)
                if self.eval_fn is not None and step % cfg.checkpoint_every == 0:
                    self.eval_fn(model, step)
        finally:
            if grad_mean is not None:
                grad_mean.remove()
        if cfg.checkpoint_dir is not None and step > start and self.lead:
            self._save(step, model, optimizer)
        return step


class _GradMean:
    """Averages every trained parameter's gradient over a group at the end
    of each backward (an autograd engine callback queued by the first
    gradient accumulated), in one flat all-reduce per dtype and device. A
    group of one has nothing to average: no hook is registered."""

    def __init__(self, model, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.device = self.params[0].device if self.params else torch.device("cpu")
        self.queued = False
        self.handles = [] if self.size == 1 else [
            p.register_post_accumulate_grad_hook(self._on_grad) for p in self.params]

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the group."""
        if self.size == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def _on_grad(self, _):
        if not self.queued:
            self.queued = True
            torch.autograd.Variable._execution_engine.queue_callback(self._reduce)

    @torch.no_grad()
    def _reduce(self):
        self.queued = False
        buckets = {}
        for p in self.params:
            buckets.setdefault((p.dtype, p.device), []).append(p)
        for ps in buckets.values():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.size)
            offset = 0
            for p, g in zip(ps, grads):
                part = flat[offset:offset + g.numel()].view_as(g)
                offset += g.numel()
                if p.grad is not None:
                    p.grad.copy_(part)
                elif part.any():  # another rank's gradient reached it
                    p.grad = part.clone()

    def mean_metrics(self, metrics: dict) -> dict:
        """The group's mean of each 0-d metric."""
        if self.size == 1:
            return metrics
        keys = sorted(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k]).float() for k in keys])
        dist.all_reduce(vals, group=self.group)
        return dict(zip(keys, (vals / self.size).tolist()))

    def remove(self):
        for h in self.handles:
            h.remove()
