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
resuming model must already hold. Data parallelism over a mesh is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Iterable, Optional

from efficientsam3_tpu_torch.utils.checkpoint import latest_step, load_checkpoint, save_checkpoint
from efficientsam3_tpu_torch.utils.observability import LOG, MeterBank, MetricsWriter


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int
    log_every: int = 50
    checkpoint_every: int = 1000
    checkpoint_dir: Optional[str] = None
    save_param_prefixes: Optional[tuple] = None  # partial checkpoints
    mesh: Optional[object] = None
    log_dir: Optional[str] = None  # JSONL + TensorBoard metrics
    handle_preemption_signals: bool = True


class Trainer:
    def __init__(self, train_step: Callable, cfg: TrainerConfig,
                 eval_fn: Optional[Callable] = None):
        if cfg.mesh is not None:
            raise NotImplementedError(
                "data parallelism over a mesh is not ported yet (ROADMAP Queue 1 item 19)")
        self.train_step = train_step
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.meters = MeterBank()
        self.preempted = False
        if cfg.handle_preemption_signals:
            self._install_signal_handlers()
        self.writer = MetricsWriter(cfg.log_dir) if cfg.log_dir is not None else None

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
        return {"params": {k: p.detach() for k, p in model.named_parameters()},
                "batch_stats": {k: b for k, b in model.named_buffers()},
                "opt_state": optimizer.state_dict()}

    def resume(self, model, optimizer) -> int:
        """Load the latest checkpoint into model and optimizer; its step, or
        0 when there is none."""
        if self.cfg.checkpoint_dir is None:
            return 0
        state, step = load_checkpoint(self.cfg.checkpoint_dir, map_location="cpu")
        if state is None:
            return 0
        own = model.state_dict()
        for part in ("params", "batch_stats"):
            unknown = state[part].keys() - own.keys()
            if unknown:
                raise KeyError(f"checkpoint step {step}: {part} not in the model: "
                               f"{sorted(unknown)[:5]}")
            own.update(state[part])
        model.load_state_dict(own)
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
        t_last = time.perf_counter()
        for batch in batches:
            if step >= cfg.max_steps or self.preempted:
                break
            metrics = self.train_step(model, optimizer, batch)
            step += 1
            if step % cfg.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                sps = cfg.log_every / (now - t_last)
                t_last = now
                self.meters.update(steps_per_s=sps, **metrics)
                self.meters.log(step, cfg.max_steps)
                if self.writer is not None:
                    self.writer.write(step, dict(metrics, steps_per_s=sps))
            if cfg.checkpoint_dir is not None and step % cfg.checkpoint_every == 0:
                self._save(step, model, optimizer)
            if self.eval_fn is not None and step % cfg.checkpoint_every == 0:
                self.eval_fn(model, step)
        if cfg.checkpoint_dir is not None and step > start:
            self._save(step, model, optimizer)
        return step
