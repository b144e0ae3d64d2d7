"""Training loop with checkpoint/restart, straggler detection and
prefetching (``src/repro/train/loop.py``).

Fault-tolerance contract, as the reference's:

* every ``ckpt_every`` steps an async atomic checkpoint of the parameters
  and the optimizer state is written (``CheckpointManager.save_async``: a
  blocking copy to the host, then the write on a thread);
* on construction the loop resumes from the newest valid checkpoint (torn
  ones are skipped), copying the saved weights into the model's parameters
  in place and taking the saved optimizer state; with ``shardings`` each
  parameter is restored onto its placement first;
* a job rerun with the same arguments continues; the last step's state is
  saved when the loop ends, unless its step's checkpoint was just written
  (the reference writes that step twice).

Straggler mitigation: the per-step wall time's EWMA; steps slower than
``straggler_factor`` × EWMA are counted.  The data iterator runs in a
background thread (depth ``prefetch``).  The reference waits for each step
with ``jax.block_until_ready`` on the loss; here the loss is read to the
host, which waits for the step's work on the device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch._device import canonical
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim._tree import leaves, named_tensors

__all__ = ["TrainLoop", "TrainLoopConfig"]


def _state_shardings(state: Any, params: Any, shardings: Dict) -> Any:
    """The placements of an optimizer state over a rank mesh, mirroring
    ``state``: a tree keyed by parameter names (the error-feedback
    residual) takes the parameters'; one keyed by the reference's leaf
    names (the moments) its leaf's, with the layer axis first where the
    leaf is stacked; any other tensor (the step) is replicated."""
    from repro_torch.distributed.sharding import NamedSharding
    mesh = next(iter(shardings.values())).mesh
    by_leaf = {}
    for leaf in leaves(named_tensors(params)):
        sh = shardings[leaf.parts[0][0]]
        by_leaf[leaf.name] = NamedSharding(
            mesh, ((None,) + tuple(sh.spec)) if leaf.stacked else sh.spec)

    def walk(x):
        if isinstance(x, dict):
            return {k: shardings.get(k) or by_leaf.get(k) or walk(v)
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return NamedSharding(mesh, ())

    return walk(state)


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 100
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.1
    prefetch: int = 2


class _Prefetcher:
    def __init__(self, it: Iterator, depth: int):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False

        def work():
            for item in it:
                if self._stop:
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop = True
        while self.t.is_alive():     # let a blocked put finish
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self.t.join(timeout=0.01)


class TrainLoop:
    """``step_fn(params, opt_state, batch, extra) -> (params, opt_state,
    metrics)`` (``make_train_step``'s); ``params`` the model (or a mapping
    of named tensors).  ``shardings``: each parameter's
    :class:`~repro_torch.distributed.sharding.NamedSharding` by dotted name
    (``param_shardings``'s), whose mesh's first device must be the
    parameter's (``ValueError`` otherwise, or for a name that is not a
    parameter's); a restore places every parameter on it and checks that
    its spec fits (``CheckpointManager.restore``), the optimizer state
    going to the parameters' device.  On a mesh over a world of ranks every
    rank runs the loop on its blocks: the optimizer state's leaves take
    their parameters' placements (a stacked moment the layer axis first),
    a checkpoint holds the whole logical arrays (rank 0 writes them, and a
    restore gives each rank its blocks), and the log is the same on every
    rank."""

    def __init__(self, cfg: TrainLoopConfig, step_fn: Callable, params: Any,
                 opt_state: Any, shardings: Any = None):
        if shardings is not None:
            named = named_tensors(params)
            if set(shardings) != set(named):
                raise ValueError(f"shardings for "
                                 f"{sorted(set(shardings) ^ set(named))} "
                                 "missing or unknown")
            for name, sh in shardings.items():
                if canonical(sh.device) != canonical(named[name].device):
                    raise ValueError(f"{name}: placed on {sh.device}, the "
                                     f"parameter is on "
                                     f"{named[name].device}")
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.start_step = 0
        self.ckpt = (CheckpointManager(cfg.ckpt_dir)
                     if cfg.ckpt_dir else None)
        self._shardings = None
        if shardings is not None and \
                next(iter(shardings.values())).mesh.world is not None:
            self._shardings = {"params": shardings,
                               "opt": _state_shardings(opt_state, params,
                                                       shardings)}
        if self.ckpt is not None:
            named = named_tensors(params)
            device = next(iter(named.values())).device
            step, state = self.ckpt.restore_latest(
                self._state(), device,
                self._shardings or {"params": shardings, "opt": None})
            if step is not None:
                with torch.no_grad():
                    for name, t in state["params"].items():
                        named[name].copy_(t)
                self.opt_state = state["opt"]
                self.start_step = step
        self.metrics_log: list = []
        self.straggler_steps = 0
        self._ewma = None

    def _state(self) -> Dict[str, Any]:
        return {"params": named_tensors(self.params), "opt": self.opt_state}

    def run(self, data_it: Iterator, extra: Optional[Dict] = None) -> Dict:
        cfg = self.cfg
        pf = _Prefetcher(data_it, cfg.prefetch)
        step = self.start_step
        try:
            for batch in pf:
                if step >= cfg.total_steps:
                    break
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch, extra)
                loss = float(metrics["loss"])     # waits for the step
                dt = time.perf_counter() - t0
                if self._ewma is None:
                    self._ewma = dt
                else:
                    if dt > cfg.straggler_factor * self._ewma:
                        self.straggler_steps += 1   # surface to orchestrator
                    self._ewma = ((1 - cfg.ewma_alpha) * self._ewma
                                  + cfg.ewma_alpha * dt)
                step += 1
                if step % cfg.log_every == 0 or step == cfg.total_steps:
                    self.metrics_log.append(
                        {"step": step, "loss": loss, "sec_per_step": dt})
                if self.ckpt is not None and step % cfg.ckpt_every == 0:
                    self.ckpt.save_async(step, self._state(),
                                         self._shardings)
        finally:
            pf.close()
            if self.ckpt is not None:
                self.ckpt.wait()
        # the last step's state, unless its checkpoint was just written
        if self.ckpt is not None and step > self.start_step \
                and step % cfg.ckpt_every:
            self.ckpt.save(step, self._state(), self._shardings)
        return {"final_step": step, "log": self.metrics_log,
                "straggler_steps": self.straggler_steps,
                "ewma_sec_per_step": self._ewma}
