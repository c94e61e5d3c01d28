"""Health-checked serving loop: failure detection and restart from a
checkpoint; port of ``tpu_flash/serving/supervisor.py``.

A supervisor wraps :meth:`Engine.step` with

- **failure detection**: a step that raises (a CUDA error, a lost host) or
  leaves an out-of-range token id marks the engine unhealthy;
- **periodic checkpoints**: atomic snapshots through
  :func:`serving.checkpoint.save_checkpoint` (a fresh step directory, then
  ``LATEST`` repointed by an atomic rename), taken between steps, the
  oldest pruned;
- **restart from a checkpoint**: on failure the engine is rebuilt from the
  latest snapshot (or fresh, when there is none) and every journaled
  request the snapshot does not know is submitted again, so no accepted
  request is lost; a speculative engine gets its draft back;
- **a submission journal**: :meth:`Supervisor.submit` records the request
  (JSONL, fsync'd) before the engine sees it.

A host loop cannot interrupt a wedged device call from inside the process,
so hang detection is cooperative: the supervisor writes each step's
deadline to ``<dir>/HEARTBEAT``; a process manager that finds it expired
kills the process, and a supervisor on the same directory resumes from the
last checkpoint and the journal (:meth:`Supervisor.resume`). Resume is
exact (byte-identical caches, sampling keyed by request and position), so
a supervised run with a crash gives the tokens of an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Callable, List, Optional

from tpu_flash_torch.serving.checkpoint import load_checkpoint, save_checkpoint
from tpu_flash_torch.serving.engine import Engine, FinishedRequest, Request

_LATEST = "LATEST"
_JOURNAL = "journal.jsonl"
_HEARTBEAT = "HEARTBEAT"


@dataclasses.dataclass
class SupervisorConfig:
    dir: str                          # checkpoints, journal and heartbeat
    checkpoint_every: int = 32        # steps between snapshots
    max_restarts: int = 3             # a run() call's
    keep_checkpoints: int = 2         # trailing snapshot directories kept
    step_timeout_s: float = 120.0     # the deadline HEARTBEAT advertises
    # chaos hook: fault_hook(step_index, engine) runs before each step;
    # raising simulates a device or host failure at that step
    fault_hook: Optional[Callable[[int, Engine], None]] = None


class Supervisor:
    """Run an :class:`Engine` under health checks and crash recovery.

    ``make_engine`` builds a fresh engine (when no checkpoint exists yet,
    also after a crash before the first snapshot); recovery otherwise goes
    through :func:`load_checkpoint`, with this ``mesh``/``tp_axis``,
    ``draft`` (re-attached to a speculative engine) and ``device``.
    """

    def __init__(
        self,
        make_engine: Callable[[], Engine],
        cfg: SupervisorConfig,
        *,
        mesh=None,
        tp_axis: str = "model",
        draft=None,
        device="cuda",
    ):
        self.cfg = cfg
        self._make_engine = make_engine
        self._mesh = mesh
        self._tp_axis = tp_axis
        self._draft = draft
        self._device = device
        os.makedirs(cfg.dir, exist_ok=True)
        self.restarts = 0
        self.step_index = 0
        self.engine = self._restore_or_fresh()

    # ---- the durable submission journal -------------------------------

    def _journal_path(self) -> str:
        return os.path.join(self.cfg.dir, _JOURNAL)

    def submit(self, req: Request) -> None:
        """Journal the request durably, then hand it to the engine."""
        with open(self._journal_path(), "a") as f:
            f.write(json.dumps(dataclasses.asdict(req)) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self.engine.submit(req)

    def _journaled_requests(self) -> List[Request]:
        path = self._journal_path()
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [Request(**json.loads(line)) for line in f if line.strip()]

    # ---- checkpoint rotation ------------------------------------------

    def _latest_path(self) -> Optional[str]:
        marker = os.path.join(self.cfg.dir, _LATEST)
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            path = os.path.join(self.cfg.dir, f.read().strip())
        return path if os.path.exists(path) else None

    def _checkpoint(self) -> None:
        # the engine cannot quiesce mid chunked prefill: the snapshot waits
        # for the next step boundary where nothing is prefilling
        if self.engine.prefilling:
            return
        name = f"step_{self.step_index:08d}"
        save_checkpoint(os.path.join(self.cfg.dir, name), self.engine)
        tmp = os.path.join(self.cfg.dir, _LATEST + ".tmp")
        with open(tmp, "w") as f:
            f.write(name)
        os.replace(tmp, os.path.join(self.cfg.dir, _LATEST))  # atomic
        self._prune(keep=name)

    def _prune(self, keep: str) -> None:
        snaps = sorted(d for d in os.listdir(self.cfg.dir)
                       if d.startswith("step_") and d != keep)
        for d in snaps[:max(0, len(snaps) - (self.cfg.keep_checkpoints - 1))]:
            shutil.rmtree(os.path.join(self.cfg.dir, d), ignore_errors=True)

    # ---- health and recovery ------------------------------------------

    def _heartbeat(self) -> None:
        tmp = os.path.join(self.cfg.dir, _HEARTBEAT + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"step": self.step_index,
                       "deadline": time.time() + self.cfg.step_timeout_s}, f)
        os.replace(tmp, os.path.join(self.cfg.dir, _HEARTBEAT))

    def _check_health(self) -> None:
        vocab = self.engine.mcfg.vocab_size
        for r in self.engine.running.values():
            tok = r.tokens[-1]
            if not 0 <= tok < vocab:
                raise RuntimeError(
                    f"decode produced out-of-vocab token {tok} "
                    f"(rid={r.rid}): device state corrupt")

    def _restore_or_fresh(self) -> Engine:
        latest = self._latest_path()
        if latest is not None:
            engine = load_checkpoint(latest, mesh=self._mesh,
                                     tp_axis=self._tp_axis, draft=self._draft,
                                     device=self._device)
            # the snapshot's name carries its step: the counter (and the
            # next snapshots' names) follow the restored state
            self.step_index = int(os.path.basename(latest).split("_")[1])
        else:
            engine = self._make_engine()
            self.step_index = 0
        # submit the journaled requests the snapshot predates (by rid,
        # against every queue the restored engine knows)
        known = ({r.rid for r in engine.waiting}
                 | {r.rid for r in engine.running.values()}
                 | {f.rid for f in engine.finished})
        for req in self._journaled_requests():
            if req.rid not in known:
                engine.submit(req)
        return engine

    def _recover(self, err: BaseException) -> None:
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            raise RuntimeError(
                f"supervisor exceeded max_restarts={self.cfg.max_restarts}"
            ) from err
        self.engine.close()
        self.engine = self._restore_or_fresh()

    # ---- the loop -----------------------------------------------------

    def resume(self, max_steps: int = 10_000) -> List[FinishedRequest]:
        """:meth:`run`, the re-entry point after an external kill (the same
        directory: the same checkpoint and journal)."""
        return self.run(max_steps)

    def run(self, max_steps: int = 10_000) -> List[FinishedRequest]:
        steps = 0
        eng = self.engine
        while (eng.waiting or eng.running or eng.prefilling) and steps < max_steps:
            self._heartbeat()
            try:
                if self.cfg.fault_hook is not None:
                    self.cfg.fault_hook(self.step_index, eng)
                eng.step()
                self._check_health()
            except Exception as e:  # any failure: recover
                self._recover(e)
                eng = self.engine
                continue
            self.step_index += 1
            steps += 1
            if (self.cfg.checkpoint_every
                    and self.step_index % self.cfg.checkpoint_every == 0):
                self._checkpoint()
        eng.flush()  # commit any async round left in flight
        return eng.finished
