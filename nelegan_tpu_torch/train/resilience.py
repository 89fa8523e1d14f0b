"""Elastic training recovery: survive transient runtime failures.

Counterpart of `nelegan_tpu/train/resilience.py`.  The reference has no
failure handling: any exception kills the run, and a restart means
re-running the script after uncommenting its checkpoint-loading block
(reference: train_nele.py:76-85).

`run_with_recovery` wraps the Trainer loop with bounded retries: on any
exception (a CUDA error counts like any other) it builds the Trainer anew
(fresh device tensors: state from a failed attempt is not reused), resumes
from the latest complete-state checkpoint (parameters, Adam, RNG streams,
epoch and replay, so recovery is exact up to the failed epoch) and
continues.

Under torchrun an in-process retry cannot rebuild a world: the peers of a
failed rank sit in a collective that never completes.  torchrun's elastic
agent (`--max-restarts R`) kills every worker when one fails and starts
the whole world again, up to R times; each worker reads its attempt from
TORCHELASTIC_RESTART_COUNT.  `resume_after_restart` is that form's
counterpart of the retry above: on a restarted attempt every rank resumes
the same latest checkpoint, under the same rule and message.
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Callable, Optional


def run_with_recovery(make_trainer: Callable[[], "Trainer"],
                      epochs: Optional[int] = None,
                      max_retries: int = 5,
                      backoff_seconds: float = 20.0,
                      verbose_timing: bool = False):
    """Run a Trainer to completion, rebuilding and resuming on failures.

    Args:
      make_trainer: zero-argument factory of a fresh Trainer.
      epochs: forwarded to Trainer.run.
      max_retries: failed attempts allowed beyond the first.
    Returns:
      the (last) Trainer after a successful run.
    Raises:
      the last exception if every attempt fails.
    """
    last_exc: Optional[BaseException] = None
    for attempt in range(max_retries + 1):
        try:
            # the factory runs inside the retry too: device initialisation
            # can itself fail transiently
            trainer = make_trainer()
            if attempt > 0:
                _resume_latest(trainer, attempt, _has_latest(trainer))
            trainer.run(epochs, verbose_timing=verbose_timing)
            return trainer
        except KeyboardInterrupt:
            raise
        except Exception as exc:  # noqa: BLE001 — transient runtime faults
            last_exc = exc
            traceback.print_exc()
            print(f"[recovery] attempt {attempt + 1} failed "
                  f"({type(exc).__name__}); retrying in "
                  f"{backoff_seconds:.0f}s", flush=True)
            time.sleep(backoff_seconds)
    raise last_exc


def _has_latest(trainer) -> bool:
    return os.path.exists(os.path.join(trainer.paths.checkpoints, "latest"))


def _resume_latest(trainer, attempt: int, exists: bool) -> Optional[int]:
    """Resume `trainer` from its latest checkpoint if there is one (a fault
    in epoch 1 leaves none: the attempt starts afresh) -> the epoch it
    resumed at, or None."""
    if not exists:
        return None
    trainer.resume(truncate_log=True)
    print(f"[recovery] attempt {attempt + 1}: resumed at epoch "
          f"{trainer.start_epoch}", flush=True)
    return trainer.start_epoch


def restart_count() -> int:
    """How often torchrun's elastic agent has restarted this world: 0 on
    the first attempt, and outside torchrun."""
    return int(os.environ.get("TORCHELASTIC_RESTART_COUNT", "0"))


def check_restart_budget(max_retries: int) -> None:
    """Refuse `max_retries` retries of a torchrun world whose agent
    restarts it fewer times (TORCHELASTIC_MAX_RESTARTS, torchrun's
    --max-restarts): fewer retries than asked must not pass silently."""
    have = os.environ.get("TORCHELASTIC_MAX_RESTARTS")
    if have is None or int(have) < max_retries:
        raise SystemExit(
            f"--max-retries {max_retries} in a torchrun world needs torchrun "
            f"--max-restarts {max_retries} or more (it has "
            f"{have if have is not None else 'no agent restarts'}): the "
            f"agent restarts the world, the CLI resumes it")


def resume_after_restart(trainer) -> Optional[int]:
    """On an attempt that torchrun's agent restarted, resume every rank of
    the world from the same latest checkpoint (rank 0 decides whether one
    exists and tells the others) -> the epoch it resumed at; None on the
    first attempt, or with no checkpoint yet (the world starts afresh)."""
    attempt = restart_count()
    if attempt == 0:
        return None
    exists = _has_latest(trainer)
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        flag = [exists]
        dist.broadcast_object_list(flag, src=0)
        exists = flag[0]
    return _resume_latest(trainer, attempt, exists)
