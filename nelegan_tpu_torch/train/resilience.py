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
            latest = os.path.join(trainer.paths.checkpoints, "latest")
            if attempt > 0 and os.path.exists(latest):
                trainer.resume(truncate_log=True)
                print(f"[recovery] attempt {attempt + 1}: resumed at epoch "
                      f"{trainer.start_epoch}", flush=True)
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
