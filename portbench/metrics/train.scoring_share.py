"""Share of the measured training window spent in the scoring phases of
`Trainer.run_epoch` (validate, score_for_d, score_drc), by the trainer's
StepTimer over the window's untraced epochs.  Layer: training loop.
Moves `train_utts_per_s`."""
from portbench.metrics import _common as _c

UNIT = "%"


def read(ctx):
    w = _c.train_window(ctx)
    if w is None:
        return None
    phases, _, window_s = w
    return 100.0 * sum(phases.get(k, 0.0) for k in
                       ("validate", "score_for_d", "score_drc")) / window_s
