"""Share of the measured training window spent in the GAN steps' phases
(g_train, d_train), by the trainer's StepTimer over the window's untraced
epochs.  Layer: training loop.  Moves `train_utts_per_s`."""
from portbench.metrics import _common as _c

UNIT = "%"


def read(ctx):
    w = _c.train_window(ctx)
    if w is None:
        return None
    phases, _, window_s = w
    return 100.0 * (phases.get("g_train", 0.0)
                    + phases.get("d_train", 0.0)) / window_s
