"""Shared arithmetic of the per-layer readers (not a metric: the harness
skips files whose name starts with an underscore)."""
from __future__ import annotations


def train_window(ctx):
    """The measured training window's (phase seconds, steps [(kind, rows,
    frames)], length), read in a traced run, or None."""
    w = ctx.layer.get("window")
    if not ctx.trace or w is None or "phases_s" not in w:
        return None
    return w["phases_s"], w["steps"], w["window_s"]


def enhance_batches(ctx):
    """The traced enhancement batches [(rows, frames)], or None."""
    if ctx.window is None or "batches" not in ctx.layer:
        return None
    return ctx.layer["batches"]


def idle_percent(ctx):
    w = ctx.window
    if w is None or w.window_s <= 0 or w.busy_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
