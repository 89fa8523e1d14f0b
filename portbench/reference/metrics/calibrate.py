"""Logistic score calibrations mapping raw metrics into [0, 1] GAN targets.

Counterpart of `nelegan_tpu/metrics/calibrate.py` (reference: intel.py:
102-160, audio_util.py:259-262): each raw score passes through
1 / (1 + exp(a * (x - b))) before it becomes a discriminator target.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.config import MetricCalibration

_NAMES = ("siib", "haspi", "estoi", "pesq", "visqol")


def logistic(x, a: float, b: float):
    return 1.0 / (1.0 + torch.exp(a * (torch.as_tensor(x) - b)))


def logistic_np(x, a: float, b: float):
    """Host-side logistic for scores already fetched."""
    return 1.0 / (1.0 + np.exp(a * (np.asarray(x, np.float64) - b)))


def make_mappers_np(calib: MetricCalibration = MetricCalibration()):
    return {name: (lambda x, ab=getattr(calib, name): logistic_np(x, *ab))
            for name in _NAMES}


def make_mappers(calib: MetricCalibration = MetricCalibration()):
    return {name: (lambda x, ab=getattr(calib, name): logistic(x, *ab))
            for name in _NAMES}
