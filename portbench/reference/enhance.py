"""The reference side of the enhancement cell's comparison.

From the raw PCM16 rows the benchmark made and the seed alone: the
generator drawn from the seed (`models.draw_models`, the port's order and
float64 host draw), each batch reflect-padded, featurized with the plain
IMCRA loop, enhanced and quantized as the PCM16 writer rounds
(`reference/pipeline.py`).  `precision="lower"` computes the same with
TF32 on: the control.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from portbench.reference import models
from portbench.reference.config import config_from_dict
from portbench.reference.pipeline import (enhance_batch, featurize_batch,
                                          pcm16_quantize_i16,
                                          reflect_pad_batch)


class Reference:

    def __init__(self, config: dict, seed: int, pool: list, device):
        self.cfg = config_from_dict(config)
        self.seed = int(seed)
        self.pool = pool
        self.dev = torch.device(device)

    @contextlib.contextmanager
    def precision(self, which: str):
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        lower = which == "lower"
        torch.backends.cuda.matmul.allow_tf32 = lower
        torch.backends.cudnn.allow_tf32 = lower
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    @torch.no_grad()
    def batch(self, gen, k: int) -> np.ndarray:
        _, _, _, clean, noise, lens, blen = self.pool[k]
        cp, ln = reflect_pad_batch([clean[i, :lens[i]]
                                    for i in range(len(lens))], blen)
        npad, _ = reflect_pad_batch([noise[i, :lens[i]]
                                     for i in range(len(lens))], blen)
        feats = featurize_batch(cp, npad, ln, self.cfg.train.p_power,
                                self.cfg.imcra, device=self.dev)
        wav, _, _ = enhance_batch(gen, feats, self.cfg.train.p_power,
                                  self.cfg.train.target_rms, device=self.dev)
        return pcm16_quantize_i16(wav).cpu().numpy()

    def records(self, kept: Dict[tuple, np.ndarray],
                precision: str = "stated", fault: str | None = None) -> dict:
        """{"pcm": {key: int16 rows}} for every kept (index, batch) key.
        `fault` plants one of the faults the limits are read against:
        "half_batch" (the second half of each batch's rows left out) or
        "altered_answer" (ten samples of the first row 40 LSB up)."""
        with self.precision(precision):
            gen = models.draw_models(self.cfg.model, self.seed, self.dev)[0]
            outs = {k: self.batch(gen, k) for k in sorted({k for _, k in kept})}
        for k, out in outs.items():
            if fault == "half_batch":
                out[out.shape[0] // 2:] = 0
            elif fault == "altered_answer":
                out[0, 1000:1010] += 40
        return {"pcm": {key: outs[key[1]] for key in kept}}
