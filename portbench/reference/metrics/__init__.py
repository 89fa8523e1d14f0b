"""The five metrics of the reference, scored in chunks of one bucket.

Frozen copies of the port's metric code (`estoi.py`, `siib.py`, `haspi/`,
`pesq.py`, `visqol.py`, `_framing.py`, `calibrate.py`), with PESQ's and
HASPI's recurrences on the host (`reference/iir.py`).  `score_rows`
follows the port's corpus scoring (`metrics.score_corpus`), without its
caches: the signals zero-padded to the next multiple of 16384 samples and
scored eight rows of one bucket at a time, each with its valid length,
SIIB on the clean row tiled to about 25 s of active speech.  (The port's unpadded `score_pair` differs from it: its
HASPI reads a few 1e-3 apart on utterances of 1-3 s.)  The
intelligibility metrics hear enhanced + noise, the quality metrics the
enhanced signal alone, and ``norm=True`` applies the logistic
calibrations that turn a raw score into a discriminator target.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.config import MetricCalibration
from portbench.reference.metrics.calibrate import make_mappers_np
from portbench.reference.metrics.estoi import estoi_10k
from portbench.reference.metrics.haspi import haspi_v2_24k, resample_to_24k
from portbench.reference.metrics.pesq import pesq_p862_16k
from portbench.reference.metrics.siib import HOP as SIIB_HOP
from portbench.reference.metrics.siib import _vad_mask, siib_gauss_16k
from portbench.reference.metrics.visqol import visqol_speech_16k
from portbench.reference.resample import resample_poly

ALL_METRICS = ("siib", "haspi", "estoi", "pesq", "visqol")
BUCKET = 16384
MAX_TILED = 2_097_152


def siib_tiled_length(clean: np.ndarray, fs: int = 16000) -> int:
    """The tile-to-20-s rule's length of an utterance, capped."""
    n = len(clean)
    active = _vad_mask(clean).sum() / (fs / SIIB_HOP)
    m_fac = (max(int(np.floor(25.0 / max(active, 0.25))), 1)
             if active < 20 else 1)
    return min(m_fac, max(MAX_TILED // max(n, 1), 1)) * n


def _tile(sig: torch.Tensor, nv: torch.Tensor, sv: torch.Tensor, sb: int):
    pos = torch.arange(sb, device=sig.device)
    idx = pos[None, :] % torch.clamp_min(nv, 1)[:, None]
    return torch.gather(sig, 1, idx) * (pos[None, :] < sv[:, None]).to(
        sig.dtype)


def score_rows(triples, device, norm: bool = True,
               calib: MetricCalibration = MetricCalibration(),
               fs: int = 16000, chunk: int = 8) -> np.ndarray:
    """[len(triples), 5] scores (siib, haspi, estoi, pesq, visqol) of
    (clean, noise, enhanced) host float32 triples, each trimmed to its
    shortest signal, scored `chunk` rows of one bucket at a time."""
    lens = [min(len(c), len(n), len(e)) for c, n, e in triples]
    out = np.zeros((len(triples), len(ALL_METRICS)))
    buckets = {}
    for i, n in enumerate(lens):
        buckets.setdefault(-(-n // BUCKET) * BUCKET, []).append(i)
    for blen, idxs in sorted(buckets.items()):
        for j in range(0, len(idxs), chunk):
            rows = idxs[j:j + chunk]
            out[rows] = _score_chunk([triples[i] for i in rows],
                                     [lens[i] for i in rows], blen, device,
                                     fs)
    if norm:
        mappers = make_mappers_np(calib)
        for k, m in enumerate(ALL_METRICS):
            out[:, k] = mappers[m](out[:, k])
    return out


def _score_chunk(triples, lens, blen, device, fs):
    def pack(k):
        buf = np.zeros((len(triples), blen), np.float32)
        for i, (t, n) in enumerate(zip(triples, lens)):
            buf[i, :n] = np.asarray(t[k], np.float32)[:n]
        return torch.as_tensor(buf, device=device)

    ref, noz, enh = pack(0), pack(1), pack(2)
    ne = noz + enh
    nv = torch.as_tensor(np.array(lens, np.int64), device=device)
    raw = {
        "estoi": estoi_10k(resample_poly(ref, 5, 8), resample_poly(ne, 5, 8),
                           -(-nv * 5 // 8)),
        "haspi": haspi_v2_24k(resample_to_24k(ref, 16000),
                              resample_to_24k(ne, 16000),
                              n_valid=-(-nv * 3 // 2))[0],
        "pesq": pesq_p862_16k(ref, enh, nv),
        "visqol": visqol_speech_16k(ref, enh, nv),
    }
    sv_h = [siib_tiled_length(np.asarray(t[0], np.float32)[:n], fs)
            for t, n in zip(triples, lens)]
    sb = -(-max(sv_h) // BUCKET) * BUCKET
    sv = torch.as_tensor(np.array(sv_h, np.int64), device=device)
    raw["siib"] = siib_gauss_16k(_tile(ref, nv, sv, sb), _tile(ne, nv, sv, sb),
                                 sv)
    return np.stack([torch.as_tensor(raw[m]).reshape(-1).to(torch.float64)
                     .cpu().numpy() for m in ALL_METRICS], axis=1)


def score_triple(clean, noise, enhanced, device, norm: bool = True,
                 calib: MetricCalibration = MetricCalibration(),
                 fs: int = 16000) -> np.ndarray:
    """`score_rows` of one triple -> [5]."""
    return score_rows([(clean, noise, enhanced)], device, norm, calib,
                      fs)[0]
