"""A synthetic PCM16 corpus made from a seed, in the training corpus layout.

A vectorised copy of the recipe of `tools/make_synth_corpus.py` (the
Harvard_SI corpus the paper trains on cannot be shared): "speech" is a
harmonic series on a drifting f0 under three formant-like resonances,
syllabic modulation, pauses and consonant-like bursts; noise is white,
pink, babble (six speech processes) or hum at -11, -7 or -3 dB; the
pre-enhanced `MultiEnh` side is a fixed high-frequency emphasis plus
dynamic-range compression of the speech.  Files are written as
``<root>/{Train,Test}/{Clean,Noise[,MultiEnh]}/s_<split>_<i>#<Kind>#<snr>.wav``.

Every seed gets the same set of sizes: the lengths are a fixed grid over
`len_s` and the noise kinds and SNRs fixed proportions, dealt out to the
utterances in an order drawn from the seed; only the order and the
signals' content change with it.  The harmonic sums run on `device` from
a `torch.Generator` there; the recursive filters run on the host
(`scipy.signal.lfilter`, a whole batch a call).
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence

import numpy as np
import torch
from scipy.io import wavfile
from scipy.signal import lfilter

FS = 16000
RMS = 0.03
NOISE_KINDS = ("White", "Pink", "Babble", "Hum")
SNRS_DB = (-11, -7, -3)


def _rms_norm(x: np.ndarray, lens: np.ndarray, rms: float = RMS) -> np.ndarray:
    """Each row scaled to RMS `rms` over its first lens[i] samples."""
    valid = np.arange(x.shape[1])[None, :] < lens[:, None]
    msq = (x * x * valid).sum(1) / np.maximum(lens, 1)
    return x / np.maximum(np.sqrt(msq), 1e-12)[:, None] * rms * valid


def _uniform(g: torch.Generator, lo, hi, n: int, dev) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=torch.float64, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=dev)
    u = torch.rand((n,) + tuple(lo.shape), generator=g, dtype=torch.float64,
                   device=dev)
    return lo + (hi - lo) * u


def synth_speech(g: torch.Generator, lens: np.ndarray, dev) -> np.ndarray:
    """[len(lens), max(lens)] float64 speech-like rows at RMS 0.03."""
    b, n = len(lens), int(lens.max())
    t = torch.arange(n, dtype=torch.float64, device=dev)[None, :] / FS
    valid = t * FS < torch.as_tensor(lens, device=dev)[:, None]
    f0 = _uniform(g, 90, 220, b, dev)[:, None] * (1.0 + 0.12 * torch.sin(
        2 * math.pi * _uniform(g, 0.2, 0.6, b, dev)[:, None] * t
        + _uniform(g, 0, 6.3, b, dev)[:, None]))
    phase = torch.cumsum(2 * math.pi * f0 / FS, dim=1)
    formants = _uniform(g, [300, 900, 2200], [800, 1800, 3400], b, dev)
    mean_f0 = (f0 * valid).sum(1) / valid.sum(1)
    x = torch.zeros(b, n, dtype=torch.float64, device=dev)
    for k in range(1, 40):
        fk = k * mean_f0
        amp = torch.exp(-0.5 * ((fk[:, None] - formants) / 300.0) ** 2).sum(1)
        w = (amp + 0.05) / k * (fk <= 7000)
        x += w[:, None] * torch.sin(k * phase)
    syl = 0.5 * (1 + torch.sin(2 * math.pi * _uniform(g, 2.5, 5.0, b, dev)
                               [:, None] * t
                               + _uniform(g, 0, 6.3, b, dev)[:, None]))
    gate = (torch.sin(2 * math.pi * _uniform(g, 0.3, 0.7, b, dev)[:, None] * t
                      + _uniform(g, 0, 6.3, b, dev)[:, None]) > -0.7)
    burst = (torch.randn(b, n, generator=g, dtype=torch.float64, device=dev)
             * (syl > 0.9) * 0.2)
    x, syl, gate, burst = (a.double().cpu().numpy()
                           for a in (x, syl, gate, burst))
    gate = lfilter([0.002], [1, -0.998], gate, axis=1)   # smooth the edges
    return _rms_norm(x * (0.15 + syl) * gate + burst, lens)


def ssdrc_like(x: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Fixed spectral shaping and compression: the pre-enhanced side."""
    emph = lfilter([1.0, -0.85], [1.0], x, axis=1)
    env = np.sqrt(lfilter([0.001], [1, -0.999], emph ** 2, axis=1) + 1e-12)
    return _rms_norm(emph * (env + 1e-4) ** -0.5 * 3e-2, lens)


def synth_noise(g: torch.Generator, kinds: Sequence[str], lens: np.ndarray,
                dev) -> np.ndarray:
    b, n = len(lens), int(lens.max())
    white = torch.randn(b, n, generator=g, dtype=torch.float64,
                        device=dev).cpu().numpy()
    out = white.copy()
    pink = lfilter([0.049922, -0.095993, 0.050612, -0.004408],
                   [1, -2.494956, 2.017265, -0.522189], white, axis=1)
    t = np.arange(n)[None, :] / FS
    hum = (np.sin(2 * np.pi * 100 * t) + 0.5 * np.sin(2 * np.pi * 200 * t)
           + 0.2 * white)
    kinds = np.asarray(kinds)
    out[kinds == "Pink"] = pink[kinds == "Pink"]
    out[kinds == "Hum"] = hum[kinds == "Hum"]
    babble = np.flatnonzero(kinds == "Babble")
    if babble.size:
        talkers = synth_speech(g, np.repeat(lens[babble], 6), dev)
        out[babble, :talkers.shape[1]] = talkers.reshape(
            babble.size, 6, -1).sum(1)
    return _rms_norm(out, lens)


def _pcm16(x: np.ndarray) -> np.ndarray:
    """The writer of `tools/make_synth_corpus.py`: clip, * 32767, truncate."""
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def deal(seed: int, n: int, len_s: Sequence[float]) -> Dict[str, list]:
    """Lengths, noise kinds and SNRs of `n` utterances: fixed sets, in an
    order drawn from `seed`."""
    rng = np.random.default_rng([seed, n])
    lens = np.round(np.linspace(len_s[0], len_s[1], n) * FS).astype(np.int64)
    kinds = [NOISE_KINDS[i % len(NOISE_KINDS)] for i in range(n)]
    snrs = [SNRS_DB[(i // len(NOISE_KINDS)) % len(SNRS_DB)] for i in range(n)]
    p = rng.permutation(n)
    q = rng.permutation(n)
    return {"lens": lens[p], "kinds": [kinds[i] for i in q],
            "snrs": [snrs[i] for i in q]}


def make_rows(seed: int, stream: int, lens: np.ndarray, kinds: Sequence[str],
              snrs: Sequence[int], device, multi_enh: bool = False
              ) -> Dict[str, np.ndarray]:
    """Clean and noise (and MultiEnh) int16 rows [len(lens), max(lens)],
    zero past each length, drawn from (`seed`, `stream`) on `device`."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(
        (int(seed) * 4 + stream) % (2 ** 63))
    speech = synth_speech(g, lens, dev)
    noise = synth_noise(g, kinds, lens, dev)
    gain = 10.0 ** (-np.asarray(snrs, np.float64) / 20.0)
    out = {"clean": _pcm16(speech), "noise": _pcm16(noise * gain[:, None])}
    if multi_enh:
        out["multi_enh"] = _pcm16(ssdrc_like(speech, lens))
    return out


def make_split(seed: int, split: str, n: int, len_s: Sequence[float],
               multi_enh: bool, device) -> Dict[str, object]:
    """The signals of one split as int16 rows (zero past each length)."""
    d = deal(seed, n, len_s)
    out = make_rows(seed, int(split == "Test"), d["lens"], d["kinds"],
                    d["snrs"], device, multi_enh)
    out["names"] = [f"s_{split.lower()}_{i:04d}#{k}#{s}.wav"
                    for i, (k, s) in enumerate(zip(d["kinds"], d["snrs"]))]
    out["lens"] = d["lens"]
    return out


def write_corpus(root: str, seed: int, n_train: int, n_test: int,
                 len_s: Sequence[float], device) -> Dict[str, str]:
    """Write the corpus under `root`; -> its directories by role."""
    dirs = {}
    for split, n, extra in (("Train", n_train, True), ("Test", n_test, False)):
        sig = make_split(seed, split, n, len_s, extra, device)
        subs = {"Clean": "clean", "Noise": "noise"}
        if extra:
            subs["MultiEnh"] = "multi_enh"
        for sub, key in subs.items():
            d = os.path.join(root, split, sub)
            os.makedirs(d, exist_ok=True)
            dirs[f"{split.lower()}_{key}"] = d
            for name, ln, row in zip(sig["names"], sig["lens"], sig[key]):
                wavfile.write(os.path.join(d, name), FS, row[:ln])
    return dirs


def read_pcm(path: str) -> np.ndarray:
    """A PCM16 wav's samples as float32 / 32768, as the port's reader
    returns them."""
    rate, x = wavfile.read(path)
    if rate != FS or x.dtype != np.int16:
        raise ValueError(f"{path}: expected 16 kHz PCM16")
    return x.astype(np.float32) / np.float32(32768.0)


def names_of(directory: str) -> List[str]:
    return sorted(f for f in os.listdir(directory) if f.endswith(".wav"))
