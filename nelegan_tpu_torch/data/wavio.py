"""Wav I/O: ctypes bindings of the native reader, and a scipy plain version.

Counterpart of `nelegan_tpu/data/wavio.py`.  The native library is the
port's own copy of the reader, `nelegan_tpu_torch/csrc/wavio.cpp`, built on
first use with ``g++ -O2 -shared -fPIC`` into ``build/nelegan_tpu_torch/``
under a name keyed by the source's hash (as `kernels` keys its CUDA
libraries), so an edited source is rebuilt.  A failed build raises.  Every
reader takes ``native=False`` for the plain version (scipy), which the tests
hold the native one against; nothing falls back to it on its own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Sequence, Tuple

import numpy as np

from nelegan_tpu_torch.kernels import BUILD_DIR, CSRC

_SRC = CSRC / "wavio.cpp"
_FLAGS = ("-O2", "-shared", "-fPIC")
_lib = None
_lock = threading.Lock()
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path():
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libwavio-{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile csrc/wavio.cpp unless it is built; returns the library's
    path.  Raises if g++ fails."""
    out = library_path()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("wavio: g++ not found; the native reader is built "
                           "on first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"wavio: g++ exited {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.wavio_read.restype = ctypes.c_int32
            lib.wavio_read.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int32,
                                       _I32P]
            lib.wavio_length.restype = ctypes.c_int32
            lib.wavio_length.argtypes = [ctypes.c_char_p]
            lib.wavio_read_batch.restype = None
            lib.wavio_read_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, _F32P,
                ctypes.c_int32, _I32P, _I32P, ctypes.c_int32]
            lib.wavio_write_pcm16.restype = ctypes.c_int32
            lib.wavio_write_pcm16.argtypes = [ctypes.c_char_p, _F32P,
                                              ctypes.c_int32, ctypes.c_int32]
            _lib = lib
    return _lib


def _read_plain(path: str) -> Tuple[np.ndarray, int]:
    import scipy.io.wavfile
    rate, data = scipy.io.wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, rate


def read_wav(path: str, native: bool = True) -> Tuple[np.ndarray, int]:
    """-> (float32 samples scaled like librosa.load(sr=None), sample rate)."""
    if not native:
        return _read_plain(path)
    lib = _load()
    n = lib.wavio_length(path.encode())
    if n < 0:
        raise IOError(f"cannot read wav: {path}")
    out = np.zeros(n, np.float32)
    rate = ctypes.c_int32(0)
    got = lib.wavio_read(path.encode(), out.ctypes.data_as(_F32P), n,
                         ctypes.byref(rate))
    if got < 0:
        raise IOError(f"cannot decode wav: {path}")
    return out[:got], rate.value


def wav_length(path: str, native: bool = True) -> int:
    if not native:
        return len(_read_plain(path)[0])
    n = _load().wavio_length(path.encode())
    if n < 0:
        raise IOError(f"cannot read wav: {path}")
    return n


def read_wav_batch(paths: Sequence[str], max_len: int, n_threads: int = 8,
                   native: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (wavs [B, max_len] zero-padded, lengths [B], rates [B]); the
    native reader decodes the files on `n_threads` threads."""
    b = len(paths)
    out = np.zeros((b, max_len), np.float32)
    lengths = np.zeros(b, np.int32)
    rates = np.zeros(b, np.int32)
    if native:
        arr = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
        _load().wavio_read_batch(arr, b, out.ctypes.data_as(_F32P), max_len,
                                 lengths.ctypes.data_as(_I32P),
                                 rates.ctypes.data_as(_I32P), n_threads)
        bad = np.nonzero(lengths < 0)[0]
        if bad.size:
            raise IOError("cannot decode wav(s): "
                          + ", ".join(paths[i] for i in bad[:4]))
    else:
        for i, p in enumerate(paths):
            w, r = _read_plain(p)
            m = min(len(w), max_len)
            out[i, :m] = w[:m]
            lengths[i] = m
            rates[i] = r
    return out, lengths, rates


def pcm16_samples(data: np.ndarray) -> np.ndarray:
    """The int16 samples of a PCM16 file of float `data`: clip to [-1, 1],
    scale by 32768 and clamp to 32767 in float32, then round half away from
    zero (libsndfile's PCM16 write, as csrc/wavio.cpp does it)."""
    v = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    s = np.minimum(v * np.float32(32768.0), np.float32(32767.0))
    half = np.float32(0.5)
    return np.where(s >= 0, np.trunc(s + half),
                    np.trunc(s - half)).astype(np.int16)


def write_wav_pcm16(path: str, data: np.ndarray, fs: int = 16000,
                    native: bool = True) -> None:
    """Mono PCM16 wav of `data`.  int16 data is written as it is (samples
    already quantized, e.g. `pipeline.pcm16_quantize_i16` fetched from the
    device at half the bytes); float data is clipped and rounded as
    `pcm16_samples` does, natively or with scipy: the same bytes."""
    import scipy.io.wavfile
    if data.dtype == np.int16:
        scipy.io.wavfile.write(path, fs, np.ascontiguousarray(data))
        return
    data = np.ascontiguousarray(data, np.float32)
    if not native:
        scipy.io.wavfile.write(path, fs, pcm16_samples(data))
        return
    n = _load().wavio_write_pcm16(path.encode(), data.ctypes.data_as(_F32P),
                                  len(data), fs)
    if n != len(data):
        raise IOError(f"cannot write wav: {path}")
