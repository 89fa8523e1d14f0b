"""Optional exact external metric engines.

Counterpart of `nelegan_tpu/metrics/oracles.py`, of which this is an own
copy (the port imports nothing of that package).  The reference's
quality and intelligibility ground truth comes from external native
engines: pypesq (intel.py:9), pysiib (intel.py:4), pystoi (intel.py:8),
and the ViSQOL C++ executable shelled out per batch
(audio_util.py:232-265).  The port trains and evaluates with its own
implementations (`metrics/`); where an engine is installed, these hooks
give its published numbers for parity tables.  Every function raises
`OracleUnavailable`, with the reference package's message, when its
engine is missing.
"""
from __future__ import annotations

import csv
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np


class OracleUnavailable(RuntimeError):
    pass


def pesq_exact(ref: np.ndarray, deg: np.ndarray, fs: int = 16000) -> float:
    """ITU-T P.862 via the pypesq C extension."""
    try:
        from pypesq import pesq
    except ImportError as e:
        raise OracleUnavailable(
            "pypesq is not installed; use metrics.pesq_proxy or "
            "`pip install pypesq`") from e
    n = min(len(ref), len(deg))
    return float(pesq(ref[:n], deg[:n], fs))


def estoi_exact(ref: np.ndarray, deg: np.ndarray, fs: int = 16000) -> float:
    """ESTOI via pystoi."""
    try:
        from pystoi.stoi import stoi
    except ImportError as e:
        raise OracleUnavailable(
            "pystoi is not installed; use metrics.estoi or "
            "`pip install pystoi`") from e
    n = min(len(ref), len(deg))
    return float(stoi(ref[:n], deg[:n], fs, extended=True))


def siib_exact(ref: np.ndarray, deg: np.ndarray, fs: int = 16000,
               gauss: bool = True) -> float:
    """SIIB via pysiib."""
    try:
        from pysiib import SIIB
    except ImportError as e:
        raise OracleUnavailable(
            "pysiib is not installed; use metrics.siib or "
            "`pip install pysiib`") from e
    n = min(len(ref), len(deg))
    return float(SIIB(ref[:n], deg[:n], fs, gauss=gauss))


def visqol_exact_batch(ref_paths: Sequence[str], deg_paths: Sequence[str],
                       binary: Optional[str] = None,
                       model: Optional[str] = None) -> List[float]:
    """ViSQOL MOS-LQO via the C++ executable, batch-CSV protocol exactly as
    the reference drives it (audio_util.py:232-265)."""
    binary = binary or os.environ.get("VISQOL_BIN")
    if not binary or not os.path.exists(binary):
        raise OracleUnavailable(
            "ViSQOL binary not found; set VISQOL_BIN or pass binary=; "
            "on-device surrogate: metrics.visqol_proxy")
    with tempfile.TemporaryDirectory() as td:
        in_csv = os.path.join(td, "input.csv")
        out_csv = os.path.join(td, "results.csv")
        with open(in_csv, "w") as f:
            f.write("reference,degraded\n")
            for r, d in zip(ref_paths, deg_paths):
                f.write(f"{r},{d}\n")
        cmd = [binary, "--use_speech_mode", "--batch_input_csv", in_csv,
               "--results_csv", out_csv]
        if model:
            cmd += ["--similarity_to_quality_model", model]
        subprocess.run(cmd, check=True, capture_output=True)
        with open(out_csv) as f:
            rows = list(csv.DictReader(f))
    scores = [float(r["moslqo"]) for r in rows]
    if len(scores) != len(ref_paths):
        raise RuntimeError(f"ViSQOL returned {len(scores)} scores for "
                           f"{len(ref_paths)} pairs")
    return scores
