"""The port's hooks into external metric engines
(`nelegan_tpu_torch/metrics/oracles.py`) against the JAX package's
(`nelegan_tpu/metrics/oracles.py`, which imports no JAX).

No engine is installed here: each function raises `OracleUnavailable`
with the JAX module's message.  The ViSQOL hook also runs a stand-in
executable that speaks its batch-CSV protocol.
"""
import os
import stat
import sys

import numpy as np
import pytest

from nelegan_tpu.metrics import oracles as joracles
from nelegan_tpu_torch.metrics import oracles

SIGNALS = (np.zeros(160), np.zeros(160))


def _message(module, name, *args, **kw):
    with pytest.raises(module.OracleUnavailable) as info:
        getattr(module, name)(*args, **kw)
    return str(info.value)


@pytest.mark.parametrize("name", ["pesq_exact", "estoi_exact",
                                  "siib_exact"])
def test_missing_engine_raises_the_reference_message(name):
    """An engine that is not installed raises OracleUnavailable, a
    RuntimeError, with the JAX module's message."""
    assert issubclass(oracles.OracleUnavailable, RuntimeError)
    assert (_message(oracles, name, *SIGNALS)
            == _message(joracles, name, *SIGNALS))


@pytest.mark.parametrize("binary", [None, "/nonexistent/visqol"])
def test_missing_visqol_binary_raises(binary, monkeypatch):
    """No VISQOL_BIN and no binary, or a binary that does not exist."""
    monkeypatch.delenv("VISQOL_BIN", raising=False)
    args = (["r.wav"], ["d.wav"])
    assert (_message(oracles, "visqol_exact_batch", *args, binary=binary)
            == _message(joracles, "visqol_exact_batch", *args,
                        binary=binary))


def test_visqol_batch_protocol(tmp_path, monkeypatch):
    """A stand-in ViSQOL executable (found through VISQOL_BIN) that scores
    each CSV row: both modules pass the same command line and read the
    same scores in row order."""
    fake = tmp_path / "visqol"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import csv, sys\n"
        "a = sys.argv\n"
        "src = a[a.index('--batch_input_csv') + 1]\n"
        "rows = list(csv.DictReader(open(src)))\n"
        "with open(a[a.index('--results_csv') + 1], 'w') as f:\n"
        "    f.write('reference,degraded,moslqo\\n')\n"
        "    for i, r in enumerate(rows):\n"
        "        ref, deg = r['reference'], r['degraded']\n"
        "        f.write(f'{ref},{deg},{1 + i / 4}\\n')\n"
        "    assert '--use_speech_mode' in a and a[-1] == 'm.txt'\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("VISQOL_BIN", os.fspath(fake))
    refs, degs = ["a.wav", "b.wav", "c.wav"], ["x.wav", "y.wav", "z.wav"]
    got = oracles.visqol_exact_batch(refs, degs, model="m.txt")
    assert got == joracles.visqol_exact_batch(refs, degs, model="m.txt")
    assert got == [1.0, 1.25, 1.5]
