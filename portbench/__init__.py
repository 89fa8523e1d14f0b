"""The benchmark of `nelegan_tpu_torch` on one NVIDIA H100 (`run.py`)."""
