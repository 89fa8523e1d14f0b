"""nelegan_tpu_torch: the PyTorch/CUDA port of `nelegan_tpu` for one H100.

Layout mirrors the reference package, so each module's counterpart sits at
the same path there:
  config.py   own copy of the band table and the config dataclasses
  device.py   device=None -> CUDA (raises without a GPU); TF32 switch
  dsp/        STFT, ERB band matrices, IMCRA (plain loop + CUDA kernel),
              single-utterance features and resynthesis
  models/     the generator (reference state-dict keys) and weight import
  ops/        gammatone one-pole cascade (plain + CUDA kernel)
  pipeline.py batched featurize -> generator -> resynthesis
  cli/serve   the dynamic-batching enhancement server
  kernels/    nvcc build, ctypes binding and launch counts of csrc/*.cu

It imports torch, numpy and scipy only; nothing of the reference package.
"""

__version__ = "0.1.0"
