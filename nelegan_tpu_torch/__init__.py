"""nelegan_tpu_torch: the PyTorch/CUDA port of `nelegan_tpu` for one H100.

Layout mirrors the reference package, so each module's counterpart sits at
the same path there:
  config.py   own copy of the band table and the config dataclasses
  device.py   device=None -> CUDA (raises without a GPU); TF32 switch
  dsp/        STFT, ERB band matrices, IMCRA (plain loop + CUDA kernel),
              single-utterance features and resynthesis, P.56 active
              speech level, MMSE estimators, reverberation helpers,
              polyphase resampling
  models/     the generator and spectral-norm discriminators (reference
              state-dict keys), weight and train-state import, the
              reference `chkpt_*.pt` reader and writer
  ops/        gammatone one-pole cascade; IIR filters over the first-order
              recurrence linrec (each a plain version + CUDA kernel)
  metrics/    ESTOI, SIIB, HASPI v1/v2 and HASQI v2; score_pair,
              score_batch and bucketed score_corpus; calibrations
  pipeline.py batched featurize -> generator -> resynthesis
  streaming.py frame streaming at 32 ms latency (IMCRA carried in the
              kernel's state layout)
  data/       wav I/O (native reader csrc/wavio.cpp, built with g++) and
              bucketed corpus loading
  train/      the GAN training steps, exact-resume checkpoints (also
              reading the reference package's .msgpack files), replay
  parallel/   data parallelism over torch.distributed: the mesh and its
              collectives, local worlds of spawned ranks
  cli/        serve (dynamic-batching server), infer (corpus, scoring),
              stream, export_torch, train (also under torchrun)
  kernels/    nvcc build, ctypes binding and launch counts of csrc/*.cu

It imports torch, numpy and scipy only; nothing of the reference package,
nor flax or msgpack.
"""

__version__ = "0.1.0"
