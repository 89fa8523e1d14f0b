"""Wav I/O and bucketed corpus loading."""
from nelegan_tpu_torch.data.wavio import (  # noqa: F401
    read_wav,
    read_wav_batch,
    write_wav_pcm16,
    wav_length,
)
from nelegan_tpu_torch.data.pipeline import (  # noqa: F401
    BucketedLoader,
    CorpusIndex,
    UtteranceBatch,
    get_filepaths,
)
