"""Typed configuration of the port: the model, DSP and serving constants.

An own copy of the reference package's `nelegan_tpu/config.py` (the parts
this package uses): the port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# 64 ERB-scaled band edges over 257 rFFT bins for 16 kHz speech
# (reference: audio_util.py:23 `gmtband`).  The triangular band pooling it
# induces is expressed as two constant matrices (see dsp/erb.py).
GMTBAND: Tuple[int, ...] = (
    0, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 28, 30, 32, 34, 36, 38, 41, 43, 46, 49, 52, 55, 58,
    62, 66, 70, 74, 79, 83, 88, 93, 99, 105, 111, 117, 124, 131, 139, 147,
    156, 165, 174, 184, 195, 206, 218, 230, 243, 257,
)


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """STFT frontend (reference: audio_util.py:53-65)."""
    n_fft: int = 512
    hop: int = 256
    win_length: int = 512
    # librosa semantics: centered frames, reflect padding, periodic Hann.
    center: bool = True

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class BandConfig:
    """ERB band pooling (reference: audio_util.py:23-50, 93-110)."""
    n_bands: int = 64
    n_bins: int = 257
    # Low/high frequency gain floors applied during resynthesis
    # (reference: audio_util.py:107-109).
    floor_low: float = 1e-4
    floor_high: float = 1e-2


@dataclasses.dataclass(frozen=True)
class ImcraConfig:
    """IMCRA noise-PSD tracker (reference: noise_est/imcra.py:166-247,487-516)."""
    is_frames: int = 15          # initial noise-only segment (IS)
    w: int = 1                   # +/- bins for frequency smoothing
    alpha_s: float = 0.9         # spectrogram time-smoothing rate
    alpha_d: float = 0.85        # noise-PSD recursive smoothing rate
    u_buffers: int = 8           # U minimum-tracking buffers
    v_frames: int = 15           # V frames per minimum-tracking window
    bmin: float = 3.2            # minimum-statistics bias
    gamma0: float = 4.6          # first-VAD threshold
    gamma1: float = 3.0          # second-VAD threshold
    zeta0: float = 1.67          # smoothed-spectrum threshold
    beta: float = 1.47           # noise-variance bias correction
    p_upthr: float = 0.9         # speech-presence probability cap
    alpha_dd: float = 0.92       # decision-directed a-priori SNR smoothing
    xi_min: float = 10.0 ** (-25.0 / 20.0)  # a-priori SNR floor
    lambda_init: float = 1e-6    # initial noise PSD


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Generator / discriminator hyper-parameters (reference: model.py)."""
    n_bands: int = 64
    gen_hidden: int = 256
    gen_blocks: int = 6
    gen_kernel_first: int = 5
    gen_kernel_mid: int = 7
    gen_kernel_last: int = 5
    leaky_slope: float = 0.3          # reference: model.py:78
    mask_bound: float = 3.2           # exp(bound*tanh(.)) (reference: model.py:98)
    disc_channels: Tuple[int, ...] = (8, 16, 32, 48, 64)
    disc_kernels: Tuple[int, ...] = (1, 3, 5, 7, 9)
    n_intel_scores: int = 3           # SIIB, HASPI, ESTOI
    n_quality_scores: int = 2         # PESQ, ViSQOL
    # Activation dtype of the generator and discriminator trunks.  Only
    # "float32" is ported; the bfloat16 policy raises (models/).
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """GAN training loop (reference: train_nele.py:30-68,89-91)."""
    gan_epochs: int = 500
    num_sampling: int = 300           # utterances sampled per epoch
    num_valid: int = 480
    batch_size: int = 8
    p_power: float = 1.0 / 6.0        # power-law compression exponent
    inv_p: float = 6.0
    weight_qua: float = 0.5           # quality-loss weight (Eq.7 in the paper)
    lr_g: float = 5e-4
    lr_d: float = 2.5e-4
    lr_dqua: float = 2.5e-4
    seed: int = 666
    replay_fraction: int = 30         # past-list subsample divisor
    target_rms: float = 0.03          # output RMS normalization
    fs: int = 16000
    ckpt_keep_every: int = 0
    ckpt_keep_last: int = 5


@dataclasses.dataclass(frozen=True)
class Config:
    stft: StftConfig = dataclasses.field(default_factory=StftConfig)
    band: BandConfig = dataclasses.field(default_factory=BandConfig)
    imcra: ImcraConfig = dataclasses.field(default_factory=ImcraConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def config_to_dict(cfg: Config) -> dict:
    """JSON-serialisable dict of the config tree (tuples become lists), kept
    beside a checkpoint so a restore rebuilds the model's exact shape."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> Config:
    """Inverse of `config_to_dict`.  Unknown sections and keys (a newer
    writer, or the reference package's `calib` and `parallel` sections) are
    ignored; missing keys keep their defaults."""
    def build(cls, sub):
        kw = {}
        for f in dataclasses.fields(cls):
            if sub is None or f.name not in sub:
                continue
            v = sub[f.name]
            kw[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)

    return Config(stft=build(StftConfig, d.get("stft")),
                  band=build(BandConfig, d.get("band")),
                  imcra=build(ImcraConfig, d.get("imcra")),
                  model=build(ModelConfig, d.get("model")),
                  train=build(TrainConfig, d.get("train")))
