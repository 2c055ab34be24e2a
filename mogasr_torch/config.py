"""Configuration system for the mogasr-tpu pipeline (the port's copy of
mogasr/config.py, which mogasr_torch does not import).

Frozen dataclasses composed into one :class:`PipelineConfig`. Every run
serializes its config into the run directory for reproducibility (SURVEY.md §5).

The reference source was not readable when this was written (SURVEY.md §0), so
the front-end defaults follow the Kaldi/HTK conventions that a LibriSpeech
GMM-HMM pipeline of the reference's shape uses; every convention that could
differ (mel scale, window, log base, edge handling) is a config knob so parity
can be re-tuned against the real reference without code changes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class FrontendConfig:
    """Audio front end: framing -> STFT -> log-mel -> MFCC -> deltas -> CMVN."""

    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemphasis: float = 0.97
    window: str = "povey"  # povey | hamming | hann | rectangular
    n_fft: int = 512
    # Mel filterbank
    n_mels: int = 40
    mel_low_hz: float = 20.0
    mel_high_hz: float = 0.0  # 0 => Nyquist
    mel_scale: str = "htk"  # htk (2595 log10(1+f/700)) | slaney
    # VTLN (vocal tract length normalization): piecewise-linear frequency
    # warp of the mel filterbank (Kaldi convention). 1.0 = no warp; the
    # per-speaker warp is estimated by pipeline.decode_with_vtln.
    vtln_warp: float = 1.0
    vtln_low_hz: float = 100.0
    vtln_high_hz: float = -600.0  # <=0 => Nyquist + this value
    # MFCC
    n_ceps: int = 13
    cepstral_lifter: float = 22.0
    use_energy: bool = False  # replace c0 with log frame energy
    # Deltas
    delta_order: int = 2  # 0 = none, 1 = +delta, 2 = +delta+deltadelta
    delta_window: int = 2
    # CMVN
    cmvn: str = "utterance"  # utterance | global | sliding | none
    cmvn_norm_var: bool = True
    # sliding mode: CAUSAL trailing window (frames, incl. current) — the
    # streaming-safe normalization for online decoding
    cmvn_window: int = 600
    # Numerics
    log_floor: float = 1.1921e-07  # ~float32 eps; floor before log
    snip_edges: bool = True  # Kaldi frame-count convention
    dither: float = 0.0
    feature_type: str = "mfcc"  # mfcc | fbank | plp
    lpc_order: int = 12  # PLP all-pole model order (needs >= n_ceps - 1)
    # Pitch stream (frontend/pitch.py): append (POV, centered log-f0,
    # Δlog-f0) per frame. Utterance-level (the lag Viterbi + log-f0
    # centering are acausal), so the streaming front end rejects it.
    add_pitch: bool = False

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def base_dim(self) -> int:
        return self.n_mels if self.feature_type == "fbank" else self.n_ceps

    @property
    def feat_dim(self) -> int:
        return self.base_dim * (1 + self.delta_order) + (
            3 if self.add_pitch else 0
        )

    def num_frames(self, num_samples: int) -> int:
        if self.snip_edges:
            if num_samples < self.frame_length:
                return 0
            return 1 + (num_samples - self.frame_length) // self.frame_shift
        return (num_samples + self.frame_shift // 2) // self.frame_shift


@dataclass(frozen=True)
class GmmConfig:
    """Diagonal-covariance mixture-of-Gaussians acoustic model."""

    n_states: int = 1000
    n_components: int = 256
    feat_dim: int = 39
    var_floor: float = 1e-3
    weight_floor: float = 1e-5
    # Mixture-splitting schedule for EM training: start with 1 component and
    # double (perturbing means) until n_components is reached.
    split_perturb: float = 0.2
    min_occupancy: float = 3.0
    # Occupancy-gated splitting (Kaldi-style Gaussian allocation): a state is
    # split only if each component would still average >= min_split_occ
    # frames afterwards. 0 = always split (round-1 behavior).
    min_split_occ: float = 0.0


@dataclass(frozen=True)
class TopologyConfig:
    """HMM topology: monophone left-to-right HMMs."""

    states_per_phone: int = 3
    self_loop_prob: float = 0.6
    # silence phone gets its own (possibly longer) model
    sil_states: int = 3
    sil_self_loop_prob: float = 0.8


@dataclass(frozen=True)
class DecodeConfig:
    # beam is in acoustic_scale-multiplied log units; 0 disables pruning
    # (exact dense Viterbi — cheap at monophone graph sizes). If you enable a
    # beam, match it to acoustic_scale: beam ~ 16 suits scale ~ 0.1.
    beam: float = 0.0
    acoustic_scale: float = 0.1
    word_insertion_penalty: float = 0.0
    max_active: int = 0  # 0 = unlimited (dense Viterbi)


@dataclass(frozen=True)
class TrainConfig:
    # GMM / EM
    num_em_iters: int = 10
    realign_every: int = 1
    # Neural
    nn_arch: str = "mlp"  # mlp | lstm
    nn_hidden: int = 512
    nn_layers: int = 3
    nn_context: int = 4  # frames of left/right context for the MLP splice
    # MoE (arch="moe"): top-1-routed expert FFN blocks; expert-parallel over
    # an ('expert',) mesh in mogasr.dist.expert_parallel
    nn_experts: int = 4
    moe_ffn: int = 0  # expert FFN width; 0 -> 2 * nn_hidden
    moe_lb_weight: float = 0.01  # Switch-style load-balance aux loss weight
    lr: float = 1e-3
    weight_decay: float = 1e-5
    batch_frames: int = 8192
    num_nn_steps: int = 2000
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Data-parallel utterance sharding over ICI (SURVEY.md §2)."""

    data_axis: str = "data"
    num_devices: int = 0  # 0 = all visible devices


@dataclass(frozen=True)
class BatchConfig:
    max_frames: int = 2000  # T_max bucket ceiling
    batch_size: int = 16
    bucket_boundaries: Tuple[int, ...] = (400, 800, 1200, 1600, 2000)
    sort_by_length: bool = True


@dataclass(frozen=True)
class PipelineConfig:
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    gmm: GmmConfig = field(default_factory=GmmConfig)
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "PipelineConfig":
        raw = json.loads(s)
        return cls(
            frontend=FrontendConfig(**raw.get("frontend", {})),
            gmm=GmmConfig(**raw.get("gmm", {})),
            topology=TopologyConfig(**raw.get("topology", {})),
            decode=DecodeConfig(**raw.get("decode", {})),
            train=TrainConfig(**{k: v for k, v in raw.get("train", {}).items()}),
            mesh=MeshConfig(**raw.get("mesh", {})),
            batch=BatchConfig(
                **{
                    k: tuple(v) if k == "bucket_boundaries" else v
                    for k, v in raw.get("batch", {}).items()
                }
            ),
        )


def override(cfg: Any, **kwargs: Any) -> Any:
    """Return a copy of a frozen dataclass with fields replaced."""
    return dataclasses.replace(cfg, **kwargs)
