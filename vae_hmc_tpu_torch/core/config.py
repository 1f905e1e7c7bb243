"""Configuration dataclasses, copied from the JAX package.

Copies of ``vae_hmc_tpu.core.config`` ``Workspace``, ``MelConfig``
(``MEL_MEDIUM``), ``MfccConfig`` (``MFCC_EASY``, ``MFCC_HARD``),
``DenseVaeConfig`` (``DENSE_VAE_EASY``), ``ConvMMVaeConfig``
(``CONV_MM_VAE_MEDIUM``), ``HardVaeConfig`` (``HARD_BETA_VAE``,
``HARD_CVAE``), ``AeConfig`` (``AE_BASELINE_HARD``), ``KMeansConfig``
(``KMEANS_EASY``, ``KMEANS_HARD``), ``SweepConfig`` (``SWEEP_MEDIUM``),
``TextEmbedConfig`` (``TEXT_MEDIUM``, ``TEXT_HARD``), ``TsneConfig``
(``TSNE_DEFAULT``), ``UmapConfig`` (``UMAP_EASY``, ``UMAP_HARD``),
``ParallelConfig``, ``asdict`` and ``to_json`` with their reference
citations, so the port never imports the JAX package.  Field values are
identical; the tests compare them.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple


def asdict(cfg) -> dict:
    """dataclasses.asdict with Path fields as strings (JSON metadata)."""
    d = dataclasses.asdict(cfg)
    for k, v in d.items():
        if isinstance(v, Path):
            d[k] = str(v)
    return d


def to_json(cfg, path: Path) -> None:
    """Write ``asdict(cfg)`` as indented JSON, creating the directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(asdict(cfg), indent=2, default=str))


@dataclass(frozen=True)
class Workspace:
    """Root directories of the artifact contract (reference layout)."""

    root: Path = Path(".")

    @property
    def data(self) -> Path:
        return Path(self.root) / "data"

    @property
    def results(self) -> Path:
        return Path(self.root) / "results"

    @property
    def data_hard(self) -> Path:
        return self.data / "hard"

    @property
    def results_hard(self) -> Path:
        return self.results / "hard"

    def manifest_clean(self) -> Path:
        # reference scripts/05:53-57 canonical manifest
        return self.data / "fma_manifest_combined_text_only_clean.csv"


@dataclass(frozen=True)
class MelConfig:
    """Log-mel spectrogram images for the conv VAE (reference scripts/10:14-23)."""

    sample_rate: int = 22050
    duration_s: float = 15.0       # 10:17 duration=15.0
    n_fft: int = 2048              # 10:19
    hop_length: int = 512          # 10:20
    n_mels: int = 128              # 10:21
    power: float = 2.0             # 10:22
    fmin: float = 0.0
    fmax: Optional[float] = None
    top_db: float = 80.0           # librosa power_to_db default
    ref_max: bool = True           # 10:65 power_to_db(S, ref=np.max)
    per_sample_standardize: bool = True  # 10:69-72

    @property
    def n_samples(self) -> int:
        return int(round(self.sample_rate * self.duration_s))

    @property
    def n_frames(self) -> int:
        # center=True framing: 1 + n_samples // hop  (librosa stft semantics)
        return 1 + self.n_samples // self.hop_length


MEL_MEDIUM = MelConfig()           # script 10 canonical


@dataclass(frozen=True)
class MfccConfig:
    """MFCC stats-pooled vector extraction.

    Easy tier: reference scripts/06:56-89 (30 s clips).
    Hard tier: reference scripts/18:73-97 (20 s clips, skip <1 s audio).
    """

    sample_rate: int = 22050       # 06:63 librosa.load(sr=22050)
    duration_s: float = 30.0       # 06:207 --duration default 30.0
    n_mfcc: int = 40               # 06:208
    n_fft: int = 2048              # 06:209
    hop_length: int = 512          # 06:210
    n_mels: int = 128              # librosa.feature.mfcc default melspectrogram n_mels
    fmin: float = 0.0
    fmax: Optional[float] = None   # librosa default -> sr/2
    pad_mode: str = "reflect"      # librosa stft center=True default
    min_duration_s: float = 0.0    # hard tier skips <1 s clips (18:88-89)

    @property
    def n_samples(self) -> int:
        return int(round(self.sample_rate * self.duration_s))

    @property
    def feature_dim(self) -> int:
        return 2 * self.n_mfcc     # mean+std stats pool (06:83-87)


MFCC_EASY = MfccConfig()                                        # script 06
MFCC_HARD = MfccConfig(duration_s=20.0, min_duration_s=1.0)     # script 18:118, 18:88


@dataclass(frozen=True)
class DenseVaeConfig:
    """MLP VAE used by the easy tier (reference scripts/06:145-179, 06:202-242)."""

    input_dim: int = 80
    hidden_dims: Tuple[int, ...] = (256, 256)  # 06:151-158 two hidden layers 256
    latent_dim: int = 16           # 06:212
    beta: float = 1.0              # 06:213
    epochs: int = 40               # 06:214
    batch_size: int = 128          # 06:215
    learning_rate: float = 1e-3    # 06:216
    seed: int = 42                 # 06:217
    loss_reduction: str = "mean"   # 06:182-188: MSE mean + beta*KL mean-over-elements
    standardize: bool = True       # 06:291-294 StandardScaler on X


DENSE_VAE_EASY = DenseVaeConfig()


@dataclass(frozen=True)
class ConvMMVaeConfig:
    """Conv multimodal VAE, medium tier (reference scripts/12:15-23, 12:83-190)."""

    in_mels: int = 128
    in_frames: int = 646           # 15 s @ hop 512 -> 1 + 330750//512
    audio_channels: Tuple[int, ...] = (32, 64, 128)  # 12:86-90 stride-2 convs
    audio_fc_dim: int = 256        # 12:98-103 conv flat -> 256
    audio_latent_dim: int = 32     # 12:20 latent_dim 32 (mu_a, logvar_a)
    lyrics_dim: int = 384          # MiniLM embedding width
    lyrics_hidden: Tuple[int, ...] = (256, 128)  # 12:111-120 projector 384->256->128
    latent_dim: int = 32           # fused final latent (12:159-166)
    beta: float = 1.0              # 12:21
    epochs: int = 25               # 12:18
    batch_size: int = 64           # 12:17
    learning_rate: float = 2e-3    # 12:19
    seed: int = 42
    loss_reduction: str = "mean"   # 12:262-264 MSE mean + beta*KL mean
    # Only "float32" is ported: parity with the reference's f32 torch
    # training is the hard constraint (TF32 is switched off, core.device).
    compute_dtype: str = "float32"


CONV_MM_VAE_MEDIUM = ConvMMVaeConfig()


@dataclass(frozen=True)
class HardVaeConfig:
    """Beta-VAE / CVAE on early-fused features, hard tier (reference scripts/19:136-155)."""

    input_dim: int = 464           # 80 mfcc-stats + 384 lyrics emb (19:171)
    hidden_dim: int = 256          # 19:141
    latent_dim: int = 16           # 19:140
    beta: float = 4.0              # 19:139
    epochs: int = 50               # 19:142
    batch_size: int = 256          # 19:143
    learning_rate: float = 1e-3    # 19:144
    seed: int = 42
    use_cvae: bool = False         # 19:146 --cvae flag
    cond_genre: bool = False       # 19 --cond_on genre: CVAE genre one-hot
    cond_lang: bool = False        # 19 --cond_on lang: CVAE language one-hot
    include_genre_in_input: bool = False  # 19:174-175 one-hot appended to X
    include_lang_in_input: bool = False   # 19:176-177 (independent of CVAE)
    n_genres: int = 6
    n_langs: int = 4
    loss_reduction: str = "sum"    # 19:226-228 per-sample SUM, then batch mean
    kl_anneal_epochs: int = 0      # optional KL warmup (BASELINE.json config 4)


HARD_BETA_VAE = HardVaeConfig(beta=4.0)
HARD_CVAE = HardVaeConfig(beta=4.0, use_cvae=True, cond_genre=True)


@dataclass(frozen=True)
class AeConfig:
    """Deterministic autoencoder baseline (reference scripts/22:66-88, 22:139-171)."""

    input_dim: int = 464
    hidden_dim: int = 256          # 22:70-80 two 256 layers each side
    latent_dim: int = 16           # 22:118 z=16
    epochs: int = 30               # 22:146
    batch_size: int = 256
    learning_rate: float = 1e-3
    seed: int = 42


AE_BASELINE_HARD = AeConfig()


@dataclass(frozen=True)
class KMeansConfig:
    n_clusters: int = 5            # easy: 07:70 k=5; hard uses k=#genres (20:65)
    n_init: int = 20               # 07:70, 20:68 n_init=20
    max_iter: int = 300            # sklearn default
    tol: float = 1e-4              # sklearn default (relative center-shift)
    seed: int = 42
    # consumed by the tier pipelines (they scale before calling kmeans);
    # kmeans() itself takes data as given.
    standardize: bool = True       # easy: 07:67-68 scales; hard: 20:65-69 does NOT


KMEANS_EASY = KMeansConfig(n_clusters=5, standardize=True)
KMEANS_HARD = KMeansConfig(n_clusters=6, standardize=False)


@dataclass(frozen=True)
class SweepConfig:
    """Medium full clustering sweep grid (reference scripts/16:159-244)."""

    ks: Tuple[int, ...] = (4, 5, 6, 7, 8)                       # 16:181
    dbscan_eps: Tuple[float, ...] = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)  # 16:219
    dbscan_min_samples: Tuple[int, ...] = (3, 5, 8)             # 16:219
    representations: Tuple[str, ...] = (
        "vae_mm_latents", "baseline_mel_flat", "baseline_lyrics_only")  # 16:163-165
    seed: int = 42


SWEEP_MEDIUM = SweepConfig()


@dataclass(frozen=True)
class TextEmbedConfig:
    model_name: str = "sentence-transformers/all-MiniLM-L6-v2"  # 11:85
    embed_dim: int = 384
    normalize: bool = True          # 11:90 normalize_embeddings=True
    min_chars: int = 30             # 11:43 skip <30 chars
    tfidf_max_features: int = 2000  # 18:221 fallback TfidfVectorizer(max_features=2000)
    batch_size: int = 64


TEXT_MEDIUM = TextEmbedConfig()
TEXT_HARD = TextEmbedConfig(min_chars=1)


@dataclass(frozen=True)
class TsneConfig:
    perplexity: float = 30.0       # 08:118
    learning_rate: float = 200.0   # 08:119
    n_iter: int = 1500             # 08:120
    init: str = "pca"              # 08:120
    early_exaggeration: float = 12.0  # sklearn default
    seed: int = 42


@dataclass(frozen=True)
class UmapConfig:
    n_neighbors: int = 30          # easy 08:98; hard uses 20 (21:36)
    min_dist: float = 0.1          # easy 08:99; hard 0.15 (21:37)
    seed: int = 42


TSNE_DEFAULT = TsneConfig()
UMAP_EASY = UmapConfig()
UMAP_HARD = UmapConfig(n_neighbors=20, min_dist=0.15)


# ---------------------------------------------------------------------------
# Parallelism
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    """The JAX package's device mesh layout, copied field for field (its
    'restarts' axis names the JAX package's own mesh).  Nothing in the port
    reads it: the port's mesh (``parallel/mesh``) is ('data', 'model')."""

    data_axis: str = "data"
    restart_axis: str = "restarts"
    mesh_shape: Optional[Tuple[int, ...]] = None  # None -> (n_devices,)
