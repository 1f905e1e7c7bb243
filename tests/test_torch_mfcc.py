"""Port MFCC front end (``ops.mfcc``, ``features.build_mfcc_stats``) against
the JAX package.

The same waveforms, made with numpy from a seed, go through the JAX
functions and the port's; on the CPU the port's kernel 1 wrapper takes its
plain PyTorch version (mel product, dB with ref=1.0 and the 80 dB floor).
Tolerances: the coefficients and stats are on the dB scale (magnitudes up
to ~100), so atol 1e-3 with rtol 1e-5 (f32 logs and a 128-term DCT in
another summation order; measured gaps are under 7e-5); the DCT matrix,
reflect tail and frame masks are exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_hmc_tpu.core import config as jconfig
from vae_hmc_tpu.ops import mfcc as jmfcc
from vae_hmc_tpu.ops import stft as jstft
from vae_hmc_tpu.pipelines import features as jfeatures
from vae_hmc_tpu_torch.core import config
from vae_hmc_tpu_torch.ops import mfcc as tmfcc
from vae_hmc_tpu_torch.ops import stft as tstft
from vae_hmc_tpu_torch.ops.kernels import build
from vae_hmc_tpu_torch.pipelines import features

torch.manual_seed(0)
torch.set_num_threads(1)

ATOL, RTOL = 1e-3, 1e-5
SR = 22050


def _signals(n, n_samples, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SR
    return np.stack([
        (0.5 * np.sin(2 * np.pi * rng.uniform(80, 2000) * t)
         * (1.0 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.5, 4) * t))
         + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
        for _ in range(n)])


@pytest.mark.parametrize("name", ["MfccConfig", "DenseVaeConfig",
                                  "HardVaeConfig", "AeConfig",
                                  "TextEmbedConfig"])
def test_config_copies(name):
    assert dataclasses.asdict(getattr(config, name)()) == dataclasses.asdict(
        getattr(jconfig, name)())


@pytest.mark.parametrize("name", ["MFCC_EASY", "MFCC_HARD", "DENSE_VAE_EASY",
                                  "HARD_BETA_VAE", "HARD_CVAE", "TEXT_HARD"])
def test_preset_copies(name):
    assert dataclasses.asdict(getattr(config, name)) == dataclasses.asdict(
        getattr(jconfig, name))
    assert config.MfccConfig().n_samples == jconfig.MfccConfig().n_samples
    assert config.MFCC_HARD.feature_dim == 80


@pytest.mark.parametrize("n_out,n_in", [(40, 128), (13, 40), (1, 8)])
def test_dct_matrix_equal(n_out, n_in):
    np.testing.assert_array_equal(tmfcc.dct_ii_matrix(n_out, n_in),
                                  jmfcc.dct_ii_matrix(n_out, n_in))


@pytest.mark.parametrize("n,target", [(100, 300), (5000, 5000), (6000, 5000),
                                      (3, 2000), (2, 50), (1500, 2000)])
def test_pad_with_reflect_tail_equal(n, target):
    y = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(tstft.pad_with_reflect_tail(y, target, 2048),
                                  jstft.pad_with_reflect_tail(y, target, 2048))


@pytest.mark.parametrize("dur", [1.0, 2.0])
def test_mfcc_and_stats_match_jax(dur):
    cfg = config.MfccConfig(duration_s=dur)
    jcfg = jconfig.MfccConfig(duration_s=dur)
    y = _signals(3, cfg.n_samples, seed=int(dur * 10))
    before = build.launch_counts()["mel_db_standardize"]
    feats = tmfcc.mfcc_batch(torch.from_numpy(y), cfg)
    assert build.launch_counts()["mel_db_standardize"] == before  # CPU: plain
    want = np.asarray(jmfcc.mfcc_batch(jnp.asarray(y), jcfg))
    assert feats.shape == want.shape == (3, 40, 1 + cfg.n_samples // 512)
    np.testing.assert_allclose(feats.numpy(), want, rtol=RTOL, atol=ATOL)
    got = tmfcc.mfcc_stats_batch(torch.from_numpy(y), cfg).numpy()
    want = np.asarray(jmfcc.mfcc_stats_batch(jnp.asarray(y), jcfg))
    assert got.shape == (3, 80)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_masked_stats_with_reflect_tail_match_jax():
    """Clips of true length staged into the 2 s buffer with their reflect
    tail, stats masked to 1 + length // hop frames, as the hard tier does."""
    cfg = config.MfccConfig(duration_s=2.0, min_duration_s=1.0)
    jcfg = jconfig.MfccConfig(duration_s=2.0, min_duration_s=1.0)
    lengths = np.array([cfg.n_samples, 30000, 22050, 40001], np.int32)
    raw = _signals(4, cfg.n_samples, seed=5)
    staged = np.stack([tstft.pad_with_reflect_tail(raw[r, :lengths[r]],
                                                   cfg.n_samples, cfg.n_fft)
                       for r in range(4)])
    mask = tmfcc.frame_mask_from_lengths(torch.from_numpy(lengths),
                                         cfg.n_samples, cfg)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jmfcc.frame_mask_from_lengths(
            jnp.asarray(lengths), cfg.n_samples, jcfg)))
    assert mask.sum(dim=1).tolist() == [1 + int(n) // 512 for n in lengths]
    got = tmfcc.mfcc_stats_batch(torch.from_numpy(staged), cfg,
                                 lengths=torch.from_numpy(lengths)).numpy()
    want = np.asarray(jmfcc.mfcc_stats_batch(jnp.asarray(staged), jcfg,
                                             lengths=jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the full-length row's masked stats are its plain stats
    plain = tmfcc.mfcc_stats_batch(torch.from_numpy(staged[:1]), cfg).numpy()
    np.testing.assert_allclose(got[:1], plain, rtol=1e-6, atol=1e-4)


def test_stats_pool_matches_jax():
    rng = np.random.default_rng(3)
    f = rng.standard_normal((2, 5, 9)).astype(np.float32) * 50
    m = (rng.random((2, 9)) < 0.6).astype(np.float32)
    for mask in (None, m):
        got = tmfcc.stats_pool(torch.from_numpy(f), None if mask is None
                               else torch.from_numpy(mask)).numpy()
        want = np.asarray(jmfcc.stats_pool(
            jnp.asarray(f), None if mask is None else jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


# -- build_mfcc_stats on a source of short clips ----------------------------

N_CLIPS = 7
DUR = 1.5


def _clips():
    """Per-track (waveform or None, error): full-length, short, too-short
    (< 1 s), non-finite and a decode error."""
    full = int(round(SR * DUR))
    lens = [full, full, 25000, 15000, full, 30000, full]
    waves = list(_signals(N_CLIPS, full + 500, seed=11))
    out = [(waves[i][:lens[i]], None) for i in range(N_CLIPS)]
    bad = waves[4][:full].copy()
    bad[1000] = np.nan
    out[4] = (bad, None)
    out[6] = (None, "decode_error: bad header")
    return out


class _JaxClips:
    """The JAX package's source interface over host waveforms."""

    def __init__(self, clips):
        self.clips = clips
        self.track_ids = np.arange(500, 500 + len(clips), dtype=np.int64)
        self.paths = [f"/music/{t}.mp3" for t in self.track_ids]

    def __len__(self):
        return len(self.clips)

    def waveforms(self, idx, duration_s):
        n = int(round(SR * duration_s))
        batch = np.zeros((len(idx), n), np.float32)
        lengths = np.zeros(len(idx), np.int32)
        errors = []
        for r, i in enumerate(idx):
            y, err = self.clips[i]
            if y is not None:
                y = y[:n]
                batch[r, :len(y)] = y
                lengths[r] = len(y)
            errors.append(err)
        return batch, lengths, errors


class _PortClips(_JaxClips):
    """The port's source interface: the same batch, on the device."""

    def waveforms(self, idx, duration_s, device):
        batch, lengths, errors = super().waveforms(idx, duration_s)
        return torch.from_numpy(batch).to(device), lengths, errors


@pytest.mark.parametrize("min_dur", [1.0, 0.0])
def test_build_mfcc_stats_matches_jax(min_dur):
    """Masked hard preset (short clips staged with their reflect tail, the
    < 1 s clip skipped) and the fixed-length easy preset: the same report
    rows, ids and stats."""
    clips = _clips()
    cfg = config.MfccConfig(duration_s=DUR, min_duration_s=min_dur)
    jcfg = jconfig.MfccConfig(duration_s=DUR, min_duration_s=min_dur)
    x, ids, report = features.build_mfcc_stats(_PortClips(clips), cfg,
                                               device_batch=3, device="cpu")
    jx, jids, jreport = jfeatures.build_mfcc_stats(_JaxClips(clips), jcfg,
                                                   device_batch=3)
    assert report.rows == jreport.rows
    np.testing.assert_array_equal(ids, jids)
    assert x.dtype == np.float32 and x.shape == jx.shape
    np.testing.assert_allclose(x, jx, rtol=RTOL, atol=ATOL)
    status = {r[0]: (r[2], r[3]) for r in report.rows}
    assert status[504] == ("error", "non_finite_features")
    assert status[506] == ("error", "decode_error: bad header")
    assert status[503] == (("skipped", "too_short") if min_dur
                           else ("ok", ""))
    assert report.ok_count() == len(ids) == (4 if min_dur else 5)


def test_build_mfcc_stats_strict_raises():
    with pytest.raises(RuntimeError, match="track 506: decode_error"):
        features.build_mfcc_stats(_PortClips(_clips()),
                                  config.MfccConfig(duration_s=DUR),
                                  device_batch=4, strict=True, device="cpu")
