"""Port log-mel path (kernel 1's function) against the JAX package.

The same waveforms, made with numpy from a seed, go through the JAX
functions and the port's; on the CPU the port's kernel wrapper takes its
plain PyTorch version.  Tolerances are those of tests/test_pallas.py:
1e-4 on standardized features, 1e-3 on raw dB with the top_db floor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_hmc_tpu.core.config import MelConfig as JMelConfig
from vae_hmc_tpu.ops import mel as jmel
from vae_hmc_tpu.ops import stft as jstft
from vae_hmc_tpu.ops.pallas import logmel_kernel as jkernel
from vae_hmc_tpu_torch.core.config import MelConfig
from vae_hmc_tpu_torch.ops import mel as tmel
from vae_hmc_tpu_torch.ops import stft as tstft
from vae_hmc_tpu_torch.ops.kernels import build
from vae_hmc_tpu_torch.ops.kernels.logmel import (
    logmel_standardized, mel_db_standardize, mel_db_standardize_plain)

torch.manual_seed(0)
torch.set_num_threads(1)


def _signals(n, dur_s, seed=0, sr=22050):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * dur_s)) / sr
    return np.stack([
        (np.sin(2 * np.pi * rng.uniform(100, 1000) * t)
         + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)
        for _ in range(n)])


def test_filterbank_identical():
    for sr, n_fft, n_mels in ((22050, 2048, 128), (22050, 2048, 32)):
        np.testing.assert_array_equal(tmel.mel_filterbank(sr, n_fft, n_mels),
                                      jmel.mel_filterbank(sr, n_fft, n_mels))


@pytest.mark.parametrize("n_mels,tile", [(128, 32), (32, 32), (128, 16)])
def test_filterbank_bands_cover_every_nonzero(n_mels, tile):
    """Kernel 1 sums each row tile over the union of its rows' bands; that
    sum equals the dense product, and the bands hold each row's nonzeros
    exactly."""
    fb = tmel.mel_filterbank(22050, 2048, n_mels)
    bands = tmel.filterbank_bands(fb)
    assert bands.dtype == np.int32 and bands.shape == (n_mels, 2)
    for row, (lo, hi) in zip(fb, bands):
        nz = np.flatnonzero(row)
        assert (lo, hi) == (nz[0], nz[-1] + 1)
    spec = np.random.default_rng(n_mels).random((1025, 7))
    for m0 in range(0, n_mels, tile):
        lo = bands[m0:m0 + tile, 0].min()
        hi = bands[m0:m0 + tile, 1].max()
        np.testing.assert_allclose(fb[m0:m0 + tile, lo:hi] @ spec[lo:hi],
                                   fb[m0:m0 + tile] @ spec, rtol=1e-12)
    empty = np.zeros((2, 5), np.float32)
    empty[1, 2] = 1.0
    np.testing.assert_array_equal(tmel.filterbank_bands(empty),
                                  [[5, 0], [2, 3]])
    cached = tmel.filterbank_bands_tensor(MelConfig(n_mels=n_mels), "cpu")
    np.testing.assert_array_equal(cached.numpy(), bands)


def test_power_spectrogram_matches_jax():
    y = _signals(2, 0.5, seed=1)
    ours = tstft.power_spectrogram(torch.from_numpy(y)).numpy()
    ref = np.asarray(jstft.power_spectrogram(jnp.asarray(y)))
    assert ours.shape == ref.shape == (2, 1025, 22)
    # f32 DFT-as-matmul in two frameworks: relative to the spectrum's peak
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5 * ref.max())


@pytest.mark.parametrize("kind,kw,atol", [
    ("standardized, no floor", dict(duration_s=1.0, n_mels=32, top_db=-1.0),
     1e-4),
    ("standardized, top_db=80", dict(duration_s=1.0, n_mels=32), 1e-4),
    ("raw dB, top_db=80", dict(duration_s=0.5, n_mels=32,
                               per_sample_standardize=False), 1e-3),
])
def test_logmel_matches_jax_xla_path(kind, kw, atol):
    y = _signals(3, kw["duration_s"], seed=2)
    ours = logmel_standardized(torch.from_numpy(y), MelConfig(**kw)).numpy()
    jcfg = JMelConfig(**kw)
    ref = jmel.logmel_batch(jnp.asarray(y), jcfg)
    if jcfg.per_sample_standardize:
        ref = jmel.per_sample_standardize(ref)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-4, atol=atol,
                               err_msg=kind)


@pytest.mark.parametrize("top_db,standardize,atol", [
    (None, True, 1e-4), (80.0, True, 1e-4), (80.0, False, 1e-3),
    (None, False, 1e-3)])
def test_kernel_function_matches_pallas_interpret(top_db, standardize, atol):
    """The wrapper's function on the same spectrogram as the Pallas kernel
    run in interpret mode."""
    y = _signals(2, 0.5, seed=3)
    spec = np.array(jstft.power_spectrogram(jnp.asarray(y)))   # writable copy
    fb = jmel.mel_filterbank(22050, 2048, 32)
    ref = np.asarray(jkernel.mel_db_standardize(
        jnp.asarray(spec), jnp.asarray(fb), 32, True, top_db, standardize,
        interpret=True))
    ours = mel_db_standardize(torch.from_numpy(spec), torch.from_numpy(fb),
                              top_db=top_db, standardize=standardize).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=atol)


def test_logmel_matches_pallas_pipeline_interpret():
    cfg_kw = dict(duration_s=1.0, n_mels=32)
    y = _signals(2, 1.0, seed=4)
    ref = np.asarray(jkernel.logmel_standardized_pallas(
        jnp.asarray(y), JMelConfig(**cfg_kw), interpret=True))
    ours = logmel_standardized(torch.from_numpy(y), MelConfig(**cfg_kw))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_full_width_two_rows():
    """Full (128, 646) features: 15 s at the default MelConfig (top_db=80,
    standardized) on 2 rows."""
    y = _signals(2, 15.0, seed=5)
    ours = logmel_standardized(torch.from_numpy(y), MelConfig()).numpy()
    ref = np.asarray(jmel.per_sample_standardize(
        jmel.logmel_batch(jnp.asarray(y), JMelConfig())))
    assert ours.shape == (2, 128, 646)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_wrapper_cpu_takes_plain_version_and_counts_nothing():
    rng = np.random.default_rng(6)
    spec = torch.from_numpy(rng.random((2, 1025, 9), dtype=np.float32))
    fb = tmel.mel_filterbank_tensor(MelConfig(n_mels=16), "cpu")
    before = build.launch_counts()
    got = mel_db_standardize(spec, fb, top_db=80.0)
    assert build.launch_counts() == before
    torch.testing.assert_close(
        got, mel_db_standardize_plain(spec, fb, top_db=80.0), rtol=0, atol=0)
    # population std: each standardized sample has mean 0 and std 1
    np.testing.assert_allclose(got.mean(dim=(1, 2)).numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(got.std(dim=(1, 2), correction=0).numpy(), 1,
                               atol=1e-5)


def test_wrapper_rejects_other_devices():
    spec = torch.empty((1, 1025, 4), device="meta")
    fb = torch.empty((8, 1025), device="meta")
    with pytest.raises(ValueError):
        mel_db_standardize(spec, fb)



@pytest.mark.parametrize("n_mels", [128, 32, 16])
def test_packed_filterbank_table_rebuilds_fb_exactly(n_mels):
    """Kernel 1's compact filterbank: each row's weights over its band,
    packed row after row, scatter back to the dense fb bit for bit."""
    cfg = MelConfig(n_mels=n_mels)
    fb = tmel.mel_filterbank_tensor(cfg, "cpu").numpy()
    bands = tmel.filterbank_bands_tensor(cfg, "cpu").numpy()
    weights = tmel.filterbank_weights_tensor(cfg, "cpu").numpy()
    assert weights.dtype == np.float32
    assert weights.size == int((bands[:, 1] - bands[:, 0]).clip(0).sum())
    assert weights.size == int((fb != 0).sum())          # 2,018 at 128 mels
    dense = np.zeros_like(fb)
    off = 0
    for row, (lo, hi) in enumerate(bands):
        n = max(hi - lo, 0)
        dense[row, lo:lo + n] = weights[off:off + n]
        off += n
    np.testing.assert_array_equal(dense, fb)
    # an all-zero row packs nothing
    empty = np.zeros((3, 6), np.float32)
    empty[0, 1:3] = [0.5, 0.25]
    empty[2, 4] = 2.0
    np.testing.assert_array_equal(
        tmel.filterbank_weights(empty, tmel.filterbank_bands(empty)),
        np.float32([0.5, 0.25, 2.0]))


def test_power_spectrogram_rows_are_16_byte_aligned():
    """Kernel 1 reads the spectrogram through a TMA tensor map: rows padded
    to 4 frames, the same values as the contiguous result, zero pad."""
    y = torch.from_numpy(_signals(2, 1.0, seed=8))
    spec = tstft.power_spectrogram(y)
    b, f, t = spec.shape
    assert (b, f, t) == (2, 1025, 44)
    tp = -(-t // 4) * 4
    assert spec.stride() == (f * tp, tp, 1) and spec.data_ptr() % 16 == 0
    odd = tstft.power_spectrogram(torch.from_numpy(_signals(1, 0.7, seed=9)))
    assert odd.shape[2] == 31 and odd.stride(1) == 32
    flat = spec.contiguous()
    torch.testing.assert_close(tstft.row_aligned(flat), flat, rtol=0, atol=0)
    assert tstft.row_aligned(spec) is spec
    padded = tstft.row_aligned(odd.contiguous())
    torch.testing.assert_close(padded, odd, rtol=0, atol=0)
    assert padded.stride(1) == 32
    rows = padded.as_strided((1, 1025, 32), padded.stride())   # with the pad
    assert torch.count_nonzero(rows[:, :, 31:]) == 0
