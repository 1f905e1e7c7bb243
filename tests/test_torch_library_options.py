"""Library options of the port against the JAX package: the STFT's
``method="fft"``, NMI's ``average_method``, ``TfidfVectorizer.transform``
and the config presets with ``to_json``.

Tolerances: the FFT spectrogram within 1e-5 of the spectrum's peak of the
JAX package's FFT and of the port's DFT (f32 roundoff of two transforms);
NMI within 1e-12 (float64 in both); TF-IDF within 1e-12 (the same float64
arithmetic, rounded to float32 once); presets exactly.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_hmc_tpu.core import config as jconfig
from vae_hmc_tpu.metrics import external as jexternal
from vae_hmc_tpu.ops import stft as jstft
from vae_hmc_tpu.text import tfidf as jtfidf
from vae_hmc_tpu_torch.core import config
from vae_hmc_tpu_torch.metrics import external
from vae_hmc_tpu_torch.ops import stft
from vae_hmc_tpu_torch.text import tfidf

torch.set_num_threads(1)


def _signals(n, samples, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 22050
    return np.stack([
        (np.sin(2 * np.pi * rng.uniform(100, 4000) * t)
         + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)
        for _ in range(n)])


@pytest.mark.parametrize("power", [2.0, 1.0])
def test_power_spectrogram_fft_matches_jax_fft_and_port_dft(power):
    y = _signals(3, 11025, seed=int(power))
    fft = stft.power_spectrogram(torch.from_numpy(y), power=power,
                                 method="fft")
    dft = stft.power_spectrogram(torch.from_numpy(y), power=power)
    ref = np.asarray(jstft.power_spectrogram(jnp.asarray(y), power=power,
                                             method="fft"))
    assert fft.shape == dft.shape == ref.shape == (3, 1025, 22)
    assert fft.stride() == dft.stride()             # row_aligned, as dft
    peak = float(ref.max())
    np.testing.assert_allclose(fft.numpy(), ref, rtol=0, atol=1e-5 * peak)
    np.testing.assert_allclose(fft.numpy(), dft.numpy(), rtol=0,
                               atol=1e-5 * peak)


def test_power_spectrogram_rejects_an_unknown_method():
    y = torch.zeros(1, 4096)
    with pytest.raises(ValueError, match="method must be"):
        stft.power_spectrogram(y, method="rfft")
    with pytest.raises(ValueError, match="method must be"):
        jstft.power_spectrogram(jnp.zeros((1, 4096)), method="rfft")


def _labels(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, 300)
    b = np.where(rng.random(300) < 0.6, a, rng.integers(0, 4, 300))
    return a, b


@pytest.mark.parametrize("average", ["arithmetic", "geometric", "min", "max"])
@pytest.mark.parametrize("seed", [0, 1])
def test_nmi_averages_match_jax(average, seed):
    a, b = _labels(seed)
    got = external.normalized_mutual_info(a, b, average_method=average)
    want = jexternal.normalized_mutual_info(a, b, average_method=average)
    assert abs(got - want) <= 1e-12
    # min <= geometric <= arithmetic <= max for the denominators, so
    # NMI's order is the reverse
    if average == "min":
        assert got >= external.normalized_mutual_info(a, b, "max")


def test_nmi_default_is_arithmetic_and_unknown_average_raises():
    a, b = _labels(2)
    assert (external.normalized_mutual_info(a, b)
            == external.normalized_mutual_info(a, b, "arithmetic"))
    with pytest.raises(ValueError):
        external.normalized_mutual_info(a, b, average_method="harmonic")


FIT_DOCS = [
    "The night is young and the city lights are burning bright",
    "We were running through the rain, the rain, the endless rain",
    "Drums and bass and a hundred voices calling out my name",
    "city rain city night",
]
NEW_DOCS = [
    "rain rain city of neon and chrome",          # two known, two unknown
    "entirely unseen vocabulary here",            # nothing known: zeros
    "",
    "NIGHT night Night drums",                    # case folding
]


@pytest.mark.parametrize("stop_words", [None, "english"])
@pytest.mark.parametrize("max_features", [None, 6])
def test_tfidf_transform_matches_jax(stop_words, max_features):
    ours = tfidf.TfidfVectorizer(max_features=max_features,
                                 stop_words=stop_words)
    ref = jtfidf.TfidfVectorizer(max_features=max_features,
                                 stop_words=stop_words)
    ours.fit_transform(FIT_DOCS)
    ref.fit_transform(FIT_DOCS)
    assert ours.vocabulary_ == ref.vocabulary_
    got, want = ours.transform(NEW_DOCS), ref.transform(NEW_DOCS)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert not got[1].any() and not got[2].any()
    # transform of the fitted documents is fit_transform's output
    np.testing.assert_array_equal(ours.transform(FIT_DOCS),
                                  ours.fit_transform(FIT_DOCS))


PRESETS = ["MEL_MEDIUM", "CONV_MM_VAE_MEDIUM", "AE_BASELINE_HARD",
           "KMEANS_EASY", "KMEANS_HARD", "SWEEP_MEDIUM", "TEXT_MEDIUM",
           "TSNE_DEFAULT"]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equals_jax(name):
    ours, ref = getattr(config, name), getattr(jconfig, name)
    assert type(ours).__name__ == type(ref).__name__
    assert config.asdict(ours) == jconfig.asdict(ref)


def test_parallel_config_equals_jax(tmp_path):
    ours, ref = config.ParallelConfig(), jconfig.ParallelConfig()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert config.asdict(ours) == jconfig.asdict(ref)
    config.to_json(ours, tmp_path / "ours.json")
    jconfig.to_json(ref, tmp_path / "ref.json")
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


def test_to_json_round_trip_and_bytes(tmp_path):
    for name in PRESETS + ["MFCC_HARD", "HARD_CVAE"]:
        cfg = getattr(config, name)
        path = tmp_path / "nested" / f"{name}.json"
        config.to_json(cfg, path)
        jconfig.to_json(getattr(jconfig, name), tmp_path / f"{name}.jax.json")
        assert path.read_bytes() == (tmp_path / f"{name}.jax.json").read_bytes()
        back = type(cfg)(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in json.loads(path.read_text()).items()})
        assert back == cfg
