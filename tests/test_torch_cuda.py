"""GPU tests of the port: each CUDA kernel against its plain version on the
card, and the main path through both kernels at a small size.

Marked ``cuda``; they skip without a GPU.  The GPU machine has no JAX and
tests/conftest.py imports it, so this file imports torch and numpy only and
runs there with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from vae_hmc_tpu_torch.core.config import MelConfig
from vae_hmc_tpu_torch.ops import mel as tmel
from vae_hmc_tpu_torch.ops import stft as tstft
from vae_hmc_tpu_torch.ops.kernels import build
from vae_hmc_tpu_torch.ops.kernels.distance import (pairwise_dists,
                                                    pairwise_dists_plain)
from vae_hmc_tpu_torch.ops.kernels.logmel import (mel_db_standardize,
                                                  mel_db_standardize_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def test_logmel_kernel_matches_plain(gpu):
    rng = np.random.default_rng(7)
    cfg = MelConfig(duration_s=1.0, n_mels=32)
    y = torch.from_numpy(rng.normal(0, 0.1, (4, cfg.n_samples))
                         .astype(np.float32)).to(gpu)
    spec = tstft.power_spectrogram(y)
    fb = tmel.mel_filterbank_tensor(cfg, gpu)
    bands = tmel.filterbank_bands_tensor(cfg, gpu)
    for top_db, standardize, atol in ((80.0, True, 1e-4), (None, False, 1e-3)):
        before = build.launch_counts()["mel_db_standardize"]
        got = mel_db_standardize(spec, fb, top_db=top_db,
                                 standardize=standardize, bands=bands)
        assert build.launch_counts()["mel_db_standardize"] == before + 1
        want = mel_db_standardize_plain(spec, fb, top_db=top_db,
                                        standardize=standardize)
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
        # bands derived from fb on the host when not given
        torch.testing.assert_close(
            mel_db_standardize(spec, fb, top_db=top_db,
                               standardize=standardize), got, rtol=0, atol=0)


def test_distance_kernel_matches_plain(gpu):
    rng = np.random.default_rng(3)

    def centred(n, d):
        x = rng.normal(0, 1, (n, d)).astype(np.float32)
        return torch.from_numpy(x - x.mean(axis=0)).to(gpu)

    for n, m, d in ((300, None, 32), (37, None, 17), (130, 6, 40)):
        x = centred(n, d)
        y = None if m is None else centred(m, d)
        got = pairwise_dists(x, y)
        torch.testing.assert_close(got, pairwise_dists_plain(x, y),
                                   rtol=1e-4, atol=1e-2)
        if m is None:
            assert torch.count_nonzero(got.diagonal()) == 0


def test_main_path_small_on_gpu(gpu):
    from vae_hmc_tpu_torch.pipelines.bench_chain import run_core
    r = run_core(n_tracks=48, epochs=1, device=gpu, duration_s=1.0,
                 device_batch=16)
    assert r["launches"] == {"mel_db_standardize": 3, "pairwise_dists": 3}
    assert r["feature_shape"] == [48, 128, 44, 1]
    assert np.isfinite([r["silhouette"], r["davies_bouldin"],
                        r["train_final_loss"]]).all()
