"""GPU tests of the port: each CUDA kernel against its plain version on the
card (kernel 1 also in the MFCC mode at the easy and hard tiers' frame
counts), the main path and the three tiers through both kernels at a small
size, MiniLM, MFCC stats, the scripts 13/16 sweep, the bf16 train step and
the full-width float32 conv step on cuDNN's measured engines on the card
against the CPU, and a resumed dense fit against a straight one.

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
    weights = tmel.filterbank_weights_tensor(cfg, gpu)
    for top_db, standardize, atol in ((80.0, True, 1e-4), (None, False, 1e-3)):
        before = build.launch_counts()["mel_db_standardize"]
        got = mel_db_standardize(spec, fb, top_db=top_db,
                                 standardize=standardize, bands=bands,
                                 weights=weights)
        assert build.launch_counts()["mel_db_standardize"] == before + 1
        want = mel_db_standardize_plain(spec, fb, top_db=top_db,
                                        standardize=standardize)
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
        # the filterbank table derived from fb on the host when not given
        torch.testing.assert_close(
            mel_db_standardize(spec, fb, top_db=top_db,
                               standardize=standardize), got, rtol=0, atol=0)


def _spec(gpu, n, cfg, seed):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.normal(0, 0.1, (n, cfg.n_samples))
                         .astype(np.float32)).to(gpu)
    return tstft.power_spectrogram(y)


@pytest.mark.parametrize("b,cfg_kw", [
    (1, dict(duration_s=1.0, n_mels=32)),      # one sample, T = 44
    (3, dict(duration_s=1.0, n_mels=128)),     # the 1 s shape at 128 mels
    (2, dict(duration_s=0.7, n_mels=32)),      # T = 31: odd, not a multiple of 8
    (2, dict(duration_s=0.1, n_mels=32)),      # T = 5: some blocks own no frame
])
@pytest.mark.parametrize("ref_max", [True, False])
@pytest.mark.parametrize("top_db,standardize,atol", [
    (80.0, True, 1e-4), (None, True, 1e-4), (80.0, False, 1e-3),
    (None, False, 1e-3)])
def test_logmel_kernel_shapes_and_options(gpu, b, cfg_kw, ref_max, top_db,
                                          standardize, atol):
    cfg = MelConfig(**cfg_kw)
    spec = _spec(gpu, b, cfg, seed=b)
    fb = tmel.mel_filterbank_tensor(cfg, gpu)
    kw = dict(ref_max=ref_max, top_db=top_db, standardize=standardize)
    got = mel_db_standardize(spec, fb, bands=tmel.filterbank_bands_tensor(
        cfg, gpu), weights=tmel.filterbank_weights_tensor(cfg, gpu), **kw)
    want = mel_db_standardize_plain(spec, fb, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_logmel_kernel_nan_sample_stays_non_finite(gpu):
    cfg = MelConfig(duration_s=1.0, n_mels=32)
    rng = np.random.default_rng(11)
    y = rng.normal(0, 0.1, (3, cfg.n_samples)).astype(np.float32)
    y[1, 5000] = np.nan
    spec = tstft.power_spectrogram(torch.from_numpy(y).to(gpu))
    fb = tmel.mel_filterbank_tensor(cfg, gpu)
    got = mel_db_standardize(spec, fb, top_db=80.0)
    finite = torch.isfinite(got).all(dim=2).all(dim=1).cpu().tolist()
    assert finite == [True, False, True]
    keep = torch.tensor([0, 2], device=gpu)
    torch.testing.assert_close(
        got[keep], mel_db_standardize_plain(spec, fb, top_db=80.0)[keep],
        rtol=0, atol=1e-4)


def test_logmel_kernel_repeats_bitwise_one_launch_a_call(gpu):
    cfg = MelConfig(duration_s=1.0, n_mels=128)
    spec = _spec(gpu, 4, cfg, seed=5)
    fb = tmel.mel_filterbank_tensor(cfg, gpu)
    before = build.launch_counts()["mel_db_standardize"]
    a = mel_db_standardize(spec, fb, top_db=80.0)
    assert build.launch_counts()["mel_db_standardize"] == before + 1
    b = mel_db_standardize(spec, fb, top_db=80.0)
    assert build.launch_counts()["mel_db_standardize"] == before + 2
    assert torch.equal(a, b)


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
            assert torch.equal(got, got.T)


@pytest.mark.parametrize("n,m,d", [(70, None, 20000), (70, 6, 20000),
                                   (45, None, 4099)])
def test_distance_kernel_split_k(gpu, n, m, d):
    """Split-K shapes (slices > 1): right, bit-identical across calls, one
    count a call."""
    from vae_hmc_tpu_torch.ops.kernels.distance import (n_tiles, occupancy,
                                                        split_k_bounds)
    rng = np.random.default_rng(n + d)

    def centred(rows):
        x = rng.normal(0, 1, (rows, d)).astype(np.float32)
        return torch.from_numpy(x - x.mean(axis=0)).to(gpu)

    x = centred(n)
    y = None if m is None else centred(m)
    tiles = n_tiles(n, m or n, m is None)
    assert len(split_k_bounds(tiles, d, *occupancy(gpu))) > 1
    before = build.launch_counts()["pairwise_dists"]
    got = pairwise_dists(x, y)
    again = pairwise_dists(x, y)
    assert build.launch_counts()["pairwise_dists"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, pairwise_dists_plain(x, y), rtol=1e-4,
                               atol=1e-2)
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


def test_minilm_on_gpu_matches_cpu(gpu):
    """The same synthetic weights (drawn on the host) on both devices; each
    batch padded to its own longest row, one row truncated at 256 tokens."""
    from vae_hmc_tpu_torch.text import minilm
    texts = ["the rain falls all night", "hello, world!",
             " ".join(["love", "unbelievable", "o'clock"] * 100), ""]
    cpu_model, tok = minilm.synthetic_minilm(texts, seed=3, device="cpu")
    gpu_model, _ = minilm.synthetic_minilm(texts, seed=3, device=gpu)
    want = minilm.encode_texts(cpu_model, tok, texts, batch_size=3)
    got = minilm.encode_texts(gpu_model, tok, texts, batch_size=3)
    assert got.shape == (4, 384)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_sweep_on_gpu_matches_cpu(gpu):
    """Scripts 13 and 16's suite and sweep on the card against the CPU: the
    same rows, metrics within atol 1e-4, every distance from kernel 2."""
    from tests import torch_sweep_data as sweep_data
    from vae_hmc_tpu_torch.cluster import sweep
    from vae_hmc_tpu_torch.core.align import labels_for_ids
    arrays, genre_map = sweep_data.reps_data()
    rows = {}
    before = build.launch_counts()["pairwise_dists"]
    for dev in ("cpu", gpu):
        reps = [sweep.RepData.build(name, x, labels_for_ids(ids, genre_map),
                                    device=dev)
                for name, (x, ids) in arrays.items()]
        rows[str(dev)] = [r for rep in reps for r in
                          sweep.cluster_suite(rep, 6) + sweep.full_sweep(rep)]
    assert build.launch_counts()["pairwise_dists"] > before
    ours, ref = rows["cuda"], rows["cpu"]
    assert len(ours) == len(ref) == 3 * (7 + 34)
    for r, c in zip(ours, ref):
        assert list(r) == list(c)
        for key, a in r.items():
            if key in ("silhouette", "davies_bouldin", "ari", "score",
                       "noise_frac") and a is not None:
                assert a == pytest.approx(c[key], abs=1e-4), (key, r, c)
            else:
                assert a == c[key], (key, r, c)


def _low_rank(rng, n, d):
    u = np.linalg.qr(rng.normal(0, 1, (n, 4)))[0]
    v = np.linalg.qr(rng.normal(0, 1, (d, 4)))[0]
    s = np.sqrt(n) * np.array([0.5, 0.4, 0.3, 0.2])
    return ((u * s) @ v.T + 0.005 * rng.normal(0, 1, (n, d))
            + rng.normal(0, 1, d)).astype(np.float32)


def test_pca_and_tsne_on_gpu_match_cpu(gpu):
    """PCA (Gram and scatter sides) and t-SNE's P and optimizer on the card
    against the CPU; the card's squared distances come from kernel 2."""
    from vae_hmc_tpu_torch.ops.pca import PCA
    from vae_hmc_tpu_torch.viz import tsne
    rng = np.random.default_rng(12)
    for shape in ((40, 300), (300, 24)):
        x = _low_rank(rng, *shape)
        got, want = PCA(3, device=gpu).fit(x), PCA(3, device="cpu").fit(x)
        assert got.components_.device.type == "cuda"
        torch.testing.assert_close(got.components_.cpu(), want.components_,
                                   rtol=0, atol=1e-4)
        torch.testing.assert_close(got.transform(x).cpu(), want.transform(x),
                                   rtol=0, atol=1e-4)
    x = torch.from_numpy(rng.normal(0, 1, (200, 10)).astype(np.float32))
    before = build.launch_counts()["pairwise_dists"]
    p_gpu = tsne._binary_search_perplexity(tsne.input_sq_dists(x.to(gpu)),
                                           30.0)
    assert build.launch_counts()["pairwise_dists"] == before + 1
    p_cpu = tsne._binary_search_perplexity(tsne.input_sq_dists(x), 30.0)
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=0, atol=1e-5)
    y0 = 1e-2 * torch.from_numpy(rng.normal(0, 1, (200, 2)).astype(
        np.float32))
    got = tsne._tsne_optimize(p_cpu.to(gpu), y0.to(gpu), 200.0, n_iter=3)
    want = tsne._tsne_optimize(p_cpu, y0, 200.0, n_iter=3)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_umap_on_gpu(gpu):
    """UMAP's chain on the card against the CPU, on a 4 x 1 rectangle
    whose first two Laplacian eigenvectors are well separated (on separated
    blobs they are nearly degenerate and any rotation of them is right),
    and the embedding of three blobs.  Limits, from the readings of
    vae_hmc_tpu_torch.tools.umap_init_spread on an H100 (PERF.md):
      * the graph stages (kNN, rho, sigma, edge weights) from the CPU's
        distance matrix at 1e-6 (read: at most 1.2e-7), from kernel 2's at
        1e-5, the edge weights at 5e-5 (read: 3.6e-6 on the distances,
        1.7e-5 on the weights, which divide by sigma); kNN indices exact;
      * the sparse init of the card's own chain (kernel 2 -> kNN -> edge
        list -> init, one start block) at 1e-2 of its +-10 box: 150 fp32
        iterations carry last-bit changes of the weights to the 1e-3 level
        (one-ulp moves of the weights move the CPU's init by up to 3.7e-3,
        tests/test_torch_viz.py), and index_add_'s atomics reorder each
        matvec's sums; 40 runs on the card read 0.6e-3 to 6.2e-3."""
    from vae_hmc_tpu_torch.cluster.kmeans import kmeans_fit_predict
    from vae_hmc_tpu_torch.metrics.external import adjusted_rand_index
    from vae_hmc_tpu_torch.metrics.internal import center
    from vae_hmc_tpu_torch.tools import umap_init_spread as spread
    from vae_hmc_tpu_torch.viz import umap
    x, q0 = spread.rectangle()
    d_cpu = pairwise_dists_plain(center(x, x.device))
    want = spread.stages(d_cpu)
    before = build.launch_counts()["pairwise_dists"]
    d_gpu = pairwise_dists(center(x.to(gpu), gpu))
    assert build.launch_counts()["pairwise_dists"] == before + 1
    own = spread.stages(d_gpu)
    for got, atol, atol_w in ((spread.stages(d_cpu.to(gpu)), 1e-6, 1e-6),
                              (own, 1e-5, 5e-5)):
        # [knn_d, knn_i, rho, sigma, heads, tails, weights]
        for i, (g, w) in enumerate(zip(got, want)):
            if w.dtype == torch.int64:
                assert torch.equal(g.cpu(), w)
            else:
                torch.testing.assert_close(g.cpu(), w, rtol=0,
                                           atol=atol_w if i == 6 else atol)
    gap = spread.signed_gap(spread.init(*own[4:], q0),
                            spread.init(*want[4:], q0))
    assert gap <= 1e-2, gap
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 8, (3, 10))
    y = np.repeat(np.arange(3), 60)
    x = torch.from_numpy((centers[y] + rng.normal(0, 0.8, (180, 10)))
                         .astype(np.float32))
    emb = umap.umap_2d(x.to(gpu), n_neighbors=12, n_epochs=200, seed=0)
    assert emb.shape == (180, 2) and np.isfinite(emb).all()
    yhat = kmeans_fit_predict(emb, 3, n_init=5, seed=0, device=gpu)
    assert adjusted_rand_index(y, yhat) > 0.95


def test_medium_pipeline_small_on_gpu(gpu, tmp_path):
    """run_medium_pipeline at the CPU test's size on the card: the tier's
    files (figures as .png or .npz), 21 and 24 rows, both kernels."""
    from vae_hmc_tpu_torch.core.config import (ConvMMVaeConfig, SweepConfig,
                                               TextEmbedConfig, Workspace)
    from vae_hmc_tpu_torch.pipelines import medium
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource
    ws = Workspace(tmp_path)
    before = build.launch_counts()
    out = medium.run_medium_pipeline(
        SyntheticSource.make(n_tracks=36, seed=1, lyrics_coverage=0.8), ws,
        MelConfig(duration_s=1.5, n_mels=32), TextEmbedConfig(),
        ConvMMVaeConfig(epochs=2, batch_size=12, latent_dim=8,
                        audio_fc_dim=32),
        SweepConfig(ks=(4, 6), dbscan_eps=(0.5, 1.0),
                    dbscan_min_samples=(3, 5)),
        device_batch=12, device=gpu)
    after = build.launch_counts()
    assert after["mel_db_standardize"] - before["mel_db_standardize"] == 3
    assert after["pairwise_dists"] > before["pairwise_dists"]
    assert len(out["suite"]) == 21 and len(out["sweep"]) == 24
    ext = "." + out["figures"]
    for rel in ("data/audio_cnn_mel_X.npy",
                "results/vae_conv_mm_medium/ckpt_epoch_002.pt",
                "results/report_medium/best_filtered.csv",
                "results/cluster_viz/side_by_side_medium" + ext,
                "results/cluster_viz/lyrics_dbscan_eps_sweep_noise_medium"
                + ext, "results/timing_medium.json"):
        assert (tmp_path / rel).exists(), rel
    assert out["quality_drift"]["key"] == "medium:gpu:36"
    for xy in out["viz15"]["embeddings"]["umap"]:
        assert xy.shape[1] == 2 and np.isfinite(xy).all()


@pytest.mark.parametrize("duration_s", [30.0, 20.0])     # T = 1,292 and 862
def test_logmel_kernel_mfcc_mode_at_tier_shapes(gpu, duration_s):
    """Kernel 1 in the MFCC mode (ref 1.0, 80 dB floor, no standardize) at
    the easy and hard tiers' frame counts, against its plain version: raw
    dB, atol 1e-3 as the other unstandardized cases."""
    from vae_hmc_tpu_torch.core.config import MfccConfig
    cfg = MfccConfig(duration_s=duration_s)
    spec = _spec(gpu, 3, cfg, seed=int(duration_s))
    assert spec.shape[2] == 1 + cfg.n_samples // cfg.hop_length
    fb = tmel.mel_filterbank_tensor(cfg, gpu)
    kw = dict(ref_max=False, top_db=80.0, standardize=False)
    before = build.launch_counts()["mel_db_standardize"]
    got = mel_db_standardize(spec, fb, bands=tmel.filterbank_bands_tensor(
        cfg, gpu), weights=tmel.filterbank_weights_tensor(cfg, gpu), **kw)
    assert build.launch_counts()["mel_db_standardize"] == before + 1
    torch.testing.assert_close(got, mel_db_standardize_plain(spec, fb, **kw),
                               rtol=0, atol=1e-3)


def test_mfcc_stats_on_gpu_match_cpu(gpu):
    """mfcc_stats_batch through kernel 1 on the card against the CPU's
    plain path, full-length and masked to true lengths: dB-scale stats,
    atol 1e-3."""
    from vae_hmc_tpu_torch.core.config import MfccConfig
    from vae_hmc_tpu_torch.ops.mfcc import mfcc_stats_batch
    rng = np.random.default_rng(4)
    cfg = MfccConfig(duration_s=20.0, min_duration_s=1.0)
    y = torch.from_numpy(rng.normal(0, 0.1, (3, cfg.n_samples))
                         .astype(np.float32))
    lengths = torch.tensor([cfg.n_samples, 200000, 30000])
    for kw in ({}, {"lengths": lengths}):
        before = build.launch_counts()["mel_db_standardize"]
        got = mfcc_stats_batch(y.to(gpu), cfg, **{
            k: v.to(gpu) for k, v in kw.items()})
        assert build.launch_counts()["mel_db_standardize"] == before + 1
        want = mfcc_stats_batch(y, cfg, **kw)
        assert got.shape == (3, 80)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-3)


def test_easy_and_hard_pipelines_small_on_gpu(gpu, tmp_path):
    """run_easy_pipeline and run_hard_pipeline at the CPU tests' sizes on
    the card: their files (figures as .png or .npz) and both kernels."""
    from vae_hmc_tpu_torch.core.config import (AeConfig, DenseVaeConfig,
                                               HardVaeConfig, KMeansConfig,
                                               MfccConfig, TextEmbedConfig,
                                               Workspace)
    from vae_hmc_tpu_torch.pipelines import easy, hard
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource
    before = build.launch_counts()
    out = easy.run_easy_pipeline(
        SyntheticSource.make(n_tracks=48, seed=0), Workspace(tmp_path / "e"),
        MfccConfig(duration_s=2.0), DenseVaeConfig(latent_dim=8, epochs=6,
                                                   batch_size=16),
        KMeansConfig(n_clusters=6, n_init=4), device_batch=16, device=gpu)
    mid = build.launch_counts()
    assert mid["mel_db_standardize"] - before["mel_db_standardize"] == 3
    assert mid["pairwise_dists"] > before["pairwise_dists"]
    ext = "." + out["figures"]
    for rel in ("results/vae_basic/vae_basic.pt",
                "results/vae_basic/scaler.joblib",
                "results/compare_metrics/metrics.csv",
                "results/viz_vae/plots/vae_umap" + ext,
                "results/timing_easy.json"):
        assert (tmp_path / "e" / rel).exists(), rel
    assert out["quality_drift"]["key"] == "easy:gpu:48"
    out = hard.run_hard_pipeline(
        SyntheticSource.make(n_tracks=36, seed=2, lyrics_coverage=0.85),
        Workspace(tmp_path / "h"), MfccConfig(duration_s=2.0,
                                              min_duration_s=1.0),
        TextEmbedConfig(), HardVaeConfig(hidden_dim=32, latent_dim=6,
                                         epochs=3, batch_size=12),
        AeConfig(hidden_dim=32, latent_dim=6, epochs=3, batch_size=12),
        tag="t", device_batch=12, device=gpu)
    after = build.launch_counts()
    assert after["mel_db_standardize"] - mid["mel_db_standardize"] == 3
    assert after["pairwise_dists"] - mid["pairwise_dists"] >= 5
    assert len(out["baselines"]) == 4
    for rel in ("models/hard/beta_vae_multimodal_t.pt",
                "results/hard/baseline_comparison.csv",
                "results/hard/plots/recon_examples" + ext,
                "results/timing_hard.json"):
        assert (tmp_path / "h" / rel).exists(), rel


def _silent_and_tailed(n: int, n_samples: int, sr: int, seed: int):
    """(n, n_samples) noise with row 0 all zeros (a row that failed to
    decode), row 1 zero past 0.5 s and row 2 zero past 8 s (short clips'
    padded tails)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0, 0.1, (n, n_samples)).astype(np.float32)
    y[0] = 0.0
    y[1, int(0.5 * sr):] = 0.0
    y[2, int(8.0 * sr):] = 0.0
    return y


@pytest.mark.parametrize("b", [6, 64])
@pytest.mark.parametrize("mode,duration_s", [("standardized", 15.0),
                                             ("mfcc", 30.0), ("mfcc", 20.0)])
def test_logmel_kernel_on_silent_and_zero_tailed_rows(gpu, b, mode,
                                                      duration_s):
    """Kernel 1 on the inputs a file-backed batch holds: an all-zero row
    (its mel slice is constant: max = amin, centred variance exactly 0, and
    standardize divides by 0 + eps) and zero tails, against the plain
    version: the standardized mode at T = 646, the MFCC mode at T = 1,292
    and 862; atol 1e-4 standardized, 1e-3 dB raw."""
    from vae_hmc_tpu_torch.core.config import MfccConfig
    cfg = (MelConfig(duration_s=duration_s) if mode == "standardized"
           else MfccConfig(duration_s=duration_s))
    y = _silent_and_tailed(b, cfg.n_samples, cfg.sample_rate, seed=b)
    spec = tstft.power_spectrogram(torch.from_numpy(y).to(gpu),
                                   n_fft=cfg.n_fft, hop_length=cfg.hop_length)
    fb = tmel.mel_filterbank_tensor(cfg, gpu)
    kw = (dict(top_db=tmel.effective_top_db(cfg), standardize=True)
          if mode == "standardized"
          else dict(ref_max=False, top_db=80.0, standardize=False))
    got = mel_db_standardize(spec, fb, bands=tmel.filterbank_bands_tensor(
        cfg, gpu), weights=tmel.filterbank_weights_tensor(cfg, gpu), **kw)
    want = mel_db_standardize_plain(spec, fb, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 if mode == "standardized" else 1e-3)
    if mode == "standardized":          # the silent row standardizes to 0
        assert float(got[0].abs().max()) == 0.0


def test_file_source_mfcc_stats_on_gpu_match_cpu(gpu, tmp_path):
    """FileSource -> build_mfcc_stats on the card (prefetch thread, pinned
    copies, kernel 1) against the port on the CPU, on the 13-row WAV corpus
    with a short clip: the same ids and report rows; stats atol 1e-3."""
    from tests.torch_audio_data import corpus_rows
    from vae_hmc_tpu_torch.core.config import MfccConfig
    from vae_hmc_tpu_torch.core.manifest import read_manifest, write_manifest
    from vae_hmc_tpu_torch.pipelines.features import build_mfcc_stats
    from vae_hmc_tpu_torch.pipelines.sources import FileSource
    write_manifest(tmp_path / "m.csv",
                   corpus_rows(tmp_path, seconds=1.5, short={3: 0.6}))
    source = FileSource.from_manifest(read_manifest(tmp_path / "m.csv"),
                                      root=tmp_path)
    for cfg in (MfccConfig(duration_s=1.0),
                MfccConfig(duration_s=1.0, min_duration_s=0.5)):
        before = build.launch_counts()["mel_db_standardize"]
        got, ids, rep = build_mfcc_stats(source, cfg, device_batch=5,
                                         device=gpu)
        assert build.launch_counts()["mel_db_standardize"] == before + 3
        want, wids, wrep = build_mfcc_stats(source, cfg, device_batch=5,
                                            device="cpu")
        np.testing.assert_array_equal(ids, wids)
        assert rep.rows == wrep.rows and len(ids) == 12
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _fit_case(kind, device):
    """A small ConvMMVAE or DenseVAE seeded on the host, its data, and the
    fit arguments (the test shapes of tests/test_torch_fit_options.py)."""
    from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
    from vae_hmc_tpu_torch.models.dense_vae import DenseVAE
    rng = np.random.default_rng(0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if kind == "conv":
            model = ConvMMVAE(n_mels=32, n_frames=48, latent_dim=8, fc_dim=64)
            arrays = [rng.normal(0, 1, (24, 32, 48, 1)),
                      rng.normal(0, 1, (24, 384)),
                      (rng.random((24, 1)) < 0.7)]
            kw = dict(batch_size=8, learning_rate=2e-3, seed=0)
        else:
            model = DenseVAE(24, (32, 32), 6)
            arrays = [rng.standard_normal((50, 24))]
            kw = dict(batch_size=16, learning_rate=1e-3, seed=5)
    return (model.to(device),
            [torch.tensor(a, dtype=torch.float32, device=device)
             for a in arrays], kw)


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_bf16_fit_on_gpu_matches_cpu(gpu, kind):
    """The bf16 step on the card against the same step on the CPU, with the
    same injected permutations and noise: every layer computes in bf16,
    the weights stay float32, and each history column is within 2e-3 of
    the epoch's total (one bf16 rounding unit of the loss; cuDNN/cuBLAS
    against the CPU's bf16 kernels)."""
    from vae_hmc_tpu_torch.models.train import fit
    n, bs, lat = (24, 8, 8) if kind == "conv" else (50, 16, 6)
    perms = [np.random.default_rng(e).permutation(n) for e in range(3)]
    rng = np.random.default_rng(3)
    eps = {(e, s // bs): rng.standard_normal((len(perms[e][s:s + bs]), lat))
           .astype(np.float32) for e in range(3) for s in range(0, n, bs)}
    histories = []
    for dev in ("cpu", gpu):
        model, arrays, kw = _fit_case(kind, dev)
        seen = set()
        for layer in model.modules():
            if not list(layer.children()):
                layer.register_forward_hook(
                    lambda mod, inp, out: seen.add(out.dtype))
        res = fit(model, arrays, epochs=3, compute_dtype="bfloat16",
                  perms=perms, eps_fn=lambda e, i: torch.from_numpy(eps[e, i]),
                  **kw)
        assert seen == {torch.bfloat16}
        assert all(p.dtype == torch.float32 for p in model.parameters())
        histories.append(res.history)
    for c, g in zip(*histories):
        gap = max(abs(c[k] - g[k]) for k in ("total", "recon", "kl"))
        print(f"bf16 {kind} epoch {c['epoch']}: card - cpu {gap:.3e} "
              f"of total {c['total']:.6f}")
        assert gap <= 2e-3 * abs(c["total"]), (c, g)


class _ReluMasks(torch.overrides.TorchFunctionMode):
    """Inside it every ``F.relu`` records its output's sign pattern, in call
    order; given recorded `masks`, each call applies its mask instead (the
    same activation pattern, so the same gradient paths)."""

    def __init__(self, masks=None):
        super().__init__()
        self.masks, self.seen = masks, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.nn.functional.relu:
            return func(*args, **kwargs)
        if self.masks is None:
            out = func(*args, **kwargs)
            self.seen.append((out > 0).cpu())
            return out
        mask = self.masks[len(self.seen)]
        self.seen.append(mask)
        return args[0] * mask.to(args[0])


def test_conv_step_under_measured_engines_matches_float64(gpu, monkeypatch):
    """One full-width (128 x 646) ConvMMVAE step at batch 64 under the conv
    fit's scope (cuDNN's measured engines): TF32 stays off inside it, and
    every weight's gradient is within 1e-4 of its norm of the same step in
    float64 on the CPU (worst leaf).  The card's step runs twice, the second
    on the engines the first measured.  The float64 step takes the card's
    ReLU sign patterns: a pre-activation within rounding of zero flips its
    unit on or off, and those few units alone put the float32 step up to
    5.7e-4 off float64 on any engine; with the patterns shared it reads
    about 1e-6, and with TF32 on 7.5e-4 (H100)."""
    from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig
    from vae_hmc_tpu_torch.core.device import (TIMED_ENGINES,
                                               measured_conv_engines,
                                               resolve_device)
    from vae_hmc_tpu_torch.models.api import build_conv_mm_vae
    from vae_hmc_tpu_torch.models.losses import elbo_loss
    resolve_device(gpu)                                   # parity mode
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    rng = np.random.default_rng(15)
    inputs = (rng.standard_normal((64, 128, 646, 1)),
              rng.standard_normal((64, 384)),
              rng.random((64, 1)) < 0.9,
              rng.standard_normal((64, 32)))

    def step(dev, dtype, steps, masks=None):
        model = build_conv_mm_vae(ConvMMVaeConfig(), 128, 646, 384).to(
            dev, dtype)
        x, lyr, m, eps = (torch.tensor(a, dtype=dtype, device=dev)
                          for a in inputs)
        for _ in range(steps):
            model.zero_grad(set_to_none=True)
            relu = _ReluMasks(masks)
            with relu:
                xhat, mu, logvar = model(x, lyr, m, eps=eps)
            elbo_loss(xhat, x, mu, logvar)[0].backward()
        return relu.seen, {k: p.grad.to("cpu", torch.float64)
                           for k, p in model.named_parameters()
                           if p.grad is not None}

    with measured_conv_engines():
        assert torch.backends.cudnn.benchmark is True
        assert torch.backends.cudnn.benchmark_limit == TIMED_ENGINES
        assert torch.backends.cudnn.allow_tf32 is False
        masks, got = step(gpu, torch.float32, 2)
    _, want = step("cpu", torch.float64, 1, masks)
    assert set(got) == set(want) and len(want) > 20
    gaps = {k: float((got[k] - w).norm() / w.norm()) for k, w in want.items()}
    worst = max(gaps, key=gaps.get)
    print(f"measured engines, card float32 vs CPU float64: worst leaf "
          f"{worst} {gaps[worst]:.3e}, median "
          f"{float(np.median(list(gaps.values()))):.3e}")
    assert gaps[worst] <= 1e-4, gaps


def test_dense_resume_on_gpu_bit_for_bit(gpu, tmp_path):
    """On the card, with the port's own random streams: 2 epochs, a
    checkpoint, and a resumed fit to 4 equal the straight 4 bit for bit
    (weights and history)."""
    from vae_hmc_tpu_torch.models.train import fit
    straight, arrays, kw = _fit_case("dense", gpu)
    rs = fit(straight, arrays, epochs=4, **kw)
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    fit(_fit_case("dense", gpu)[0], arrays, epochs=2, **ck, **kw)
    resumed = _fit_case("dense", gpu)[0]
    rr = fit(resumed, arrays, epochs=4, **ck, **kw)
    assert rr.history == rs.history
    for (name, a), b in zip(straight.state_dict().items(),
                            resumed.state_dict().values()):
        assert torch.equal(a, b), name


def _dp_case():
    """A DenseVAE (24 -> 32 -> 32 -> 6, 50 rows at batch 16, 3 epochs) as a
    job of tests/torch_dist_workers.fit_job, seeded weights."""
    from tests.torch_dist_workers import build_model
    spec = ("dense", (24, (32, 32), 6, 0))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = build_model(spec)
    return dict(model=spec, state={k: v.numpy() for k, v in
                                   model.state_dict().items()},
                arrays=[np.random.default_rng(0).standard_normal(
                    (50, 24)).astype(np.float32)],
                kw=dict(epochs=3, batch_size=16, learning_rate=1e-3, seed=5))


def _fit_on_one_card(job, gpu):
    from tests.torch_dist_workers import build_model
    from vae_hmc_tpu_torch.core.device import resolve_device
    from vae_hmc_tpu_torch.models.train import fit
    resolve_device(gpu)
    model = build_model(job["model"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in job["state"].items()})
    model.to(gpu)
    return fit(model, [torch.from_numpy(a).to(gpu) for a in job["arrays"]],
               **job["kw"]).history


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_dp_fit_on_the_card_matches_fit(gpu, tmp_path, world, backend):
    """dp_fit on spawned ranks of one card (NCCL at world size 1, the
    production backend; gloo with CUDA tensors on 2 ranks, data parallel)
    against fit in this process on the card: histories within 1e-6
    relative (the order of reduction), every rank the same."""
    from tests.torch_dist_workers import run_jobs, run_ranks
    job = _dp_case()
    out = run_ranks(run_jobs, world, tmp_path, {"fit": ("fit_job", dict(
        job, mesh_shape=(world, 1), device="cuda"))}, backend=backend,
        device="cuda", timeout_s=60.0, join_s=300.0)
    ref = _fit_on_one_card(job, gpu)
    for rank in out:
        got = rank["fit"]["history"]
        assert got == out[0]["fit"]["history"]
        for g, w in zip(got, ref):
            for k in ("total", "recon", "kl"):
                assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]) + 1e-7, (g, w)


def test_logmel_kernel_sharded_on_two_ranks(gpu, tmp_path):
    """Kernel 1 through logmel_batch_sharded on 2 gloo ranks of the card
    (7 rows: 4 on rank 0, 3 and a padding row on rank 1): each rank
    launches it once and every rank's whole result is within phase 2's
    raw-dB 1e-3 of the plain version."""
    from tests.torch_dist_workers import run_jobs, run_ranks
    cfg = dict(duration_s=1.0, n_mels=128)
    y = np.random.default_rng(5).normal(0, 0.1, (7, 22050)).astype(
        np.float32)
    out = run_ranks(run_jobs, 2, tmp_path, {"k1": ("logmel_kernel_job", dict(
        y=y, mel_kw=cfg))}, backend="gloo", device="cuda", timeout_s=60.0,
        join_s=300.0)
    for rank in out:
        assert rank["k1"]["shape"] == (7, 128, 44)
        assert rank["k1"]["launches"] == 1
        assert rank["k1"]["max_abs_err"] <= 1e-3


def test_run_bench_small_on_the_card(gpu, tmp_path, monkeypatch):
    """The benchmark entry point at 64 tracks, 1 epoch and 1 s clips on the
    card: the kernel smoke (both kernels against their plain versions at
    bench scale) reads ok, both kernels run in the timed stages, and the
    line names the card."""
    from vae_hmc_tpu_torch.bench import run_bench
    empty = tmp_path / "goldens.json"
    empty.write_text("{}\n")
    monkeypatch.setenv("VAE_HMC_GOLDENS_PATH", str(empty))
    build.reset_launch_counts()
    r = run_bench(n_tracks=64, epochs=1, duration_s=1.0, device="cuda",
                  lyrics_backend="hashed")
    assert r["pallas_smoke"].startswith("ok (CUDA kernels")
    assert r["device"] == torch.cuda.get_device_name(0)
    assert r["n_tracks"] == 64 and r["quality_drift"] == "no-golden"
    assert -1.0 <= r["silhouette"] <= 1.0 and r["davies_bouldin"] > 0.0
    counts = build.launch_counts()     # the smoke's 2 and the timed stages'
    assert counts["mel_db_standardize"] >= 2 and counts["pairwise_dists"] >= 2
