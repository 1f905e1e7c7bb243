"""The port's process groups, row arithmetic, row-sharded staging and
sharded features (``parallel/{multihost,features_dp}``) against the JAX
package, and a 4-rank run of ``__graft_entry__.dryrun_multichip``'s steps.

The row arithmetic is checked here against the JAX package's for the same
counts: ``padded_rows``, the divmod ``process_row_range``, and with a mesh
the range of rank r = the P('data') shard of the JAX mesh's device at grid
position r (a rank is one device).  The rest runs in spawned ranks (gloo on
the CPU, a 60 s process-group timeout, a join timeout;
``tests/torch_dist_workers``): one 4-rank spawn for the features, the
staging and the dryrun, one 2-rank spawn whose rank 1 skips a collective.
The sharded features are held to ``vae_hmc_tpu.parallel.features_dp`` on
its 8-device mesh at ``tests/test_features_dp.py``'s 2e-4, and the
synthetic source's sharded build to the port's ``build_logmel`` bit for
bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.torch_dist_workers import run_jobs, run_ranks
from vae_hmc_tpu.core.config import MelConfig as JMelConfig
from vae_hmc_tpu.core.config import MfccConfig as JMfccConfig
from vae_hmc_tpu.parallel import features_dp as jfeatures
from vae_hmc_tpu.parallel import multihost as jmh
from vae_hmc_tpu.parallel.mesh import make_mesh as jmake_mesh
from vae_hmc_tpu_torch.core.config import MelConfig
from vae_hmc_tpu_torch.parallel import multihost as mh
from vae_hmc_tpu_torch.parallel.mesh import Mesh
from vae_hmc_tpu_torch.pipelines.features import build_logmel
from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this module's tests, as the ranks run (the same
    GEMM blocking), and the caller's count again after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MEL = dict(duration_s=1.5)
MFCC = dict(duration_s=1.5, min_duration_s=0.5)
FULL = np.random.default_rng(2).normal(size=(10, 3)).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(1)
    mel_cfg, mfcc_cfg = JMelConfig(**MEL), JMfccConfig(**MFCC)
    y_mel = rng.normal(0, 0.1, (13, mel_cfg.n_samples)).astype(np.float32)
    y_mfcc = rng.normal(0, 0.1, (11, mfcc_cfg.n_samples)).astype(np.float32)
    lengths = rng.integers(mfcc_cfg.n_samples // 2, mfcc_cfg.n_samples,
                           size=(11,)).astype(np.int32)
    for r in range(11):
        y_mfcc[r, int(lengths[r]):] = 0.0
    return y_mel, y_mfcc, lengths


def _medium_inputs():
    """13 tracks of (16, 24) log-mel, 10 of them with lyrics embeddings."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (13, 16, 24)).astype(np.float32)
    ids = np.arange(100, 113)
    emb = rng.normal(0, 1, (10, 384)).astype(np.float32)
    return dict(x=x, ids=ids, emb=emb, l_ids=ids[::-1][:10],
                cfg_kw=dict(epochs=2, batch_size=4, audio_fc_dim=32,
                            latent_dim=8))


@pytest.fixture(scope="module")
def medium_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("medium_ws")
    (root / "data").mkdir()              # script 10's, as the tier has it
    return root


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, medium_root):
    y_mel, y_mfcc, lengths = _inputs()
    jobs = {"medium": ("medium_job", dict(root=str(medium_root),
                                          mesh_shape=(2, 2),
                                          **_medium_inputs())),
            "features": ("features_job", dict(
                mesh_shape=(4, 1), y_mel=y_mel, mel_kw=MEL, y_mfcc=y_mfcc,
                lengths=lengths, mfcc_kw=MFCC, n_synth=11, synth_batch=4)),
            "features_tp": ("features_job", dict(
                mesh_shape=(2, 2), y_mel=y_mel, mel_kw=MEL, y_mfcc=y_mfcc,
                lengths=lengths, mfcc_kw=MFCC, n_synth=11, synth_batch=4)),
            "multihost": ("multihost_job", dict(full=FULL)),
            "dryrun": ("dryrun_job", {})}
    return run_ranks(run_jobs, 4, tmp_path_factory.mktemp("ranks4"), jobs,
                     timeout_s=60.0, join_s=150.0)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 2), (1, 1)])
@pytest.mark.parametrize("n", [0, 7, 10, 45, 2924])
def test_row_ranges_match_jax(shape, n):
    jmesh = jmake_mesh(shape[0] * shape[1], shape=shape)
    mesh = Mesh(shape={"data": shape[0], "model": shape[1]})
    assert mh.padded_rows(n, mesh) == jmh.padded_rows(n, jmesh)
    n_pad = jmh.padded_rows(n, jmesh)
    spans = NamedSharding(jmesh, P("data")).devices_indices_map((n_pad,))
    for rank, dev in enumerate(jmesh.devices.flat):
        s = spans[dev][0]
        lo, hi = s.start or 0, n_pad if s.stop is None else s.stop
        assert mh.process_row_range(n, process_id=rank, mesh=mesh) == (
            min(lo, n), min(hi, n)), (rank, n)
        m = Mesh(shape=mesh.shape, rank=rank)
        assert mh.process_row_range(n, mesh=m) == (min(lo, n), min(hi, n))
    for pc in (1, 3, 4, 8):
        for pid in range(pc):
            assert mh.process_row_range(n, pid, pc) == jmh.process_row_range(
                n, pid, pc)


def test_global_mesh_layout_matches_jax():
    """Rank r of a (4, 2) mesh sits where the JAX package's global_mesh(2)
    puts device r: row r // 2, column r % 2 (each row one tensor-parallel
    group of consecutive ranks)."""
    jmesh = jmh.global_mesh(model_parallel=2)
    assert dict(jmesh.shape) == {"data": 4, "model": 2}
    for (d, m), dev in np.ndenumerate(jmesh.devices):
        mesh = Mesh(shape={"data": 4, "model": 2}, rank=dev.id)
        assert (mesh.data_index, mesh.model_index) == (d, m)
    with pytest.raises(ValueError):
        jmh.global_mesh(model_parallel=3)
    with pytest.raises(ValueError, match="divisible"):
        mh.global_mesh(model_parallel=3, device="cpu")


def test_init_distributed_single_process_noop(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert mh.init_distributed() == 1
    assert mh.init_distributed(device="cpu") == 1
    assert not mh.col.active()
    with pytest.raises(ValueError, match="gloo"):
        mh.init_distributed(init_method="file:///nonexistent/x",
                            world_size=1, rank=0, device="cpu")


def test_global_mesh_and_staging_on_four_ranks(ranks):
    """global_mesh(2) is (2, 2) with rank r at (r // 2, r % 2); model
    parallelism of 3 or across nodes raises; init_distributed a second time
    returns the world; 10 rows over a 'data' axis of 4 stage as ranges of
    3, 3, 3 and 1 in chunks of 2; 2 rows leave ranks 2-3 empty, which
    need feature_dims; a wrong local row count raises."""
    for rank, out in enumerate(r["multihost"] for r in ranks):
        assert out["init_again"] == 4
        assert out["mesh"] == ({"data": 2, "model": 2}, rank // 2, rank % 2)
        assert "divisible" in out["global_mesh(3)"]
        assert "spans nodes" in out["global_mesh(4)"]
        start, stop, n, local, calls = out["staged"]
        want = [(0, 3), (3, 6), (6, 9), (9, 10)][rank]
        assert (start, stop, n) == (*want, 10)
        np.testing.assert_array_equal(local, FULL[start:stop])
        assert calls[0] == (start, min(start + 2, stop))
        if rank < 2:
            assert out["empty"] == "staged"
            assert out["empty_dims"] == (rank, rank + 1, (1, 3))
        else:
            assert "feature_dims" in out["empty"]
            assert out["empty_dims"] == (2, 2, (0, 3))
        assert "sharded range" in out["mismatch"]


@pytest.mark.parametrize("label,shape", [("features", (4, 1)),
                                         ("features_tp", (2, 2))])
def test_sharded_features_match_jax(ranks, label, shape):
    """13 waveforms (uneven over the 'data' axis) through
    logmel_batch_sharded and 11 through mfcc_stats_batch_sharded with
    masked lengths, against the JAX package's on its (8, 1) mesh; every
    rank returns every row."""
    y_mel, y_mfcc, lengths = _inputs()
    jmesh = jmake_mesh(8, shape=(8, 1))
    want_mel = np.asarray(jfeatures.logmel_batch_sharded(
        jnp.asarray(y_mel), JMelConfig(**MEL), jmesh))
    want_mfcc = np.asarray(jfeatures.mfcc_stats_batch_sharded(
        jnp.asarray(y_mfcc), JMfccConfig(**MFCC), jmesh, lengths=lengths))
    for out in (r[label] for r in ranks):
        assert out["logmel"].shape == want_mel.shape == (13, 128, 65)
        np.testing.assert_allclose(out["logmel"], want_mel, rtol=2e-4,
                                   atol=2e-4)
        assert out["mfcc"].shape == (11, 80)
        assert np.isfinite(out["mfcc"]).all()
        np.testing.assert_allclose(out["mfcc"], want_mfcc, rtol=2e-4,
                                   atol=2e-4)


def test_synth_features_sharded_equal_build_logmel(ranks):
    """The synthetic source's standardized log-mel, each rank building its
    own rows on the batch grid of 4: the single-device build bit for bit,
    on every rank."""
    want, _, _ = build_logmel(SyntheticSource.make(11, seed=3),
                              MelConfig(**MEL), device_batch=4, device="cpu")
    for label in ("features", "features_tp"):
        for out in (r[label] for r in ranks):
            np.testing.assert_array_equal(out["synth"], want.numpy())


def test_dryrun_on_four_ranks(ranks):
    """``__graft_entry__.dryrun_multichip``'s steps on 4 ranks, mesh
    (2, 2): every rank finite and the same."""
    results = [r["dryrun"] for r in ranks]
    r = results[0]
    assert r["mesh"] == {"data": 2, "model": 2}
    assert r["mels"].shape == (5, 128, 11) and np.isfinite(r["mels"]).all()
    assert r["fused"].shape == (7, 128, 11) and np.isfinite(r["fused"]).all()
    assert len(r["history"]) == 2
    assert np.isfinite([h["total"] for h in r["history"]]).all()
    assert r["labels"].shape == (19,) and np.isfinite(r["inertia"])
    assert r["dmu"].shape == (17, 4) and r["hmu"].shape == (17, 4)
    assert np.isfinite(r["dmu"]).all() and np.isfinite(r["hmu"]).all()
    assert np.isfinite([h["total"] for h in r["dense"] + r["hard"]]).all()
    assert -1.0 <= r["silhouette"] <= 1.0
    for other in results[1:]:
        for k in ("mels", "fused", "z", "labels", "dmu", "hmu"):
            np.testing.assert_array_equal(other[k], r[k], err_msg=k)
        assert other["history"] == r["history"]


def test_train_conv_mm_on_a_mesh_writes_once_and_matches(ranks, medium_root,
                                                       tmp_path):
    """Script 12 on a (2, 2) mesh: every rank returns the same history and
    all 13 latents; rank 0 wrote the files (train_log.csv, the checkpoint,
    the latents); against the same script on one device, history within
    1e-5 relative and latents within 1e-5 (the order of reduction over 4
    ranks)."""
    from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig, Workspace
    from vae_hmc_tpu_torch.pipelines.medium import train_conv_mm
    inp = _medium_inputs()
    results = [r["medium"] for r in ranks]
    for r in results[1:]:
        assert r["history"] == results[0]["history"]
        np.testing.assert_array_equal(r["latents"], results[0]["latents"])
    out_dir = medium_root / "results" / "vae_conv_mm_medium"
    assert (out_dir / "ckpt_epoch_002.pt").exists()
    assert len((out_dir / "train_log.csv").read_text().splitlines()) == 3
    np.testing.assert_array_equal(
        np.load(medium_root / "data" / "vae_mm_latents_mu.npy"),
        results[0]["latents"])
    (tmp_path / "data").mkdir()
    one = train_conv_mm(Workspace(tmp_path), ConvMMVaeConfig(**inp["cfg_kw"]),
                        audio={"x": inp["x"], "ids": inp["ids"]},
                        lyrics={"emb": inp["emb"], "ids": inp["l_ids"]},
                        device="cpu")
    for g, w in zip(results[0]["history"], one["history"]):
        for k in ("total", "recon", "kl"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (g, w)
    np.testing.assert_allclose(results[0]["latents"],
                               one["latents"].numpy(), rtol=0, atol=1e-5)


def test_a_rank_that_skips_a_collective_fails_within_its_timeout(tmp_path):
    """Rank 1 skips an all-reduce and stays alive 8 s; with a 4 s process-
    group timeout rank 0's all-reduce raises after ~4 s instead of
    hanging, and both ranks end within the join timeout."""
    out = run_ranks(run_jobs, 2, tmp_path,
                    {"skip": ("skip_collective_job", dict(sleep_s=8.0))},
                    timeout_s=4.0, join_s=60.0)
    assert out[1]["skip"] == {"skipped": True}
    err = out[0]["skip"]
    assert err["error"] is not None
    assert 3.5 <= err["seconds"] <= 30.0
