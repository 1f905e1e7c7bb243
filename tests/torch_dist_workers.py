"""Ranks of the port's parallel tests, and the launcher that starts them.

JAX-free: the ranks are spawned processes that import this module (and
not the tests' conftest), torch, numpy and the port.  Each rank joins a
process group through a ``file://`` store under a directory of the
caller's (no ports, so concurrent test workers cannot collide), with a
process-group timeout so that a missed collective fails instead of
hanging, and writes its result to a pickle there; ``run_ranks`` joins the
ranks within its own timeout and kills any that outlive it.
"""
from __future__ import annotations

import datetime
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, fn, world, workdir, backend, device, timeout_s, args):
    torch.set_num_threads(1)
    from vae_hmc_tpu_torch.parallel.multihost import init_distributed
    init_distributed(init_method=f"file://{workdir}/store", world_size=world,
                     rank=rank, backend=backend, device=device,
                     timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, workdir, *args, backend: str = "gloo",
              device: str = "cpu", timeout_s: float = 60.0,
              join_s: float = 120.0) -> list:
    """fn(rank, *args) on `world` spawned ranks of one process group ->
    [each rank's result].  A rank that raises fails the call with its
    traceback; ranks still running after `join_s` seconds are killed and
    the call fails."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, str(workdir), backend, device, timeout_s,
                          args), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + join_s
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{join_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    out = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def as_numpy(state) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def mesh_of(shape, device="cpu"):
    from vae_hmc_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(shape=tuple(shape), device=device,
                     timeout=datetime.timedelta(seconds=60))


def build_model(spec):
    """("dense", (D, hidden, latent, cond)) | ("ae", (D, H, latent)) |
    ("conv", {ConvMMVAE kwargs}) -> the port's module."""
    from vae_hmc_tpu_torch.models.ae import AE
    from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
    from vae_hmc_tpu_torch.models.dense_vae import DenseVAE
    kind, args = spec
    if kind == "conv":
        return ConvMMVAE(**args)
    return (AE if kind == "ae" else DenseVAE)(*args)


def run_jobs(rank, jobs):
    """`jobs` {label: (job function's name, kwargs)}, run in order on every
    rank -> {label: the job's result}."""
    return {label: globals()[name](rank, **kw)
            for label, (name, kw) in jobs.items()}


def fit_job(rank, mesh_shape, model, state, arrays, kw, perms=None,
            eps=None, shard=False, n_rows=None, sharded_input=False,
            device="cpu"):
    """dp_fit of `model` (with `state`) on a mesh -> history, the gathered
    weights, the tensor-parallel shard shapes and this rank's rows."""
    from vae_hmc_tpu_torch.parallel.mesh import (conv_mm_param_sharding,
                                                 gather_params, shard_params)
    from vae_hmc_tpu_torch.parallel.multihost import (process_row_range,
                                                      shard_rows)
    from vae_hmc_tpu_torch.parallel.train_dp import dp_fit
    mesh = mesh_of(mesh_shape, device)
    m = build_model(model)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    m.to(mesh.device)
    shardings = conv_mm_param_sharding(mesh, m) if shard else None
    shapes = {}
    if shard:
        shard_params(m, shardings, mesh)
        shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
        gather_params(m, mesh)
        for k, v in m.state_dict().items():
            assert torch.equal(v.cpu(), torch.from_numpy(state[k])), k
    n = len(arrays[0]) if n_rows is None else n_rows
    data = [torch.from_numpy(a).to(mesh.device) for a in arrays]
    if sharded_input:
        data = [shard_rows(a, mesh, n) for a in data]
    eps_fn = None if eps is None else (
        lambda e, i: torch.from_numpy(eps[e][i]))
    res = dp_fit(m, data, mesh, shardings, perms=perms, eps_fn=eps_fn,
                 n_rows=n if (sharded_input or n_rows) else None, **kw)
    start, stop = process_row_range(n, mesh=mesh)
    return {"history": res.history, "state": as_numpy(m.state_dict()),
            "shard_shapes": shapes, "rows": (start, stop)}


def kmeans_job(rank, x, k, n_init, seed):
    from vae_hmc_tpu_torch.parallel.train_dp import kmeans_restarts_sharded
    mesh = mesh_of((dist.get_world_size(), 1))
    labels, centers, inertia = kmeans_restarts_sharded(x, k, n_init, mesh,
                                                       seed=seed)
    return {"labels": labels, "centers": centers, "inertia": inertia}


def dryrun_job(rank):
    """The steps of ``__graft_entry__.dryrun_multichip`` on the world's
    ranks at its own shapes: sharded log-mel (uneven rows), sharded
    synthetic features, a DP+TP ConvMMVAE dp_fit with uneven rows,
    sharded KMeans restarts on its latents, train_dense_vae and
    train_hard_vae (CVAE) on the mesh, and one sweep cell (KMeans and the
    silhouette from kernel 2's distances)."""
    from vae_hmc_tpu_torch.core.config import (DenseVaeConfig, HardVaeConfig,
                                               MelConfig)
    from vae_hmc_tpu_torch.metrics import internal
    from vae_hmc_tpu_torch.models import api
    from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
    from vae_hmc_tpu_torch.models.train import encode_in_batches
    from vae_hmc_tpu_torch.parallel.features_dp import (
        logmel_batch_sharded, synth_features_sharded)
    from vae_hmc_tpu_torch.parallel.mesh import (conv_mm_param_sharding,
                                                 make_mesh)
    from vae_hmc_tpu_torch.parallel.train_dp import (dp_fit,
                                                     kmeans_restarts_sharded)
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource

    n_dev = dist.get_world_size()
    mesh = make_mesh(n_dev, device="cpu",
                     timeout=datetime.timedelta(seconds=60))
    rng = np.random.default_rng(1)
    mel_cfg = MelConfig(duration_s=0.25)
    wav = rng.normal(0, 0.1, (n_dev + 1, mel_cfg.n_samples)).astype(
        np.float32)
    mels = logmel_batch_sharded(wav, mel_cfg, mesh)
    fused = synth_features_sharded(SyntheticSource.make(n_dev + 3, seed=0),
                                   mel_cfg, mesh, device_batch=n_dev)

    n_rows = 4 * n_dev + 3
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (n_rows, 32, 48, 1)).astype(
        np.float32))
    lyr = torch.from_numpy(rng.normal(0, 1, (n_rows, 384)).astype(np.float32))
    mask = torch.ones((n_rows, 1))
    torch.manual_seed(0)
    model = ConvMMVAE(n_mels=32, n_frames=48, latent_dim=8, fc_dim=64)
    res = dp_fit(model, (x, lyr, mask), mesh,
                 conv_mm_param_sharding(mesh, model), epochs=2,
                 batch_size=2 * n_dev, learning_rate=2e-3)
    model.eval()
    z = encode_in_batches(lambda a, b, c: model.encode(a, b, c)[0],
                          (x, lyr, mask), batch_size=2 * n_dev)
    labels, _, inertia = kmeans_restarts_sharded(z, 3, 2 * n_dev, mesh)

    n_d = 4 * n_dev + 1
    xd = rng.normal(0, 1, (n_d, 25)).astype(np.float32)
    dcfg = DenseVaeConfig(hidden_dims=(32, 32), latent_dim=4, epochs=2,
                          batch_size=2 * n_dev)
    _, dhist, dmu = api.train_dense_vae(xd, dcfg, device="cpu", mesh=mesh)
    cond = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n_d)]
    hcfg = HardVaeConfig(hidden_dim=32, latent_dim=4, epochs=2,
                         batch_size=2 * n_dev, use_cvae=True)
    _, hhist, hmu = api.train_hard_vae(xd, hcfg, cond=cond, device="cpu",
                                       mesh=mesh)
    d = internal.centered_euclidean_dists(dmu)
    lab2, _, _ = kmeans_restarts_sharded(dmu, 2, 2 * n_dev, mesh)
    sil = internal.silhouette_from_dists_masked(d, lab2)
    return {"mesh": dict(mesh.shape), "mels": mels.numpy(),
            "fused": fused.numpy(), "history": res.history,
            "z": z.numpy(), "labels": labels, "inertia": inertia,
            "dense": dhist, "dmu": dmu.numpy(), "hard": hhist,
            "hmu": hmu.numpy(), "silhouette": sil}


def features_job(rank, mesh_shape, y_mel, mel_kw, y_mfcc, lengths, mfcc_kw,
                 n_synth, synth_batch):
    """The sharded features on a mesh: raw log-mel, masked MFCC stats and
    a synthetic source's standardized log-mel."""
    from vae_hmc_tpu_torch.core.config import MelConfig, MfccConfig
    from vae_hmc_tpu_torch.parallel.features_dp import (
        logmel_batch_sharded, mfcc_stats_batch_sharded,
        synth_features_sharded)
    from vae_hmc_tpu_torch.pipelines.sources import SyntheticSource
    mesh = mesh_of(mesh_shape)
    mel_cfg = MelConfig(**mel_kw)
    return {
        "logmel": logmel_batch_sharded(y_mel, mel_cfg, mesh).numpy(),
        "mfcc": mfcc_stats_batch_sharded(y_mfcc, MfccConfig(**mfcc_kw), mesh,
                                         lengths=lengths).numpy(),
        "synth": synth_features_sharded(
            SyntheticSource.make(n_synth, seed=3), mel_cfg, mesh,
            device_batch=synth_batch).numpy()}


def multihost_job(rank, full):
    """global_mesh, init_distributed called again, and row-sharded
    staging of `full` (10 rows over a 'data' axis of 4 and 2 rows over
    it, where two ranks stage none)."""
    import os
    from vae_hmc_tpu_torch.parallel import multihost as mh
    out = {"init_again": mh.init_distributed(backend="gloo", device="cpu")}
    mesh = mh.global_mesh(2, device="cpu",
                          timeout=datetime.timedelta(seconds=60))
    out["mesh"] = (dict(mesh.shape), mesh.data_index, mesh.model_index)
    for mp_, local in ((3, "4"), (4, "2")):
        os.environ["LOCAL_WORLD_SIZE"] = local
        try:
            mh.global_mesh(mp_, device="cpu")
        except ValueError as e:
            out[f"global_mesh({mp_})"] = str(e)
        finally:
            del os.environ["LOCAL_WORLD_SIZE"]
    flat = mh.global_mesh(1, device="cpu")
    calls = []

    def rows(s, e):
        calls.append((s, e))
        return full[s:e]
    g = mh.stage_features_sharded(rows, 10, flat, batch=2)
    out["staged"] = (g.start, g.stop, g.n_global, g.local.numpy(), calls)
    try:
        mh.stage_features_sharded(rows, 2, flat)
        out["empty"] = "staged"
    except ValueError as e:
        out["empty"] = str(e)
    e = mh.stage_features_sharded(rows, 2, flat, feature_dims=(3,))
    out["empty_dims"] = (e.start, e.stop, tuple(e.local.shape))
    try:
        mh.global_batch_from_local(full[:2], flat, 10)
        out["mismatch"] = "accepted"
    except ValueError as err:
        out["mismatch"] = str(err)
    return out


def skip_collective_job(rank, sleep_s):
    """Rank 1 skips an all-reduce (and stays alive past the timeout);
    rank 0 must fail in it within the process group's timeout."""
    if rank == 1:
        time.sleep(sleep_s)
        return {"skipped": True}
    t0 = time.monotonic()
    try:
        dist.all_reduce(torch.ones(4))
        return {"error": None, "seconds": time.monotonic() - t0}
    except RuntimeError as e:       # DistBackendError and kin
        return {"error": type(e).__name__, "seconds": time.monotonic() - t0}


def logmel_kernel_job(rank, y, mel_kw):
    """logmel_batch_sharded on this rank's CUDA device (kernel 1) against
    the plain version of every row -> max abs error and the kernel's
    launches on this rank."""
    from vae_hmc_tpu_torch.core.config import MelConfig
    from vae_hmc_tpu_torch.ops import mel as mel_ops
    from vae_hmc_tpu_torch.ops.kernels import build
    from vae_hmc_tpu_torch.ops.kernels.logmel import mel_db_standardize_plain
    from vae_hmc_tpu_torch.ops.stft import power_spectrogram
    from vae_hmc_tpu_torch.parallel.features_dp import logmel_batch_sharded
    mesh = mesh_of((dist.get_world_size(), 1), "cuda")
    cfg = MelConfig(**mel_kw)
    build.reset_launch_counts()
    got = logmel_batch_sharded(y, cfg, mesh)
    launches = build.launch_counts()["mel_db_standardize"]
    yt = torch.from_numpy(y).to(mesh.device)
    spec = power_spectrogram(yt, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                             power=cfg.power)
    want = mel_db_standardize_plain(
        spec, mel_ops.mel_filterbank_tensor(cfg, mesh.device),
        ref_max=cfg.ref_max, top_db=mel_ops.effective_top_db(cfg),
        standardize=False)
    return {"max_abs_err": float((got - want).abs().max()),
            "shape": tuple(got.shape), "launches": launches}


def medium_job(rank, root, mesh_shape, x, ids, emb, l_ids, cfg_kw):
    """Script 12 (``pipelines/medium.train_conv_mm``) on a mesh into the
    workspace `root`, which every rank shares."""
    from vae_hmc_tpu_torch.core.config import ConvMMVaeConfig, Workspace
    from vae_hmc_tpu_torch.pipelines.medium import train_conv_mm
    out = train_conv_mm(Workspace(root), ConvMMVaeConfig(**cfg_kw),
                        audio={"x": x, "ids": ids},
                        lyrics={"emb": emb, "ids": l_ids}, device="cpu",
                        mesh=mesh_of(mesh_shape))
    return {"history": out["history"], "latents": out["latents"].numpy()}
