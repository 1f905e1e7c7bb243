"""The hard-tier job: the stages of ``pipelines.hard.run_hard_pipeline``
(reference scripts 18 -> 19 -> 20 -> 21 -> 22) over the corpus, on the
benchmark's inputs, in a fresh workspace under the run's TMPDIR:
  features   ``pipelines.hard.prepare_features``: MFCC stats (kernel 1 in
             MFCC mode), language tags, MiniLM over the lyrics from the
             checkpoint that set-up writes of the benchmark's weights (the
             fused input is 80 + 384 = 464 wide);
  train      ``models.api.train_hard_vae`` (script 19's Beta-VAE fit and
             export) from the benchmark's initial weights, row orders and
             noise, and the latents file the next stages read;
  cluster    ``pipelines.hard.cluster_and_evaluate`` (KMeans k=6, 20
             restarts; silhouette, NMI, ARI, purity);
  viz        ``pipelines.hard.visualize_latents`` (UMAP and its figures);
  baselines  what ``compare_with_baselines`` computes: KMeans and its scores
             on the latents, the MFCC stats, their PCA(32) and the latents
             of the AE baseline, whose fit (``models.api.train_ae``) starts
             from the benchmark's weights and row orders.
``train_hard`` and ``compare_with_baselines`` take no weights, row orders
or noise, so the job calls what they call; their checkpoint file, training
curve, reconstruction figure and baseline table are not made.

No cell of ``BENCHMARK.json`` runs this job yet: its host-bound rate
spreads too widely between runs on a shared host to hold a bound.

The check (``Job.check``) compares the last job's outputs with the plain
reference (``benchmark/reference``), float32 with TF32 off, computed after
the window from the same inputs:
  mfcc        MFCC stats, max gap over max |reference|;
  lyrics      max |embedding - reference MiniLM embedding|, every row;
  <fit>_steps |training steps the fit took - epochs x batches an epoch|
              (exact: 50 x 12 = 600 for vae, 30 x 12 = 360 for ae);
  <fit>_grad0, <fit>_delta3, <fit>_loss3  as the conv job's, from the
              reference's own first three steps;
  <fit>_export the exported latents against the reference's encoding of
              its own features with the program's final weights;
  km_assign   the KMeans labels against the nearest mean of each label's
              latents (float64);
  inertia     the labels' inertia above that of a float64 k-means with 20
              restarts on the same latents, relative;
  scores      silhouette, NMI, ARI and purity against the reference's of
              the same latents and labels;
  umap        1 - the share of each latent row's 20 nearest neighbours
              (float64) that are among its 20 nearest in the embedding;
  pca         the PCA(32) projection against the reference's of its own
              MFCC stats, compared through the rows' inner products;
  base_km_assign, base_inertia, base_scores  the same for the four KMeans
              of the baselines, the worst of the four.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark import corpus as corpus_mod, counters, fits, weights
from benchmark.reference import (cluster as ref_cluster,
                                 conv_vae as ref_vae, dense as ref_dense,
                                 logmel as ref_logmel, minilm as ref_minilm,
                                 pca as ref_pca, set_tf32)

BLOCK = 64
WARM_ROWS = 876        # batches of 64 / 44 (features, lyrics), 256 / 108
                       # (fits), 512 / 364 (exports): every shape of a job
KM_RESTARTS = 20       # reference scripts 20 and 22
UMAP_NEIGHBOURS = 20   # reference script 21
PCA_DIM = 32           # reference script 22
BASELINES = ("vae", "mfcc", "pca", "ae")


def vae_layers(width: int, cfg: dict):
    h, z = cfg["hidden_dim"], cfg["latent_dim"]
    return [("enc1", width, h), ("enc2", h, h), ("mu", h, z),
            ("logvar", h, z), ("dec1", z, h), ("dec2", h, h),
            ("out", h, width)]


def ae_layers(width: int, cfg: dict):
    h, z = cfg["hidden_dim"], cfg["latent_dim"]
    return [("e1", width, h), ("e2", h, h), ("e3", h, z), ("d1", z, h),
            ("d2", h, h), ("d3", h, width)]


class Inputs:
    """Everything a job is given, made from the seed: the corpus, MiniLM's
    weights, both fits' initial weights and row orders, the noise."""

    def __init__(self, config: dict, seed: int, dev: torch.device):
        self.cfg, self.seed, self.dev = config, seed, dev
        m, mc = config["mfcc"], config["minilm"]
        v, a = config["vae"], config["ae"]
        self.n = config["n_tracks"]
        self.corpus = corpus_mod.make_corpus(
            self.n, m["duration_s"], m["sample_rate"],
            config["lyrics_coverage"], seed, dev)
        self.texts = [t or "" for t in self.corpus.texts]
        self.vocab = corpus_mod.lyric_vocab()
        self.minilm = weights.minilm_weights(mc, seed, dev)
        self.width = 2 * m["n_mfcc"] + mc["hidden_size"]
        if self.width != v["input_dim"] or self.width != a["input_dim"]:
            raise ValueError(f"the fused input is {self.width} wide, the "
                             f"configuration says {v['input_dim']}")
        self.w_vae = weights.dense_weights(vae_layers(self.width, v), seed,
                                           40, dev)
        self.w_ae = weights.dense_weights(ae_layers(self.width, a), seed, 41,
                                          dev)
        self.perms_vae = weights.epoch_perms(self.n, v["epochs"], seed, 31)
        self.perms_ae = weights.epoch_perms(self.n, a["epochs"], seed, 32)

    def noise(self) -> weights.StepNoise:
        v = self.cfg["vae"]
        return weights.StepNoise(self.seed, v["batch_size"], v["latent_dim"],
                                 self.dev)


def expected_steps(cfg: dict, fit: str) -> int:
    f = cfg[fit]
    return f["epochs"] * fits.steps_per_epoch(cfg["n_tracks"],
                                              f["batch_size"])


# -- counters -------------------------------------------------------------------

def job_flops(cfg: dict, n: int, width: int) -> float:
    """The fits' training steps (3 x forward of every trained sample) and
    exports (encoder forward) of the Beta-VAE and the AE, for a fused input
    `width` wide."""
    v, a = cfg["vae"], cfg["ae"]
    h, z = v["hidden_dim"], v["latent_dim"]
    enc = counters.dense_forward((width, h, h)) + 2 * counters.dense_forward(
        (h, z))
    dec = counters.dense_forward((z, h, h, width))
    ah, az = a["hidden_dim"], a["latent_dim"]
    a_enc = counters.dense_forward((width, ah, ah, az))
    a_dec = counters.dense_forward((az, ah, ah, width))
    return n * (3 * (enc + dec) * v["epochs"] + enc
                + 3 * (a_enc + a_dec) * a["epochs"] + a_enc)


def text_flops(cfg: dict, texts: List[str]) -> float:
    """MiniLM's forward over the tokens encoded, batch by batch."""
    mc, b = cfg["minilm"], cfg["text"]["batch_size"]
    out = 0.0
    for s in range(0, len(texts), b):
        lens = [2 + len(t.split()) for t in texts[s:s + b]]
        out += sum(lens) * counters.minilm_token(mc, max(lens))
    return out


def logmel_launches(cfg: dict, n: int, batch: int) -> List[dict]:
    m = cfg["mfcc"]
    fb = ref_logmel.mel_filterbank(m["sample_rate"], m["n_fft"], m["n_mels"],
                                   m["fmin"], m["fmax"])
    nnz = int(np.count_nonzero(fb))
    t = 1 + int(round(m["sample_rate"] * m["duration_s"])) // m["hop_length"]
    return [counters.logmel_launch(min(batch, n - s), 1 + m["n_fft"] // 2, t,
                                   m["n_mels"], nnz, False)
            for s in range(0, n, batch)]


# -- the job ------------------------------------------------------------------

class Job:
    def __init__(self, config: dict, workload: dict, seed: int,
                 dev: torch.device):
        from vae_hmc_tpu_torch.core.config import (AeConfig, HardVaeConfig,
                                                   MfccConfig,
                                                   TextEmbedConfig)
        from vae_hmc_tpu_torch.core.device import resolve_device
        from vae_hmc_tpu_torch.models.ae import AE
        from vae_hmc_tpu_torch.models.dense_vae import DenseVAE
        from vae_hmc_tpu_torch.ops.kernels import build

        self.dev = resolve_device(dev)
        self.traffic = workload["traffic"]
        self.limits = workload["limits"]
        if self.dev.type == "cuda":
            build.build()
        # the first Adam imports torch._dynamo: set-up, not the window's
        torch.optim.Adam([torch.zeros(1, device=self.dev, requires_grad=True)])
        self.cfg = config
        self.inp = inp = Inputs(config, seed, self.dev)
        self.mfcc_cfg = MfccConfig(**config["mfcc"])
        self.text_cfg = TextEmbedConfig(**config["text"])
        self.vae_cfg = HardVaeConfig(**config["vae"], seed=seed)
        self.ae_cfg = AeConfig(**config["ae"], seed=seed)
        self.root = Path(tempfile.mkdtemp(prefix="bench-hard-"))
        # the program finds MiniLM where a user's checkpoint would be
        os.environ["VAE_HMC_MINILM_DIR"] = str(weights.write_minilm_checkpoint(
            self.root / "minilm", inp.minilm, inp.vocab))
        v, a = config["vae"], config["ae"]
        with torch.device(self.dev):
            self.vae = DenseVAE(inp.width, (v["hidden_dim"],) * 2,
                                v["latent_dim"])
            self.ae = AE(inp.width, a["hidden_dim"], a["latent_dim"])
        self.noise = inp.noise()
        self.flops = job_flops(config, inp.n, inp.width) + text_flops(
            config, inp.texts)
        self.logmel = logmel_launches(config, inp.n,
                                      self.traffic["device_batch"])
        self.out: Dict = {}

    def _job(self, corpus, perms_vae, perms_ae, vae_cfg, ae_cfg, spans,
             sec) -> dict:
        from vae_hmc_tpu_torch.cluster.kmeans import kmeans
        from vae_hmc_tpu_torch.core.config import KMeansConfig, Workspace
        from vae_hmc_tpu_torch.metrics import external, safe
        from vae_hmc_tpu_torch.models.api import train_ae, train_hard_vae
        from vae_hmc_tpu_torch.ops.pca import PCA
        from vae_hmc_tpu_torch.pipelines import hard

        dev, seed = self.dev, vae_cfg.seed
        ws = Workspace(root=self.root / "ws")
        shutil.rmtree(ws.root, ignore_errors=True)
        with spans.stage("features", sec):
            prep = hard.prepare_features(
                corpus_mod.BenchSource(corpus), ws, self.mfcc_cfg,
                self.text_cfg, self.traffic["device_batch"], force=True,
                device=dev)
        x_audio, y = prep["audio"], prep["genre_idx"]
        x = np.concatenate([x_audio, prep["text"]], axis=1).astype(np.float32)
        self.vae.load_state_dict(self.inp.w_vae)
        cap = fits.FitCapture(self.vae, self.noise)
        with spans.stage("train", sec):
            _m, _h, mu = train_hard_vae(x, vae_cfg, device=dev,
                                        model=self.vae, perms=perms_vae,
                                        eps_fn=cap)
            z = mu.cpu().numpy().astype(np.float32)
            np.save(ws.data_hard / "latents_mu.npy", z)
        vae_fit = cap.close()
        with spans.stage("cluster", sec):
            clus = hard.cluster_and_evaluate(ws, seed=seed, device=dev)
        with spans.stage("viz", sec):
            viz = hard.visualize_latents(ws, seed=seed, device=dev)
        self.ae.load_state_dict(self.inp.w_ae)
        cap = fits.FitCapture(self.ae)
        k = int(y.max() + 1)

        def eval_kmeans(name, feats):
            lab = kmeans(feats, KMeansConfig(n_clusters=k, n_init=KM_RESTARTS,
                                             seed=seed), device=dev).labels
            base[name] = {"x": feats, "labels": lab, "metrics": {
                "silhouette": safe.safe_silhouette(feats, lab, device=dev),
                "nmi": float(external.normalized_mutual_info(y, lab)),
                "ari": float(external.adjusted_rand_index(y, lab)),
                "purity": float(external.purity(lab, y))}}

        base: Dict[str, dict] = {}
        with spans.stage("baselines", sec):
            eval_kmeans("vae", z)
            eval_kmeans("mfcc", x_audio)
            x_pca = PCA(min(PCA_DIM, x_audio.shape[1], x_audio.shape[0]),
                        device=dev).fit_transform(x_audio).cpu().numpy()
            eval_kmeans("pca", x_pca)
            acfg = dataclasses.replace(ae_cfg, input_dim=x.shape[1],
                                       seed=seed)
            _m, _h, z_ae = train_ae(x, acfg, device=dev, model=self.ae,
                                    perms=perms_ae)
            eval_kmeans("ae", z_ae.cpu().numpy())
        ae_fit = cap.close()
        return {"ids": prep["ids"], "mfcc": x_audio, "lyrics": prep["text"],
                "x": x, "fits": {"vae": vae_fit, "ae": ae_fit}, "z": z,
                "z_ae": base["ae"]["x"], "labels": clus["labels"],
                "metrics": clus["metrics"], "embedding": viz["latent_2d"],
                "pca": x_pca, "base": base}

    def warm(self) -> None:
        """The job once over the first WARM_ROWS tracks for one epoch of
        each fit: every kernel and shape of a job runs before the window."""
        from benchmark.harness import Spans

        w = min(WARM_ROWS, self.inp.n)
        self._job(self.inp.corpus.head(w), weights.epoch_perms(w, 1, 1, 31),
                  weights.epoch_perms(w, 1, 1, 32),
                  dataclasses.replace(self.vae_cfg, epochs=1),
                  dataclasses.replace(self.ae_cfg, epochs=1),
                  Spans(self.dev), {})

    def run(self, spans) -> dict:
        sec: Dict[str, float] = {}
        inp = self.inp
        self.out = self._job(inp.corpus, inp.perms_vae, inp.perms_ae,
                             self.vae_cfg, self.ae_cfg, spans, sec)
        z = self.cfg["vae"]["latent_dim"]
        n = inp.n
        stats = 2 * self.cfg["mfcc"]["n_mfcc"]
        # kernel 2: script 20's silhouette and UMAP's kNN on the latents,
        # script 22's silhouettes on the latents, the MFCC stats, their
        # PCA(32) and the AE's latents
        distance = [counters.distance_launch(n, n, d, True)
                    for d in (z, z, z, stats, min(PCA_DIM, stats),
                              self.cfg["ae"]["latent_dim"])]
        return {"tracks": n, "stages": sec, "flops": self.flops,
                "launches": {"logmel": self.logmel, "distance": distance}}

    def release(self) -> None:
        """Frees the program's state; the last job's outputs stay."""
        del self.vae, self.ae
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, dict]:
        """The last job's outputs against the reference's."""
        try:
            prog = dict(self.out)
            x = torch.as_tensor(prog["x"], device=self.dev)
            prog["fits"] = {tag: program_fit(self.inp, tag, f, x)
                            for tag, f in prog["fits"].items()}
            ref = reference(self.inp)
            _look(self.inp, prog["fits"], x, ref)
            readings = compare(prog, ref, self.inp)
        finally:
            shutil.rmtree(self.root, ignore_errors=True)
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in readings.items()}


def program_fit(inp: Inputs, tag: str, fit: dict, x: torch.Tensor) -> dict:
    """A fit's capture in the shape ``compare`` reads: each of the first
    three steps' losses, worked out from the program's outputs on its batch
    (a step that trained on other rows than its batch's has none)."""
    f = inp.cfg[tag]
    b = f["batch_size"]
    perm = (inp.perms_vae if tag == "vae" else inp.perms_ae)[0]
    losses = []
    for i, out in enumerate(fit["outputs"]):
        xb = x[torch.as_tensor(perm[i * b:(i + 1) * b], device=x.device)]
        if out[0].shape[0] != xb.shape[0]:
            losses.append(math.inf)
        elif tag == "vae":
            losses.append(float(ref_dense.vae_elbo_sum(*out, xb, f["beta"])))
        else:
            losses.append(float(ref_dense.mse(out[0], xb)))
    return dict(fit, losses=losses,
                steps_gap=abs(fit["steps"] - expected_steps(inp.cfg, tag)))


# -- reference and comparison ---------------------------------------------------

def _features(inp: Inputs) -> dict:
    w = inp.corpus.waveforms
    mfcc = torch.cat([ref_logmel.mfcc_stats(w[s:s + BLOCK], inp.cfg["mfcc"])
                      for s in range(0, inp.n, BLOCK)])
    mc = inp.cfg["minilm"]
    lyr = ref_minilm.embed(inp.minilm, mc, inp.texts, inp.vocab,
                           mc["max_seq_length"], inp.cfg["text"]["batch_size"])
    return {"mfcc": mfcc, "lyrics": lyr, "x": torch.cat([mfcc, lyr], dim=1)}


def _first_steps(inp: Inputs, x: torch.Tensor, tag: str,
                 half: bool = False) -> dict:
    """The reference's first three steps of a fit from the benchmark's
    weights, row order and noise (`half`: the fault of each step training
    on the first half of its rows, the loss's mean taken over them)."""
    f = inp.cfg[tag]
    b = f["batch_size"]
    perm = (inp.perms_vae if tag == "vae" else inp.perms_ae)[0]
    noise = inp.noise()
    batches, eps = [], []
    for s in range(3):
        rows = torch.as_tensor(perm[s * b:(s + 1) * b], device=inp.dev)
        keep = max(1, len(rows) // 2) if half else len(rows)
        batches.append(x[rows[:keep]])
        eps.append(noise(0, s)[:keep] if tag == "vae" else None)
    w0 = inp.w_vae if tag == "vae" else inp.w_ae
    loss_fn = ref_dense.vae_loss if tag == "vae" else ref_dense.ae_loss
    st = ref_dense.steps(w0, loss_fn, batches, eps, f.get("beta", 0.0),
                         f["learning_rate"])
    return {"grad0": st["grad0"], "losses": st["losses"],
            "after3": st["after"]}


def _look(inp: Inputs, fitted: dict, x_prog: torch.Tensor, ref: dict) -> None:
    """Diagnostics on stderr, not compared: each fit's first-step gradient
    gap against the reference's step on its own features and on the
    program's (which takes the features' float32 difference out of the
    gap), worst and median leaf."""
    for tag in ("vae", "ae"):
        g_prog = ref_vae.leaf_norms(fitted[tag]["grad0"])
        on_prog = _first_steps(inp, x_prog, tag)["grad0"]
        for name, grads in (("own features", ref["fits"][tag]["grad0"]),
                            ("program's features", on_prog)):
            g_ref = ref_vae.leaf_norms(grads)
            med = float(np.median(list(g_ref.values())))
            gaps = sorted(((abs(g_prog.get(k, 0.0) - v) / max(v, med), k)
                           for k, v in g_ref.items() if v >= 1e-3 * med),
                          reverse=True)
            print(f"[bench] look {tag} grad0 vs reference on {name}: worst "
                  f"{gaps[:2]}, median leaf {gaps[len(gaps) // 2]}",
                  file=sys.stderr, flush=True)


def reference(inp: Inputs) -> dict:
    """The reference's outputs from the job's inputs (TF32 off)."""
    set_tf32(False)
    out = _features(inp)
    out["fits"] = {tag: _first_steps(inp, out["x"], tag)
                   for tag in ("vae", "ae")}
    return out


def _encode(tag: str, w, x):
    with torch.no_grad():
        return (ref_dense.vae_encode(w, x)[0] if tag == "vae"
                else ref_dense.ae_encode(w, x))


def _scores(x64: torch.Tensor, labels: np.ndarray, genres: np.ndarray,
            metrics: dict) -> float:
    lab = torch.as_tensor(labels, dtype=torch.int64, device=x64.device)
    want = {"silhouette": (ref_cluster.silhouette(x64, lab)
                           if len(np.unique(labels)) > 1 else None),
            "nmi": ref_cluster.nmi(genres, labels),
            "ari": ref_cluster.ari(genres, labels),
            "purity": ref_cluster.purity(labels, genres)}
    gaps = []
    for key, val in want.items():
        got = metrics.get(key)
        gaps.append(0.0 if got is None and val is None else
                    math.inf if got is None or val is None else
                    abs(float(got) - val))
    return max(gaps)


def _clustering(x64: torch.Tensor, labels: np.ndarray, k: int,
                seed: int) -> tuple:
    """(assignment excess, inertia excess) of `labels` on the rows `x64`."""
    lab = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                          device=x64.device)
    oh = torch.nn.functional.one_hot(lab, int(lab.max()) + 1).to(x64.dtype)
    centers = (oh.T @ x64) / oh.sum(0).clamp(min=1)[:, None]
    return (ref_cluster.assignment_excess(x64, centers, lab),
            ref_cluster.inertia_excess(x64, lab, k, KM_RESTARTS, seed))


def compare(prog: dict, ref: dict, inp: Inputs) -> Dict[str, float]:
    set_tf32(False)
    dev = ref["x"].device
    out: Dict[str, float] = {}
    same_rows = np.array_equal(np.asarray(prog["ids"]), inp.corpus.track_ids)
    mfcc = torch.as_tensor(np.asarray(prog["mfcc"]), device=dev)
    out["mfcc"] = (float((mfcc - ref["mfcc"]).abs().max()
                         / ref["mfcc"].abs().max())
                   if same_rows and mfcc.shape == ref["mfcc"].shape
                   else math.inf)
    lyr = torch.as_tensor(np.asarray(prog["lyrics"]), device=dev)
    out["lyrics"] = (float((lyr - ref["lyrics"]).abs().max())
                     if lyr.shape == ref["lyrics"].shape else math.inf)
    exports = {"vae": prog["z"], "ae": prog["z_ae"]}
    for tag in ("vae", "ae"):
        p, r = prog["fits"][tag], ref["fits"][tag]
        w0 = inp.w_vae if tag == "vae" else inp.w_ae
        out[f"{tag}_steps"] = float(p["steps_gap"])
        nums = fits.first_step_numbers(p, r, w0, f" ({tag})")
        out.update({f"{tag}_{k}": v for k, v in nums.items()})
        z_ref = _encode(tag, p["final"], ref["x"])
        z = torch.as_tensor(np.asarray(exports[tag]), device=dev)
        out[f"{tag}_export"] = (float((z - z_ref).abs().max()
                                      / z_ref.abs().max())
                                if z.shape == z_ref.shape else math.inf)
    genres, k, seed = inp.corpus.genre_idx, inp.cfg["vae"]["n_genres"], \
        inp.seed
    z64 = torch.as_tensor(np.asarray(prog["z"]), device=dev).double()
    out["km_assign"], out["inertia"] = _clustering(z64, prog["labels"], k,
                                                   seed)
    out["scores"] = _scores(z64, np.asarray(prog["labels"]), genres,
                            prog["metrics"])
    emb = torch.as_tensor(np.asarray(prog["embedding"]), device=dev).double()
    out["umap"] = (1.0 - ref_cluster.knn_recall(z64, emb, UMAP_NEIGHBOURS)
                   if emb.shape == (z64.shape[0], 2) else math.inf)
    pca_ref = ref_pca.project(ref["mfcc"].double(), PCA_DIM)
    pca = torch.as_tensor(np.asarray(prog["pca"]), device=dev).double()
    out["pca"] = (ref_pca.gram_gap(pca, pca_ref)
                  if pca.shape == pca_ref.shape else math.inf)
    worst = {"base_km_assign": 0.0, "base_inertia": 0.0, "base_scores": 0.0}
    for name in BASELINES:
        row = prog["base"].get(name)
        if row is None:
            worst = {key: math.inf for key in worst}
            break
        x64 = torch.as_tensor(np.asarray(row["x"]), device=dev).double()
        assign, excess = _clustering(x64, row["labels"], k, seed)
        score = _scores(x64, np.asarray(row["labels"]), genres,
                        row["metrics"])
        for key, val in (("base_km_assign", assign),
                         ("base_inertia", excess), ("base_scores", score)):
            worst[key] = max(worst[key], val)
    out.update(worst)
    for key, val in out.items():
        if not math.isfinite(val):
            out[key] = math.inf
    return out


# -- the control and the planted faults ------------------------------------------

def program_like(inp: Inputs, tf32: bool, half: bool = False,
                 kmeans_cut: bool = False) -> dict:
    """The reference put in the program's place (TF32 on: the control;
    `half`: each step trains on half its batch; `kmeans_cut`: k-means of one
    restart stopped after one iteration), in the shape of a job's outputs:
    three steps of each fit stand in for the fits.  The embedding is the
    program's UMAP of those latents (no plain UMAP exists here)."""
    from vae_hmc_tpu_torch.viz.umap import umap_2d

    set_tf32(tf32)
    try:
        r = _features(inp)
        x = r["x"]
        fitted, exports = {}, {}
        for tag in ("vae", "ae"):
            st = _first_steps(inp, x, tag, half)
            fitted[tag] = dict(st, final=st["after3"], steps_gap=0)
            exports[tag] = _encode(tag, st["after3"], x)
        k = inp.cfg["vae"]["n_genres"]
        g = inp.corpus.genre_idx

        def km(feats):
            lab = ref_cluster.kmeans(feats, k, 1 if kmeans_cut else
                                     KM_RESTARTS, inp.seed,
                                     1 if kmeans_cut else 300)[0]
            lab_np = lab.cpu().numpy()
            return lab_np, {"silhouette": ref_cluster.silhouette(feats, lab),
                            "nmi": ref_cluster.nmi(g, lab_np),
                            "ari": ref_cluster.ari(g, lab_np),
                            "purity": ref_cluster.purity(lab_np, g)}

        z = exports["vae"]
        labels, metrics = km(z)
        pca = ref_pca.project(r["mfcc"], PCA_DIM)
        base = {}
        for name, feats in (("vae", z), ("mfcc", r["mfcc"]), ("pca", pca),
                            ("ae", exports["ae"])):
            lab, met = km(feats)
            base[name] = {"x": feats.cpu().numpy(), "labels": lab,
                          "metrics": met}
        emb = umap_2d(z, n_neighbors=UMAP_NEIGHBOURS, min_dist=0.15,
                      seed=42, device=inp.dev)
        return {"ids": inp.corpus.track_ids, "mfcc": r["mfcc"].cpu().numpy(),
                "lyrics": r["lyrics"].cpu().numpy(), "fits": fitted,
                "z": z.cpu().numpy(), "z_ae": exports["ae"].cpu().numpy(),
                "labels": labels, "metrics": metrics, "embedding": emb,
                "pca": pca.cpu().numpy(), "base": base}
    finally:
        set_tf32(False)


def trained_latents(inp: Inputs, x: torch.Tensor) -> torch.Tensor:
    """The program's Beta-VAE fit on the reference's features `x`, from the
    benchmark's weights, row orders and noise: latents as a sound run's."""
    from vae_hmc_tpu_torch.core.config import HardVaeConfig
    from vae_hmc_tpu_torch.models.api import train_hard_vae
    from vae_hmc_tpu_torch.models.dense_vae import DenseVAE

    v = inp.cfg["vae"]
    with torch.device(inp.dev):
        model = DenseVAE(inp.width, (v["hidden_dim"],) * 2, v["latent_dim"])
    model.load_state_dict(inp.w_vae)
    _m, _h, mu = train_hard_vae(x.cpu().numpy(),
                                HardVaeConfig(**v, seed=inp.seed),
                                device=inp.dev, model=model,
                                perms=inp.perms_vae, eps_fn=inp.noise())
    return mu


def umap_miss(z: torch.Tensor, n_neighbours: int = UMAP_NEIGHBOURS,
              n_epochs: int = 0) -> float:
    """The ``umap`` number of the program's UMAP of `z` (visualize_latents'
    settings, but for the neighbours and epochs given; 0: its default)."""
    from vae_hmc_tpu_torch.viz.umap import umap_2d

    emb = umap_2d(z, n_neighbors=n_neighbours, min_dist=0.15,
                  n_epochs=n_epochs, seed=42, device=z.device)
    z64 = z.double()
    return 1.0 - ref_cluster.knn_recall(
        z64, torch.as_tensor(emb, device=z.device).double(), UMAP_NEIGHBOURS)


def control_readings(config: dict, seed: int, dev: torch.device) -> dict:
    """As ``conv_job.control_readings``, for this job's numbers, with the
    faults of a UMAP whose epochs are cut to a tenth ("umap_epochs") or
    whose neighbours are cut to 5 ("umap_neighbours"), each read on the
    latents of the program's own fit (the sound UMAP's reading of the same
    latents is logged)."""
    inp = Inputs(config, seed, dev)
    ref = reference(inp)
    out = {"control": compare(program_like(inp, True), ref, inp),
           "half_batch": compare(program_like(inp, False, half=True), ref,
                                 inp)}
    plain = program_like(inp, False)
    moved = dict(plain, labels=np.array(plain["labels"]))
    moved["labels"][0] = (moved["labels"][0] + 1) % (moved["labels"].max()
                                                      + 1)
    out["altered_label"] = compare(moved, ref, inp)
    still = dict(plain, fits={
        k: dict(f, after3=inp.w_vae if k == "vae" else inp.w_ae)
        for k, f in plain["fits"].items()})
    out["unchanged_state"] = compare(still, ref, inp)
    out["kmeans_cut"] = compare(program_like(inp, False, kmeans_cut=True),
                                ref, inp)
    z = trained_latents(inp, ref["x"])
    n_epochs = 500 if inp.n <= 10000 else 200     # the program's default
    print(f"[bench] umap of the program's fit, seed {seed}: sound "
          f"{umap_miss(z)!r}", file=sys.stderr, flush=True)
    out["umap_epochs"] = {"umap": umap_miss(z, n_epochs=n_epochs // 10)}
    out["umap_neighbours"] = {"umap": umap_miss(z, n_neighbours=5)}
    return out
