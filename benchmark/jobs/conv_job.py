"""The conv multimodal VAE job: the port's main path over the whole corpus.

One job calls ``pipelines.bench_chain.run_core``'s four stage entries in
its order, on the benchmark's inputs:
  features  ``pipelines.features.build_logmel`` (kernel 1);
  lyrics    ``text.minilm.encode_texts`` (MiniLM, the benchmark's weights);
  train     ``models.api.train_conv_mm_vae`` (the full schedule, then the
            posterior-mean export), from the benchmark's initial weights,
            row orders and noise;
  cluster   ``cluster.kmeans.kmeans``, ``metrics.internal.silhouette`` and
            ``davies_bouldin`` (kernel 2), ``metrics.external.
            adjusted_rand_index``.

The check (``Job.check``) compares the last job's outputs with the plain
reference (``benchmark/reference``), float32 with TF32 off, computed after
the window from the same inputs:
  feat       max |features - reference log-mel|, every element;
  lyrics     max |embedding - reference MiniLM embedding|, every row;
  steps      |training steps the fit took - epochs x batches an epoch|
             (exact: 25 x 46 = 1,150);
  grad0      the first step's gradient: worst leaf's gap of norms;
  delta3     the parameters' change after three steps: worst leaf's gap;
  loss3      the loss of each of the first three steps (the ELBO of the
             program's forward outputs on its batch), worst relative gap;
  export     the exported posterior means against the reference's encoding
             with the program's trained weights, max gap / max |mu|;
  km_assign  labels against the nearest of the program's centres (float64);
  inertia    the labels' inertia above that of a float64 k-means with the
             configured k and restarts on the program's latents, relative;
  dbi        Davies-Bouldin against a float64 one of the same latents and
             labels (kernel 2's point-to-centroid distances), absolute.
The silhouette is computed in the job but not compared: its float32 gap to
a float64 silhouette reaches the TF32 control's on some seeds (sound
1.8e-6 against the control's 1.5e-6), so no limit lies between them.
The float32 fit does not repeat across processes (cuDNN's default
algorithms), so the trained model is compared through the steps the
reference can follow from the same start (grad0, delta3, loss3) and,
from the program's own final state, through the export and the
clustering numbers.  Leaves whose reference gradient is under a
thousandth of the median leaf's (the unused ``logvar_a`` head) are left
out of grad0 and delta3.  The first epoch's mean loss is not compared:
over 46 steps the fit's float32 rounding grows past the TF32 control's
gap on some seeds.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark import corpus as corpus_mod, counters, fits, weights
from benchmark.reference import (cluster as ref_cluster, conv_vae as ref_vae,
                                 logmel as ref_logmel, minilm as ref_minilm,
                                 set_tf32)

FEATURE_BLOCK = 64
WARM_ROWS = 364        # batches of 128 / 108 (features, lyrics), 64 / 44
                       # (train), 256 / 108 (export): every shape of a job


class Inputs:
    """Everything a job is given, made from the seed: the corpus, MiniLM's
    and the VAE's initial weights, the row orders and the step noise."""

    def __init__(self, config: dict, seed: int, dev: torch.device):
        self.cfg, self.seed, self.dev = config, seed, dev
        mel, vae = config["mel"], config["vae"]
        self.corpus = corpus_mod.make_corpus(
            config["n_tracks"], mel["duration_s"], mel["sample_rate"],
            config["lyrics_coverage"], seed, dev)
        self.n = config["n_tracks"]
        self.n_frames = 1 + int(round(mel["sample_rate"] * mel["duration_s"])
                                ) // mel["hop_length"]
        self.texts = [t or "" for t in self.corpus.texts]
        self.has = self.corpus.has_lyrics.astype(np.float32)
        self.vocab = corpus_mod.lyric_vocab()
        self.minilm = weights.minilm_weights(config["minilm"], seed, dev)
        self.w0 = weights.conv_vae_weights(vae, mel["n_mels"], self.n_frames,
                                           seed, dev)
        self.perms = weights.epoch_perms(self.n, vae["epochs"], seed)

    def noise(self) -> weights.StepNoise:
        vae = self.cfg["vae"]
        return weights.StepNoise(self.seed, vae["batch_size"],
                                 vae["latent_dim"], self.dev)

    def shape(self):
        vae, mel = self.cfg["vae"], self.cfg["mel"]
        h, w = mel["n_mels"], self.n_frames
        for _ in vae["audio_channels"]:
            h, w = weights.conv_out(h), weights.conv_out(w)
        return (vae["audio_channels"][-1], h, w, mel["n_mels"], self.n_frames)


# -- counters -------------------------------------------------------------------

def job_flops(inp: Inputs) -> float:
    """The FLOPs the job's models need: the VAE's training steps (3 x the
    forward of every trained sample), the export's encoder forward and
    MiniLM's forward over the tokens encoded."""
    cfg = inp.cfg
    fwd = counters.conv_vae_forward(cfg["vae"], cfg["mel"]["n_mels"],
                                    inp.n_frames)
    train = 3.0 * (fwd["encoder"] + fwd["decoder"]) * inp.n * \
        cfg["vae"]["epochs"]
    export = fwd["encoder"] * inp.n
    mcfg = cfg["minilm"]
    text = 0.0
    b = mcfg["batch_size"]
    for s in range(0, inp.n, b):
        lens = [2 + len(t.split()) for t in inp.texts[s:s + b]]
        seq = max(lens)
        text += sum(lens) * counters.minilm_token(mcfg, seq)
    return train + export + text


def logmel_launches(inp: Inputs, batch: int) -> List[dict]:
    mel = inp.cfg["mel"]
    fb = ref_logmel.mel_filterbank(mel["sample_rate"], mel["n_fft"],
                                   mel["n_mels"], mel["fmin"], mel["fmax"])
    nnz = int(np.count_nonzero(fb))
    return [counters.logmel_launch(min(batch, inp.n - s),
                                   1 + mel["n_fft"] // 2, inp.n_frames,
                                   mel["n_mels"], nnz, True)
            for s in range(0, inp.n, batch)]


# -- the job ------------------------------------------------------------------

class Job:
    def __init__(self, config: dict, workload: dict, seed: int,
                 dev: torch.device):
        from vae_hmc_tpu_torch.core.config import (ConvMMVaeConfig,
                                                   KMeansConfig, MelConfig)
        from vae_hmc_tpu_torch.core.device import resolve_device
        from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
        from vae_hmc_tpu_torch.ops.kernels import build
        from vae_hmc_tpu_torch.text import minilm

        self.dev = resolve_device(dev)
        self.traffic = traffic = workload["traffic"]
        self.limits = workload["limits"]
        if self.dev.type == "cuda":
            build.build()
        # the first Adam imports torch._dynamo: set-up, not the window's
        torch.optim.Adam([torch.zeros(1, device=self.dev, requires_grad=True)])
        self.inp = inp = Inputs(config, seed, self.dev)
        mel, vae, mc = config["mel"], config["vae"], config["minilm"]
        self.mel_cfg = MelConfig(**mel)
        self.vae_cfg = ConvMMVaeConfig(**{
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in vae.items()}, "seed": seed})
        self.km_cfg = KMeansConfig(**config["kmeans"], seed=seed)
        mcfg = minilm.MiniLMConfig(
            vocab_size=mc["vocab_size"], hidden=mc["hidden_size"],
            layers=mc["num_hidden_layers"], heads=mc["num_attention_heads"],
            intermediate=mc["intermediate_size"],
            max_pos=mc["max_position_embeddings"],
            type_vocab=mc["type_vocab_size"], ln_eps=mc["layer_norm_eps"],
            max_seq_len=mc["max_seq_length"])
        with torch.device(self.dev):
            self.text_model = minilm.MiniLM(mcfg)
            self.model = ConvMMVAE(
                n_mels=mel["n_mels"], n_frames=inp.n_frames,
                channels=tuple(vae["audio_channels"]),
                fc_dim=vae["audio_fc_dim"], latent_dim=vae["latent_dim"],
                lyrics_dim=vae["lyrics_dim"])
        self.text_model.load_state_dict(minilm.hf_to_state_dict(
            inp.minilm, mcfg))
        self.text_model.eval()
        self.tok = minilm.WordPieceTokenizer(inp.vocab, mc["max_seq_length"])
        self.noise = inp.noise()
        self.flops = job_flops(inp)
        self.logmel = logmel_launches(inp, traffic["device_batch"])
        self.out: Dict = {}

    def _job(self, source, texts, has, genre_idx, perms, vae_cfg, spans,
             sec):
        from vae_hmc_tpu_torch.cluster.kmeans import kmeans
        from vae_hmc_tpu_torch.metrics import external, internal
        from vae_hmc_tpu_torch.models.api import train_conv_mm_vae
        from vae_hmc_tpu_torch.pipelines.features import build_logmel
        from vae_hmc_tpu_torch.text import minilm

        n = len(source)
        with spans.stage("features", sec):
            x, ids, _report = build_logmel(
                source, self.mel_cfg, device_batch=self.traffic["device_batch"],
                device=self.dev)
            if len(ids) != n:
                raise RuntimeError(f"features kept {len(ids)} of {n} rows")
            x = x[..., None]
        with spans.stage("lyrics", sec):
            lyr = minilm.encode_texts(
                self.text_model, self.tok, texts,
                batch_size=self.inp.cfg["minilm"]["batch_size"],
                to_host=False) * torch.as_tensor(has, device=self.dev)[:, None]
        self.model.load_state_dict(self.inp.w0)
        cap = fits.FitCapture(self.model, self.noise)
        with spans.stage("train", sec):
            _model, history, mu = train_conv_mm_vae(
                x, lyr, has, vae_cfg, device=self.dev, model=self.model,
                perms=perms, eps_fn=cap)
        fit = cap.close()
        with spans.stage("cluster", sec):
            km = kmeans(mu, self.km_cfg, device=self.dev)
            sil = internal.silhouette(mu, km.labels, device=self.dev)
            dbi = internal.davies_bouldin(mu, km.labels, device=self.dev)
            ari = external.adjusted_rand_index(km.labels, genre_idx)
        return {"features": x, "lyrics": lyr, "grad0": fit["grad0"],
                "after3": fit["after3"], "outputs3": fit["outputs"],
                "final": fit["final"], "steps": fit["steps"], "mu": mu,
                "labels": km.labels, "centers": km.centers,
                "inertia": km.inertia, "sil": sil, "dbi": dbi, "ari": ari}

    def warm(self) -> None:
        """The job once over the first WARM_ROWS tracks for one epoch: every
        kernel and shape of a job runs before the window."""
        from benchmark.harness import Spans

        w = min(WARM_ROWS, self.inp.n)
        sub = self.inp.corpus.head(w)
        self._job(corpus_mod.BenchSource(sub), self.inp.texts[:w],
                  self.inp.has[:w], sub.genre_idx,
                  weights.epoch_perms(w, 1, self.inp.seed),
                  dataclasses.replace(self.vae_cfg, epochs=1),
                  Spans(self.dev), {})

    def run(self, spans) -> dict:
        sec: Dict[str, float] = {}
        inp = self.inp
        self.out = self._job(corpus_mod.BenchSource(inp.corpus), inp.texts,
                             inp.has, inp.corpus.genre_idx, inp.perms,
                             self.vae_cfg, spans, sec)
        k = len(np.unique(self.out["labels"]))
        d = self.inp.cfg["vae"]["latent_dim"]
        distance = [counters.distance_launch(inp.n, inp.n, d, True),
                    counters.distance_launch(inp.n, k, d, False),
                    counters.distance_launch(k, k, d, True)]
        return {"tracks": inp.n, "stages": sec, "flops": self.flops,
                "launches": {"logmel": self.logmel, "distance": distance}}

    def release(self) -> None:
        """Frees the program's state; the last job's outputs stay."""
        del self.text_model, self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, dict]:
        """The last job's outputs against the reference's."""
        vae = self.inp.cfg["vae"]
        b, perm = vae["batch_size"], self.inp.perms[0]
        x = self.out["features"]
        losses = []
        for i, out in enumerate(self.out.pop("outputs3")):
            rows = torch.as_tensor(perm[i * b:(i + 1) * b], device=x.device)
            # a step that trained on other rows than its batch's has no loss
            # of that batch
            losses.append(float(ref_vae.elbo(*out, x[rows], vae["beta"]))
                          if out[0].shape[0] == len(rows) else math.inf)
        self.out["losses"] = losses
        self.out["steps_gap"] = abs(self.out["steps"] - expected_steps(
            self.inp.cfg))
        ref = reference(self.inp)
        _look(self.inp, self.out, ref)
        readings = compare(self.out, ref)
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in readings.items()}


# -- reference and comparison ---------------------------------------------------

def expected_steps(cfg: dict) -> int:
    vae = cfg["vae"]
    return vae["epochs"] * fits.steps_per_epoch(cfg["n_tracks"],
                                                vae["batch_size"])


def _features(inp: Inputs) -> torch.Tensor:
    w = inp.corpus.waveforms
    return torch.cat([ref_logmel.logmel(w[s:s + FEATURE_BLOCK], inp.cfg["mel"])
                      for s in range(0, inp.n, FEATURE_BLOCK)])[..., None]


def _lyrics(inp: Inputs) -> torch.Tensor:
    mc = inp.cfg["minilm"]
    emb = ref_minilm.embed(inp.minilm, mc, inp.texts, inp.vocab,
                           mc["max_seq_length"], mc["batch_size"])
    return emb * torch.as_tensor(inp.has, device=inp.dev)[:, None]


def _first_steps(inp: Inputs, x, lyr, trainer=ref_vae.Trainer) -> dict:
    """The reference's first three steps of the fit: the first step's
    gradients, each step's loss, the weights after the three."""
    vae = inp.cfg["vae"]
    tr = trainer(inp.w0, vae["learning_rate"], vae["beta"],
                 vae["batch_size"], inp.shape())
    m = torch.as_tensor(inp.has, device=inp.dev)[:, None]
    out = {"losses": []}
    for i, _b, val, grads in tr.epoch_steps(x, lyr, m, inp.perms[0],
                                            inp.noise(), 0):
        if i == 0:
            out["grad0"] = grads
        out["losses"].append(float(val))
        if i == 2:
            break
    out["after3"] = out["final"] = {k: v.detach().clone()
                                    for k, v in tr.w.items()}
    return out


def _look(inp: Inputs, prog: dict, ref: dict) -> None:
    """Diagnostics on stderr, not compared: the first step's gradient gap
    by leaf, against the reference's own step and against the reference's
    step on the program's features and lyrics (which takes the features'
    float32 difference out of the gap), worst and median leaf."""
    vae = inp.cfg["vae"]
    tr = ref_vae.Trainer(inp.w0, vae["learning_rate"], vae["beta"],
                         vae["batch_size"], inp.shape())
    rows = torch.as_tensor(inp.perms[0][:vae["batch_size"]], device=inp.dev)
    _, on_prog = tr.step(prog["features"][rows], prog["lyrics"][rows],
                         ref["mask"][rows], inp.noise()(0, 0))
    g_prog = ref_vae.leaf_norms(prog["grad0"])
    for name, grads in (("own features", ref["grad0"]),
                        ("program's features", on_prog)):
        g_ref = ref_vae.leaf_norms(grads)
        med = float(np.median(list(g_ref.values())))
        gaps = sorted(((abs(g_prog.get(k, 0.0) - v) / max(v, med), k)
                       for k, v in g_ref.items() if v >= 1e-3 * med),
                      reverse=True)
        print(f"[bench] look grad0 vs reference on {name}: worst "
              f"{gaps[:3]}, median leaf {gaps[len(gaps) // 2]}",
              file=sys.stderr, flush=True)


def reference(inp: Inputs) -> dict:
    """The reference's outputs from the job's inputs (TF32 off)."""
    set_tf32(False)
    x = _features(inp)
    lyr = _lyrics(inp)
    out = {"features": x, "lyrics": lyr, "w0": inp.w0,
           "mask": torch.as_tensor(inp.has, device=inp.dev)[:, None],
           "kmeans": inp.cfg["kmeans"], "seed": inp.seed}
    out.update(_first_steps(inp, x, lyr))
    return out


class HalfBatchTrainer(ref_vae.Trainer):
    """A planted fault: each step trains on the first half of its rows,
    the loss's mean taken over them."""

    def step(self, x, lyr, m, eps):
        h = max(1, x.shape[0] // 2)
        return super().step(x[:h], lyr[:h], m[:h], eps[:h])


def program_like(inp: Inputs, tf32: bool, trainer=ref_vae.Trainer,
                 kmeans_cut: bool = False) -> dict:
    """The reference put in the program's place (with TF32 on: the
    control; with a planted ``trainer``: a fault; with `kmeans_cut`: the
    fault of a k-means of one restart stopped after one iteration), its
    outputs in the shape of a job's: the fit's first three steps stand in
    for the full fit."""
    set_tf32(tf32)
    try:
        x = _features(inp)
        lyr = _lyrics(inp)
        fit = _first_steps(inp, x, lyr, trainer)
        m = torch.as_tensor(inp.has, device=inp.dev)[:, None]
        mu = ref_vae.export(fit["final"], x, lyr, m)
        k = inp.cfg["kmeans"]
        labels, centers, inertia = ref_cluster.kmeans(
            mu, k["n_clusters"], 1 if kmeans_cut else k["n_init"], inp.seed,
            1 if kmeans_cut else k["max_iter"], k["tol"])
        return {"features": x, "lyrics": lyr, "grad0": fit["grad0"],
                "after3": fit["after3"], "losses": fit["losses"],
                "final": fit["final"], "mu": mu, "steps_gap": 0,
                "labels": labels.cpu().numpy(),
                "centers": centers.cpu().numpy(), "inertia": inertia,
                "dbi": ref_cluster.davies_bouldin(mu, labels)}
    finally:
        set_tf32(False)


def control_readings(config: dict, seed: int, dev: torch.device) -> dict:
    """{"control": readings of the reference in TF32, "half_batch": of the
    half-batch fault, "altered_label": of the reference's outputs with one
    label moved to another cluster, "unchanged_state": of a fit whose steps
    leave the weights as they are, "kmeans_cut": of a k-means of one
    restart and one iteration}, at the configuration's size."""
    inp = Inputs(config, seed, dev)
    ref = reference(inp)
    out = {"control": compare(program_like(inp, True), ref)}
    plain = program_like(inp, False)
    out["half_batch"] = compare(program_like(inp, False, HalfBatchTrainer),
                                ref)
    moved = dict(plain, labels=np.array(plain["labels"]))
    moved["labels"][0] = (moved["labels"][0] + 1) % config["kmeans"][
        "n_clusters"]
    out["altered_label"] = compare(moved, ref)
    still = dict(plain, after3={k: v.clone() for k, v in inp.w0.items()})
    out["unchanged_state"] = compare(still, ref)
    out["kmeans_cut"] = compare(program_like(inp, False, kmeans_cut=True),
                                ref)
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers the check compares (see the module's docstring)."""
    set_tf32(False)
    out = {"feat": float((prog["features"] - ref["features"]).abs().max()),
           "lyrics": float((prog["lyrics"] - ref["lyrics"]).abs().max()),
           "steps": float(prog["steps_gap"])}
    out.update(fits.first_step_numbers(prog, ref, ref["w0"]))
    m = ref["mask"]
    mu_ref = ref_vae.export(prog["final"], ref["features"], ref["lyrics"], m)
    out["export"] = float((prog["mu"] - mu_ref).abs().max()
                          / mu_ref.abs().max())
    x64 = prog["mu"].detach().double()
    lab = torch.as_tensor(np.asarray(prog["labels"]), dtype=torch.int64,
                          device=x64.device)
    c64 = torch.as_tensor(np.asarray(prog["centers"]), dtype=torch.float64,
                          device=x64.device)
    out["km_assign"] = ref_cluster.assignment_excess(x64, c64, lab)
    out["inertia"] = ref_cluster.inertia_excess(
        x64, lab, c64.shape[0], ref["kmeans"]["n_init"], ref["seed"])
    out["dbi"] = abs(prog["dbi"] - ref_cluster.davies_bouldin(x64, lab))
    for k, v in out.items():
        if not math.isfinite(v):
            out[k] = math.inf
    return out
