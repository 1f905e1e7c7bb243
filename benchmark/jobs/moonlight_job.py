"""The conv multimodal VAE job with Moonlight-16B-A3B as the lyrics encoder:
the port's main path over the whole corpus, ``conv_job``'s stages with the
lyrics stage through ``text.moe_lm.encode_ids``.

  features  ``pipelines.features.build_logmel`` (kernel 1);
  lyrics    ``text.moe_lm.encode_ids`` over the lyric tracks' token ids
            (bf16, the benchmark's weights), zero rows for the rest;
  train     ``models.api.train_conv_mm_vae`` at lyrics_dim 2048 (the full
            float32 schedule, then the export), from the benchmark's
            initial weights, row orders and noise;
  cluster   ``cluster.kmeans.kmeans``, ``metrics.internal`` (kernel 2),
            ``metrics.external.adjusted_rand_index``.

The traffic (``traffic`` of the workload file): a token-id sequence for
each track with lyrics, its length log-normal (median, sigma) clipped to
[min, max], its ids Zipf over the vocabulary with each genre's own
permutation of the ranks; ``max_batch_tokens`` token slots a forward.

The check (``Job.check``) compares the last job's outputs with the plain
references (``benchmark/reference``), float32 with TF32 off:
  lm_emb    the worst row's L2 gap between the program's embedding and the
            reference's (``reference/moonlight.embed``) over a seeded sample
            of ``check_tracks`` lyric tracks that holds the
            ``check_longest`` longest; in every MoE layer the reference
            takes the program's expert choice for a token (``ChoiceCapture``)
            wherever each chosen expert's own score lies within
            ``check_follow_tol`` of its own k-th, so the gap is the
            arithmetic's along the program's path, not a near-tie flipped
            by rounding, and a choice far from the reference's is not
            followed;
  lm_layer  one MLA layer and one MoE layer of a seeded forward, applied by
            the reference to the hidden states the program gave them:
            the worse of the two relative Frobenius gaps to the program's
            outputs (the reference follows the program's expert choice
            where it lies within bf16 rounding of the k-th score);
  lm_route  the share of that MoE layer's expert choices that differ from
            the reference's own top-k;
  and ``conv_job``'s numbers of the features, the fit and the clustering
  (``conv_job.compare`` with the program's embeddings as the reference's
  lyrics input, so the fit is held to the same steps as conv's).
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import corpus as corpus_mod, counters, fits, lm_counters, \
    weights
from benchmark.jobs import conv_job
from benchmark.reference import moonlight as ref_lm, set_tf32

CELL = "moonlight_mm_vae.lyrics_job"      # whose traffic the control reads
WORKLOADS = Path(__file__).resolve().parents[1] / "workloads"
WARM_ROWS = conv_job.WARM_ROWS
LM_STREAM = 40          # the seed's stream of the lyric ids
CHECK_STREAM = 41       # of the check's sample, layer and forward


def lyric_ids(cfg: dict, traffic: dict, genre_idx: np.ndarray,
              has_lyrics: np.ndarray, seed: int) -> List[np.ndarray]:
    """One id sequence for each track with lyrics, in corpus order."""
    rng = np.random.default_rng([seed & corpus_mod.SEED_MASK, LM_STREAM])
    vocab = cfg["vocab_size"]
    perms = [rng.permutation(vocab) for _ in corpus_mod.GENRES]
    rows = np.flatnonzero(has_lyrics)
    # log-normal lengths, one from each of len(rows) equal strata of
    # probability, the strata dealt to the tracks in a random order: every
    # job holds the distribution's whole profile, tail included
    n = len(rows)
    u = (rng.permutation(n) + rng.random(n)) / n
    z = torch.special.ndtri(torch.as_tensor(u, dtype=torch.float64)).numpy()
    lengths = np.clip(np.rint(traffic["length_median"] * np.exp(
        traffic["length_sigma"] * z)), traffic["length_min"],
        traffic["length_max"]).astype(np.int64)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -traffic["zipf_exponent"]
    ranks = rng.choice(vocab, size=int(lengths.sum()), p=p / p.sum())
    out, at = [], 0
    for r, n in zip(rows, lengths):
        out.append(perms[genre_idx[r]][ranks[at:at + n]])
        at += n
    return out


def check_sample(ids: List[np.ndarray], traffic: dict, seed: int
                 ) -> np.ndarray:
    """Seeded sample of lyric rows (indices into `ids`) holding the
    longest ones, sorted."""
    lengths = np.array([len(s) for s in ids])
    longest = np.argsort(-lengths, kind="stable")[:traffic["check_longest"]]
    rest = np.setdiff1d(np.arange(len(ids)), longest)
    rng = np.random.default_rng([seed & corpus_mod.SEED_MASK, CHECK_STREAM])
    n = min(traffic["check_tracks"], len(ids)) - len(longest)
    return np.sort(np.concatenate([longest, rng.choice(rest, n,
                                                       replace=False)]))


class Inputs(conv_job.Inputs):
    """``conv_job.Inputs`` without MiniLM, with the lyric tracks' ids."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 dev: torch.device):
        self.cfg, self.seed, self.dev = config, seed, dev
        mel, vae = config["mel"], config["vae"]
        self.corpus = corpus_mod.make_corpus(
            config["n_tracks"], mel["duration_s"], mel["sample_rate"],
            config["lyrics_coverage"], seed, dev)
        self.n = config["n_tracks"]
        self.n_frames = 1 + int(round(mel["sample_rate"] * mel["duration_s"])
                                ) // mel["hop_length"]
        self.has = self.corpus.has_lyrics.astype(np.float32)
        self.rows = np.flatnonzero(self.corpus.has_lyrics)
        self.ids = lyric_ids(config, traffic, self.corpus.genre_idx,
                             self.corpus.has_lyrics, seed)
        self.w0 = weights.conv_vae_weights(vae, mel["n_mels"], self.n_frames,
                                           seed, dev)
        self.perms = weights.epoch_perms(self.n, vae["epochs"], seed)


def lm_weights(model, config: dict, seed: int, dev: torch.device) -> None:
    """Draws the encoder's weights part by part (``reference/moonlight``),
    in the model's dtype, into `model`."""
    from vae_hmc_tpu_torch.text import moe_lm

    dtype = model.embed_tokens.weight.dtype
    gen = torch.Generator(device=dev)
    for part in ref_lm.parts(config):
        moe_lm.load_hf(model, {
            name: ref_lm.draw(seed, name, shape, kind,
                              config["initializer_range"], dev, dtype, gen)
            for name, shape, kind in ref_lm.leaves(config, part)})


class LayerCapture:
    """Forward hooks on one layer's attention and MoE (never a global
    hook): at the layer's `forward`-th call, their inputs, outputs, the
    rows' lengths and the router's choice, cloned."""

    def __init__(self, layer, forward: int):
        self.forward, self.calls, self.got = forward, 0, {}
        self.hooks = [layer.self_attn.register_forward_hook(self._attn),
                      layer.mlp.register_forward_hook(self._moe),
                      layer.mlp.gate.register_forward_hook(self._gate)]

    def _attn(self, module, args, out):
        self.calls += 1
        if self.calls - 1 == self.forward:
            self.got.update(attn_in=args[0].detach().clone(),
                            attn_out=out.detach().clone(),
                            lengths=list(args[1].lengths))

    def _gate(self, module, args, out):
        if self.calls - 1 == self.forward:
            self.got["choice"] = out[0].detach().clone()

    def _moe(self, module, args, out):
        if self.calls - 1 == self.forward:
            self.got.update(moe_in=args[0].detach().clone(),
                            moe_out=out.detach().clone())

    def close(self) -> dict:
        for h in self.hooks:
            h.remove()
        return self.got


class ChoiceCapture:
    """Forward hooks on every MoE layer's router (never a global hook): in
    one ``encode_ids`` call over `lengths`' sequences, the expert choice of
    each token of the `sample` rows.  The tokens' places in each forward
    are found once, on the device, before any call (``length_batches``
    cuts the same forwards every call)."""

    def __init__(self, lengths: List[int], max_batch_tokens: int,
                 sample: np.ndarray, dev: torch.device):
        from vae_hmc_tpu_torch.text import moe_lm

        self.sample = [int(j) for j in sample]
        keep = set(self.sample)
        self.picks: List[Optional[torch.Tensor]] = []
        self.rows: List[int] = []           # the sample rows, as captured
        self.lengths = {j: lengths[j] for j in self.sample}
        for rows in moe_lm.length_batches(lengths, max_batch_tokens):
            at, picked = 0, []
            for r in rows:
                if r in keep:
                    picked.append(np.arange(at, at + lengths[r]))
                    self.rows.append(r)
                at += lengths[r]
            self.picks.append(torch.as_tensor(np.concatenate(picked),
                                              device=dev) if picked else None)
        self.hooks: list = []

    def open(self, lm) -> "ChoiceCapture":
        self.calls: Dict[int, int] = {}
        self.got: Dict[int, List[torch.Tensor]] = {}
        for i, layer in enumerate(lm.layers):
            if hasattr(layer.mlp, "gate"):
                self.calls[i], self.got[i] = 0, []
                self.hooks.append(layer.mlp.gate.register_forward_hook(
                    lambda module, args, out, i=i: self._gate(i, out)))
        return self

    def _gate(self, i: int, out) -> None:
        f = self.calls[i]
        self.calls[i] += 1
        if f < len(self.picks) and self.picks[f] is not None:
            self.got[i].append(out[0].index_select(0, self.picks[f]).to(
                torch.int16))

    def close(self) -> Dict[int, torch.Tensor]:
        """-> each MoE layer's choice (T, k) over the sample rows' tokens,
        the rows in `sample`'s order (``reference.moonlight.embed``'s
        `follow`)."""
        for h in self.hooks:
            h.remove()
        self.hooks = []
        sizes = [self.lengths[r] for r in self.rows]
        out = {}
        for i, got in self.got.items():
            by_row = dict(zip(self.rows, torch.cat(got).split(sizes)))
            out[i] = torch.cat([by_row[j] for j in self.sample])
        return out


def checked_layer(lm_cfg, lengths: List[int], traffic: dict, seed: int):
    """The seeded (MoE layer, forward) whose inputs the check captures."""
    from vae_hmc_tpu_torch.text import moe_lm

    rng = np.random.default_rng([seed & corpus_mod.SEED_MASK,
                                 CHECK_STREAM + 1])
    forwards = len(moe_lm.length_batches(lengths,
                                         traffic["max_batch_tokens"]))
    return (int(rng.integers(lm_cfg.first_dense, lm_cfg.layers)),
            int(rng.integers(0, forwards)))


def fit_flops(inp: Inputs) -> float:
    """The float32 fit's FLOPs: 3 x the forward of every trained sample and
    the export's encoder forward (``counters.conv_vae_forward``)."""
    cfg = inp.cfg
    fwd = counters.conv_vae_forward(cfg["vae"], cfg["mel"]["n_mels"],
                                    inp.n_frames)
    return (3.0 * (fwd["encoder"] + fwd["decoder"]) * inp.n
            * cfg["vae"]["epochs"] + fwd["encoder"] * inp.n)


class Job:
    def __init__(self, config: dict, workload: dict, seed: int,
                 dev: torch.device):
        from vae_hmc_tpu_torch.core.config import (ConvMMVaeConfig,
                                                   KMeansConfig, MelConfig,
                                                   MoeLMConfig)
        from vae_hmc_tpu_torch.core.device import resolve_device
        from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
        from vae_hmc_tpu_torch.ops.kernels import build
        from vae_hmc_tpu_torch.text import moe_lm

        self.dev = resolve_device(dev)
        self.traffic = traffic = workload["traffic"]
        self.limits = workload["limits"]
        if self.dev.type == "cuda":
            build.build()
        # the first Adam imports torch._dynamo: set-up, not the window's
        torch.optim.Adam([torch.zeros(1, device=self.dev, requires_grad=True)])
        self.inp = inp = Inputs(config, traffic, seed, self.dev)
        mel, vae = config["mel"], config["vae"]
        self.mel_cfg = MelConfig(**mel)
        self.vae_cfg = ConvMMVaeConfig(**{
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in vae.items()}, "seed": seed})
        self.km_cfg = KMeansConfig(**config["kmeans"], seed=seed)
        self.lm_cfg = MoeLMConfig.from_hf(config, config["torch_dtype"])
        with torch.device(self.dev):
            self.lm = moe_lm.MoeLM(self.lm_cfg)
            self.model = ConvMMVAE(
                n_mels=mel["n_mels"], n_frames=inp.n_frames,
                channels=tuple(vae["audio_channels"]),
                fc_dim=vae["audio_fc_dim"], latent_dim=vae["latent_dim"],
                lyrics_dim=vae["lyrics_dim"])
        lm_weights(self.lm, config, seed, self.dev)
        self.lm.eval()
        self.noise = inp.noise()
        self.rows = torch.as_tensor(inp.rows, device=self.dev)
        lengths = [len(s) for s in inp.ids]
        self.lm_flops = lm_counters.encode_flops(config, lengths)
        self.fit_flops = fit_flops(inp)
        self.logmel = conv_job.logmel_launches(inp, traffic["device_batch"])
        self.layer, self.forward = checked_layer(self.lm_cfg, lengths,
                                                 traffic, seed)
        self.choices = ChoiceCapture(
            lengths, traffic["max_batch_tokens"],
            check_sample(inp.ids, traffic, seed), self.dev)
        self.out: Dict = {}

    def _job(self, source, ids, rows, has, genre_idx, perms, vae_cfg, spans,
             sec, capture: Optional[LayerCapture] = None,
             choices: Optional[ChoiceCapture] = None):
        from vae_hmc_tpu_torch.cluster.kmeans import kmeans
        from vae_hmc_tpu_torch.metrics import external, internal
        from vae_hmc_tpu_torch.models.api import train_conv_mm_vae
        from vae_hmc_tpu_torch.pipelines.features import build_logmel
        from vae_hmc_tpu_torch.text import moe_lm

        n = len(source)
        with spans.stage("features", sec):
            x, kept, _report = build_logmel(
                source, self.mel_cfg,
                device_batch=self.traffic["device_batch"], device=self.dev)
            if len(kept) != n:
                raise RuntimeError(f"features kept {len(kept)} of {n} rows")
            x = x[..., None]
        lm = moe_lm.LMCounters()
        with spans.stage("lyrics", sec):
            emb = moe_lm.encode_ids(self.lm, ids,
                                    self.traffic["max_batch_tokens"],
                                    counters=lm)
            lyr = torch.zeros((n, self.lm_cfg.hidden), device=self.dev)
            lyr.index_copy_(0, rows, emb)
        got = capture.close() if capture is not None else {}
        follow = choices.close() if choices is not None else {}
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
        return {"features": x, "lyrics": lyr, "emb": emb, "counters": lm,
                "layer": got, "choices": follow, "grad0": fit["grad0"], "after3": fit["after3"],
                "outputs3": fit["outputs"], "final": fit["final"],
                "steps": fit["steps"], "mu": mu, "labels": km.labels,
                "centers": km.centers, "inertia": km.inertia, "sil": sil,
                "dbi": dbi, "ari": ari}

    def warm(self) -> None:
        """The job once over the first WARM_ROWS tracks for one epoch, then
        the fused attention once at each forward's shape of the corpus
        (``moe_lm.warm_attention``: each (rows, longest row) shape has a
        plan of its own, built at its first call): every kernel and shape
        of a job runs before the window."""
        from benchmark.harness import Spans
        from vae_hmc_tpu_torch.text import moe_lm

        inp = self.inp
        w = min(WARM_ROWS, inp.n)
        sub = inp.corpus.head(w)
        keep = inp.rows < w
        self._job(corpus_mod.BenchSource(sub),
                  [s for s, k in zip(inp.ids, keep) if k],
                  torch.as_tensor(inp.rows[keep], device=self.dev),
                  inp.has[:w], sub.genre_idx,
                  weights.epoch_perms(w, 1, inp.seed),
                  dataclasses.replace(self.vae_cfg, epochs=1),
                  Spans(self.dev), {})
        moe_lm.warm_attention(self.lm, [len(s) for s in inp.ids],
                              self.traffic["max_batch_tokens"])

    def run(self, spans) -> dict:
        sec: Dict[str, float] = {}
        inp = self.inp
        capture = LayerCapture(self.lm.layers[self.layer], self.forward)
        self.out = self._job(corpus_mod.BenchSource(inp.corpus), inp.ids,
                             self.rows, inp.has, inp.corpus.genre_idx,
                             inp.perms, self.vae_cfg, spans, sec, capture,
                             self.choices.open(self.lm))
        k = len(np.unique(self.out["labels"]))
        d = inp.cfg["vae"]["latent_dim"]
        distance = [counters.distance_launch(inp.n, inp.n, d, True),
                    counters.distance_launch(inp.n, k, d, False),
                    counters.distance_launch(k, k, d, True)]
        lm = self.out["counters"]
        return {"tracks": inp.n, "stages": sec,
                "flops_by_dtype": {"float32": self.fit_flops,
                                   "bfloat16": self.lm_flops},
                "lm": {"config": inp.cfg, "flops": self.lm_flops,
                       "tokens": lm.tokens, "slots": lm.slots,
                       "padded": lm.padded,
                       "expert_slots": lm.expert_slots},
                "launches": {"logmel": self.logmel, "distance": distance}}

    def release(self) -> None:
        """Frees the program's state; the last job's outputs stay."""
        del self.lm, self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, dict]:
        """The last job's outputs against the references'."""
        inp, out = self.inp, self.out
        vae = inp.cfg["vae"]
        b, perm = vae["batch_size"], inp.perms[0]
        x = out["features"]
        losses = []
        for i, o in enumerate(out.pop("outputs3")):
            rows = torch.as_tensor(perm[i * b:(i + 1) * b], device=x.device)
            losses.append(float(conv_job.ref_vae.elbo(*o, x[rows],
                                                      vae["beta"]))
                          if o[0].shape[0] == len(rows) else math.inf)
        out["losses"] = losses
        out["steps_gap"] = abs(out["steps"] - conv_job.expected_steps(inp.cfg))
        readings = lm_numbers(inp, self.traffic, out["emb"], out["layer"],
                              self.layer, out["choices"])
        ref = fit_reference(inp, out["lyrics"])
        conv_job._look(inp, out, ref)
        readings.update(compare(out, ref))
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in readings.items()}


# -- reference and comparison ------------------------------------------------

def _drawn_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["torch_dtype"])


def lm_embed(inp: Inputs, sample: np.ndarray, fault=None,
             follow: Optional[Dict[int, torch.Tensor]] = None,
             tol: float = ref_lm.BF16_TOL,
             record: Optional[Dict[int, torch.Tensor]] = None
             ) -> torch.Tensor:
    """The reference's embeddings of the sampled lyric rows, following
    `follow` (the program's choices of their tokens) within `tol`."""
    cfg = inp.cfg
    set_tf32(False)
    return ref_lm.embed(
        lambda part: ref_lm.part_weights(cfg, inp.seed, part, inp.dev,
                                         _drawn_dtype(cfg)),
        cfg, [inp.ids[j] for j in sample], inp.dev, fault, follow, tol,
        record)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def layer_numbers(inp: Inputs, got: dict, layer: int, fault=None
                  ) -> Dict[str, float]:
    """lm_layer and lm_route of the captured layer: the reference's MLA
    on the program's normed inputs, one row at a time, and its MoE on the
    program's normed inputs following the program's choice; with `fault`
    the faulty reference's outputs in place of the program's."""
    cfg = inp.cfg
    set_tf32(False)
    w = ref_lm.part_weights(cfg, inp.seed, layer, inp.dev, _drawn_dtype(cfg))
    p = f"model.layers.{layer}."
    xs = got["attn_in"].float().split(got["lengths"])
    attn = torch.cat([ref_lm.mla(w, p + "self_attn.", cfg, x) for x in xs])
    moe, differ = ref_lm.moe(w, p + "mlp.", cfg, got["moe_in"].float(),
                             follow=got["choice"])
    if fault is None:
        prog_attn, prog_moe, route = got["attn_out"], got["moe_out"], differ
    else:
        prog_attn = torch.cat([ref_lm.mla(w, p + "self_attn.", cfg, x, fault)
                               for x in xs])
        prog_moe, _ = ref_lm.moe(w, p + "mlp.", cfg, got["moe_in"].float(),
                                 fault)
        route = _route_gap(w, p, cfg, got["moe_in"].float(), fault)
    return {"lm_layer": max(_rel(prog_attn, attn), _rel(prog_moe, moe)),
            "lm_route": route}


def _route_gap(w, p, cfg, x, fault) -> float:
    """Share of a faulty router's choices not in the reference's top-k."""
    k = cfg["num_experts_per_tok"]
    bias = w[p + "mlp.gate.e_score_correction_bias"]
    sound = torch.sigmoid(ref_lm.mm(x, w[p + "mlp.gate.weight"]))
    faulty = torch.sigmoid(ref_lm.mm(x, w[p + "mlp.gate.weight"], fault))
    mine, _ = ref_lm.choose(faulty, bias, k)
    _, differ = ref_lm.choose(sound, bias, k, follow=mine)
    return differ


def lm_numbers(inp: Inputs, traffic: dict, emb: torch.Tensor, got: dict,
               layer: int, follow: Dict[int, torch.Tensor]
               ) -> Dict[str, float]:
    """lm_emb, lm_layer and lm_route of the program's outputs."""
    sample = check_sample(inp.ids, traffic, inp.seed)
    ref = lm_embed(inp, sample, follow=follow,
                   tol=traffic["check_follow_tol"])
    gap = (emb[torch.as_tensor(sample, device=emb.device)] - ref).norm(dim=-1)
    out = {"lm_emb": float(gap.max())}
    out.update(layer_numbers(inp, got, layer) if got else
               {"lm_layer": math.inf, "lm_route": math.inf})
    return out


def fit_reference(inp: Inputs, lyr: torch.Tensor) -> dict:
    """``conv_job.reference`` with the program's embeddings as the lyrics
    input: the reference's features and first three steps."""
    set_tf32(False)
    x = conv_job._features(inp)
    out = {"features": x, "lyrics": lyr, "w0": inp.w0,
           "mask": torch.as_tensor(inp.has, device=inp.dev)[:, None],
           "kmeans": inp.cfg["kmeans"], "seed": inp.seed}
    out.update(conv_job._first_steps(inp, x, lyr))
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """``conv_job.compare``'s numbers but its ``lyrics`` (the fit's
    reference takes the program's embeddings, so that gap is 0 by
    construction; the encoder's gap is lm_emb)."""
    out = conv_job.compare(prog, ref)
    del out["lyrics"]
    return out


def fit_like(inp: Inputs, lyr: torch.Tensor, tf32: bool,
             kmeans_cut: bool = False) -> dict:
    """The reference put in the program's place for the features, the fit's
    first three steps, the export and the k-means (``conv_job.program_like``
    with `lyr` as the lyrics input), with TF32 on or off; with
    `kmeans_cut`, the fault of a k-means of one restart stopped after one
    iteration."""
    set_tf32(tf32)
    try:
        x = conv_job._features(inp)
        fit = conv_job._first_steps(inp, x, lyr)
        m = torch.as_tensor(inp.has, device=inp.dev)[:, None]
        mu = conv_job.ref_vae.export(fit["final"], x, lyr, m)
        k = inp.cfg["kmeans"]
        labels, centers, inertia = conv_job.ref_cluster.kmeans(
            mu, k["n_clusters"], 1 if kmeans_cut else k["n_init"], inp.seed,
            1 if kmeans_cut else k["max_iter"], k["tol"])
        return {"features": x, "lyrics": lyr, "grad0": fit["grad0"],
                "after3": fit["after3"], "losses": fit["losses"],
                "final": fit["final"], "mu": mu, "steps_gap": 0,
                "labels": labels.cpu().numpy(),
                "centers": centers.cpu().numpy(), "inertia": inertia,
                "dbi": conv_job.ref_cluster.davies_bouldin(mu, labels)}
    finally:
        set_tf32(False)


def control_readings(config: dict, seed: int, dev: torch.device) -> dict:
    """At the configuration's size, the readings of: "sound", the program's
    encoder numbers (its embeddings of every lyric track, the capture of
    the job's layer and forward); each of ``reference/moonlight.FAULTS``,
    the reference with that fault in the program's place (lm_layer and
    lm_route of the captured layer; the fp8 fault also lm_emb: the whole
    faulty reference, which the sound one follows as it follows the
    program); "fit_tf32", the fit's and the clustering's numbers
    of the reference in TF32 in the program's place, on the program's
    embeddings; "kmeans_cut", those of the reference with a k-means of one
    restart and one iteration (read, not held: such a k-means can land on
    the best partition)."""
    from vae_hmc_tpu_torch.core.config import MoeLMConfig
    from vae_hmc_tpu_torch.core.device import resolve_device
    from vae_hmc_tpu_torch.text import moe_lm

    dev = resolve_device(dev)
    traffic = json.loads((WORKLOADS / f"{CELL}.json").read_text())["traffic"]
    inp = Inputs(config, traffic, seed, dev)
    lm_cfg = MoeLMConfig.from_hf(config, config["torch_dtype"])
    with torch.device(dev):
        model = moe_lm.MoeLM(lm_cfg)
    lm_weights(model, config, seed, dev)
    lengths = [len(s) for s in inp.ids]
    layer, forward = checked_layer(lm_cfg, lengths, traffic, seed)
    sample = check_sample(inp.ids, traffic, seed)
    cap = LayerCapture(model.layers[layer], forward)
    choices = ChoiceCapture(lengths, traffic["max_batch_tokens"], sample,
                            dev).open(model)
    emb = moe_lm.encode_ids(model, inp.ids, traffic["max_batch_tokens"])
    got, follow = cap.close(), choices.close()
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"sound": lm_numbers(inp, traffic, emb, got, layer, follow)}
    for fault in ref_lm.FAULTS:
        out[fault] = layer_numbers(inp, got, layer, fault)
    made: Dict[int, torch.Tensor] = {}
    bad = lm_embed(inp, sample, "fp8", record=made)
    out["fp8"]["lm_emb"] = float((bad - lm_embed(
        inp, sample, follow=made, tol=traffic["check_follow_tol"])).norm(
        dim=-1).max())
    lyr = torch.zeros((inp.n, lm_cfg.hidden), device=dev)
    lyr.index_copy_(0, torch.as_tensor(inp.rows, device=dev), emb)
    ref = fit_reference(inp, lyr)
    out["fit_tf32"] = compare(fit_like(inp, lyr, True), ref)
    out["kmeans_cut"] = compare(fit_like(inp, lyr, False, kmeans_cut=True),
                                ref)
    return out
