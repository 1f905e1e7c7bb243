"""The port's ``fit`` options against the JAX package's ``fit``: bf16 mixed
precision, checkpoint/resume in the JAX package's ``train_state.ckpt``
layout, and random streams that depend on the seed alone.

Flax params initialized by the JAX package go through ``models.convert``
into the torch modules.  Where the two packages' runs are compared, the
port gets the permutations and the reparameterization noise that the JAX
trainer draws from PRNGKey(seed) (fold_in(root, epoch), then
fold_in(epoch_key, perm_tag) for the shuffle and fold_in(epoch_key, step)
for the step's key; the noise in the model's compute dtype).  Models: the
small ConvMMVAE of ``tests/test_train_paths.py`` (32 x 48, latent 8, FC 64,
24 rows at batch 8) and a DenseVAE (24 -> 32 -> 32 -> 6, 50 rows at batch
16).

Tolerances:
  - bf16 history against the JAX package's bf16 ``fit``: every column
    (total, recon, kl) within 5e-4 x the epoch's total, a quarter of one
    bf16 rounding unit (2^-9) of the loss.  Measured on the CPU: 5.9e-5
    (conv) and 5.0e-5 (dense) of the total.  At these sizes the history
    barely sees the cast (a float32 forward with the same bf16 noise lands
    as close), so a forward hook holds every layer's output to bf16;
  - float32 runs across the packages (resume from the other package's
    file): the fit-parity tolerance of ``tests/test_torch_dense_models.py``,
    history within rtol 1e-4 (atol 1e-7); measured 1.4e-5 (conv) and
    3.8e-6 (dense);
  - the port against itself (resume, same seed): bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_hmc_tpu.models.conv_mm_vae import ConvMMVAE as FlaxConvMMVAE
from vae_hmc_tpu.models.dense_vae import DenseVAE as FlaxDenseVAE
from vae_hmc_tpu.models.train import fit as jfit
from vae_hmc_tpu_torch.models.conv_mm_vae import ConvMMVAE
from vae_hmc_tpu_torch.models.convert import module_tensors
from vae_hmc_tpu_torch.models.dense_vae import DenseVAE, reparameterize
from vae_hmc_tpu_torch.models.train import fit

torch.set_num_threads(1)

CKPT = "train_state.ckpt"


class Case:
    """One model and its data, in both packages."""

    def __init__(self, kind):
        self.kind = kind
        rng = np.random.default_rng(0)
        if kind == "conv":
            n, self.lat = 24, 8
            self.kw = dict(batch_size=8, learning_rate=2e-3, seed=0)
            x = rng.normal(0, 1, (n, 32, 48, 1)).astype(np.float32)
            lyr = rng.normal(0, 1, (n, 384)).astype(np.float32)
            m = (rng.random((n, 1)) < 0.7).astype(np.float32)
            self.arrays = (x, lyr, m)
            self.fmodel = FlaxConvMMVAE(n_mels=32, n_frames=48, latent_dim=8,
                                        fc_dim=64)
            key = jax.random.PRNGKey(0)
            self.variables = jax.jit(self.fmodel.init)(
                key, x[:1], lyr[:1], m[:1], key)
        else:
            n, self.lat = 50, 6
            self.kw = dict(batch_size=16, learning_rate=1e-3, seed=5)
            self.arrays = (rng.standard_normal((n, 24)).astype(np.float32),)
            self.fmodel = FlaxDenseVAE(input_dim=24, hidden_dims=(32, 32),
                                       latent_dim=6)
            key = jax.random.PRNGKey(3)
            self.variables = jax.jit(lambda k: self.fmodel.init(
                k, jnp.zeros((1, 24)), k))(key)
        self.n = n

    def apply_fn(self, p, rng, *batch):
        return self.fmodel.apply(p, *batch, rng)

    def torch_model(self):
        if self.kind == "conv":
            m = ConvMMVAE(n_mels=32, n_frames=48, latent_dim=8, fc_dim=64)
        else:
            m = DenseVAE(24, (32, 32), 6)
        m.load_state_dict(module_tensors(m, self.flax_params()))
        return m

    def flax_params(self):
        return jax.tree_util.tree_map(np.asarray, self.variables)["params"]

    def tensors(self):
        return [torch.from_numpy(a) for a in self.arrays]

    def jax_fit(self, epochs, **kw):
        return jfit(self.apply_fn, self.variables,
                    tuple(jnp.asarray(a) for a in self.arrays),
                    epochs=epochs, **self.kw, **kw)

    def jax_streams(self, epochs, dtype=jnp.float32):
        """perms and eps_fn of the JAX fused trainer (train_all)."""
        bs, n = self.kw["batch_size"], self.n
        root = jax.random.PRNGKey(self.kw["seed"])
        perm_tag = max(7919, n // bs + 1)
        perms, keys = [], []
        for e in range(epochs):
            ekey = jax.random.fold_in(root, e)
            perms.append(np.array(jax.random.permutation(
                jax.random.fold_in(ekey, perm_tag), n)))
            keys.append(ekey)

        def eps_fn(epoch, i):
            rows = len(perms[epoch][i * bs:(i + 1) * bs])
            eps = jax.random.normal(jax.random.fold_in(keys[epoch], i),
                                    (rows, self.lat), dtype)
            return torch.from_numpy(np.asarray(eps).astype(np.float32))
        return dict(perms=perms, eps_fn=eps_fn)

    def port_fit(self, model, epochs, **kw):
        return fit(model, self.tensors(), epochs=epochs, **self.kw, **kw)


CASES = {}


def case(kind) -> Case:
    if kind not in CASES:
        CASES[kind] = Case(kind)
    return CASES[kind]


def _cols(h):
    return np.asarray([h["total"], h["recon"], h["kl"]])


def _assert_history_close(got, want, rtol=1e-4, atol=1e-7):
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_cols(g), _cols(w), rtol=rtol, atol=atol)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_params_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# bf16 mixed precision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_bf16_fit_matches_jax_bf16_fit(kind):
    """Same streams (bf16 noise), same weights: the port's bf16 history
    follows the JAX package's fit(compute_dtype="bfloat16") to a quarter
    of a bf16 rounding unit of the loss in every column."""
    c = case(kind)
    ref = c.jax_fit(3, compute_dtype="bfloat16")
    model = c.torch_model()
    res = c.port_fit(model, 3, compute_dtype="bfloat16",
                     **c.jax_streams(3, jnp.bfloat16))
    assert [h["epoch"] for h in res.history] == [1, 2, 3]
    for g, w in zip(res.history, ref.history):
        gap = np.abs(_cols(g) - _cols(w)).max()
        assert gap <= 5e-4 * abs(w["total"]), (g, w, gap)
    assert res.history[-1]["total"] < res.history[0]["total"]


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_bf16_keeps_float32_master_weights_and_differs_from_f32(kind):
    """The cast takes effect (every layer computes in bf16, and the bf16
    history leaves the float32 one by more than float32 roundoff) while
    the parameters stay float32 (the next test reads the moments)."""
    c = case(kind)
    m32, mbf = c.torch_model(), c.torch_model()
    seen = set()
    for layer in mbf.modules():
        if not list(layer.children()):
            layer.register_forward_hook(
                lambda mod, inp, out: seen.add(out.dtype))
    r32 = c.port_fit(m32, 2, **c.jax_streams(2))
    rbf = c.port_fit(mbf, 2, compute_dtype="bf16",
                     **c.jax_streams(2, jnp.bfloat16))
    assert seen == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in mbf.parameters())
    gap = max(np.abs(_cols(a) - _cols(b)).max()
              for a, b in zip(r32.history, rbf.history))
    assert gap > 1e-5 * abs(r32.history[0]["total"]), gap
    for a, b in zip(r32.history, rbf.history):      # same loss, roughly
        assert abs(a["total"] - b["total"]) < 0.03 * abs(a["total"])


def test_bf16_checkpoint_holds_float32_state(tmp_path):
    c = case("dense")
    c.port_fit(c.torch_model(), 1, compute_dtype="bfloat16",
               checkpoint_dir=str(tmp_path), checkpoint_every=1)
    with np.load(tmp_path / CKPT) as z:
        dtypes = {k: z[k].dtype for k in z.files}
    assert dtypes.pop("1/0/count") == np.int32
    assert set(dtypes.values()) == {np.dtype(np.float32)}


def test_unknown_compute_dtype_raises():
    c = case("dense")
    with pytest.raises(ValueError, match="compute_dtype"):
        c.port_fit(c.torch_model(), 1, compute_dtype="float16")


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,dtype", [("conv", None), ("dense", None),
                                        ("dense", "bfloat16")])
def test_port_resume_equals_straight_run_bit_for_bit(tmp_path, kind, dtype):
    """3 epochs with checkpoint_every=3, then a resumed fit to 6, equal the
    uninterrupted 6 bit for bit (weights and history), with the port's own
    streams; the first 3 history rows are the saved ones."""
    c = case(kind)
    straight = c.torch_model()
    rs = c.port_fit(straight, 6, compute_dtype=dtype)
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3,
              compute_dtype=dtype)
    r1 = c.port_fit(c.torch_model(), 3, **kw)
    resumed = c.torch_model()               # fresh weights: the file rules
    r2 = c.port_fit(resumed, 6, **kw)
    assert [h["epoch"] for h in r2.history] == [1, 2, 3, 4, 5, 6]
    assert r2.history[:3] == r1.history
    assert r2.history == rs.history
    _assert_params_equal(_params(resumed), _params(straight))


def test_resume_false_starts_over_and_checkpoint_every_spacing(tmp_path):
    c = case("dense")
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    c.port_fit(c.torch_model(), 3, **kw)
    meta = json.loads((tmp_path / (CKPT + ".meta.json")).read_text())
    assert meta["epoch"] == 2 and len(meta["history"]) == 2
    again = c.port_fit(c.torch_model(), 3, resume=False, **kw)
    first = c.port_fit(c.torch_model(), 3)
    assert again.history == first.history


def _jax_ckpt(c, tmp_path, epochs):
    d = tmp_path / "jax"
    c.jax_fit(epochs, checkpoint_dir=str(d), checkpoint_every=epochs)
    return d


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_port_resumes_a_jax_checkpoint(tmp_path, kind):
    """The JAX package trains 3 epochs and writes train_state.ckpt; the
    port resumes it to 6 with the JAX streams and follows the JAX
    package's straight 6-epoch run at the fit-parity tolerance."""
    c = case(kind)
    ref = c.jax_fit(6)
    d = _jax_ckpt(c, tmp_path, 3)
    model = c.torch_model()
    with torch.no_grad():                   # the file, not these, must rule
        for p in model.parameters():
            p.zero_()
    res = c.port_fit(model, 6, checkpoint_dir=str(d), **c.jax_streams(6))
    assert res.history[:3] == json.loads(
        (d / (CKPT + ".meta.json")).read_text())["history"]
    _assert_history_close(res.history, ref.history)


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_jax_resumes_a_port_checkpoint(tmp_path, kind):
    """The port trains 3 epochs on the JAX streams and writes
    train_state.ckpt; the JAX package resumes it to 6 and follows the
    port's straight 6-epoch run at the fit-parity tolerance."""
    c = case(kind)
    ref = c.port_fit(c.torch_model(), 6, **c.jax_streams(6))
    c.port_fit(c.torch_model(), 3, checkpoint_dir=str(tmp_path),
               checkpoint_every=3, **c.jax_streams(3))
    res = c.jax_fit(6, checkpoint_dir=str(tmp_path))
    assert [h["epoch"] for h in res.history] == [1, 2, 3, 4, 5, 6]
    _assert_history_close(res.history, ref.history)


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_checkpoint_keys_and_shapes_match_jax(tmp_path, kind):
    c = case(kind)
    c.port_fit(c.torch_model(), 1, checkpoint_dir=str(tmp_path / "port"),
               checkpoint_every=1)
    jdir = _jax_ckpt(c, tmp_path, 1)

    def layout(d):
        with np.load(d / CKPT) as z:
            return {k: (z[k].shape, z[k].dtype) for k in z.files}
    port, jax_ = layout(tmp_path / "port"), layout(jdir)
    assert port == jax_
    assert port["1/0/count"] == ((), np.int32)
    for d in (tmp_path / "port", jdir):
        meta = json.loads((d / (CKPT + ".meta.json")).read_text())
        assert set(meta) == {"epoch", "history"} and meta["epoch"] == 1


def test_verbose_prints_epoch_lines(capsys):
    c = case("dense")
    c.port_fit(c.torch_model(), 5, verbose=True, log_every=2)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] for ln in lines] == [
        "[epoch   1/5", "[epoch   3/5", "[epoch   5/5"]
    assert all(" total " in ln and " recon " in ln and " kl " in ln
               for ln in lines)


# ---------------------------------------------------------------------------
# random streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_same_seed_fits_equal_whatever_the_global_generator(kind):
    c = case(kind)
    torch.manual_seed(1)
    a = c.torch_model()
    ra = c.port_fit(a, 2)
    b = c.torch_model()           # nn.Module init draws from the global one
    torch.manual_seed(2)
    torch.randn(100)
    state = torch.random.get_rng_state()
    rb = c.port_fit(b, 2)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert ra.history == rb.history
    _assert_params_equal(_params(a), _params(b))


def test_seed_changes_the_streams():
    c = case("dense")
    a, b = c.torch_model(), c.torch_model()
    c.port_fit(a, 1)
    fit(b, c.tensors(), epochs=1, **{**c.kw, "seed": c.kw["seed"] + 1})
    assert not torch.equal(a.out.weight, b.out.weight)


def test_reparameterize_needs_eps_or_a_generator():
    mu, lv = torch.zeros(3, 2), torch.zeros(3, 2)
    with pytest.raises(ValueError, match="eps or a generator"):
        reparameterize(mu, lv)
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    assert torch.equal(reparameterize(mu, lv, generator=g1),
                       reparameterize(mu, lv, generator=g2))
    z = reparameterize(mu.bfloat16(), lv.bfloat16(),
                       generator=torch.Generator().manual_seed(7))
    assert z.dtype == torch.bfloat16
