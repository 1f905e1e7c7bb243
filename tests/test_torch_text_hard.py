"""Port hard-tier text and label metrics against the JAX package and
sklearn: the TF-IDF stop list and vectors, the language heuristic, NMI,
mutual information, purity and the contingency matrix.

Exact where the arithmetic is the same (the stop list, vocabularies,
language tags, contingency counts, the JAX package's own float64 metric
code); TF-IDF against sklearn within 1e-6 (float32 output), NMI against
sklearn within 1e-12 (both float64, another summation order).
"""
import numpy as np
import pytest
from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS
from sklearn.feature_extraction.text import TfidfVectorizer as SkTfidf
from sklearn.metrics import mutual_info_score, normalized_mutual_info_score
from sklearn.metrics.cluster import contingency_matrix as sk_contingency

from vae_hmc_tpu.metrics import external as jexternal
from vae_hmc_tpu.text import embed as jembed
from vae_hmc_tpu.text import langdetect as jlangdetect
from vae_hmc_tpu.text import tfidf as jtfidf
from vae_hmc_tpu_torch.core.config import TEXT_HARD, TextEmbedConfig
from vae_hmc_tpu_torch.metrics import external
from vae_hmc_tpu_torch.pipelines.synthetic import make_dataset
from vae_hmc_tpu_torch.text import embed, langdetect, tfidf

CORPUS = [
    "The night is young and the city lights are burning bright",
    "We were running through the rain, the rain, the endless rain",
    "Drums and bass and a hundred voices calling out my name",
    "",
    "   ",
    "আমার সোনার বাংলা আমি তোমায় ভালোবাসি",
    "Café au lait, très bien, les enfants du paradis",
    "I I I me me myself and you",
    "12 34 ab cd ab ab x y z",
]


def test_stop_list_is_sklearns():
    assert tfidf.ENGLISH_STOP_WORDS == ENGLISH_STOP_WORDS
    assert len(tfidf.ENGLISH_STOP_WORDS) == 318
    assert isinstance(tfidf.ENGLISH_STOP_WORDS, frozenset)


def _synthetic_corpus():
    ds = make_dataset(60, seed=3, lyrics_coverage=0.8)
    return [t or "" for t in ds.lyrics]


@pytest.mark.parametrize("max_features", [None, 2000, 12])
@pytest.mark.parametrize("corpus", ["mixed", "synthetic"])
def test_tfidf_matches_jax_and_sklearn(max_features, corpus):
    docs = CORPUS if corpus == "mixed" else _synthetic_corpus()
    docs = [d if d.strip() else " " for d in docs]
    ours = tfidf.TfidfVectorizer(max_features=max_features,
                                 stop_words="english")
    x = ours.fit_transform(docs)
    ref = jtfidf.TfidfVectorizer(max_features=max_features,
                                 stop_words="english")
    np.testing.assert_array_equal(x, ref.fit_transform(docs))
    assert ours.vocabulary_ == ref.vocabulary_
    assert x.dtype == np.float32
    if max_features is not None and len(ours.vocabulary_) == max_features:
        # a cut through terms of equal corpus frequency: both packages keep
        # the alphabetically first, sklearn whichever its unstable argsort
        # of -tf puts first, so sklearn is compared without the cut
        return
    sk = SkTfidf(max_features=max_features, stop_words="english")
    want = sk.fit_transform(docs).toarray()
    assert ours.vocabulary_ == {k: int(v) for k, v in sk.vocabulary_.items()}
    np.testing.assert_allclose(x, want, rtol=0, atol=1e-6)


def test_embed_texts_tfidf_backend(monkeypatch, tmp_path):
    """No MiniLM checkpoint: the hard tier's TF-IDF, as the JAX package
    gives it (empty texts become " ")."""
    monkeypatch.delenv("VAE_HMC_MINILM_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "no_hf_cache"))
    docs = _synthetic_corpus()
    emb, backend = embed.embed_texts(docs, TEXT_HARD, device="cpu")
    want, jbackend = jembed.embed_texts(docs)
    assert backend == jbackend == "tfidf"
    np.testing.assert_array_equal(emb, want)
    assert emb.shape[0] == len(docs) and emb.dtype == np.float32
    emb, _ = embed.embed_texts(docs, TextEmbedConfig(tfidf_max_features=5),
                               device="cpu")
    assert emb.shape == (len(docs), 5)


@pytest.mark.parametrize("text", CORPUS + [None, 3.0, "১২৩", "!!! ???",
                                           "abc বাংলা"])
def test_detect_language_matches_jax(text):
    assert (langdetect.detect_language_simple(text)
            == jlangdetect.detect_language_simple(text))


def test_detect_language_cases():
    f = langdetect.detect_language_simple
    assert [f(None), f(""), f("  "), f("hello"), f("আমার"), f("123 !"),
            f("abc বাংলা")] == ["none", "none", "none", "en", "bn", "other",
                               "bn"]


def _labelings(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, 200)
    b = np.where(rng.random(200) < 0.7, a, rng.integers(0, 4, 200))
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nmi_mi_purity_contingency_match_jax_and_sklearn(seed):
    a, b = _labelings(seed)
    m = external.contingency_matrix(a, b)
    np.testing.assert_array_equal(m, jexternal.contingency_matrix(a, b))
    np.testing.assert_array_equal(m, sk_contingency(a, b))
    nmi = external.normalized_mutual_info(a, b)
    assert nmi == jexternal.normalized_mutual_info(a, b)
    assert abs(nmi - normalized_mutual_info_score(a, b)) < 1e-12
    mi = external.mutual_info(a, b)
    assert mi == jexternal.mutual_info(a, b)
    assert abs(mi - mutual_info_score(a, b)) < 1e-12
    p = external.purity(b, a)
    assert p == jexternal.purity(b, a)
    assert p == pytest.approx(m.T.max(axis=1).sum() / len(a), abs=0)


def test_nmi_and_purity_edge_cases():
    one = np.zeros(10, int)
    assert external.normalized_mutual_info(one, one) == 1.0
    assert external.normalized_mutual_info(one, np.arange(10)) == 0.0
    assert external.purity(np.arange(10), one) == 1.0
    genres = np.array(["Rock", "Pop", "Rock", "Folk"])
    assert external.purity(np.array([0, 0, 1, 1]), genres) == 0.5
