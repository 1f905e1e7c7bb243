"""First-party TF-IDF vectorizer with sklearn TfidfVectorizer semantics
(port of ``vae_hmc_tpu.text.tfidf``).

The hard tier's text-embedding fallback (reference scripts/18:221-222:
TfidfVectorizer(max_features=2000, stop_words='english')).  Reproduces the
sklearn defaults that matter for parity:
  - lowercase, token_pattern r'(?u)\\b\\w\\w+\\b' (>=2 word chars), unigrams;
  - vocabulary sorted alphabetically; max_features keeps the top terms by
    corpus-wide term frequency;
  - smooth idf: ln((1+n)/(1+df)) + 1;  tf = raw counts;  l2 row norm.
The stop list is the port's own copy of sklearn's ENGLISH_STOP_WORDS (318
words).  The JAX package takes sklearn's list when sklearn imports and a
25-word list otherwise, so where sklearn is missing (as on the GPU
machine) the two packages' vocabularies would differ; the port always
uses the 318 words (tests/test_torch_text_hard.py compares the list and
the vectors with sklearn's).
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

_TOKEN = re.compile(r"(?u)\b\w\w+\b")

# sklearn.feature_extraction.text.ENGLISH_STOP_WORDS, verbatim
ENGLISH_STOP_WORDS = frozenset("""
    a about above across after afterwards again against all almost
    alone along already also although always am among amongst amoungst
    amount an and another any anyhow anyone anything anyway anywhere
    are around as at back be became because become becomes becoming
    been before beforehand behind being below beside besides between
    beyond bill both bottom but by call can cannot cant co con could
    couldnt cry de describe detail do done down due during each eg
    eight either eleven else elsewhere empty enough etc even ever
    every everyone everything everywhere except few fifteen fifty fill
    find fire first five for former formerly forty found four from
    front full further get give go had has hasnt have he hence her
    here hereafter hereby herein hereupon hers herself him himself his
    how however hundred i ie if in inc indeed interest into is it its
    itself keep last latter latterly least less ltd made many may me
    meanwhile might mill mine more moreover most mostly move much must
    my myself name namely neither never nevertheless next nine no
    nobody none noone nor not nothing now nowhere of off often on once
    one only onto or other others otherwise our ours ourselves out
    over own part per perhaps please put rather re same see seem
    seemed seeming seems serious several she should show side since
    sincere six sixty so some somehow someone something sometime
    sometimes somewhere still such system take ten than that the their
    them themselves then thence there thereafter thereby therefore
    therein thereupon these they thick thin third this those though
    three through throughout thru thus to together too top toward
    towards twelve twenty two un under until up upon us very via was
    we well were what whatever when whence whenever where whereafter
    whereas whereby wherein whereupon wherever whether which while
    whither who whoever whole whom whose why will with within without
    would yet you your yours yourself yourselves
""".split())


class TfidfVectorizer:
    def __init__(self, max_features: Optional[int] = None,
                 stop_words: Optional[str] = None):
        self.max_features = max_features
        self.stop_words = (ENGLISH_STOP_WORDS if stop_words == "english"
                           else None)
        self.vocabulary_: Dict[str, int] = {}
        self.idf_: Optional[np.ndarray] = None

    def _tokenize(self, doc: str) -> List[str]:
        toks = _TOKEN.findall(doc.lower())
        if self.stop_words is not None:
            toks = [t for t in toks if t not in self.stop_words]
        return toks

    def fit_transform(self, docs: Sequence[str]) -> np.ndarray:
        n = len(docs)
        counts: List[Dict[str, int]] = []
        tf_total: Dict[str, int] = {}
        df: Dict[str, int] = {}
        for d in docs:
            c: Dict[str, int] = {}
            for t in self._tokenize(d):
                c[t] = c.get(t, 0) + 1
            counts.append(c)
            for t, k in c.items():
                tf_total[t] = tf_total.get(t, 0) + k
                df[t] = df.get(t, 0) + 1
        terms = sorted(tf_total)
        if self.max_features is not None and len(terms) > self.max_features:
            # top-k by corpus term frequency (sklearn _limit_features)
            ranked = sorted(terms, key=lambda t: (-tf_total[t], t))
            keep = set(ranked[: self.max_features])
            terms = [t for t in terms if t in keep]
        self.vocabulary_ = {t: i for i, t in enumerate(terms)}
        self.idf_ = np.log((1.0 + n) / (1.0 + np.asarray(
            [df[t] for t in terms], dtype=np.float64))) + 1.0
        return self._transform_counts(counts)

    def transform(self, docs: Sequence[str]) -> np.ndarray:
        """Vectors of `docs` over the fitted vocabulary and idf; terms
        outside the vocabulary are dropped."""
        return self._transform_counts(
            [Counter(self._tokenize(d)) for d in docs])

    def _transform_counts(self, counts: Sequence[Dict[str, int]]
                          ) -> np.ndarray:
        x = np.zeros((len(counts), len(self.vocabulary_)), dtype=np.float64)
        for i, c in enumerate(counts):
            for t, k in c.items():
                j = self.vocabulary_.get(t)
                if j is not None:
                    x[i, j] = k
        x *= self.idf_[None, :]
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        norms[norms == 0.0] = 1.0
        return (x / norms).astype(np.float32)
