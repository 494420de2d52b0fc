"""Topic-quality diagnostics — TopicModelDiagnosticsPlain
(topics/TopicModelDiagnosticsPlain.java, 707 LoC; CSV output via
`topicsToCsv` :576, consumed by tui/ParallelLDA.java:219-225).

Scores per topic (reference method : our function):
  tokens            (:226)  — tokens assigned to topic
  document_entropy  (:236)  — entropy of p(d | k)
  word-length       (:399)  — mean top-word length (+ sd)
  coherence         (:474)  — Mimno et al. log co-document coherence
  uniform_dist      (:249)  — KL(top words || uniform)
  corpus_dist       (:311)  — KL(top words || corpus frequencies)
  eff_num_words     (:284)  — 1 / sum phi_kw^2 (inverse Simpson)
  token-doc-diff    (:346)  — JS-ish discrepancy between token share and
                              doc share per topic
  rank_1_docs       (:501)  — fraction of docs where topic is dominant
  allocation_ratio  (:511)  — docs>50% / docs>2% percentile ratio
  allocation_count  (:528)  — fraction of docs with >`percent` allocation

All computed from (nkw, ndk, top-word co-document counts) with NumPy — this
is a post-run reporting path, not a hot loop. The port's copy of
`ldagroupedgibbssampler_tpu/evaluation/diagnostics.py`: the same CSV line
for line.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


class TopicDiagnostics:
    def __init__(self, nkw: np.ndarray, ndk: np.ndarray, corpus,
                 num_top_words: int = 20):
        self.nkw = np.asarray(nkw, np.float64)          # [K, V]
        self.ndk = np.asarray(ndk, np.float64)          # [D, K]
        self.corpus = corpus
        self.num_topics, self.num_types = self.nkw.shape
        self.num_top_words = num_top_words
        self.top_idx = np.argsort(-self.nkw, axis=1)[:, :num_top_words]
        self._codoc = None

    # ------------------------------------------------------------------
    def tokens(self):
        return self.nkw.sum(axis=1)

    def document_entropy(self):
        p = self.ndk / np.maximum(self.ndk.sum(axis=0, keepdims=True), _EPS)
        return -np.sum(p * np.log(p + _EPS), axis=0)

    def word_length(self):
        vocab = self.corpus.vocab
        lengths = np.asarray([[len(vocab[i]) for i in row]
                              for row in self.top_idx], np.float64)
        return lengths.mean(axis=1), lengths.std(axis=1)

    def _codocument_counts(self):
        """codoc[k][i][j] = #docs containing top-word i and j of topic k
        (collectDocumentStatistics :108)."""
        if self._codoc is not None:
            return self._codoc
        c = self.corpus
        # doc-term incidence restricted to the union of top words
        union = np.unique(self.top_idx)
        col = {t: i for i, t in enumerate(union)}
        inc = np.zeros((c.num_docs, len(union)), np.float64)
        for d in range(c.num_docs):
            s, e = c.doc_offsets[d], c.doc_offsets[d + 1]
            for t in np.unique(c.tokens[s:e]):
                j = col.get(int(t))
                if j is not None:
                    inc[d, j] = 1.0
        co = inc.T @ inc                                  # [U, U]
        self._codoc = (co, col)
        return self._codoc

    def codocument_matrix(self, topic: int) -> np.ndarray:
        """[num_top_words, num_top_words] co-document counts for one
        topic's top words (getCodocumentMatrix,
        TopicModelDiagnosticsPlain.java:222-224)."""
        co, col = self._codocument_counts()
        idx = [col[int(t)] for t in self.top_idx[topic]]
        return co[np.ix_(idx, idx)].astype(np.int64)

    def coherence(self):
        """Mimno coherence: sum_{i<j} log((D(w_i, w_j) + 1) / D(w_j))
        over the topic's top words (:474-500)."""
        co, col = self._codocument_counts()
        out = np.zeros(self.num_topics)
        for k in range(self.num_topics):
            idx = [col[int(t)] for t in self.top_idx[k]]
            score = 0.0
            for i in range(1, len(idx)):
                for j in range(i):
                    score += np.log((co[idx[i], idx[j]] + 1.0)
                                    / max(co[idx[j], idx[j]], 1.0))
            out[k] = score
        return out

    def _top_word_probs(self):
        probs = np.take_along_axis(self.nkw, self.top_idx, axis=1)
        return probs / np.maximum(probs.sum(axis=1, keepdims=True), _EPS)

    def distance_from_uniform(self):
        p = self._top_word_probs()
        u = 1.0 / self.num_top_words
        return np.sum(p * np.log((p + _EPS) / u), axis=1)

    def distance_from_corpus(self):
        freq = self.corpus.type_frequencies().astype(np.float64)
        freq = freq / max(freq.sum(), 1)
        p = self._top_word_probs()
        q = np.take_along_axis(
            np.broadcast_to(freq, (self.num_topics, self.num_types)),
            self.top_idx, axis=1)
        q = q / np.maximum(q.sum(axis=1, keepdims=True), _EPS)
        return np.sum(p * np.log((p + _EPS) / (q + _EPS)), axis=1)

    def effective_number_of_words(self):
        phi = self.nkw / np.maximum(self.nkw.sum(axis=1, keepdims=True),
                                    _EPS)
        return 1.0 / np.maximum(np.sum(phi ** 2, axis=1), _EPS)

    def token_document_discrepancy(self):
        token_share = self.nkw.sum(axis=1)
        token_share = token_share / max(token_share.sum(), 1)
        doc_share = (self.ndk > 0).sum(axis=0).astype(np.float64)
        doc_share = doc_share / max(doc_share.sum(), 1)
        return np.abs(token_share - doc_share)

    def rank1_percent(self):
        dominant = np.argmax(self.ndk, axis=1)
        return np.bincount(dominant, minlength=self.num_topics) \
            / max(self.ndk.shape[0], 1)

    def allocation_count(self, percent: float = 0.05):
        share = self.ndk / np.maximum(self.ndk.sum(axis=1, keepdims=True),
                                      _EPS)
        return (share > percent).mean(axis=0)

    def allocation_ratio(self):
        return self.allocation_count(0.5) \
            / np.maximum(self.allocation_count(0.02), _EPS)

    # ------------------------------------------------------------------
    def scores(self) -> dict:
        wl_mean, wl_sd = self.word_length()
        return {
            "tokens": self.tokens(),
            "document_entropy": self.document_entropy(),
            "word-length": wl_mean,
            "word-length-sd": wl_sd,
            "coherence": self.coherence(),
            "uniform_dist": self.distance_from_uniform(),
            "corpus_dist": self.distance_from_corpus(),
            "eff_num_words": self.effective_number_of_words(),
            "token-doc-diff": self.token_document_discrepancy(),
            "rank_1_docs": self.rank1_percent(),
            "allocation_ratio": self.allocation_ratio(),
            "allocation_count": self.allocation_count(),
        }

    def to_csv_lines(self) -> list[str]:
        """topicsToCsv (:576): header + one row per topic + top words."""
        sc = self.scores()
        vocab = self.corpus.vocab
        header = "topic," + ",".join(sc.keys()) + ",top_words"
        lines = [header]
        for k in range(self.num_topics):
            row = [str(k)] + [f"{sc[name][k]:.6g}" for name in sc]
            words = " ".join(vocab[i] for i in self.top_idx[k])
            lines.append(",".join(row) + "," + words)
        return lines


def topic_diagnostics_csv(model, corpus, num_top_words: int = 20):
    diag = TopicDiagnostics(model.get_topic_type_counts(),
                            model.get_document_topic_matrix(), corpus,
                            num_top_words)
    return diag.to_csv_lines()
