// Fast corpus tokenizer / vocabulary builder.
//
// Native replacement for the hot part of the data-ingestion layer
// (reference: cc/mallet/pipe/SimpleTokenizerLarge.java:15-29 + the
// two-sweep loaders util/LDAUtils.java:212-467). The reference is
// JVM-bound here; for PubMed-scale corpora (~730M tokens,
// resources/datasets/README.txt) a single-pass C++ tokenizer keeps corpus
// load off the critical path. Exposed through a plain C ABI for ctypes
// (no pybind11 in this image).
//
// Semantics match corpus/tokenizer.py::tokenize exactly on ASCII text
// (the Python implementation remains the fallback and the executable
// spec; callers route non-ASCII text to Python). MALLET's tokenizers
// three-way classify characters (SimpleTokenizerLarge.java:67-118):
//   - token chars: [a-z]; mode "numeric"/"connector_numeric" adds [0-9]
//     (NumericAlsoTokenizer.java:96); mode "connector"/
//     "connector_numeric" adds '_' (Pc connector punctuation,
//     KeepConnectorPunctuationTokenizerLarge.java:70)
//   - delimiters: whitespace + punctuation incl. '-' (DASH_PUNCTUATION
//     always delimits); '_' delimits outside connector modes
//   - transparent (skipped WITHOUT breaking the token): digits outside
//     numeric modes, math/currency/modifier symbols (+ < = > | ~ $ ^ `),
//     controls — the reference's silent else branch (:111-115)
//   - tokens shorter than 2 chars are dropped
//   - stoplist filtering; per-document token cap (max_doc_buf_size)
//
// Build: g++ -O3 -march=native -shared -fPIC fast_tokenizer.cpp -o libfasttok.so

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Corpus {
  std::vector<int32_t> tokens;
  std::vector<int64_t> doc_offsets;  // D+1
  std::vector<std::string> vocab;    // id -> surface
  std::string vocab_blob;            // '\n'-joined, built on demand
};

enum CharClass { kTransparent = 0, kToken = 1, kDelim = 2 };

// mode: 0=simple, 1=numeric, 2=connector, 3=connector_numeric.
inline CharClass classify(unsigned char c, int mode) {
  const bool keep_num = (mode == 1 || mode == 3);
  const bool keep_conn = (mode == 2 || mode == 3);
  if (c >= 'a' && c <= 'z') return kToken;
  if (c >= '0' && c <= '9') return keep_num ? kToken : kTransparent;
  if (c == '_') return keep_conn ? kToken : kDelim;
  switch (c) {
    case ' ': case '\t': case '\n': case '\r': case '\f': case '\v':
    case '-': case '!': case '"': case '#': case '%': case '&':
    case '\'': case '(': case ')': case '*': case ',': case '.':
    case '/': case ':': case ';': case '?': case '@': case '[':
    case '\\': case ']': case '{': case '}':
      return kDelim;
    default:
      // + < = > | ~ $ ^ ` and controls: MALLET's transparent else branch.
      return kTransparent;
  }
}

}  // namespace

extern "C" {

// Tokenize `num_docs` documents. `texts` is one blob; `text_offsets`
// [num_docs+1] delimits each document's raw text. `stoplist` is a
// '\n'-separated blob (may be empty). mode: 0=simple, 1=numeric,
// 2=connector. Returns an opaque handle.
void* tokenize_corpus(const char* texts, const int64_t* text_offsets,
                      int64_t num_docs, const char* stoplist,
                      int64_t stoplist_len, int mode,
                      int64_t max_doc_tokens) {
  auto* corpus = new Corpus();
  corpus->doc_offsets.reserve(num_docs + 1);
  corpus->doc_offsets.push_back(0);

  std::unordered_set<std::string> stop;
  {
    const char* p = stoplist;
    const char* end = stoplist + stoplist_len;
    while (p < end) {
      const char* nl = static_cast<const char*>(
          memchr(p, '\n', static_cast<size_t>(end - p)));
      size_t n = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
      if (n > 0) {
        std::string w(p, n);
        for (auto& ch : w) ch = static_cast<char>(tolower(ch));
        stop.insert(std::move(w));
      }
      p = nl ? nl + 1 : end;
    }
  }

  std::unordered_map<std::string, int32_t> vocab_ids;
  std::string tok;
  tok.reserve(64);

  for (int64_t d = 0; d < num_docs; ++d) {
    const char* p = texts + text_offsets[d];
    const char* end = texts + text_offsets[d + 1];
    int64_t doc_count = 0;
    while (p <= end) {
      unsigned char c = (p < end) ? static_cast<unsigned char>(*p) : ' ';
      unsigned char lc = static_cast<unsigned char>(tolower(c));
      CharClass cls = classify(lc, mode);
      if (cls == kToken) {
        tok.push_back(static_cast<char>(lc));
      } else if (cls == kTransparent) {
        // skipped without delimiting (digits in simple mode, symbols)
      } else if (!tok.empty()) {
        if (tok.size() >= 2 && !stop.count(tok) &&
            (max_doc_tokens <= 0 || doc_count < max_doc_tokens)) {
          auto it = vocab_ids.find(tok);
          int32_t id;
          if (it == vocab_ids.end()) {
            id = static_cast<int32_t>(corpus->vocab.size());
            vocab_ids.emplace(tok, id);
            corpus->vocab.push_back(tok);
          } else {
            id = it->second;
          }
          corpus->tokens.push_back(id);
          ++doc_count;
        }
        tok.clear();
      }
      ++p;
    }
    corpus->doc_offsets.push_back(
        static_cast<int64_t>(corpus->tokens.size()));
  }
  return corpus;
}

int64_t corpus_num_tokens(void* h) {
  return static_cast<int64_t>(static_cast<Corpus*>(h)->tokens.size());
}
int64_t corpus_num_docs(void* h) {
  return static_cast<int64_t>(static_cast<Corpus*>(h)->doc_offsets.size()) - 1;
}
int64_t corpus_vocab_size(void* h) {
  return static_cast<int64_t>(static_cast<Corpus*>(h)->vocab.size());
}

// Copy-out accessors (caller allocates).
void corpus_copy_tokens(void* h, int32_t* out) {
  auto* c = static_cast<Corpus*>(h);
  memcpy(out, c->tokens.data(), c->tokens.size() * sizeof(int32_t));
}
void corpus_copy_offsets(void* h, int64_t* out) {
  auto* c = static_cast<Corpus*>(h);
  memcpy(out, c->doc_offsets.data(), c->doc_offsets.size() * sizeof(int64_t));
}

// Vocabulary as one '\n'-joined blob; returns its length. Call with
// out=nullptr to query the size first.
int64_t corpus_vocab_blob(void* h, char* out) {
  auto* c = static_cast<Corpus*>(h);
  if (c->vocab_blob.empty() && !c->vocab.empty()) {
    size_t total = 0;
    for (const auto& w : c->vocab) total += w.size() + 1;
    c->vocab_blob.reserve(total);
    for (const auto& w : c->vocab) {
      c->vocab_blob += w;
      c->vocab_blob += '\n';
    }
  }
  if (out != nullptr) {
    memcpy(out, c->vocab_blob.data(), c->vocab_blob.size());
  }
  return static_cast<int64_t>(c->vocab_blob.size());
}

void corpus_free(void* h) { delete static_cast<Corpus*>(h); }

}  // extern "C"
