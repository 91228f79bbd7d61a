// Native corpus ingestion: trectext parsing, tokenization, vocabulary
// selection, and token packing.
//
// This is the TPU-framework equivalent of the reference's native data layer
// (cpp/data_indri.cpp + the Indri index it reads): the host-side, IO- and
// string-heavy part of the pipeline that profits from C++ throughput at
// collection scale.  Semantics mirror cunvsm_tpu/data/{text,vocab,corpus}.py
// exactly (the Python implementation remains as the reference fallback and
// the oracle for differential tests):
//
//  * tokens are lowercase [a-z0-9]+ runs, minus stopwords;
//  * documents shorter than the window (post-stopword) are dropped;
//  * vocabulary: drop numeric terms (unless include_digits), blacklisted
//    terms, and terms with document frequency outside [min_df, max_df]
//    (max_df <= 1.0 is a corpus fraction); keep top max_vocab by collection
//    frequency; model ids ascend by (frequency, first-occurrence id);
//    frequencies recomputed over kept docs when a subset was dropped;
//  * OOV positions dropped, or emitted as id 0 with include_oov.
//
// Exposed as a C API consumed through ctypes (cunvsm_tpu/data/native.py).

#include "corpus.h"

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct TermStats {
    int64_t first_id = 0;  // 1-based first-occurrence rank
    int64_t cf = 0;
    int64_t df = 0;
    int64_t last_doc = -1;
};

bool is_number(const std::string& term) {
    // Must match the Python oracle: float(term) over the token alphabet
    // [a-z0-9] (no '.', '+', '-' can appear).  Accepted forms: "nan",
    // "inf"/"infinity", and DIGITS[eDIGITS].  Note strtod is NOT equivalent
    // (it also accepts C99 hex like "0x1a", which Python rejects).
    if (term.empty()) return false;
    if (term == "nan" || term == "inf" || term == "infinity") return true;
    size_t i = 0;
    size_t digits = 0;
    while (i < term.size() && std::isdigit(
               static_cast<unsigned char>(term[i]))) {
        ++i;
        ++digits;
    }
    if (digits == 0) return false;
    if (i == term.size()) return true;
    if (term[i] != 'e') return false;
    ++i;
    size_t exp_digits = 0;
    while (i < term.size() && std::isdigit(
               static_cast<unsigned char>(term[i]))) {
        ++i;
        ++exp_digits;
    }
    return i == term.size() && exp_digits > 0;
}

void tokenize(const std::string& text,
              const std::unordered_set<std::string>& stopwords,
              std::vector<std::string>* out) {
    std::string cur;
    for (char raw : text) {
        unsigned char c = static_cast<unsigned char>(raw);
        if (std::isalnum(c)) {
            cur.push_back(static_cast<char>(std::tolower(c)));
        } else if (!cur.empty()) {
            if (stopwords.empty() || !stopwords.count(cur)) out->push_back(cur);
            cur.clear();
        }
    }
    if (!cur.empty() && (stopwords.empty() || !stopwords.count(cur)))
        out->push_back(cur);
}

std::string strip_tags(const std::string& s) {
    std::string out;
    out.reserve(s.size());
    bool in_tag = false;
    for (char c : s) {
        if (c == '<') in_tag = true;
        else if (c == '>') { in_tag = false; out.push_back(' '); }
        else if (!in_tag) out.push_back(c);
    }
    return out;
}

// Parse TRECTEXT: emits (docno, body-with-tags-stripped).
void parse_trectext(const std::string& data,
                    std::vector<std::pair<std::string, std::string>>* docs) {
    size_t pos = 0;
    while (true) {
        size_t start = data.find("<DOC>", pos);
        if (start == std::string::npos) break;
        size_t end = data.find("</DOC>", start);
        if (end == std::string::npos) break;
        std::string doc = data.substr(start + 5, end - start - 5);
        pos = end + 6;

        size_t no_start = doc.find("<DOCNO>");
        size_t no_end = doc.find("</DOCNO>");
        if (no_start == std::string::npos || no_end == std::string::npos)
            continue;
        std::string docno = doc.substr(no_start + 7, no_end - no_start - 7);
        // trim whitespace
        size_t a = docno.find_first_not_of(" \t\r\n");
        size_t b = docno.find_last_not_of(" \t\r\n");
        if (a == std::string::npos) continue;
        docno = docno.substr(a, b - a + 1);

        std::string body =
            doc.substr(0, no_start) + doc.substr(no_end + 8);
        docs->emplace_back(docno, strip_tags(body));
    }
}

std::unordered_set<std::string> load_word_list(const char* path) {
    std::unordered_set<std::string> words;
    if (path == nullptr || *path == '\0') return words;
    std::ifstream f(path);
    std::string line;
    while (std::getline(f, line)) {
        std::vector<std::string> toks;
        tokenize(strip_tags(line), {}, &toks);
        for (auto& t : toks) words.insert(t);
    }
    return words;
}

}  // namespace

extern "C" {

// Build a packed corpus from a TRECTEXT file.  Returns an opaque Corpus*.
void* corpus_build(const char* trectext_path, const char* stopword_path,
                   const char* blacklist_path, int window_size,
                   long max_vocab, long min_df, double max_df_raw,
                   int include_oov, int include_digits, long doc_cutoff) {
    Corpus* c = new Corpus();
    std::ifstream f(trectext_path, std::ios::binary);
    if (!f) {
        c->error = "cannot open corpus file";
        return c;
    }
    std::stringstream ss;
    ss << f.rdbuf();
    std::string data = ss.str();

    auto stopwords = load_word_list(stopword_path);
    auto blacklist = load_word_list(blacklist_path);

    std::vector<std::pair<std::string, std::string>> raw_docs;
    parse_trectext(data, &raw_docs);
    data.clear();
    data.shrink_to_fit();

    // Tokenize all documents; compute corpus-wide df/cf with
    // first-occurrence term ids.
    std::vector<std::vector<std::string>> tokenized(raw_docs.size());
    std::unordered_map<std::string, TermStats> stats;
    int64_t next_id = 1;
    for (size_t d = 0; d < raw_docs.size(); ++d) {
        tokenize(raw_docs[d].second, stopwords, &tokenized[d]);
        raw_docs[d].second.clear();
        for (const auto& t : tokenized[d]) {
            auto& s = stats[t];
            if (s.first_id == 0) s.first_id = next_id++;
            s.cf += 1;
            if (s.last_doc != static_cast<int64_t>(d)) {
                s.last_doc = static_cast<int64_t>(d);
                s.df += 1;
            }
        }
    }

    // Document selection: index length >= window, then cutoff.
    std::vector<size_t> kept;
    for (size_t d = 0; d < tokenized.size(); ++d) {
        if (static_cast<int>(tokenized[d].size()) >= window_size)
            kept.push_back(d);
    }
    if (doc_cutoff > 0 && static_cast<long>(kept.size()) > doc_cutoff)
        kept.resize(doc_cutoff);

    long max_df = static_cast<long>(max_df_raw);
    if (max_df_raw > 0.0 && max_df_raw <= 1.0) {
        max_df = static_cast<long>(
            std::ceil(raw_docs.size() * max_df_raw));
    }

    // Candidate terms sorted by (cf, first_id) ascending.
    struct Cand { int64_t cf; int64_t first_id; const std::string* term; };
    std::vector<Cand> candidates;
    candidates.reserve(stats.size());
    for (const auto& kv : stats) {
        const std::string& term = kv.first;
        const TermStats& s = kv.second;
        if (!include_digits && is_number(term)) continue;
        if (!blacklist.empty() && blacklist.count(term)) continue;
        if (min_df > 0 && s.df < min_df) continue;
        if (max_df > 0 && s.df > max_df) continue;
        candidates.push_back({s.cf, s.first_id, &term});
    }
    std::sort(candidates.begin(), candidates.end(),
              [](const Cand& a, const Cand& b) {
                  return a.cf != b.cf ? a.cf < b.cf : a.first_id < b.first_id;
              });
    if (max_vocab > 0 && static_cast<long>(candidates.size()) > max_vocab) {
        candidates.erase(candidates.begin(),
                         candidates.end() - max_vocab);
    }

    // Subset frequency recomputation.
    std::unordered_map<std::string, int64_t> subset_cf;
    bool subset = kept.size() != tokenized.size();
    if (subset) {
        for (size_t d : kept)
            for (const auto& t : tokenized[d]) subset_cf[t] += 1;
    }

    if (include_oov) {
        c->vocab_terms.push_back("");
        c->index_term_ids.push_back(0);
        c->term_freq.push_back(1);
    }
    std::unordered_map<std::string, int32_t> term_to_id;
    for (const auto& cand : candidates) {
        int64_t freq = cand.cf;
        if (subset) {
            auto it = subset_cf.find(*cand.term);
            freq = it == subset_cf.end() ? 0 : it->second;
            if (freq == 0) continue;
        }
        term_to_id[*cand.term] =
            static_cast<int32_t>(c->vocab_terms.size());
        c->vocab_terms.push_back(*cand.term);
        c->index_term_ids.push_back(cand.first_id);
        c->term_freq.push_back(freq);
        c->total_terms += freq;
    }

    // Pack kept documents.
    c->offsets.push_back(0);
    for (size_t d : kept) {
        for (const auto& t : tokenized[d]) {
            auto it = term_to_id.find(t);
            if (it != term_to_id.end()) {
                c->tokens.push_back(it->second);
            } else if (include_oov) {
                c->tokens.push_back(0);
            }
        }
        c->offsets.push_back(static_cast<int64_t>(c->tokens.size()));
        c->index_lengths.push_back(
            static_cast<int64_t>(tokenized[d].size()));
        c->docnos.push_back(raw_docs[d].first);
    }
    return c;
}

const char* corpus_error(void* h) {
    return static_cast<Corpus*>(h)->error.c_str();
}
long corpus_num_docs(void* h) {
    return static_cast<long>(static_cast<Corpus*>(h)->docnos.size());
}
long corpus_num_tokens(void* h) {
    return static_cast<long>(static_cast<Corpus*>(h)->tokens.size());
}
long corpus_vocab_size(void* h) {
    return static_cast<long>(static_cast<Corpus*>(h)->vocab_terms.size());
}
long corpus_total_terms(void* h) {
    return static_cast<Corpus*>(h)->total_terms;
}
void corpus_copy_tokens(void* h, int32_t* out) {
    auto& v = static_cast<Corpus*>(h)->tokens;
    std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}
void corpus_copy_offsets(void* h, int64_t* out) {
    auto& v = static_cast<Corpus*>(h)->offsets;
    std::memcpy(out, v.data(), v.size() * sizeof(int64_t));
}
void corpus_copy_index_lengths(void* h, int64_t* out) {
    auto& v = static_cast<Corpus*>(h)->index_lengths;
    std::memcpy(out, v.data(), v.size() * sizeof(int64_t));
}
void corpus_copy_term_freq(void* h, int64_t* out) {
    auto& v = static_cast<Corpus*>(h)->term_freq;
    std::memcpy(out, v.data(), v.size() * sizeof(int64_t));
}
void corpus_copy_index_term_ids(void* h, int64_t* out) {
    auto& v = static_cast<Corpus*>(h)->index_term_ids;
    std::memcpy(out, v.data(), v.size() * sizeof(int64_t));
}
long corpus_num_index_doc_ids(void* h) {
    return static_cast<long>(static_cast<Corpus*>(h)->index_doc_ids.size());
}
void corpus_copy_index_doc_ids(void* h, int64_t* out) {
    auto& v = static_cast<Corpus*>(h)->index_doc_ids;
    std::memcpy(out, v.data(), v.size() * sizeof(int64_t));
}

static int64_t joined_size(const std::vector<std::string>& v) {
    int64_t n = 0;
    for (const auto& s : v) n += static_cast<int64_t>(s.size()) + 1;
    return n;
}
static void copy_joined(const std::vector<std::string>& v, char* out) {
    for (const auto& s : v) {
        std::memcpy(out, s.data(), s.size());
        out += s.size();
        *out++ = '\n';
    }
}
long corpus_vocab_bytes(void* h) {
    return joined_size(static_cast<Corpus*>(h)->vocab_terms);
}
void corpus_copy_vocab(void* h, char* out) {
    copy_joined(static_cast<Corpus*>(h)->vocab_terms, out);
}
long corpus_docnos_bytes(void* h) {
    return joined_size(static_cast<Corpus*>(h)->docnos);
}
void corpus_copy_docnos(void* h, char* out) {
    copy_joined(static_cast<Corpus*>(h)->docnos, out);
}
void corpus_free(void* h) { delete static_cast<Corpus*>(h); }

}  // extern "C"
