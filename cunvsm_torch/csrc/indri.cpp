// Native Indri DiskIndex ingestion: the C++ twin of
// cunvsm_tpu/data/indri.py (the Python implementation stays the semantic
// oracle; tests/test_native.py runs both differentially over the
// checked-in Brown index).
//
// Reads the on-disk Indri 5.x format directly — RVL-compressed direct-file
// term lists, BulkTree term vocabularies, Keyfile docno lookups — and
// builds the same packed Corpus the TRECTEXT backend produces, with real
// Indri term/document ids preserved for checkpoint-metadata interop.
// Semantics mirror the reference's IndriSource::initialize
// (cpp/data_indri.cpp:620-887): document selection by index length >=
// window (or a docno list, order preserved), vocabulary filtering by
// digit/blacklist/df bounds with top-K by collection frequency in
// ascending (cf, term id) order, subset frequency recounting, and
// stopped/OOV position handling.

#include "corpus.h"

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr size_t kKeyfileBlock = 4096;
constexpr size_t kBulkTreeBlock = 8192;

std::string read_file(const std::string& path, std::string* error) {
    std::ifstream f(path, std::ios::binary);
    if (!f) {
        if (error->empty()) *error = "cannot open " + path;
        return "";
    }
    std::stringstream ss;
    ss << f.rdbuf();
    return ss.str();
}

// -- tiny XML parameter extraction (Indri manifests are flat + regular) ----

std::string tag_value(const std::string& xml, const std::string& tag) {
    const std::string open = "<" + tag + ">";
    const std::string close = "</" + tag + ">";
    size_t lo = xml.find(open);
    if (lo == std::string::npos) return "";
    lo += open.size();
    size_t hi = xml.find(close, lo);
    if (hi == std::string::npos) return "";
    std::string v = xml.substr(lo, hi - lo);
    // strip surrounding whitespace
    size_t a = v.find_first_not_of(" \t\r\n");
    size_t b = v.find_last_not_of(" \t\r\n");
    return a == std::string::npos ? "" : v.substr(a, b - a + 1);
}

std::vector<std::string> tag_values(const std::string& xml,
                                    const std::string& tag) {
    const std::string open = "<" + tag + ">";
    const std::string close = "</" + tag + ">";
    std::vector<std::string> out;
    size_t pos = 0;
    while (true) {
        size_t lo = xml.find(open, pos);
        if (lo == std::string::npos) break;
        lo += open.size();
        size_t hi = xml.find(close, lo);
        if (hi == std::string::npos) break;
        std::string v = xml.substr(lo, hi - lo);
        size_t a = v.find_first_not_of(" \t\r\n");
        size_t b = v.find_last_not_of(" \t\r\n");
        out.push_back(a == std::string::npos ? "" : v.substr(a, b - a + 1));
        pos = hi + close.size();
    }
    return out;
}

// -- RVL decoding ----------------------------------------------------------

inline int64_t rvl_decode(const unsigned char* buf, size_t* pos) {
    int64_t val = 0;
    int shift = 0;
    for (;;) {
        unsigned char b = buf[(*pos)++];
        if (b & 0x80) return val | (static_cast<int64_t>(b & 0x7F) << shift);
        val |= static_cast<int64_t>(b) << shift;
        shift += 7;
    }
}

// -- BulkTree leaf walk ------------------------------------------------------

struct TermEntry {
    std::string term;
    int64_t term_id;  // Indri internal id
    int64_t cf;
    int64_t df;
};

void parse_term_tree(const std::string& data, int64_t id_offset,
                     std::vector<TermEntry>* out) {
    const unsigned char* bytes =
        reinterpret_cast<const unsigned char*>(data.data());
    for (size_t base = 0; base + kBulkTreeBlock <= data.size();
         base += kBulkTreeBlock) {
        uint16_t header;
        std::memcpy(&header, bytes + base, 2);
        const uint16_t count = header & 0x7FFF;
        const bool leaf = header & 0x8000;
        if (count == 0 || !leaf) continue;
        size_t dirpos = base + kBulkTreeBlock;
        size_t prev_end = base + 2;
        for (uint16_t i = 0; i < count; ++i) {
            uint16_t vs, ve;
            std::memcpy(&vs, bytes + dirpos - 4, 2);
            std::memcpy(&ve, bytes + dirpos - 2, 2);
            dirpos -= 4;
            TermEntry e;
            e.term.assign(data, prev_end, base + vs - prev_end);
            size_t pos = base + vs;
            e.cf = rvl_decode(bytes, &pos);
            e.df = rvl_decode(bytes, &pos);
            rvl_decode(bytes, &pos);  // max doc length
            rvl_decode(bytes, &pos);  // min doc length
            e.term_id = rvl_decode(bytes, &pos) + id_offset;
            out->push_back(std::move(e));
            prev_end = base + ve;
        }
    }
}

// -- Keyfile walk ------------------------------------------------------------

void parse_keyfile(const std::string& data,
                   std::vector<std::pair<std::string, std::string>>* out) {
    const unsigned char* bytes =
        reinterpret_cast<const unsigned char*>(data.data());
    for (size_t base = kKeyfileBlock; base + kKeyfileBlock <= data.size();
         base += kKeyfileBlock) {
        const uint16_t nkeys = (bytes[base] << 8) | bytes[base + 1];
        const uint16_t chars = (bytes[base + 2] << 8) | bytes[base + 3];
        if (nkeys == 0 || chars > kKeyfileBlock) continue;
        const unsigned char prefix_lc = bytes[base + 5];
        const std::string prefix(
            data, base + kKeyfileBlock - prefix_lc, prefix_lc);
        // Entries fill the block tail before a one-byte pad + the prefix.
        const size_t end_limit = base + kKeyfileBlock - prefix_lc - 1;
        size_t pos = end_limit - (chars - prefix_lc);
        struct Raw { unsigned char lc; std::string suffix, value; };
        std::vector<Raw> raw;
        bool ok = true;
        for (uint16_t i = 0; i < nkeys; ++i) {
            if (pos + 2 >= end_limit) { ok = false; break; }
            unsigned char lc = bytes[pos], ln = bytes[pos + 1];
            size_t vpos = pos + 2 + ln;
            if (vpos >= end_limit || bytes[vpos] < 1) { ok = false; break; }
            unsigned char vlen = bytes[vpos];
            raw.push_back({lc, std::string(data, pos + 2, ln),
                           std::string(data, vpos + 1, vlen - 1)});
            pos = vpos + vlen;
        }
        if (!ok || pos != end_limit) continue;  // not a level-0 data block
        // Stored back-to-front in descending key order.
        std::string prev_tail;
        for (auto it = raw.rbegin(); it != raw.rend(); ++it) {
            std::string tail = prev_tail.substr(0, it->lc) + it->suffix;
            prev_tail = tail;
            out->emplace_back(prefix + tail, it->value);
        }
    }
}

int64_t decode_docid_key(const std::string& key) {
    int64_t v = 0;
    for (unsigned char b : key) v = (v << 6) | (b - 0x40);
    return v;
}

bool is_digitpart(const std::string& t, size_t lo, size_t hi) {
    // Python digitpart: digit (('_')? digit)*
    if (lo >= hi) return false;
    bool prev_digit = false;
    for (size_t i = lo; i < hi; ++i) {
        if (std::isdigit(static_cast<unsigned char>(t[i]))) {
            prev_digit = true;
        } else if (t[i] == '_') {
            if (!prev_digit || i + 1 >= hi ||
                !std::isdigit(static_cast<unsigned char>(t[i + 1])))
                return false;
            prev_digit = false;
        } else {
            return false;
        }
    }
    return true;
}

bool is_number(const std::string& term) {
    // Faithful acceptor for Python's float(term) grammar (the oracle the
    // Python reader uses): [sign] (inf|infinity|nan | digitpart[.digitpart?]
    // | [digitpart].digitpart) [e [sign] digitpart].
    size_t lo = 0, hi = term.size();
    if (lo >= hi) return false;
    if (term[lo] == '+' || term[lo] == '-') ++lo;
    std::string body = term.substr(lo, hi - lo);
    for (auto& ch : body) ch = std::tolower(static_cast<unsigned char>(ch));
    if (body == "inf" || body == "infinity" || body == "nan") return true;
    // Split the exponent.
    size_t e = body.find_first_of("e");
    std::string mant = e == std::string::npos ? body : body.substr(0, e);
    if (e != std::string::npos) {
        std::string exp = body.substr(e + 1);
        size_t xlo = 0;
        if (!exp.empty() && (exp[0] == '+' || exp[0] == '-')) xlo = 1;
        if (!is_digitpart(exp, xlo, exp.size())) return false;
    }
    size_t dot = mant.find('.');
    if (dot == std::string::npos)
        return is_digitpart(mant, 0, mant.size());
    const bool left = dot > 0;
    const bool right = dot + 1 < mant.size();
    if (!left && !right) return false;
    if (left && !is_digitpart(mant, 0, dot)) return false;
    if (right && !is_digitpart(mant, dot + 1, mant.size())) return false;
    return left || right;
}

std::vector<std::string> load_lines(const char* path) {
    std::vector<std::string> lines;
    if (path == nullptr || *path == '\0') return lines;
    std::ifstream f(path);
    std::string line;
    while (std::getline(f, line)) {
        size_t a = line.find_first_not_of(" \t\r\n");
        size_t b = line.find_last_not_of(" \t\r\n");
        if (a != std::string::npos) lines.push_back(line.substr(a, b - a + 1));
    }
    return lines;
}

}  // namespace

extern "C" {

// Build a packed corpus from an Indri DiskIndex repository.
void* indri_build(const char* repository_path, const char* doclist_path,
                  const char* blacklist_path, int window_size,
                  long max_vocab, long min_df, double max_df_raw,
                  int include_oov, int include_digits, long doc_cutoff) {
    Corpus* c = new Corpus();
    const std::string repo(repository_path);

    const std::string manifest = read_file(repo + "/manifest", &c->error);
    if (!c->error.empty()) return c;
    // Every on-disk index listed in the repository manifest.  The
    // reference FATALs on more than one (data_indri.cpp:43-45); here the
    // per-index term dictionaries are merged (see data/indri.py, the
    // semantic oracle for this reader).
    const std::string idx_block = tag_value(manifest, "indexes");
    std::vector<std::string> index_names =
        tag_values(idx_block.empty() ? manifest : idx_block, "index");
    if (index_names.empty()) {
        c->error = "repository manifest lists no indexes";
        return c;
    }

    struct DocStat {
        uint64_t offset;
        int32_t byte_length, indexed_length, total_length, unique_terms;
    } __attribute__((packed));
    struct IdxData {
        int64_t document_base = 1;
        int64_t maximum_document = 0;
        int64_t frequent_count = 0;
        std::vector<uint32_t> doc_lengths;
        std::string direct;
        std::string ds;  // raw documentStatistics bytes
        std::vector<TermEntry> vocab;
        std::vector<int32_t> local_to_merged;  // empty => identity
        const DocStat* stats() const {
            return reinterpret_cast<const DocStat*>(ds.data());
        }
    };

    std::vector<IdxData> idxs;
    for (const std::string& name : index_names) {
        const std::string index_dir = repo + "/index/" + name;
        const std::string info = read_file(index_dir + "/manifest",
                                           &c->error);
        if (!c->error.empty()) return c;
        IdxData ix;
        ix.document_base = std::max<int64_t>(
            1, atoll(tag_value(info, "document-base").c_str()));
        ix.maximum_document =
            atoll(tag_value(info, "maximum-document").c_str());
        ix.frequent_count =
            atoll(tag_value(info, "frequent-terms").c_str());
        const std::string dl = read_file(index_dir + "/documentLengths",
                                         &c->error);
        ix.ds = read_file(index_dir + "/documentStatistics", &c->error);
        ix.direct = read_file(index_dir + "/directFile", &c->error);
        if (!c->error.empty()) return c;
        ix.doc_lengths.resize(dl.size() / 4);
        std::memcpy(ix.doc_lengths.data(), dl.data(), dl.size());
        parse_term_tree(read_file(index_dir + "/frequentString", &c->error),
                        0, &ix.vocab);
        parse_term_tree(
            read_file(index_dir + "/infrequentString", &c->error),
            ix.frequent_count, &ix.vocab);
        if (!c->error.empty()) return c;
        idxs.push_back(std::move(ix));
    }
    std::sort(idxs.begin(), idxs.end(),
              [](const IdxData& a, const IdxData& b) {
                  return a.document_base < b.document_base;
              });
    for (size_t i = 1; i < idxs.size(); ++i) {
        if (idxs[i].document_base != idxs[i - 1].maximum_document) {
            c->error = "non-contiguous document ranges across indexes";
            return c;
        }
    }
    const int64_t document_base = idxs.front().document_base;
    const int64_t maximum_document = idxs.back().maximum_document;
    int64_t document_count = 0;
    for (const auto& ix : idxs)
        document_count +=
            static_cast<int64_t>(ix.doc_lengths.size());

    // Merged vocabulary.  Single index: the index's own terms/ids.
    // Multiple: merge by term string (cf/df summed), merged ids = 1-based
    // byte-order alphabetical ranks (matching data/indri.py).
    std::vector<TermEntry> vocab;
    if (idxs.size() == 1) {
        vocab = idxs[0].vocab;
    } else {
        std::unordered_map<std::string, size_t> merged_pos;
        for (const auto& ix : idxs) {
            for (const auto& e : ix.vocab) {
                auto it = merged_pos.find(e.term);
                if (it == merged_pos.end()) {
                    merged_pos.emplace(e.term, vocab.size());
                    vocab.push_back({e.term, 0, e.cf, e.df});
                } else {
                    vocab[it->second].cf += e.cf;
                    vocab[it->second].df += e.df;
                }
            }
        }
        std::sort(vocab.begin(), vocab.end(),
                  [](const TermEntry& a, const TermEntry& b) {
                      return a.term < b.term;
                  });
        std::unordered_map<std::string, int64_t> term_to_merged;
        for (size_t r = 0; r < vocab.size(); ++r) {
            vocab[r].term_id = static_cast<int64_t>(r) + 1;
            term_to_merged[vocab[r].term] = vocab[r].term_id;
        }
        for (auto& ix : idxs) {
            int64_t max_local = 0;
            for (const auto& e : ix.vocab)
                max_local = std::max(max_local, e.term_id);
            ix.local_to_merged.assign(max_local + 1, 0);
            for (const auto& e : ix.vocab)
                ix.local_to_merged[e.term_id] =
                    static_cast<int32_t>(term_to_merged[e.term]);
        }
    }

    auto owner = [&](int64_t docid) -> const IdxData& {
        size_t i = idxs.size() - 1;
        while (i > 0 && idxs[i].document_base > docid) --i;
        return idxs[i];
    };
    auto doc_length = [&](int64_t docid) -> uint32_t {
        const IdxData& ix = owner(docid);
        return ix.doc_lengths[docid - ix.document_base];
    };

    // Docno lookups.
    std::vector<std::pair<std::string, std::string>> fwd;
    parse_keyfile(read_file(repo + "/collection/forwardLookup0", &c->error),
                  &fwd);
    if (!c->error.empty()) return c;
    std::unordered_map<int64_t, std::string> docnos;
    std::unordered_map<std::string, int64_t> docno_to_id;
    for (auto& kv : fwd) {
        const int64_t docid = decode_docid_key(kv.first);
        docnos[docid] = kv.second;
        docno_to_id[kv.second] = docid;
    }

    // -- document selection (data_indri.cpp:652-733) -----------------------
    std::vector<int64_t> candidate_ids;
    int64_t wanted = document_count;
    const std::vector<std::string> doclist = load_lines(doclist_path);
    if (!doclist.empty()) {
        wanted = static_cast<int64_t>(doclist.size());
        for (const auto& d : doclist) {
            auto it = docno_to_id.find(d);
            if (it == docno_to_id.end()) {
                c->error = "unknown docno in document list: " + d;
                return c;
            }
            candidate_ids.push_back(it->second);
        }
    } else {
        for (int64_t d = document_base; d < maximum_document; ++d)
            candidate_ids.push_back(d);
    }
    if (doc_cutoff > 0) wanted = std::min<int64_t>(wanted, doc_cutoff);

    std::vector<int64_t> kept;
    for (int64_t d : candidate_ids) {
        if (static_cast<long>(kept.size()) >= wanted) break;
        if (static_cast<int>(doc_length(d)) >= window_size)
            kept.push_back(d);
    }

    // -- vocabulary (data_indri.cpp:735-869) --------------------------------
    // Lowercase to match the Python oracle (corpus.py lowercases blacklist
    // entries; index terms are already lowercase).  ASCII-only: multi-byte
    // UTF-8 code points pass through unchanged (Python's str.lower() would
    // also fold non-ASCII letters, but Indri's own normalizer leaves them
    // byte-raw in the index, so ASCII folding is the case that matters).
    auto blacklist_lines = load_lines(blacklist_path);
    std::unordered_set<std::string> blacklist;
    for (auto& line : blacklist_lines) {
        std::string lower;
        lower.reserve(line.size());
        for (char c : line) {
            lower.push_back(static_cast<char>(
                std::tolower(static_cast<unsigned char>(c))));
        }
        blacklist.insert(lower);
    }
    long max_df = static_cast<long>(max_df_raw);
    if (max_df_raw > 0.0 && max_df_raw <= 1.0)
        max_df = static_cast<long>(std::ceil(document_count * max_df_raw));

    struct Cand { int64_t cf, tid; const TermEntry* e; };
    std::vector<Cand> candidates;
    int64_t max_term_id = 0;
    for (const auto& e : vocab) {
        max_term_id = std::max(max_term_id, e.term_id);
        if (!include_digits && is_number(e.term)) continue;
        if (!blacklist.empty() && blacklist.count(e.term)) continue;
        if (min_df > 0 && e.df < min_df) continue;
        if (max_df > 0 && e.df > max_df) continue;
        candidates.push_back({e.cf, e.term_id, &e});
    }
    std::sort(candidates.begin(), candidates.end(),
              [](const Cand& a, const Cand& b) {
                  return a.cf != b.cf ? a.cf < b.cf : a.tid < b.tid;
              });
    if (max_vocab > 0 && static_cast<long>(candidates.size()) > max_vocab)
        candidates.erase(candidates.begin(), candidates.end() - max_vocab);

    // Decode the term list of one document (merged term-id space).
    auto term_list = [&](int64_t docid, std::vector<int64_t>* out) {
        out->clear();
        const IdxData& ix = owner(docid);
        const unsigned char* dbytes =
            reinterpret_cast<const unsigned char*>(ix.direct.data());
        size_t pos = ix.stats()[docid - ix.document_base].offset;
        const int64_t term_count = rvl_decode(dbytes, &pos);
        rvl_decode(dbytes, &pos);  // field count
        out->reserve(term_count);
        for (int64_t i = 0; i < term_count; ++i) {
            int64_t t = rvl_decode(dbytes, &pos);
            if (!ix.local_to_merged.empty()) {
                t = (t >= 0 &&
                     t < static_cast<int64_t>(ix.local_to_merged.size()))
                        ? ix.local_to_merged[t]
                        : 0;
            }
            out->push_back(t);
        }
    };

    // Subset frequency recount (data_indri.cpp:592-618).
    const bool subset =
        static_cast<int64_t>(kept.size()) != document_count;
    std::vector<int64_t> subset_cf;
    std::vector<int64_t> tl;
    if (subset) {
        subset_cf.assign(max_term_id + 1, 0);
        for (int64_t d : kept) {
            term_list(d, &tl);
            for (int64_t t : tl)
                if (t > 0) subset_cf[t] += 1;
        }
    }

    if (include_oov) {
        c->vocab_terms.push_back("");
        c->index_term_ids.push_back(0);
        c->term_freq.push_back(1);
    }
    std::vector<int32_t> indri_to_model(max_term_id + 1, -1);
    for (const auto& cand : candidates) {
        int64_t freq = cand.cf;
        if (subset) {
            freq = subset_cf[cand.tid];
            if (freq == 0) continue;  // data_indri.cpp:843-845
        }
        indri_to_model[cand.tid] =
            static_cast<int32_t>(c->vocab_terms.size());
        c->vocab_terms.push_back(cand.e->term);
        c->index_term_ids.push_back(cand.tid);
        c->term_freq.push_back(freq);
        c->total_terms += freq;
    }

    // -- token streams (generate_terms, data_indri.cpp:117-133) -------------
    c->offsets.push_back(0);
    for (int64_t d : kept) {
        term_list(d, &tl);
        for (int64_t t : tl) {
            const int32_t m = (t >= 0 && t <= max_term_id)
                                  ? indri_to_model[t]
                                  : -1;
            if (m >= 0) {
                c->tokens.push_back(m);
            } else if (include_oov) {
                c->tokens.push_back(0);
            }
        }
        c->offsets.push_back(static_cast<int64_t>(c->tokens.size()));
        c->index_lengths.push_back(doc_length(d));
        c->docnos.push_back(docnos[d]);
        c->index_doc_ids.push_back(d);
    }
    return c;
}

}  // extern "C"
