// Shared packed-corpus container for the native ingestion backends
// (corpus.cpp: TRECTEXT; indri.cpp: Indri DiskIndex repositories).
// Accessor C API lives in corpus.cpp; builders fill this struct.
#ifndef CUNVSM_NATIVE_CORPUS_H_
#define CUNVSM_NATIVE_CORPUS_H_

#include <cstdint>
#include <string>
#include <vector>

struct Corpus {
    std::vector<int32_t> tokens;
    std::vector<int64_t> offsets;        // num_docs + 1
    std::vector<int64_t> index_lengths;  // tokenized length pre-vocab-filter
    std::vector<std::string> docnos;
    std::vector<std::string> vocab_terms;  // model id -> term ('' for OOV)
    std::vector<int64_t> term_freq;
    std::vector<int64_t> index_term_ids;
    // model doc id -> external index document id (empty when the corpus
    // wasn't built from an index).
    std::vector<int64_t> index_doc_ids;
    int64_t total_terms = 0;
    std::string error;
};

#endif  // CUNVSM_NATIVE_CORPUS_H_
