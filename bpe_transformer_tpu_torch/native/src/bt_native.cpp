// Native tokenization engine of the port: GPT-2 pre-tokenization and the BPE
// encode, count and merge hot loops behind a C ABI that
// bpe_transformer_tpu_torch/native/engine.py drives through ctypes.
//
// Provenance: a copy of the JAX package's bpe_transformer_tpu/native/src/
// bt_native.cpp (host code, no device code), kept here so that the port
// builds and loads it without importing that package.  Only this header
// comment differs; the C ABI and every loop are the same, so both engines
// give the same pre-tokens, counts, merges and ids.
//
// The scanner is a hand-rolled implementation of the GPT-2 pre-tokenization
// regex ('(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|
// \s+(?!\S)|\s+) over UTF-8, with Unicode class membership taken from the
// range tables of unicode_classes.inc, which native/gen_unicode_tables.py
// writes from the port's own tokenization/unicode_classes.py (the tables of
// the `regex` module's classes), so the C++ and Python paths classify every
// codepoint identically.
//
// The BPE loop applies the lowest-rank adjacent merge (earliest position on
// ties) per pre-token: the greedy order of the Python path's compiled rank
// table.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct CpRange {
  uint32_t lo;
  uint32_t hi;
};

#include "unicode_classes.inc"

inline bool in_ranges(uint32_t cp, const CpRange* ranges, int n) {
  int lo = 0, hi = n - 1;
  while (lo <= hi) {
    int mid = (lo + hi) >> 1;
    if (cp < ranges[mid].lo) {
      hi = mid - 1;
    } else if (cp > ranges[mid].hi) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}

enum CharClass : uint8_t { CC_OTHER = 0, CC_LETTER = 1, CC_NUMBER = 2, CC_SPACE = 3 };

// Direct-lookup table for the first 0x300 codepoints (covers ASCII +
// Latin-1/Latin-Extended, i.e. nearly all real text); binary search beyond.
struct AsciiTable {
  uint8_t cls[0x300];
  AsciiTable() {
    for (uint32_t cp = 0; cp < 0x300; ++cp) {
      if (in_ranges(cp, kSpaceRanges, kSpaceRanges_len)) {
        cls[cp] = CC_SPACE;
      } else if (in_ranges(cp, kLetterRanges, kLetterRanges_len)) {
        cls[cp] = CC_LETTER;
      } else if (in_ranges(cp, kNumberRanges, kNumberRanges_len)) {
        cls[cp] = CC_NUMBER;
      } else {
        cls[cp] = CC_OTHER;
      }
    }
  }
};
const AsciiTable kTable;

inline CharClass classify(uint32_t cp) {
  if (cp < 0x300) return static_cast<CharClass>(kTable.cls[cp]);
  if (in_ranges(cp, kLetterRanges, kLetterRanges_len)) return CC_LETTER;
  if (in_ranges(cp, kNumberRanges, kNumberRanges_len)) return CC_NUMBER;
  if (in_ranges(cp, kSpaceRanges, kSpaceRanges_len)) return CC_SPACE;
  return CC_OTHER;
}

// Decode one UTF-8 codepoint at p (p < end guaranteed).  Input comes from
// Python str.encode("utf-8") and is always valid; malformed bytes are
// defensively treated as single-byte CC_OTHER codepoints.
inline uint32_t decode_utf8(const uint8_t* p, const uint8_t* end, int* len) {
  uint8_t b0 = p[0];
  if (b0 < 0x80) {
    *len = 1;
    return b0;
  }
  if ((b0 & 0xE0) == 0xC0 && p + 1 < end) {
    *len = 2;
    return ((b0 & 0x1Fu) << 6) | (p[1] & 0x3Fu);
  }
  if ((b0 & 0xF0) == 0xE0 && p + 2 < end) {
    *len = 3;
    return ((b0 & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) | (p[2] & 0x3Fu);
  }
  if ((b0 & 0xF8) == 0xF0 && p + 3 < end) {
    *len = 4;
    return ((b0 & 0x07u) << 18) | ((p[1] & 0x3Fu) << 12) | ((p[2] & 0x3Fu) << 6) |
           (p[3] & 0x3Fu);
  }
  *len = 1;
  return 0xFFFFFFFFu;  // classify() returns CC_OTHER
}

inline CharClass class_at(const uint8_t* p, const uint8_t* end, int* len) {
  uint32_t cp = decode_utf8(p, end, len);
  return cp == 0xFFFFFFFFu ? CC_OTHER : classify(cp);
}

// Consume a maximal run of codepoints of class `want` starting at p.
inline const uint8_t* consume_class(const uint8_t* p, const uint8_t* end,
                                    CharClass want) {
  while (p < end) {
    int len;
    if (class_at(p, end, &len) != want) break;
    p += len;
  }
  return p;
}

// One GPT-2 pre-token starting at byte offset `i`; returns its end offset.
// Implements the regex alternation in order, with the alternatives' greedy /
// backtracking semantics resolved statically (see scanner notes above).
size_t next_pretoken_end(const uint8_t* s, size_t n, size_t i) {
  const uint8_t* end = s + n;

  // Alt 1: '(?:[sdmt]|ll|ve|re)  — lowercase ASCII only, class before pairs.
  if (s[i] == '\'') {
    if (i + 1 < n) {
      uint8_t c = s[i + 1];
      if (c == 's' || c == 'd' || c == 'm' || c == 't') return i + 2;
      if (i + 2 < n) {
        uint8_t c2 = s[i + 2];
        if ((c == 'l' && c2 == 'l') || (c == 'v' && c2 == 'e') ||
            (c == 'r' && c2 == 'e'))
          return i + 3;
      }
    }
  }

  // Alts 2-4: " ?" + a maximal run of letters / numbers / other.  The
  // optional-space branch only survives regex backtracking when a run of the
  // right class actually follows the space.
  size_t j = i;
  if (s[i] == ' ') j = i + 1;
  if (j < n) {
    int len;
    CharClass cc = class_at(s + j, end, &len);
    if (cc != CC_SPACE) {
      const uint8_t* run_end = consume_class(s + j + len, end, cc);
      return static_cast<size_t>(run_end - s);
    }
  }

  // Alts 5-6: whitespace.  \s+(?!\S) keeps the full run at end-of-input,
  // otherwise leaves the final whitespace codepoint for the next token; a
  // single whitespace codepoint followed by non-space falls through to \s+.
  size_t k = i;
  size_t last_ws_start = i;
  int n_ws = 0;
  while (k < n) {
    int len;
    if (class_at(s + k, end, &len) != CC_SPACE) break;
    last_ws_start = k;
    k += len;
    ++n_ws;
  }
  if (n_ws == 0) {
    // Defensive: cannot happen (every class falls in an alternative above).
    return i + 1;
  }
  if (k == n) return k;          // \s+(?!\S): run extends to end of input
  if (n_ws >= 2) return last_ws_start;  // leave last ws codepoint
  return k;                       // \s+ on a single whitespace codepoint
}

// ------------------------------------------------------------------ BPE

// Open-addressing hash map: (left_id, right_id) -> (rank, merged_id).
struct PairMap {
  std::vector<uint64_t> keys;
  std::vector<uint64_t> vals;  // rank << 32 | merged_id
  uint64_t mask = 0;

  static constexpr uint64_t kEmpty = ~0ull;

  void build(int64_t n, const int32_t* lefts, const int32_t* rights,
             const int32_t* ranks, const int32_t* merged) {
    size_t cap = 16;
    while (cap < static_cast<size_t>(n) * 2) cap <<= 1;
    keys.assign(cap, kEmpty);
    vals.assign(cap, 0);
    mask = cap - 1;
    for (int64_t idx = 0; idx < n; ++idx) {
      uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>(lefts[idx])) << 32) |
                     static_cast<uint32_t>(rights[idx]);
      uint64_t slot = hash(key) & mask;
      while (keys[slot] != kEmpty) {
        if (keys[slot] == key) goto next;  // first (lowest-rank) entry wins
        slot = (slot + 1) & mask;
      }
      keys[slot] = key;
      vals[slot] = (static_cast<uint64_t>(static_cast<uint32_t>(ranks[idx])) << 32) |
                   static_cast<uint32_t>(merged[idx]);
    next:;
    }
  }

  static inline uint64_t hash(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    return x;
  }

  // Returns rank<<32|merged, or kEmpty when absent.
  inline uint64_t find(int32_t l, int32_t r) const {
    uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>(l)) << 32) |
                   static_cast<uint32_t>(r);
    uint64_t slot = hash(key) & mask;
    while (true) {
      uint64_t k = keys[slot];
      if (k == key) return vals[slot];
      if (k == kEmpty) return kEmpty;
      slot = (slot + 1) & mask;
    }
  }
};

struct Engine {
  int32_t byte_ids[256];
  PairMap pairs;
};

// Merge `len` ids in place; returns the merged length.  Applies the
// lowest-rank adjacent pair first, earliest position breaking ties —
// identical greedy order to BPETokenizer._encode_pretoken.
inline int merge_ids(const Engine* e, int32_t* ids, int len) {
  while (len > 1) {
    uint64_t best = PairMap::kEmpty;
    int best_pos = -1;
    for (int i = 0; i < len - 1; ++i) {
      uint64_t hit = e->pairs.find(ids[i], ids[i + 1]);
      if (hit < best) {
        best = hit;
        best_pos = i;
      }
    }
    if (best_pos < 0) break;
    ids[best_pos] = static_cast<int32_t>(best & 0xFFFFFFFFu);
    std::memmove(ids + best_pos + 1, ids + best_pos + 2,
                 static_cast<size_t>(len - best_pos - 2) * sizeof(int32_t));
    --len;
  }
  return len;
}

// ------------------------------------------------------------- BPE trainer

// Greedy BPE merge loop with the reference's exact selection semantics
// (mirrors tokenization/trainer.py): highest total pair count wins, ties
// broken toward the lexicographically GREATER (bytes, bytes) pair; within a
// word, occurrences merge leftmost-first without overlap; a merge is only
// recorded if it applied somewhere; heap entries are lazily invalidated by a
// count check at pop time.  Vocab entries are immutable once assigned, so
// comparing via the current vocab table equals capture-at-push semantics.

struct TrainerHeapEntry {
  int64_t count;
  int32_t a, b;
};

inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

struct TrainerHeapCompare {
  const std::vector<std::string>* vocab;
  // priority_queue pops the LARGEST element; "larger" = higher count, then
  // lexicographically greater (bytes_a, bytes_b).
  bool operator()(const TrainerHeapEntry& x, const TrainerHeapEntry& y) const {
    if (x.count != y.count) return x.count < y.count;
    const std::string& xa = (*vocab)[static_cast<size_t>(x.a)];
    const std::string& ya = (*vocab)[static_cast<size_t>(y.a)];
    if (xa != ya) return xa < ya;
    return (*vocab)[static_cast<size_t>(x.b)] < (*vocab)[static_cast<size_t>(y.b)];
  }
};

// Core merge loop shared by bt_train_bpe and the fused counter->train entry.
int64_t train_bpe_impl(std::vector<std::vector<int32_t>>& words,
                       const std::vector<int64_t>& word_counts,
                       std::vector<std::string>& vocab, int64_t target_vocab,
                       int32_t* out_pairs, int64_t out_cap) {
  int64_t n_words = static_cast<int64_t>(words.size());
  std::unordered_map<uint64_t, int64_t> pair_counts;
  // Pair -> word indices that may contain it.  Entries can go stale (the
  // word was rewritten); they are filtered by the rewrite scan, and count
  // bookkeeping stays exact because counts update only on actual rewrites.
  std::unordered_map<uint64_t, std::vector<int32_t>> pair_words;
  pair_counts.reserve(static_cast<size_t>(n_words) * 2);
  pair_words.reserve(static_cast<size_t>(n_words) * 2);

  for (int64_t w = 0; w < n_words; ++w) {
    const auto& word = words[static_cast<size_t>(w)];
    int64_t c = word_counts[w];
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      uint64_t key = pair_key(word[i], word[i + 1]);
      auto [it, inserted] = pair_counts.try_emplace(key, 0);
      it->second += c;
      auto& vec = pair_words[key];
      if (vec.empty() || vec.back() != static_cast<int32_t>(w)) {
        vec.push_back(static_cast<int32_t>(w));
      }
    }
  }

  TrainerHeapCompare cmp{&vocab};
  std::priority_queue<TrainerHeapEntry, std::vector<TrainerHeapEntry>,
                      TrainerHeapCompare>
      heap(cmp);
  for (const auto& [key, count] : pair_counts) {
    heap.push({count, static_cast<int32_t>(key >> 32),
               static_cast<int32_t>(key & 0xFFFFFFFFu)});
  }

  int64_t n_merges = 0;
  std::vector<int32_t> rewritten;
  std::vector<uint64_t> touched;
  while (static_cast<int64_t>(vocab.size()) < target_vocab && !heap.empty()) {
    TrainerHeapEntry top = heap.top();
    heap.pop();
    uint64_t key = pair_key(top.a, top.b);
    auto cit = pair_counts.find(key);
    int64_t current = (cit == pair_counts.end()) ? 0 : cit->second;
    if (current != top.count || current <= 0) continue;  // stale entry

    auto mit = pair_words.find(key);
    if (mit == pair_words.end() || mit->second.empty()) continue;
    // The member list is consumed: rewritten words no longer contain the
    // pair (new adjacencies always involve the fresh id, so a merged pair
    // of old ids can never re-form), and stale indices are filtered below.
    std::vector<int32_t> members;
    members.swap(mit->second);

    int32_t z = static_cast<int32_t>(vocab.size());
    bool merged_any = false;
    touched.clear();

    for (int32_t idx : members) {
      auto& word = words[static_cast<size_t>(idx)];
      size_t n = word.size();
      // Leftmost non-overlapping scan; skip words without the pair.
      rewritten.clear();
      bool hit = false;
      size_t i = 0;
      while (i + 1 < n) {
        if (word[i] == top.a && word[i + 1] == top.b) {
          rewritten.push_back(z);
          i += 2;
          hit = true;
        } else {
          rewritten.push_back(word[i]);
          ++i;
        }
      }
      if (!hit) continue;
      if (i == n - 1) rewritten.push_back(word[n - 1]);
      merged_any = true;
      int64_t c = word_counts[idx];
      for (size_t j = 0; j + 1 < n; ++j) {
        uint64_t p = pair_key(word[j], word[j + 1]);
        pair_counts[p] -= c;
        touched.push_back(p);
      }
      for (size_t j = 0; j + 1 < rewritten.size(); ++j) {
        uint64_t p = pair_key(rewritten[j], rewritten[j + 1]);
        pair_counts[p] += c;
        auto& vec = pair_words[p];
        if (vec.empty() || vec.back() != idx) vec.push_back(idx);
        touched.push_back(p);
      }
      word.assign(rewritten.begin(), rewritten.end());
    }

    if (!merged_any) continue;

    if (n_merges < out_cap) {
      out_pairs[2 * n_merges] = top.a;
      out_pairs[2 * n_merges + 1] = top.b;
    }
    ++n_merges;
    vocab.push_back(vocab[static_cast<size_t>(top.a)] +
                    vocab[static_cast<size_t>(top.b)]);

    for (uint64_t p : touched) {
      auto it = pair_counts.find(p);
      if (it != pair_counts.end() && it->second > 0) {
        heap.push({it->second, static_cast<int32_t>(p >> 32),
                   static_cast<int32_t>(p & 0xFFFFFFFFu)});
      }
    }
  }

  return n_merges <= out_cap ? n_merges : -n_merges;
}

// Streaming pre-token counter (training mode: caller strips specials).
struct PretokenCounter {
  std::unordered_map<std::string, int64_t> counts;
};

}  // namespace

extern "C" {

#define BT_EXPORT __attribute__((visibility("default")))

BT_EXPORT Engine* bt_engine_new(const int32_t* byte_ids, int64_t n_merges,
                      const int32_t* lefts, const int32_t* rights,
                      const int32_t* ranks, const int32_t* merged) {
  Engine* e = new Engine();
  std::memcpy(e->byte_ids, byte_ids, 256 * sizeof(int32_t));
  e->pairs.build(n_merges, lefts, rights, ranks, merged);
  return e;
}

BT_EXPORT void bt_engine_free(Engine* e) { delete e; }

// Pre-tokenize only: writes (start, end) byte-offset pairs.  Returns the
// number of pre-tokens, or -(required_pairs) when out_cap is too small.
BT_EXPORT int64_t bt_pretokenize(const uint8_t* text, int64_t n, int64_t* out_offsets,
                       int64_t out_cap) {
  int64_t count = 0;
  size_t i = 0;
  size_t len = static_cast<size_t>(n);
  while (i < len) {
    size_t end = next_pretoken_end(text, len, i);
    if (count < out_cap) {
      out_offsets[2 * count] = static_cast<int64_t>(i);
      out_offsets[2 * count + 1] = static_cast<int64_t>(end);
    }
    ++count;
    i = end;
  }
  return count <= out_cap ? count : -count;
}

// Fused pre-tokenize + BPE encode of a specials-free UTF-8 part.  Writes
// token ids to `out` (capacity `out_cap`; n input bytes always suffice).
// Returns the number of ids, or -(required) when out_cap is too small.
BT_EXPORT int64_t bt_encode(const Engine* e, const uint8_t* text, int64_t n, int32_t* out,
                  int64_t out_cap) {
  int64_t n_out = 0;
  size_t i = 0;
  size_t len = static_cast<size_t>(n);
  std::vector<int32_t> big;  // spill for pathological pre-tokens
  int32_t buf[256];
  while (i < len) {
    size_t end = next_pretoken_end(text, len, i);
    size_t n_bytes = end - i;
    int32_t* ids = buf;
    if (n_bytes > 256) {
      big.resize(n_bytes);
      ids = big.data();
    }
    int m = 0;
    for (size_t b = i; b < end; ++b) {
      int32_t id = e->byte_ids[text[b]];
      if (id >= 0) ids[m++] = id;  // bytes absent from the vocab are skipped
    }
    m = merge_ids(e, ids, m);
    if (n_out + m <= out_cap) {
      std::memcpy(out + n_out, ids, static_cast<size_t>(m) * sizeof(int32_t));
    }
    n_out += m;
    i = end;
  }
  return n_out <= out_cap ? n_out : -n_out;
}

// Learn BPE merges.  Inputs: the distinct-word table (flattened ids +
// offsets + multiplicities) and the initial vocab byte strings (flattened +
// offsets; ids 0..n_vocab-1).  Writes (a, b) id pairs of the ordered merge
// list into out_pairs (2 int32 per merge).  Returns the number of merges,
// or -(required) if out_cap (in pairs) is too small.
BT_EXPORT int64_t bt_train_bpe(
    const int32_t* word_data, const int64_t* word_offsets, int64_t n_words,
    const int64_t* word_counts, const uint8_t* vocab_data,
    const int64_t* vocab_offsets, int64_t n_vocab, int64_t target_vocab,
    int32_t* out_pairs, int64_t out_cap) {
  std::vector<std::string> vocab;
  vocab.reserve(static_cast<size_t>(target_vocab));
  for (int64_t i = 0; i < n_vocab; ++i) {
    vocab.emplace_back(
        reinterpret_cast<const char*>(vocab_data + vocab_offsets[i]),
        static_cast<size_t>(vocab_offsets[i + 1] - vocab_offsets[i]));
  }
  std::vector<std::vector<int32_t>> words(static_cast<size_t>(n_words));
  for (int64_t w = 0; w < n_words; ++w) {
    words[static_cast<size_t>(w)].assign(word_data + word_offsets[w],
                                         word_data + word_offsets[w + 1]);
  }
  std::vector<int64_t> counts(word_counts, word_counts + n_words);
  return train_bpe_impl(words, counts, vocab, target_vocab, out_pairs, out_cap);
}

// ---------------------------------------------- streaming pre-token counter

BT_EXPORT PretokenCounter* bt_counter_new() { return new PretokenCounter(); }

BT_EXPORT void bt_counter_free(PretokenCounter* c) { delete c; }

// Pre-tokenize a specials-free UTF-8 part and accumulate counts.
BT_EXPORT void bt_counter_add(PretokenCounter* c, const uint8_t* text,
                              int64_t n) {
  size_t i = 0;
  size_t len = static_cast<size_t>(n);
  auto& counts = c->counts;
  while (i < len) {
    size_t end = next_pretoken_end(text, len, i);
    counts[std::string(reinterpret_cast<const char*>(text + i), end - i)] += 1;
    i = end;
  }
}

// Streaming variant: count every pre-token that ends strictly BEFORE the end
// of the buffer (the final token may extend — or have its whitespace
// lookahead change — once more input arrives).  Returns bytes consumed; the
// caller re-feeds the unconsumed tail prepended to the next chunk.
BT_EXPORT int64_t bt_counter_add_prefix(PretokenCounter* c, const uint8_t* text,
                                        int64_t n) {
  size_t len = static_cast<size_t>(n);
  // A trailing incomplete UTF-8 sequence (chunk cut mid-codepoint) must stay
  // in the tail, or the truncated lead byte would misclassify as CC_OTHER
  // and falsely terminate the preceding run.
  for (size_t back = 1; back <= 3 && back <= len; ++back) {
    uint8_t b = text[len - back];
    if (b < 0x80) break;              // ASCII: sequence complete
    if ((b & 0xC0) == 0xC0) {         // lead byte of a multi-byte sequence
      size_t need = (b & 0xE0) == 0xC0   ? 2
                    : (b & 0xF0) == 0xE0 ? 3
                    : (b & 0xF8) == 0xF0 ? 4
                                         : 1;
      if (back < need) len -= back;   // incomplete: exclude from this pass
      break;
    }
    // else: continuation byte, keep scanning backwards for the lead
  }
  size_t i = 0;
  auto& counts = c->counts;
  while (i < len) {
    size_t end = next_pretoken_end(text, len, i);
    // A token is only final when its full lookahead context is present:
    // runs/whitespace need the next codepoint (<= 4 bytes) and the
    // contraction alternative peeks 2 chars past the apostrophe — e.g.
    // "we'l|l go" cut after the first 'l' would otherwise emit "'" + "ll"
    // instead of "'ll".  Hold back anything ending within 4 bytes of the
    // buffer end.
    if (end + 4 > len) break;
    counts[std::string(reinterpret_cast<const char*>(text + i), end - i)] += 1;
    i = end;
  }
  return static_cast<int64_t>(i);
}

BT_EXPORT void bt_counter_stats(const PretokenCounter* c, int64_t* n_items,
                                int64_t* total_bytes) {
  *n_items = static_cast<int64_t>(c->counts.size());
  int64_t bytes = 0;
  for (const auto& [word, count] : c->counts) {
    bytes += static_cast<int64_t>(word.size());
  }
  *total_bytes = bytes;
}

// Export (string, count) items; buffers must be sized per bt_counter_stats
// (offsets has n_items + 1 slots).  Returns the number of items.
BT_EXPORT int64_t bt_counter_items(const PretokenCounter* c, uint8_t* str_data,
                                   int64_t* offsets, int64_t* counts) {
  int64_t idx = 0;
  int64_t pos = 0;
  for (const auto& [word, count] : c->counts) {
    offsets[idx] = pos;
    std::memcpy(str_data + pos, word.data(), word.size());
    pos += static_cast<int64_t>(word.size());
    counts[idx] = count;
    ++idx;
  }
  offsets[idx] = pos;
  return idx;
}

// Fused path: learn merges straight from an accumulated counter, never
// materializing the word table on the Python side.  Words with < 2 bytes
// cannot merge and are skipped; initial word ids are the raw byte values
// (base vocab ids 0..255 are always the single bytes).
BT_EXPORT int64_t bt_train_bpe_from_counter(
    PretokenCounter* c, const uint8_t* vocab_data, const int64_t* vocab_offsets,
    int64_t n_vocab, int64_t target_vocab, int32_t* out_pairs,
    int64_t out_cap) {
  std::vector<std::string> vocab;
  vocab.reserve(static_cast<size_t>(target_vocab));
  for (int64_t i = 0; i < n_vocab; ++i) {
    vocab.emplace_back(
        reinterpret_cast<const char*>(vocab_data + vocab_offsets[i]),
        static_cast<size_t>(vocab_offsets[i + 1] - vocab_offsets[i]));
  }
  std::vector<std::vector<int32_t>> words;
  std::vector<int64_t> counts;
  words.reserve(c->counts.size());
  counts.reserve(c->counts.size());
  for (const auto& [word, count] : c->counts) {
    if (word.size() < 2) continue;
    std::vector<int32_t> ids(word.size());
    for (size_t i = 0; i < word.size(); ++i) {
      ids[i] = static_cast<uint8_t>(word[i]);
    }
    words.push_back(std::move(ids));
    counts.push_back(count);
  }
  return train_bpe_impl(words, counts, vocab, target_vocab, out_pairs, out_cap);
}

}  // extern "C"
