// Native WordPiece tokenizer — C++ counterpart of HuggingFace's Rust
// tokenizer used by the reference's language backbone
// (transf_models.py:13; SURVEY.md §2b "WordPiece tokenizer ... Rust").
//
// Fast path for ASCII text (virtually all COCO captions): lowercase,
// punctuation split, greedy-longest-match WordPiece against a hashed
// vocab. Non-ASCII inputs are rejected (return -1) so the caller falls
// back to the full-Unicode Python implementation — both paths produce
// identical output on ASCII (tested).
//
// Built by locov_torch/utils/native.py (g++ -O3 -shared -fPIC) into
// build/native/. The port's own copy of locov_tpu/native/wordpiece.cpp.
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int> vocab;
  int pad_id, unk_id, cls_id, sep_id;
  bool lowercase;
  int max_chars_per_word;
};

inline bool is_ascii_punct(char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

}  // namespace

extern "C" {

void* wp_create(const char** vocab, int n, int lowercase,
                int pad_id, int unk_id, int cls_id, int sep_id,
                int max_chars_per_word) {
  auto* t = new Tokenizer();
  t->vocab.reserve(n * 2);
  for (int i = 0; i < n; ++i) t->vocab.emplace(vocab[i], i);
  t->lowercase = lowercase != 0;
  t->pad_id = pad_id;
  t->unk_id = unk_id;
  t->cls_id = cls_id;
  t->sep_id = sep_id;
  t->max_chars_per_word = max_chars_per_word;
  return t;
}

void wp_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

// Encode one text into [CLS] ids [SEP] + padding.
// Returns 0 on success, -1 if the text contains non-ASCII bytes
// (caller must fall back to the Python tokenizer).
int wp_encode(void* h, const char* text, int max_len,
              int32_t* out_ids, int32_t* out_attn,
              int32_t* out_special) {
  auto* t = static_cast<Tokenizer*>(h);
  const size_t len = std::strlen(text);
  for (size_t i = 0; i < len; ++i)
    if (static_cast<unsigned char>(text[i]) > 127) return -1;

  // basic tokenize: clean, lowercase, split on space + punctuation
  std::vector<std::string> words;
  std::string cur;
  for (size_t i = 0; i < len; ++i) {
    char c = text[i];
    if (c == 0) continue;
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
        (static_cast<unsigned char>(c) < 32)) {
      if (!cur.empty()) { words.push_back(cur); cur.clear(); }
      continue;
    }
    if (t->lowercase && c >= 'A' && c <= 'Z') c += 32;
    if (is_ascii_punct(c)) {
      if (!cur.empty()) { words.push_back(cur); cur.clear(); }
      words.emplace_back(1, c);
      continue;
    }
    cur.push_back(c);
  }
  if (!cur.empty()) words.push_back(cur);

  // wordpiece greedy longest match
  std::vector<int> ids;
  ids.reserve(words.size() * 2);
  std::string sub;
  for (const auto& w : words) {
    if (static_cast<int>(w.size()) > t->max_chars_per_word) {
      ids.push_back(t->unk_id);
      continue;
    }
    size_t start = 0;
    std::vector<int> pieces;
    bool bad = false;
    while (start < w.size()) {
      size_t end = w.size();
      int found = -1;
      while (start < end) {
        sub.clear();
        if (start > 0) sub = "##";
        sub.append(w, start, end - start);
        auto it = t->vocab.find(sub);
        if (it != t->vocab.end()) { found = it->second; break; }
        --end;
      }
      if (found < 0) { bad = true; break; }
      pieces.push_back(found);
      start = end;
    }
    if (bad) ids.push_back(t->unk_id);
    else ids.insert(ids.end(), pieces.begin(), pieces.end());
  }

  // [CLS] ids[:max_len-2] [SEP], pad
  int n = static_cast<int>(ids.size());
  if (n > max_len - 2) n = max_len - 2;
  int pos = 0;
  out_ids[pos] = t->cls_id; out_attn[pos] = 1; out_special[pos] = 1;
  ++pos;
  for (int i = 0; i < n; ++i, ++pos) {
    out_ids[pos] = ids[i]; out_attn[pos] = 1; out_special[pos] = 0;
  }
  out_ids[pos] = t->sep_id; out_attn[pos] = 1; out_special[pos] = 1;
  ++pos;
  for (; pos < max_len; ++pos) {
    out_ids[pos] = t->pad_id; out_attn[pos] = 0; out_special[pos] = 1;
  }
  return 0;
}

}  // extern "C"
