// Fast WordPiece tokenizer — the framework's native (C++) runtime
// component for input pipelines.
//
// Reference analog: PaddleNLP/paddle's fast_tokenizer C++ library and the
// faster_tokenizer op family: batch text -> padded id matrices without
// holding the Python GIL, so tokenization overlaps accelerator steps.
// Exposed through a plain C ABI consumed via ctypes (no pybind11
// dependency); built on demand by paddle_tpu_torch/text/fast_tokenizer.py.
//
// Algorithm: BERT basic tokenization (lowercase option, punctuation
// splitting, CJK isolation, whitespace) followed by greedy
// longest-match-first WordPiece with "##" continuation pieces.
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id = 0;
  int32_t cls_id = 0;
  int32_t sep_id = 0;
  int32_t pad_id = 0;
  bool lowercase = true;
  size_t max_word_chars = 100;
};

bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// split one text into basic tokens (ASCII-oriented; multi-byte UTF-8
// sequences pass through as word chars)
void basic_tokenize(const char* text, bool lowercase,
                    std::vector<std::string>* out) {
  std::string cur;
  for (const char* p = text; *p; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      if (!cur.empty()) { out->push_back(cur); cur.clear(); }
    } else if (is_punct(c)) {
      if (!cur.empty()) { out->push_back(cur); cur.clear(); }
      out->push_back(std::string(1, static_cast<char>(c)));
    } else {
      cur.push_back(lowercase && c >= 'A' && c <= 'Z'
                        ? static_cast<char>(c - 'A' + 'a')
                        : static_cast<char>(c));
    }
  }
  if (!cur.empty()) out->push_back(cur);
}

// greedy longest-match-first wordpiece for one basic token
void wordpiece(const Tokenizer& tk, const std::string& word,
               std::vector<int32_t>* ids) {
  if (word.size() > tk.max_word_chars) {
    ids->push_back(tk.unk_id);
    return;
  }
  std::vector<int32_t> pieces;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur_id = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = tk.vocab.find(sub);
      if (it != tk.vocab.end()) { cur_id = it->second; break; }
      --end;
    }
    if (cur_id < 0) {  // no piece matched: whole word is UNK
      ids->push_back(tk.unk_id);
      return;
    }
    pieces.push_back(cur_id);
    start = end;
  }
  ids->insert(ids->end(), pieces.begin(), pieces.end());
}

void encode_range(const Tokenizer* tk, const char* const* texts,
                  int64_t begin, int64_t endi, int32_t max_len,
                  int32_t* out_ids, int32_t* out_lens) {
  for (int64_t i = begin; i < endi; ++i) {
    std::vector<std::string> words;
    basic_tokenize(texts[i], tk->lowercase, &words);
    std::vector<int32_t> ids;
    ids.reserve(max_len);
    ids.push_back(tk->cls_id);
    for (const auto& w : words) {
      if (static_cast<int32_t>(ids.size()) >= max_len - 1) break;
      wordpiece(*tk, w, &ids);
    }
    if (static_cast<int32_t>(ids.size()) > max_len - 1)
      ids.resize(max_len - 1);
    ids.push_back(tk->sep_id);
    out_lens[i] = static_cast<int32_t>(ids.size());
    int32_t* row = out_ids + i * max_len;
    for (int32_t j = 0; j < max_len; ++j)
      row[j] = j < static_cast<int32_t>(ids.size()) ? ids[j] : tk->pad_id;
  }
}

}  // namespace

extern "C" {

// vocab_blob: '\n'-joined tokens, id = line index
void* ft_new(const char* vocab_blob, int32_t unk_id, int32_t cls_id,
             int32_t sep_id, int32_t pad_id, int32_t lowercase) {
  auto* tk = new Tokenizer();
  tk->unk_id = unk_id;
  tk->cls_id = cls_id;
  tk->sep_id = sep_id;
  tk->pad_id = pad_id;
  tk->lowercase = lowercase != 0;
  int32_t id = 0;
  const char* p = vocab_blob;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t n = nl ? static_cast<size_t>(nl - p) : strlen(p);
    tk->vocab.emplace(std::string(p, n), id++);
    if (!nl) break;
    p = nl + 1;
  }
  return tk;
}

void ft_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

int32_t ft_vocab_size(void* handle) {
  return static_cast<int32_t>(
      static_cast<Tokenizer*>(handle)->vocab.size());
}

// texts: array of n C strings; out_ids: [n, max_len] int32 (caller-
// allocated); out_lens: [n] int32.  n_threads <= 0 -> hardware count.
void ft_encode_batch(void* handle, const char* const* texts, int64_t n,
                     int32_t max_len, int32_t n_threads, int32_t* out_ids,
                     int32_t* out_lens) {
  if (n <= 0) return;
  const auto* tk = static_cast<Tokenizer*>(handle);
  // max_len < 2 would resize(max_len - 1) with a negative value, whose
  // size_t conversion throws length_error across the extern "C"/thread
  // boundary and aborts the process — reject defensively (the Python
  // wrapper also validates), pad-filling ids like the normal path
  if (max_len < 2) {
    for (int64_t i = 0; i < n; ++i) {
      out_lens[i] = 0;
      for (int32_t j = 0; j < max_len; ++j) out_ids[i * max_len + j] = tk->pad_id;
    }
    return;
  }
  int64_t workers = n_threads > 0
                        ? n_threads
                        : static_cast<int64_t>(
                              std::thread::hardware_concurrency());
  if (workers < 1) workers = 1;
  if (workers > n) workers = n;
  if (workers == 1) {
    encode_range(tk, texts, 0, n, max_len, out_ids, out_lens);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + workers - 1) / workers;
  for (int64_t w = 0; w < workers; ++w) {
    int64_t b = w * chunk;
    int64_t e = b + chunk < n ? b + chunk : n;
    if (b >= e) break;
    pool.emplace_back(encode_range, tk, texts, b, e, max_len, out_ids,
                      out_lens);
  }
  for (auto& t : pool) t.join();
}

}  // extern "C"
