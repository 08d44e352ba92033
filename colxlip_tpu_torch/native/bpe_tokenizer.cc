// Native CLIP byte-BPE tokenizer core (ASCII fast path).
//
// Host-side tokenization is on the pod-scale feed's critical path: the train
// pipeline tokenizes --num-sampled-captions (default 8) merged captions per
// sample (reference data.py:146-182 semantics), and at the 192k img/s design
// point (BASELINE) the Python BPE loop becomes a per-host CPU bottleneck.
// This core implements the exact published CLIP BPE algorithm
// (data/tokenizer.py, itself the open_clip SimpleTokenizer algorithm) for
// ASCII inputs; the Python wrapper routes any string containing non-ASCII
// bytes, '<' (special tokens) or '&' (HTML entities) through the reference
// Python path, so behavior is byte-identical end to end (pinned by
// tests/test_native_tokenizer.py against the Python tokenizer, including
// with a real-format merges table).
//
// Plain C ABI for ctypes (no pybind11 in this image):
//   cx_bpe_init(merges_utf8, len)        -> handle (>=0) or -1
//   cx_bpe_encode_batch(handle, texts, n, ctx, out_int32) -> 0 ok
//   cx_bpe_free(handle)
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

std::string utf8_of(int cp) {
  std::string s;
  if (cp < 0x80) {
    s.push_back(static_cast<char>(cp));
  } else {  // all code points used by bytes_to_unicode are < 0x800
    s.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    s.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
  return s;
}

// Port of the GPT-2/CLIP bytes_to_unicode(): byte value -> printable
// unicode symbol (as UTF-8), preserving the Python dict's insertion order
// in `order` (the vocab layout depends on it).
void bytes_to_unicode(std::vector<std::string>& sym_of_byte,
                      std::vector<int>& order) {
  std::vector<int> bs, cs;
  for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  cs = bs;
  bool in_bs[256] = {false};
  for (int b : bs) in_bs[b] = true;
  int n = 0;
  for (int b = 0; b < 256; ++b) {
    if (!in_bs[b]) {
      bs.push_back(b);
      cs.push_back(256 + n);
      ++n;
    }
  }
  sym_of_byte.assign(256, "");
  order = bs;
  for (size_t i = 0; i < bs.size(); ++i) sym_of_byte[bs[i]] = utf8_of(cs[i]);
}

struct Tokenizer {
  std::unordered_map<std::string, int32_t> encoder;
  std::unordered_map<std::string, int32_t> ranks;  // "first\x01second" -> rank
  // word cache shared across encode calls; guarded by cache_mu because
  // ctypes releases the GIL during cx_bpe_encode_batch and the wds pipeline
  // tokenizes from several worker threads on one handle.
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex cache_mu;
  std::vector<std::string> sym_of_byte;
  static constexpr int32_t kSot = 49406;
  static constexpr int32_t kEot = 49407;
  static constexpr size_t kCacheCap = 1 << 16;

  void build(const std::string& merges_blob) {
    std::vector<int> order;
    bytes_to_unicode(sym_of_byte, order);
    // vocab = byte symbols, then symbol+"</w>", then merge results, specials.
    // Assignment (not emplace): python builds the encoder as a dict
    // comprehension, so a duplicate vocab string keeps the LATEST id — a
    // merge result equal to an existing entry must shadow it identically.
    int32_t id = 0;
    for (int b : order) encoder[sym_of_byte[b]] = id++;
    for (int b : order) encoder[sym_of_byte[b] + "</w>"] = id++;
    size_t pos = 0;
    while (pos < merges_blob.size()) {
      size_t eol = merges_blob.find('\n', pos);
      if (eol == std::string::npos) eol = merges_blob.size();
      std::string line = merges_blob.substr(pos, eol - pos);
      pos = eol + 1;
      size_t sp = line.find(' ');
      if (sp == std::string::npos || line.empty()) continue;
      std::string first = line.substr(0, sp), second = line.substr(sp + 1);
      ranks.emplace(first + '\x01' + second,
                    static_cast<int32_t>(ranks.size()));
      encoder[first + second] = id++;
    }
    encoder["<|startoftext|>"] = kSot;
    encoder["<|endoftext|>"] = kEot;
  }

  // the greedy merge loop of SimpleTokenizer.bpe() on one pattern token
  // (ASCII bytes; per-byte == per-character symbols). Returns by VALUE:
  // a reference into `cache` could be invalidated by another thread's
  // capacity clear() between the lookup and the caller's read.
  std::vector<int32_t> bpe(const std::string& token) {
    {
      std::lock_guard<std::mutex> lock(cache_mu);
      auto hit = cache.find(token);
      if (hit != cache.end()) return hit->second;
    }
    std::vector<std::string> word;
    word.reserve(token.size());
    for (size_t i = 0; i + 1 < token.size(); ++i)
      word.emplace_back(1, token[i]);
    word.push_back(std::string(1, token.back()) + "</w>");

    if (!ranks.empty()) {
      while (word.size() > 1) {
        // lowest-rank adjacent pair
        int32_t best = INT32_MAX;
        size_t best_i = 0;
        for (size_t i = 0; i + 1 < word.size(); ++i) {
          auto it = ranks.find(word[i] + '\x01' + word[i + 1]);
          if (it != ranks.end() && it->second < best) {
            best = it->second;
            best_i = i;
          }
        }
        if (best == INT32_MAX) break;
        // merge EVERY occurrence of that pair left-to-right (python loop)
        const std::string first = word[best_i], second = word[best_i + 1];
        std::vector<std::string> merged;
        merged.reserve(word.size());
        size_t i = 0;
        while (i < word.size()) {
          if (i + 1 < word.size() && word[i] == first && word[i + 1] == second) {
            merged.push_back(first + second);
            i += 2;
          } else {
            merged.push_back(word[i]);
            ++i;
          }
        }
        word.swap(merged);
      }
    }
    std::vector<int32_t> ids;
    ids.reserve(word.size());
    for (const auto& w : word) ids.push_back(encoder.at(w));
    {
      std::lock_guard<std::mutex> lock(cache_mu);
      if (cache.size() >= kCacheCap) cache.clear();
      cache.emplace(token, ids);
    }
    return ids;
  }

  // clean + pattern-scan + BPE one text into ids (no SOT/EOT)
  void encode(const char* text, std::vector<int32_t>& out) {
    // whitespace_clean(basic_clean(x)).lower() for ASCII without '&'/'<':
    // collapse \s+ to single spaces, strip, lowercase
    std::string s;
    s.reserve(strlen(text));
    bool pending_space = false;
    for (const char* p = text; *p; ++p) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (c == ' ' || (c >= 0x09 && c <= 0x0D)) {
        if (!s.empty()) pending_space = true;
        continue;
      }
      if (pending_space) {
        s.push_back(' ');
        pending_space = false;
      }
      s.push_back(static_cast<char>(c >= 'A' && c <= 'Z' ? c + 32 : c));
    }
    auto is_letter = [](char c) { return c >= 'a' && c <= 'z'; };
    auto is_digit = [](char c) { return c >= '0' && c <= '9'; };
    size_t i = 0;
    std::string tok;
    while (i < s.size()) {
      char c = s[i];
      if (c == ' ') {
        ++i;
        continue;
      }
      tok.clear();
      if (c == '\'') {  // contraction alternatives, tried before the
                        // punctuation class exactly like the regex
        static const char* kContr[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
        for (const char* cand : kContr) {
          size_t len = strlen(cand);
          if (s.compare(i, len, cand) == 0) {
            // a contraction only matches if the next char is NOT a letter?
            // No: the regex has no lookahead — "'stop" matches "'s" then
            // "top". Plain prefix match is exact.
            tok.assign(cand);
            break;
          }
        }
      }
      if (tok.empty() && is_letter(c)) {
        size_t j = i;
        while (j < s.size() && is_letter(s[j])) ++j;
        tok = s.substr(i, j - i);
      } else if (tok.empty() && is_digit(c)) {
        tok.assign(1, c);  // [0-9]: one digit per token
      } else if (tok.empty()) {
        size_t j = i;
        while (j < s.size() && s[j] != ' ' && !is_letter(s[j]) &&
               !is_digit(s[j]) &&
               !(static_cast<unsigned char>(s[j]) >= 0x09 &&
                 static_cast<unsigned char>(s[j]) <= 0x0D))
          ++j;
        tok = s.substr(i, j - i);
      }
      i += tok.size();
      // ASCII printable bytes map to themselves under bytes_to_unicode,
      // so the byte-encoded token IS the token (eligibility guarantees
      // bytes in [0x20..0x7E]; space can't appear inside a token)
      const std::vector<int32_t> ids = bpe(tok);
      out.insert(out.end(), ids.begin(), ids.end());
    }
  }
};

std::mutex g_mu;
std::vector<Tokenizer*> g_handles;

}  // namespace

extern "C" {

int cx_bpe_init(const char* merges, size_t len) {
  Tokenizer* t = new (std::nothrow) Tokenizer();
  if (!t) return -1;
  t->build(std::string(merges, len));
  std::lock_guard<std::mutex> lock(g_mu);
  g_handles.push_back(t);
  return static_cast<int>(g_handles.size()) - 1;
}

int cx_bpe_encode_batch(int handle, const char** texts, int n, int ctx,
                        int32_t* out) {
  Tokenizer* t = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (handle < 0 || handle >= static_cast<int>(g_handles.size())) return -1;
    t = g_handles[handle];
  }
  if (!t) return -1;  // handle already freed
  std::vector<int32_t> ids;
  for (int r = 0; r < n; ++r) {
    ids.clear();
    ids.push_back(Tokenizer::kSot);
    t->encode(texts[r], ids);
    ids.push_back(Tokenizer::kEot);
    if (static_cast<int>(ids.size()) > ctx) {
      ids.resize(ctx);
      ids[ctx - 1] = Tokenizer::kEot;
    }
    int32_t* row = out + static_cast<size_t>(r) * ctx;
    memset(row, 0, sizeof(int32_t) * ctx);
    memcpy(row, ids.data(), sizeof(int32_t) * ids.size());
  }
  return 0;
}

void cx_bpe_free(int handle) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (handle >= 0 && handle < static_cast<int>(g_handles.size())) {
    delete g_handles[handle];
    g_handles[handle] = nullptr;
  }
}

}  // extern "C"
