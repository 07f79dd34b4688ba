// chatterbox-tpu native runtime components (C++17, no external deps).
//
// The reference's native surface lives in external Rust/C++ crates
// (HF `tokenizers` BPE, `safetensors`, torchaudio I/O -- SURVEY.md §2.4).
// This library provides the host-side data plane: WAV decode/encode, the
// greedy-merge BPE text encoder, safetensors header scanning, and libm's
// fp32 sine over an array (the synthetic weights' sine on the CPU). The
// PyTorch port's own copy of native/csrc/chatterbox_native.cpp, loaded
// with ctypes by chatterbox_tpu_torch/native/loader.py; every entry point
// has a Python fallback, so the port works without a compiler.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

void cbx_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// WAV PCM decode/encode
// ---------------------------------------------------------------------------

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Decode a RIFF/WAVE byte buffer into mono float32 [-1, 1].
// Returns 0 on success. Caller frees *out with cbx_free.
int cbx_wav_decode(const uint8_t* data, size_t n, float** out, int32_t* sr,
                   size_t* n_samples) {
  if (n < 44 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0)
    return -1;
  size_t pos = 12;
  int channels = 0, bits = 0, fmt = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;
  while (pos + 8 <= n) {
    const uint8_t* hdr = data + pos;
    uint32_t sz = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + sz > n) sz = (uint32_t)(n - pos - 8);
    if (memcmp(hdr, "fmt ", 4) == 0 && sz >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      *sr = (int32_t)rd_u32(body + 4);
      bits = rd_u16(body + 14);
    } else if (memcmp(hdr, "data", 4) == 0) {
      pcm = body;
      pcm_len = sz;
    }
    pos += 8 + sz + (sz & 1);
  }
  if (!pcm || channels <= 0 || bits <= 0) return -2;
  if (fmt != 1 && fmt != 3) return -3;  // PCM or IEEE float only

  size_t bytes_per = (size_t)bits / 8;
  size_t frames = pcm_len / (bytes_per * channels);
  float* y = (float*)malloc(frames * sizeof(float));
  if (!y) return -4;
  for (size_t i = 0; i < frames; i++) {
    double acc = 0.0;
    for (int c = 0; c < channels; c++) {
      const uint8_t* s = pcm + (i * channels + c) * bytes_per;
      double v = 0.0;
      if (fmt == 3 && bits == 32) {
        float f;
        memcpy(&f, s, 4);
        v = f;
      } else if (bits == 16) {
        int16_t x = (int16_t)rd_u16(s);
        v = x / 32768.0;
      } else if (bits == 32) {
        int32_t x = (int32_t)rd_u32(s);
        v = x / 2147483648.0;
      } else if (bits == 24) {
        int32_t x = ((int32_t)s[0] | ((int32_t)s[1] << 8) | ((int32_t)s[2] << 16));
        if (x & 0x800000) x |= ~0xFFFFFF;
        v = x / 8388608.0;
      } else if (bits == 8) {
        v = ((int)s[0] - 128) / 128.0;
      } else {
        free(y);
        return -5;
      }
      acc += v;
    }
    y[i] = (float)(acc / channels);
  }
  *out = y;
  *n_samples = frames;
  return 0;
}

// Encode mono float32 as 16-bit PCM WAV. Caller frees *out with cbx_free.
int cbx_wav_encode_pcm16(const float* x, size_t n, int32_t sr, uint8_t** out,
                         size_t* out_n) {
  size_t data_len = n * 2;
  size_t total = 44 + data_len;
  uint8_t* buf = (uint8_t*)malloc(total);
  if (!buf) return -1;
  auto wr_u32 = [&](size_t at, uint32_t v) {
    buf[at] = v & 0xFF;
    buf[at + 1] = (v >> 8) & 0xFF;
    buf[at + 2] = (v >> 16) & 0xFF;
    buf[at + 3] = (v >> 24) & 0xFF;
  };
  auto wr_u16 = [&](size_t at, uint16_t v) {
    buf[at] = v & 0xFF;
    buf[at + 1] = (v >> 8) & 0xFF;
  };
  memcpy(buf, "RIFF", 4);
  wr_u32(4, (uint32_t)(36 + data_len));
  memcpy(buf + 8, "WAVEfmt ", 8);
  wr_u32(16, 16);
  wr_u16(20, 1);
  wr_u16(22, 1);
  wr_u32(24, (uint32_t)sr);
  wr_u32(28, (uint32_t)sr * 2);
  wr_u16(32, 2);
  wr_u16(34, 16);
  memcpy(buf + 36, "data", 4);
  wr_u32(40, (uint32_t)data_len);
  for (size_t i = 0; i < n; i++) {
    float v = x[i];
    v = v > 1.f ? 1.f : (v < -1.f ? -1.f : v);
    int16_t s = (int16_t)lrintf(v * 32767.f);
    wr_u16(44 + 2 * i, (uint16_t)s);
  }
  *out = buf;
  *out_n = total;
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy lowest-rank-merge BPE (HF tokenizers semantics for plain vocabs)
// ---------------------------------------------------------------------------

struct Bpe {
  std::unordered_map<std::string, int32_t> vocab;
  // merge rank keyed by "left\x01right"
  std::unordered_map<std::string, int32_t> ranks;
  std::vector<std::string> specials;  // sorted by length desc
  int32_t unk = -1;
};

// vocab_blob: n_tokens strings separated by '\n' (ids are 0..n implied by
// the ids array); merges_blob: n_merges lines "left right".
void* cbx_bpe_create(const char* vocab_blob, const int32_t* vocab_ids,
                     int32_t n_tokens, const char* merges_blob,
                     int32_t n_merges, const char* specials_blob,
                     int32_t n_specials, int32_t unk_id) {
  Bpe* b = new Bpe();
  b->unk = unk_id;
  const char* p = vocab_blob;
  for (int i = 0; i < n_tokens; i++) {
    const char* e = strchr(p, '\n');
    if (!e) e = p + strlen(p);
    b->vocab.emplace(std::string(p, e - p), vocab_ids[i]);
    p = (*e) ? e + 1 : e;
  }
  p = merges_blob;
  for (int i = 0; i < n_merges; i++) {
    const char* e = strchr(p, '\n');
    if (!e) e = p + strlen(p);
    std::string line(p, e - p);
    size_t sp = line.find(' ');
    if (sp != std::string::npos) {
      b->ranks.emplace(line.substr(0, sp) + '\x01' + line.substr(sp + 1), i);
    }
    p = (*e) ? e + 1 : e;
  }
  p = specials_blob;
  for (int i = 0; i < n_specials; i++) {
    const char* e = strchr(p, '\n');
    if (!e) e = p + strlen(p);
    b->specials.emplace_back(p, e - p);
    p = (*e) ? e + 1 : e;
  }
  std::sort(b->specials.begin(), b->specials.end(),
            [](const std::string& a, const std::string& c) { return a.size() > c.size(); });
  return b;
}

void cbx_bpe_destroy(void* h) { delete (Bpe*)h; }

static void bpe_word(const Bpe* b, const std::string& word,
                     std::vector<int32_t>& out) {
  // split into UTF-8 code points
  std::vector<std::string> pieces;
  for (size_t i = 0; i < word.size();) {
    size_t len = 1;
    unsigned char c = word[i];
    if ((c & 0xE0) == 0xC0) len = 2;
    else if ((c & 0xF0) == 0xE0) len = 3;
    else if ((c & 0xF8) == 0xF0) len = 4;
    pieces.push_back(word.substr(i, len));
    i += len;
  }
  while (pieces.size() > 1) {
    int best = -1;
    int32_t best_rank = std::numeric_limits<int32_t>::max();
    for (size_t i = 0; i + 1 < pieces.size(); i++) {
      auto it = b->ranks.find(pieces[i] + '\x01' + pieces[i + 1]);
      if (it != b->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best = (int)i;
      }
    }
    if (best < 0) break;
    pieces[best] += pieces[best + 1];
    pieces.erase(pieces.begin() + best + 1);
  }
  for (auto& piece : pieces) {
    auto it = b->vocab.find(piece);
    out.push_back(it != b->vocab.end() ? it->second : b->unk);
  }
}

// Encode text -> ids. Returns count written (or needed, if > out_cap).
int32_t cbx_bpe_encode(void* h, const char* text, int32_t* out, int32_t out_cap) {
  const Bpe* b = (const Bpe*)h;
  std::vector<int32_t> ids;
  std::string seg;
  std::string s(text);
  size_t i = 0;
  auto flush = [&]() {
    if (!seg.empty()) {
      bpe_word(b, seg, ids);
      seg.clear();
    }
  };
  while (i < s.size()) {
    bool matched = false;
    for (const auto& sp : b->specials) {
      if (s.compare(i, sp.size(), sp) == 0) {
        flush();
        auto it = b->vocab.find(sp);
        ids.push_back(it != b->vocab.end() ? it->second : b->unk);
        i += sp.size();
        matched = true;
        break;
      }
    }
    if (!matched) seg += s[i++];
  }
  flush();
  int32_t n = (int32_t)ids.size();
  if (n <= out_cap) memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

// ---------------------------------------------------------------------------
// safetensors header scan: returns the JSON header (caller frees) and the
// byte offset where tensor data starts.
// ---------------------------------------------------------------------------

int cbx_safetensors_header(const uint8_t* data, size_t n, char** json_out,
                           uint64_t* data_start) {
  if (n < 8) return -1;
  uint64_t hlen = 0;
  for (int i = 0; i < 8; i++) hlen |= ((uint64_t)data[i]) << (8 * i);
  if (8 + hlen > n) return -2;
  char* j = (char*)malloc(hlen + 1);
  if (!j) return -3;
  memcpy(j, data + 8, hlen);
  j[hlen] = 0;
  *json_out = j;
  *data_start = 8 + hlen;
  return 0;
}

// ---------------------------------------------------------------------------
// libm's sinf over an array: the function XLA's CPU code calls for an fp32
// sine, so runtime/fast_init.py's synthetic weights meet the JAX package's
// on the CPU element for element.
// ---------------------------------------------------------------------------

void cbx_sinf(const float* x, float* y, size_t n) {
  for (size_t i = 0; i < n; i++) y[i] = sinf(x[i]);
}

}  // extern "C"
