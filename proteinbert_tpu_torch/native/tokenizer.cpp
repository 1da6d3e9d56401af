// Native host-side batch tokenizer (crop → LUT encode → sos/eos → pad),
// the port's copy of the JAX package's native/tokenizer.cpp.
//
// The per-batch host work feeding the card is per-row tokenization
// (proteinbert_tpu_torch/data/transforms.py, mirroring reference
// ProteinBERT/data_processing.py:159-180 which runs it in DataLoader
// workers). The host thread that feeds the card also launches its
// kernels, so the inner loop is done here in C++: one call tokenizes a
// whole batch from a concatenated byte buffer with zero per-row Python
// overhead.
//
// Contract (mirrors transforms.tokenize): row i holds
//   [SOS=1, lut[s[0]], ..., lut[s[len-1]], EOS=2, PAD=0...]
// with sequences longer than seq_len-2 cropped to a COUNTER-BASED window
// when do_crop — start = splitmix64(seed + row_ids[i]) % span, the same
// formula transforms.crop_starts computes in numpy, so the two paths
// produce bit-identical batches and a row's window depends only on
// (seed, global row id), never on batch composition or RNG state (the
// byte-deterministic-resume scheme) — else
// head-truncated.
//
// The 256-entry LUT is passed in from Python (data/vocab.py stays the
// single source of truth for the id space).

#include <cstdint>

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

extern "C" {

void pbt_tokenize_batch(const uint8_t* bytes, const int64_t* offsets,
                        int64_t n, int64_t seq_len, const int32_t* lut,
                        uint64_t seed, int32_t do_crop,
                        const int64_t* row_ids, int32_t* out) {
  const int64_t cap = seq_len - 2;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = bytes + offsets[i];
    int64_t len = offsets[i + 1] - offsets[i];
    int64_t start = 0;
    if (len > cap) {
      if (do_crop) {
        uint64_t r = splitmix64(seed + static_cast<uint64_t>(row_ids[i]));
        start = static_cast<int64_t>(r % static_cast<uint64_t>(len - cap + 1));
      }
      len = cap;
    }
    int32_t* row = out + i * seq_len;
    row[0] = 1;  // <sos>
    int64_t j = 0;
    for (; j < len; ++j) row[1 + j] = lut[s[start + j]];
    row[1 + len] = 2;  // <eos>
    for (j = len + 2; j < seq_len; ++j) row[j] = 0;  // <pad>
  }
}

int32_t pbt_abi_version(void) { return 2; }

}  // extern "C"
