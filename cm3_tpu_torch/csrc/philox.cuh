// Philox4x32-10 (Salmon et al., SC 2011; the constants of Random123),
// the twin of cm3_tpu_torch/ops/philox.py: the same (counter, key) gives
// the same four 32-bit words in a kernel thread and in plain PyTorch.
#pragma once
#include <cstdint>

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return Philox4{{c0, c1, c2, c3}};
}
