// zk_coefficients: the zero-knowledge randomizer's coefficients in one launch.
//
// Replaces, on the card, the plain route of utils/threefry.py
// `zk_coefficients_plain` (the JAX package draws the same values with
// jax.random.bits and the field ops of field_jnp, iop/stark.py `_zk_codeword`):
// 16 rows of threefry2x32 words, each masked to a 16-bit digit, paired into
// eight 32-bit words, canonicalised, lifted to Montgomery form. There, every
// step is an int64 torch pass over the whole (16, m) draw: ~190 launches,
// each moving 16 x 8 B a coefficient.
//
// Bound on an H100: OPERATIONS. A coefficient costs 16 threefry2x32 blocks of
// ~80 32-bit operations (20 rounds of add, rotate, xor; 5 key injections of
// two adds; the counter and the output xor), two Montgomery products, an add
// and two conditional subtracts: ~1450 operations against 16 B written (24
// with an index read), 0.7 ms at m = 2^24 at 33.5e12 operations/s.
//
// Design. One thread a coefficient (column c of the draw), everything in
// registers. Row r of the draw encrypts the 64-bit flat counter r * n + c,
// split into its (high, low) words (x0, x1), under the key (k0, k1); its word
// is x0 ^ x1 of the cipher, and its digit the low 16 bits. The high word is
// not zero once r * n + c >= 2^32 (n > 2^28). Word k of the eight is
// d[2k] | d[2k+1] << 16 (one byte permute); lo = words 0..3, hi = words
// 4..7, each < 2^128 and canonicalised by one conditional subtract, as
// `add(x, 0)` does. The coefficient X = hi * 2^128 + lo mod p in Montgomery
// form is mont_mul(add(mont_mul(hi, R^2), lo), R^2): multiplying by 2^128 is
// the Montgomery lift. The columns are a contiguous run (`start`, `cols`
// null) or an int64 index list (`cols`, e.g. the cyclic indices a process of
// a group holds); the output is four planes at `out_stride`, so a view such
// as coeffs[:, a:b] can be written in place.
#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;  // threefry's key-schedule constant

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int rot) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, rot) ^ x0;
}

// One threefry2x32 block (20 rounds) of the counter (x0, x1) under the key
// schedule ks = (k0, k1, k0 ^ k1 ^ kParity); returns the xor of its words.
__device__ __forceinline__ uint32_t threefry_xor(const uint32_t (&ks)[3], uint32_t x0, uint32_t x1) {
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
    } else {
      mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

__global__ void __launch_bounds__(kThreads)
zk_coefficients_kernel(uint32_t k0, uint32_t k1, unsigned long long n, long start,
                       const long* cols, long m, uint32_t* out, long out_stride) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const unsigned long long c = (unsigned long long)(cols ? cols[i] : start + i);
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t d[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned long long ctr = (unsigned long long)(2 * k + h) * n + c;
      d[h] = threefry_xor(ks, (uint32_t)(ctr >> 32), (uint32_t)ctr);
    }
    w[k] = __byte_perm(d[0], d[1], 0x5410);  // bytes 0, 1 of d[0], then of d[1]
  }
  fp::Fe lo, hi;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo.w[j] = w[j];
    hi.w[j] = w[4 + j];
  }
  lo = fp::cond_sub_p(lo, 0u);
  hi = fp::cond_sub_p(hi, 0u);
  const fp::Fe r2 = fp::r2_mod_p();
  fp::store(out, out_stride, i, fp::mont_mul(fp::add(fp::mont_mul(hi, r2), lo), r2));
}

}  // namespace

// The m coefficients of the columns start .. start + m - 1 (cols null) or
// cols[0 .. m - 1] of the 16 x n draw under the key (k0, k1), into four
// planes of `out` `out_stride` words apart. Returns cudaGetLastError().
extern "C" int zk_coefficients(uint32_t k0, uint32_t k1, long n, long start, const long* cols, long m,
                               uint32_t* out, long out_stride, cudaStream_t stream) {
  if (n <= 0 || m <= 0 || start < 0) return (int)cudaErrorInvalidValue;
  const long blocks = (m + kThreads - 1) / kThreads;
  zk_coefficients_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      k0, k1, (unsigned long long)n, start, cols, m, out, out_stride);
  return (int)cudaGetLastError();
}
