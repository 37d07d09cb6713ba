// Elementwise F_p kernels: fp_add, fp_sub, fp_mont_mul, fp_butterfly and
// fp_pow_const.
//
// The three binary kernels replace stark_anatomy_tpu/ops/field_pallas.py
// `_add_kernel`, `_sub_kernel`, `_mont_mul_kernel` (through
// `_elementwise_call`), and with a by-value constant operand `to_mont` /
// `from_mont` and every "multiply by a broadcast constant" the prover does.
// fp_butterfly and fp_pow_const (each with its own note further down)
// replace `butterfly` and `pow_const` of the same file.
//
// Bound of the binary kernels on an H100: BYTES. Each element moves
// 3 x 16 B (two reads, one write; 2 x 16 B with a constant operand) against ~3.35 TB/s, while the
// Montgomery product is ~20 32x32 multiplies and ~50 adds per element: at
// 2^24 elements that is 0.24 ms of memory traffic against roughly 0.05 ms of
// integer issue. Design: one thread per element, plane-major so each of the
// four word loads of a warp is one coalesced 128-byte line; a grid-stride
// loop is not needed (n <= 2^31). Either operand may be a constant passed by
// value (its pointer is null), which removes a third of the traffic for the
// constant multiplies. The Pallas kernel's 16-bit-digit schoolbook (a 32-bit
// vector unit without a widening multiply) is NOT carried over: words are 32
// bits and products 64.
//
// The ragged edge is masked per thread: any n >= 1 is accepted. `out` may be
// one of the operands (each thread reads its element before it writes it), so
// the pointers are deliberately not __restrict__.
#include "field.cuh"

namespace {

enum Op { kAdd = 0, kSub = 1, kMul = 2 };

fp::Fe make_fe(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3) {
  fp::Fe c;
  c.w[0] = c0;
  c.w[1] = c1;
  c.w[2] = c2;
  c.w[3] = c3;
  return c;
}

template <int OP>
__global__ void fp_binary_kernel(const uint32_t* a, long a_stride,
                                 const uint32_t* b, long b_stride, fp::Fe c,
                                 uint32_t* out, long out_stride, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const fp::Fe x = a ? fp::load(a, a_stride, i) : c;
  const fp::Fe y = b ? fp::load(b, b_stride, i) : c;
  fp::Fe r;
  if (OP == kAdd) r = fp::add(x, y);
  if (OP == kSub) r = fp::sub(x, y);
  if (OP == kMul) r = fp::mont_mul(x, y);
  fp::store(out, out_stride, i, r);
}

template <int OP>
int launch(const uint32_t* a, long a_stride, const uint32_t* b, long b_stride,
           uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3, uint32_t* out,
           long out_stride, long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long blocks = (n + threads - 1) / threads;
  fp_binary_kernel<OP><<<(unsigned)blocks, threads, 0, stream>>>(
      a, a_stride, b, b_stride, make_fe(c0, c1, c2, c3), out, out_stride, n);
  return (int)cudaGetLastError();
}

// fp_butterfly. Replaces field_pallas.py `_butterfly_kernel` (`butterfly`):
// t = odd * tw; hi = even + t; lo = even - t, one thread per element.
// Bound: BYTES, 80 per element (three reads, two writes; 64 with a constant
// twiddle) against ~84 integer operations. The product stays in registers
// between the multiply and the add/sub, which is all the fusion there is to
// have. `hi` may be `even` and `lo` may be `odd` (a thread reads its element
// of every operand before it writes). The NTT does not call this: ntt_stage
// fuses the same arithmetic in place with a strided twiddle table.
__global__ void fp_butterfly_kernel(const uint32_t* even, long even_stride,
                                    const uint32_t* odd, long odd_stride,
                                    const uint32_t* tw, long tw_stride, fp::Fe c,
                                    uint32_t* hi, long hi_stride, uint32_t* lo,
                                    long lo_stride, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const fp::Fe e = fp::load(even, even_stride, i);
  const fp::Fe o = fp::load(odd, odd_stride, i);
  const fp::Fe w = tw ? fp::load(tw, tw_stride, i) : c;
  const fp::Fe t = fp::mont_mul(o, w);
  fp::store(hi, hi_stride, i, fp::add(e, t));
  fp::store(lo, lo_stride, i, fp::sub(e, t));
}

// fp_pow_const. Replaces field_pallas.py `pow_const` (:266), which scans the
// product kernel over the exponent's bits: two launches and two full passes
// over device memory per bit. Here the running power never leaves its
// thread: one read and one write per element whatever the exponent, so the
// kernel is bound by OPERATIONS, the Montgomery products. Fixed 4-bit windows,
// most significant first (ops/field_kernels.py `pow_windows`; the C entry
// counts the digits): a table x^1..x^15 (14 products), then for every window
// after the top one 4 squarings and, for a non-zero digit, one product from
// the table. For any e < 2^128 that is at most 14 + 124 + 31
// = 169 products (169 for p - 2, which took 250 by bits; `inv` uses the
// 143-product chain of field.cuh instead). The digit is the same for every
// thread, so no warp diverges. The table lies in shared memory as planes
// [digit][word][thread]: each thread reads only its own column (no barrier),
// and a warp's 32 reads of one word are 32 adjacent banks. The input is
// canonicalised first (one conditional subtract) so that every product has
// a canonical operand and the result is the canonical representative, which
// is what the LSB-first plain version gives for any 128-bit input. e = 0
// gives R mod p (Montgomery one) for every input, 0 included.
constexpr int kPowThreads = 128;

__global__ void __launch_bounds__(kPowThreads)
fp_pow_const_kernel(const uint32_t* a, long a_stride, fp::Fe e, int windows, uint32_t* out,
                    long out_stride, long n) {
  __shared__ uint32_t table[15][4][kPowThreads];  // x^d at [d - 1]: 30 KB
  const int t = threadIdx.x;
  const long i = (long)blockIdx.x * kPowThreads + t;
  if (i >= n) return;
  fp::Fe r = fp::mont_one();
  if (windows > 0) {
    const fp::Fe x = fp::cond_sub_p(fp::load(a, a_stride, i), 0u);
    fp::Fe p = x;
#pragma unroll 1
    for (int d = 1; d < 16; ++d) {
      if (d > 1) p = fp::mont_mul(p, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) table[d - 1][j][t] = p.w[j];
    }
    auto digit = [&e](int w) { return (e.w[w >> 3] >> ((w & 7) * 4)) & 15u; };
    const unsigned top = digit(windows - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) r.w[j] = table[top - 1][j][t];
#pragma unroll 1
    for (int w = windows - 2; w >= 0; --w) {
      r = fp::sqr_n(r, 4);
      const unsigned d = digit(w);
      if (d) {
        fp::Fe m;
#pragma unroll
        for (int j = 0; j < 4; ++j) m.w[j] = table[d - 1][j][t];
        r = fp::mont_mul(r, m);
      }
    }
  }
  fp::store(out, out_stride, i, r);
}

}  // namespace

// A null `a` or `b` means "the constant (c0..c3)". Strides are in words
// between consecutive planes. Returns cudaGetLastError() of the launch.
extern "C" int fp_add(const uint32_t* a, long a_stride, const uint32_t* b,
                      long b_stride, uint32_t c0, uint32_t c1, uint32_t c2,
                      uint32_t c3, uint32_t* out, long out_stride, long n,
                      cudaStream_t stream) {
  return launch<kAdd>(a, a_stride, b, b_stride, c0, c1, c2, c3, out, out_stride, n, stream);
}

extern "C" int fp_sub(const uint32_t* a, long a_stride, const uint32_t* b,
                      long b_stride, uint32_t c0, uint32_t c1, uint32_t c2,
                      uint32_t c3, uint32_t* out, long out_stride, long n,
                      cudaStream_t stream) {
  return launch<kSub>(a, a_stride, b, b_stride, c0, c1, c2, c3, out, out_stride, n, stream);
}

extern "C" int fp_mont_mul(const uint32_t* a, long a_stride, const uint32_t* b,
                           long b_stride, uint32_t c0, uint32_t c1, uint32_t c2,
                           uint32_t c3, uint32_t* out, long out_stride, long n,
                           cudaStream_t stream) {
  return launch<kMul>(a, a_stride, b, b_stride, c0, c1, c2, c3, out, out_stride, n, stream);
}

// hi = even + odd * tw, lo = even - odd * tw. A null `tw` means the constant
// (c0..c3). `hi` may alias `even`, `lo` may alias `odd`.
extern "C" int fp_butterfly(const uint32_t* even, long even_stride,
                            const uint32_t* odd, long odd_stride,
                            const uint32_t* tw, long tw_stride, uint32_t c0,
                            uint32_t c1, uint32_t c2, uint32_t c3, uint32_t* hi,
                            long hi_stride, uint32_t* lo, long lo_stride, long n,
                            cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long blocks = (n + threads - 1) / threads;
  fp_butterfly_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      even, even_stride, odd, odd_stride, tw, tw_stride, make_fe(c0, c1, c2, c3),
      hi, hi_stride, lo, lo_stride, n);
  return (int)cudaGetLastError();
}

// out = a^e in Montgomery form, e = e0 + e1*2^32 + e2*2^64 + e3*2^96 by
// value. `out` may alias `a`.
extern "C" int fp_pow_const(const uint32_t* a, long a_stride, uint32_t e0,
                            uint32_t e1, uint32_t e2, uint32_t e3, uint32_t* out,
                            long out_stride, long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t ew[4] = {e0, e1, e2, e3};
  int windows = 0;  // the number of 4-bit digits of e: 0 for e = 0
  for (int w = 0; w < 32; ++w)
    if ((ew[w >> 3] >> ((w & 7) * 4)) & 15u) windows = w + 1;
  const long blocks = (n + kPowThreads - 1) / kPowThreads;
  fp_pow_const_kernel<<<(unsigned)blocks, kPowThreads, 0, stream>>>(
      a, a_stride, make_fe(e0, e1, e2, e3), windows, out, out_stride, n);
  return (int)cudaGetLastError();
}
