// F_p device arithmetic shared by every kernel, p = 1 + 407 * 2^119.
//
// An element is four little-endian 32-bit words. Arrays are stored as word
// PLANES: word j of element i lives at base[j * plane_stride + i], so a warp
// reading element i..i+31 reads four coalesced 128-byte lines.
//
// p's words are [1, 0, 0, 0xCB800000]. Because p = 1 (mod 2^32), the
// per-word Montgomery constant -p^-1 mod 2^32 is 0xFFFFFFFF: each REDC step
// takes m = -t[0], adds m at word 0 and the 64-bit product m * 0xCB800000 at
// word 3. One 32x32 multiply per step instead of four, and the first three
// steps collapse into one 96-bit negation (see mont_mul).
//
// All three operations accept ANY 128-bit inputs (not only values < p) and
// apply exactly one conditional subtract (or add) of p, which is what the
// plain PyTorch versions in ops/field_torch.py do: raw 128-bit random draws
// are canonicalised with add(raw, 0).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace fp {

constexpr uint32_t P0 = 1u;
constexpr uint32_t P3 = 0xCB800000u;

struct Fe {
  uint32_t w[4];
};

__device__ __forceinline__ Fe load(const uint32_t* base, long stride, long i) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; ++j) r.w[j] = base[j * stride + i];
  return r;
}

__device__ __forceinline__ void store(uint32_t* base, long stride, long i, const Fe& v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) base[j * stride + i] = v.w[j];
}

// The three helpers below are single carry chains in PTX: the flag carries
// from word to word, where 64-bit C costs a shift and an add for each.

// v (with an extra bit `hi` at 2^128) -> v - p if v >= p, else v; mod 2^128.
__device__ __forceinline__ Fe cond_sub_p(const Fe& v, uint32_t hi) {
  Fe r;
  asm("{\n\t"
      ".reg .u32 d0, d1, d2, d3, top;\n\t"
      ".reg .pred lt;\n\t"
      // (hi : v) - p over five words; the top word is -1 exactly when v < p
      "sub.cc.u32 d0, %4, 1;\n\t"
      "subc.cc.u32 d1, %5, 0;\n\t"
      "subc.cc.u32 d2, %6, 0;\n\t"
      "subc.cc.u32 d3, %7, %9;\n\t"
      "subc.u32 top, %8, 0;\n\t"
      "setp.lt.s32 lt, top, 0;\n\t"
      "selp.u32 %0, %4, d0, lt;\n\t"
      "selp.u32 %1, %5, d1, lt;\n\t"
      "selp.u32 %2, %6, d2, lt;\n\t"
      "selp.u32 %3, %7, d3, lt;\n\t"
      "}"
      : "=&r"(r.w[0]), "=&r"(r.w[1]), "=&r"(r.w[2]), "=&r"(r.w[3])
      : "r"(v.w[0]), "r"(v.w[1]), "r"(v.w[2]), "r"(v.w[3]), "r"(hi), "r"(P3));
  return r;
}

__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  Fe r;
  uint32_t hi;
  asm("add.cc.u32 %0, %5, %9;\n\t"
      "addc.cc.u32 %1, %6, %10;\n\t"
      "addc.cc.u32 %2, %7, %11;\n\t"
      "addc.cc.u32 %3, %8, %12;\n\t"
      "addc.u32 %4, 0, 0;"
      : "=&r"(r.w[0]), "=&r"(r.w[1]), "=&r"(r.w[2]), "=&r"(r.w[3]), "=&r"(hi)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(b.w[0]),
        "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]));
  return cond_sub_p(r, hi);
}

// a - b, plus p (mod 2^128) where a < b.
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
  Fe r;
  asm("{\n\t"
      ".reg .u32 d0, d1, d2, d3, mask, p0, p3;\n\t"
      "sub.cc.u32 d0, %4, %8;\n\t"
      "subc.cc.u32 d1, %5, %9;\n\t"
      "subc.cc.u32 d2, %6, %10;\n\t"
      "subc.cc.u32 d3, %7, %11;\n\t"
      "subc.u32 mask, 0, 0;\n\t"  // -1 where the chain borrowed
      "and.b32 p0, mask, 1;\n\t"
      "and.b32 p3, mask, %12;\n\t"
      "add.cc.u32 %0, d0, p0;\n\t"
      "addc.cc.u32 %1, d1, 0;\n\t"
      "addc.cc.u32 %2, d2, 0;\n\t"
      "addc.u32 %3, d3, p3;\n\t"
      "}"
      : "=&r"(r.w[0]), "=&r"(r.w[1]), "=&r"(r.w[2]), "=&r"(r.w[3])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(b.w[0]),
        "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(P3));
  return r;
}

// REDC(a * b) = a * b * 2^-128 mod p, in two carry-chain blocks of PTX (the
// compiler's own code for the same arithmetic in 64-bit C spends two thirds
// of its ~145 SASS operations moving carries; a chain keeps them in the flag).
//
// 1. T = a * b, eight words. Products a[j] * b[i] with i + j even start at
//    even words and go to E (kept in T's registers), those with i + j odd to
//    O, one word up: within a row every lo/hi pair then lands on its own two
//    words, so a row is ONE chain of mad.lo.cc / madc.hi.cc pairs (each pair
//    a single wide multiply-add). T = E + (O << 32).
// 2. Montgomery reduction, using p = 1 + P3 * 2^96: the word-serial factors
//    m0, m1, m2 (m_i = -t_i once the steps before have been added) touch
//    only words >= 3 through P3, so (m2 m1 m0) is the 96-bit NEGATION of
//    T's three low words, which cancel to a carry c = (low words != 0). Then
//    U = T[3..7] + c + (m2 m1 m0) * P3, and one last step on U's low word:
//    m3 = -U0, carry (U0 != 0), m3 * P3 three words up. What is left is the
//    129-bit value (T + m p) / 2^128 < 2^128 + p for ANY 128-bit a and b; one
//    conditional subtract, as in the plain version.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
  uint32_t t0, t1, t2, t3, t4, t5, t6, t7;
  asm("{\n\t"
      ".reg .u32 o0, o1, o2, o3, o4, o5, o6;\n\t"
      // row b0: E = a0 b0 (words 0,1), a2 b0 (2,3); O = a1 b0 (1,2), a3 b0 (3,4)
      "mul.lo.u32 %0, %8, %12;\n\t"
      "mul.hi.u32 %1, %8, %12;\n\t"
      "mul.lo.u32 %2, %10, %12;\n\t"
      "mul.hi.u32 %3, %10, %12;\n\t"
      "mul.lo.u32 o0, %9, %12;\n\t"
      "mul.hi.u32 o1, %9, %12;\n\t"
      "mul.lo.u32 o2, %11, %12;\n\t"
      "mul.hi.u32 o3, %11, %12;\n\t"
      // row b1: E += a1 b1 (2,3), a3 b1 (4,5); O += a0 b1 (1,2), a2 b1 (3,4)
      "mad.lo.cc.u32 %2, %9, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, 0;\n\t"
      "madc.hi.u32 %5, %11, %13, 0;\n\t"
      "mad.lo.cc.u32 o0, %8, %13, o0;\n\t"
      "madc.hi.cc.u32 o1, %8, %13, o1;\n\t"
      "madc.lo.cc.u32 o2, %10, %13, o2;\n\t"
      "madc.hi.cc.u32 o3, %10, %13, o3;\n\t"
      "addc.u32 o4, 0, 0;\n\t"
      // row b2: E += a0 b2 (2,3), a2 b2 (4,5); O += a1 b2 (3,4), a3 b2 (5,6)
      "mad.lo.cc.u32 %2, %8, %14, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %14, %5;\n\t"
      "addc.u32 %6, 0, 0;\n\t"
      "mad.lo.cc.u32 o2, %9, %14, o2;\n\t"
      "madc.hi.cc.u32 o3, %9, %14, o3;\n\t"
      "madc.lo.cc.u32 o4, %11, %14, o4;\n\t"
      "madc.hi.u32 o5, %11, %14, 0;\n\t"
      // row b3: E += a1 b3 (4,5), a3 b3 (6,7); O += a0 b3 (3,4), a2 b3 (5,6)
      "mad.lo.cc.u32 %4, %9, %15, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %15, %6;\n\t"
      "madc.hi.u32 %7, %11, %15, 0;\n\t"
      "mad.lo.cc.u32 o2, %8, %15, o2;\n\t"
      "madc.hi.cc.u32 o3, %8, %15, o3;\n\t"
      "madc.lo.cc.u32 o4, %10, %15, o4;\n\t"
      "madc.hi.cc.u32 o5, %10, %15, o5;\n\t"
      "addc.u32 o6, 0, 0;\n\t"
      // T = E + (O << 32)
      "add.cc.u32 %1, %1, o0;\n\t"
      "addc.cc.u32 %2, %2, o1;\n\t"
      "addc.cc.u32 %3, %3, o2;\n\t"
      "addc.cc.u32 %4, %4, o3;\n\t"
      "addc.cc.u32 %5, %5, o4;\n\t"
      "addc.cc.u32 %6, %6, o5;\n\t"
      "addc.u32 %7, %7, o6;\n\t"
      "}"
      : "=&r"(t0), "=&r"(t1), "=&r"(t2), "=&r"(t3), "=&r"(t4), "=&r"(t5),
        "=&r"(t6), "=&r"(t7)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(b.w[0]),
        "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]));
  Fe r;
  uint32_t hi;
  asm("{\n\t"
      ".reg .u32 z, n0, n1, n2, c, u0, u1, u2, u3, u4, u5, m3;\n\t"
      "mov.u32 z, 0;\n\t"
      // (n2 n1 n0) = -(t2 t1 t0) mod 2^96; c = 1 unless they are all zero
      "sub.cc.u32 n0, z, %5;\n\t"
      "subc.cc.u32 n1, z, %6;\n\t"
      "subc.u32 n2, z, %7;\n\t"
      "or.b32 c, %5, %6;\n\t"
      "or.b32 c, c, %7;\n\t"
      "min.u32 c, c, 1;\n\t"
      // U = T[3..7] + c
      "add.cc.u32 u0, %8, c;\n\t"
      "addc.cc.u32 u1, %9, z;\n\t"
      "addc.cc.u32 u2, %10, z;\n\t"
      "addc.cc.u32 u3, %11, z;\n\t"
      "addc.cc.u32 u4, %12, z;\n\t"
      "addc.u32 u5, z, z;\n\t"
      // U += n0 P3 (words 0,1) + n2 P3 (words 2,3)
      "mad.lo.cc.u32 u0, n0, %13, u0;\n\t"
      "madc.hi.cc.u32 u1, n0, %13, u1;\n\t"
      "madc.lo.cc.u32 u2, n2, %13, u2;\n\t"
      "madc.hi.cc.u32 u3, n2, %13, u3;\n\t"
      "addc.cc.u32 u4, u4, z;\n\t"
      "addc.u32 u5, u5, z;\n\t"
      // U += n1 P3 (words 1,2)
      "mad.lo.cc.u32 u1, n1, %13, u1;\n\t"
      "madc.hi.cc.u32 u2, n1, %13, u2;\n\t"
      "addc.cc.u32 u3, u3, z;\n\t"
      "addc.cc.u32 u4, u4, z;\n\t"
      "addc.u32 u5, u5, z;\n\t"
      // last step: m3 = -u0 cancels u0 to a carry; m3 P3 at words 3,4
      "sub.u32 m3, z, u0;\n\t"
      "min.u32 c, u0, 1;\n\t"
      "add.cc.u32 %0, u1, c;\n\t"
      "addc.cc.u32 %1, u2, z;\n\t"
      "madc.lo.cc.u32 %2, m3, %13, u3;\n\t"
      "madc.hi.cc.u32 %3, m3, %13, u4;\n\t"
      "addc.u32 %4, u5, z;\n\t"
      "}"
      : "=&r"(r.w[0]), "=&r"(r.w[1]), "=&r"(r.w[2]), "=&r"(r.w[3]), "=&r"(hi)
      : "r"(t0), "r"(t1), "r"(t2), "r"(t3), "r"(t4), "r"(t5), "r"(t6), "r"(t7),
        "r"(P3));
  return cond_sub_p(r, hi);
}

// Montgomery one, R mod p = 2^128 - p.
__device__ __forceinline__ Fe mont_one() {
  Fe r;
  r.w[0] = 0xFFFFFFFFu;
  r.w[1] = 0xFFFFFFFFu;
  r.w[2] = 0xFFFFFFFFu;
  r.w[3] = 0u - P3 - 1u;
  return r;
}

// R^2 mod p = 2^256 mod p (ops/limbs.py R2_MOD_P): mont_mul(x, r2_mod_p())
// lifts a standard-form x to Montgomery form, as to_mont does.
__device__ __forceinline__ Fe r2_mod_p() {
  Fe r;
  r.w[0] = 0x0E778236u;
  r.w[1] = 0x5BD53A7Fu;
  r.w[2] = 0x1A6AEDC2u;
  r.w[3] = 0xAAF4AD9Au;
  return r;
}

__device__ __forceinline__ Fe sqr_n(Fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = mont_mul(x, x);
  return x;
}

// a^(p-2), Montgomery in and out (0 -> 0), by the addition chain of
// stark_anatomy_tpu/ops/field_pallas.py `_inv_ladder` (plain copy:
// ops/field_torch.py `inv_chain`). p - 2 = 407 * 2^119 - 1: run-doubling
// t_k = a^(2^k - 1) up to t = a^(2^119 - 1), then z = t * a = a^(2^119) and
// a^(p-2) = z^406 * t. 118 squarings and 25 other products: 143, against 250
// for square-and-multiply over the bits of p - 2.
__device__ __forceinline__ Fe inv_chain(const Fe& a) {
  Fe t = mont_mul(sqr_n(a, 1), a);  // t_2
  const Fe t2 = t;
  t = mont_mul(sqr_n(t, 2), t);  // t_4
  const Fe t4 = t;
  t = mont_mul(sqr_n(t, 4), t);  // t_8
  t = mont_mul(sqr_n(t, 8), t);  // t_16
  const Fe t16 = t;
  t = mont_mul(sqr_n(t, 16), t);  // t_32
  const Fe t32 = t;
  t = mont_mul(sqr_n(t, 32), t);    // t_64
  t = mont_mul(sqr_n(t, 32), t32);  // t_96
  t = mont_mul(sqr_n(t, 16), t16);  // t_112
  t = mont_mul(sqr_n(t, 4), t4);    // t_116
  t = mont_mul(sqr_n(t, 2), t2);    // t_118
  t = mont_mul(sqr_n(t, 1), a);     // t_119
  const Fe z = mont_mul(t, a);
  // z^406, MSB first over 406 = 0b110010110 (the leading 1 is z itself)
  Fe r = mont_mul(sqr_n(z, 1), z);  // 1
  r = sqr_n(r, 2);                  // 0, 0
  r = mont_mul(sqr_n(r, 1), z);     // 1
  r = sqr_n(r, 1);                  // 0
  r = mont_mul(sqr_n(r, 1), z);     // 1
  r = mont_mul(sqr_n(r, 1), z);     // 1
  r = sqr_n(r, 1);                  // 0
  return mont_mul(r, t);
}

}  // namespace fp
