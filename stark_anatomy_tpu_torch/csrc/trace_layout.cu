// trace_layout: a byte trace and its pad rows -> Montgomery word planes of
// every column, in one launch.
//
// Replaces, on the card, the host layout of iop/stark.py `_trace_lde` (the
// JAX package does the same layout in numpy before its device_put,
// stark_anatomy_tpu/iop/stark.py `_trace_lde`): per column a
// strided copy, a transpose into (4, O) u32 planes, the concatenation with
// the pad rows and a copy into fresh memory, then one fp_mont_mul by R^2 on
// the card. Here the host uploads the caller's (T, w, 16) uint8 trace as it
// is and a (w, 4, P) block of the P = O - T pad rows' standard-form words;
// the kernel writes column j's four Montgomery planes out[j] of (w, 4, O).
//
// Bound on an H100: BYTES. An element reads 16 B and writes 16 B, against one
// Montgomery product (~60 32-bit operations): 32 * O * w B, 0.08 ms at
// O = 2^22, w = 2 at 3.35 TB/s, against 0.03 ms of integer issue.
//
// Design. One thread a row, a loop over the w columns. Rows are contiguous,
// so a thread's w elements are w * 16 consecutive bytes, read as 16-byte
// vector loads (the trace must be 16-byte aligned); the lanes of a warp
// cover w * 512 consecutive bytes. Each word goes to its own plane, so a warp
// stores four coalesced 128-byte lines a column. Rows T..O-1 read the pad
// block instead, plane-major like the output. The product is field.cuh's
// mont_mul by R^2, the arithmetic of fp_mont_mul's to_mont, so the planes
// equal the host route's bit for bit whatever the 128-bit input.
#include "field.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
trace_layout_kernel(const uint4* __restrict__ body, long rows, int w,
                    const uint32_t* __restrict__ pad, long pad_len,
                    uint32_t* __restrict__ out, long col_stride, long plane_stride, long n) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const fp::Fe r2 = fp::r2_mod_p();
  for (int j = 0; j < w; ++j) {
    fp::Fe x;
    if (i < rows) {
      const uint4 v = body[i * w + j];
      x.w[0] = v.x;
      x.w[1] = v.y;
      x.w[2] = v.z;
      x.w[3] = v.w;
    } else {
      x = fp::load(pad + (long)j * 4 * pad_len, pad_len, i - rows);
    }
    fp::store(out + (long)j * col_stride, plane_stride, i, fp::mont_mul(x, r2));
  }
}

}  // namespace

// The (rows + pad_len) rows of w columns: `body` the rows * w 16-byte
// encodings (row-major, 16-byte aligned), `pad` (null when pad_len is 0) the
// (w, 4, pad_len) words of the rows after them; column j's plane k at
// out + j * col_stride + k * plane_stride. Returns cudaGetLastError().
extern "C" int trace_layout(const void* body, long rows, int w, const uint32_t* pad, long pad_len,
                            uint32_t* out, long col_stride, long plane_stride, cudaStream_t stream) {
  const long n = rows + pad_len;
  if (rows < 0 || pad_len < 0 || n <= 0 || w <= 0 || (pad_len > 0 && pad == nullptr))
    return (int)cudaErrorInvalidValue;
  const long blocks = (n + kThreads - 1) / kThreads;
  trace_layout_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(body), rows, w, pad, pad_len, out, col_stride, plane_stride, n);
  return (int)cudaGetLastError();
}
