// Radix-2 NTT over F_p: ntt_block (first stages in shared memory),
// ntt_stage (one global stage per launch) and ntt_grouped (many small
// transforms, each wholly in shared memory).
//
// Replaces: stark_anatomy_tpu/ops/ntt_pallas.py `_early_kernel_factory` /
// `_run_early` (ntt_block) and `_late_kernel` / `_run_late_stage`
// (ntt_stage), with the bit reversal of `_bit_reverse_fast` folded into
// ntt_block's load index and the per-stage twiddle tables of `_stage_tables`
// replaced by strided reads of ONE master table w^0 .. w^(n/2-1).
//
// The transform is decimation in time on bit-reversed input: stage s
// (m = 2^s, h = m/2) combines pairs (pos, pos + h) inside groups of m with
// the twiddle w_n^(j * n/m); after log2(n) stages the output is in natural
// order, bit-equal to any correct radix-2 NTT (exact arithmetic, canonical
// representatives).
//
// Bound on an H100: BYTES. ntt_stage moves 2 x 16 B per element per stage
// (read and write every element once) plus 16 B per butterfly of twiddle;
// ntt_block moves 2 x 16 B per element ONCE for its first log2(B) stages,
// which is the point of the kernel: at n = 2^24 the 10 stages it fuses would
// otherwise be 10 more global passes of 0.16 ms each. Design: one thread
// block owns B = 2^log_block <= 1024 consecutive outputs (16 KB of shared
// memory as uint4), one thread per butterfly per stage with __syncthreads()
// between stages; no lane rolls and no compute-both-and-select as the Pallas
// kernel needed. The bit-reversed gather on load is strided and therefore
// uncoalesced; that cost is recorded, not hidden (PERF.md). The inverse
// transform's 1/n (or any scale) is multiplied in on load.
//
// Every size n = 2^k >= 2 is accepted: a transform smaller than the block
// size runs entirely in one block of n/2 threads.
//
// ntt_grouped replaces stark_anatomy_tpu/ops/ntt_pallas.py
// `grouped_ntt_with_tables` (the early kernel run over aligned lane groups):
// n/g independent size-g transforms of a flat array, g = 2^log_group <= 128,
// every aligned run of g elements one transform; the column transforms of the
// four-step mesh NTT. NATURAL-ORDER GROUPS IN, NATURAL-ORDER GROUPS OUT: the
// Pallas kernel works by lane rolls and so needs each group handed over
// bit-reversed (a gather by its caller); here the global load is linear and
// coalesced and the in-group bit reversal goes into the shared-memory index,
// so the caller's gather is not needed. Bound on an H100: BYTES (2 x 16 B
// per element against at most 7 butterfly stages). Design: one thread block
// owns 1024 consecutive elements = 1024/g whole groups (16 KB of shared
// memory), one thread per butterfly per stage, twiddle w_g^(j * g/2^s) read
// from the (4, g/2) master table of size g, the scale (1/g for the inverse)
// multiplied in on load. Any n that is a multiple of g: the last block is
// ragged, n < 1024 runs in one smaller block.
#include "field.cuh"

namespace {

__device__ __forceinline__ uint4 pack(const fp::Fe& v) {
  return make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
}

__device__ __forceinline__ fp::Fe unpack(const uint4& u) {
  fp::Fe v;
  v.w[0] = u.x;
  v.w[1] = u.y;
  v.w[2] = u.z;
  v.w[3] = u.w;
  return v;
}

__global__ void ntt_block_kernel(const uint32_t* __restrict__ x, long x_stride,
                                 uint32_t* __restrict__ out, long out_stride,
                                 const uint32_t* __restrict__ tw, long tw_stride,
                                 int log_n, int log_block, int use_scale,
                                 fp::Fe scale) {
  extern __shared__ uint4 sm[];
  const int block = 1 << log_block;
  const int half_block = block >> 1;
  const int tid = threadIdx.x;
  const long base = (long)blockIdx.x << log_block;

  for (int l = tid; l < block; l += half_block) {
    const uint32_t p = (uint32_t)(base + l);
    const uint32_t src = __brev(p) >> (32 - log_n);
    fp::Fe v = fp::load(x, x_stride, (long)src);
    if (use_scale) v = fp::mont_mul(v, scale);
    sm[l] = pack(v);
  }
  __syncthreads();

  for (int s = 1; s <= log_block; ++s) {
    const int h = 1 << (s - 1);
    const int j = tid & (h - 1);
    const int pos = ((tid >> (s - 1)) << s) + j;
    const fp::Fe w = fp::load(tw, tw_stride, (long)j << (log_n - s));
    const fp::Fe e = unpack(sm[pos]);
    const fp::Fe t = fp::mont_mul(unpack(sm[pos + h]), w);
    sm[pos] = pack(fp::add(e, t));
    sm[pos + h] = pack(fp::sub(e, t));
    __syncthreads();
  }

  for (int l = tid; l < block; l += half_block)
    fp::store(out, out_stride, base + l, unpack(sm[l]));
}

__global__ void ntt_stage_kernel(uint32_t* __restrict__ x, long stride,
                                 const uint32_t* __restrict__ tw, long tw_stride,
                                 int log_n, int s) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (1L << (log_n - 1))) return;
  const long h = 1L << (s - 1);
  const long j = i & (h - 1);
  const long pos = ((i >> (s - 1)) << s) + j;
  const fp::Fe w = fp::load(tw, tw_stride, j << (log_n - s));
  const fp::Fe e = fp::load(x, stride, pos);
  const fp::Fe t = fp::mont_mul(fp::load(x, stride, pos + h), w);
  fp::store(x, stride, pos, fp::add(e, t));
  fp::store(x, stride, pos + h, fp::sub(e, t));
}

__global__ void ntt_grouped_kernel(const uint32_t* __restrict__ x, long x_stride,
                                   uint32_t* __restrict__ out, long out_stride,
                                   const uint32_t* __restrict__ tw, long tw_stride,
                                   long n, int log_group, int use_scale,
                                   fp::Fe scale) {
  __shared__ uint4 sm[1024];
  const int tid = threadIdx.x;
  const long base = (long)blockIdx.x << 10;
  const int count = (int)((n - base) < 1024L ? (n - base) : 1024L);
  const int in_group = (1 << log_group) - 1;

  for (int l = tid; l < count; l += blockDim.x) {
    fp::Fe v = fp::load(x, x_stride, base + l);
    if (use_scale) v = fp::mont_mul(v, scale);
    const int j = (int)(__brev((uint32_t)(l & in_group)) >> (32 - log_group));
    sm[(l & ~in_group) | j] = pack(v);
  }
  __syncthreads();

  for (int s = 1; s <= log_group; ++s) {
    const int h = 1 << (s - 1);
    for (int t = tid; t < (count >> 1); t += blockDim.x) {
      const int j = t & (h - 1);
      const int pos = ((t >> (s - 1)) << s) + j;
      const fp::Fe w = fp::load(tw, tw_stride, (long)j << (log_group - s));
      const fp::Fe e = unpack(sm[pos]);
      const fp::Fe o = fp::mont_mul(unpack(sm[pos + h]), w);
      sm[pos] = pack(fp::add(e, o));
      sm[pos + h] = pack(fp::sub(e, o));
    }
    __syncthreads();
  }

  for (int l = tid; l < count; l += blockDim.x)
    fp::store(out, out_stride, base + l, unpack(sm[l]));
}

}  // namespace

// Stages 1..log_block of a 2^log_n-point transform: reads x in bit-reversed
// order (optionally times `scale`), writes out. 1 <= log_block <= min(10,
// log_n), log_n <= 31. tw: planes of the n/2-entry master twiddle table.
extern "C" int ntt_block(const uint32_t* x, long x_stride, uint32_t* out,
                         long out_stride, const uint32_t* tw, long tw_stride,
                         int log_n, int log_block, int use_scale, uint32_t s0,
                         uint32_t s1, uint32_t s2, uint32_t s3,
                         cudaStream_t stream) {
  if (log_n < 1 || log_n > 31 || log_block < 1 || log_block > 10 ||
      log_block > log_n)
    return (int)cudaErrorInvalidValue;
  fp::Fe scale;
  scale.w[0] = s0;
  scale.w[1] = s1;
  scale.w[2] = s2;
  scale.w[3] = s3;
  const unsigned blocks = 1u << (log_n - log_block);
  const unsigned threads = 1u << (log_block - 1);
  const size_t smem = sizeof(uint4) << log_block;
  ntt_block_kernel<<<blocks, threads, smem, stream>>>(
      x, x_stride, out, out_stride, tw, tw_stride, log_n, log_block, use_scale,
      scale);
  return (int)cudaGetLastError();
}

// One in-place radix-2 stage s (m = 2^s) over all n/2 butterflies.
extern "C" int ntt_stage(uint32_t* x, long stride, const uint32_t* tw,
                         long tw_stride, int log_n, int s, cudaStream_t stream) {
  if (log_n < 1 || log_n > 31 || s < 1 || s > log_n)
    return (int)cudaErrorInvalidValue;
  const long butterflies = 1L << (log_n - 1);
  const int threads = 256;
  const unsigned blocks = (unsigned)((butterflies + threads - 1) / threads);
  ntt_stage_kernel<<<blocks, threads, 0, stream>>>(x, stride, tw, tw_stride,
                                                   log_n, s);
  return (int)cudaGetLastError();
}

// n / 2^log_group independent transforms of size 2^log_group, natural order
// in and out (optionally times `scale`). 1 <= log_group <= 7, n a positive
// multiple of the group size. tw: planes of the g/2-entry master twiddle
// table of size g.
extern "C" int ntt_grouped(const uint32_t* x, long x_stride, uint32_t* out,
                           long out_stride, const uint32_t* tw, long tw_stride,
                           long n, int log_group, int use_scale, uint32_t s0,
                           uint32_t s1, uint32_t s2, uint32_t s3,
                           cudaStream_t stream) {
  if (log_group < 1 || log_group > 7 || n < 1 || (n & ((1L << log_group) - 1)) ||
      n > (1L << 40))
    return (int)cudaErrorInvalidValue;
  fp::Fe scale;
  scale.w[0] = s0;
  scale.w[1] = s1;
  scale.w[2] = s2;
  scale.w[3] = s3;
  const unsigned blocks = (unsigned)((n + 1023) >> 10);
  const unsigned threads = n >= 1024 ? 512u : (unsigned)(n >> 1);
  ntt_grouped_kernel<<<blocks, threads, 0, stream>>>(
      x, x_stride, out, out_stride, tw, tw_stride, n, log_group, use_scale,
      scale);
  return (int)cudaGetLastError();
}
