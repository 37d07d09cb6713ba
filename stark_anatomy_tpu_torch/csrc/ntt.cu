// Radix-2 NTT over F_p in tiles: ntt_block (the first stages, bit-reversed
// gather included), ntt_stage (a run of later stages in ONE pass, in place)
// and ntt_grouped (many small transforms, each wholly in shared memory).
//
// Replaces: stark_anatomy_tpu/ops/ntt_pallas.py `_early_kernel_factory` (:95)
// / `_run_early` (:140) (ntt_block) and `_late_kernel` (:128) /
// `_run_late_stage` (:166) (ntt_stage), with the bit reversal of
// `_bit_reverse_fast` folded into ntt_block's tile and the per-stage twiddle
// tables of `_stage_tables` replaced by two small tables per pass.
//
// The transform is decimation in time on bit-reversed input: stage s
// (m = 2^s, h = m/2) combines pairs (pos, pos + h) inside groups of m with
// the twiddle w_n^(j * n/m), j = pos mod h; after log2(n) stages the output
// is in natural order, bit-equal to any correct radix-2 NTT (exact
// arithmetic, canonical representatives). ops/ntt_kernels.py `pass_plan`
// cuts the stages into at most 3 passes for n <= 2^24 (2 for n <= 2^20):
// ntt_block runs the first, ntt_stage each of the others, so the codeword
// crosses device memory once per PASS (read + write), not once per stage.
//
// TILES. A pass over stages s0+1 .. s0+k touches independent sub-problems
// {q * 2^(s0+k) + i * 2^s0 + c : i < 2^k}. One thread block takes 2^k rows i
// by 2^t ADJACENT columns c into shared memory, runs the k stages there with
// __syncthreads() between them, and stores the tile where it came from (the
// block owns it, hence in place). The index maps are mirrored, and tested on
// the CPU, by the pure functions of ops/ntt_kernels.py named at each use
// below (`stage_global_index`, `block_source_index`, `block_shared_index`,
// `block_output_index`, `pair_rows`, `row_twiddle_index`, `master_index`).
//
//   ntt_stage: global index q * 2^(s0+k) + i * 2^s0 + c0 + c
//     (`stage_global_index`), row i at shared index i * 2^t + c.
//   ntt_block (s0 = 0 on bit-reversed input): the tile is taken on the SOURCE
//     side, rows r * 2^(log_n-k), r < 2^k, by 2^t adjacent source columns
//     c0 + c (`block_source_index`). Column c is one whole size-2^k
//     transform; its element r goes to row brev_k(r) (`block_shared_index`)
//     and its 2^k results are the run of consecutive outputs
//     brev_(log_n-k)(c0 + c) * 2^k + row (`block_output_index`).
//
// Every global access whose volume grows with n, and its run length:
//   ntt_stage tile load and store   runs of 2^t elements per word plane
//                                   (t = 3: one 32 B sector)
//   ntt_block tile load             runs of 2^t elements per word plane
//   ntt_block tile store            runs of 2^k elements (k = 8: 1 KB)
//   column factors (ntt_stage)      2^t entries of the master table per tile,
//                                   2^(log_n-last) apart (adjacent in the
//                                   last pass): 2^(s-1) distinct entries
//   row factors (both)              2^(k-1) entries of the master table per
//                                   tile, 2^(log_n-k) apart, the SAME entries
//                                   for every tile (8 KB at k = 8: they stay
//                                   in L2, device memory gives them once)
// No access to the codeword is strided by more than the tile's row, and what
// a pass reads of the table from device memory is 2^(k-1) + 2^(s-1) entries.
//
// TWIDDLES. In a tile the twiddle of stage s0+u at column c, row i is
// w_n^((c + 2^s0 * i') * 2^(log_n-s0-u)), i' = i mod 2^(u-1), which factors as
//   w_(2^(s0+u))^c   *   w_(2^u)^i'
//   = col[c]^(2^(k-u))  *  row[i' << (k-u)]
// with row[e] = w_(2^k)^e = tw[e << (log_n-k)], e < 2^(k-1)
// (`row_twiddle_index`) and col[c] = w_(2^(s0+k))^c = tw[c << (log_n-s0-k)],
// c < 2^s0 (`master_index`): entries of the master table itself, so there is
// no second table to build, keep or free. A tile copies its 2^(k-1) row
// entries into shared memory and squares its 2^t column values k-1 times
// there (k * 2^t entries).
// ntt_block has s0 = 0, c = 0: the row table alone, no extra product.
// Reckoning, per element and pass of k = 8 stages (4 butterflies, 32 B of
// tile traffic): (c) reading the master table direct costs no product but
// 16 B more traffic in the last pass, contiguous only in its last stage
// (the stage before reads every second entry, and so on: up to 32 B in all),
// and a strided gather in a middle pass; (b) a cross twiddle per element is
// one product to apply and, without an n-entry table, one more to make (2
// on 4); (a) one product per DISTINCT twiddle of the tile: a thread's
// butterflies of one stage share (i', c) whenever they differ above bit u-1
// of the row, so the product is made once per thread and stage in the early
// stages and per butterfly only in the last ones. With L butterflies per
// thread and stage that is sum_u max(2^(k-1)/L, 2^(u-1)) products a column
// on k * 2^(k-1) butterflies: at k = 8, 304 on 1024 for L = 8 (+30 %, as
// launched: four quads of two stages), no traffic at all. (a) is taken.
// Operations bound of a whole 2^24-point transform: 24 * 2^23 * 84 / 33.5e12
// = 0.505 ms, with the extra products 0.505 + 16 * 2^23 * 0.30 * 60 / 33.5e12
// = 0.58 ms; bytes bound of a pass 32 B * n / 3.35e12 = 0.16 ms, of three
// passes 0.48 ms.
//
// SHARED MEMORY is uint4 (one LDS.128 / STS.128 per element). With >= 8
// columns the eight threads of a quarter warp take eight consecutive uint4 of
// ONE row, 128 contiguous bytes = every bank once, at every stage, h = 1, 2, 4
// included: the pairing runs along rows, the threads along columns. ntt_block
// pads its row to 2^t + 1 entries, so that its transposed store (threads
// along a column, stride 2^t + 1 entries: odd) is conflict-free as well.
// Sizes: 16 B * (2^(k+t) + 2^(k-1) + k * 2^t) for ntt_stage (k = 8, t = 3:
// 35 KB; k = 10, t = 3: 137 KB), 16 B * (2^k * (2^t + 1) + 2^(k-1)) for
// ntt_block (k = 8, t = 3: 38 KB; k = 10, t = 3: 152 KB); above 48 KB the
// launchers opt in with cudaFuncSetAttribute.
//
// WHAT BOUNDS A PASS on an H100 is the integer pipes, not bytes. A butterfly
// is about 105 SASS operations (the product 70, of them 20 wide multiply-adds
// that take two slots each; add 15, sub 11; its share of the shared-memory
// round trip), and a pass of 8 stages over 2^24 elements takes 0.47 ms
// (ntt_block) and 0.57 ms (ntt_stage, with the twiddle products) on an NVIDIA
// H100 80GB HBM3 at 700 W, against 0.16 ms for its bytes: 1.2 cycles of an SM
// per butterfly, which is every slot its schedulers have. Hence two stages
// per shared-memory round trip (a thread carries four rows through them in
// registers), small tiles, t = 3, and four quads a thread and step
// (ops/ntt_kernels.py `tile_cols`, `tile_threads`; timed by chip_smoke.py's
// `tune` phase). ptxas: 56 registers each, no spills; at k = 8 a block is 128
// threads and 35-38 KB, six blocks (24 warps) an SM; at k = 10 (n = 2^20 in
// two passes) 512 threads and 137-152 KB, one block an SM. Wider tiles
// (t = 4, 5: 64 and 128 B runs) and other block sizes were within 5 % or
// slower.
//
// The inverse transform's 1/n (or any scale) is multiplied in on ntt_block's
// load. Every size n = 2^k >= 2 up to 2^31 is accepted; a transform that fits
// one block is one launch.
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

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSharedBytes = 232448;  // what one block may opt in to

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

// The twiddle of stage u (of k) at i' and column c of a tile: row_tw[i' <<
// (k - u)] (ops/ntt_kernels.py `row_twiddle_index`), times the column factor
// col_tw[(u - 1) * 2^t + c] where the tile has one.
template <bool kColumnFactor>
__device__ __forceinline__ fp::Fe tile_twiddle(const uint4* row_tw,
                                               const uint4* col_tw, int k,
                                               int u, int ip, int cols, int c) {
  fp::Fe w = unpack(row_tw[ip << (k - u)]);
  if (kColumnFactor) w = fp::mont_mul(w, unpack(col_tw[(u - 1) * cols + c]));
  return w;
}

__device__ __forceinline__ void butterfly(fp::Fe& lo, fp::Fe& hi, const fp::Fe& w) {
  const fp::Fe o = fp::mont_mul(hi, w);
  hi = fp::sub(lo, o);
  lo = fp::add(lo, o);
}

// Stages 1..k over the rows of a tile of 2^k rows by 2^t columns held in
// shared memory at sm[row * row_stride + c]; blockDim.x is a power of two
// >= 2^t, so a thread keeps its column. Two stages u, u+1 at a time, in
// registers: quad b is column b mod 2^t and row quad rq = b >> t, the four
// rows row + {0, h, 2h, 3h}, h = 2^(u-1), with i' = rq mod h
// (ops/ntt_kernels.py `quad_rows`). Stage u pairs (0, h) and (2h, 3h), both
// with the twiddle of i'; stage u+1 pairs (0, 2h) with that of i' and
// (h, 3h) with that of i' + h: one shared-memory round trip and three
// twiddles for four butterflies. The twiddles are made anew only when i'
// changes between a thread's quads. An odd k ends with one radix-2 stage
// (`pair_rows`).
template <bool kColumnFactor>
__device__ __forceinline__ void tile_stages(uint4* sm, int row_stride,
                                            const uint4* row_tw,
                                            const uint4* col_tw, int k, int t) {
  const int tid = threadIdx.x;
  const int step = blockDim.x;
  const int cols = 1 << t;
  const int c = tid & (cols - 1);
  int u = 1;
  for (; u < k; u += 2) {
    const int h = 1 << (u - 1);
    const int quads = 1 << (k - 2 + t);
    const int hs = h * row_stride;
    int have = -1;
    fp::Fe w0 = {}, w1 = {}, w2 = {};
    for (int b = tid; b < quads; b += step) {
      const int rq = b >> t;
      const int ip = rq & (h - 1);
      const int row = ((rq >> (u - 1)) << (u + 1)) | ip;
      if (ip != have) {
        w0 = tile_twiddle<kColumnFactor>(row_tw, col_tw, k, u, ip, cols, c);
        w1 = tile_twiddle<kColumnFactor>(row_tw, col_tw, k, u + 1, ip, cols, c);
        w2 = tile_twiddle<kColumnFactor>(row_tw, col_tw, k, u + 1, ip + h, cols, c);
        have = ip;
      }
      uint4* p0 = sm + row * row_stride + c;
      uint4* p1 = p0 + hs;
      uint4* p2 = p1 + hs;
      uint4* p3 = p2 + hs;
      fp::Fe x0 = unpack(*p0), x1 = unpack(*p1), x2 = unpack(*p2), x3 = unpack(*p3);
      butterfly(x0, x1, w0);
      butterfly(x2, x3, w0);
      butterfly(x0, x2, w1);
      butterfly(x1, x3, w2);
      *p0 = pack(x0);
      *p1 = pack(x1);
      *p2 = pack(x2);
      *p3 = pack(x3);
    }
    __syncthreads();
  }
  if (u == k) {
    const int h = 1 << (u - 1);
    const int pairs = 1 << (k - 1 + t);
    int have = -1;
    fp::Fe w = {};
    for (int b = tid; b < pairs; b += step) {
      const int rp = b >> t;
      const int ip = rp & (h - 1);
      const int row = ((rp >> (u - 1)) << u) | ip;
      if (ip != have) {
        w = tile_twiddle<kColumnFactor>(row_tw, col_tw, k, u, ip, cols, c);
        have = ip;
      }
      uint4* lo = sm + row * row_stride + c;
      uint4* hi = lo + h * row_stride;
      fp::Fe e = unpack(*lo), o = unpack(*hi);
      butterfly(e, o, w);
      *lo = pack(e);
      *hi = pack(o);
    }
    __syncthreads();
  }
}

// row_tw[e] = w_(2^k)^e, e < 2^(k-1), out of the master table of the
// 2^log_n-point transform (ops/ntt_kernels.py `master_index`)
__device__ __forceinline__ void load_row_table(uint4* row_tw,
                                               const uint32_t* __restrict__ tw,
                                               long tw_stride, int log_n, int k) {
  for (int e = threadIdx.x; e < (1 << (k - 1)); e += blockDim.x)
    row_tw[e] = pack(fp::load(tw, tw_stride, (long)e << (log_n - k)));
}

__global__ void __launch_bounds__(kMaxThreads)
ntt_block_kernel(const uint32_t* __restrict__ x, long x_stride,
                 uint32_t* __restrict__ out, long out_stride,
                 const uint32_t* __restrict__ tw, long tw_stride,
                 int log_n, int k, int t, int use_scale, fp::Fe scale) {
  extern __shared__ uint4 sm[];
  const int cols = 1 << t;
  const int row_stride = cols | 1;  // padded: see the note on shared memory
  const int elems = 1 << (k + t);
  uint4* row_tw = sm + ((long)row_stride << k);
  const long c0 = (long)blockIdx.x << t;

  // `block_source_index`, `block_shared_index`
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int c = e & (cols - 1);
    const uint32_t r = (uint32_t)(e >> t);
    fp::Fe v = fp::load(x, x_stride, ((long)r << (log_n - k)) + c0 + c);
    if (use_scale) v = fp::mont_mul(v, scale);
    sm[(int)(__brev(r) >> (32 - k)) * row_stride + c] = pack(v);
  }
  load_row_table(row_tw, tw, tw_stride, log_n, k);
  __syncthreads();

  tile_stages<false>(sm, row_stride, row_tw, nullptr, k, t);

  // `block_output_index`: threads along a column, runs of 2^k outputs
  const int high_bits = log_n - k;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int row = e & ((1 << k) - 1);
    const int c = e >> k;
    const uint32_t col = (uint32_t)(c0 + c);
    const long high = high_bits ? (long)(__brev(col) >> (32 - high_bits)) : 0L;
    fp::store(out, out_stride, (high << k) + row, unpack(sm[row * row_stride + c]));
  }
}

__global__ void __launch_bounds__(kMaxThreads)
ntt_stage_kernel(uint32_t* __restrict__ x, long stride,
                 const uint32_t* __restrict__ tw, long tw_stride,
                 int log_n, int s0, int k, int t) {
  extern __shared__ uint4 sm[];
  const int cols = 1 << t;
  const int elems = 1 << (k + t);
  uint4* row_tw = sm + elems;
  uint4* col_tw = row_tw + (1 << (k - 1));
  const long tile = blockIdx.x;
  const long c0 = (tile & ((1L << (s0 - t)) - 1)) << t;
  const long base = ((tile >> (s0 - t)) << (s0 + k)) + c0;

  // `stage_global_index`; shared index i * 2^t + c = e
  for (int e = threadIdx.x; e < elems; e += blockDim.x)
    sm[e] = pack(fp::load(x, stride, base + ((long)(e >> t) << s0) + (e & (cols - 1))));
  load_row_table(row_tw, tw, tw_stride, log_n, k);
  // column factors of stage s0+u: col[c]^(2^(k-u)), by squaring from u = k;
  // col[c] = w_(2^(s0+k))^c out of the master table (`master_index`)
  if ((int)threadIdx.x < cols) {
    fp::Fe a = fp::load(tw, tw_stride, (c0 + threadIdx.x) << (log_n - s0 - k));
    for (int u = k; u >= 1; --u) {
      col_tw[(u - 1) * cols + threadIdx.x] = pack(a);
      a = fp::mont_mul(a, a);
    }
  }
  __syncthreads();

  tile_stages<true>(sm, cols, row_tw, col_tw, k, t);

  for (int e = threadIdx.x; e < elems; e += blockDim.x)
    fp::store(x, stride, base + ((long)(e >> t) << s0) + (e & (cols - 1)), unpack(sm[e]));
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
// order (optionally times `scale`), writes out. Tiles of 2^log_block rows by
// 2^log_cols source columns, min(2^log_threads, pairs of a tile) threads.
// 1 <= log_block <= log_n <= 31, log_cols <= log_n - log_block. tw: planes
// of the master table [w^e : e < 2^(log_n-1)] of the 2^log_n-point transform.
extern "C" int ntt_block(const uint32_t* x, long x_stride, uint32_t* out,
                         long out_stride, const uint32_t* tw,
                         long tw_stride, int log_n, int log_block,
                         int log_cols, int log_threads, int use_scale,
                         uint32_t s0, uint32_t s1, uint32_t s2, uint32_t s3,
                         cudaStream_t stream) {
  if (log_n < 1 || log_n > 31 || log_block < 1 || log_block > log_n ||
      log_cols < 0 || log_cols > log_n - log_block || log_threads < log_cols ||
      (1 << log_threads) > kMaxThreads || log_block + log_cols > 20)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint4) * ((((size_t)1 << log_cols) | 1) << log_block) +
                      sizeof(uint4) * ((size_t)1 << (log_block - 1));
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        ntt_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  fp::Fe scale;
  scale.w[0] = s0;
  scale.w[1] = s1;
  scale.w[2] = s2;
  scale.w[3] = s3;
  const int log_pairs = log_block - 1 + log_cols;
  const unsigned threads = 1u << (log_pairs < log_threads ? log_pairs : log_threads);
  const unsigned blocks = 1u << (log_n - log_block - log_cols);
  ntt_block_kernel<<<blocks, threads, smem, stream>>>(
      x, x_stride, out, out_stride, tw, tw_stride, log_n, log_block,
      log_cols, use_scale, scale);
  return (int)cudaGetLastError();
}

// Stages s..last of a 2^log_n-point transform in ONE pass, in place. Tiles of
// 2^(last-s+1) rows by 2^log_cols columns, log_cols <= s - 1. tw: planes of
// the master table [w^e : e < 2^(log_n-1)] of the 2^log_n-point transform.
extern "C" int ntt_stage(uint32_t* x, long stride, const uint32_t* tw,
                         long tw_stride, int log_n, int s, int last,
                         int log_cols, int log_threads, cudaStream_t stream) {
  if (log_n < 1 || log_n > 31 || s < 1 || last < s || last > log_n ||
      log_cols < 0 || log_cols > s - 1 || log_threads < log_cols ||
      (1 << log_threads) > kMaxThreads || last - s + 1 + log_cols > 20)
    return (int)cudaErrorInvalidValue;
  const int k = last - s + 1;
  const size_t smem =
      sizeof(uint4) * (((size_t)1 << (k + log_cols)) + ((size_t)1 << (k - 1)) +
                       ((size_t)k << log_cols));
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        ntt_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int log_pairs = k - 1 + log_cols;
  const unsigned threads = 1u << (log_pairs < log_threads ? log_pairs : log_threads);
  const unsigned blocks = 1u << (log_n - k - log_cols);
  ntt_stage_kernel<<<blocks, threads, smem, stream>>>(
      x, stride, tw, tw_stride, log_n, s - 1, k, log_cols);
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
