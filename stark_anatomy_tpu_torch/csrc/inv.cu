// fp_batch_inv: the batched field inverse, Montgomery form in and out, 0 -> 0,
// in 2 L + 1 launches for a plan of L + 1 levels (5 at n = 2^24).
//
// Replaces stark_anatomy_tpu/ops/field_pallas.py `inv` (:401). There,
// Montgomery's batch inversion is jax.lax.scan over the Pallas product kernel
// (`_batch_inv_nonzero`, :364: a forward scan of exclusive prefixes over 128
// column groups, the group totals inverted recursively, a backward scan) with
// the addition chain `_inv_ladder` (:315) at its base, all inside one jit.
// Launched one product at a time from Python that is ~760 product launches
// and ~260 copies a call; here the scans are loops of a thread and the
// recursion is the levels of ops/field_kernels.py `inv_plan`.
//
// Bound on an H100 at n = 2^24: BYTES. The least work is one read and one
// write of 16 B an element (0.160 ms at 3.35 TB/s) beside 3 products an
// element (0.090 ms at 60 operations a product). This design reads the input
// twice (once for the products of the tiles, once to walk back): 48 B an
// element, 0.24 ms of traffic, and about 5 products an element at the tile
// of 4 x 128 (the block trees run in part-empty warps).
//
// Design. A level of m elements is cut into tiles of K * B elements, one
// block of B threads each: K = 4, B = 128, the fastest of K in {4, 8, 16} x
// B in {64, 128, 256} at n = 2^24 on an H100 (ops/field_kernels.py
// INV_PER_THREAD / INV_THREADS are the same two numbers). Thread t owns the
// elements k * B + t of its tile (k = 0..K-1), so every load and store of a
// warp is one coalesced run. The products are taken thread-major (thread
// 0's K elements, then thread 1's, ...), a permutation of the index order;
// the inverse of a unit is unique, so the order does not show in the result.
//  up    each thread takes the product of its K elements in registers; a
//        product tree over the block's threads in shared memory (heap order:
//        node i = node 2i * node 2i+1, the threads' products at the leaves
//        B..2B-1) leaves the tile's product at the root, written to
//        totals[block]: the next level's input.
//  base  the last level fits one block: each thread inverts the product of
//        its own elements by the addition chain of field.cuh (143 products;
//        the threads run it side by side, so it costs the latency of one
//        chain) and walks back.
//  down  each block reads the inverse of its tile's product from
//        totals[block] (the level above has put the inverses over the
//        products), rebuilds the tree and walks it down in place (node 2i <-
//        inv(i) * node 2i+1, node 2i+1 <- inv(i) * node 2i), which leaves at
//        each leaf the inverse of that thread's product. The thread keeps its
//        elements x_k and forward prefixes L_k = x_0 .. x_k in registers
//        (rather than writing them out in the up pass and reading them back)
//        and walks back from c = L_{K-1}^-1: x_k^-1 = c * L_{k-1}, then
//        c <- c * x_k; x_0^-1 is the last c.
// The word pattern 0 counts as 1 inside the products and is written as 0;
// positions past the end count as 1 and are not written. Inputs must be
// canonical, as field_pallas.py's `inv` assumes too: a non-canonical zero
// (the pattern p) would zero every product of its tile. Above level 0 the
// base and down phases write the inverses over the products they read
// (x == out): each element is read and then written by the same thread.
#include "field.cuh"

namespace {

constexpr int K = 4;    // elements a thread
constexpr int B = 128;  // threads a block
constexpr long kTile = (long)K * B;

// A product tree of 2B - 1 nodes in shared memory, as four word planes of 2B.
struct Tree {
  uint32_t (&s)[4][2 * B];
  __device__ __forceinline__ fp::Fe get(int i) const {
    fp::Fe r;
#pragma unroll
    for (int j = 0; j < 4; ++j) r.w[j] = s[j][i];
    return r;
  }
  __device__ __forceinline__ void put(int i, const fp::Fe& v) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][i] = v.w[j];
  }
};

// Nodes `lowest`..B-1 of the tree over the B leaves (written by the caller).
__device__ __forceinline__ void tree_up(const Tree& tree, int t, int lowest) {
  for (int half = B >> 1; half >= lowest; half >>= 1) {
    __syncthreads();
    if (t < half) {
      const int i = half + t;
      tree.put(i, fp::mont_mul(tree.get(2 * i), tree.get(2 * i + 1)));
    }
  }
}

// Loads thread t's K elements of the tile at `first` (zeros and positions
// past the end as 1); bit k of the result is set where element k is 0.
__device__ __forceinline__ unsigned load_tile(const uint32_t* x, long x_stride, long n,
                                              long first, fp::Fe (&y)[K]) {
  const fp::Fe one = fp::mont_one();
  unsigned zero = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long i = first + (long)k * B;
    y[k] = one;
    if (i < n) {
      const fp::Fe v = fp::load(x, x_stride, i);
      if ((v.w[0] | v.w[1] | v.w[2] | v.w[3]) == 0u)
        zero |= 1u << k;
      else
        y[k] = v;
    }
  }
  return zero;
}

// L_k = y_0 .. y_k; from c = L_{K-1}^-1 back to the inverses of y, written
// to `out` (0 where the input was 0).
__device__ __forceinline__ void walk_back(fp::Fe (&y)[K], const fp::Fe (&L)[K], fp::Fe c,
                                          unsigned zero, uint32_t* out, long out_stride,
                                          long n, long first) {
#pragma unroll
  for (int k = K - 1; k >= 1; --k) {
    const fp::Fe inv_k = fp::mont_mul(c, L[k - 1]);
    c = fp::mont_mul(c, y[k]);
    y[k] = inv_k;
  }
  y[0] = c;
  const fp::Fe zero_fe = {{0u, 0u, 0u, 0u}};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long i = first + (long)k * B;
    if (i < n) fp::store(out, out_stride, i, ((zero >> k) & 1u) ? zero_fe : y[k]);
  }
}

__device__ __forceinline__ void prefixes(const fp::Fe (&y)[K], fp::Fe (&L)[K]) {
  L[0] = y[0];
#pragma unroll
  for (int k = 1; k < K; ++k) L[k] = fp::mont_mul(L[k - 1], y[k]);
}

__global__ void __launch_bounds__(B) fp_inv_up_kernel(const uint32_t* x, long x_stride, long n,
                                                      uint32_t* totals, long totals_stride) {
  __shared__ uint32_t shared[4][2 * B];
  const int t = threadIdx.x;
  fp::Fe y[K];
  load_tile(x, x_stride, n, blockIdx.x * kTile + t, y);
  // the thread's product as a pairwise tree: depth log2 K, not K - 1
#pragma unroll
  for (int w = 1; w < K; w <<= 1) {
#pragma unroll
    for (int k = 0; k + w < K; k += 2 * w) y[k] = fp::mont_mul(y[k], y[k + w]);
  }
  const Tree tree{shared};
  tree.put(B + t, y[0]);
  tree_up(tree, t, 1);
  if (t == 0) fp::store(totals, totals_stride, blockIdx.x, tree.get(1));
}

__global__ void __launch_bounds__(B) fp_inv_base_kernel(const uint32_t* x, long x_stride, long n,
                                                        uint32_t* out, long out_stride) {
  const int t = threadIdx.x;
  fp::Fe y[K], L[K];
  const unsigned zero = load_tile(x, x_stride, n, t, y);
  prefixes(y, L);
  walk_back(y, L, fp::inv_chain(L[K - 1]), zero, out, out_stride, n, t);
}

__global__ void __launch_bounds__(B) fp_inv_down_kernel(const uint32_t* x, long x_stride, long n,
                                                        const uint32_t* totals, long totals_stride,
                                                        uint32_t* out, long out_stride) {
  __shared__ uint32_t shared[4][2 * B];
  const int t = threadIdx.x;
  const long first = blockIdx.x * kTile + t;
  fp::Fe y[K], L[K];
  const unsigned zero = load_tile(x, x_stride, n, first, y);
  prefixes(y, L);
  const Tree tree{shared};
  tree.put(B + t, L[K - 1]);
  tree_up(tree, t, 2);  // the root's product is known: its inverse comes in
  if (t == 0) tree.put(1, fp::load(totals, totals_stride, blockIdx.x));
  for (int half = 1; half < B; half <<= 1) {
    __syncthreads();
    if (t < half) {
      const int i = half + t;
      const fp::Fe v = tree.get(i), l = tree.get(2 * i), r = tree.get(2 * i + 1);
      tree.put(2 * i, fp::mont_mul(v, r));
      tree.put(2 * i + 1, fp::mont_mul(v, l));
    }
  }
  __syncthreads();
  walk_back(y, L, tree.get(B + t), zero, out, out_stride, n, first);
}

}  // namespace

// One phase of one level (ops/field_kernels.py `inv_plan`): phase 0 (up)
// writes the products of the tiles of x to totals; phase 1 (base, n <= K *
// B) writes the inverses of x to out; phase 2 (down) reads the inverses of
// those products from totals and writes the inverses of x to out. `out` may
// be `x`. Returns cudaGetLastError() of the launch.
extern "C" int fp_batch_inv(const uint32_t* x, long x_stride, long n, uint32_t* totals,
                            long totals_stride, uint32_t* out, long out_stride, int phase,
                            cudaStream_t stream) {
  const long blocks = (n + kTile - 1) / kTile;
  if (n <= 0 || phase < 0 || phase > 2 || (phase == 1 && blocks != 1))
    return (int)cudaErrorInvalidValue;
  if (phase == 0)
    fp_inv_up_kernel<<<(unsigned)blocks, B, 0, stream>>>(x, x_stride, n, totals, totals_stride);
  else if (phase == 1)
    fp_inv_base_kernel<<<1, B, 0, stream>>>(x, x_stride, n, out, out_stride);
  else
    fp_inv_down_kernel<<<(unsigned)blocks, B, 0, stream>>>(x, x_stride, n, totals, totals_stride,
                                                           out, out_stride);
  return (int)cudaGetLastError();
}
