// The K nearest targets of each query, by brute force: the rigidity loss's
// KNN (train/losses.py::rigidity, K = 8 over its sample of the store) and
// the scale prior's (ops/knn.py::mean_knn_sqdist, K = 4 with the
// self-match).
//
// Replaces no TPU kernel: the JAX package computes the KNN in plain XLA
// (rodygs_tpu/ops/knn.py: a product with an inner dimension of 3 and a
// running top-k). The port's plain version (ops/knn.py::knn_plain) writes
// each [4096, M] block of distances to device memory and runs a radix
// select over it, some 16 GiB of traffic a block.
//
// Bound on the H100: the FP32 instruction rate. The least work a (query,
// valid target) pair needs is three FMAs, |t|^2 - 2 q.t with |q|^2 moved
// into the query's limit, and a compare with that limit: 7 FP32
// operations, an FMA counting two; the norms are work per point, not per
// pair. No distance reaches device memory. Design:
//  - A thread holds QUERIES queries, each with its K best (distance, index)
//    pairs in registers, sorted ascending (K a template parameter). A
//    candidate enters only when it is nearer than the K-th, about
//    K ln(M / K) times a query in M, so the insertion (unrolled, by moves
//    under a predicate) lies off the hot path.
//  - Targets stream through shared memory in tiles of TILE float4s (x, y,
//    z, w), which the block builds as it stages them: w = |t|^2 (1 - 2^-19),
//    or +inf for a target that valid_mask rules out or that lies past M,
//    which never enters. Two buffers: the next tile's loads are in flight
//    while the block works on this one, one barrier a tile, whose vote
//    skips a tile without a valid target. Every thread reads the same word
//    at a time, which shared memory broadcasts. The targets (16 bytes
//    each) stay in the 50 MB L2.
//  - The hot path is a sieve of three FMAs a pair, s = w - 2 q.t, against
//    a limit kept per query, (K-th - |q|^2) + 2^-19 (|q|^2 + K-th). The
//    sieve's rounding errors and the exact form's together stay under 13
//    units of 2^-24 times |q|^2 + |t|^2 (as 2 |q.t| <= |q|^2 + |t|^2); the
//    margins, 32 such units in w and in the limit, exceed that, so every
//    candidate the exact form would admit passes the sieve, and nearly
//    nothing else. A warp branches once for GROUP candidates of a query,
//    on their minimum; a lane then computes the exact distance for each
//    candidate that passed, in ascending index, and offers it: the warp
//    makes as many passes as its busiest lane needs. The results are the
//    bits of a brute force that computes every pair exactly.
//  - The exact distance takes the plain version's association on the card,
//    in explicitly rounded operations that nvcc never contracts or
//    reorders: |q|^2 and |t|^2 as torch.sum forms them, the addend |q|^2 +
//    |t|^2, q.t as addmm's product forms it (x x', then FMAs of y y' and z
//    z'), the addend less twice it (the factor -2 carried by the query,
//    which is exact), clamped at 0. The neighbour sets differ from the
//    plain version's only among equal distances. No TF32, nothing below
//    FP32.
//  - Ties: each lane visits the targets in ascending index, and a
//    candidate enters or passes an entry only when strictly nearer, so of
//    equal distances the lower target index comes first. A slot that no
//    valid target fills keeps distance +inf and index -1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QUERIES = 2;              // queries a thread
constexpr int TILE = 512;               // targets a shared-memory tile
constexpr int FETCH = TILE / THREADS;   // targets a thread stages a tile
constexpr int GROUP = 8;                // candidates tested at once
// The sieve's margin: 32 units of 2^-24, relative.
constexpr float MARGIN = 1.9073486328125e-06f;

// (x x + z z) + y y: the order torch.sum takes over a last dimension of 3
// on the card
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)),
                   __fmul_rn(y, y));
}

// The distance as the plain version forms it: (|q|^2 + |t|^2) - 2 q.t,
// with (ax, ay, az) = -2 q.
__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float qn, float4 t) {
  float p = __fmul_rn(ax, t.x);
  p = __fmaf_rn(ay, t.y, p);
  p = __fmaf_rn(az, t.z, p);
  return __fadd_rn(__fadd_rn(qn, sq_norm(t.x, t.y, t.z)), p);
}

// The filter's value: |t|^2 (1 - 2^-19) - 2 q.t in three FMAs, t.w holding
// the first term (+inf for a target ruled out).
__device__ __forceinline__ float sieve(float ax, float ay, float az,
                                       float4 t) {
  return __fmaf_rn(ax, t.x, __fmaf_rn(ay, t.y, __fmaf_rn(az, t.z, t.w)));
}

// What sieve() must stay under for the candidate to be computed: the K-th
// best less |q|^2, widened by the margin.
__device__ __forceinline__ float sieve_limit(float kth, float qn) {
  return __fadd_rn(__fsub_rn(kth, qn), __fmul_rn(MARGIN, __fadd_rn(qn, kth)));
}

// Candidate j at unclamped distance c into the sorted K best.
template <int K>
__device__ __forceinline__ void offer(float (&d)[K], int (&ix)[K], float c,
                                      int j) {
  c = fmaxf(c, 0.f);
  if (!(c < d[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const float prev = d[s - 1];
    if (prev > c) {
      d[s] = prev;
      ix[s] = ix[s - 1];
    } else if (d[s] > c) {
      d[s] = c;
      ix[s] = j;
    }
  }
  if (d[0] > c) {
    d[0] = c;
    ix[0] = j;
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ query, int n,
           const float* __restrict__ targets, int m,
           const uint8_t* __restrict__ valid, float* __restrict__ out_d,
           int* __restrict__ out_i) {
  static_assert(K % 4 == 0, "rows are written as 16-byte vectors");
  static_assert(GROUP == 8, "the group's minimum is written out for 8");
  __shared__ float4 s_t[2][TILE];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * (THREADS * QUERIES) + tid;

  float ax[QUERIES], ay[QUERIES], az[QUERIES], qn[QUERIES], lim[QUERIES];
  float d[QUERIES][K];
  int ix[QUERIES][K];
#pragma unroll
  for (int q = 0; q < QUERIES; ++q) {
    // a thread past N repeats the last query and writes nothing
    const size_t i = min(first + q * THREADS, n - 1);
    const float x = __ldg(query + 3 * i), y = __ldg(query + 3 * i + 1),
                z = __ldg(query + 3 * i + 2);
    qn[q] = sq_norm(x, y, z);
    ax[q] = -2.f * x;
    ay[q] = -2.f * y;
    az[q] = -2.f * z;
    lim[q] = INFINITY;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d[q][s] = INFINITY;
      ix[q][s] = -1;
    }
  }

  float3 raw[FETCH];
  bool ok[FETCH];
  auto fetch = [&](int base) {
#pragma unroll
    for (int r = 0; r < FETCH; ++r) {
      const int j = base + r * THREADS + tid;
      ok[r] = j < m && (valid == nullptr || __ldg(valid + j) != 0);
      raw[r] = j < m ? make_float3(__ldg(targets + 3 * (size_t)j),
                                   __ldg(targets + 3 * (size_t)j + 1),
                                   __ldg(targets + 3 * (size_t)j + 2))
                     : make_float3(0.f, 0.f, 0.f);
    }
  };
  auto stage = [&](float4* buf) {
    int any = 0;
#pragma unroll
    for (int r = 0; r < FETCH; ++r) {
      const float3 t = raw[r];
      const float w = __fmul_rn(sq_norm(t.x, t.y, t.z), 1.f - MARGIN);
      buf[r * THREADS + tid] =
          make_float4(t.x, t.y, t.z, ok[r] ? w : INFINITY);
      any |= ok[r];
    }
    return any;
  };

  const int num_tiles = (m + TILE - 1) / TILE;
  int live = 0;
  if (num_tiles > 0) {
    fetch(0);
    live = __syncthreads_or(stage(s_t[0]));
  }
  for (int t = 0; t < num_tiles; ++t) {
    const bool more = t + 1 < num_tiles;
    if (more) fetch((t + 1) * TILE);
    if (live) {   // uniform over the block: the barrier's vote
      const float4* buf = s_t[t & 1];
      const int base = t * TILE;
#pragma unroll 4
      for (int g = 0; g < TILE; g += GROUP) {
        float f[QUERIES][GROUP];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const float4 tg = buf[g + u];
#pragma unroll
          for (int q = 0; q < QUERIES; ++q)
            f[q][u] = sieve(ax[q], ay[q], az[q], tg);
        }
#pragma unroll
        for (int q = 0; q < QUERIES; ++q) {
          const float lo = fminf(
              fminf(fminf(f[q][0], f[q][1]), fminf(f[q][2], f[q][3])),
              fminf(fminf(f[q][4], f[q][5]), fminf(f[q][6], f[q][7])));
          if (lo < lim[q]) {
            unsigned pass = 0;   // the lane's candidates that passed
#pragma unroll
            for (int u = 0; u < GROUP; ++u)
              pass |= (f[q][u] < lim[q] ? 1u : 0u) << u;
            while (pass) {
              const int u = __ffs(pass) - 1;
              pass &= pass - 1;
              offer<K>(d[q], ix[q],
                       sq_dist(ax[q], ay[q], az[q], qn[q], buf[g + u]),
                       base + g + u);
              lim[q] = sieve_limit(d[q][K - 1], qn[q]);
            }
          }
        }
      }
    }
    int next = 0;
    if (more) next = stage(s_t[(t + 1) & 1]);
    live = __syncthreads_or(next);
  }

#pragma unroll
  for (int q = 0; q < QUERIES; ++q) {
    const int i = first + q * THREADS;
    if (i >= n) continue;
    float4* od = reinterpret_cast<float4*>(out_d + (size_t)i * K);
    int4* oi = reinterpret_cast<int4*>(out_i + (size_t)i * K);
#pragma unroll
    for (int s = 0; s < K; s += 4) {
      od[s / 4] = make_float4(d[q][s], d[q][s + 1], d[q][s + 2], d[q][s + 3]);
      oi[s / 4] = make_int4(ix[q][s], ix[q][s + 1], ix[q][s + 2],
                            ix[q][s + 3]);
    }
  }
}

template <typename F>
int for_k(int k, F&& f) {
  if (k == 4) return f(knn_kernel<4>);
  if (k == 8) return f(knn_kernel<8>);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// query [n, 3], targets [m, 3] float32; valid [m] bytes (0: ruled out) or
// null; out_d [n, k] float32 and out_i [n, k] int32, ascending. k is 4 or 8.
extern "C" int rodygs_knn(const float* query, int n, const float* targets,
                          int m, const uint8_t* valid, int k, float* out_d,
                          int* out_i, cudaStream_t stream) {
  if (n <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS * QUERIES - 1) / (THREADS * QUERIES);
  return for_k(k, [&](auto kernel) {
    kernel<<<blocks, THREADS, 0, stream>>>(query, n, targets, m, valid,
                                           out_d, out_i);
    return (int)cudaGetLastError();
  });
}

// Resident blocks per SM of one instantiation (variant: 0 for K = 4, 1 for
// K = 8).
extern "C" int rodygs_knn_blocks_per_sm(int variant) {
  return for_k(variant ? 8 : 4, [&](auto kernel) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, THREADS, 0);
    return err == cudaSuccess ? blocks : -(int)err;
  });
}
