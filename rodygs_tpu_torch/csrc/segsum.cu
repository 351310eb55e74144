// Segment sum: presort-order per-fragment gradient rows -> per-gaussian rows.
//
// Replaces the Pallas kernel `_segsum_kernel` launched by
// `segment_sum_rows` (rodygs_tpu/render/compact.py). Fragments are
// enumerated gaussian-major, so column g of the table owns the contiguous
// slot range [off[g], off[g+1]) (pad columns carry offsets >= 2e7 and own
// nothing). Slots at or past f_kept hold no fragment; ranges are clamped to
// [0, f_kept) and nothing there is read. out[r, g] is the sum of d[r, i]
// over the clamped range, and every out[r, g] is written exactly once, the
// zeros of columns without a filled slot included: the caller fills nothing.
//
// Bound on the H100: memory (each word of the filled slots read once, one
// add per word, each output word written once). Design: one block of 256
// threads per 512-slot chunk; a range is summed and written by the block
// whose chunk holds its head slot.
//  - Reads are parallel over slots: thread t copies slots t and t + 256 of
//    every row into shared memory, a full 128-byte line per warp and row.
//    These loads start first and wait for nothing but f_kept; the
//    window's 641 offsets are staged beside them, once per chunk, so a
//    block makes one round trip to device memory before it sums.
//  - Sums are formed from shared memory, where an unaligned walk costs
//    nothing: thread w takes window columns w, w + 256, ..., and a range of
//    up to 32 slots is summed by its thread, in slot order. Neighbouring
//    threads hold neighbouring columns, so the stores are coalesced.
//  - Work stays balanced by slots: a range longer than 32 slots goes on a
//    list and is summed by a whole warp (lanes stride over its slots, five
//    shuffle steps close the sum). The chunk's last range may run on beyond
//    the chunk: the 32 slots after the chunk are staged with it, which
//    closes nearly every such range, and what lies further on is summed
//    from device memory by as many warps as it has 32-slot pieces, their
//    sums added in warp order. A range of 500 slots costs about what 500
//    ranges of one slot cost. (The blocks further on stage those slots too
//    and never sum them: a word is read once, or twice when it follows a
//    chunk edge by less than 32 slots or its range began in an earlier
//    chunk.)
//  - Every order is fixed: no floating-point atomics, two runs give the
//    same bits. (The list's order may vary; each entry's sum does not
//    depend on it.)
//  - Columns whose offset lies at or past the capacity (dropped gaussians
//    beyond it, pad columns) have no chunk: a second set of blocks walks the
//    offsets row from its end, writes their zeros, and stops at the first
//    256 columns that hold none.
// Measured against this and slower: a segmented shuffle scan over the slots
// with carries between warps (50 shuffles and five barriers a block), 512
// threads a block, staging only after the window has named the block's
// slots (each word then read once, at the price of a second round trip),
// float4 staging loads, and streaming cache hints.
#include <math.h>
#include "common.cuh"

using namespace rodygs;

constexpr int CHUNK_THREADS = 256;   // two slots of the chunk per thread
constexpr int CHUNK_WARPS = CHUNK_THREADS / 32;
constexpr int SERIAL_MAX = 32;   // longer ranges are summed by a warp
constexpr int APRON = 32;        // slots staged beyond the chunk's end

template <int N_ROWS>
__device__ __forceinline__ void warp_sum(float (&t)[N_ROWS]) {
#pragma unroll
  for (int r = 0; r < N_ROWS; ++r) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      t[r] += __shfl_xor_sync(0xffffffffu, t[r], m);
  }
}

template <int N_ROWS>
__global__ void __launch_bounds__(CHUNK_THREADS, 8)
segsum_kernel(const float* __restrict__ d, int C,
              const float* __restrict__ off, int nw,
              const int* __restrict__ bases, int num_chunks,
              const int* __restrict__ f_kept_ptr, float* __restrict__ out) {
  __shared__ float s_d[N_ROWS][FCHUNK + APRON];   // the slots, row by row
  __shared__ float s_off[WIN + 1];          // window offsets and the next one
  __shared__ float s_spill[CHUNK_WARPS][N_ROWS];
  __shared__ int s_long[(FCHUNK + APRON) / SERIAL_MAX];   // long ranges
  __shared__ int s_num_long, s_last_col;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if ((int)blockIdx.x >= num_chunks) {
    // columns without a chunk, from the end of the offsets row
    const int top = nw - 1 - ((int)blockIdx.x - num_chunks) * CHUNK_THREADS;
    if (__ldg(off + top) < (float)C) return;   // offsets increase: none here
    const int g = top - tid;
    if (g >= 0 && __ldg(off + g) >= (float)C) {
#pragma unroll
      for (int r = 0; r < N_ROWS; ++r) out[(size_t)r * nw + g] = 0.f;
    }
    return;
  }

  const int i0 = blockIdx.x * FCHUNK, i1 = i0 + FCHUNK;
  const int end = min(*f_kept_ptr, C);
  const int base = bases[blockIdx.x];
  // stage the chunk's filled slots first: nothing but f_kept holds these
  // loads back; slots at or past f_kept read as zero
  for (int q = tid; q < FCHUNK; q += CHUNK_THREADS) {
#pragma unroll
    for (int r = 0; r < N_ROWS; ++r)
      s_d[r][q] = i0 + q < end ? __ldg(d + (size_t)r * C + i0 + q) : 0.f;
  }
  // and the 32 slots after the chunk: the chunk's last range most often
  // ends there, and is then closed without a second trip to device memory
  if (tid < APRON) {
#pragma unroll
    for (int r = 0; r < N_ROWS; ++r)
      s_d[r][FCHUNK + tid] =
          i1 + tid < end ? __ldg(d + (size_t)r * C + i1 + tid) : 0.f;
  }
  for (int c = tid; c < WIN; c += CHUNK_THREADS)
    s_off[c] = __ldg(off + base + c);
  if (tid == 0) {
    // behind the window: the end of its last column's range (the table's
    // last column ends at f_kept)
    s_off[WIN] = base + WIN < nw ? __ldg(off + base + WIN) : INFINITY;
    s_num_long = 0;
    s_last_col = -1;
  }
  __syncthreads();

  // the window columns whose range starts in this chunk are this block's
  const float lo_f = (float)i0, hi_f = (float)i1;
  if (i0 >= end) {   // no filled slot here: the heads of this chunk get zeros
    for (int c = tid; c < WIN; c += CHUNK_THREADS) {
      if (s_off[c] >= lo_f && s_off[c] < hi_f) {
#pragma unroll
        for (int r = 0; r < N_ROWS; ++r) out[(size_t)r * nw + base + c] = 0.f;
      }
    }
    return;
  }
  for (int c = tid; c < WIN; c += CHUNK_THREADS) {
    const float o = s_off[c];
    if (o >= lo_f && o < hi_f && s_off[c + 1] >= hi_f) s_last_col = c;
  }
  __syncthreads();

  // what the chunk's last range holds beyond the staged slots, up to f_kept
  const int last_col = s_last_col;
  int spill = 0;
  if (last_col >= 0)
    spill = (int)fminf(s_off[last_col + 1], (float)end) - (i1 + APRON);
  if (warp * 32 < spill) {   // uniform over the warp
    float t[N_ROWS];
#pragma unroll
    for (int r = 0; r < N_ROWS; ++r) t[r] = 0.f;
    for (int j = tid; j < spill; j += CHUNK_THREADS) {
#pragma unroll
      for (int r = 0; r < N_ROWS; ++r)
        t[r] += __ldg(d + (size_t)r * C + i1 + APRON + j);
    }
    warp_sum<N_ROWS>(t);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < N_ROWS; ++r) s_spill[warp][r] = t[r];
    }
  }
  __syncthreads();

  // `sum` plus, for the chunk's last range, what lies beyond the staged slots
  auto write = [&](int c, const float (&sum)[N_ROWS]) {
#pragma unroll
    for (int r = 0; r < N_ROWS; ++r) {
      float v = sum[r];
      if (c == last_col)
        for (int k = 0; k < CHUNK_WARPS && 32 * k < spill; ++k)
          v += s_spill[k][r];
      out[(size_t)r * nw + base + c] = v;
    }
  };

  for (int c = tid; c < WIN; c += CHUNK_THREADS) {
    const float o = s_off[c];
    if (!(o >= lo_f && o < hi_f)) continue;
    const int lo = (int)o - i0;
    const int hi = (int)fminf(s_off[c + 1], hi_f + APRON) - i0;   // staged
    if (hi - lo > SERIAL_MAX) {
      s_long[atomicAdd(&s_num_long, 1)] = c;
      continue;
    }
    float sum[N_ROWS];
#pragma unroll
    for (int r = 0; r < N_ROWS; ++r) sum[r] = 0.f;
    for (int j = lo; j < hi; ++j) {
#pragma unroll
      for (int r = 0; r < N_ROWS; ++r) sum[r] += s_d[r][j];
    }
    write(c, sum);
  }
  __syncthreads();

  for (int n = warp; n < s_num_long; n += CHUNK_WARPS) {
    const int c = s_long[n];
    const int lo = (int)s_off[c] - i0;
    const int hi = (int)fminf(s_off[c + 1], hi_f + APRON) - i0;
    float sum[N_ROWS];
#pragma unroll
    for (int r = 0; r < N_ROWS; ++r) sum[r] = 0.f;
    for (int j = lo + lane; j < hi; j += 32) {
#pragma unroll
      for (int r = 0; r < N_ROWS; ++r) sum[r] += s_d[r][j];
    }
    warp_sum<N_ROWS>(sum);
    if (lane == 0) write(c, sum);
  }
}

template <typename F>
static int for_rows(int n_rows, F&& f) {
  if (n_rows == 10) return f(segsum_kernel<10>);
  if (n_rows == NUM_REC_ROWS) return f(segsum_kernel<NUM_REC_ROWS>);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rodygs_segsum(const float* d, int n_rows, int C,
                             const float* off_row, int nw, const int* bases,
                             const int* f_kept, float* out,
                             cudaStream_t stream) {
  const int num_chunks = C / FCHUNK;
  if (num_chunks * FCHUNK != C || nw < WIN) return (int)cudaErrorInvalidValue;
  const int zero_blocks = (nw + CHUNK_THREADS - 1) / CHUNK_THREADS;
  return for_rows(n_rows, [&](auto kernel) {
    kernel<<<num_chunks + zero_blocks, CHUNK_THREADS, 0, stream>>>(
        d, C, off_row, nw, bases, num_chunks, f_kept, out);
    return (int)cudaGetLastError();
  });
}

// Resident blocks per SM of one instantiation (variant: 13 rows summed).
extern "C" int rodygs_segsum_blocks_per_sm(int variant) {
  return for_rows(variant ? NUM_REC_ROWS : 10, [&](auto kernel) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, CHUNK_THREADS, 0);
    return err == cudaSuccess ? blocks : -(int)err;
  });
}
