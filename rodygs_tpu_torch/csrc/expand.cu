// Fragment expansion: packed per-gaussian table -> (sort key, record rows).
//
// Replaces the Pallas kernel `_expand_kernel` launched by
// `expand_fragments` (rodygs_tpu/render/compact.py). For every fragment
// slot i < C it finds the owner gaussian m(i) — the last window column
// whose fragment offset is <= i, inside the 640-column window that starts
// at bases[i / 512] — derives the fragment's tile (rect enumeration, or the
// per-tile-row spans of rows mode), and writes the packed key
// ((tile << db) | depth_bits) ^ 0x80000000 (INT32_MAX for a slot that
// carries no fragment). The record rows of m(i), 10 or 13 of them, are
// written only for slots i < f_kept that have an owner: the rest sort
// behind every tile range and nothing reads their records.
//
// Bound on the H100: memory; there is almost no arithmetic. What a render
// needs is the key of every slot, the emitted rows of the filled slots and
// the table words of the columns that own one. Design, one block of 512
// threads per 512-slot chunk, one thread per slot:
//  - a chunk at or past f_kept (read from device memory, no host
//    synchronisation) writes its 512 keys as 128 int4 and returns;
//  - the window's 640 offsets are read from device memory once per chunk,
//    coalesced, into shared memory, and every slot finds its owner there
//    with a ten-probe binary search: all probes of a chunk hit one 2.5 KB
//    array instead of going to L1/L2 with ten dependent loads per slot.
//    (Head marks scattered by the window's columns and a block max-scan
//    give the same owners with no search; with their three barriers they
//    measured 5-7% slower than the search in shared memory.)
//  - each slot then reads its owner's 14 table words (rect) or up to 24
//    (rows mode: the mode flag, the 8 row offsets and one row start) with
//    independent read-only loads. Neighbouring slots share or neighbour
//    their owners, so a warp's 32 loads of one row fall into one or two
//    32-byte sectors and L1 serves the repeats: a column's words leave L2
//    about once per warp that touches it, as a staged copy would;
//  - stores are one full 128-byte line per warp and row.
// Key arithmetic is done in uint32 and then reinterpreted, so `tile << db`
// reaching bit 31 is well defined. The float compare `off <= i` is the
// plain version's: offsets are whole numbers below 2^24.
#include "common.cuh"

using namespace rodygs;

constexpr int CHUNK_THREADS = FCHUNK;   // one thread per slot of a chunk
constexpr int INVALID_KEY = 0x7fffffff;

template <bool ROWS_MODE, int N_ROWS>
__global__ void __launch_bounds__(CHUNK_THREADS, 4)
expand_kernel(const float* __restrict__ table, int nw,
              const int* __restrict__ bases,
              const int* __restrict__ f_kept_ptr, int tiles_x, int db,
              int* __restrict__ key, float* __restrict__ rec) {
  __shared__ float s_off[WIN];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * FCHUNK;
  const int i = i0 + tid;
  const int capacity = gridDim.x * FCHUNK;
  const int f_kept = *f_kept_ptr;
  if (i0 >= f_kept) {
    if (tid < FCHUNK / 4)
      reinterpret_cast<int4*>(key + i0)[tid] =
          make_int4(INVALID_KEY, INVALID_KEY, INVALID_KEY, INVALID_KEY);
    return;
  }
  const int base = bases[blockIdx.x];
  const float* off_row = table + (size_t)ROW_OFF * nw + base;
  for (int c = tid; c < WIN; c += CHUNK_THREADS) s_off[c] = __ldg(off_row + c);
  __syncthreads();
  // last w in [0, WIN) with off[base + w] <= i (the off row is increasing)
  const float fi = (float)i;
  int lo = 0, hi = WIN;  // invariant: answer in [lo - 1, hi - 1]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_off[mid] <= fi) lo = mid + 1; else hi = mid;
  }
  const int w = lo - 1;
  if (w < 0 || i >= f_kept) {
    key[i] = INVALID_KEY;
    return;
  }
  const float* col = table + base + w;
  auto at = [&](int row) { return __ldg(col + (size_t)row * nw); };

  float r[N_ROWS];
#pragma unroll
  for (int j = 0; j < N_ROWS; ++j) r[j] = at(j);
  const int span_w = (int)at(ROW_SPANW);
  const int base_tile = (int)at(ROW_BASE_TILE);
  const uint32_t dbits = (uint32_t)(int)at(ROW_DBITS);
  const int k = i - (int)s_off[w];
  int tile;
  bool valid;
  if (ROWS_MODE && at(ROW_RMODE) > 0.5f) {
    // tile row: the last j with rowoff_j <= k; column from its txlo
    int row = -1, rowoff_r = 0;
#pragma unroll
    for (int j = 0; j < ROW_SPAN_MAX; ++j) {
      const int rowoff = (int)at(ROW_ROWOFF0 + j);
      if (rowoff <= k) {
        row = j;
        rowoff_r = rowoff;
      }
    }
    const int txlo_r = row >= 0 ? (int)at(ROW_TXLO0 + row) : 0;
    tile = base_tile + row * tiles_x + txlo_r + (k - rowoff_r);
    valid = true;
  } else {
    const int sw = span_w > 1 ? span_w : 1;
    const int ky = k / sw;
    tile = base_tile + ky * tiles_x + (k - ky * sw);
    valid = span_w > 0;
  }
  const uint32_t packed = (((uint32_t)tile << db) | dbits) ^ 0x80000000u;
  key[i] = valid ? (int)packed : INVALID_KEY;
#pragma unroll
  for (int j = 0; j < N_ROWS; ++j) rec[(size_t)j * capacity + i] = r[j];
}

// variant = 2 * rows_mode + (13 rows emitted)
template <typename F>
static int for_variant(int rows_mode, int n_rows, F&& f) {
  if (n_rows != 10 && n_rows != NUM_REC_ROWS) return (int)cudaErrorInvalidValue;
  if (rows_mode)
    return n_rows == 10 ? f(expand_kernel<true, 10>)
                        : f(expand_kernel<true, NUM_REC_ROWS>);
  return n_rows == 10 ? f(expand_kernel<false, 10>)
                      : f(expand_kernel<false, NUM_REC_ROWS>);
}

extern "C" int rodygs_expand(const float* table, int nw, const int* bases,
                             int num_chunks, const int* f_kept, int tiles_x,
                             int db, int rows_mode, int n_rows, int* key,
                             float* rec, cudaStream_t stream) {
  if (num_chunks <= 0) return (int)cudaSuccess;
  if (reinterpret_cast<uintptr_t>(key) % 16 != 0)   // the int4 key stores
    return (int)cudaErrorMisalignedAddress;
  return for_variant(rows_mode, n_rows, [&](auto kernel) {
    kernel<<<num_chunks, CHUNK_THREADS, 0, stream>>>(
        table, nw, bases, f_kept, tiles_x, db, key, rec);
    return (int)cudaGetLastError();
  });
}

// Resident blocks per SM of one instantiation: the runtime's count.
extern "C" int rodygs_expand_blocks_per_sm(int variant) {
  return for_variant(variant >> 1, (variant & 1) ? NUM_REC_ROWS : 10,
                     [&](auto kernel) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, CHUNK_THREADS, 0);
    return err == cudaSuccess ? blocks : -(int)err;
  });
}
