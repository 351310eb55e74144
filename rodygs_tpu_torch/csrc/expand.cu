// Fragment expansion: packed per-gaussian table -> (sort key, record rows).
//
// Replaces the Pallas kernel `_expand_kernel` launched by
// `expand_fragments` (rodygs_tpu/render/compact.py). For every fragment
// slot i < C it finds the owner gaussian m(i) — the last window column
// whose fragment offset is <= i, inside the 640-column window that starts
// at bases[i / 512] — derives the fragment's tile (rect enumeration, or the
// per-tile-row spans of rows mode), and writes the packed key
// ((tile << db) | depth_bits) ^ 0x80000000 (INT32_MAX for an invalid slot)
// and the 13 record rows of m(i).
//
// Bound on the H100: memory. Each slot reads ~14-40 table words and writes
// 14 words; there is almost no arithmetic. The TPU kernel gathered with a
// one-hot [640, 512] matmul because the TPU has no fast gather; here one
// thread per slot binary-searches the window's offset row (10 probes, all
// L1/L2 hits: the 512 threads of a chunk share one window) and reads its
// gaussian's column directly. Writes are coalesced (consecutive threads,
// consecutive slots, field-major rows); the table reads of one warp touch
// a few neighbouring columns. Key arithmetic is done in uint32 and then
// reinterpreted, so `tile << db` reaching bit 31 is well defined.
#include "common.cuh"

using namespace rodygs;

__global__ void expand_kernel(const float* __restrict__ table, int nw,
                              const int* __restrict__ bases, int capacity,
                              const int* __restrict__ f_kept_ptr, int tiles_x,
                              int db, int rows_mode, int* __restrict__ key,
                              float* __restrict__ rec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= capacity) return;
  const int base = bases[i / FCHUNK];
  const float fi = (float)i;
  const float* off_row = table + (size_t)ROW_OFF * nw + base;
  // last w in [0, WIN) with off[base + w] <= i (the off row is increasing)
  int lo = 0, hi = WIN;  // invariant: answer in [lo - 1, hi - 1]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (off_row[mid] <= fi) lo = mid + 1; else hi = mid;
  }
  const int w = lo - 1;
  if (w < 0) {
    // no owner in the window: the one-hot gather of the TPU kernel yields
    // all-zero rows, and a zero span marks the slot invalid
    key[i] = 0x7fffffff;
    for (int r = 0; r < NUM_REC_ROWS; ++r) rec[(size_t)r * capacity + i] = 0.f;
    return;
  }
  const int g = base + w;
  auto col = [&](int row) { return table[(size_t)row * nw + g]; };

  const int k = i - (int)col(ROW_OFF);
  const int span_w = (int)col(ROW_SPANW);
  const int base_tile = (int)col(ROW_BASE_TILE);
  const int sw = span_w > 1 ? span_w : 1;
  const int ky = k / sw;
  const int kx = k - ky * sw;
  int tile = base_tile + ky * tiles_x + kx;
  bool valid = (span_w > 0);
  if (rows_mode && col(ROW_RMODE) > 0.5f) {
    // tile row: the last j with rowoff_j <= k; column from its txlo
    int r = -1;
    for (int j = 0; j < ROW_SPAN_MAX; ++j)
      if ((int)col(ROW_ROWOFF0 + j) <= k) r = j > r ? j : r;
    int rowoff_r = 0, txlo_r = 0;
    if (r >= 0) {
      rowoff_r = (int)col(ROW_ROWOFF0 + r);
      txlo_r = (int)col(ROW_TXLO0 + r);
    }
    tile = base_tile + r * tiles_x + txlo_r + (k - rowoff_r);
    valid = true;
  }
  valid = valid && (i < *f_kept_ptr);
  const uint32_t packed =
      (((uint32_t)tile << db) | (uint32_t)(int)col(ROW_DBITS)) ^ 0x80000000u;
  key[i] = valid ? (int)packed : 0x7fffffff;
  for (int r = 0; r < NUM_REC_ROWS; ++r)
    rec[(size_t)r * capacity + i] = col(r);
}

extern "C" int rodygs_expand(const float* table, int table_rows, int nw,
                             const int* bases, int num_chunks,
                             const int* f_kept, int tiles_x, int db,
                             int rows_mode, int* key, float* rec,
                             cudaStream_t stream) {
  (void)table_rows;
  const int capacity = num_chunks * FCHUNK;
  const int threads = 256;
  const int blocks = (capacity + threads - 1) / threads;
  expand_kernel<<<blocks, threads, 0, stream>>>(table, nw, bases, capacity,
                                                f_kept, tiles_x, db, rows_mode,
                                                key, rec);
  return (int)cudaGetLastError();
}
