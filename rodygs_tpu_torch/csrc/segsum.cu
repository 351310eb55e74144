// Segment sum: presort-order per-fragment gradient rows -> per-gaussian rows.
//
// Replaces the Pallas kernel `_segsum_kernel` launched by
// `segment_sum_rows` (rodygs_tpu/render/compact.py). Fragments are
// enumerated gaussian-major, so gaussian g owns the contiguous slot range
// [off[g], off[g+1]) of the offsets row of the expand table (pad columns
// carry offsets >= 2e7 and own nothing). Slots at or past f_kept hold no
// fragment (their keys are invalid, so they lie outside every tile range
// and their gradient rows are 0); ranges are clamped to [0, f_kept), which
// spares the last gaussian a walk over the capacity's unused tail.
// out[r, g] is the sum of d[r, i] over the clamped range.
//
// Bound on the H100: memory (each input word is read once, one add per
// word). Design: one thread per gaussian sums its own range in order —
// deterministic, no atomics (the reference's atomicAdd reduction and the
// TPU's windowed one-hot matmul both disappear). Ranges of neighbouring
// gaussians are adjacent, so a warp's reads fall on a few cache lines per
// row.
#include "common.cuh"

using namespace rodygs;

__global__ void segsum_kernel(const float* __restrict__ d, int n_rows, int C,
                              const float* __restrict__ off, int nw,
                              const int* __restrict__ f_kept_ptr,
                              float* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nw) return;
  const float end_f = (float)min(*f_kept_ptr, C);
  const int lo = (int)fminf(off[g], end_f);
  const int hi = g + 1 < nw ? (int)fminf(off[g + 1], end_f) : (int)end_f;
  for (int r = 0; r < n_rows; ++r) {
    const float* row = d + (size_t)r * C;
    float s = 0.f;
    for (int i = lo; i < hi; ++i) s += row[i];
    out[(size_t)r * nw + g] = s;
  }
}

extern "C" int rodygs_segsum(const float* d, int n_rows, int C,
                             const float* off_row, int nw, const int* f_kept,
                             float* out, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (nw + threads - 1) / threads;
  segsum_kernel<<<blocks, threads, 0, stream>>>(d, n_rows, C, off_row, nw,
                                                f_kept, out);
  return (int)cudaGetLastError();
}
