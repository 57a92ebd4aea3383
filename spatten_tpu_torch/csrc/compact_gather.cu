// Prune-event row compaction of one layer's int8 K and V planes, in
// place, on Hopper (sm_90a).
//
// Replaces the TPU kernel spatten_tpu/ops/compact_gather.py::
// gather_compact_rows (pallas_call at :335, body _make_kernel :51-261).
// For each (batch row b, kv head h) of a triggered sequence, rows
// keep_idx[b, h, :keep_count[b]] (ascending, distinct) of both planes move
// to the front of that head's lanes [h*D, (h+1)*D).  Untriggered
// sequences and rows at or past keep_count are untouched.
//
// In-place safety.  The TPU kernel's argument rests on grid steps running
// in sequence; CTAs here run at the same time.  So one CTA owns one
// (b, h): lanes of different heads and rows of different sequences are
// disjoint, and no two CTAs touch the same bytes.  Inside the CTA the
// destination tiles are walked in order; a tile first loads all of its
// sources into registers, synchronises, then stores.  Because the kept
// indices are sorted and distinct, keep_idx[i] >= i: a tile's sources lie
// at or after its own first row, which no earlier tile wrote.
//
// Bound on this card: bytes -- each moved row is read once and written
// once per plane (2 * 2 * D bytes) plus its 4-byte index.  Rows already
// in place (keep_idx[i] == i: the sink tokens and every row before the
// first pruned one) are skipped entirely.  Loads and stores are 16 bytes
// per thread; the MXU permutation matmul of the TPU kernel has no
// counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
compact_gather_kernel(int8_t* k, int8_t* v, const int* __restrict__ keep_idx,
                      const int* __restrict__ keep_count,
                      const int* __restrict__ triggered, int C, int H, int D,
                      int P) {
  const int h = blockIdx.x, b = blockIdx.y;
  if (triggered[b] == 0) return;                  // uniform in the CTA
  const int n = min(keep_count[b], P);
  const int vec_per_row = D / 16;                 // int4 chunks per head row
  const int rows_per_pass = kThreads / vec_per_row;
  const int tile = 2 * rows_per_pass;             // two rows per thread
  const int row = threadIdx.x / vec_per_row;
  const int chunk = threadIdx.x % vec_per_row;
  // threads past rows_per_pass * vec_per_row (D not dividing 4096) idle
  // but still reach every barrier
  const bool active = row < rows_per_pass;
  const size_t F = static_cast<size_t>(H) * D;
  int8_t* kb = k + static_cast<size_t>(b) * C * F + static_cast<size_t>(h) * D;
  int8_t* vb = v + static_cast<size_t>(b) * C * F + static_cast<size_t>(h) * D;
  const int* idx = keep_idx + (static_cast<size_t>(b) * H + h) * P;

  for (int i0 = 0; i0 < n; i0 += tile) {
    int4 kr[2], vr[2];
    int dst[2], src[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dst[r] = i0 + row + r * rows_per_pass;
      src[r] = (active && dst[r] < n) ? idx[dst[r]] : dst[r];
      if (src[r] != dst[r]) {
        kr[r] = reinterpret_cast<const int4*>(kb + src[r] * F)[chunk];
        vr[r] = reinterpret_cast<const int4*>(vb + src[r] * F)[chunk];
      }
    }
    __syncthreads();                              // all sources read
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (src[r] != dst[r]) {
        reinterpret_cast<int4*>(kb + dst[r] * F)[chunk] = kr[r];
        reinterpret_cast<int4*>(vb + dst[r] * F)[chunk] = vr[r];
      }
    }
    __syncthreads();                              // tile written
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success); the wrapper
// (spatten_tpu_torch/ops/compact_gather.py) validates shapes.
extern "C" int spatten_compact_gather(int8_t* k, int8_t* v, const int* keep_idx,
                                      const int* keep_count,
                                      const int* triggered, int B, int C,
                                      int H, int D, int P, void* stream) {
  if (D % 16 != 0 || D > 16 * kThreads) return cudaErrorInvalidValue;
  compact_gather_kernel<<<dim3(H, B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      k, v, keep_idx, keep_count, triggered, C, H, D, P);
  return static_cast<int>(cudaGetLastError());
}
