// Launch-overhead probes P1-P5 on Hopper (sm_90a).
//
// Replace the five probes of tools/pallas_overhead.py (main(): bare :62,
// gridded :70, dma :90, aliased :113, spref :134), which time a trivial
// pallas_call with one more feature each to isolate the TPU's per-call
// dispatch cost.  Each kernel here does the same trivial work with the
// card's counterpart of that feature:
//
//   P1 bare     o = x + 1 over one f32 (8, 128) block, one CTA;
//   P2 gridded  the same function over a grid of 16 CTAs that partition
//               the block (the Pallas grid's 16 steps map the one block);
//   P3 dma      bulk async copies (cp.async.bulk completing on an
//               mbarrier, Hopper's counterpart of make_async_copy plus a
//               DMA semaphore) of rows 0-255 of an int8 [1024, 512] plane
//               into the shared memory of a cluster of 8 CTAs, then o =
//               sum of those bytes, summed in int32 (exact), broadcast to
//               (8, 128);
//   P4 aliased  rows 0-7 of the plane +1 with int8 wrap-around, in place
//               (the aliased read-modify-write), and o = 0;
//   P5 spref    o = x + s[0], s an int32 array read from device memory
//               (scalar prefetch has no counterpart: a block loads its
//               own scalars).
//
// Bound on this card: the launch, not the bytes.  The bytes (8 KB; 132 KB
// for P3, 12 KB for P4) take 2.4-40 ns at 3.35 TB/s, far below a launch
// (spatten_probe_empty, an empty kernel, is the floor the tools print
// beside them); the probes measure what a launch costs, eager, from a
// CUDA graph and through ctypes.
//
// P2's 16 CTAs split the block, so o is written once (16 CTAs that each
// computed the whole block would write the same 4 KB sixteen times): each
// owns 64 floats, 16 lanes of one warp with one float4 each (__ldg, a
// vector store).  P3 spreads over a thread-block cluster of 8 CTAs, so
// that no single SM's share of bandwidth and issue rate sets its time:
// each arms its own mbarrier for its 32 rows (16 KB) and issues one bulk
// copy into its own shared memory; its 256 threads sum 4 int4s each with
// __dp4a against 0x01010101 (one instruction per 4 signed bytes), warp
// shuffles and the 8 warp partials give the CTA's partial, which it
// writes into rank 0's shared memory through DSMEM; after a cluster
// barrier every CTA reads the 8 partials and stores its eighth of o (32
// float4s), and a second cluster barrier keeps rank 0's shared memory
// alive until all have read it.
//
// P4 and P5 do not stage through shared memory.  The Pallas probes had to
// (a TPU kernel computes on VMEM, so the aliased plane came in and went
// back by DMA), but on Hopper each thread can read, change and write its
// own 16-byte segments where they lie.  Each is one CTA of 256 threads,
// one vector per thread: P4 stores its float4 of o = 0 first (it depends
// on nothing), then loads one int4 of rows 0-7, adds 1 to each byte with
// __vadd4 (per-byte, modulo 256: int8 wrap-around) and stores it back; P5
// loads s[0] and its float4 of x, both before any use so the two
// latencies overlap.  Staged, P4 paid an mbarrier, two bulk copies and a
// wait for the global writes in series.  P3 keeps the bulk copy: it is the
// probe of Hopper's asynchronous copy.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 8 * 128;          // f32 elements of the (8, 128) block
constexpr int kPlaneCols = 512;          // int8 plane [1024, 512]
constexpr int kDmaBytes = 256 * kPlaneCols;
constexpr int kRmwBytes = 8 * kPlaneCols;
// P4 and P5: one 16-byte vector of each operand per thread
static_assert(kBlock / 4 == kThreads && kRmwBytes / 16 == kThreads,
              "one CTA of kThreads covers the block and the rows");
// P2: 16 CTAs of 16 threads, one float4 each
constexpr int kGridCtas = 16;
constexpr int kGridThreads = kBlock / 4 / kGridCtas;
// P3: a cluster of 8 CTAs, 32 rows (16 KB) each, 4 int4s per thread
constexpr int kCluster = 8;
constexpr int kDmaCtaBytes = kDmaBytes / kCluster;
constexpr int kDmaCtaOut = kBlock / 4 / kCluster;   // float4s of o per CTA
static_assert(kDmaCtaBytes == 16 * 4 * kThreads && kDmaCtaOut <= kThreads,
              "a CTA's rows are 4 int4s per thread; its eighth of o fits");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One mbarrier expecting `bytes` of one bulk copy global -> shared, issued
// by thread 0; every thread waits on phase 0.
__device__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                          uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint64_t state;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
        : "=l"(state)
        : "r"(b), "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(b)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

__global__ void __launch_bounds__(kThreads)
add_one_kernel(const float* __restrict__ x, float* __restrict__ o) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads) o[i] = x[i] + 1.f;
}

// P2: CTA c owns float4s [16c, 16c + 16) of the block, one per thread.
__global__ void __launch_bounds__(kGridThreads)
gridded_add_kernel(const float4* __restrict__ x, float4* __restrict__ o) {
  const int i = blockIdx.x * kGridThreads + threadIdx.x;
  float4 v = __ldg(x + i);
  v.x += 1.f;
  v.y += 1.f;
  v.z += 1.f;
  v.w += 1.f;
  o[i] = v;
}

// P3: CTA r of the cluster sums rows [32r, 32r + 32) from its own shared
// memory; rank 0 gathers the partials.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
dma_sum_kernel(const int8_t* __restrict__ plane, float4* __restrict__ o) {
  __shared__ __align__(128) int4 buf[kDmaCtaBytes / 16];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int red[kThreads / 32];
  __shared__ int partials[kCluster];            // read on rank 0 only
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  // no CTA may write into rank 0's shared memory before rank 0 runs:
  // arrive now, wait just before that write (copy and sum run between)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  bulk_load(buf, plane + static_cast<size_t>(rank) * kDmaCtaBytes,
            kDmaCtaBytes, &bar);
  int sum = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 w = buf[k * kThreads + threadIdx.x];
    sum = __dp4a(w.x, 0x01010101, sum);
    sum = __dp4a(w.y, 0x01010101, sum);
    sum = __dp4a(w.z, 0x01010101, sum);
    sum = __dp4a(w.w, 0x01010101, sum);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sum;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  int* gather = cluster.map_shared_rank(partials, 0);
  if (threadIdx.x == 0) {
    int part = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) part += red[w];
    gather[rank] = part;
  }
  cluster.sync();                               // every partial has landed
  if (threadIdx.x < kDmaCtaOut) {
    int total = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) total += gather[r];
    const float t = static_cast<float>(total);
    o[rank * kDmaCtaOut + threadIdx.x] = make_float4(t, t, t, t);
  }
  cluster.sync();                // rank 0's partials stay until all read
}

// o = 0 as float4s, then rows 0-7 (kRmwBytes) +1 per byte, in place, as
// 16-byte segments: one of each per thread.
__global__ void __launch_bounds__(kThreads)
aliased_rmw_kernel(uint4* plane, float4* __restrict__ o) {
  const int i = threadIdx.x;
  o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  uint4 w = plane[i];
  w.x = __vadd4(w.x, 0x01010101u);
  w.y = __vadd4(w.y, 0x01010101u);
  w.z = __vadd4(w.z, 0x01010101u);
  w.w = __vadd4(w.w, 0x01010101u);
  plane[i] = w;
}

// o = x + s[0], one float4 per thread.
__global__ void __launch_bounds__(kThreads)
spref_kernel(const int* __restrict__ s, const float4* __restrict__ x,
             float4* __restrict__ o) {
  const int add = __ldg(s);
  const int i = threadIdx.x;
  float4 v = __ldg(x + i);
  const float a = static_cast<float>(add);
  v.x += a;
  v.y += a;
  v.z += a;
  v.w += a;
  o[i] = v;
}

__global__ void empty_kernel() {}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = success); the wrappers (spatten_tpu_torch/tools/launch_overhead.py)
// check shapes, types and contiguity.
extern "C" int spatten_probe_bare(const float* x, float* o, void* stream) {
  add_one_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatten_probe_gridded(const float* x, float* o, void* stream) {
  gridded_add_kernel<<<kGridCtas, kGridThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatten_probe_dma(const int8_t* plane, float* o, void* stream) {
  dma_sum_kernel<<<kCluster, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      plane, reinterpret_cast<float4*>(o));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatten_probe_aliased(int8_t* plane, float* o,
                                     void* stream) {
  aliased_rmw_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<uint4*>(plane), reinterpret_cast<float4*>(o));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatten_probe_spref(const int* s, const float* x, float* o,
                                   void* stream) {
  spref_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o));
  return static_cast<int>(cudaGetLastError());
}

// The launch floor: an empty kernel, one warp.
extern "C" int spatten_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
