// Fused SpAtten decode attention for one layer of the stacked token-major
// cache, in place, on Hopper (sm_90a).
//
// Replaces the TPU kernel spatten_tpu/ops/fused_decode.py::
// fused_decode_attention (pallas_call at :2319, body _make_kernel
// :254-1902).  Same function, redesigned for the GPU:
//
//   append the new K/V row (int8 + per-(token, head) scale, the 4-bit
//   nibble RMW and, under a 6-bit profile, the 2-bit lsb2 RMW)
//   -> pass-1 scores on the layer's profile plane: 4-bit msb, 6-bit
//      msb + lsb2, or the int8 plane (8-bit layers and dense mode); the
//      scaled score is ksc * (raw * rowscale * mult * sm + rowscale * qsum
//      * (mid - 128) * sm) over the biased stored nibbles, as in the
//      Pallas body (:1196-1231)
//   -> masked f32 softmax -> requant decision (max prob < threshold) and,
//      where it fires, an int8-plane recompute -> importance EMA update of
//      the stacked [L, B, Hkv, C] accumulator -> local V top-k by block
//      mass (ties kept) -> P·V over the kept V blocks only, in f32 or with
//      8-bit row weights on the stored int8 rows (pv_int8).
//
// Importance: "prob" (the softmax probabilities) or "presoftmax" (the
// masked scaled scores of the last scoring pass, head-masked), either
// accumulated in place (imp <- ema * imp + delta) or, in delta mode,
// written as this step's delta to an output of [B, Hkv, C] (or per query
// row, [B, Hq, C]), every column of the window, zeros past the length.
//
// Split-K flags (parallel/split_k.py): append_mask (a row that does not
// append writes no plane byte, scores its idx column as a stored token and
// resets no importance slot; it may hold no live token at all, and then
// reports zero output, m = MASK_VALUE and den = 1e-30, so its flash weight
// exp(m - m_g) * den is exactly 0); row stats (the per-row softmax max m and
// denominator den, written for every row of a live or dead group).
//
// skip_append (perf triage, the Pallas kernel's _skip_append; a runtime
// flag of the C entry, the stash pointer): the step returns what the
// appending step returns and writes the new row's scales (the Pallas body
// writes its scale windows back either way), but leaves every byte of the
// int8, nibble and 2-bit planes as it found them.  K1's passes read the
// appended row back from the planes, so the entry brackets the unchanged
// K1 launch with stash_kernel: before it, the bytes each CTA's append will
// overwrite go to a stash in device memory; after it, they go back.  The
// flag prices nothing of the append on this card (the Pallas kernel's
// skips its row DMAs).
//
// Serving flags: head_mask (a kv-head group with no live query row
// appends, then exits: zero output, zero max prob, importance untouched);
// f32 or bf16 scale and importance planes (read as f32, stored with
// round-to-nearest-even; the appended column's P·V term keeps the new
// row's f32 scales, as the Pallas body does); quantize_queries (per-row
// int8 queries: the raw dot products are exact integers before scaling);
// pv_int8; probs_bf16 (each unnormalized probability is rounded to bf16
// where it is stored: the CTA keeps scores and probabilities in ONE f32
// plane, in place, so a separate bf16 plane would not shrink it); and
// cap_override (the CTA's planes, its V-block ranking and its loops are
// sized to the rung C, while plane strides use the stored capacity Ct).
//
// Grid: one CTA per (kv head, batch row).  The CTA owns lanes
// [h*d, (h+1)*d) of every cache row, the head's scale column and its
// importance row, so its append read-modify-writes cannot race any other
// CTA (the 2-bit byte that four tokens share lies in the CTA's own
// lanes): it appends first, byte by byte, then __syncthreads(), then
// reads the post-append cache.
//
// Head dims: instances exist for D = 64, 128 and 256; a model's head_dim
// d runs in D = 64 if d is 64, else in the smallest of 128 and 256 that
// holds d lanes after a lead-in of up to 16 - gcd(d, 16) bytes
// (instance_dim in the wrapper), with the live lanes p.d.  A head past
// 256 lanes (the JAX kernel takes up to 3,712) runs in D = 256 as lane
// pieces: a TMA box is at most 256 bytes wide, so a CTA reads its head's
// rows as ceil((sh + d) / 256) boxes side by side, piece j from plane
// column box_col + 256 j.  Each streaming pass runs once per piece, with
// that piece's query lanes in registers (re-read from the query row; a
// row's int8 query scale and lane sum still cover all d lanes): pass 1
// and the requant recompute add each piece's raw dot products into the
// score plane in piece order (as int32 under int8 queries, so the sum
// stays exact) and scale the sum after the last piece; P·V accumulates
// and writes each piece's columns.  The append, the softmax, the requant
// decision, the importance and the V-block keep sets are per row, as for
// one piece.  A head of one piece runs the code it ran before.
//
// Its tiles keep rows of D bytes: a box of D bytes from the head's
// first lane h*d rounded down to 16 bytes holds, around the head's d
// lanes, its neighbours' lanes (or zeros past the row), which the zero
// query lanes weight by 0 and P·V never writes.  A head's rows are then
// only 4-byte aligned (d = 100: h*100), so rows of d < D lanes are copied
// only as TMA boxes (a ragged tile as a whole box, whose extra rows are
// never consumed), never by row copies, which need 16-byte addresses.
//
// Capacities: any even stored capacity Ct and rung C whose pack unit
// (and, with the 2-bit plane, its quarter) divides them, as in the Pallas
// kernel.  A msb tile's rows divide the half-unit (not only powers of
// two: 1020 tokens have a half-unit of 510), the scale segments align
// their own addresses, and the metadata vectors fall back to scalars
// where a column (at a stride off a multiple of 8) is misaligned.
//
// Bound on this card: bytes.  Per (b, h) one step moves ~len*D/2 bytes of
// msb (plus len*D/4 of lsb2 for a 6-bit layer, len*D for a requant head,
// an 8-bit layer or dense mode), the kept V rows, and the scale and
// importance columns, against ~4*G flops per K byte -- far below the
// H100's ~20 f32 flops/byte ridge.  (Not so for one cached head read by
// 16 query rows, DeepSeek-V2's latent row: ~64 operations a packed byte
// outrun dp4a, and such calls run in the latent instance on the tensor
// cores, csrc/fused_decode_latent.cu.)  The design reads each packed row once
// (one msb row and one lsb2 row serve a hi and a lo token), unpacks in
// registers, keeps scores and probabilities in shared memory, and skips
// the loads of V blocks no query row keeps and of dead head groups.
//
// The [G, C] score plane grows with the window: where it would take the
// plan past 227 KB (at head_dim 128 and v_block 64: past 3808 tokens for
// GQA 8, 8608 for GQA 4, 36928 for MHA), the wrapper passes a plane in
// device memory instead, one [G, C] slice per CTA that only that CTA
// writes and reads back (its __syncthreads() order global accesses within
// the block as they do shared ones).  That is a second instance of each
// <G, D> (kSmemScores false), so the shared-plane instances compile to
// the same shared-memory instructions as before.  The slices of a step (B * Hkv * G *
// C * 4 bytes: 8.4 MB for Llama-2-70B's group at batch 8 and 4096 tokens)
// fit in the card's 50 MB L2, so the plane should add L2 traffic rather
// than HBM bytes; the rest of the plan is unchanged.  The device-plane
// instances also take what the shared ones cannot: a GQA group past 8
// (Llama-3.1-405B's 16) runs in <8, D, false> as chunks of 8 query rows
// in the CTA (one append, one requant decision and one importance EMA
// over every row; pass 1, the recompute and P·V once per chunk), and a
// window whose per-V-block arrays would still pass 227 KB (1 kv head of
// group 8 at 65,536 tokens, v_block 16) keeps them in a device plane too.
//
// What held the first design far from that bound was latency, not bytes:
// each warp kept 4 rows of 4 bytes per lane in flight (~4 KB per CTA), and
// every token's scale was a dependent global load.  So the three
// streaming passes (pass 1, the requant recompute, P·V) now read from a
// ring of kStages tiles of 16 KB in shared memory.  Warp 0 fills it: a
// full tile is one TMA box (a 2-D tensor map over the layer's plane, D
// bytes x the tile's rows at the plane's F = Hkv*d stride; the maps are
// encoded on the host once per plane and layer and cached), a ragged last
// tile one cp.async.bulk per live row (where d = D), and each stage
// completes on its own
// mbarrier (expect_tx).  After a tile is consumed a __syncthreads() frees
// its stage and warp 0 refills it, so ~kStages * 16 KB stay in flight per
// CTA.  (128-byte row copies cost ~30-75 ns each per CTA on this card, so
// a tile of them could not keep up; one box per tile does.)  Each tile
// carries its metadata: the K (or V) scale segment of its tokens is one
// more bulk copy into the same stage (two for a packed msb tile: its hi
// and lo tokens; one per kept block piece for P·V), so no scale is read
// from device memory inside a per-token loop.  Only live rows are
// fetched: packed rows whose hi token is below the length, int8 rows of
// [0, len) (the requant pass only where it fires), V rows of kept blocks
// other than the appended one.  Compute warps read a tile with D/16 lanes
// per row, 16 B per lane (4 rows per warp instruction at D = 128, no bank
// conflicts), two row steps at a time so that their loads and shuffles
// overlap, and reduce a row over its lanes in log2(D/16) shuffles; the
// row's leader writes the scaled score with the scale from the tile.  The
// dot products avoid int-to-float conversions (a quarter-rate unit that
// bounded the first ring): exact dp4a integer sums under int8 queries,
// else bytes read as floats by placing them under the exponent of 2^23
// (exact).  P·V gives each lane 16 columns of the accumulator.  GQA group
// 8 uses 8 B per lane so that its query rows and accumulators fit in
// registers.  The importance column and the pv_int8 V-scale maximum are
// read in 8-column vectors.  The append writes the cache with ordinary
// stores, which the copies (async proxy) may read back: every thread
// fences the async proxy before the __syncthreads() that follows the
// append.  The shared-memory plan is smem_bytes() below, mirrored by
// smem_bytes() in spatten_tpu_torch/ops/fused_decode.py (which checks it
// before a launch).
// The TPU scheduling machinery (heads/batches per program, DMA slot
// rotation, cross-instance prefetch, scale-ladder rungs, gate words) has
// no counterpart here.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <unordered_map>

// The build compiles this file as two translation units at once and links
// them into one library (kernels.PARTS), since one nvcc of all 24
// instances took a fifth of chip_smoke.py's run: K1_PART 1 holds the
// shared-plane instances (kSmemScores) and the C entry, K1_PART 2 the
// device-plane instances, which part 1 reaches through
// spatten_fused_decode_device_plane.  K1_PART 0 (the default) is the
// whole file in one unit, as tools/k1_passes.py builds its variants.
// K1_PART 3 is this file's helpers alone, without an instance or a C
// entry: csrc/fused_decode_latent.cu includes it so, and adds the latent
// instance as a third unit of the same library, which the C entry
// reaches through spatten_fused_decode_latent.
#ifndef K1_PART
#define K1_PART 0
#endif

// the device-plane launch of part 2, which part 1 calls: `params` is a
// Params (the same definition in both units); declared in every part, so
// that launch<G, D> parses where its branch to it is discarded
extern "C" int spatten_fused_decode_device_plane(const void* params, int B,
                                                 int G, int D, int rows,
                                                 void* stream);
// the latent instance's launch (csrc/fused_decode_latent.cu): one cached
// head read by a group of 9-16 query rows, the wrapper's G = 16
extern "C" int spatten_fused_decode_latent(const void* params, int B,
                                           void* stream);

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;               // tiles in flight per CTA
constexpr int kStageBytes = 16384;       // plane rows of one tile
constexpr int kSegBytes = 2304;          // the tile's scale segments
constexpr int kSegHalf = kSegBytes / 2;  // a packed tile's lo-token segment
constexpr int kStageStride = kStageBytes + kSegBytes;
constexpr int kRowSteps = 2;             // row steps a warp overlaps
constexpr int kMisc = 8;                 // per-row scalars in shared memory
constexpr float kMsbMidpoint = 7.5f;     // qz.MSB_MIDPOINT
constexpr float kMidpoint6 = 1.5f;       // qz.MIDPOINT6
constexpr float kMaskValue = -0.7f * 3.402823466e38f;   // MASK_VALUE

struct Params {
  const float* q;        // [B, Hq, D]
  const float* k_new;    // [B, Hkv, D]
  const float* v_new;    // [B, Hkv, D]
  const int* lengths;    // [B] valid tokens incl. the appended row
  int8_t* kfull;         // [B, Ct, F]   (this layer's base)
  uint8_t* kmsb;         // [B, Ct/2, F] or null (dense)
  uint8_t* klsb2;        // [B, Ct/4, F] or null (no 6-bit profile)
  void* kscale;          // [B, Hkv, Ct] f32 or bf16
  int8_t* vfull;         // [B, Ct, F]
  uint8_t* vmsb;         // [B, Ct/2, F] or null
  void* vscale;          // [B, Hkv, Ct] f32 or bf16
  void* imp;             // [B, Hkv, Ct] accumulator (f32 or bf16) or null
  const uint8_t* hmask;  // [B, Hq] head liveness or null (all alive)
  const int* qbits;      // [L] per-layer pass-1 bits or null
  const uint8_t* appmask;  // [B] 0 = this row does not append, or null
  float* out;            // [B, Hq, D]
  float* max_prob;       // [B, Hkv]
  uint8_t* need;         // [B, Hkv]
  uint8_t* keep_out;     // [B, Hq, C / v_block] or null
  float* delta;          // delta mode: [B, Hkv or Hq, C], or null
  float* mrow;           // [B, Hq] row max, or null (no row stats)
  float* drow;           // [B, Hq] row denominator
  float* splane;         // [B, Hkv, rows, C] score plane in device memory,
                         // or null (in shared memory)
  int Hq, C, Ct, F, Hkv, pack_unit, layer;
  float sm_scale, threshold, ema;
  int quant, requant, keep_blocks, v_block;
  int sc_bf16, imp_bf16, qq, pv_int8, probs_bf16, presoftmax, per_row;
  int g;                 // the model's GQA group Hq / Hkv: the live rows
                         // of the instance's G (1 <= g <= G)
  int d;                 // the model's head_dim: the live lanes of the
                         // instance's D (1 <= d <= D), or of its lane
                         // pieces (D = 256, d past 256 lanes)
  // the ring's geometry (host-computed): packed rows of a msb tile, V
  // rows of a P·V tile and of one of its pieces (inside one V block)
  int t_msb, tpv, piece;
  int v_box;             // a P·V piece may be one box (128-byte aligned)
  int l2_off;            // where a msb tile's lsb2 rows start (128-aligned)
  uint8_t* bplane;       // [B, Hkv, bstride] per-V-block arrays in device
  int bstride;           // memory (device-plane instances), or null
  // TMA tensor maps over this layer's planes, rows of D bytes from the
  // head's first lane at stride F: boxes of kRows (int8 K), t_msb (msb,
  // lsb2) and piece (int8 V) rows
  CUtensorMap kf_map, km_map, kl2_map, vf_map;
};

// per-row scalars: misc[k * rows + g] (rows: G, or the score rows of a
// group run in chunks)
enum Misc { kDen, kMax, kEmv, kXidx, kKth, kWrow, kEidx, kWmax };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; every thread gets the result.  `red` holds
// kWarps floats of shared scratch.
template <typename Op>
__device__ float block_reduce(float v, float* red, float init, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = op(v);
  __syncthreads();                       // earlier readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return op(lane < kWarps ? red[lane] : init);
}

__device__ __forceinline__ void store_meta(void* p, size_t i, float v,
                                           int bf) {
  if (bf) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Quantize one head's new row of d values (one warp; VEC = D / 32 lanes
// each, those past d idle, in rounds of D lanes past D): int8 + scale into
// slot idx of the full plane, the nibble RMW of the packed plane and the
// 2-bit RMW of the lsb2 plane, byte by byte in the head's own d lanes (the
// next head's CTA appends the lanes after them).  The f32 scale also goes
// to *scale_f32.
template <int VEC>
__device__ void append_row(const float* x, int d, int8_t* full_row,
                           void* scale, size_t scale_idx, int sc_bf16,
                           float* scale_f32, uint8_t* msb_row, bool is_hi,
                           uint8_t* l2_row, int l2_shift) {
  const int lane = threadIdx.x & 31;
  // below D = 256 the row takes one round of D lanes (d <= D); at 256 a
  // head of lane pieces takes as many as it needs
  constexpr int kRound = 32 * VEC;
  const int rounds = VEC < 8 ? 1 : (d + kRound - 1) / kRound;
  float amax = 0.f;
  for (int c0 = lane * VEC, k = 0; k < rounds; c0 += kRound, ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (c0 + i < d) amax = fmaxf(amax, fabsf(x[c0 + i]));
  amax = warp_max(amax);
  const float s = amax > 0.f ? amax / 127.f : 1.f;
  for (int c0 = lane * VEC, k = 0; k < rounds; c0 += kRound, ++k)
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = c0 + i;
    if (c >= d) break;
    const float r = fminf(fmaxf(rintf(x[c] / s), -127.f), 127.f);
    const int q8 = static_cast<int>(r);
    full_row[c] = static_cast<int8_t>(q8);
    if (msb_row != nullptr) {
      const uint8_t nib = static_cast<uint8_t>(((q8 >> 4) & 0xF) ^ 8);
      const uint8_t old = msb_row[c];
      msb_row[c] = is_hi ? static_cast<uint8_t>((nib << 4) | (old & 0x0F))
                         : static_cast<uint8_t>((old & 0xF0) | nib);
    }
    if (l2_row != nullptr) {
      const int f2 = (q8 >> 2) & 0x3;
      const int old = l2_row[c];
      l2_row[c] =
          static_cast<uint8_t>((old & ~(0x3 << l2_shift)) | (f2 << l2_shift));
    }
  }
  if (lane == 0) {
    store_meta(scale, scale_idx, s, sc_bf16);
    *scale_f32 = s;
  }
}

// Sum / max over the N lanes (an aligned group) that hold one row.
template <int N>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = N / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int N>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = N / 2; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// n <= 8 consecutive metadata values from element i (the rest read as
// 0), and their store: one 16-byte vector for bf16, two for f32, where all
// eight are wanted and the address is 16-byte aligned (a row stride off a
// multiple of 8 elements misaligns columns), else element by element.
__device__ __forceinline__ bool vec_ok(const void* p, size_t i, int bf,
                                       int n) {
  return n == 8 &&
         ((reinterpret_cast<uintptr_t>(p) + i * (bf ? 2 : 4)) & 15) == 0;
}

__device__ __forceinline__ void load_meta8(const void* p, size_t i, int bf,
                                           float (&v)[8], int n = 8) {
  if (!vec_ok(p, i, bf, n)) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = j >= n ? 0.f
             : bf   ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(p)[i + j])
                    : static_cast<const float*>(p)[i + j];
    return;
  }
  if (bf) {
    const uint4 w = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p) + i);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(ws[k] << 16);
      v[2 * k + 1] = __uint_as_float(ws[k] & 0xFFFF0000u);
    }
  } else {
    const float4* f =
        reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 a = f[0], b = f[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ void store_meta8(void* p, size_t i,
                                            const float (&v)[8], int bf,
                                            int n = 8) {
  if (!vec_ok(p, i, bf, n)) {
    for (int j = 0; j < n; ++j) store_meta(p, i + j, v[j], bf);
    return;
  }
  if (bf) {
    uint32_t ws[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ws[k] = static_cast<uint32_t>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]))) |
              (static_cast<uint32_t>(
                   __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])))
               << 16);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + i) =
        make_uint4(ws[0], ws[1], ws[2], ws[3]);
  } else {
    float4* f = reinterpret_cast<float4*>(static_cast<float*>(p) + i);
    f[0] = make_float4(v[0], v[1], v[2], v[3]);
    f[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// ---- the tile ring: bulk copies into shared memory on mbarriers --------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void arrive_expect_tx(uint32_t bar,
                                                 uint32_t bytes) {
  uint64_t state;
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
      : "=l"(state)
      : "r"(bar), "r"(bytes)
      : "memory");
  (void)state;
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One TMA box (rows of D bytes) at (column c0, row c1) of `map`.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Wait for a stage's phase; a copy that never lands (a byte count that
// disagrees with the copies) traps after ~4 s instead of hanging.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 33)) __trap();
  }
}

// A tile's metadata segment: the span of a scale column that covers
// tokens [t, t + n), widened to 16-byte-aligned addresses (a column of a
// row stride off a multiple of 8 elements starts anywhere).  Returns its
// bytes; copies it into dst on `bar` when `go`.
__device__ __forceinline__ uint32_t seg_copy(uint8_t* dst, const uint8_t* col,
                                             int t, int n, int es,
                                             uint32_t bar, bool go) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(col + t * es) & ~uintptr_t{15};
  const uintptr_t e =
      (reinterpret_cast<uintptr_t>(col + (t + n) * es) + 15) & ~uintptr_t{15};
  if (go) bulk_copy(dst, reinterpret_cast<const void*>(a), e - a, bar);
  return static_cast<uint32_t>(e - a);
}

// A column's address modulo 16 (the `mis` of seg_at).
__device__ __forceinline__ int misalign(const uint8_t* col) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(col) & 15);
}

// Token t's value in a segment whose first token is tf, of a column whose
// address modulo 16 is `mis`.
__device__ __forceinline__ float seg_at(const uint8_t* seg, int mis, int tf,
                                        int t, int bf) {
  const int es = bf ? 2 : 4;
  const uint8_t* x = seg + (mis + t * es - ((mis + tf * es) & ~15));
  if (bf) return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(x));
  return *reinterpret_cast<const float*>(x);
}

// Room for one segment of n tokens (its widening to 16 B included).
__host__ __device__ constexpr int seg_stride(int n, int es) {
  return (n * es + 28 + 15) & ~15;
}

// The largest power of two <= rows that divides n (a P·V tile piece must
// not cross a V block).
__host__ __device__ inline int tile_rows(int rows, int n) {
  while (n % rows) rows >>= 1;
  return rows;
}

// The largest divisor of n that is <= rows (a msb tile must not cross a
// half-unit of the packed layout, whose span is any even capacity's).
inline int divisor_rows(int rows, int n) {
  for (int r = rows < n ? rows : n; r > 1; --r)
    if (n % r == 0) return r;
  return 1;
}

struct Ring {
  uint8_t* buf;        // kStages stages of kStageStride bytes
  uint64_t* bar;       // one mbarrier per stage
  int used;            // tiles streamed so far (every thread agrees)
};

// Stream n tiles through the ring.  copy(i, stage, bar, go) returns the
// bytes the calling lane of warp 0 copies for tile i, issuing them when
// `go`; consume(i, stage) reads a tile that has landed.  Warp 0 keeps
// kStages tiles in flight: after a tile is consumed a __syncthreads()
// frees its stage and warp 0 refills it.  Every thread calls this.
template <class Copy, class Consume>
__device__ void stream_tiles(Ring& r, int n, Copy copy, Consume consume) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto issue = [&](int i) {
    const int g = r.used + i;
    uint8_t* stage = r.buf + (g % kStages) * kStageStride;
    const uint32_t bar = smem_addr(r.bar + g % kStages);
    uint32_t bytes = copy(i, stage, bar, false);
#pragma unroll
    for (int o = 16; o; o >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
    if (lane == 0) arrive_expect_tx(bar, bytes);   // before any copy lands
    __syncwarp();
    copy(i, stage, bar, true);
  };
  if (warp == 0)
    for (int i = 0; i < n && i < kStages; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    const int g = r.used + i;
    wait_phase(smem_addr(r.bar + g % kStages), (g / kStages) & 1);
    consume(i, r.buf + (g % kStages) * kStageStride);
    __syncthreads();                                // the stage is free
    if (warp == 0 && i + kStages < n) issue(i + kStages);
  }
  r.used += n;
}

// How a warp reads a tile: LPR lanes per D-byte row, CW bytes (columns)
// each, RPW rows per warp instruction.  GQA group 8 takes 8 B per lane so
// that its query rows and P·V accumulators stay in registers.
template <int G, int D>
struct Lanes {
  static constexpr int CW = G <= 4 ? 16 : 8;
  static constexpr int LPR = D / CW;
  static constexpr int RPW = 32 / LPR;
  static constexpr int kRows = kStageBytes / D;    // rows of a full tile
};

template <int CW>
__device__ __forceinline__ void lds(const uint8_t* p, uint32_t (&w)[CW / 4]) {
  if constexpr (CW == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  }
}

__device__ __forceinline__ int byte_at(const uint32_t* w, int c) {
  return (w[c >> 2] >> (8 * (c & 3))) & 0xFF;
}

// K independent group sums at once (their shuffles overlap).
template <int N, int K, typename V>
__device__ __forceinline__ void group_sums(V (&v)[K]) {
#pragma unroll
  for (int o = N / 2; o; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
}

// Byte j of x as the float 2^23 + byte (one prmt: the byte under the
// exponent of 2^23); subtracting 2^23 (+ 128 for an int8 byte stored as
// byte ^ 0x80) is exact -- full-rate ALU work instead of int-to-float
// conversions, which run at a quarter of the rate.
__device__ __forceinline__ float biased_byte(uint32_t x, int j) {
  return __int_as_float(static_cast<int>(__byte_perm(x, 0x4B000000u, j | 0x7540)));
}

constexpr float kBias = 8388608.f;           // 2^23
constexpr float kBias8 = 8388736.f;          // 2^23 + 128

__device__ __forceinline__ float int8_at(const uint32_t* w, int c) {
  return biased_byte(w[c >> 2] ^ 0x80808080u, c & 3) - kBias8;
}

// A lane's dot product q . x over CW bytes x (words w, each byte an
// unsigned value, biased by `bias`), f32 in column order; and its exact
// integer form for int8 queries (qi: the query bytes, 4 per word), where
// the stored values are < 128 or signed int8.
template <int CW>
__device__ __forceinline__ float dot_f(const float* q, const uint32_t* w,
                                       float bias) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < CW; ++c)
    acc = fmaf(q[c], biased_byte(w[c >> 2], c & 3) - bias, acc);
  return acc;
}

template <int CW>
__device__ __forceinline__ int dot_i(const int* qi, const uint32_t* w) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < CW / 4; ++k)
    acc = __dp4a(qi[k], static_cast<int>(w[k]), acc);
  return acc;
}

// The raw scores of K values per lane (rows, or a row's hi and lo
// tokens) over their LPR lanes: exact integers under int8 queries, else
// f32 in column order, reduced over the lanes in shuffle order.
// wi: the values as signed bytes for the integer form, wf: as unsigned
// bytes biased by `bias` for the f32 form (the same words for nibbles).
template <int CW, int LPR, int K>
__device__ __forceinline__ void row_dots(bool qq, const float* q,
                                         const int* qi,
                                         const uint32_t (&wi)[K][CW / 4],
                                         const uint32_t (&wf)[K][CW / 4],
                                         float bias, float (&out)[K]) {
  if (qq) {
    int a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = dot_i<CW>(qi, wi[k]);
    group_sums<LPR>(a);
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = static_cast<float>(a[k]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = dot_f<CW>(q, wf[k], bias);
    group_sums<LPR>(out);
  }
}

// Per-row score constants of one pass: s = ksc * (raw * rs + off).
template <int G>
struct RowScale {
  float rs[G];
  float off[G];
};

// The scaled score of column t from its raw dot product (the row's
// leader lane only); the pre-scale value of the appended column is kept
// for its P·V term.
__device__ __forceinline__ void finalize(float raw, float rs, float off,
                                         float ksc, int t, int idx,
                                         float* srow, float* xidx) {
  const float x = __fadd_rn(__fmul_rn(raw, rs), off);
  if (t == idx) *xidx = x;
  srow[t] = __fmul_rn(x, ksc);
}

// Which lane piece a scoring pass reads: piece `j` of a head's boxes (from
// plane column `col`), the last one when `last`.  A head of one piece has
// j = 0 and last = true; only the D = 256 instances read pieces, so the
// passes of the others compile as if there were none (kPieces).
struct Piece {
  int j, col;
  bool last;
};

template <int D>
constexpr bool kPieces = D == 256;

// A piece's raw score of column t: added to the earlier pieces' sum, kept
// in the score plane (int32 bits under int8 queries, so the sum is
// exact), and scaled by finalize() after the last piece.
__device__ __forceinline__ void piece_score(float raw, bool qq,
                                            Piece pc, float rs,
                                            float off, float ksc, int t,
                                            int idx, float* srow,
                                            float* xidx) {
  if (pc.j > 0)
    raw = qq ? static_cast<float>(static_cast<int>(raw) +
                                  __float_as_int(srow[t]))
             : __fadd_rn(srow[t], raw);
  if (pc.last)
    finalize(raw, rs, off, ksc, t, idx, srow, xidx);
  else
    srow[t] = qq ? __int_as_float(static_cast<int>(raw)) : raw;
}

// The first plane column of head h's boxes: its first lane h*d rounded
// down to 16 bytes, so a box starts on a 16-byte address; the head's d
// lanes then sit `sh` = h*d - box_col bytes into each D-byte tile row
// (instance_dim keeps sh + d <= D, or runs the head in lane pieces of
// D = 256 from box_col + 256 j).  sh = 0 wherever d % 16 == 0.
__device__ __forceinline__ int box_col(const Params& p, int h) {
  return (h * p.d) & ~15;
}

// Raw scores of every live token from the int8 plane: tiles of kRows
// tokens (one TMA box, or row copies for a ragged last tile where rows are
// D bytes) with their K scale segment (the last piece's tiles only).  (b,
// pc): the CTA's batch row and the lane piece.
template <int G, int D>
__device__ void scores_full(const Params& p, int b, Piece pc, Ring& ring,
                            const int8_t* kf, const uint8_t* kcol,
                            const float (&qr)[G][Lanes<G, D>::CW],
                            const int (&qi)[G][Lanes<G, D>::CW / 4],
                            const RowScale<G>& rsc, int len, int idx,
                            float* s, float* xidx) {
  using L = Lanes<G, D>;
  constexpr int T = L::kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lrow = lane / L::LPR, lcol = lane % L::LPR;
  const int es = p.sc_bf16 ? 2 : 4, kmis = misalign(kcol);
  const bool last = !kPieces<D> || pc.last;
  const uint8_t* plane = reinterpret_cast<const uint8_t*>(kf);
  stream_tiles(
      ring, (len + T - 1) / T,
      [&](int i, uint8_t* st, uint32_t bar, bool go) {
        const int t0 = i * T, rows = min(T, len - t0);
        uint32_t bytes = 0;
        if (rows == T || p.d != D) {
          // a whole box (a ragged one reads rows past the length, or zeros
          // past the plane); rows of d < D lanes are only 4-byte aligned
          if (lane == 0) {
            if (go) tensor_copy(st, &p.kf_map, pc.col, b * p.Ct + t0, bar);
            bytes += T * D;
          }
        } else {
          for (int rr = lane; rr < rows; rr += 32) {
            if (go)
              bulk_copy(st + rr * D, plane + static_cast<size_t>(t0 + rr) * p.F,
                        D, bar);
            bytes += D;
          }
        }
        if (lane == 0 && last)
          bytes += seg_copy(st + kStageBytes, kcol, t0, rows, es, bar, go);
        return bytes;
      },
      [&](int i, const uint8_t* st) {
        // kRowSteps row steps per warp at once: their loads and shuffles
        // overlap
        constexpr int U = kRowSteps, kStep = kWarps * L::RPW;
        const int t0 = i * T, rows = min(T, len - t0);
        for (int base = warp * L::RPW; base < rows; base += U * kStep) {
          int t[U];
          bool lead[U];
          uint32_t w[U][L::CW / 4] = {}, x[U][L::CW / 4];
          float ksc[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int rr = base + u * kStep + lrow;
            const bool live = rr < rows;             // uniform in the row
            t[u] = t0 + rr;
            if (live) lds<L::CW>(st + rr * D + lcol * L::CW, w[u]);
            lead[u] = live && lcol == 0;
            ksc[u] = lead[u] && last ? seg_at(st + kStageBytes, kmis, t0,
                                              t[u], p.sc_bf16)
                                     : 0.f;
#pragma unroll
            for (int k = 0; k < L::CW / 4; ++k)
              x[u][k] = w[u][k] ^ 0x80808080u;       // int8 as byte ^ 0x80
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float acc[U];
            row_dots<L::CW, L::LPR>(p.qq, qr[g], qi[g], w, x, kBias8, acc);
#pragma unroll
            for (int u = 0; u < U; ++u) {
              if (!lead[u]) continue;
              if constexpr (kPieces<D>)
                piece_score(acc[u], p.qq, pc, rsc.rs[g], rsc.off[g], ksc[u],
                            t[u], idx, s + g * p.C, xidx + g);
              else
                finalize(acc[u], rsc.rs[g], rsc.off[g], ksc[u], t[u], idx,
                         s + g * p.C, xidx + g);
            }
          }
        }
      });
}

// Pass-1 raw scores from the packed msb plane (biased nibbles n = k4 + 8):
// packed row r carries its hi token (unit*U + r % (U/2)) and lo token
// (+ U/2).  Under a 6-bit profile the lsb2 row of the same unit carries
// both tokens' 2-bit fields (hi: fields 0/1, lo: fields 2/3), and the raw
// value is q . (4n + l2).  Live packed rows (hi token below the length)
// are a prefix; a tile holds T of them (and their lsb2 rows, from
// p.l2_off) inside one half-unit (and, under a 6-bit profile, one
// quarter-unit), with the hi and lo tokens' K scale segments.  A full tile
// is one TMA box of msb rows (and one of lsb2 rows); a ragged last tile is
// copied row by row where rows are D bytes, else it is a whole box too.
template <int G, int D>
__device__ void scores_msb(const Params& p, int b, Piece pc, Ring& ring,
                           const uint8_t* km,
                           const uint8_t* kl2, const uint8_t* kcol,
                           const float (&qr)[G][Lanes<G, D>::CW],
                           const int (&qi)[G][Lanes<G, D>::CW / 4],
                           const RowScale<G>& rsc, int len, int idx,
                           float* s, float* xidx) {
  using L = Lanes<G, D>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lrow = lane / L::LPR, lcol = lane % L::LPR;
  const int es = p.sc_bf16 ? 2 : 4, kmis = misalign(kcol);
  const int u = p.pack_unit, half_u = u / 2, quarter_u = u / 4;
  const int nr = (len / u) * half_u + min(len % u, half_u);
  const int T = p.t_msb;
  const bool last = !kPieces<D> || pc.last;
  auto hi_token = [&](int r) { return (r / half_u) * u + r % half_u; };
  stream_tiles(
      ring, (nr + T - 1) / T,
      [&](int i, uint8_t* st, uint32_t bar, bool go) {
        const int r0 = i * T, rows = min(T, nr - r0);
        uint32_t bytes = 0;
        if (rows == T || p.d != D) {       // whole boxes, as in scores_full
          if (lane == 0) {
            if (go) tensor_copy(st, &p.km_map, pc.col, b * (p.Ct / 2) + r0, bar);
            bytes += T * D;
          }
          if (kl2 != nullptr && lane == 2) {
            const int lr0 = (r0 / half_u) * quarter_u + r0 % quarter_u;
            if (go)
              tensor_copy(st + p.l2_off, &p.kl2_map, pc.col,
                          b * (p.Ct / 4) + lr0, bar);
            bytes += T * D;
          }
        } else {
          for (int rr = lane; rr < rows; rr += 32) {
            const int r = r0 + rr;
            if (go)
              bulk_copy(st + rr * D, km + static_cast<size_t>(r) * p.F, D, bar);
            bytes += D;
            if (kl2 != nullptr) {
              const int lr = (r / half_u) * quarter_u + r % quarter_u;
              if (go)
                bulk_copy(st + p.l2_off + rr * D,
                          kl2 + static_cast<size_t>(lr) * p.F, D, bar);
              bytes += D;
            }
          }
        }
        const int thi0 = hi_token(r0);
        if (lane == 0 && last)
          bytes += seg_copy(st + kStageBytes, kcol, thi0, rows, es, bar, go);
        if (lane == 1 && last)
          bytes += seg_copy(st + kStageBytes + kSegHalf, kcol, thi0 + half_u,
                            rows, es, bar, go);
        return bytes;
      },
      [&](int i, const uint8_t* st) {
        // kRowSteps row steps per warp at once: their loads and shuffles
        // overlap
        constexpr int U = kRowSteps, kStep = kWarps * L::RPW;
        const int r0 = i * T, rows = min(T, nr - r0);
        const int thi0 = hi_token(r0);
        for (int base = warp * L::RPW; base < rows; base += U * kStep) {
          // per byte: hi and lo nibbles n (biased, 0..15), or under a
          // 6-bit profile 4n + the token's 2-bit field (0..63); values
          // 2u and 2u + 1 are row step u's hi and lo tokens
          uint32_t v[2 * U][L::CW / 4];
          int tok[2 * U];
          bool put[2 * U];
          float ksc[2 * U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int rr = base + u * kStep + lrow;
            const bool live = rr < rows;             // uniform in the row
            const int thi = thi0 + rr, tlo = thi + half_u;
            uint32_t w[L::CW / 4] = {}, l2[L::CW / 4] = {};
            int sh_hi = 0, sh_lo = 0;
            if (live) {
              lds<L::CW>(st + rr * D + lcol * L::CW, w);
              if (kl2 != nullptr) {
                lds<L::CW>(st + p.l2_off + rr * D + lcol * L::CW, l2);
                // the hi token's 2-bit field; the lo token's is field + 2
                const int field = ((r0 + rr) % half_u) / quarter_u;
                sh_hi = 6 - 2 * field;
                sh_lo = 2 - 2 * field;
              }
            }
#pragma unroll
            for (int k = 0; k < L::CW / 4; ++k) {
              uint32_t hi = (w[k] >> 4) & 0x0F0F0F0Fu;
              uint32_t lo = w[k] & 0x0F0F0F0Fu;
              if (kl2 != nullptr) {
                hi = (hi << 2) | ((l2[k] >> sh_hi) & 0x03030303u);
                lo = (lo << 2) | ((l2[k] >> sh_lo) & 0x03030303u);
              }
              v[2 * u][k] = hi;
              v[2 * u + 1][k] = lo;
            }
            const bool lead = live && lcol == 0;
            tok[2 * u] = thi;
            tok[2 * u + 1] = tlo;
            put[2 * u] = lead;
            put[2 * u + 1] = lead && tlo < len;
            ksc[2 * u] = lead && last ? seg_at(st + kStageBytes, kmis, thi0,
                                               thi, p.sc_bf16)
                                      : 0.f;
            ksc[2 * u + 1] = put[2 * u + 1] && last
                                 ? seg_at(st + kStageBytes + kSegHalf, kmis,
                                          thi0 + half_u, tlo, p.sc_bf16)
                                 : 0.f;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float acc[2 * U];
            row_dots<L::CW, L::LPR>(p.qq, qr[g], qi[g], v, v, kBias, acc);
#pragma unroll
            for (int k = 0; k < 2 * U; ++k) {
              if (!put[k]) continue;
              if constexpr (kPieces<D>)
                piece_score(acc[k], p.qq, pc, rsc.rs[g], rsc.off[g], ksc[k],
                            tok[k], idx, s + g * p.C, xidx + g);
              else
                finalize(acc[k], rsc.rs[g], rsc.off[g], ksc[k], tok[k], idx,
                         s + g * p.C, xidx + g);
            }
          }
        }
      });
}

// Softmax statistics over [0, len) of the plane's `rows` score rows: the
// row max, the denominator and, for pv_int8, the running max of e *
// vscale over the f32 e, into misc (misc[k * rows + g]); with `write`,
// also the in-place numerators s <- exp(s - max) (rounded to bf16 under
// probs_bf16).  Presoftmax importance reads the scores first and writes
// the numerators later (exp_rows), from the same max.  A thread takes 8
// consecutive columns at a time (one vector read of V scales).
__device__ void softmax_rows(const Params& p, float* s, int len, float* red,
                             float* misc, const uint8_t* vcol, bool write,
                             int rows) {
  for (int g = 0; g < rows; ++g) {
    float* row = s + g * p.C;
    float m = -INFINITY;
    for (int t = threadIdx.x; t < len; t += kThreads) m = fmaxf(m, row[t]);
    m = block_reduce(m, red, -INFINITY, [](float x) { return warp_max(x); });
    float sum = 0.f, emv = 0.f;
    for (int c0 = 8 * threadIdx.x; c0 < len; c0 += 8 * kThreads) {
      float vs[8];
      if (p.pv_int8) load_meta8(vcol, c0, p.sc_bf16, vs, min(8, len - c0));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = c0 + j;
        if (t < len) {
          const float e = expf(row[t] - m);
          if (p.pv_int8) emv = fmaxf(emv, __fmul_rn(e, vs[j]));
          if (write) row[t] = p.probs_bf16 ? round_bf16(e) : e;
          sum += e;
        }
      }
    }
    sum = block_reduce(sum, red, 0.f, [](float x) { return warp_sum(x); });
    if (p.pv_int8)
      emv = block_reduce(emv, red, 0.f, [](float x) { return warp_max(x); });
    if (threadIdx.x == 0) {
      misc[kDen * rows + g] = sum;
      misc[kMax * rows + g] = m;
      misc[kEmv * rows + g] = emv;
    }
  }
  __syncthreads();
}

// The numerators softmax_rows(write = false) summed, written in place.
// Thread x handles the 8-column chunks importance() reads, so no barrier
// is needed between the two.
__device__ void exp_rows(const Params& p, float* s, int len,
                         const float* misc, int rows) {
  for (int g = 0; g < rows; ++g) {
    float* row = s + g * p.C;
    const float m = misc[kMax * rows + g];
    for (int c0 = 8 * threadIdx.x; c0 < len; c0 += 8 * kThreads) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = c0 + j;
        if (t < len) {
          const float e = expf(row[t] - m);
          row[t] = p.probs_bf16 ? round_bf16(e) : e;
        }
      }
    }
  }
}

// This step's importance: delta(t) = sum over the plane's `rows` score
// rows g, in row order, of s[g][t] * wt(g) over the live columns
// (probabilities times the row weight, or scores times the head mask).
// Accumulated into the stacked plane (the appended slot starts from 0;
// the EMA applies once to the sum of every row), or written to the delta
// output over the whole window; 8 columns per thread, read and written as
// vectors where they align.  Inlined, so that a constant `rows` unrolls.
template <class W>
__device__ __forceinline__ void importance(const Params& p, const float* s,
                                           W wt, int rows, int len, int idx,
                                           bool do_app, size_t col0,
                                           float* dl) {
  if (p.imp != nullptr) {
    for (int c0 = 8 * threadIdx.x; c0 < len; c0 += 8 * kThreads) {
      float v[8];
      const int n = min(8, len - c0);   // columns past the length keep
      load_meta8(p.imp, col0 + c0, p.imp_bf16, v, n);   // their bytes
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = c0 + j;
        if (t < len) {
          float delta = 0.f;
#pragma unroll
          for (int g = 0; g < rows; ++g)
            delta += __fmul_rn(s[g * p.C + t], wt(g));
          const float prev = (do_app && t == idx) ? 0.f : v[j];
          v[j] = __fadd_rn(__fmul_rn(prev, p.ema), delta);
        }
      }
      store_meta8(p.imp, col0 + c0, v, p.imp_bf16, n);
    }
  } else if (dl != nullptr) {
    for (int c0 = 8 * threadIdx.x; c0 < p.C; c0 += 8 * kThreads) {
      if (p.per_row) {
#pragma unroll
        for (int g = 0; g < rows; ++g) {
          if (g >= p.g) break;                        // padding rows
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int t = c0 + j;
            v[j] = t < len ? __fmul_rn(s[g * p.C + t], wt(g)) : 0.f;
          }
          store_meta8(dl + static_cast<size_t>(g) * p.C, c0, v, 0,
                      min(8, p.C - c0));
        }
      } else {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int t = c0 + j;
          float delta = 0.f;
          if (t < len) {
#pragma unroll
            for (int g = 0; g < rows; ++g)
              delta += __fmul_rn(s[g * p.C + t], wt(g));
          }
          v[j] = delta;
        }
        store_meta8(dl, c0, v, 0, min(8, p.C - c0));
      }
    }
  }
}

// The k-th largest V-block mass of each of `rows` rows of n non-negative
// masses, into kth[row], for the device-plane instances (where counting
// each mass's rank costs n^2 loads at long windows): the largest bit
// pattern T with at least k masses >= T, found bit by bit (non-negative
// floats order as their patterns do), which is the value the counting
// rule picks (0 where k > n, which keeps the same blocks: those of mass
// > 0).  Rows go to the warps kWarps at a time, each row to kWarps / R
// warps (R rows in the round) that count slices of it, kSelUnroll loads in
// flight per lane; their counts meet in red[] once a bit.
constexpr int kSelUnroll = 8;
__device__ void kth_largest_rows(const float* mass, int rows, int n, int k,
                                 float* kth, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* cnt = reinterpret_cast<int*>(red);
  for (int r0 = 0; r0 < rows; r0 += kWarps) {
    const int R = min(rows - r0, kWarps), S = kWarps / R;
    const int row = warp / S, part = warp % S;
    const bool on = row < R;
    const float* m = mass + static_cast<size_t>(r0 + row) * n;
    const int span = (n + S - 1) / S;
    const int lo = part * span, hi = min(n, lo + span);
    uint32_t t = 0;
    for (int bit = 30; bit >= 0; --bit) {
      const uint32_t cand = t | (1u << bit);
      int c = 0;
      for (int j0 = on ? lo : hi; j0 < hi; j0 += 32 * kSelUnroll) {
        uint32_t v[kSelUnroll];
#pragma unroll
        for (int u = 0; u < kSelUnroll; ++u) {
          const int j = j0 + u * 32 + lane;
          v[u] = j < hi ? __float_as_uint(m[j]) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kSelUnroll; ++u)
          c += __popc(__ballot_sync(0xffffffffu, v[u] >= cand));
      }
      __syncthreads();                     // earlier readers of red are done
      if (lane == 0) cnt[warp] = c;
      __syncthreads();
      int total = 0;
      for (int q = 0; q < S; ++q) total += on ? cnt[row * S + q] : 0;
      if (total >= k) t = cand;
    }
    if (on && part == 0 && lane == 0) kth[r0 + row] = __uint_as_float(t);
  }
}

// Zero output, kept-block mask and delta of a group that computes nothing
// more (a dead head group, or a row with no live token): its p.g live
// rows of p.d lanes only.
__device__ void zero_outputs(const Params& p, int b, int hq0, size_t out0,
                             int nvb, float* dl) {
  for (int i = threadIdx.x; i < p.g * p.d; i += kThreads)
    p.out[out0 + i] = 0.f;
  if (p.keep_out != nullptr && p.keep_blocks > 0) {
    for (int i = threadIdx.x; i < p.g * nvb; i += kThreads)
      p.keep_out[static_cast<size_t>(b) * p.Hq * nvb + hq0 * nvb + i] = 0;
  }
  if (dl != nullptr) {
    const int n = (p.per_row ? p.g : 1) * p.C;
    for (int i = threadIdx.x; i < n; i += kThreads) dl[i] = 0.f;
  }
}

// kSmemScores: the [G, C] score plane lies in shared memory (p.splane is
// null), so its loads and stores compile to shared-memory instructions;
// else it is this CTA's slice of the device-memory plane p.splane.
//
// G is the instance's group; the model's group p.g may be smaller (3 runs
// in <4, D>; 5, 6 and 7 in <8, D>).  Rows g >= p.g are padding: they read
// no query (zeros: every score 0, finite), count as dead rows (zero row
// weight and V-block mass, so no importance, keep decision or P·V term),
// enter neither the group's max probability nor the row stats, and write
// nothing.  Every [B, Hq] index uses p.g.
//
// A group past 8 runs in the device-plane <8, D, false> instances, in
// chunks of G query rows inside the one CTA of (kv head, batch row): the
// plane holds rows = ceil(g / G) * G score rows.  The append runs once;
// pass 1, the requant recompute and P·V run once per chunk (each with the
// chunk's queries and accumulators in registers); the softmax, the
// requant decision (one per CTA, over every row), the importance sum (over
// every row, one EMA), the V-block masses and keep masks run over all
// rows.  The per-row scalars (misc) hold `rows` entries each.  In those
// instances the per-V-block arrays (masses, keep masks, kept-block list)
// lie in shared memory after the scalars, or, where the wrapper passes
// p.bplane because the plan would pass 227 KB, in this CTA's slice of
// that device plane (generic loads: the pointer is chosen at run time
// only here, so the shared-plane instances keep their shared-memory
// instructions).
template <int G, int D, bool kSmemScores>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const __grid_constant__ Params p) {
  constexpr int VEC = D / 32;
  using L = Lanes<G, D>;
  constexpr int CW = L::CW;
  extern __shared__ __align__(128) uint8_t smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lrow = lane / L::LPR, lcol = lane % L::LPR;
  const int C = p.C, F = p.F;
  const int nvb = C / p.v_block;
  const int gl = p.g;                               // live rows
  // chunks of G rows and the score rows: only <8, D, false> runs a group
  // past its G (elsewhere they are the constants 1 and G, so the other
  // instances keep their registers)
  constexpr bool kChunks = !kSmemScores && G == 8;
  const int nch = kChunks ? (gl + G - 1) / G : 1;
  const int MG = kChunks ? nch * G : G;

  Ring ring{smem, reinterpret_cast<uint64_t*>(smem + kStages * kStageStride),
            0};
  float* scratch = reinterpret_cast<float*>(ring.bar + kStages);
  float *s, *pv, *mass, *red, *misc, *app;
  int* kblk;
  uint8_t *keep, *keep_any;
  if constexpr (kSmemScores) {
    s = scratch;                                    // [G, C]
    pv = s + G * C;                                 // [kWarps, G, D]
    mass = pv + kWarps * G * D;                     // [G, nvb]
    red = mass + G * nvb;                           // [kWarps]
    misc = red + kWarps;                            // [kMisc, G]
    app = misc + kMisc * G;                         // k, v f32 new scales
    kblk = reinterpret_cast<int*>(app + 2);         // kept blocks, count
    keep = reinterpret_cast<uint8_t*>(kblk + nvb + 1);   // [G, nvb]
  } else {
    s = p.splane + (static_cast<size_t>(b) * p.Hkv + h) * MG * C;
    pv = scratch;
    red = pv + kWarps * G * D;
    misc = red + kWarps;                            // [kMisc, MG]
    app = misc + kMisc * MG;
    uint8_t* blk = p.bplane != nullptr
        ? p.bplane + (static_cast<size_t>(b) * p.Hkv + h) * p.bstride
        : reinterpret_cast<uint8_t*>(app + 2);
    mass = reinterpret_cast<float*>(blk);           // [MG, nvb]
    kblk = reinterpret_cast<int*>(mass + MG * nvb);
    keep = reinterpret_cast<uint8_t*>(kblk + nvb + 1);   // [MG, nvb]
  }
  keep_any = keep + MG * nvb;                       // [nvb]
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(ring.bar + i)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  const int len = p.lengths[b];
  const bool do_app = p.appmask == nullptr || p.appmask[b] != 0;
  const int hq0 = h * gl;                           // first q head of group
  const int d = p.d;                                // live lanes of D
  const int sh = h * d - box_col(p, h);            // their offset in a row
  // lane pieces (boxes): only D = 256 runs a head in more than one, so
  // the other instances compile the one-piece code they had before
  const int npc = kPieces<D> ? (sh + d + D - 1) / D : 1;
  auto lane_piece = [&](int j) {
    return Piece{j, box_col(p, h) + j * D, j + 1 == npc};
  };
  const size_t out0 = (static_cast<size_t>(b) * p.Hq + hq0) * d;
  const size_t row0 = static_cast<size_t>(b) * p.Hq + hq0;   // [B, Hq] index
  float* dl = p.delta == nullptr ? nullptr
            : p.delta + (p.per_row ? row0 : static_cast<size_t>(b) * p.Hkv + h)
                            * C;
  // an appending row holds its new token; only a non-appending one (a
  // split-K shard past the kept prefix) may hold none
  if (len < (do_app ? 1 : 0) || len > C) {          // contract violation
    for (int i = threadIdx.x; i < gl * d; i += kThreads) p.out[out0 + i] = NAN;
    if (threadIdx.x == 0) p.max_prob[b * p.Hkv + h] = NAN;
    return;
  }
  auto row_alive = [&](int r) {
    return r < gl && (p.hmask == nullptr || p.hmask[row0 + r] != 0);
  };
  bool alive[G];
  bool any_alive = false;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    alive[g] = row_alive(g);
    any_alive |= alive[g];
  }
  for (int r = G; r < MG; ++r) any_alive |= row_alive(r);   // later chunks
  auto alive_at = [&](int r) {
    if constexpr (kSmemScores) {
      return alive[r];
    } else {
      return row_alive(r);
    }
  };
  if (len == 0) {
    // no live column: every score is masked, so m = MASK_VALUE, e = 0 and
    // den sits at its 1e-30 floor (max prob 1e30, which never requantizes)
    zero_outputs(p, b, hq0, out0, nvb, dl);
    if (p.mrow != nullptr) {
      for (int r = threadIdx.x; r < gl; r += kThreads) {
        p.mrow[row0 + r] = kMaskValue;
        p.drow[row0 + r] = 1e-30f;
      }
    }
    if (threadIdx.x == 0) {
      p.max_prob[b * p.Hkv + h] = any_alive ? 1e30f : 0.f;
      p.need[b * p.Hkv + h] = 0;
    }
    return;
  }
  const int idx = len - 1;

  const size_t plane_b = static_cast<size_t>(b) * p.Ct * F;
  const size_t packed_b = static_cast<size_t>(b) * (p.Ct / 2) * F;
  const size_t lsb2_b = static_cast<size_t>(b) * (p.Ct / 4) * F;
  const size_t col0 = (static_cast<size_t>(b) * p.Hkv + h) * p.Ct;
  const int es = p.sc_bf16 ? 2 : 4;
  int8_t* kf = p.kfull + plane_b + h * d;
  int8_t* vf = p.vfull + plane_b + h * d;
  uint8_t* km = p.kmsb ? p.kmsb + packed_b + h * d : nullptr;
  uint8_t* kl2 = p.klsb2 ? p.klsb2 + lsb2_b + h * d : nullptr;
  uint8_t* vm = p.vmsb ? p.vmsb + packed_b + h * d : nullptr;
  const uint8_t* kcol = static_cast<const uint8_t*>(p.kscale) + col0 * es;
  const uint8_t* vcol = static_cast<const uint8_t*>(p.vscale) + col0 * es;

  // ---- append (warp 0: K, warp 1: V) -------------------------------------
  if (do_app) {
    const int u = p.pack_unit;
    const int r_u = idx % u;
    const bool is_hi = r_u < u / 2;
    const size_t prow = static_cast<size_t>(idx / u) * (u / 2) + r_u % (u / 2);
    const size_t lrow2 = static_cast<size_t>(idx / u) * (u / 4) + r_u % (u / 4);
    const int l2_shift = 6 - 2 * (r_u / (u / 4));
    const size_t src = (static_cast<size_t>(b) * p.Hkv + h) * d;
    if (warp == 0) {
      append_row<VEC>(p.k_new + src, d, kf + static_cast<size_t>(idx) * F,
                      p.kscale, col0 + idx, p.sc_bf16, app,
                      km ? km + prow * F : nullptr, is_hi,
                      kl2 ? kl2 + lrow2 * F : nullptr, l2_shift);
    } else if (warp == 1) {
      append_row<VEC>(p.v_new + src, d, vf + static_cast<size_t>(idx) * F,
                      p.vscale, col0 + idx, p.sc_bf16, app + 1,
                      vm ? vm + prow * F : nullptr, is_hi, nullptr, 0);
    }
  }
  // the bulk copies (async proxy) read what the append stored (generic
  // proxy): fence, then the block sees its row
  asm volatile("fence.proxy.async;" ::: "memory");
  __syncthreads();

  // ---- head gating: a dead group appended, and does nothing else, but
  // for its row stats (the Pallas body scores every row)
  if (!any_alive && p.mrow == nullptr) {
    zero_outputs(p, b, hq0, out0, nvb, dl);
    if (threadIdx.x == 0) {
      p.max_prob[b * p.Hkv + h] = 0.f;
      p.need[b * p.Hkv + h] = 0;
    }
    return;
  }

  // ---- pass 1's profile --------------------------------------------------
  const int bits = !p.quant ? 8 : (p.qbits ? p.qbits[p.layer] : 4);
  const bool p1_full = bits == 8;
  const bool use6 = bits == 6 && kl2 != nullptr;
  const float mult = p1_full ? 1.f : (use6 ? 4.f : 16.f);
  const float moff = p1_full ? 0.f : (use6 ? kMidpoint6 : kMsbMidpoint) - 128.f;

  // ---- the queries of the chunk from row r0 in registers, piece j's
  // lanes (a lane holds tile columns lcol*CW + c of every row: head column
  // j*D + lcol*CW + c - sh; columns outside the head's d read 0, so the
  // tile bytes there, a neighbouring head's or zeros, add nothing),
  // optionally quantized to int8 per row (by the whole row's amax), with
  // the rows' score constants for pass 1 (rs1) and the int8 recompute
  // (rs2), whose lane sums run over every piece in piece order; every row
  // group derives the same constants
  float qr[G][CW];
  int qi[G][CW / 4];                                // int8 queries, 4 a word
  RowScale<G> rs1, rs2;
  auto load_queries = [&](int r0, int j) {
    float rowscale[G], qsum[G];
    auto qval = [&](int r, int jj, int c) {
      const int col = jj * D + lcol * CW + c - sh;
      return r < gl && col >= 0 && col < d ? p.q[out0 + r * d + col] : 0.f;
    };
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if constexpr (!kPieces<D>) {                   // one piece
        const int r = r0 + g;
        float amax = 0.f;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          qr[g][c] = qval(r, 0, c);
          amax = fmaxf(amax, fabsf(qr[g][c]));
        }
        rowscale[g] = 1.f;
        if (p.qq) {
          rowscale[g] = fmaxf(group_max<L::LPR>(amax), 1e-20f) / 127.f;
#pragma unroll
          for (int c = 0; c < CW; ++c)
            qr[g][c] =
                fminf(fmaxf(rintf(qr[g][c] / rowscale[g]), -127.f), 127.f);
        }
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < CW; ++c) sum += qr[g][c];
        qsum[g] = group_sum<L::LPR>(sum);
        continue;
      }
      const int r = r0 + g;
      float amax = 0.f;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        qr[g][c] = qval(r, j, c);
        amax = fmaxf(amax, fabsf(qr[g][c]));
      }
      for (int jj = 0; jj < npc; ++jj) {
        if (jj == j) continue;
#pragma unroll
        for (int c = 0; c < CW; ++c) amax = fmaxf(amax, fabsf(qval(r, jj, c)));
      }
      rowscale[g] = 1.f;
      if (p.qq) {
        rowscale[g] = fmaxf(group_max<L::LPR>(amax), 1e-20f) / 127.f;
#pragma unroll
        for (int c = 0; c < CW; ++c)
          qr[g][c] = fminf(fmaxf(rintf(qr[g][c] / rowscale[g]), -127.f), 127.f);
      }
      qsum[g] = 0.f;
      for (int jj = 0; jj < npc; ++jj) {
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          float v = qr[g][c];
          if (jj != j) {
            v = qval(r, jj, c);
            if (p.qq) v = fminf(fmaxf(rintf(v / rowscale[g]), -127.f), 127.f);
          }
          sum += v;
        }
        qsum[g] += group_sum<L::LPR>(sum);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < CW / 4; ++k) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v |= (static_cast<uint32_t>(static_cast<int>(qr[g][4 * k + j])) & 0xFFu)
               << (8 * j);
        qi[g][k] = static_cast<int>(v);
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      rs1.rs[g] = __fmul_rn(rowscale[g], __fmul_rn(mult, p.sm_scale));
      rs1.off[g] = p.quant ? __fmul_rn(__fmul_rn(rowscale[g], qsum[g]),
                                       __fmul_rn(moff, p.sm_scale))
                           : 0.f;
      rs2.rs[g] = __fmul_rn(rowscale[g], p.sm_scale);
      rs2.off[g] = 0.f;
    }
  };
  load_queries(0, 0);

  // ---- pass 1 on the layer's profile (per chunk and lane piece) +
  // softmax + requant decision (over every row)
  for (int c = 0; c < nch; ++c) {
    float* sc = s + static_cast<size_t>(c) * G * C;
    float* xc = misc + kXidx * MG + c * G;
    for (int j = 0; j < npc; ++j) {
      if (c > 0 || j > 0) load_queries(c * G, j);
      if (p1_full) {
        scores_full<G, D>(p, b, lane_piece(j), ring, kf, kcol, qr, qi, rs1, len,
                          idx, sc, xc);
      } else {
        scores_msb<G, D>(p, b, lane_piece(j), ring, km, use6 ? kl2 : nullptr, kcol,
                         qr, qi, rs1, len, idx, sc, xc);
      }
    }
  }
  // presoftmax keeps the scores until its importance has read them
  const bool write_e = !p.presoftmax;
  softmax_rows(p, s, len, red, misc, vcol, write_e, MG);
  float mp = 0.f;
#pragma unroll
  for (int g = 0; g < MG; ++g)
    if (g < gl) mp = fmaxf(mp, 1.f / fmaxf(misc[kDen * MG + g], 1e-30f));
  // an 8-bit pass 1 already read the int8 plane: it never requantizes
  const bool fire = any_alive && p.requant && !p1_full &&
                    mp < p.threshold;               // uniform
  if (threadIdx.x == 0) {
    p.max_prob[b * p.Hkv + h] = any_alive ? mp : 0.f;
    p.need[b * p.Hkv + h] = fire ? 1 : 0;
  }
  if (fire) {
    __syncthreads();
    for (int c = 0; c < nch; ++c)
      for (int j = 0; j < npc; ++j) {
        if (nch > 1 || npc > 1) load_queries(c * G, j);
        scores_full<G, D>(p, b, lane_piece(j), ring, kf, kcol, qr, qi, rs2, len,
                          idx, s + static_cast<size_t>(c) * G * C,
                          misc + kXidx * MG + c * G);
      }
    softmax_rows(p, s, len, red, misc, vcol, write_e, MG);
  }
  if (p.mrow != nullptr) {
    for (int r = threadIdx.x; r < gl; r += kThreads) {
      p.mrow[row0 + r] = misc[kMax * MG + r];
      p.drow[row0 + r] = fmaxf(misc[kDen * MG + r], 1e-30f);
    }
  }
  if (!any_alive) {                                 // row stats only
    zero_outputs(p, b, hq0, out0, nvb, dl);
    return;
  }
  if (p.presoftmax) {
    float hm[G];
#pragma unroll
    for (int g = 0; g < G; ++g) hm[g] = alive[g] ? 1.f : 0.f;
    importance(p, s,
               [&](int g) {
                 if constexpr (kSmemScores) {
                   return hm[g];
                 } else {
                   return row_alive(g) ? 1.f : 0.f;
                 }
               },
               MG, len, idx, do_app, col0, dl);
    exp_rows(p, s, len, misc, MG);
  }
  for (int g = threadIdx.x; g < MG; g += kThreads) {
    const float inv = 1.f / fmaxf(misc[kDen * MG + g], 1e-30f);
    const float wrow = alive_at(g) ? inv : 0.f;
    misc[kWrow * MG + g] = wrow;
    misc[kWmax * MG + g] = __fmul_rn(misc[kEmv * MG + g], wrow);
    // the appended column's probability with the new row's f32 K scale
    misc[kEidx * MG + g] =
        do_app ? expf(__fmul_rn(misc[kXidx * MG + g], app[0]) -
                      misc[kMax * MG + g])
               : 0.f;
  }
  __syncthreads();
  const float* wrow = misc + kWrow * MG;

  // ---- prob importance: probabilities times the row weight -------------
  if (!p.presoftmax)
    importance(p, s, [&](int g) { return wrow[g]; }, MG, len, idx, do_app,
               col0, dl);

  // ---- local V pruning: per-row block keep mask --------------------------
  const bool vprune = p.keep_blocks > 0;
  int nk = (len + p.v_block - 1) / p.v_block;      // blocks P·V streams
  if (vprune) {
    for (int i = threadIdx.x; i < MG * nvb; i += kThreads) {
      const int g = i / nvb, j = i % nvb;
      const int t0 = j * p.v_block, t1 = min(t0 + p.v_block, len);
      float m = 0.f;
      for (int t = t0; t < t1; ++t) m += s[g * C + t];
      mass[i] = alive_at(g) ? m : 0.f;
    }
    __syncthreads();
    if constexpr (kSmemScores) {
      for (int g = 0; g < G; ++g) {
        // k-th largest by counting: the smallest mass whose strictly-
        // greater count is below keep_blocks (ties kept)
        float cand = INFINITY;
        for (int j = threadIdx.x; j < nvb; j += kThreads) {
          const float mj = mass[g * nvb + j];
          int rank = 0;
          for (int i = 0; i < nvb; ++i) rank += mass[g * nvb + i] > mj;
          if (rank < p.keep_blocks) cand = fminf(cand, mj);
        }
        cand = block_reduce(cand, red, INFINITY,
                            [](float x) { return warp_min(x); });
        if (threadIdx.x == 0) misc[kKth * G + g] = cand;
      }
    } else {
      kth_largest_rows(mass, MG, nvb, p.keep_blocks, misc + kKth * MG, red);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nvb; j += kThreads) {
      uint8_t any = 0;
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float mj = mass[g * nvb + j];
        const uint8_t k = (mj >= misc[kKth * MG + g]) && (mj > 0.f);
        keep[g * nvb + j] = k;
        any |= k;
        if (p.keep_out != nullptr && g < gl)
          p.keep_out[(static_cast<size_t>(b) * p.Hq + hq0 + g) * nvb + j] = k;
      }
      keep_any[j] = any;
    }
    __syncthreads();
    // the blocks some row keeps, in order (warp 0, 32 at a time)
    if (warp == 0) {
      int n = 0;
      for (int j0 = 0; j0 < nvb; j0 += 32) {
        const int j = j0 + lane;
        const bool k = j < nvb && keep_any[j];
        const unsigned bal = __ballot_sync(0xffffffffu, k);
        if (k) kblk[n + __popc(bal & ((1u << lane) - 1u))] = j;
        n += __popc(bal);
      }
      if (lane == 0) kblk[nvb] = n;
    }
    __syncthreads();
    nk = kblk[nvb];
  }

  // ---- P·V over the kept blocks, streamed as a run of "virtual rows"
  // (the kept blocks' rows back to back); a tile is tpv of them, made of
  // pieces that lie inside one block, each with its V scale segment.  The
  // appended column comes last, from the new row's f32 V scale (pv_int8:
  // 8-bit row weights w8 = rint(w * 127 / wmax) on the stored int8 rows,
  // int32 sums, kept in the f32 accumulators' bits).  One stream per chunk
  // of G rows (the kept blocks are every row's) and lane piece, which
  // writes the piece's columns
  const int tpv = p.tpv, piece = p.piece;
  const int sstride = seg_stride(piece, es), vmis = misalign(vcol);
  const int nvr = nk * p.v_block;
  auto token = [&](int vr) {
    const int k = vr / p.v_block;
    return (vprune ? kblk[k] : k) * p.v_block + vr % p.v_block;
  };
  auto fetched = [&](int t) { return t < len && (t != idx || !do_app); };
  // a piece of n virtual rows from token tf is one TMA box when all of
  // its rows are fetched, and always where rows are d < D lanes (4-byte
  // aligned: no row copies; the rows it reads past those fetched are
  // never consumed)
  auto whole = [&](int tf, int n) {
    return p.v_box && n == piece &&
           (d != D || (tf + piece <= len &&
                       !(do_app && idx >= tf && idx < tf + piece)));
  };
  const uint8_t* vplane = reinterpret_cast<const uint8_t*>(vf);
  const float kept_scale = 1.f / 127.f;
  for (int c = 0; c < nch; ++c)
  for (int lp = 0; lp < npc; ++lp) {
    const int r0 = c * G;
    const int pcol = box_col(p, h) + lp * D;        // the piece's boxes
    const float* sc = s + static_cast<size_t>(r0) * C;
    const uint8_t* kc = keep + r0 * nvb;
    const float* wc = wrow + r0;
    const float* wmx = misc + kWmax * MG + r0;
    float acc[G][CW];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) acc[g][cc] = 0.f;
    float wrecip[G];
#pragma unroll
    for (int g = 0; g < G; ++g) wrecip[g] = 127.f / fmaxf(wmx[g], 1e-30f);
    stream_tiles(
        ring, (nvr + tpv - 1) / tpv,
        [&](int i, uint8_t* st, uint32_t bar, bool go) {
          const int vr0 = i * tpv, rows = min(tpv, nvr - vr0);
          uint32_t bytes = 0;
          for (int rr = lane; rr < rows; rr += 32) {
            const int j = rr / piece;
            const int t = token(vr0 + rr);
            if (fetched(t) &&
                !whole(t - rr % piece, min(piece, rows - j * piece))) {
              if (go)
                bulk_copy(st + rr * D, vplane + static_cast<size_t>(t) * F,
                          D, bar);
              bytes += D;
            }
          }
          for (int j = lane; j * piece < rows; j += 32) {
            const int tf = token(vr0 + j * piece);
            const int n = min(piece, rows - j * piece);
            bytes += seg_copy(st + kStageBytes + j * sstride, vcol, tf, n, es,
                              bar, go);
            if (whole(tf, n)) {
              if (go)
                tensor_copy(st + j * piece * D, &p.vf_map, pcol, b * p.Ct + tf,
                            bar);
              bytes += piece * D;
            }
          }
          return bytes;
        },
        [&](int i, const uint8_t* st) {
          const int vr0 = i * tpv, rows = min(tpv, nvr - vr0);
          for (int base = warp * L::RPW; base < rows; base += kWarps * L::RPW) {
            const int rr = base + lrow;
            const int t = rr < rows ? token(vr0 + rr) : len;
            if (!fetched(t)) continue;                 // no shuffles below
            uint32_t w[CW / 4];
            lds<CW>(st + rr * D + lcol * CW, w);
            const float scl = seg_at(st + kStageBytes + (rr / piece) * sstride,
                                     vmis, t - rr % piece, t, p.sc_bf16);
            const int j = t / p.v_block;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const bool kept = !vprune || kc[g * nvb + j];
              const float wt = kept
                  ? __fmul_rn(__fmul_rn(sc[g * C + t], wc[g]), scl)
                  : 0.f;
              if (p.pv_int8) {
                const int w8 = static_cast<int>(
                    fminf(fmaxf(rintf(__fmul_rn(wt, wrecip[g])), 0.f), 127.f));
#pragma unroll
                for (int cc = 0; cc < CW; ++cc)
                  acc[g][cc] = __int_as_float(
                      __float_as_int(acc[g][cc]) +
                      w8 * static_cast<int>(static_cast<int8_t>(byte_at(w, cc))));
              } else {
#pragma unroll
                for (int cc = 0; cc < CW; ++cc)
                  acc[g][cc] = fmaf(wt, int8_at(w, cc), acc[g][cc]);
              }
            }
          }
        });
    // the warp's row groups hold partial sums of the same columns
#pragma unroll
    for (int o = L::LPR; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          const float other = __shfl_xor_sync(0xffffffffu, acc[g][cc], o);
          acc[g][cc] = p.pv_int8 ? __int_as_float(__float_as_int(acc[g][cc]) +
                                                  __float_as_int(other))
                                 : acc[g][cc] + other;
        }
    }
    if (lrow == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int cc = 0; cc < CW; ++cc)
          pv[(warp * G + g) * D + lcol * CW + cc] = acc[g][cc];
    }
    __syncthreads();
    const int* pvi = reinterpret_cast<const int*>(pv);
    // the partials' lanes outside the head's (its neighbours' bytes) are
    // never read; the chunk's live rows only, the head columns [lo, hi) of
    // the piece
    const int glc = min(G, gl - r0);
    int lo = 0, n = d;
    if constexpr (kPieces<D>) {
      lo = max(0, lp * D - sh);
      n = min(d, (lp + 1) * D - sh) - lo;
    }
    for (int i = threadIdx.x; i < glc * n; i += kThreads) {
      const int g = i / n, dd = lo + i % n, k = g * D + sh + dd - lp * D;
      float o;
      if (p.pv_int8) {
        int sum = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += pvi[w * G * D + k];
        o = __fmul_rn(static_cast<float>(sum), __fmul_rn(wmx[g], kept_scale));
      } else {
        o = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) o += pv[w * G * D + k];
      }
      if (do_app) {
        const float kept_new =
            (!vprune || kc[g * nvb + idx / p.v_block]) ? 1.f : 0.f;
        const float p_idx = __fmul_rn(
            __fmul_rn(misc[kEidx * MG + r0 + g], wc[g]), kept_new);
        const float vnew = __fmul_rn(
            static_cast<float>(vf[static_cast<size_t>(idx) * F + dd]), app[1]);
        o = __fadd_rn(o, __fmul_rn(p_idx, vnew));
      }
      p.out[out0 + static_cast<size_t>(r0 + g) * d + dd] = o;
    }
    if (c + 1 < nch || lp + 1 < npc) __syncthreads();   // pv is the next's
  }
}

// skip_append: the bytes of K1 CTA (blockIdx.y, blockIdx.x)'s d lanes that
// its append writes -- K int8 and V int8 at slot idx, K msb and V msb at
// the token's packed row, K lsb2 at its 2-bit row -- copied into its slice
// of `stash` ([B, Hkv, 5, stash_row] bytes) before K1 (put), or back into
// the planes after it (take).  Warp 0 moves K's rows, warp 1 V's, a lane
// every 32nd byte; a row that does not append (or holds no token) has
// nothing to move.
#if K1_PART != 3
__global__ void stash_kernel(const __grid_constant__ Params p,
                             uint8_t* stash, int stash_row, bool put) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y, len = p.lengths[b];
  if (warp > 1 || len < 1 || len > p.C ||
      (p.appmask != nullptr && p.appmask[b] == 0))
    return;
  const int idx = len - 1, d = p.d, u = p.pack_unit, r_u = idx % u;
  const size_t F = p.F, lanes = static_cast<size_t>(h) * d;
  const size_t full = (static_cast<size_t>(b) * p.Ct + idx) * F + lanes;
  const size_t packed = (static_cast<size_t>(b) * (p.Ct / 2) +
                         static_cast<size_t>(idx / u) * (u / 2) + r_u % (u / 2)) *
                            F + lanes;
  const size_t lsb2 = (static_cast<size_t>(b) * (p.Ct / 4) +
                       static_cast<size_t>(idx / u) * (u / 4) + r_u % (u / 4)) *
                          F + lanes;
  uint8_t* rows[3] = {nullptr, nullptr, nullptr};
  if (warp == 0) {
    rows[0] = reinterpret_cast<uint8_t*>(p.kfull) + full;
    if (p.kmsb) rows[1] = p.kmsb + packed;
    if (p.klsb2) rows[2] = p.klsb2 + lsb2;
  } else {
    rows[0] = reinterpret_cast<uint8_t*>(p.vfull) + full;
    if (p.vmsb) rows[1] = p.vmsb + packed;
  }
  uint8_t* st = stash + ((static_cast<size_t>(b) * p.Hkv + h) * 5 +
                         (warp == 0 ? 0 : 3)) * stash_row;
  for (int k = 0; k < 3; ++k) {
    if (rows[k] == nullptr) continue;
    for (int c = lane; c < d; c += 32) {
      if (put) {
        st[k * stash_row + c] = rows[k][c];
      } else {
        rows[k][c] = st[k * stash_row + c];
      }
    }
  }
}
#endif  // K1_PART != 3

// Bytes of one CTA's per-V-block arrays over `rows` score rows: masses
// (f32 [rows, nvb]), the kept-block list and its count (int [nvb + 1]),
// the keep masks ([rows, nvb] bytes) and their union ([nvb] bytes).
size_t block_bytes(int rows, int nvb) {
  return sizeof(float) * (static_cast<size_t>(rows) * nvb + nvb + 1) +
         static_cast<size_t>(rows + 1) * nvb;
}

// Shared memory of one CTA of instance <G, D> over `rows` score rows (G,
// or a multiple of it for a group past the instance's): the ring, the
// [G, C] score plane only when it is not in device memory, the per-warp
// P·V partials, the scalars and, unless they lie in device memory, the
// per-V-block arrays.  spatten_tpu_torch/ops/fused_decode.py::smem_bytes
// mirrors it (and raises before a launch past the limit).
size_t smem_bytes(int G, int D, int C, int v_block, bool scores_in_smem,
                  int rows, bool blocks_in_smem) {
  const int nvb = C / v_block;
  return static_cast<size_t>(kStages) * (kStageStride + sizeof(uint64_t)) +
         sizeof(float) * ((scores_in_smem ? static_cast<size_t>(G) * C : 0) +
                          kWarps * G * D + kWarps + kMisc * rows + 2) +
         (blocks_in_smem ? block_bytes(rows, nvb) : 0);
}

template <int G, int D>
cudaError_t launch(const Params& p, int B, int rows, cudaStream_t stream) {
  const bool in_smem = p.splane == nullptr;
  const size_t smem = smem_bytes(G, D, p.C, p.v_block, in_smem, rows,
                                 p.bplane == nullptr);
  void (*kernel)(Params) = nullptr;
  if (in_smem) {
    if constexpr (K1_PART != 2) kernel = fused_decode_kernel<G, D, true>;
  } else {
    if constexpr (K1_PART == 1)
      return static_cast<cudaError_t>(spatten_fused_decode_device_plane(
          &p, B, G, D, rows, stream));
    else
      kernel = fused_decode_kernel<G, D, false>;
  }
  if (kernel == nullptr) return cudaErrorInvalidDeviceFunction;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(p.Hkv, B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// G: the instance the wrapper chose for the model's group p.g (the
// smallest of 1, 2, 4, 8 that holds it, and 8 past 8; its shared-memory
// plan and score plane slices are sized by G and `rows`).
template <int D>
cudaError_t launch_g(const Params& p, int B, int G, int rows,
                     cudaStream_t stream) {
  switch (G) {
    case 1: return launch<1, D>(p, B, rows, stream);
    case 2: return launch<2, D>(p, B, rows, stream);
    case 4: return launch<4, D>(p, B, rows, stream);
    case 8: return launch<8, D>(p, B, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool misaligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) != 0;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

struct MapKey {
  uintptr_t base;
  uint64_t rows;
  int F, D, box;
  CUtensorMapSwizzle swizzle;
  bool operator==(const MapKey& o) const {
    return base == o.base && rows == o.rows && F == o.F && D == o.D &&
           box == o.box && swizzle == o.swizzle;
  }
};

struct MapHash {
  size_t operator()(const MapKey& k) const {
    return k.base ^ (k.rows * 0x9E3779B97F4A7C15ull) ^
           (static_cast<size_t>(k.F) << 40) ^ (static_cast<size_t>(k.D) << 20) ^
           static_cast<size_t>(k.box) ^ (static_cast<size_t>(k.swizzle) << 12);
  }
};

// The TMA tensor map of a plane of `rows` rows of F bytes, read in boxes
// of D bytes x `box` rows (written to shared memory as they are, or under
// a swizzle, which the latent instance asks for); encoded once per (base,
// shape, box) -- once per plane allocation and layer -- and cached, so a
// call only looks it up.
cudaError_t plane_map(const void* base, uint64_t rows, int F, int D, int box,
                      CUtensorMap* out,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  static std::unordered_map<MapKey, CUtensorMap, MapHash> cache;
  static EncodeTiled encode = nullptr;
  const MapKey key{reinterpret_cast<uintptr_t>(base), rows, F, D, box,
                   swizzle};
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (fn == nullptr || found != cudaDriverEntryPointSuccess)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  CUtensorMap m;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(F), rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(F)};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(D),
                              static_cast<cuuint32_t>(box)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, boxd, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cache.emplace(key, m);
  *out = m;
  return cudaSuccess;
}

// The ring's geometry and the tensor maps of this call's planes.
cudaError_t plan_ring(Params& p, int B, int D) {
  const int k_rows = kStageBytes / D;
  const int u = p.pack_unit;
  p.t_msb = divisor_rows(p.klsb2 ? k_rows / 2 : k_rows, p.klsb2 ? u / 4 : u / 2);
  if (p.v_block >= k_rows) {
    p.tpv = tile_rows(k_rows, p.v_block);
    p.piece = p.tpv;
  } else {
    int nb = k_rows / p.v_block;
    while (nb > 1 && nb * seg_stride(p.v_block, p.sc_bf16 ? 2 : 4) > kSegBytes)
      --nb;
    p.tpv = nb * p.v_block;
    p.piece = p.v_block;
  }
  // a box lands 128-byte aligned: piece j at j*piece*D, the lsb2 half at
  // l2_off (t_msb may be odd: a half-unit of any even capacity's)
  p.v_box = p.piece * D % 128 == 0;
  p.l2_off = (p.t_msb * D + 127) & ~127;
  // rows of d < D lanes are copied only as boxes (the wrapper's instance
  // choice keeps V pieces boxable)
  if (p.d != D && !p.v_box) return cudaErrorInvalidValue;
  const uint64_t rows = static_cast<uint64_t>(B) * p.Ct;
  cudaError_t e = plane_map(p.kfull, rows, p.F, D, k_rows, &p.kf_map);
  if (e == cudaSuccess && p.kmsb)
    e = plane_map(p.kmsb, rows / 2, p.F, D, p.t_msb, &p.km_map);
  if (e == cudaSuccess && p.klsb2)
    e = plane_map(p.klsb2, rows / 4, p.F, D, p.t_msb, &p.kl2_map);
  if (e == cudaSuccess)
    e = plane_map(p.vfull, rows, p.F, D, p.piece, &p.vf_map);
  return e;
}

}  // namespace

#if K1_PART == 2
extern "C" int spatten_fused_decode_device_plane(const void* params, int B,
                                                 int G, int D, int rows,
                                                 void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch_g<64>(p, B, G, rows, s));
    case 128: return static_cast<int>(launch_g<128>(p, B, G, rows, s));
    case 256: return static_cast<int>(launch_g<256>(p, B, G, rows, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#elif K1_PART != 3
// Returns cudaGetLastError() after the launch (0 = success); the wrapper
// (spatten_tpu_torch/ops/fused_decode.py) validates shapes and flags.
// The bulk copies and tensor maps need 16-byte-aligned plane bases and a
// row stride F = Hkv * d that is a multiple of 16; scale, importance and
// delta columns may start anywhere (their segments and vectors align
// themselves).  `G`, `D`: the <G, D> instance, which holds the model's
// group g = Hq / Hkv (its smallest such G, or 8 in chunks of 8 rows for g
// past 8) and head_dim d (the wrapper's fused_decode.instance_dim: 256 in
// lane pieces for d past 256 lanes);
// `splane`: f32 [B, Hkv, rows, C] for the score plane, rows = ceil(g / G)
// * G, when the wrapper finds that the instance's shared-memory plan with
// it would pass 227 KB or g passes G, else null; `bplane`: bytes [B, Hkv,
// round16(block_bytes(rows, C / v_block))] for the per-V-block arrays when
// the plan with them would still pass 227 KB (only with `splane`), else
// null.  G = 16 asks for the latent instance (csrc/fused_decode_latent.cu,
// which checks the rest of the call): `splane` is then f32 [B, 16, C + 4]
// or null, and `D` is not read.
extern "C" int spatten_fused_decode(
    const float* q, const float* k_new, const float* v_new, const int* lengths,
    int8_t* kfull, uint8_t* kmsb, uint8_t* klsb2, void* kscale, int8_t* vfull,
    uint8_t* vmsb, void* vscale, void* imp, const uint8_t* hmask,
    const int* qbits, const uint8_t* appmask, float* out, float* max_prob,
    uint8_t* need, uint8_t* keep_out, float* delta, float* mrow, float* drow,
    float* splane, int B, int Hq, int Hkv, int G, int D, int d, int C, int Ct,
    int pack_unit, int layer,
    float sm_scale, float threshold, float ema, int quant, int requant,
    int keep_blocks, int v_block, int sc_bf16, int imp_bf16, int qq,
    int pv_int8, int probs_bf16, int presoftmax, int per_row, uint8_t* stash,
    int stash_row, uint8_t* bplane, void* stream) {
  if (Ct % 2 || C % 2 || (klsb2 && pack_unit % 4) || (Hkv * d) % 16 || misaligned(kfull) ||
      misaligned(kmsb) || misaligned(klsb2) || misaligned(vfull) ||
      misaligned(vmsb) || misaligned(splane) || misaligned(bplane))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params p{q, k_new, v_new, lengths, kfull, kmsb, klsb2, kscale, vfull, vmsb,
           vscale, imp, hmask, qbits, appmask, out, max_prob, need, keep_out,
           delta, mrow, drow, splane, Hq, C, Ct, Hkv * d, Hkv, pack_unit, layer,
           sm_scale, threshold, ema, quant, requant, keep_blocks, v_block,
           sc_bf16, imp_bf16, qq, pv_int8, probs_bf16, presoftmax, per_row};
  p.g = Hq / Hkv;
  p.d = d;
  p.bplane = bplane;
  if (G == 16)                                      // the latent instance
    return stash != nullptr || bplane != nullptr
               ? static_cast<int>(cudaErrorInvalidValue)
               : spatten_fused_decode_latent(&p, B, stream);
  const int rows = G < 1 ? 0 : (p.g + G - 1) / G * G;
  p.bstride = static_cast<int>((block_bytes(rows, C / v_block) + 15) & ~size_t{15});
  const int low = d & -d;                  // a box row's lead-in is at
  const int lead = low < 16 ? 16 - low : 0;   // most 16 - gcd(d, 16)
  // a group past its instance runs in chunks only in <8, D, false>; the
  // block plane comes only with the score plane; a head past D lanes runs
  // in lane pieces only in D = 256
  if (G < 1 || Hq % Hkv || p.g < 1 || (G > 1 && 2 * p.g <= G) ||
      (p.g > G && (G != 8 || splane == nullptr)) ||
      (bplane != nullptr && splane == nullptr) || d < 1 ||
      (d + lead > D && D != 256) || (D != 64 && D != 128 && D != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = plan_ring(p, B, D);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hkv, B);
  if (stash != nullptr) {                           // skip_append: save
    stash_kernel<<<grid, 64, 0, s>>>(p, stash, stash_row, true);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  switch (D) {
    case 64: e = launch_g<64>(p, B, G, rows, s); break;
    case 128: e = launch_g<128>(p, B, G, rows, s); break;
    case 256: e = launch_g<256>(p, B, G, rows, s); break;
  }
  if (e == cudaSuccess && stash != nullptr) {       // and put back
    stash_kernel<<<grid, 64, 0, s>>>(p, stash, stash_row, false);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}
#endif  // K1_PART
