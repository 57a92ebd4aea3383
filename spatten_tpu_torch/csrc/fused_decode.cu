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
// [h*D, (h+1)*D) of every cache row, the head's scale column and its
// importance row, so its append read-modify-writes cannot race any other
// CTA (the 2-bit byte that four tokens share lies in the CTA's own
// lanes): it appends first, then __syncthreads(), then reads the
// post-append cache.
//
// Bound on this card: bytes.  Per (b, h) one step moves ~len*D/2 bytes of
// msb (plus len*D/4 of lsb2 for a 6-bit layer, len*D for a requant head,
// an 8-bit layer or dense mode), the kept V rows, and the scale and
// importance columns, against ~4*G flops per K byte -- far below the
// H100's ~20 f32 flops/byte ridge.  The design reads each packed row once
// (one msb row and one lsb2 row serve a hi and a lo token), unpacks in
// registers, keeps scores and probabilities in shared memory (never in
// device memory), and skips the loads of V blocks no query row keeps and
// of dead head groups.  Each warp keeps kUnroll rows' loads in flight.
// The TPU scheduling machinery (heads/batches per program, DMA slot
// rotation, cross-instance prefetch, scale-ladder rungs, gate words) has
// no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
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
  int Hq, C, Ct, F, Hkv, pack_unit, layer;
  float sm_scale, threshold, ema;
  int quant, requant, keep_blocks, v_block;
  int sc_bf16, imp_bf16, qq, pv_int8, probs_bf16, presoftmax, per_row;
};

// per-row scalars: misc[k * G + g]
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

__device__ __forceinline__ float load_meta(const void* p, size_t i, int bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
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

// Load VEC consecutive bytes (VEC in {2, 4, 8}) as one aligned word.
template <int VEC>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint8_t (&b)[VEC]) {
  if constexpr (VEC == 8) {
    uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = (w.x >> (8 * i)) & 0xFF;
#pragma unroll
    for (int i = 0; i < 4; ++i) b[4 + i] = (w.y >> (8 * i)) & 0xFF;
  } else if constexpr (VEC == 4) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = (w >> (8 * i)) & 0xFF;
  } else {
    uint16_t w = *reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < VEC; ++i) b[i] = (w >> (8 * i)) & 0xFF;
  }
}

// Quantize one head's new row (one warp): int8 + scale into slot idx of
// the full plane, the nibble RMW of the packed plane and the 2-bit RMW of
// the lsb2 plane.  The f32 scale also goes to *scale_f32.
template <int VEC>
__device__ void append_row(const float* x, int8_t* full_row, void* scale,
                           size_t scale_idx, int sc_bf16, float* scale_f32,
                           uint8_t* msb_row, bool is_hi, uint8_t* l2_row,
                           int l2_shift) {
  const int lane = threadIdx.x & 31;
  float v[VEC];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    v[i] = x[lane * VEC + i];
    amax = fmaxf(amax, fabsf(v[i]));
  }
  amax = warp_max(amax);
  const float s = amax > 0.f ? amax / 127.f : 1.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float r = fminf(fmaxf(rintf(v[i] / s), -127.f), 127.f);
    const int q8 = static_cast<int>(r);
    full_row[lane * VEC + i] = static_cast<int8_t>(q8);
    if (msb_row != nullptr) {
      const uint8_t nib = static_cast<uint8_t>(((q8 >> 4) & 0xF) ^ 8);
      const uint8_t old = msb_row[lane * VEC + i];
      msb_row[lane * VEC + i] =
          is_hi ? static_cast<uint8_t>((nib << 4) | (old & 0x0F))
                : static_cast<uint8_t>((old & 0xF0) | nib);
    }
    if (l2_row != nullptr) {
      const int f2 = (q8 >> 2) & 0x3;
      const int old = l2_row[lane * VEC + i];
      l2_row[lane * VEC + i] =
          static_cast<uint8_t>((old & ~(0x3 << l2_shift)) | (f2 << l2_shift));
    }
  }
  if (lane == 0) {
    store_meta(scale, scale_idx, s, sc_bf16);
    *scale_f32 = s;
  }
}

// Per-row score constants of one pass: s = ksc * (raw * rs + off).
template <int G>
struct RowScale {
  float rs[G];
  float off[G];
};

// The scaled score of column t from its raw dot product (lane 0 only);
// the pre-scale value of the appended column is kept for its P·V term.
__device__ __forceinline__ void finalize(const Params& p, float raw, float rs,
                                         float off, const void* ksc,
                                         size_t col0, int t, int idx,
                                         float* srow, float* xidx) {
  const float x = __fadd_rn(__fmul_rn(raw, rs), off);
  if (t == idx) *xidx = x;
  srow[t] = __fmul_rn(x, load_meta(ksc, col0 + t, p.sc_bf16));
}

// Raw scores of every live token from the int8 plane.
template <int G, int VEC>
__device__ void scores_full(const Params& p, const int8_t* kf, const void* ksc,
                            size_t col0, const float (&qr)[G][VEC],
                            const RowScale<G>& rsc, int len, int idx, float* s,
                            float* misc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    uint8_t raw[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < len) {
        load_bytes<VEC>(reinterpret_cast<const uint8_t*>(kf) +
                            static_cast<size_t>(t) * p.F + lane * VEC,
                        raw[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t >= len) break;                       // warp-uniform
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc = fmaf(qr[g][i], static_cast<float>(static_cast<int8_t>(raw[u][i])),
                     acc);
        acc = warp_sum(acc);
        if (lane == 0)
          finalize(p, acc, rsc.rs[g], rsc.off[g], ksc, col0, t, idx,
                   s + g * p.C, misc + kXidx * G + g);
      }
    }
  }
}

// Pass-1 raw scores from the packed msb plane (biased nibbles n = k4 + 8):
// one packed row carries its hi token (unit*U + r) and lo token (+ U/2).
// Under a 6-bit profile the lsb2 row of the same unit carries both
// tokens' 2-bit fields (hi: fields 0/1, lo: fields 2/3), and the raw
// value is q . (4n + l2).
template <int G, int VEC>
__device__ void scores_msb(const Params& p, const uint8_t* km,
                           const uint8_t* kl2, const void* ksc, size_t col0,
                           const float (&qr)[G][VEC], const RowScale<G>& rsc,
                           int len, int idx, float* s, float* misc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half_u = p.pack_unit / 2;
  const int quarter_u = p.pack_unit / 4;
  const int nrows = p.C / 2;
  for (int r0 = warp * kUnroll; r0 < nrows; r0 += kWarps * kUnroll) {
    uint8_t raw[kUnroll][VEC];
    uint8_t l2[kUnroll][VEC];
    int thi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      thi[u] = (r / half_u) * p.pack_unit + r % half_u;
      if (r < nrows && thi[u] < len) {
        load_bytes<VEC>(km + static_cast<size_t>(r) * p.F + lane * VEC, raw[u]);
        if (kl2 != nullptr) {
          const int lrow = (thi[u] / p.pack_unit) * quarter_u + r % quarter_u;
          load_bytes<VEC>(kl2 + static_cast<size_t>(lrow) * p.F + lane * VEC,
                          l2[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      if (r >= nrows || thi[u] >= len) continue;  // warp-uniform
      const int tlo = thi[u] + half_u;
      const bool lo_live = tlo < len;
      const int qi = (r % half_u) / quarter_u;     // hi field; lo is qi + 2
      const int sh_hi = 6 - 2 * qi, sh_lo = 2 - 2 * qi;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float ahi = 0.f, alo = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int byte = raw[u][i];
          float nhi = static_cast<float>(byte >> 4);
          float nlo = static_cast<float>(byte & 0xF);
          if (kl2 != nullptr) {
            nhi = fmaf(nhi, 4.f, static_cast<float>((l2[u][i] >> sh_hi) & 3));
            nlo = fmaf(nlo, 4.f, static_cast<float>((l2[u][i] >> sh_lo) & 3));
          }
          ahi = fmaf(qr[g][i], nhi, ahi);
          alo = fmaf(qr[g][i], nlo, alo);
        }
        ahi = warp_sum(ahi);
        alo = warp_sum(alo);
        if (lane == 0) {
          float* srow = s + g * p.C;
          float* xi = misc + kXidx * G + g;
          finalize(p, ahi, rsc.rs[g], rsc.off[g], ksc, col0, thi[u], idx, srow,
                   xi);
          if (lo_live)
            finalize(p, alo, rsc.rs[g], rsc.off[g], ksc, col0, tlo, idx, srow,
                     xi);
        }
      }
    }
  }
}

// Softmax statistics over [0, len): the row max, the denominator and, for
// pv_int8, the running max of e * vscale over the f32 e, into misc; with
// `write`, also the in-place numerators s <- exp(s - max) (rounded to bf16
// under probs_bf16).  Presoftmax importance reads the scores first and
// writes the numerators later (exp_rows), from the same max.
template <int G>
__device__ void softmax_rows(const Params& p, float* s, int len, float* red,
                             float* misc, const void* vsc, size_t col0,
                             bool write) {
  for (int g = 0; g < G; ++g) {
    float* row = s + g * p.C;
    float m = -INFINITY;
    for (int t = threadIdx.x; t < len; t += kThreads) m = fmaxf(m, row[t]);
    m = block_reduce(m, red, -INFINITY, [](float x) { return warp_max(x); });
    float sum = 0.f, emv = 0.f;
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const float e = expf(row[t] - m);
      if (p.pv_int8)
        emv = fmaxf(emv, __fmul_rn(e, load_meta(vsc, col0 + t, p.sc_bf16)));
      if (write) row[t] = p.probs_bf16 ? round_bf16(e) : e;
      sum += e;
    }
    sum = block_reduce(sum, red, 0.f, [](float x) { return warp_sum(x); });
    if (p.pv_int8)
      emv = block_reduce(emv, red, 0.f, [](float x) { return warp_max(x); });
    if (threadIdx.x == 0) {
      misc[kDen * G + g] = sum;
      misc[kMax * G + g] = m;
      misc[kEmv * G + g] = emv;
    }
  }
  __syncthreads();
}

// The numerators softmax_rows(write = false) summed, written in place.
// Thread t handles the columns importance() reads, so no barrier is
// needed between the two.
template <int G>
__device__ void exp_rows(const Params& p, float* s, int len,
                         const float* misc) {
  for (int g = 0; g < G; ++g) {
    float* row = s + g * p.C;
    const float m = misc[kMax * G + g];
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const float e = expf(row[t] - m);
      row[t] = p.probs_bf16 ? round_bf16(e) : e;
    }
  }
}

// This step's importance: delta(g, t) = s[g][t] * wt[g] over the live
// columns (probabilities times the row weight, or scores times the head
// mask).  Accumulated into the stacked plane (the appended slot starts
// from 0), or written to the delta output over the whole window.
template <int G>
__device__ void importance(const Params& p, const float* s, const float* wt,
                           int len, int idx, bool do_app, size_t col0,
                           float* dl) {
  if (p.imp != nullptr) {
    for (int t = threadIdx.x; t < len; t += kThreads) {
      float delta = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) delta += __fmul_rn(s[g * p.C + t], wt[g]);
      const float prev = (do_app && t == idx)
                             ? 0.f : load_meta(p.imp, col0 + t, p.imp_bf16);
      store_meta(p.imp, col0 + t, __fadd_rn(__fmul_rn(prev, p.ema), delta),
                 p.imp_bf16);
    }
  } else if (dl != nullptr) {
    for (int t = threadIdx.x; t < p.C; t += kThreads) {
      if (p.per_row) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          dl[static_cast<size_t>(g) * p.C + t] =
              t < len ? __fmul_rn(s[g * p.C + t], wt[g]) : 0.f;
      } else {
        float delta = 0.f;
        if (t < len) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            delta += __fmul_rn(s[g * p.C + t], wt[g]);
        }
        dl[t] = delta;
      }
    }
  }
}

// Zero output, kept-block mask and delta of a group that computes nothing
// more (a dead head group, or a row with no live token).
template <int G, int D>
__device__ void zero_outputs(const Params& p, int b, int hq0, size_t out0,
                             int nvb, float* dl) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) p.out[out0 + i] = 0.f;
  if (p.keep_out != nullptr && p.keep_blocks > 0) {
    for (int i = threadIdx.x; i < G * nvb; i += kThreads)
      p.keep_out[static_cast<size_t>(b) * p.Hq * nvb + hq0 * nvb + i] = 0;
  }
  if (dl != nullptr) {
    const int n = (p.per_row ? G : 1) * p.C;
    for (int i = threadIdx.x; i < n; i += kThreads) dl[i] = 0.f;
  }
}

template <int G, int D>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const Params p) {
  constexpr int VEC = D / 32;
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = p.C, F = p.F;
  const int nvb = C / p.v_block;

  float* s = smem;                                  // [G, C]
  float* pv = s + G * C;                            // [kWarps, G, D]
  float* mass = pv + kWarps * G * D;                // [G, nvb]
  float* red = mass + G * nvb;                      // [kWarps]
  float* misc = red + kWarps;                       // [kMisc, G]
  float* app = misc + kMisc * G;                    // k, v f32 new scales
  uint8_t* keep = reinterpret_cast<uint8_t*>(app + 2);   // [G, nvb]
  uint8_t* keep_any = keep + G * nvb;                    // [nvb]

  const int len = p.lengths[b];
  const bool do_app = p.appmask == nullptr || p.appmask[b] != 0;
  const int hq0 = h * G;                            // first q head of group
  const size_t out0 = (static_cast<size_t>(b) * p.Hq + hq0) * D;
  const size_t row0 = static_cast<size_t>(b) * p.Hq + hq0;   // [B, Hq] index
  float* dl = p.delta == nullptr ? nullptr
            : p.delta + (p.per_row ? row0 : static_cast<size_t>(b) * p.Hkv + h)
                            * C;
  // an appending row holds its new token; only a non-appending one (a
  // split-K shard past the kept prefix) may hold none
  if (len < (do_app ? 1 : 0) || len > C) {          // contract violation
    for (int i = threadIdx.x; i < G * D; i += kThreads) p.out[out0 + i] = NAN;
    if (threadIdx.x == 0) p.max_prob[b * p.Hkv + h] = NAN;
    return;
  }
  bool alive[G];
  bool any_alive = false;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    alive[g] = p.hmask == nullptr || p.hmask[row0 + g] != 0;
    any_alive |= alive[g];
  }
  if (len == 0) {
    // no live column: every score is masked, so m = MASK_VALUE, e = 0 and
    // den sits at its 1e-30 floor (max prob 1e30, which never requantizes)
    zero_outputs<G, D>(p, b, hq0, out0, nvb, dl);
    if (threadIdx.x < G && p.mrow != nullptr) {
      p.mrow[row0 + threadIdx.x] = kMaskValue;
      p.drow[row0 + threadIdx.x] = 1e-30f;
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
  int8_t* kf = p.kfull + plane_b + h * D;
  int8_t* vf = p.vfull + plane_b + h * D;
  uint8_t* km = p.kmsb ? p.kmsb + packed_b + h * D : nullptr;
  uint8_t* kl2 = p.klsb2 ? p.klsb2 + lsb2_b + h * D : nullptr;
  uint8_t* vm = p.vmsb ? p.vmsb + packed_b + h * D : nullptr;

  // ---- append (warp 0: K, warp 1: V) -------------------------------------
  if (do_app) {
    const int u = p.pack_unit;
    const int r_u = idx % u;
    const bool is_hi = r_u < u / 2;
    const size_t prow = static_cast<size_t>(idx / u) * (u / 2) + r_u % (u / 2);
    const size_t lrow = static_cast<size_t>(idx / u) * (u / 4) + r_u % (u / 4);
    const int l2_shift = 6 - 2 * (r_u / (u / 4));
    const size_t src = (static_cast<size_t>(b) * p.Hkv + h) * D;
    if (warp == 0) {
      append_row<VEC>(p.k_new + src, kf + static_cast<size_t>(idx) * F,
                      p.kscale, col0 + idx, p.sc_bf16, app,
                      km ? km + prow * F : nullptr, is_hi,
                      kl2 ? kl2 + lrow * F : nullptr, l2_shift);
    } else if (warp == 1) {
      append_row<VEC>(p.v_new + src, vf + static_cast<size_t>(idx) * F,
                      p.vscale, col0 + idx, p.sc_bf16, app + 1,
                      vm ? vm + prow * F : nullptr, is_hi, nullptr, 0);
    }
  }
  __syncthreads();                                  // the block sees its row

  // ---- head gating: a dead group appended, and does nothing else, but
  // for its row stats (the Pallas body scores every row)
  if (!any_alive && p.mrow == nullptr) {
    zero_outputs<G, D>(p, b, hq0, out0, nvb, dl);
    if (threadIdx.x == 0) {
      p.max_prob[b * p.Hkv + h] = 0.f;
      p.need[b * p.Hkv + h] = 0;
    }
    return;
  }

  // ---- queries in registers (lane holds d = lane*VEC + i), optionally
  // quantized to int8 per row; every warp derives the same row constants
  float qr[G][VEC];
  float rowscale[G], qsum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qr[g][i] = p.q[out0 + g * D + lane * VEC + i];
      amax = fmaxf(amax, fabsf(qr[g][i]));
    }
    rowscale[g] = 1.f;
    if (p.qq) {
      rowscale[g] = fmaxf(warp_max(amax), 1e-20f) / 127.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        qr[g][i] = fminf(fmaxf(rintf(qr[g][i] / rowscale[g]), -127.f), 127.f);
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum += qr[g][i];
    qsum[g] = warp_sum(sum);
  }

  // ---- pass 1 on the layer's profile + softmax + requant decision -------
  const int bits = !p.quant ? 8 : (p.qbits ? p.qbits[p.layer] : 4);
  const bool p1_full = bits == 8;
  const bool use6 = bits == 6 && kl2 != nullptr;
  const float mult = p1_full ? 1.f : (use6 ? 4.f : 16.f);
  const float moff = p1_full ? 0.f : (use6 ? kMidpoint6 : kMsbMidpoint) - 128.f;
  RowScale<G> rs1, rs2;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    rs1.rs[g] = __fmul_rn(rowscale[g], __fmul_rn(mult, p.sm_scale));
    rs1.off[g] = p.quant ? __fmul_rn(__fmul_rn(rowscale[g], qsum[g]),
                                     __fmul_rn(moff, p.sm_scale))
                         : 0.f;
    rs2.rs[g] = __fmul_rn(rowscale[g], p.sm_scale);
    rs2.off[g] = 0.f;
  }
  if (p1_full) {
    scores_full<G, VEC>(p, kf, p.kscale, col0, qr, rs1, len, idx, s, misc);
  } else {
    scores_msb<G, VEC>(p, km, use6 ? kl2 : nullptr, p.kscale, col0, qr, rs1,
                       len, idx, s, misc);
  }
  __syncthreads();
  // presoftmax keeps the scores until its importance has read them
  const bool write_e = !p.presoftmax;
  softmax_rows<G>(p, s, len, red, misc, p.vscale, col0, write_e);
  float mp = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g)
    mp = fmaxf(mp, 1.f / fmaxf(misc[kDen * G + g], 1e-30f));
  // an 8-bit pass 1 already read the int8 plane: it never requantizes
  const bool fire = any_alive && p.requant && !p1_full &&
                    mp < p.threshold;               // uniform
  if (threadIdx.x == 0) {
    p.max_prob[b * p.Hkv + h] = any_alive ? mp : 0.f;
    p.need[b * p.Hkv + h] = fire ? 1 : 0;
  }
  if (fire) {
    __syncthreads();
    scores_full<G, VEC>(p, kf, p.kscale, col0, qr, rs2, len, idx, s, misc);
    __syncthreads();
    softmax_rows<G>(p, s, len, red, misc, p.vscale, col0, write_e);
  }
  if (p.mrow != nullptr && threadIdx.x < G) {
    p.mrow[row0 + threadIdx.x] = misc[kMax * G + threadIdx.x];
    p.drow[row0 + threadIdx.x] = fmaxf(misc[kDen * G + threadIdx.x], 1e-30f);
  }
  if (!any_alive) {                                 // row stats only
    zero_outputs<G, D>(p, b, hq0, out0, nvb, dl);
    return;
  }
  if (p.presoftmax) {
    float hm[G];
#pragma unroll
    for (int g = 0; g < G; ++g) hm[g] = alive[g] ? 1.f : 0.f;
    importance<G>(p, s, hm, len, idx, do_app, col0, dl);
    exp_rows<G>(p, s, len, misc);
  }
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    const float inv = 1.f / fmaxf(misc[kDen * G + g], 1e-30f);
    const float wrow = alive[g] ? inv : 0.f;
    misc[kWrow * G + g] = wrow;
    misc[kWmax * G + g] = __fmul_rn(misc[kEmv * G + g], wrow);
    // the appended column's probability with the new row's f32 K scale
    misc[kEidx * G + g] =
        do_app ? expf(__fmul_rn(misc[kXidx * G + g], app[0]) -
                      misc[kMax * G + g])
               : 0.f;
  }
  __syncthreads();
  const float* wrow = misc + kWrow * G;

  // ---- prob importance: probabilities times the row weight -------------
  if (!p.presoftmax) importance<G>(p, s, wrow, len, idx, do_app, col0, dl);

  // ---- local V pruning: per-row block keep mask --------------------------
  const bool vprune = p.keep_blocks > 0;
  if (vprune) {
    for (int i = threadIdx.x; i < G * nvb; i += kThreads) {
      const int g = i / nvb, j = i % nvb;
      const int t0 = j * p.v_block, t1 = min(t0 + p.v_block, len);
      float m = 0.f;
      for (int t = t0; t < t1; ++t) m += s[g * C + t];
      mass[i] = alive[g] ? m : 0.f;
    }
    __syncthreads();
    // k-th largest by counting: the smallest mass whose strictly-greater
    // count is below keep_blocks (ties kept)
    for (int g = 0; g < G; ++g) {
      float cand = INFINITY;
      for (int j = threadIdx.x; j < nvb; j += kThreads) {
        const float mj = mass[g * nvb + j];
        int rank = 0;
        for (int i = 0; i < nvb; ++i) rank += mass[g * nvb + i] > mj;
        if (rank < p.keep_blocks) cand = fminf(cand, mj);
      }
      cand = block_reduce(cand, red, INFINITY, [](float x) { return warp_min(x); });
      if (threadIdx.x == 0) misc[kKth * G + g] = cand;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nvb; j += kThreads) {
      uint8_t any = 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mj = mass[g * nvb + j];
        const uint8_t k = (mj >= misc[kKth * G + g]) && (mj > 0.f);
        keep[g * nvb + j] = k;
        any |= k;
        if (p.keep_out != nullptr)
          p.keep_out[(static_cast<size_t>(b) * p.Hq + hq0 + g) * nvb + j] = k;
      }
      keep_any[j] = any;
    }
    __syncthreads();
  }

  // ---- P·V over the kept blocks; the appended column comes last, from
  // the new row's f32 V scale (pv_int8: 8-bit row weights w8 =
  // rint(w * 127 / wmax) on the stored int8 rows, int32 sums)
  float accf[G][VEC];
  int acci[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      accf[g][i] = 0.f;
      acci[g][i] = 0;
    }
  float wrecip[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    wrecip[g] = 127.f / fmaxf(misc[kWmax * G + g], 1e-30f);
  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    uint8_t raw[kUnroll][VEC];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      live[u] = t < len && (t != idx || !do_app) &&
                (!vprune || keep_any[t / p.v_block]);
      if (live[u]) {
        load_bytes<VEC>(reinterpret_cast<const uint8_t*>(vf) +
                            static_cast<size_t>(t) * F + lane * VEC,
                        raw[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      const int t = t0 + u;
      const float sc = load_meta(p.vscale, col0 + t, p.sc_bf16);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const bool kept = !vprune || keep[g * nvb + t / p.v_block];
        const float w = kept ? __fmul_rn(__fmul_rn(s[g * C + t], wrow[g]), sc)
                             : 0.f;
        if (p.pv_int8) {
          const int w8 = static_cast<int>(
              fminf(fmaxf(rintf(__fmul_rn(w, wrecip[g])), 0.f), 127.f));
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acci[g][i] += w8 * static_cast<int>(static_cast<int8_t>(raw[u][i]));
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            accf[g][i] = fmaf(w, static_cast<float>(static_cast<int8_t>(raw[u][i])),
                              accf[g][i]);
        }
      }
    }
  }
  int* pvi = reinterpret_cast<int*>(pv);
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int at = (warp * G + g) * D + lane * VEC + i;
      if (p.pv_int8) {
        pvi[at] = acci[g][i];
      } else {
        pv[at] = accf[g][i];
      }
    }
  __syncthreads();
  const float kept_scale = 1.f / 127.f;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, dd = i % D;
    float o;
    if (p.pv_int8) {
      int acc = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += pvi[w * G * D + i];
      o = __fmul_rn(static_cast<float>(acc),
                    __fmul_rn(misc[kWmax * G + g], kept_scale));
    } else {
      o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += pv[w * G * D + i];
    }
    if (do_app) {
      const float kept_new =
          (!vprune || keep[g * nvb + idx / p.v_block]) ? 1.f : 0.f;
      const float p_idx =
          __fmul_rn(__fmul_rn(misc[kEidx * G + g], wrow[g]), kept_new);
      const float vnew = __fmul_rn(
          static_cast<float>(vf[static_cast<size_t>(idx) * F + dd]), app[1]);
      o = __fadd_rn(o, __fmul_rn(p_idx, vnew));
    }
    p.out[out0 + i] = o;
  }
}

size_t smem_bytes(int G, int D, int C, int v_block) {
  const int nvb = C / v_block;
  return sizeof(float) * (static_cast<size_t>(G) * C + kWarps * G * D +
                          G * nvb + kWarps + kMisc * G + 2) +
         static_cast<size_t>(G + 1) * nvb;
}

template <int G, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, D, p.C, p.v_block);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_decode_kernel<G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_decode_kernel<G, D><<<dim3(p.Hkv, B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_g(const Params& p, int B, int G, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<1, D>(p, B, stream);
    case 2: return launch<2, D>(p, B, stream);
    case 4: return launch<4, D>(p, B, stream);
    case 8: return launch<8, D>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success); the wrapper
// (spatten_tpu_torch/ops/fused_decode.py) validates shapes and flags.
extern "C" int spatten_fused_decode(
    const float* q, const float* k_new, const float* v_new, const int* lengths,
    int8_t* kfull, uint8_t* kmsb, uint8_t* klsb2, void* kscale, int8_t* vfull,
    uint8_t* vmsb, void* vscale, void* imp, const uint8_t* hmask,
    const int* qbits, const uint8_t* appmask, float* out, float* max_prob,
    uint8_t* need, uint8_t* keep_out, float* delta, float* mrow, float* drow,
    int B, int Hq, int Hkv, int D, int C, int Ct, int pack_unit, int layer,
    float sm_scale, float threshold, float ema, int quant, int requant,
    int keep_blocks, int v_block, int sc_bf16, int imp_bf16, int qq,
    int pv_int8, int probs_bf16, int presoftmax, int per_row, void* stream) {
  Params p{q, k_new, v_new, lengths, kfull, kmsb, klsb2, kscale, vfull, vmsb,
           vscale, imp, hmask, qbits, appmask, out, max_prob, need, keep_out,
           delta, mrow, drow, Hq, C, Ct, Hkv * D, Hkv, pack_unit, layer,
           sm_scale, threshold, ema, quant, requant, keep_blocks, v_block,
           sc_bf16, imp_bf16, qq, pv_int8, probs_bf16, presoftmax, per_row};
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch_g<64>(p, B, G, s));
    case 128: return static_cast<int>(launch_g<128>(p, B, G, s));
    case 256: return static_cast<int>(launch_g<256>(p, B, G, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
