// Fused SpAtten decode attention for one layer of the stacked token-major
// cache, in place, on Hopper (sm_90a).
//
// Replaces the TPU kernel spatten_tpu/ops/fused_decode.py::
// fused_decode_attention (pallas_call at :2319, body _make_kernel
// :254-1902).  Same function, redesigned for the GPU:
//
//   append the new K/V row (int8 + per-(token, head) scale + nibble RMW)
//   -> pass-1 scores on the 4-bit msb plane (dequantized with the msb
//      midpoint rule, as dequantize_msb) or the int8 plane (dense mode)
//   -> masked f32 softmax -> requant decision (max prob < threshold) and,
//      where it fires, a full-plane recompute -> importance EMA update of
//      the stacked [L, B, Hkv, C] accumulator -> local V top-k by block
//      mass (ties kept) -> P·V over the kept V blocks only.
//
// Grid: one CTA per (kv head, batch row).  The CTA owns lanes
// [h*D, (h+1)*D) of every cache row, the head's scale column and its
// importance row, so its append read-modify-write cannot race any other
// CTA: it appends first, then __syncthreads(), then reads the post-append
// cache like the reference does.
//
// Bound on this card: bytes.  Per (b, h) one step moves ~len*D/2 bytes of
// msb (len*D for a requant head or dense mode), the kept V rows, and the
// f32 scale/importance columns, against ~4*G flops per K byte -- far
// below the H100's ~20 f32 flops/byte ridge.  The design reads the packed
// plane once (one packed row serves its hi and lo token), unpacks nibbles
// in registers, keeps scores and probabilities in shared memory (never in
// device memory), and skips the loads of V blocks no query row keeps.
// Each warp keeps UNROLL rows' loads in flight.  The TPU scheduling
// machinery (heads/batches per program, DMA slot rotation, cross-instance
// prefetch, scale-ladder rungs, gate words) has no counterpart here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr float kMsbMidpoint = 7.5f;

struct Params {
  const float* q;        // [B, Hq, D]
  const float* k_new;    // [B, Hkv, D]
  const float* v_new;    // [B, Hkv, D]
  const int* lengths;    // [B] valid tokens incl. the appended row
  int8_t* kfull;         // [B, C, F]   (this layer's base)
  uint8_t* kmsb;         // [B, C/2, F] or null (dense)
  float* kscale;         // [B, Hkv, C]
  int8_t* vfull;         // [B, C, F]
  uint8_t* vmsb;         // [B, C/2, F] or null
  float* vscale;         // [B, Hkv, C]
  float* imp;            // [B, Hkv, C] accumulator or null
  float* out;            // [B, Hq, D]
  float* max_prob;       // [B, Hkv]
  uint8_t* need;         // [B, Hkv]
  uint8_t* keep_out;     // [B, Hq, C / v_block] or null
  int C, F, Hkv, pack_unit;
  float sm_scale, threshold, ema;
  int quant, requant, keep_blocks, v_block;
};

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
// the full plane, and the nibble read-modify-write of the packed plane.
template <int VEC>
__device__ void append_row(const float* x, int8_t* full_row, float* scale_slot,
                           uint8_t* msb_row, bool is_hi) {
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
  }
  if (lane == 0) *scale_slot = s;
}

// Scores of every live token from the int8 plane into s[g*C + t].
template <int G, int VEC>
__device__ void scores_full(const Params& p, const int8_t* kf, const float* ksc,
                            const float (&qr)[G][VEC], int len, float* s) {
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
      const float f = ksc[t] * p.sm_scale;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc = fmaf(qr[g][i], static_cast<float>(static_cast<int8_t>(raw[u][i])),
                     acc);
        acc = warp_sum(acc);
        if (lane == 0) s[g * p.C + t] = acc * f;
      }
    }
  }
}

// Pass-1 scores from the packed msb plane: one packed row carries its hi
// token (unit*U + r) and lo token (+ U/2).
template <int G, int VEC>
__device__ void scores_msb(const Params& p, const uint8_t* km, const float* ksc,
                           const float (&qr)[G][VEC], int len, float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half_u = p.pack_unit / 2;
  const int nrows = p.C / 2;
  for (int r0 = warp * kUnroll; r0 < nrows; r0 += kWarps * kUnroll) {
    uint8_t raw[kUnroll][VEC];
    int thi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      thi[u] = (r / half_u) * p.pack_unit + r % half_u;
      if (r < nrows && thi[u] < len) {
        load_bytes<VEC>(km + static_cast<size_t>(r) * p.F + lane * VEC, raw[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      if (r >= nrows || thi[u] >= len) continue;  // warp-uniform
      const int tlo = thi[u] + half_u;
      const bool lo_live = tlo < len;
      const float fhi = ksc[thi[u]] * p.sm_scale;
      const float flo = lo_live ? ksc[tlo] * p.sm_scale : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float ahi = 0.f, alo = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int byte = raw[u][i];
          const float khi = fmaf(static_cast<float>((byte >> 4) - 8), 16.f,
                                 kMsbMidpoint);
          const float klo = fmaf(static_cast<float>((byte & 0xF) - 8), 16.f,
                                 kMsbMidpoint);
          ahi = fmaf(qr[g][i], khi, ahi);
          alo = fmaf(qr[g][i], klo, alo);
        }
        ahi = warp_sum(ahi);
        alo = warp_sum(alo);
        if (lane == 0) {
          s[g * p.C + thi[u]] = ahi * fhi;
          if (lo_live) s[g * p.C + tlo] = alo * flo;
        }
      }
    }
  }
}

// In-place softmax numerators: s <- exp(s - max) over [0, len); returns
// the row denominators in den[g].
template <int G>
__device__ void softmax_rows(float* s, int C, int len, float* red, float* den) {
  for (int g = 0; g < G; ++g) {
    float* row = s + g * C;
    float m = -INFINITY;
    for (int t = threadIdx.x; t < len; t += kThreads) m = fmaxf(m, row[t]);
    m = block_reduce(m, red, -INFINITY, [](float x) { return warp_max(x); });
    float sum = 0.f;
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const float e = expf(row[t] - m);
      row[t] = e;
      sum += e;
    }
    sum = block_reduce(sum, red, 0.f, [](float x) { return warp_sum(x); });
    if (threadIdx.x == 0) den[g] = sum;
  }
  __syncthreads();
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
  float* den = red + kWarps;                        // [G]
  float* inv = den + G;                             // [G]
  float* kth = inv + G;                             // [G]
  uint8_t* keep = reinterpret_cast<uint8_t*>(kth + G);   // [G, nvb]
  uint8_t* keep_any = keep + G * nvb;                    // [nvb]

  const int len = p.lengths[b];
  const int hq0 = h * G;                            // first q head of group
  if (len < 1 || len > C) {                         // contract violation
    for (int i = threadIdx.x; i < G * D; i += kThreads)
      p.out[(static_cast<size_t>(b) * p.Hkv * G + hq0) * D + i] = NAN;
    if (threadIdx.x == 0) p.max_prob[b * p.Hkv + h] = NAN;
    return;
  }
  const int idx = len - 1;

  const size_t plane_b = static_cast<size_t>(b) * C * F;
  const size_t packed_b = static_cast<size_t>(b) * (C / 2) * F;
  const size_t col_bh = (static_cast<size_t>(b) * p.Hkv + h) * C;
  int8_t* kf = p.kfull + plane_b + h * D;
  int8_t* vf = p.vfull + plane_b + h * D;
  uint8_t* km = p.kmsb ? p.kmsb + packed_b + h * D : nullptr;
  uint8_t* vm = p.vmsb ? p.vmsb + packed_b + h * D : nullptr;
  float* ksc = p.kscale + col_bh;
  float* vsc = p.vscale + col_bh;

  // ---- append (warp 0: K, warp 1: V) -------------------------------------
  {
    const int u = p.pack_unit;
    const int r_u = idx % u;
    const bool is_hi = r_u < u / 2;
    const size_t prow = static_cast<size_t>(idx / u) * (u / 2) + r_u % (u / 2);
    const size_t src = (static_cast<size_t>(b) * p.Hkv + h) * D;
    if (warp == 0) {
      append_row<VEC>(p.k_new + src, kf + static_cast<size_t>(idx) * F,
                      ksc + idx, km ? km + prow * F : nullptr, is_hi);
    } else if (warp == 1) {
      append_row<VEC>(p.v_new + src, vf + static_cast<size_t>(idx) * F,
                      vsc + idx, vm ? vm + prow * F : nullptr, is_hi);
    }
  }
  __syncthreads();                                  // the block sees its row

  // ---- queries of this group in registers: lane holds d = lane*VEC + i --
  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      qr[g][i] = p.q[(static_cast<size_t>(b) * p.Hkv * G + hq0 + g) * D +
                     lane * VEC + i];

  // ---- pass 1 + softmax + requant decision -------------------------------
  if (p.quant) {
    scores_msb<G, VEC>(p, km, ksc, qr, len, s);
  } else {
    scores_full<G, VEC>(p, kf, ksc, qr, len, s);
  }
  __syncthreads();
  softmax_rows<G>(s, C, len, red, den);
  float mp = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) mp = fmaxf(mp, 1.f / fmaxf(den[g], 1e-30f));
  const bool fire = p.requant && mp < p.threshold;   // uniform in the CTA
  if (threadIdx.x == 0) {
    p.max_prob[b * p.Hkv + h] = mp;
    p.need[b * p.Hkv + h] = fire ? 1 : 0;
  }
  if (fire) {
    __syncthreads();
    scores_full<G, VEC>(p, kf, ksc, qr, len, s);
    __syncthreads();
    softmax_rows<G>(s, C, len, red, den);
  }
  if (threadIdx.x < G) inv[threadIdx.x] = 1.f / fmaxf(den[threadIdx.x], 1e-30f);
  __syncthreads();

  // ---- importance: reset the appended slot, then imp <- ema*imp + delta --
  if (p.imp != nullptr) {
    float* imp = p.imp + col_bh;
    for (int t = threadIdx.x; t < len; t += kThreads) {
      float delta = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) delta += s[g * C + t] * inv[g];
      const float prev = t == idx ? 0.f : imp[t];
      imp[t] = prev * p.ema + delta;
    }
  }

  // ---- local V pruning: per-row block keep mask --------------------------
  const bool vprune = p.keep_blocks > 0;
  if (vprune) {
    for (int i = threadIdx.x; i < G * nvb; i += kThreads) {
      const int g = i / nvb, j = i % nvb;
      const int t0 = j * p.v_block, t1 = min(t0 + p.v_block, len);
      float m = 0.f;
      for (int t = t0; t < t1; ++t) m += s[g * C + t];
      mass[i] = m;
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
      if (threadIdx.x == 0) kth[g] = cand;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nvb; j += kThreads) {
      uint8_t any = 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mj = mass[g * nvb + j];
        const uint8_t k = (mj >= kth[g]) && (mj > 0.f);
        keep[g * nvb + j] = k;
        any |= k;
        if (p.keep_out != nullptr)
          p.keep_out[(static_cast<size_t>(b) * p.Hkv * G + hq0 + g) * nvb + j] = k;
      }
      keep_any[j] = any;
    }
    __syncthreads();
  }

  // ---- P·V over the kept blocks ------------------------------------------
  float acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    uint8_t raw[kUnroll][VEC];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      live[u] = t < len && (!vprune || keep_any[t / p.v_block]);
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
      const float sc = vsc[t];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const bool kept = !vprune || keep[g * nvb + t / p.v_block];
        const float w = kept ? s[g * C + t] * inv[g] * sc : 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[g][i] = fmaf(w, static_cast<float>(static_cast<int8_t>(raw[u][i])),
                           acc[g][i]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      pv[(warp * G + g) * D + lane * VEC + i] = acc[g][i];
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += pv[w * G * D + i];
    p.out[(static_cast<size_t>(b) * p.Hkv * G + hq0) * D + i] = o;
  }
}

size_t smem_bytes(int G, int D, int C, int v_block) {
  const int nvb = C / v_block;
  return sizeof(float) * (static_cast<size_t>(G) * C + kWarps * G * D +
                          G * nvb + kWarps + 3 * G) +
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
    int8_t* kfull, uint8_t* kmsb, float* kscale, int8_t* vfull, uint8_t* vmsb,
    float* vscale, float* imp, float* out, float* max_prob, uint8_t* need,
    uint8_t* keep_out, int B, int Hq, int Hkv, int D, int C, int pack_unit,
    float sm_scale, float threshold, float ema, int quant, int requant,
    int keep_blocks, int v_block, void* stream) {
  Params p{q, k_new, v_new, lengths, kfull, kmsb, kscale, vfull, vmsb,
           vscale, imp, out, max_prob, need, keep_out, C, Hkv * D, Hkv,
           pack_unit, sm_scale, threshold, ema, quant, requant, keep_blocks,
           v_block};
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch_g<64>(p, B, G, s));
    case 128: return static_cast<int>(launch_g<128>(p, B, G, s));
    case 256: return static_cast<int>(launch_g<256>(p, B, G, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
