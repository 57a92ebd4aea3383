// K1's latent instance: one cached head read by a wide query group, as
// DeepSeek-V2's latent (MLA) cache is read -- one row of 512 + 64 lanes a
// token, scored and weighted by all 16 query heads.  Same function as
// fused_decode_kernel<G, D> in csrc/fused_decode.cu (whose helpers this
// unit includes, K1_PART 3) and as ops/fused_decode.py::
// fused_decode_attention_plain, at the flags the serving path sets for
// such a cache: the append, pass 1 on the layer's 4/6/8-bit profile,
// the masked softmax, the requant decision and int8 recompute, the
// per-query-row importance delta, the V-block top-k and 8-bit P·V over
// the kept blocks (int8 queries and pv_int8 required; f32 or bf16
// scales; probs_bf16 either way; head mask and rung as they come).
//
// What it replaces: such a call ran in <8, 256, false>, the device-plane
// instance that takes any group and head width -- its 16 query rows in 2
// chunks of 8 and its 576 lanes in 3 TMA pieces of 256 (256 + 256 + 64),
// each pass once per chunk and piece, so pass 1 and the requant recompute
// each streamed every live row up to 6 times, the [16, C] score plane in
// device memory, and every dot product a CUDA-core dp4a (8.70 ms at batch
// 128 and 2048 tokens against a 0.041 ms bound).
//
// What bounds it: bytes.  At 16 query rows a cached byte carries ~32 int8
// operations (~64 a packed 4-bit byte), which is past what dp4a keeps up
// with at the card's bandwidth; on the tensor cores (mma.sync m16n8k32,
// s8 x s8/u8 -> s32) the same products cost ~10% of the bytes' time.  So
// the design reads each live byte once and keeps the rest on chip:
//
// - One CTA per batch row, all query rows at once.  A tile carries 64
//   plane rows at every lane: five TMA boxes of 128 bytes side by side
//   (lanes 0-639; lanes past the row's d arrive as zeros), under one
//   mbarrier of their summed bytes with the tile's scale segments; a ring
//   of two such 41 KB stages.  Pass 1, the recompute and P·V each read
//   every live packed, int8 or kept V row once.
// - Scores on the tensor cores.  The int8 queries are the A operand
//   (M = 16 rows, in registers for the whole call), a tile's tokens the B
//   operand (N = 8 a warp); K runs over the lanes in an order of our
//   choosing, the same for both operands: each thread reads 16 bytes of a
//   row at once.  The raw sums are exact integers, the same as dp4a's in
//   any order, and are scaled as the plain version scales them.  4-bit
//   rows give their hi and lo tokens' nibbles (u8) from one load, 6-bit
//   rows add the lsb2 fields, 8-bit layers and the recompute read int8.
// - P·V on the tensor cores: the 8-bit row weights [16 x 32 tokens] times
//   the int8 V rows [32 tokens x 8 lanes] (a 4 x 4 byte transpose in
//   registers makes V's rows the k-contiguous operand), exact s32 sums,
//   scaled as before; only kept blocks' rows are fetched.
// - The score plane [16, C] (row stride C + 4 floats, against bank
//   conflicts) lies in shared memory up to a rung of ~2.2k tokens (2048:
//   ~216 KB of the 227 KB plan); past that in device memory, one slice
//   per CTA (rung 4096: 4.2 MB a layer at batch 128, which stays in L2),
//   not a 2-CTA cluster: at batch 128 a second CTA a row would need a
//   second wave of SMs.  On an H100 SXM (700 W) at batch 128 and random
//   lengths, a call takes ~0.22 ms at rung 2048 and ~0.42 ms at 4096.
// - The softmax, importance and V-block passes run over all 16 rows at
//   once (one barrier per reduction, not per row), in the summation order
//   of the plain version (its _k1_row_sum and _ordered_sum).
//
// The tiles land in shared memory under TMA's 128-byte swizzle (the
// 16-byte chunk c of row r at chunk c ^ (r % 8)), so that the 8 rows a
// warp's fragment load touches fall on distinct banks.  The wrapper's
// plan (ops/fused_decode.py::latent_smem_bytes) mirrors lat_smem_bytes.

#ifndef K1_PART
#define K1_PART 3
#endif
#if K1_PART != 3
#error "fused_decode_latent.cu is built as K1_PART 3"
#endif
#include "fused_decode.cu"

namespace {

constexpr int kLatRows = 16;                   // M: query rows of the group
constexpr int kLatBoxes = 5;                   // 128-byte boxes of a row
constexpr int kLatLanes = kLatBoxes * 128;     // the widest row taken
constexpr int kLatKPairs = 2 * kLatBoxes;      // 16-byte chunks a thread reads
constexpr int kLatTile = 64;                   // plane rows of a tile
constexpr int kLatBoxBuf = kLatTile * 128;     // one box's rows in a stage
constexpr int kLatSegOff = kLatBoxes * kLatBoxBuf;   // the scale segments
constexpr int kLatSegBytes = 1024;
constexpr int kLatStageStride = kLatSegOff + kLatSegBytes;
constexpr int kLatStages = 2;
constexpr int kLatPad = 4;                     // score rows at stride C + 4
constexpr int kLatAlign = 1024;                // the swizzle's atom
constexpr int kLatSmemLimit = 232448;

// Byte of row r, 16-byte chunk c, in a 128-byte-wide box buffer that TMA
// wrote under SWIZZLE_128B (the buffer 1024-byte aligned).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// d += a . b over k = 32 (m16n8k32): a holds int8 queries or weights, b
// int8 (s8) or unsigned bytes (u8: nibbles, 6-bit values).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct LatRing {
  uint8_t* buf;        // kLatStages stages of kLatStageStride bytes
  uint64_t* bar;       // one mbarrier per stage
  int used;            // tiles streamed so far (every thread agrees)
};

// Stream n tiles through the ring, as stream_tiles does: copy(i, stage,
// bar, go) returns the bytes of tile i and issues its copies when `go`
// (thread 0 only); consume(i, stage) reads a tile that has landed; after
// it a __syncthreads() frees the stage and thread 0 refills it.
template <class Copy, class Consume>
__device__ void lat_stream(LatRing& r, int n, Copy copy, Consume consume) {
  auto issue = [&](int i) {
    const int g = r.used + i;
    uint8_t* st = r.buf + (g % kLatStages) * kLatStageStride;
    const uint32_t bar = smem_addr(r.bar + g % kLatStages);
    arrive_expect_tx(bar, copy(i, st, bar, false));   // before any lands
    copy(i, st, bar, true);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < n && i < kLatStages; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    const int g = r.used + i;
    wait_phase(smem_addr(r.bar + g % kLatStages), (g / kLatStages) & 1);
    consume(i, r.buf + (g % kLatStages) * kLatStageStride);
    __syncthreads();                                // the stage is free
    if (threadIdx.x == 0 && i + kLatStages < n) issue(i + kLatStages);
  }
  r.used += n;
}

// A row's five boxes of `rows` plane rows from plane row `row` (`map`'s
// box height), box j at dst + j * kLatBoxBuf; returns their bytes (lanes
// past the plane's width arrive as zeros and count).
__device__ __forceinline__ uint32_t lat_boxes(uint8_t* dst,
                                              const CUtensorMap* map, int row,
                                              int rows, uint32_t bar,
                                              bool go) {
  if (go)
#pragma unroll
    for (int j = 0; j < kLatBoxes; ++j)
      tensor_copy(dst + j * kLatBoxBuf, map, j * 128, row, bar);
  return static_cast<uint32_t>(kLatBoxes * rows * 128);
}

// The shared memory of one CTA: the alignment slack, the ring and its
// barriers, the per-row scalars (misc, the reductions' [3][16][kWarps],
// the score constants [4][16], the new rows' scales), the [16, C + 4]
// score plane unless it lies in device memory, and the per-V-block arrays
// (masses [16, nvb], kept-block list and count, keep masks [16, nvb] and
// their union).  ops/fused_decode.py::latent_smem_bytes mirrors it.
constexpr int kLatScalars = kMisc * kLatRows + 3 * kLatRows * kWarps +
                            4 * kLatRows + 4;
size_t lat_smem_bytes(int C, int v_block, bool scores_in_smem) {
  const size_t nvb = C / v_block;
  return kLatAlign + kLatStages * (kLatStageStride + sizeof(uint64_t)) +
         sizeof(float) * kLatScalars +
         (scores_in_smem ? sizeof(float) * kLatRows * (C + kLatPad) : 0) +
         sizeof(float) * kLatRows * nvb + sizeof(int) * (nvb + 1) +
         (kLatRows + 1) * nvb;
}

// The raw scores of one scoring pass for every live token, scaled into
// the score plane: s[r][t] = ksc[t] * (raw * rs[r] + off[r]), the
// pre-scale value of the appended column into xidx[r], each row's max
// over the live tokens into mx[r].  kKind 0: the int8 plane (8-bit layers,
// the recompute); 1: the packed 4-bit plane (biased nibbles, u8); 2: the
// nibbles and the lsb2 fields (4n + field, u8).  A tile is 64 int8 rows,
// or p.t_msb packed rows (64, or 32 with the lsb2 rows beside them, as
// the old plan halves its msb tiles under a 6-bit profile); warp w takes
// the tile's 8 rows from 8w, or, in a tile of 32 packed rows, rows 8(w %
// 4) and their hi (w < 4) or lo (w >= 4) tokens.  Thread (gq, tig) of the
// warp holds query rows gq and gq + 8 and gives the B operand of row gq;
// its sums are tokens 2 tig and 2 tig + 1 of the 8.
template <int kKind>
__device__ __forceinline__ void lat_scores(const Params& p, int b, LatRing& ring,
                           const uint8_t* kcol,
                           const uint32_t (&qa)[kLatKPairs][2][4],
                           const float* rs, const float* off, int len,
                           int idx, float* s, int ss, float* xidx, float* mx,
                           float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int es = p.sc_bf16 ? 2 : 4, kmis = misalign(kcol);
  const float rsA = rs[gq], rsB = rs[gq + 8];
  const float offA = off[gq], offB = off[gq + 8];
  float mA = -INFINITY, mB = -INFINITY;
  const int u = p.pack_unit, half_u = u / 2, quarter_u = u / 4;
  const int nr = kKind == 0 ? len
                            : (len / u) * half_u + min(len % u, half_u);
  const int T = kKind == 0 ? kLatTile : p.t_msb;
  auto hi_token = [&](int r) { return (r / half_u) * u + r % half_u; };

  // scale and store a pair of sums (rows gq and gq + 8, tokens t and t + 1
  // where live), from K scales k0, k1
  auto put = [&](const int (&a)[4], int t, bool v0, bool v1, float k0,
                 float k1) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = gq + 8 * rr;
      const float rsc = rr ? rsB : rsA, of = rr ? offB : offA;
      const float x0 = __fadd_rn(__fmul_rn(static_cast<float>(a[2 * rr]), rsc), of);
      const float x1 =
          __fadd_rn(__fmul_rn(static_cast<float>(a[2 * rr + 1]), rsc), of);
      const float s0 = __fmul_rn(x0, k0), s1 = __fmul_rn(x1, k1);
      float* dst = s + static_cast<size_t>(row) * ss + t;
      if (v1) {
        *reinterpret_cast<float2*>(dst) = make_float2(s0, s1);
      } else if (v0) {
        *dst = s0;
      }
      float& m = rr ? mB : mA;
      if (v0) m = fmaxf(m, s0);
      if (v1) m = fmaxf(m, s1);
      if (v0 && t == idx) xidx[row] = x0;
      if (v1 && t + 1 == idx) xidx[row] = x1;
    }
  };

  lat_stream(
      ring, (nr + T - 1) / T,
      [&](int i, uint8_t* st, uint32_t bar, bool go) {
        const int r0 = i * T, rows = min(T, nr - r0);
        uint32_t bytes;
        if constexpr (kKind == 0) {
          bytes = lat_boxes(st, &p.kf_map, b * p.Ct + r0, T, bar, go);
          bytes += seg_copy(st + kLatSegOff, kcol, r0, rows, es, bar, go);
        } else {
          bytes = lat_boxes(st, &p.km_map, b * (p.Ct / 2) + r0, T, bar, go);
          if constexpr (kKind == 2) {
            const int lr0 = (r0 / half_u) * quarter_u + r0 % quarter_u;
            bytes += lat_boxes(st + T * 128, &p.kl2_map,
                               b * (p.Ct / 4) + lr0, T, bar, go);
          }
          const int thi0 = hi_token(r0);
          bytes += seg_copy(st + kLatSegOff, kcol, thi0, rows, es, bar, go);
          bytes += seg_copy(st + kLatSegOff + kLatSegBytes / 2, kcol,
                           thi0 + half_u, rows, es, bar, go);
        }
        return bytes;
      },
      [&](int i, const uint8_t* st) {
        const int r0 = i * T, rows = min(T, nr - r0);
        const bool split = kKind != 0 && T < kLatTile;   // hi or lo a warp
        const int nt = split ? (warp & 3) : warp;       // the warp's 8 rows
        const int r = 8 * nt + gq;                      // this thread's B row
        int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
        if constexpr (kKind == 0) {
#pragma unroll
          for (int kp = 0; kp < kLatKPairs; ++kp) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                st + (kp >> 1) * kLatBoxBuf + swz(r, 2 * tig + (kp & 1)));
            mma_s8(acc[0], qa[kp][0], v.x, v.y);
            mma_s8(acc[1], qa[kp][1], v.z, v.w);
          }
        } else if (!split) {
          // 4-bit, 64 packed rows: the hi tokens' nibbles into acc[0], the
          // lo tokens' into acc[1]
#pragma unroll
          for (int kp = 0; kp < kLatKPairs; ++kp) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                st + (kp >> 1) * kLatBoxBuf + swz(r, 2 * tig + (kp & 1)));
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma_u8(acc[0], qa[kp][h], (w[2 * h] >> 4) & 0x0F0F0F0Fu,
                     (w[2 * h + 1] >> 4) & 0x0F0F0F0Fu);
              mma_u8(acc[1], qa[kp][h], w[2 * h] & 0x0F0F0F0Fu,
                     w[2 * h + 1] & 0x0F0F0F0Fu);
            }
          }
        } else {
          // 32 packed rows (and their lsb2 rows under a 6-bit layer): the
          // warp's tokens are the rows' hi or lo ones, its sums split by k
          const bool lo = warp >= 4;
          const int field = (r0 % half_u) / quarter_u;  // the tile's lsb2
          const int sh = (lo ? 2 : 6) - 2 * field;      // field of its tokens
#pragma unroll
          for (int kp = 0; kp < kLatKPairs; ++kp) {
            const int at = (kp >> 1) * kLatBoxBuf + swz(r, 2 * tig + (kp & 1));
            const uint4 v = *reinterpret_cast<const uint4*>(st + at);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
            uint32_t x[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              x[k] = (lo ? w[k] : w[k] >> 4) & 0x0F0F0F0Fu;
            if constexpr (kKind == 2) {
              const uint4 l = *reinterpret_cast<const uint4*>(st + T * 128 + at);
              const uint32_t l2[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
              for (int k = 0; k < 4; ++k)
                x[k] = (x[k] << 2) | ((l2[k] >> sh) & 0x03030303u);
            }
            mma_u8(acc[0], qa[kp][0], x[0], x[1]);
            mma_u8(acc[1], qa[kp][1], x[2], x[3]);
          }
        }
        const int rr0 = 8 * nt + 2 * tig;               // the sums' rows
        const bool v0 = rr0 < rows, v1 = rr0 + 1 < rows;
        if constexpr (kKind == 0) {
          int a[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) a[k] = acc[0][k] + acc[1][k];
          const int t = r0 + rr0;
          put(a, t, v0, v1,
              v0 ? seg_at(st + kLatSegOff, kmis, r0, t, p.sc_bf16) : 0.f,
              v1 ? seg_at(st + kLatSegOff, kmis, r0, t + 1, p.sc_bf16) : 0.f);
        } else {
          const int thi0 = hi_token(r0);
          const uint8_t* seg_hi = st + kLatSegOff;
          const uint8_t* seg_lo = seg_hi + kLatSegBytes / 2;
          auto put_hi = [&](const int (&a)[4]) {
            const int t = thi0 + rr0;
            put(a, t, v0, v1,
                v0 ? seg_at(seg_hi, kmis, thi0, t, p.sc_bf16) : 0.f,
                v1 ? seg_at(seg_hi, kmis, thi0, t + 1, p.sc_bf16) : 0.f);
          };
          auto put_lo = [&](const int (&a)[4]) {
            const int t = thi0 + half_u + rr0;
            const bool w0 = v0 && t < len, w1 = v1 && t + 1 < len;
            put(a, t, w0, w1,
                w0 ? seg_at(seg_lo, kmis, thi0 + half_u, t, p.sc_bf16) : 0.f,
                w1 ? seg_at(seg_lo, kmis, thi0 + half_u, t + 1, p.sc_bf16)
                   : 0.f);
          };
          if (!split) {
            put_hi(acc[0]);
            put_lo(acc[1]);
          } else {
            int a[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) a[k] = acc[0][k] + acc[1][k];
            if (warp >= 4)
              put_lo(a);
            else
              put_hi(a);
          }
        }
      });
  // the rows' maxima: over the 4 threads of a row, then over the warps
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mA = fmaxf(mA, __shfl_xor_sync(0xffffffffu, mA, o));
    mB = fmaxf(mB, __shfl_xor_sync(0xffffffffu, mB, o));
  }
  if (tig == 0) {
    red[gq * kWarps + warp] = mA;
    red[(gq + 8) * kWarps + warp] = mB;
  }
  __syncthreads();
  if (threadIdx.x < kLatRows) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[threadIdx.x * kWarps + w]);
    mx[threadIdx.x] = m;
  }
  __syncthreads();
}

// The masked softmax of all 16 rows over [0, len), in place: e = exp(s -
// max) (rounded to bf16 under probs_bf16), each row's denominator and,
// for pv_int8, the max of e * vscale, into misc.  Thread x adds the
// columns 8x + 2048k + j of every row (k, then j) from 0.0, each warp
// reduces them by the butterfly and the 8 warps' sums meet in one more:
// softmax_rows' order, row by row.  red: [2][16][kWarps].
__device__ __forceinline__ void lat_softmax(const Params& p, float* s, int ss, int len,
                            const uint8_t* vcol, float* misc, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m[kLatRows], sum[kLatRows], emv[kLatRows];
#pragma unroll
  for (int g = 0; g < kLatRows; ++g) {
    m[g] = misc[kMax * kLatRows + g];
    sum[g] = 0.f;
    emv[g] = 0.f;
  }
  for (int c0 = 8 * threadIdx.x; c0 < len; c0 += 8 * kThreads) {
    const int n = min(8, len - c0);
    float vs[8];
    if (p.pv_int8) load_meta8(vcol, c0, p.sc_bf16, vs, n);
#pragma unroll
    for (int g = 0; g < kLatRows; ++g) {
      float* row = s + static_cast<size_t>(g) * ss + c0;
      const float4 a = reinterpret_cast<const float4*>(row)[0];
      const float4 c = reinterpret_cast<const float4*>(row)[1];
      float x[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < n) {
          const float e = expf(x[j] - m[g]);
          if (p.pv_int8) emv[g] = fmaxf(emv[g], __fmul_rn(e, vs[j]));
          x[j] = p.probs_bf16 ? round_bf16(e) : e;
          sum[g] += e;
        }
      }
      if (n == 8) {
        reinterpret_cast<float4*>(row)[0] = make_float4(x[0], x[1], x[2], x[3]);
        reinterpret_cast<float4*>(row)[1] = make_float4(x[4], x[5], x[6], x[7]);
      } else {
        for (int j = 0; j < n; ++j) row[j] = x[j];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kLatRows; ++g) {
    sum[g] = warp_sum(sum[g]);
    emv[g] = warp_max(emv[g]);
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kLatRows; ++g) {
      red[g * kWarps + warp] = sum[g];
      red[(kLatRows + g) * kWarps + warp] = emv[g];
    }
  }
  __syncthreads();
  for (int g = warp; g < kLatRows; g += kWarps) {
    const float v = warp_sum(lane < kWarps ? red[g * kWarps + lane] : 0.f);
    const float e =
        warp_max(lane < kWarps ? red[(kLatRows + g) * kWarps + lane] : 0.f);
    if (lane == 0) {
      misc[kDen * kLatRows + g] = v;
      misc[kEmv * kLatRows + g] = p.pv_int8 ? e : 0.f;
    }
  }
  __syncthreads();
}

// One CTA per batch row (one cached head, h = 0); Params as the other
// instances take them, with p.g the group's live rows (9-16; rows past it
// are padding: zero queries, no weight, never written) and p.d the row's
// lanes (257-640).
__global__ void __launch_bounds__(kThreads, 1)
fused_decode_kernel_latent(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t lat_smem[];
  uint8_t* base = lat_smem + ((kLatAlign - (smem_addr(lat_smem) & (kLatAlign - 1))) &
                              (kLatAlign - 1));
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int C = p.C, F = p.F, d = p.d, gl = p.g, vb = p.v_block;
  const int ss = C + kLatPad, nvb = C / vb;

  LatRing ring{base, reinterpret_cast<uint64_t*>(
                         base + kLatStages * kLatStageStride), 0};
  float* misc = reinterpret_cast<float*>(ring.bar + kLatStages);  // [kMisc][16]
  float* red = misc + kMisc * kLatRows;            // [3][16][kWarps]
  float* rsc = red + 3 * kLatRows * kWarps;   // rs1, off1, rs2, 0 [4][16]
  float* app = rsc + 4 * kLatRows;                 // k, v f32 new scales
  float* after = app + 4;
  float* s = p.splane != nullptr
                 ? p.splane + static_cast<size_t>(b) * kLatRows * ss
                 : after;                          // [16, ss]
  float* mass = p.splane != nullptr ? after : after + kLatRows * ss;
  int* kblk = reinterpret_cast<int*>(mass + kLatRows * nvb);   // [nvb + 1]
  uint8_t* keep = reinterpret_cast<uint8_t*>(kblk + nvb + 1);  // [16, nvb]
  uint8_t* keep_any = keep + kLatRows * nvb;                   // [nvb]
  if (threadIdx.x == 0) {
    for (int i = 0; i < kLatStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(ring.bar + i)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  const int len = p.lengths[b];
  const size_t out0 = static_cast<size_t>(b) * p.Hq * d;
  const size_t row0 = static_cast<size_t>(b) * p.Hq;
  float* dl = p.delta == nullptr ? nullptr : p.delta + row0 * C;
  if (len < 1 || len > C) {                         // contract violation
    for (int i = threadIdx.x; i < gl * d; i += kThreads) p.out[out0 + i] = NAN;
    if (threadIdx.x == 0) p.max_prob[b] = NAN;
    return;
  }
  uint32_t alive = 0;                               // live rows, a bit each
  for (int r = 0; r < gl; ++r)
    if (p.hmask == nullptr || p.hmask[row0 + r] != 0) alive |= 1u << r;
  const int idx = len - 1;

  const size_t plane_b = static_cast<size_t>(b) * p.Ct * F;
  const size_t packed_b = static_cast<size_t>(b) * (p.Ct / 2) * F;
  const size_t lsb2_b = static_cast<size_t>(b) * (p.Ct / 4) * F;
  const size_t col0 = static_cast<size_t>(b) * p.Ct;
  const int es = p.sc_bf16 ? 2 : 4;
  int8_t* kf = p.kfull + plane_b;
  int8_t* vf = p.vfull + plane_b;
  uint8_t* km = p.kmsb ? p.kmsb + packed_b : nullptr;
  uint8_t* kl2 = p.klsb2 ? p.klsb2 + lsb2_b : nullptr;
  uint8_t* vm = p.vmsb ? p.vmsb + packed_b : nullptr;
  const uint8_t* kcol = static_cast<const uint8_t*>(p.kscale) + col0 * es;
  const uint8_t* vcol = static_cast<const uint8_t*>(p.vscale) + col0 * es;

  // ---- append (warp 0: K, warp 1: V), as the other instances do ---------
  {
    const int u = p.pack_unit;
    const int r_u = idx % u;
    const bool is_hi = r_u < u / 2;
    const size_t prow = static_cast<size_t>(idx / u) * (u / 2) + r_u % (u / 2);
    const size_t lrow2 = static_cast<size_t>(idx / u) * (u / 4) + r_u % (u / 4);
    const int l2_shift = 6 - 2 * (r_u / (u / 4));
    const size_t src = static_cast<size_t>(b) * d;
    if (warp == 0) {
      append_row<8>(p.k_new + src, d, kf + static_cast<size_t>(idx) * F,
                    p.kscale, col0 + idx, p.sc_bf16, app,
                    km ? km + prow * F : nullptr, is_hi,
                    kl2 ? kl2 + lrow2 * F : nullptr, l2_shift);
    } else if (warp == 1) {
      append_row<8>(p.v_new + src, d, vf + static_cast<size_t>(idx) * F,
                    p.vscale, col0 + idx, p.sc_bf16, app + 1,
                    vm ? vm + prow * F : nullptr, is_hi, nullptr, 0);
    }
  }
  // the bulk copies (async proxy) read what the append stored
  asm volatile("fence.proxy.async;" ::: "memory");
  __syncthreads();

  if (alive == 0) {                 // a dead group appended, and is done
    zero_outputs(p, b, 0, out0, nvb, dl);
    if (threadIdx.x == 0) {
      p.max_prob[b] = 0.f;
      p.need[b] = 0;
    }
    return;
  }

  // ---- pass 1's profile --------------------------------------------------
  const int bits = !p.quant ? 8 : (p.qbits ? p.qbits[p.layer] : 4);
  const bool p1_full = bits == 8;
  const bool use6 = bits == 6 && kl2 != nullptr;
  const float mult = p1_full ? 1.f : (use6 ? 4.f : 16.f);
  const float moff = p1_full ? 0.f : (use6 ? kMidpoint6 : kMsbMidpoint) - 128.f;

  // ---- the queries: int8 per row (by the row's amax), staged in the
  // ring's first stage as [16][640] bytes (zeros past d and past the live
  // rows), with each row's score constants; then each thread's A
  // fragments: for the 16-byte chunk kp of its lanes (box kp / 2, chunk 2
  // tig + kp % 2), k-steps 2 kp and 2 kp + 1 take its words 0, 1 and 2, 3
  uint8_t* qb = ring.buf;
  for (int r = warp; r < kLatRows; r += kWarps) {
    const float* qr = p.q + out0 + static_cast<size_t>(r) * d;
    float amax = 0.f;
    if (r < gl)
      for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(qr[c]));
    const float rowscale = fmaxf(warp_max(amax), 1e-20f) / 127.f;
    float sum = 0.f;
    for (int c = lane; c < kLatLanes; c += 32) {
      float v = 0.f;
      if (r < gl && c < d)
        v = fminf(fmaxf(rintf(qr[c] / rowscale), -127.f), 127.f);
      sum += v;
      qb[r * kLatLanes + c] =
          static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(v)));
    }
    const float qsum = warp_sum(sum);              // an exact integer
    if (lane == 0) {
      rsc[r] = __fmul_rn(rowscale, __fmul_rn(mult, p.sm_scale));
      rsc[kLatRows + r] = p.quant ? __fmul_rn(__fmul_rn(rowscale, qsum),
                                              __fmul_rn(moff, p.sm_scale))
                                  : 0.f;
      rsc[2 * kLatRows + r] = __fmul_rn(rowscale, p.sm_scale);
      rsc[3 * kLatRows + r] = 0.f;           // the recompute's offsets
    }
  }
  __syncthreads();
  uint32_t qa[kLatKPairs][2][4];
#pragma unroll
  for (int kp = 0; kp < kLatKPairs; ++kp) {
    const int at = (kp >> 1) * 128 + 16 * (2 * tig + (kp & 1));
    const uint4 a = *reinterpret_cast<const uint4*>(qb + gq * kLatLanes + at);
    const uint4 c =
        *reinterpret_cast<const uint4*>(qb + (gq + 8) * kLatLanes + at);
    qa[kp][0][0] = a.x; qa[kp][0][1] = c.x; qa[kp][0][2] = a.y; qa[kp][0][3] = c.y;
    qa[kp][1][0] = a.z; qa[kp][1][1] = c.z; qa[kp][1][2] = a.w; qa[kp][1][3] = c.w;
  }
  // the stage is the ring's again: its copies (async proxy) come after
  // these generic accesses
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // ---- pass 1 on the layer's profile + softmax + requant decision --------
  float* xidx = misc + kXidx * kLatRows;
  float* mx = misc + kMax * kLatRows;
  if (p1_full) {
    lat_scores<0>(p, b, ring, kcol, qa, rsc, rsc + kLatRows, len, idx, s,
                  ss, xidx, mx, red);
  } else if (use6) {
    lat_scores<2>(p, b, ring, kcol, qa, rsc, rsc + kLatRows, len, idx, s,
                  ss, xidx, mx, red);
  } else {
    lat_scores<1>(p, b, ring, kcol, qa, rsc, rsc + kLatRows, len, idx, s,
                  ss, xidx, mx, red);
  }
  lat_softmax(p, s, ss, len, vcol, misc, red);
  float mp = 0.f;
  for (int g = 0; g < gl; ++g)
    mp = fmaxf(mp, 1.f / fmaxf(misc[kDen * kLatRows + g], 1e-30f));
  // an 8-bit pass 1 already read the int8 plane: it never requantizes
  const bool fire = p.requant && !p1_full && mp < p.threshold;   // uniform
  if (threadIdx.x == 0) {
    p.max_prob[b] = mp;
    p.need[b] = fire ? 1 : 0;
  }
  if (fire) {
    lat_scores<0>(p, b, ring, kcol, qa, rsc + 2 * kLatRows,
                  rsc + 3 * kLatRows, len, idx, s, ss, xidx, mx, red);
    lat_softmax(p, s, ss, len, vcol, misc, red);
  }
  for (int g = threadIdx.x; g < kLatRows; g += kThreads) {
    const float inv = 1.f / fmaxf(misc[kDen * kLatRows + g], 1e-30f);
    const float wrow = (alive >> g) & 1 ? inv : 0.f;
    misc[kWrow * kLatRows + g] = wrow;
    misc[kWmax * kLatRows + g] = __fmul_rn(misc[kEmv * kLatRows + g], wrow);
    // the appended column's probability with the new row's f32 K scale
    misc[kEidx * kLatRows + g] =
        expf(__fmul_rn(xidx[g], app[0]) - misc[kMax * kLatRows + g]);
  }
  __syncthreads();
  const float* wrow = misc + kWrow * kLatRows;

  // ---- this step's importance, per query row: probabilities times the
  // row weight over the live columns, zeros to the rung
  if (dl != nullptr) {
    const int chunks = C / 8;
    for (int i = threadIdx.x; i < gl * chunks; i += kThreads) {
      const int g = i / chunks, c0 = 8 * (i % chunks);
      const float w = wrow[g];
      const float* row = s + static_cast<size_t>(g) * ss + c0;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = c0 + j < len ? __fmul_rn(row[j], w) : 0.f;
      store_meta8(dl + static_cast<size_t>(g) * C, c0, v, 0, 8);
    }
  }

  // ---- local V pruning: per-row block keep masks -------------------------
  const bool vprune = p.keep_blocks > 0;
  int nk = (len + vb - 1) / vb;                    // blocks P·V streams
  if (vprune) {
    // masses in each block's token order, from 0.0 (vb is a multiple of 4)
    for (int i = threadIdx.x; i < kLatRows * nvb; i += kThreads) {
      const int g = i & (kLatRows - 1), j = i / kLatRows;
      const int t0 = j * vb, t1 = min(t0 + vb, len);
      const float* row = s + static_cast<size_t>(g) * ss;
      float m = 0.f;
      int t = t0;
      for (; t + 4 <= t1; t += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + t);
        m += v.x;
        m += v.y;
        m += v.z;
        m += v.w;
      }
      for (; t < t1; ++t) m += row[t];
      mass[g * nvb + j] = (alive >> g) & 1 ? m : 0.f;
    }
    __syncthreads();
    float* kth = misc + kKth * kLatRows;
    if (nvb <= 128) {
      // k-th largest by counting, a warp a row: the smallest mass whose
      // strictly-greater count is below keep_blocks (ties kept)
      for (int g = warp; g < kLatRows; g += kWarps) {
        const float* mg = mass + g * nvb;
        float cand = INFINITY;
        for (int j = lane; j < nvb; j += 32) {
          const float mj = mg[j];
          int rank = 0;
          for (int i = 0; i < nvb; ++i) rank += mg[i] > mj;
          if (rank < p.keep_blocks) cand = fminf(cand, mj);
        }
        cand = warp_min(cand);
        if (lane == 0) kth[g] = cand;
      }
    } else {
      kth_largest_rows(mass, kLatRows, nvb, p.keep_blocks, kth, red);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nvb; j += kThreads) {
      uint8_t any = 0;
#pragma unroll
      for (int g = 0; g < kLatRows; ++g) {
        const float mj = mass[g * nvb + j];
        const uint8_t k = (mj >= kth[g]) && (mj > 0.f);
        keep[g * nvb + j] = k;
        any |= k;
        if (p.keep_out != nullptr && g < gl)
          p.keep_out[(row0 + g) * nvb + j] = k;
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

  // ---- P·V over the kept blocks, their rows back to back as "virtual
  // rows", 64 a tile (pieces of min(vb, 64) rows inside one block, each
  // with its V scale segment), 32 a k-step (inside one block).  The
  // appended column is added last from the new row's f32 V scale; 8-bit
  // row weights w8 = rint(w * 127 / wmax) on the stored int8 rows.
  //
  // A (w8, M = 16 rows x 32 tokens): k = 4 tig + i of a k-step's first
  // (second) 16 is token 2 tig + (i & 1) + 8 (i >> 1) (+ 16).  B (V, 32
  // tokens x N = 8 lanes): the warp's 32-lane groups ag = warp + 8 j;
  // n-tile 4 ag + i, column n is lane 32 ag + 4 n + i, so that a thread
  // reads one word (4 lanes) of each of its 4 tokens and transposes them
  // into the 4 n-tiles' operands.  Both choices put a load's 32 words on
  // distinct banks.
  const int piece = p.piece;
  const int sstride = seg_stride(piece, es), vmis = misalign(vcol);
  const int nvr = nk * vb;
  const int na = (d + 31) / 32;
  auto token = [&](int vr) {
    const int k = vr / vb;
    return (vprune ? kblk[k] : k) * vb + vr % vb;
  };
  const float wA = wrow[gq], wB = wrow[gq + 8];
  const float rA = 127.f / fmaxf(misc[kWmax * kLatRows + gq], 1e-30f);
  const float rB = 127.f / fmaxf(misc[kWmax * kLatRows + gq + 8], 1e-30f);
  int acc[3][4][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][n][k] = 0;
  lat_stream(
      ring, (nvr + kLatTile - 1) / kLatTile,
      [&](int i, uint8_t* st, uint32_t bar, bool go) {
        const int vr0 = i * kLatTile, rows = min(kLatTile, nvr - vr0);
        uint32_t bytes = 0;
        for (int j = 0; j * piece < rows; ++j) {
          const int tf = token(vr0 + j * piece);
          bytes += lat_boxes(st + j * piece * 128, &p.vf_map, b * p.Ct + tf,
                             piece, bar, go);
          bytes += seg_copy(st + kLatSegOff + j * sstride, vcol, tf, piece,
                           es, bar, go);
        }
        return bytes;
      },
      [&](int i, const uint8_t* st) {
        const int vr0 = i * kLatTile, rows = min(kLatTile, nvr - vr0);
        for (int ks = 0; 32 * ks < rows; ++ks) {
          const int tb = token(vr0 + 32 * ks);         // tokens tb .. tb + 31
          const int pj = 32 * ks / piece;
          const uint8_t* seg = st + kLatSegOff + pj * sstride;
          const int tf = token(vr0 + pj * piece);
          const int blk = tb / vb;
          const bool kA = !vprune || keep[gq * nvb + blk];
          const bool kB = !vprune || keep[(gq + 8) * nvb + blk];
          uint32_t a[4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            uint32_t wa = 0, wb = 0;
#pragma unroll
            for (int i4 = 0; i4 < 4; ++i4) {
              const int t = tb + 16 * hf + 2 * tig + (i4 & 1) + 8 * (i4 >> 1);
              if (t >= len || t == idx) continue;       // not fetched
              const float vsc = seg_at(seg, vmis, tf, t, p.sc_bf16);
              if (kA) {
                const float wt = __fmul_rn(
                    __fmul_rn(s[static_cast<size_t>(gq) * ss + t], wA), vsc);
                wa |= static_cast<uint32_t>(fminf(
                          fmaxf(rintf(__fmul_rn(wt, rA)), 0.f), 127.f))
                      << (8 * i4);
              }
              if (kB) {
                const float wt = __fmul_rn(
                    __fmul_rn(s[static_cast<size_t>(gq + 8) * ss + t], wB),
                    vsc);
                wb |= static_cast<uint32_t>(fminf(
                          fmaxf(rintf(__fmul_rn(wt, rB)), 0.f), 127.f))
                      << (8 * i4);
              }
            }
            a[2 * hf] = wa;
            a[2 * hf + 1] = wb;
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int ag = warp + 8 * j;
            if (ag >= na) break;
            const int bx = ag >> 2, ch = 2 * (ag & 3) + (gq >> 2);
            const uint8_t* box = st + bx * kLatBoxBuf + 4 * (gq & 3);
            uint32_t bf[2][4];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              uint32_t w[4];
#pragma unroll
              for (int i4 = 0; i4 < 4; ++i4) {
                const int r = 32 * ks + 16 * hf + 2 * tig + (i4 & 1) +
                              8 * (i4 >> 1);
                w[i4] = *reinterpret_cast<const uint32_t*>(box + swz(r, ch));
              }
              // bf[hf][n] byte i = lane 4 gq + n of token i: a 4 x 4 byte
              // transpose
              const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
              const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
              const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
              const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
              bf[hf][0] = __byte_perm(t0, t2, 0x5410);
              bf[hf][1] = __byte_perm(t0, t2, 0x7632);
              bf[hf][2] = __byte_perm(t1, t3, 0x5410);
              bf[hf][3] = __byte_perm(t1, t3, 0x7632);
            }
#pragma unroll
            for (int n = 0; n < 4; ++n) mma_s8(acc[j][n], a, bf[0][n], bf[1][n]);
          }
        }
      });
  // thread (gq, tig) holds rows gq and gq + 8 at lanes 32 ag + 8 tig + 0..7:
  // n-tile n's column 2 tig is lane + n, its column 2 tig + 1 lane + 4 + n
  const float kept_scale = 1.f / 127.f;
  const int kb_new = idx / vb;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int ag = warp + 8 * j;
    if (ag >= na) break;
    const int l0 = 32 * ag + 8 * tig;
    if (l0 >= d) continue;
    const uint2 raw = *reinterpret_cast<const uint2*>(
        vf + static_cast<size_t>(idx) * F + l0);
    const uint32_t vw[2] = {raw.x, raw.y};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int g = gq + 8 * rr;
      if (g >= gl) continue;
      const float wm = __fmul_rn(misc[kWmax * kLatRows + g], kept_scale);
      const float kept_new = (!vprune || keep[g * nvb + kb_new]) ? 1.f : 0.f;
      const float p_idx = __fmul_rn(
          __fmul_rn(misc[kEidx * kLatRows + g], wrow[g]), kept_new);
      float o[8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[n] = __fmul_rn(static_cast<float>(acc[j][n][2 * rr]), wm);
        o[4 + n] = __fmul_rn(static_cast<float>(acc[j][n][2 * rr + 1]), wm);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int v8 = static_cast<int8_t>((vw[k >> 2] >> (8 * (k & 3))) & 0xFF);
        const float vnew = __fmul_rn(static_cast<float>(v8), app[1]);
        o[k] = __fadd_rn(o[k], __fmul_rn(p_idx, vnew));
      }
      float4* dst = reinterpret_cast<float4*>(
          p.out + out0 + static_cast<size_t>(g) * d + l0);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
  }
}

}  // namespace

// The latent instance's launch, from spatten_fused_decode (the wrapper's G
// = 16): checks the call's shape and flags (one cached head, a group of
// 9-16 rows of 257-640 lanes, d a multiple of 16, int8 queries and
// pv_int8, delta-mode importance per query row or none, no accumulator,
// presoftmax, append mask or row stats; v_block a multiple of 32 that
// divides 64 or is a multiple of 64; packed tiles inside a pack unit's
// halves and quarters), encodes the planes' swizzled tensor maps and
// launches one CTA per batch row.  Returns a cudaError_t.
extern "C" int spatten_fused_decode_latent(const void* params, int B,
                                           void* stream) {
  Params p = *static_cast<const Params*>(params);
  const int vb = p.v_block, u = p.pack_unit;
  p.t_msb = p.klsb2 ? kLatTile / 2 : kLatTile;
  p.piece = vb < kLatTile ? vb : kLatTile;
  p.tpv = kLatTile;
  const bool shape_ok =
      p.Hkv == 1 && p.g >= 9 && p.g <= kLatRows && p.Hq == p.g &&
      p.d > 256 && p.d <= kLatLanes && p.d % 16 == 0 && p.F == p.d &&
      vb % 32 == 0 && (vb <= kLatTile ? kLatTile % vb == 0 : vb % kLatTile == 0) &&
      p.C % vb == 0 &&
      (!p.kmsb || ((u / 2) % p.t_msb == 0 &&
                   (!p.klsb2 || (u / 4) % p.t_msb == 0)));
  const bool flags_ok = p.qq && p.pv_int8 && p.imp == nullptr &&
                        !p.presoftmax && p.appmask == nullptr &&
                        p.mrow == nullptr && p.bplane == nullptr &&
                        (p.delta == nullptr || p.per_row);
  if (!shape_ok || !flags_ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = p.splane == nullptr;
  const size_t smem = lat_smem_bytes(p.C, vb, in_smem);
  if (smem > static_cast<size_t>(kLatSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t rows = static_cast<uint64_t>(B) * p.Ct;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t e = plane_map(p.kfull, rows, p.F, 128, kLatTile, &p.kf_map, sw);
  if (e == cudaSuccess && p.kmsb)
    e = plane_map(p.kmsb, rows / 2, p.F, 128, p.t_msb, &p.km_map, sw);
  if (e == cudaSuccess && p.klsb2)
    e = plane_map(p.klsb2, rows / 4, p.F, 128, p.t_msb, &p.kl2_map, sw);
  if (e == cudaSuccess)
    e = plane_map(p.vfull, rows, p.F, 128, p.piece, &p.vf_map, sw);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(fused_decode_kernel_latent,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_decode_kernel_latent<<<B, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
