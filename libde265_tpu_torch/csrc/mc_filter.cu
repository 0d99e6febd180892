// K2: inter prediction (motion compensation) of one plane group from the
// persistent MC tile table, in one launch.
//
// Replaces the TPU kernel mc_taps_pallas (_kernel,
// libde265_tpu/ops/pallas/mc_filter.py:33-81) together with the XLA work
// around it in ops/mc_tile_jax.py (window clamp and tile-row index
// :186-192 / :228-234, the row gather, the uni / bi / explicit-weighted
// combine :331-355) and the inter mask of frame_program.py:1028-1029.
// For every 4x4 luma block n (its 2x2 chroma blocks for the [Cb|Cr]
// table) and each list l it uses:
//   x0 = clamp(pos_x + (mvx >> FRAC) - OFF, LO, Wp + 1), y0 likewise;
//   row (slot * nty + ((y0 + T) >> 2)) * ntx + ((x0 + T) >> 2) of the
//   table, whose element p*T*T + c*T + r is tile sample (r, c);
//   th = taps[(mvx & (2^FRAC - 1)) * 4 + ((x0 + T) & 3)], tv likewise;
//   h-pass tmp[j][r] = (sum_u row[(u + j) * T + r] * th[u]) >> SHIFT1;
//   v-pass pred[i][j] = (sum_u tmp[j][i + u] * tv[u]) >> 6,
// then the spec 8.5.3.3.4.2 default or 8.5.3.3.4.3 explicit weighted
// combine and clip, and writes 0 where the block is not inter.
// Strip form (the tile-column decoder, mc_tile_jax.py:263-291): the
// blocks cover an output strip of luma width Ws whose global x origin is
// x0, so block n sits at x = (n % (Ws/4)) * 4 + x0 while the window clamp
// keeps the reference frame's (H, W); x0 = 0, Ws = W is the whole frame.
// Luma: T = 16, 4x4 outputs. Chroma: T = 8, 2x2 outputs for each of Cb
// and Cr from one 128-element row.
//
// Bound on the H100: memory. A 4K uni-predicted frame gathers 518,400 luma
// rows of 256 B and as many chroma rows of 128 B (199 MB, twice that where
// every block is bi-predicted) and writes 50 MB of int32 planes: ~0.08 ms
// at the H100 SXM's 3.35 TB/s (700 W limit); neighbouring chroma blocks
// often share a row, so fewer distinct bytes there. Every gathered row
// is a dependent load (its address comes from the block's MV), so rows
// must be in flight while earlier ones are filtered; with that, the
// h-pass's shared-memory reads and multiplies set much of the pace.
//
// Design: warps own blocks and never wait on each other (a block-wide
// barrier between each row gather and its use would leave one 16-byte
// load per thread in flight). A warp takes 32 consecutive blocks: each
// lane reads one block's grids and works out its table rows, taps and
// output offset, which the warp hands out by shuffles; it walks them 2
// luma / 4 chroma blocks a step, one group of G = 16 / 8 lanes per block.
// It keeps an NS-stage ring of gathered rows in its own shared memory,
// filled with 16-byte cp.async copies: the rows of step k + NS - 1 are
// requested before step k computes, so NS - 1 steps of rows are in
// flight per warp. Only __syncwarp() orders the ring; the one block-wide
// barrier stages the filters before any row is used. Taps:
// TH[f*4 + d][u] = F_f[u - d] (the tables of packing.py), so each pass
// runs the NT = 8 / 4 taps of F_f from offset d. h-pass: each lane
// computes 4 rows of one column; the column-major row keeps them in one
// 32-bit word (int16 tables: 64-bit), and for uint8 tables the word's
// even and odd bytes are multiplied as two 16-bit lanes of one int32
// (hpass below). v-pass: one output per lane from the warp's h-results in
// shared memory. Uni-predicted launches are a separate instantiation with
// no list-1 storage, copy or pass; in a bi launch a block with
// pf[n][1] == 0 gathers no list-1 row. Non-inter blocks read nothing. The
// TPU's lane-slab form (80/64-lane slices, an int8 tap matrix, f32 FMAs)
// is not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WPB = 4;                 // warps per thread block
constexpr int THREADS = 32 * WPB;
constexpr unsigned FULL = 0xffffffffu;

struct Geo {
  int n_bx, N;      // 4x4 blocks per output row, blocks in the output
  int x0;           // global luma x of the output's first column
  int ow;           // output plane width (luma Ws, chroma Ws/2)
  int nty, ntx;     // tile grid of this plane (rows padded to ROWPAD)
  int Hp, Wp;       // reference plane size (luma H, W or chroma H/2, W/2)
  int weighted, bitdepth;
};

__device__ __forceinline__ int clip_pel(int v, int maxv) {
  return min(max(v, 0), maxv);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every copy group of this thread but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// h-pass of one unit: acc[b] = sum_t row[t*T + b] * F[t], rows b < 4 of
// NT consecutive tile columns. uint8: each 32-bit word holds the 4 rows;
// its even and odd bytes are multiplied as two 16-bit lanes at once
// (rows 0|2 and 1|3). A lane's sum stays within +-2^15 (at most 88 * 255
// for the luma filters, 74 * 255 for chroma) and the packed sum within
// +-2^31, so the low lane is its low 16 bits, sign-extended, and the high
// lane what remains, shifted down: exact.
template <int NT, int T>
__device__ __forceinline__ void hpass(const uint8_t* row, const int* F,
                                      int acc[4]) {
  int a02 = 0, a13 = 0;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + t * T);
    a02 += (int)(w & 0x00ff00ffu) * F[t];
    a13 += (int)((w >> 8) & 0x00ff00ffu) * F[t];
  }
  acc[0] = (int)(int16_t)(a02 & 0xffff);
  acc[2] = (a02 - acc[0]) >> 16;
  acc[1] = (int)(int16_t)(a13 & 0xffff);
  acc[3] = (a13 - acc[1]) >> 16;
}

// int16 (10-12 bit) samples: one 64-bit word holds the 4 rows
template <int NT, int T>
__device__ __forceinline__ void hpass(const int16_t* row, const int* F,
                                      int acc[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) acc[b] = 0;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + t * T);
    acc[0] += (int)(int16_t)(w.x & 0xffff) * F[t];
    acc[1] += ((int)w.x >> 16) * F[t];
    acc[2] += (int)(int16_t)(w.y & 0xffff) * F[t];
    acc[3] += ((int)w.y >> 16) * F[t];
  }
}

// per block: its first output sample, and per list the table row and the
// taps (d | f << 2 | dy << 5 | fy << 7: 10 bits a list); bit 20 inter,
// bit 21 both lists used, bit 22 a block of the output (n < N)
struct Blocks {
  int idx0, idx1, meta, out;
};
constexpr int LIVE = 1 << 20, HAS1 = 1 << 21, VALID = 1 << 22;

// the grids of block n, read once, into what the warp hands out
template <int T, bool BI>
__device__ __forceinline__ Blocks block_of(int n, const int* mv,
                                           const int* slot, const int* pf,
                                           const uint8_t* inter,
                                           const Geo& g) {
  constexpr int FRAC = (T == 16) ? 2 : 3;   // fractional MV bits
  constexpr int OFF = (T == 16) ? 3 : 1;    // taps before the sample
  constexpr int LO = (T == 16) ? -14 : -7;  // window clamp, low side
  constexpr int S = (T == 16) ? 4 : 2;      // output side
  Blocks b = {0, 0, 0, 0};
  if (n >= g.N) return b;
  const int lbx = (n % g.n_bx) * 4;         // x within the output
  const int by = (n / g.n_bx) * 4;
  b.out = (by >> 2) * S * g.ow + (lbx >> 2) * S;
  b.meta = VALID;
  if (inter[n] == 0) return b;
  const bool has1 = BI && pf[2 * n] * pf[2 * n + 1] != 0;
  const int bx = lbx + g.x0;
  const int px = (T == 16) ? bx : (bx >> 1);
  const int py = (T == 16) ? by : (by >> 1);
  b.meta |= LIVE | (has1 ? HAS1 : 0);
#pragma unroll
  for (int l = 0; l < (BI ? 2 : 1); ++l) {
    if (l == 1 && !has1) break;
    const int mvx = mv[4 * n + 2 * l];
    const int mvy = mv[4 * n + 2 * l + 1];
    const int sl = slot[2 * n + l];
    const int x0 = min(max(px + (mvx >> FRAC) - OFF, LO), g.Wp + 1);
    const int y0 = min(max(py + (mvy >> FRAC) - OFF, LO), g.Hp + 1);
    const int idx = (sl * g.nty + ((y0 + T) >> 2)) * g.ntx + ((x0 + T) >> 2);
    const int m = ((x0 + T) & 3) | ((mvx & ((1 << FRAC) - 1)) << 2)
                  | (((y0 + T) & 3) << 5) | ((mvy & ((1 << FRAC) - 1)) << 7);
    b.meta |= m << (10 * l);
    if (l) b.idx1 = idx; else b.idx0 = idx;
  }
  return b;
}

// request the rows of step s (blocks s*BPW .. of the warp's 32, whose
// grids `b` holds, one per lane) into a ring stage: ring + (l*BPW + blk)
// * RP is the row of list l of this lane's block
template <int ROWB, int RP, int BPW, int CPL, int L, typename TT>
__device__ __forceinline__ void issue(const TT* table, const Blocks& b, int s,
                                      uint8_t* ring, int blk, int k) {
  const int src = s * BPW + blk;
  const int meta = __shfl_sync(FULL, b.meta, src);
  const int i0 = __shfl_sync(FULL, b.idx0, src);
  const int i1 = L == 2 ? __shfl_sync(FULL, b.idx1, src) : 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (!(meta & (l ? HAS1 : LIVE))) continue;
    const uint8_t* row = reinterpret_cast<const uint8_t*>(table)
                         + (size_t)(l ? i1 : i0) * ROWB;
    uint8_t* dst = ring + (l * BPW + blk) * RP;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      cp_async16(dst + 16 * (k * CPL + c), row + 16 * (k * CPL + c));
  }
}

// T: tile side; TT: table element; BI: list 1 may be used in this launch
template <int T, typename TT, int SHIFT1, bool BI>
__global__ void __launch_bounds__(THREADS)
mc_predict_kernel(const TT* __restrict__ table, const int* __restrict__ taps,
                  const int* __restrict__ mv, const int* __restrict__ slot,
                  const int* __restrict__ pf, const int* __restrict__ wts,
                  const int* __restrict__ ex,
                  const uint8_t* __restrict__ inter, int* __restrict__ out0,
                  int* __restrict__ out1, Geo g) {
  constexpr bool LUMA = T == 16;
  constexpr int U = LUMA ? 11 : 7;          // tap-table row width
  constexpr int NT = LUMA ? 8 : 4;          // filter taps
  constexpr int NF = LUMA ? 4 : 8;          // filters (MV fractions)
  constexpr int S = LUMA ? 4 : 2;           // output side
  constexpr int NP = LUMA ? 1 : 2;          // planes per table row
  constexpr int G = NP * S * S;             // lanes per block
  constexpr int BPW = 32 / G;               // blocks per warp step
  constexpr int NSC = G;                    // steps for the warp's 32 blocks
  constexpr int ROW = NP * T * T;           // table row elements
  constexpr int ROWB = ROW * (int)sizeof(TT);
  constexpr int RP = ROWB + (LUMA ? 64 : 16);  // ring row pitch, bytes
  constexpr int CPL = ROWB / 16 / G;        // 16-byte copies per lane
  constexpr int NS = sizeof(TT) == 1 ? 4 : 2;  // ring stages
  constexpr int L = BI ? 2 : 1;
  constexpr int NQ = T / 4;                 // 4-row groups of a column
  constexpr int TCP = LUMA ? 20 : 8;        // h-result column pitch (words)
  constexpr int TBP = LUMA ? 80 : 36;       // h-result block pitch (words)
  static_assert(NSC >= NS - 1 && ROWB % (16 * G) == 0 && RP % 16 == 0,
                "layout");
  __shared__ __align__(16) uint8_t s_ring[WPB][NS][L][BPW][RP];
  __shared__ __align__(16) int s_tmp[WPB][L][BPW][TBP];
  __shared__ int s_f[NF][NT];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int blk = lane / G;                 // block of this lane's group
  const int k = lane % G;                   // lane within the group
  const int n0 = 32 * (blockIdx.x * WPB + warp);  // this warp's 32 blocks

  // one block's grids per lane, on their way while the filters are
  // staged: F_f[t] = taps[(f * 4) * U + t]
  const Blocks blocks = block_of<T, BI>(n0 + lane, mv, slot, pf, inter, g);
  for (int q = threadIdx.x; q < NF * NT; q += THREADS)
    s_f[q / NT][q % NT] = taps[(q / NT) * 4 * U + q % NT];
  __syncthreads();

  // this lane's h-pass unit: tile column cj % S of plane cj / S, rows
  // 4q .. 4q+3; its v-pass output: sample (i, j) of plane p
  const int q = k % NQ;
  const int cj = k / NQ;
  const int hp = cj / S, hj = cj % S;
  const int j = k % S;
  const int i = (k / S) % S;
  const int p = k / (S * S);
  const int maxv = (1 << g.bitdepth) - 1;
  const int shift = 14 - g.bitdepth;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    issue<ROWB, RP, BPW, CPL, L>(table, blocks, s, &s_ring[warp][s][0][0][0],
                                 blk, k);
    cp_async_commit();
  }
  for (int s = 0; s < NSC; ++s) {
    if (s + NS - 1 < NSC)                   // the step requested now
      issue<ROWB, RP, BPW, CPL, L>(table, blocks, s + NS - 1,
                                   &s_ring[warp][(s + NS - 1) % NS][0][0][0],
                                   blk, k);
    cp_async_commit();

    const int n = n0 + s * BPW + blk;
    const int meta = __shfl_sync(FULL, blocks.meta, s * BPW + blk);
    const int ob = __shfl_sync(FULL, blocks.out, s * BPW + blk);
    const bool live = meta & LIVE;
    const bool has1 = BI && (meta & HAS1);
    int w5[5] = {0, 0, 0, 0, 0};
    bool exw = false;
    if (g.weighted && live) {             // in flight during the passes
      exw = ex[n] != 0;
      const int* w = wts + n * 15 + (p + (NP == 2 ? 1 : 0)) * 5;
#pragma unroll
      for (int u = 0; u < 5; ++u) w5[u] = w[u];
    }
    cp_async_wait<NS - 1>();              // this step's rows have landed
    __syncwarp();

    const int st = s % NS;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (!(l ? has1 : live)) continue;
      const int m = meta >> (10 * l);
      const int* F = s_f[(m >> 2) & 7];
      const TT* row = reinterpret_cast<const TT*>(s_ring[warp][st][l][blk])
                      + hp * T * T + (hj + (m & 3)) * T + 4 * q;
      int acc[4];
      hpass<NT, T>(row, F, acc);
      *reinterpret_cast<int4*>(&s_tmp[warp][l][blk][cj * TCP + 4 * q]) =
          make_int4(acc[0] >> SHIFT1, acc[1] >> SHIFT1, acc[2] >> SHIFT1,
                    acc[3] >> SHIFT1);
    }
    __syncwarp();
    int pred[2] = {0, 0};
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (!(l ? has1 : live)) continue;
      const int m = meta >> (10 * l);
      const int* F = s_f[(m >> 7) & 7];
      const int* tmp = &s_tmp[warp][l][blk][(p * S + j) * TCP + i
                                            + ((m >> 5) & 3)];
      int acc = 0;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc += tmp[t] * F[t];
      pred[l] = acc >> 6;
    }
    __syncwarp();                         // ring stage and h-results free

    if (meta & VALID) {
      int v = 0;
      if (live) {
        const int P0 = pred[0], P1 = pred[1];
        v = has1 ? clip_pel((P0 + P1 + (1 << shift)) >> (shift + 1), maxv)
                 : clip_pel((P0 + (1 << (shift - 1))) >> shift, maxv);
        if (exw) {
          const int w0 = w5[0], o0 = w5[1], w1 = w5[2], o1 = w5[3];
          const int l2 = w5[4];
          if (has1) {
            // (o0 + o1 + 1) may be negative: scale by a multiply
            v = clip_pel((P0 * w0 + P1 * w1 + (o0 + o1 + 1) * (1 << l2))
                         >> (l2 + 1), maxv);
          } else {
            const int rnd = l2 >= 1 ? 1 << (l2 - 1) : 0;
            v = clip_pel(((P0 * w0 + rnd) >> l2) + o0, maxv);
          }
        }
      }
      (p == 0 ? out0 : out1)[ob + i * g.ow + j] = v;
    }
  }
}

template <int T, typename TT, bool BI>
cudaError_t launch_shift(int shift1, const void* table, const int* taps,
                         const int* mv, const int* slot, const int* pf,
                         const int* wts, const int* ex, const uint8_t* inter,
                         int* out0, int* out1, Geo g, cudaStream_t s) {
  const int grid = ((g.N + 31) / 32 + WPB - 1) / WPB;
  const TT* tab = (const TT*)table;
#define K2_CASE(SH)                                                        \
  case SH:                                                                 \
    mc_predict_kernel<T, TT, SH, BI><<<grid, THREADS, 0, s>>>(             \
        tab, taps, mv, slot, pf, wts, ex, inter, out0, out1, g);           \
    break;
  switch (shift1) {
    K2_CASE(0) K2_CASE(1) K2_CASE(2) K2_CASE(3) K2_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef K2_CASE
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_elem(int elem_bytes, int bi, int shift1, const void* table,
                        const int* taps, const int* mv, const int* slot,
                        const int* pf, const int* wts, const int* ex,
                        const uint8_t* inter, int* out0, int* out1, Geo g,
                        cudaStream_t s) {
#define K2_ELEM(TT)                                                        \
  return bi ? launch_shift<T, TT, true>(shift1, table, taps, mv, slot, pf, \
                                        wts, ex, inter, out0, out1, g, s)  \
            : launch_shift<T, TT, false>(shift1, table, taps, mv, slot,    \
                                         pf, wts, ex, inter, out0, out1,   \
                                         g, s);
  if (elem_bytes == 1) K2_ELEM(uint8_t)
  if (elem_bytes == 2) K2_ELEM(int16_t)
#undef K2_ELEM
  return cudaErrorInvalidValue;
}

}  // namespace

// luma = 1: table rows of 256 elements, out0 = Y (H x Ws).
// luma = 0: [Cb|Cr] rows of 128 elements, out0 = Cb, out1 = Cr
// (H/2 x Ws/2). (H, W): the reference frames; Ws, x0: the output strip
// (Ws = W, x0 = 0 for a whole frame). wts / ex may be null when
// weighted = 0.
extern "C" int k2_mc_predict(const void* table, int elem_bytes, int luma,
                             const void* taps, const void* mv,
                             const void* slot, const void* pf,
                             const void* wts, const void* ex,
                             const void* inter, void* out0, void* out1,
                             int H, int W, int Ws, int x0, int nty, int ntx,
                             int bi, int weighted, int bitdepth,
                             void* stream) {
  if (bitdepth < 8 || bitdepth > 12 || H % 8 || W % 8 || Ws % 8 || x0 % 4)
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.n_bx = Ws / 4;
  g.N = (H / 4) * (Ws / 4);
  g.x0 = x0;
  g.ow = luma ? Ws : Ws / 2;
  g.nty = nty;
  g.ntx = ntx;
  g.Hp = luma ? H : H / 2;
  g.Wp = luma ? W : W / 2;
  g.weighted = weighted;
  g.bitdepth = bitdepth;
  const int shift1 = bitdepth - 8 < 4 ? bitdepth - 8 : 4;
  cudaStream_t s = (cudaStream_t)stream;
  const int* ip[6] = {(const int*)taps, (const int*)mv, (const int*)slot,
                      (const int*)pf, (const int*)wts, (const int*)ex};
  if (luma)
    return (int)launch_elem<16>(elem_bytes, bi, shift1, table, ip[0], ip[1],
                                ip[2], ip[3], ip[4], ip[5],
                                (const uint8_t*)inter, (int*)out0,
                                (int*)out1, g, s);
  return (int)launch_elem<8>(elem_bytes, bi, shift1, table, ip[0], ip[1],
                             ip[2], ip[3], ip[4], ip[5],
                             (const uint8_t*)inter, (int*)out0, (int*)out1,
                             g, s);
}
