// K6: the in-loop deblocking filter (spec 8.7.2) of a picture's three
// planes, one launch a direction, in place.
//
// Replaces no TPU kernel: the JAX program deblocks with XLA ops
// (libde265_tpu/ops/filter_plan_jax.py plan_deblock_device, then
// ops/deblock_jax.py), which the port carried over as plain PyTorch
// (ops/filter_plan.plan_deblock_device, ops/deblock.deblock_luma_pass /
// deblock_chroma_pass: some 960 small launches a 4K picture). Here every
// thread derives what the planner derived, for its own 4-sample segment,
// straight from the frame's 4x4 grids (pm, cbf, tucb, edgeall, qp, off,
// pf, mv, poc), the CTB grids (sidx, allow_v / allow_h) and the slice
// rows (sh_disable, sh_beta, sh_tc):
//   luma bS: 2 where either side is intra, 1 on a transform edge with
//     coded coefficients on either side, else the motion rule (8.7.2.4:
//     prediction counts, reference pictures, |mv delta| >= 4); 0 off the
//     edge grid, on a CTB edge that allow_v / allow_h forbids (slices,
//     tiles), or in a slice with deblocking disabled;
//   beta and tc from the QP average and the slice offsets, shifted to the
//     bit depth; dE / dEp / dEq from lines 0 and 3 of the segment; the
//     strong or the weak filter on each of its 4 lines; pcm / transquant
//     bypass sides (the `off` grid) left as they are;
//   chroma (edges every 8 chroma samples, bS 2 only): the chroma QP (the
//     4:2:0 table, min(qpi, 51) in the other formats) and tc, then the
//     one-sample filter on each line of the map row's `rep` lines.
// CTB lookups use global luma coordinates (a strip's xoff added) clipped
// into the picture, as the planner's. Launch 1 filters the vertical edges
// of Y, Cb and Cr, launch 2 the horizontal ones; in place is exact, since
// an edge on the 8-sample grid writes at most p2..q2 and reads p3..q3, so
// no edge of one direction reads another's output.
//
// Bound on the H100: memory. A 4K 8-bit picture moves about 140 MB of
// int32 over both launches and three planes (a luma edge pass reads every
// sample and writes 6 of 8), ~0.04 ms at 3.35 TB/s; the stage was bound by
// the host's launches, which this kernel takes from ~960 to 2. Design: one
// thread per line of a segment (a row for a vertical edge, a column for a
// horizontal one), block x over lines, block y over edges, block z over
// planes. The 4 lines of a luma segment are 4 neighbouring lanes: lane 0
// of the group does the segment's grid lookups once and shuffles the
// packed (beta, tc, pcm) word to the others, and the decisions of lines 0
// and 3 go round by shuffles too. A warp of the vertical pass reads 32
// rows' 32-byte p3..q3 windows (two 16-byte loads a row where the pitch
// allows); one of the horizontal pass reads 32 neighbouring columns, so
// each of its 8 row loads is one 128-byte line. A warp whose segments
// are all inactive stops after the lookups.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

enum {
  G_PM, G_CBF, G_TUCB, G_EDGE, G_QP, G_OFF, G_PF, G_MV, G_POC, G_SIDX,
  G_ALLOW_V, G_ALLOW_H, G_DIS, G_BETA, G_TC, NGRID
};

// one grid as it arrives: element type code (0 uint8 / bool, 1 int8,
// 2 int16, 3 int32, 4 int64) and strides in elements
struct Grid {
  const void* p;
  int code;
  int s[4];
};

struct Plane {
  int32_t* p;
  int h, w, pitch;
};

// mirrored by ops/kernels/deblock.py (_Args)
struct Args {
  Grid g[NGRID];
  Plane pl[3];
  int gh, gw;               // the 4x4 grids' rows and columns
  int nctby, nctbx;
  int log2ctb, chroma_fmt, bd_y, bd_c, qpoff_cb, qpoff_cr, xoff;
  int vertical;
  int vec;                  // luma rows allow 16-byte window loads
};

__constant__ int BETA_T[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
    8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
__constant__ int TC_T[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,  4,
    4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
__constant__ int CHROMA_QP_T[14] = {29, 30, 31, 32, 33, 33, 34,
                                    34, 35, 35, 36, 36, 37, 37};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int ld(const Grid& g, long long i) {
  switch (g.code) {
    case 0: return static_cast<const uint8_t*>(g.p)[i];
    case 1: return static_cast<const int8_t*>(g.p)[i];
    case 2: return static_cast<const int16_t*>(g.p)[i];
    case 3: return static_cast<const int32_t*>(g.p)[i];
    default: return (int)static_cast<const long long*>(g.p)[i];
  }
}

__device__ __forceinline__ int at1(const Grid& g, int i) {
  return ld(g, (long long)i * g.s[0]);
}

__device__ __forceinline__ int at2(const Grid& g, int r, int c) {
  return ld(g, (long long)r * g.s[0] + (long long)c * g.s[1]);
}

__device__ __forceinline__ int at3(const Grid& g, int r, int c, int k) {
  return ld(g, (long long)r * g.s[0] + (long long)c * g.s[1] +
                   (long long)k * g.s[2]);
}

__device__ __forceinline__ int mv_at(const Grid& g, int r, int c, int l,
                                     int k) {
  return ld(g, (long long)r * g.s[0] + (long long)c * g.s[1] +
                   (long long)l * g.s[2] + (long long)k * g.s[3]);
}

__device__ __forceinline__ bool far(int ax, int ay, int bx, int by) {
  return abs(ax - bx) >= 4 || abs(ay - by) >= 4;
}

// spec 8.7.2.4 motion rule between blocks p = (pr, pc) and q = (qr, qc):
// 0 or 1 (ops/filter_plan._bs_motion)
__device__ __forceinline__ int bs_motion(const Args& a, int pr, int pc,
                                         int qr, int qc) {
  const Grid& pf = a.g[G_PF];
  const Grid& poc = a.g[G_POC];
  const Grid& mv = a.g[G_MV];
  const int pf0 = at3(pf, pr, pc, 0), pf1 = at3(pf, pr, pc, 1);
  const int qf0 = at3(pf, qr, qc, 0), qf1 = at3(pf, qr, qc, 1);
  const int np = pf0 + pf1, nq = qf0 + qf1;
  if (np != nq) return 1;
  if (np == 1) {
    const int lp = pf0 > 0 ? 0 : 1, lq = qf0 > 0 ? 0 : 1;
    return at3(poc, pr, pc, lp) != at3(poc, qr, qc, lq) ||
           far(mv_at(mv, pr, pc, lp, 0), mv_at(mv, pr, pc, lp, 1),
               mv_at(mv, qr, qc, lq, 0), mv_at(mv, qr, qc, lq, 1));
  }
  if (np != 2) return 0;
  const int pp0 = at3(poc, pr, pc, 0), pp1 = at3(poc, pr, pc, 1);
  const int qq0 = at3(poc, qr, qc, 0), qq1 = at3(poc, qr, qc, 1);
  if (min(pp0, pp1) != min(qq0, qq1) || max(pp0, pp1) != max(qq0, qq1))
    return 1;
  const int p0x = mv_at(mv, pr, pc, 0, 0), p0y = mv_at(mv, pr, pc, 0, 1);
  const int p1x = mv_at(mv, pr, pc, 1, 0), p1y = mv_at(mv, pr, pc, 1, 1);
  int q0x = mv_at(mv, qr, qc, 0, 0), q0y = mv_at(mv, qr, qc, 0, 1);
  int q1x = mv_at(mv, qr, qc, 1, 0), q1y = mv_at(mv, qr, qc, 1, 1);
  if (pp0 == pp1)
    return (far(p0x, p0y, q0x, q0y) || far(p1x, p1y, q1x, q1y)) &&
           (far(p0x, p0y, q1x, q1y) || far(p1x, p1y, q0x, q0y));
  if (pp0 != qq0) {             // align q's lists to p's by picture
    int tx = q0x, ty = q0y;
    q0x = q1x; q0y = q1y; q1x = tx; q1y = ty;
  }
  return far(p0x, p0y, q0x, q0y) || far(p1x, p1y, q1x, q1y);
}

// Where an edge segment sits: its q and p blocks on the 4x4 grid and its
// CTB-level verdict. s: segment index along the edge (grid row of a
// vertical edge, grid column of a horizontal one); qe: the q block's grid
// index across the edge. Returns false where the CTB boundary forbids the
// edge or the slice disables deblocking; else sets the slice row.
struct Seg {
  int qr, qc, pr, pc, se;
};

__device__ __forceinline__ bool locate(const Args& a, int s, int qe,
                                       Seg& g) {
  int gx, gy, across;
  if (a.vertical) {
    g.qr = g.pr = s;
    g.qc = qe;
    g.pc = qe - 1;
    gx = 4 * qe + a.xoff;
    gy = 4 * s;
    across = gx;
  } else {
    g.qc = g.pc = s;
    g.qr = qe;
    g.pr = qe - 1;
    gx = 4 * s + a.xoff;
    gy = 4 * qe;
    across = gy;
  }
  const int cy = clampi(gy >> a.log2ctb, 0, a.nctby - 1);
  const int cx = clampi(gx >> a.log2ctb, 0, a.nctbx - 1);
  if ((across & ((1 << a.log2ctb) - 1)) == 0 &&
      at2(a.g[a.vertical ? G_ALLOW_V : G_ALLOW_H], cy, cx) == 0)
    return false;
  g.se = at2(a.g[G_SIDX], cy, cx);
  return at1(a.g[G_DIS], g.se) == 0;
}

__device__ __forceinline__ int qp_avg(const Args& a, const Seg& g) {
  return (at2(a.g[G_QP], g.pr, g.pc) + at2(a.g[G_QP], g.qr, g.qc) + 1) >> 1;
}

__device__ __forceinline__ int pcm_bits(const Args& a, const Seg& g) {
  return (at2(a.g[G_OFF], g.pr, g.pc) != 0 ? 2 : 0) |
         (at2(a.g[G_OFF], g.qr, g.qc) != 0 ? 1 : 0);
}

// A luma segment's word: beta << 16 | tc << 2 | p_off << 1 | q_off, or 0
// where the segment is not filtered (bS 0, beta 0, tc 0, or both sides
// pcm / bypass). e: edge index (the edge sits at 8 * (e + 1)).
__device__ __forceinline__ int luma_word(const Args& a, int s, int e) {
  const int bit = a.vertical ? 1 : 2;
  Seg g;
  const int qe = 2 * e + 2;
  if (!locate(a, s, qe, g)) return 0;
  if ((at2(a.g[G_EDGE], g.qr, g.qc) & bit) == 0) return 0;
  int bs;
  if (at2(a.g[G_PM], g.qr, g.qc) == 1 || at2(a.g[G_PM], g.pr, g.pc) == 1)
    bs = 2;
  else if ((at2(a.g[G_TUCB], g.qr, g.qc) & bit) &&
           (at2(a.g[G_CBF], g.qr, g.qc) > 0 ||
            at2(a.g[G_CBF], g.pr, g.pc) > 0))
    bs = 1;
  else
    bs = bs_motion(a, g.pr, g.pc, g.qr, g.qc);
  if (bs == 0) return 0;
  const int qp = qp_avg(a, g);
  const int sh = a.bd_y - 8;
  const int beta =
      BETA_T[clampi(qp + at1(a.g[G_BETA], g.se), 0, 51)] << sh;
  const int tc =
      TC_T[clampi(qp + 2 * (bs - 1) + at1(a.g[G_TC], g.se), 0, 53)] << sh;
  const int pcm = pcm_bits(a, g);
  if (beta == 0 || tc == 0 || pcm == 3) return 0;
  return beta << 16 | tc << 2 | pcm;
}

// A chroma segment's word for plane cidx: tc << 2 | p_off << 1 | q_off,
// or 0. Chroma edges sit every sp = 8 * sub luma samples across the edge.
__device__ __forceinline__ int chroma_word(const Args& a, int s, int e,
                                           int cidx) {
  const int bit = a.vertical ? 1 : 2;
  const int sub = a.vertical ? (a.chroma_fmt == 3 ? 1 : 2)
                             : (a.chroma_fmt == 1 ? 2 : 1);
  Seg g;
  const int qe = 2 * sub * (e + 1);
  if (!locate(a, s, qe, g)) return 0;
  if ((at2(a.g[G_TUCB], g.qr, g.qc) & bit) == 0) return 0;
  if (at2(a.g[G_PM], g.qr, g.qc) != 1 && at2(a.g[G_PM], g.pr, g.pc) != 1)
    return 0;
  const int qpi = clampi(
      qp_avg(a, g) + (cidx == 1 ? a.qpoff_cb : a.qpoff_cr), 0, 57);
  int qpc;
  if (a.chroma_fmt == 1)
    qpc = qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : CHROMA_QP_T[qpi - 30];
  else
    qpc = min(qpi, 51);
  const int tc =
      TC_T[clampi(qpc + 2 + at1(a.g[G_TC], g.se), 0, 53)] << (a.bd_c - 8);
  const int pcm = pcm_bits(a, g);
  if (tc == 0 || pcm == 3) return 0;
  return tc << 2 | pcm;
}

// a line's window from x0 across the edge: along its row for a vertical
// edge (step 1), down its column for a horizontal one (step pitch)
__device__ __forceinline__ int32_t* win(const Plane& P, bool vertical,
                                        int line, int x0) {
  return vertical ? P.p + (long long)line * P.pitch + x0
                  : P.p + (long long)x0 * P.pitch + line;
}

__device__ __forceinline__ void luma_line(const Args& a, int line, int e) {
  const Plane& P = a.pl[0];
  const bool vert = a.vertical;
  const int nlines = vert ? P.h : P.w;
  const bool in = line < nlines;
  const int lane = threadIdx.x & 31;
  const int base = lane & ~3;
  int word = 0;
  if (in && (line & 3) == 0) word = luma_word(a, line >> 2, e);
  word = __shfl_sync(FULL, word, base);
  if (__all_sync(FULL, word == 0)) return;

  // p3 p2 p1 p0 q0 q1 q2 q3 at 8e+4 .. 8e+11 across the edge
  int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int32_t* w = nullptr;
  const long long step = vert ? 1 : P.pitch;
  if (word) {
    w = win(P, vert, line, 8 * e + 4);
    if (vert && a.vec) {
      const int4 lo = reinterpret_cast<const int4*>(w)[0];
      const int4 hi = reinterpret_cast<const int4*>(w)[1];
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = w[i * step];
    }
  }
  const int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3];
  const int q0 = v[4], q1 = v[5], q2 = v[6], q3 = v[7];
  const int beta = word >> 16, tc = (word >> 2) & 0x3fff;
  const int dp = abs(p2 - 2 * p1 + p0), dq = abs(q2 - 2 * q1 + q0);
  const bool sl = 2 * (dp + dq) < (beta >> 2) &&
                  abs(p3 - p0) + abs(q0 - q3) < (beta >> 3) &&
                  abs(p0 - q0) < ((5 * tc + 1) >> 1);
  const int dp0 = __shfl_sync(FULL, dp, base);
  const int dp3 = __shfl_sync(FULL, dp, base + 3);
  const int dq0 = __shfl_sync(FULL, dq, base);
  const int dq3 = __shfl_sync(FULL, dq, base + 3);
  const unsigned strong_lanes = __ballot_sync(FULL, sl);
  if (word == 0 || dp0 + dq0 + dp3 + dq3 >= beta) return;

  const int maxv = (1 << a.bd_y) - 1;
  int n[6] = {p2, p1, p0, q0, q1, q2};
  if ((strong_lanes >> base & 1) && (strong_lanes >> (base + 3) & 1)) {
    const int t2 = 2 * tc;
    n[2] = clampi((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - t2,
                  p0 + t2);
    n[1] = clampi((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2);
    n[0] = clampi((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - t2,
                  p2 + t2);
    n[3] = clampi((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - t2,
                  q0 + t2);
    n[4] = clampi((p0 + q0 + q1 + q2 + 2) >> 2, q1 - t2, q1 + t2);
    n[5] = clampi((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - t2,
                  q2 + t2);
  } else {
    const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
    if (abs(delta) >= 10 * tc) return;
    const int dlt = clampi(delta, -tc, tc);
    const int th = tc >> 1;
    const int side = (beta + (beta >> 1)) >> 3;
    n[2] = p0 + dlt;
    n[3] = q0 - dlt;
    if (dp0 + dp3 < side)
      n[1] = clampi(p1 + clampi((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                                -th, th), 0, maxv);
    if (dq0 + dq3 < side)
      n[4] = clampi(q1 + clampi((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                                -th, th), 0, maxv);
  }
  if (!(word & 2)) {
#pragma unroll
    for (int i = 0; i < 3; ++i) w[(i + 1) * step] = clampi(n[i], 0, maxv);
  }
  if (!(word & 1)) {
#pragma unroll
    for (int i = 3; i < 6; ++i) w[(i + 1) * step] = clampi(n[i], 0, maxv);
  }
}

__device__ __forceinline__ void chroma_line(const Args& a, int cidx,
                                            int line, int e) {
  const Plane& P = a.pl[cidx];
  const bool vert = a.vertical;
  if (line >= (vert ? P.h : P.w)) return;
  // map rows are 4 luma samples along the edge: rep chroma lines each
  const int rep = vert ? (a.chroma_fmt == 1 ? 2 : 4)
                       : (a.chroma_fmt == 3 ? 4 : 2);
  const int s = line / rep;
  if (s >= (vert ? a.gh : a.gw)) return;
  const int word = chroma_word(a, s, e, cidx);
  if (word == 0) return;
  const long long step = vert ? 1 : P.pitch;
  int32_t* w = win(P, vert, line, 8 * e + 6);      // p1 p0 q0 q1
  const int p1 = w[0], p0 = w[step], q0 = w[2 * step], q1 = w[3 * step];
  const int tc = word >> 2;
  const int maxv = (1 << a.bd_c) - 1;
  const int delta = clampi((4 * (q0 - p0) + p1 - q1 + 4) >> 3, -tc, tc);
  if (!(word & 2)) w[step] = clampi(p0 + delta, 0, maxv);
  if (!(word & 1)) w[2 * step] = clampi(q0 - delta, 0, maxv);
}

// edges of plane group cidx (0 luma, else chroma) in this direction: luma
// edges every 8 samples, chroma edges every sp luma samples across
__host__ __device__ __forceinline__ int edges_of(const Args& a, int cidx) {
  const int across = 4 * (a.vertical ? a.gw : a.gh);
  if (cidx == 0) return across / 8 - 1;
  const int sp = 8 * (a.vertical ? (a.chroma_fmt == 3 ? 1 : 2)
                                 : (a.chroma_fmt == 1 ? 2 : 1));
  return across / sp - (across % sp == 0);
}

__global__ void __launch_bounds__(THREADS) deblock_kernel(const Args a) {
  const int cidx = blockIdx.z;
  const int e = blockIdx.y;
  const int line = blockIdx.x * THREADS + threadIdx.x;
  if (e >= edges_of(a, cidx)) return;                  // block-uniform
  if (cidx == 0)
    luma_line(a, line, e);
  else
    chroma_line(a, cidx, line, e);
}

}  // namespace

// One launch: the edges of one direction (args->vertical) in Y and, unless
// the picture is monochrome, Cb and Cr, in place. The planes are int32
// with unit column stride; the grids arrive as the frame program, the
// tile strips or the hybrid path leave them (any of the element types
// Grid.code names, any strides).
extern "C" int k6_deblock(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  const int lines = a.vertical ? a.pl[0].h : a.pl[0].w;
  int edges = edges_of(a, 0);
  if (a.chroma_fmt && edges_of(a, 1) > edges) edges = edges_of(a, 1);
  if (lines <= 0 || edges <= 0) return 0;
  const dim3 grid((lines + THREADS - 1) / THREADS, edges,
                  a.chroma_fmt ? 3 : 1);
  deblock_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
