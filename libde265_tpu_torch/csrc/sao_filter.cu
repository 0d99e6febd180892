// K3: SAO (spec 8.7.3) of one plane from the per-CTB SAO parameters.
//
// Replaces the TPU kernel sao_pallas (_kernel,
// libde265_tpu/ops/pallas/sao_filter.py:32-64) together with the planner
// that fed it (filter_plan_jax.plan_sao_device / plan_sao_compact, which
// expand every CTB's parameters into per-sample maps first). Here each
// thread block owns one tile of the plane on the GLOBAL CTB grid: plane
// column c sits at global column gx = c + gx0 (gx0 = xoff / sub, negative
// for the first halo-extended strip of a tile column), so a strip whose
// origin is not a multiple of the CTB width still tiles correctly. Tiles
// left of the picture or right of its last CTB take the clamped CTB's
// parameters, as the planner's clipped lookups do. Per sample, by the
// block's SAO type (0 with the slice's sao flag off):
//   1 band offset: k = ((x >> (bitdepth-5)) - band) & 31, offs[k] if k < 4
//   2 edge offset: the EO class picks the neighbour pair (a, b) (0
//     horizontal, 1 vertical, 2 135 degrees, 3 45 degrees) and
//     sign(x-a) + sign(x-b) = -2,-1,1,2 selects offs[0..3]; a sample
//     whose pair crosses a CTB edge that pair_ok forbids, or the
//     picture's right/bottom edge, passes through
//   pcm/tq-bypass samples (the 4x4 `off` grid) pass through
// then every sample is clipped to [0, 2^bitdepth - 1]. Neighbours are read
// with plane-clamped coordinates, as the plain version (sao_filter_plain)
// reads them. Type, band and offsets are narrowed to int8 as the planner
// narrows them.
//
// Bound on the H100: memory, the plane read once and written once (8
// bytes a sample; the off grid and the CTB parameters are ~1% of it): a
// ~20 us floor for a 4K luma plane and ~5 us for a 4K chroma plane at the
// H100 SXM's 3.35 TB/s (700 W limit). Design: the block reads its CTB's
// type, class or band position, four offsets, slice flag and four pair
// flags once, so mode and class are uniform across the block and no warp
// diverges on them. Each thread produces 4 consecutive samples of a row
// (one 16-byte load and store where the pitch and the tile's columns
// allow, scalar accesses at ragged edges). Band and pass-through tiles
// stream straight from the plane; an edge tile stages its rows and a
// one-sample halo ring into shared memory with 16-byte cp.async copies
// (4-byte copies for the two halo columns, plain loads where the pitch
// is not a multiple of 4 samples) and reads the neighbours there. An edge
// tile in which every sample is pcm/tq-bypass copies without staging.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

struct Args {
  int32_t* out;                 // (H, W), pitch W
  const int32_t* x;             // (H, W), pitch xpitch
  const void* off;              // 4x4 pcm/tq-bypass grid, 1 or 4 bytes
  const uint8_t* type;          // (nctby, nctbx, 3)
  const uint8_t* eo;
  const uint8_t* band;
  const int16_t* offs;          // (nctby, nctbx, 3, 4)
  const int32_t* sidx;          // (nctby, nctbx)
  const int32_t* en;            // slice rows: sh_sao_luma or _chroma
  const uint8_t* pair_ok;       // (4, nctby, nctbx): left right up down
  int H, W, xpitch, opitch, oes;
  int gx0, tx0, ctb, ctbv, fxs, fys, wpic, nctby, nctbx, cidx, bitdepth;
  int vec;                      // 16-byte accesses allowed
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int pick(int k, int o0, int o1, int o2, int o3) {
  return k == 0 ? o0 : k == 1 ? o1 : k == 2 ? o2 : k == 3 ? o3 : 0;
}

__device__ __forceinline__ bool skip_at(const Args& a, int y, int c) {
  const long long i = (long long)(y >> a.fys) * a.opitch + (c >> a.fxs);
  return a.oes == 4 ? static_cast<const int32_t*>(a.off)[i] != 0
                    : static_cast<const uint8_t*>(a.off)[i] != 0;
}

// The tile geometry of this block: rows [y0, y0 + rows), plane columns
// [c_lo, c_hi), walked in units of 4 columns from ub (c_lo rounded down to
// a multiple of 4), nu units a row.
struct Tile {
  int y0, rows, c_lo, c_hi, ub, nu;
};

// 4 samples of plane row y from column c0 (only those in [c_lo, c_hi))
__device__ __forceinline__ void load4(const Args& a, const Tile& t,
                                      bool full, int y, int c0, int v[4]) {
  const int32_t* row = a.x + (long long)y * a.xpitch;
  if (full) {
    const int4 q = *reinterpret_cast<const int4*>(row + c0);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      v[i] = (c >= t.c_lo && c < t.c_hi) ? row[c] : 0;
    }
  }
}

__device__ __forceinline__ void store4(const Args& a, const Tile& t,
                                       bool full, int y, int c0,
                                       const int v[4]) {
  int32_t* row = a.out + (long long)y * a.W;
  if (full) {
    *reinterpret_cast<int4*>(row + c0) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      if (c >= t.c_lo && c < t.c_hi) row[c] = v[i];
    }
  }
}

// band offset (isband) or pass-through straight from the plane
__device__ void band_or_copy(const Args& a, const Tile& t, bool isband,
                             int band, int o0, int o1, int o2, int o3) {
  const int maxv = (1 << a.bitdepth) - 1;
  const int n = t.rows * t.nu;
  for (int u = threadIdx.x; u < n; u += blockDim.x) {
    const int r = u / t.nu;
    const int c0 = t.ub + 4 * (u - r * t.nu);
    const int y = t.y0 + r;
    const bool full = a.vec && c0 >= t.c_lo && c0 + 4 <= t.c_hi;
    int v[4];
    load4(a, t, full, y, c0, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int d = 0;
      if (isband && c0 + i >= t.c_lo && c0 + i < t.c_hi &&
          !skip_at(a, y, c0 + i)) {
        d = pick(((v[i] >> (a.bitdepth - 5)) - band) & 31, o0, o1, o2, o3);
      }
      v[i] = clampi(v[i] + d, 0, maxv);
    }
    store4(a, t, full, y, c0, v);
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
sao_ctb_kernel(const Args a) {
  extern __shared__ int4 smem4[];
  int* s = reinterpret_cast<int*>(smem4);

  // ---- the block's CTB and its parameters (block-uniform)
  const int tx = a.tx0 + (int)blockIdx.x;       // global CTB column
  const int ty = (int)blockIdx.y;
  const int ci = min(ty, a.nctby - 1) * a.nctbx + clampi(tx, 0, a.nctbx - 1);
  const int pi = ci * 3 + a.cidx;
  int type = (int8_t)a.type[pi];
  if (a.en[a.sidx[ci]] == 0) type = 0;
  const int o0 = (int8_t)a.offs[4 * pi + 0];
  const int o1 = (int8_t)a.offs[4 * pi + 1];
  const int o2 = (int8_t)a.offs[4 * pi + 2];
  const int o3 = (int8_t)a.offs[4 * pi + 3];

  Tile t;
  t.y0 = ty * a.ctbv;
  t.rows = min(a.ctbv, a.H - t.y0);
  const int pxa = tx * a.ctb - a.gx0;            // plane column of gx = tx*ctb
  t.c_lo = max(pxa, 0);
  t.c_hi = min(pxa + a.ctb, a.W);
  t.ub = t.c_lo & ~3;
  t.nu = ((t.c_hi - 1) >> 2) - (t.c_lo >> 2) + 1;

  if (type == 1) {
    band_or_copy(a, t, true, (int8_t)a.band[pi], o0, o1, o2, o3);
    return;
  }
  if (type != 2) {
    band_or_copy(a, t, false, 0, 0, 0, 0, 0);
    return;
  }

  // ---- edge offset
  const int eo = (int8_t)a.eo[pi];
  const int cls = eo == 0 ? 0 : eo == 1 ? 1 : eo == 2 ? 2 : 3;
  const int nctb = a.nctby * a.nctbx;
  const bool okl = a.pair_ok[ci] != 0, okr = a.pair_ok[nctb + ci] != 0;
  const bool oku = a.pair_ok[2 * nctb + ci] != 0;
  const bool okd = a.pair_ok[3 * nctb + ci] != 0;
  const int n = t.rows * t.nu;

  // a tile that is pcm/tq-bypass everywhere passes through unstaged
  bool any = false;
  for (int u = threadIdx.x; u < n && !any; u += blockDim.x) {
    const int r = u / t.nu;
    const int c0 = t.ub + 4 * (u - r * t.nu);
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      if (c >= t.c_lo && c < t.c_hi && !skip_at(a, t.y0 + r, c)) any = true;
    }
  }
  if (!__syncthreads_or(any)) {
    band_or_copy(a, t, false, 0, 0, 0, 0, 0);
    return;
  }

  // stage rows y0-1 .. y0+rows and columns c_lo-1 .. c_hi (each clamped
  // into the plane): shared column j holds plane column ub - 4 + j, so the
  // unit at ub + 4v starts at the 16-byte aligned shared column 4 + 4v
  const int pitch = a.ctb + 8;
  const int srows = t.rows + 2;
  if (a.vec) {
    for (int q = threadIdx.x; q < srows * t.nu; q += blockDim.x) {
      const int r = q / t.nu, v = q - r * t.nu;
      const int yy = clampi(t.y0 - 1 + r, 0, a.H - 1);
      cp_async16(s + r * pitch + 4 + 4 * v,
                 a.x + (long long)yy * a.xpitch + t.ub + 4 * v);
    }
    for (int q = threadIdx.x; q < 2 * srows; q += blockDim.x) {
      const int r = q >> 1;
      const int c = (q & 1) ? t.c_hi : t.c_lo - 1;
      const int yy = clampi(t.y0 - 1 + r, 0, a.H - 1);
      cp_async4(s + r * pitch + (c - t.ub + 4),
                a.x + (long long)yy * a.xpitch + clampi(c, 0, a.W - 1));
    }
    cp_async_commit();
    cp_async_wait_all();
  } else {
    const int sw = t.c_hi - t.c_lo + 2;
    for (int q = threadIdx.x; q < srows * sw; q += blockDim.x) {
      const int r = q / sw;
      const int c = t.c_lo - 1 + (q - r * sw);
      const int yy = clampi(t.y0 - 1 + r, 0, a.H - 1);
      s[r * pitch + (c - t.ub + 4)] =
          a.x[(long long)yy * a.xpitch + clampi(c, 0, a.W - 1)];
    }
  }
  __syncthreads();

  // neighbour a at (dy, dx) of the sample, b at (-dy, -dx)
  const int dy = cls == 0 ? 0 : -1;
  const int dx = cls == 1 ? 0 : (cls == 3 ? 1 : -1);
  const int maxv = (1 << a.bitdepth) - 1;
  for (int u = threadIdx.x; u < n; u += blockDim.x) {
    const int r = u / t.nu, vu = u - r * t.nu;
    const int c0 = t.ub + 4 * vu;
    const int y = t.y0 + r;
    const int* sc = s + (r + 1) * pitch + 4 + 4 * vu;
    const int4 q = *reinterpret_cast<const int4*>(sc);
    const int v[4] = {q.x, q.y, q.z, q.w};
    // the a and b rows: an aligned 16-byte read and the one sample beside
    // it that the class's horizontal shift needs
    const int* ra = sc + dy * pitch;
    const int* rb = sc - dy * pitch;
    const int4 qa = *reinterpret_cast<const int4*>(ra);
    const int4 qb = *reinterpret_cast<const int4*>(rb);
    const int ea = dx < 0 ? ra[-1] : dx > 0 ? ra[4] : 0;
    const int eb = dx > 0 ? rb[-1] : dx < 0 ? rb[4] : 0;
    const int wa[6] = {ea, qa.x, qa.y, qa.z, qa.w, ea};
    const int wb[6] = {eb, qb.x, qb.y, qb.z, qb.w, eb};
    const bool at_u = r == 0;
    const bool at_d = r == a.ctbv - 1 || y == a.H - 1;
    const bool okv = (!at_u || oku) && (!at_d || okd);
    int res[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      const int gx = c + a.gx0;
      const int lc = gx - tx * a.ctb;
      const bool at_l = lc == 0;
      const bool at_r = lc == a.ctb - 1 || gx == a.wpic - 1;
      const bool okh = (!at_l || okl) && (!at_r || okr);
      const bool ok = cls == 0 ? okh : cls == 1 ? okv : (okh && okv);
      const int av = dx < 0 ? wa[i] : dx > 0 ? wa[i + 2] : wa[i + 1];
      const int bv = dx > 0 ? wb[i] : dx < 0 ? wb[i + 2] : wb[i + 1];
      int d = 0;
      if (ok && c >= t.c_lo && c < t.c_hi && !skip_at(a, y, c)) {
        const int e = sgn(v[i] - av) + sgn(v[i] - bv);
        d = e == -2 ? o0 : e == -1 ? o1 : e == 1 ? o2 : e == 2 ? o3 : 0;
      }
      res[i] = clampi(v[i] + d, 0, maxv);
    }
    store4(a, t, a.vec && c0 >= t.c_lo && c0 + 4 <= t.c_hi, y, c0, res);
  }
}

int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

}  // namespace

// One launch for one plane. out: (H, W) int32, contiguous; x: (H, W)
// int32 with row pitch xpitch; off: the 4x4 grid with row pitch opitch
// and element size oes (1 or 4); the CTB grids contiguous; gx0 = xoff /
// sub; (fxs, fys) = log2 of the 4x4 grid's block size in this plane's
// samples; wpic = picture width / sub; vec: x and out 16-byte aligned
// with pitches a multiple of 4 samples.
extern "C" int k3_sao_ctb(void* out, const void* x, const void* off,
                          const void* type, const void* eo, const void* band,
                          const void* offs, const void* sidx, const void* en,
                          const void* pair_ok, int H, int W, int xpitch,
                          int opitch, int oes, int gx0, int ctb, int ctbv,
                          int fxs, int fys, int wpic, int nctby, int nctbx,
                          int cidx, int bitdepth, int vec, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  Args a;
  a.out = (int32_t*)out;
  a.x = (const int32_t*)x;
  a.off = off;
  a.type = (const uint8_t*)type;
  a.eo = (const uint8_t*)eo;
  a.band = (const uint8_t*)band;
  a.offs = (const int16_t*)offs;
  a.sidx = (const int32_t*)sidx;
  a.en = (const int32_t*)en;
  a.pair_ok = (const uint8_t*)pair_ok;
  a.H = H; a.W = W; a.xpitch = xpitch; a.opitch = opitch; a.oes = oes;
  a.gx0 = gx0; a.ctb = ctb; a.ctbv = ctbv; a.fxs = fxs; a.fys = fys;
  a.wpic = wpic; a.nctby = nctby; a.nctbx = nctbx; a.cidx = cidx;
  a.bitdepth = bitdepth; a.vec = vec;
  a.tx0 = floor_div(gx0, ctb);
  const int ntx = floor_div(gx0 + W - 1, ctb) - a.tx0 + 1;
  const int nty = (H + ctbv - 1) / ctbv;
  // 2-4 units of 4 samples a thread: 256 threads for a 64x64 tile, 128
  // for a 32x32 one
  int threads = (ctb * ctbv / 8 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS
                                                        : threads);
  // the staged tile, and one 16-byte slack: the last unit of a tile whose
  // first column is not a multiple of 4 reads one word past its row
  const size_t smem = ((size_t)(ctbv + 2) * (ctb + 8) + 4) * sizeof(int);
  sao_ctb_kernel<<<dim3(ntx, nty), threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
