// K1 and K5: the MC tile tables.
//
// K1 inserts one decoded frame into the persistent table at a DPB slot.
// It replaces the TPU kernel update_tile_table_pallas (_upd_kernel,
// libde265_tpu/ops/pallas/mc_tables.py:157-286). K5 builds fresh tables
// for a stack of R reference frames, as the tile-column decoder does once
// per frame; it replaces build_tile_table_pallas (_kernel,
// mc_tables.py:61-154). For every stride-4 tile (ty, tx) of the
// edge-padded planes of slot s (K1: the given slot; K5: each r < R) the
// table row
//   (s * nty_p + ty) * ntx + tx
// gets, at element p*T*T + c*T + r, the sample padded[p][4*ty + r][4*tx + c]
// (T = 16 luma with P = 1, T = 8 chroma with P = 2 interleaved [Cb|Cr]).
// Rows ty >= nty (the ROWPAD layout rows at the end of each slot) are
// written as zeros, as the plain versions do; the MC window clamp never
// reads them. (The TPU's K5 leaves roll residue there.)
//
// Tables are uint8 for 8-bit streams and int16 above 8 bits (the JAX
// program's table_geom); both kernels take either (elem_bytes).
//
// Bound on the H100: pure data movement, dominated by the 16x expanding
// write (about 153 MB per 4K 4:2:0 frame in uint8: a ~46 us floor at the
// H100 SXM's 3.35 TB/s, 700 W limit; twice the write for int16 tables).
// Design: K1 is K5 with R = 1 on the slot's rows: one kernel. A block
// owns a strip of TXB tile columns (TXB * row bytes = 8 KB of table a tile
// row, two 16-byte stores a thread) and walks TYB tile rows down it. It
// keeps the input rows of the current tile row in a ring of T + 4 rows in
// shared memory, stored column-major as the table's element type (4 uint8
// or 2 int16 rows of one column per 32-bit word, an odd word pitch per
// column against bank conflicts), so a 16-byte table chunk is 4 aligned
// 32-bit shared reads. Each tile row needs only 4 new input rows: they are
// requested with 16-byte cp.async copies (8 int16 samples) into a
// row-major buffer before the current tile row's stores are issued, then
// transposed into the ring words of the 4 rows the current tile row no
// longer reads; so every input row is loaded once per strip and its load
// overlaps the stores. Table rows go out with streaming stores: the table
// is not read again before the next frame's MC and a 4K luma slot (136
// MB) exceeds the 50 MB L2. Padded planes whose pitch is not a multiple
// of 8 samples stage with 2-byte loads instead. K5 adds the slot as the
// grid's third dimension. The TPU's MXU permutation dot, sublane roll and
// double-buffered DMA span are store tricks for that machine and are not
// carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int T, int P, typename OT>
struct Tiles {
  static constexpr int ROW = P * T * T;            // elements per table row
  static constexpr int EPC = 16 / (int)sizeof(OT); // elements per 16 bytes
  static constexpr int CHUNKS = ROW / EPC;         // 16-byte chunks per row
  static constexpr int TXB = 2 * THREADS / CHUNKS; // tile columns per block
  static constexpr int TYB = 4;                     // tile rows per block
  static constexpr int NC = 4 * (TXB - 1) + T;     // staged columns
  static constexpr int NCS = (NC + 7) / 8 * 8;     // staged, whole vectors
  static constexpr int RING = T + 4;               // input rows in the ring
  static constexpr int RPW = 4 / (int)sizeof(OT);  // rows per 32-bit word
  static constexpr int CPW = (RING / RPW) | 1;     // words per column
};

// request input rows R .. R+NR-1 of the block's columns [c0, c0 + ncols)
// into buf[p][m][col] (int16, row-major): 16-byte cp.async copies when
// VEC, else plain 2-byte loads
template <int NR, int P, int RB, int NCS, bool VEC>
__device__ __forceinline__ void fetch_rows(int16_t (*buf)[RB][NCS],
                                           const int16_t* __restrict__ padded,
                                           int Hp, int Wp, int R, int c0,
                                           int ncols) {
  if (VEC) {
    const int nv = (ncols + 7) >> 3;
    for (int i = threadIdx.x; i < P * NR * nv; i += THREADS) {
      const int p = i / (NR * nv);
      const int m = (i / nv) % NR;
      const int v = i % nv;
      cp_async16(&buf[p][m][8 * v],
                 padded + ((size_t)p * Hp + R + m) * Wp + c0 + 8 * v);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < P * NR * ncols; i += THREADS) {
      const int p = i / (NR * ncols);
      const int m = (i / ncols) % NR;
      const int c = i % ncols;
      buf[p][m][c] = padded[((size_t)p * Hp + R + m) * Wp + c0 + c];
    }
  }
}

// the NR fetched rows (input rows R .. R+NR-1, R % 4 == 0) into the ring,
// 4 rows at a time: rows R' .. R'+3 go to words (R' % RING) / RPW .. of
// each column. Rows R' - RING .. held those words, and the tile row that
// reads rows R' - RING + 4 .. R' - 1 reads none of them, so the next
// tile row's rows can be stored while that one is still being emitted.
template <int NR, int P, int RB, int NC, int NCS, int RING, int CPW,
          typename OT>
__device__ __forceinline__ void ring_store(uint32_t (*ring)[NC][CPW],
                                           int16_t (*buf)[RB][NCS], int R,
                                           int ncols) {
  constexpr int RPW = 4 / (int)sizeof(OT);
  for (int i = threadIdx.x; i < P * ncols; i += THREADS) {
    const int p = i / ncols;
    const int c = i % ncols;
#pragma unroll
    for (int q = 0; q < NR; q += 4) {
      const int w0 = ((R + q) % RING) / RPW;
      uint32_t s[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) s[m] = (uint16_t)buf[p][q + m][c];
      if (sizeof(OT) == 1) {
        ring[p][c][w0] = (s[0] & 0xff) | (s[1] & 0xff) << 8
                         | (s[2] & 0xff) << 16 | (s[3] & 0xff) << 24;
      } else {
        ring[p][c][w0] = s[0] | s[1] << 16;
        ring[p][c][w0 + 1] = s[2] | s[3] << 16;
      }
    }
  }
}

// Table rows of tile rows [ty0, ty0 + TYB) and tile columns
// [tx0, tx0 + TXB) of one plane group; `slot_rows` is the row of tile
// (0, 0) of the slot, `padded` the group's first plane (P planes of
// Hp x Wp int16).
template <int T, int P, typename OT, bool VEC>
__device__ __forceinline__ void tile_rows_block(
    OT* __restrict__ slot_rows, const int16_t* __restrict__ padded, int Hp,
    int Wp, int nty, int nty_p, int ntx, int ty0, int tx0) {
  using G = Tiles<T, P, OT>;
  constexpr int EPC = G::EPC, CHUNKS = G::CHUNKS, RING = G::RING;
  constexpr int RPW = G::RPW;
  __shared__ uint32_t ring[P][G::NC][G::CPW];
  __shared__ __align__(16) int16_t buf[P][T][G::NCS];

  const int ntxb = min(G::TXB, ntx - tx0);
  const int ncols = 4 * (ntxb - 1) + T;
  const int c0 = 4 * tx0;
  const int ty1 = min(ty0 + G::TYB, nty_p);
  const int nchunks = ntxb * CHUNKS;

  // the first tile row's T input rows
  if (ty0 < nty) {
    fetch_rows<T, P, T, G::NCS, VEC>(buf, padded, Hp, Wp, 4 * ty0, c0,
                                     ncols);
    if (VEC) cp_async_wait_all();
    __syncthreads();
    ring_store<T, P, T, G::NC, G::NCS, RING, G::CPW, OT>(ring, buf, 4 * ty0,
                                                          ncols);
    __syncthreads();
  }
  for (int ty = ty0; ty < ty1; ++ty) {
    uint4* out = reinterpret_cast<uint4*>(
        slot_rows + ((size_t)ty * ntx + tx0) * G::ROW);
    if (ty >= nty) {                         // layout padding rows
      for (int i = threadIdx.x; i < nchunks; i += THREADS)
        __stcs(out + i, make_uint4(0u, 0u, 0u, 0u));
      continue;
    }
    // the next tile row's 4 new input rows, in flight during the stores
    const bool more = ty + 1 < min(ty1, nty);
    if (more)
      fetch_rows<4, P, T, G::NCS, VEC>(buf, padded, Hp, Wp, 4 * ty + T, c0,
                                       ncols);
    const int rb = (4 * ty) % RING;          // ring row of input row 4ty
    for (int i = threadIdx.x; i < nchunks; i += THREADS) {
      const int txl = i / CHUNKS;
      const int k = i - txl * CHUNKS;
      uint32_t w[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int e = EPC * k + m * RPW;     // first element of word m
        const int p = e / (T * T);
        const int c = (e / T) % T;
        int rr = rb + e % T;
        rr -= rr >= RING ? RING : 0;
        w[m] = ring[p][4 * txl + c][rr / RPW];
      }
      __stcs(out + i, make_uint4(w[0], w[1], w[2], w[3]));
    }
    if (more) {
      if (VEC) cp_async_wait_all();
      __syncthreads();                       // every copy has landed
      ring_store<4, P, T, G::NC, G::NCS, RING, G::CPW, OT>(ring, buf,
                                                           4 * ty + T, ncols);
      __syncthreads();
    }
  }
}

// R table slots, one per grid z: K5's stack of R frames, or K1's one slot
// (table already offset to it)
template <int T, int P, typename OT, bool VEC>
__global__ void __launch_bounds__(THREADS)
tile_table_kernel(OT* __restrict__ table, const int16_t* __restrict__ padded,
                  int Hp, int Wp, int nty, int nty_p, int ntx) {
  using G = Tiles<T, P, OT>;
  const int r = blockIdx.z;
  tile_rows_block<T, P, OT, VEC>(
      table + (size_t)r * nty_p * ntx * G::ROW,
      padded + (size_t)r * P * Hp * Wp, Hp, Wp, nty, nty_p, ntx,
      blockIdx.y * G::TYB, blockIdx.x * G::TXB);
}

template <int T, int P, typename OT>
dim3 tile_grid(int ntx, int nty_p, int R) {
  using G = Tiles<T, P, OT>;
  return dim3((ntx + G::TXB - 1) / G::TXB, (nty_p + G::TYB - 1) / G::TYB, R);
}

// 16-byte staging needs 16-byte aligned planes and rows of 8k samples
bool vec_ok(const void* padded, int Wp) {
  return (uintptr_t)padded % 16 == 0 && Wp % 8 == 0;
}

template <int T, int P, typename OT>
cudaError_t launch_build(void* table, const int16_t* padded, int Hp, int Wp,
                         int nty, int nty_p, int ntx, int R, cudaStream_t s) {
  const dim3 grid = tile_grid<T, P, OT>(ntx, nty_p, R);
  if (vec_ok(padded, Wp))
    tile_table_kernel<T, P, OT, true><<<grid, THREADS, 0, s>>>(
        (OT*)table, padded, Hp, Wp, nty, nty_p, ntx);
  else
    tile_table_kernel<T, P, OT, false><<<grid, THREADS, 0, s>>>(
        (OT*)table, padded, Hp, Wp, nty, nty_p, ntx);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t launch_build_t(void* table, const int16_t* padded, int P, int T,
                           int Hp, int Wp, int nty, int nty_p, int ntx, int R,
                           cudaStream_t s) {
  if (P == 1 && T == 16)
    return launch_build<16, 1, OT>(table, padded, Hp, Wp, nty, nty_p, ntx, R,
                                   s);
  if (P == 2 && T == 8)
    return launch_build<8, 2, OT>(table, padded, Hp, Wp, nty, nty_p, ntx, R,
                                  s);
  return cudaErrorInvalidValue;
}

}  // namespace

// padded: (R, P, Hp, Wp) int16; table: (R * nty_p * ntx, P*T*T) of
// elem_bytes 1 (uint8) or 2 (int16).
extern "C" int k5_build_tile_table(void* table, const void* padded, int P,
                                   int T, int Hp, int Wp, int nty, int nty_p,
                                   int ntx, int R, int elem_bytes,
                                   void* stream) {
  if (R < 1 || nty_p > 65535 || R > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int16_t* pad = (const int16_t*)padded;
  if (elem_bytes == 1)
    return (int)launch_build_t<uint8_t>(table, pad, P, T, Hp, Wp, nty, nty_p,
                                        ntx, R, s);
  if (elem_bytes == 2)
    return (int)launch_build_t<int16_t>(table, pad, P, T, Hp, Wp, nty, nty_p,
                                        ntx, R, s);
  return (int)cudaErrorInvalidValue;
}

// padded: (P, Hp, Wp) int16; table: (NSLOTS * nty_p * ntx, P*T*T) of
// elem_bytes 1 (uint8, 8-bit streams) or 2 (int16, 9 to 12 bits); writes
// slot `slot`, as K5 with R = 1 on that slot's rows.
extern "C" int k1_update_tile_table(void* table, const void* padded, int P,
                                    int T, int Hp, int Wp, int nty,
                                    int nty_p, int ntx, int slot,
                                    int elem_bytes, void* stream) {
  if (slot < 0) return (int)cudaErrorInvalidValue;
  char* rows = (char*)table
               + (size_t)slot * nty_p * ntx * P * T * T * elem_bytes;
  return k5_build_tile_table(rows, padded, P, T, Hp, Wp, nty, nty_p, ntx, 1,
                             elem_bytes, stream);
}
