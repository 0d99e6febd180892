// K4: intra reconstruction of a frame's TU slots (spec 8.4.4.2) as a
// wavefront over CTB-row bands, one thread block per band.
//
// Replaces the TPU kernel build_scan -> scan (libde265_tpu/ops/pallas/
// intra_scan.py:119-518), whose grid (band, TU slot) runs in order on
// one core. Each valid TU record of a band, in slot order:
//   1. gathers its 4n+1 reference samples in spec scan order (lane 0 =
//      bottom-most left sample p[-1][2n-1], lane 2n = corner, lane
//      2n+1+k = p[k][-1]) straight from the plane, substituted
//      (8.4.4.2.2) and smoothed (8.4.4.2.3) as they are read: when the
//      available lanes form one run [a, b), lane k reads the sample of
//      lane clamp(k, a, b-1), and each thread reads the lanes its
//      [1,2,1] or strong bilinear filter needs; with holes in the run,
//      every lane is read raw, one thread per plane fills forward /
//      backward over the availability row, then the filter runs as a
//      pass; none available -> 1 << (bitdepth-1);
//   2. predicts planar / DC / angular directly by the spec (8.4.4.2.4-6)
//      with the DC, mode-26 and mode-10 boundary filters for luma n < 32;
//   3. adds the residual, clips, and writes the block into the plane.
// The TPU kernel's int8 weight-table matvec, lane rolls and placement
// dot are MXU/VPU tricks, not the function, and are not carried over.
//
// Bound on the H100: the critical path in TU steps, not bytes (the bytes
// of a whole 4K IDR take ~0.04 ms at 3.35 TB/s). A TU depends on its
// reconstructed neighbours, but reads only two things outside its own
// band: the row above the band, up to the CTB one column to its right
// (above-right), and below-left samples in the band below, which are
// never available. So band b may reconstruct CTB column c once band b-1
// has finished every slot in columns <= c+1: the two-CTB lag of WPP.
// All bands run at once; the critical path is one band's TUs plus
// (bands - 1) lags (band_waits in the wrapper, wavefront_steps in
// profile_frames.py), where
// the serial walk took every TU of the frame in turn. A TU step is a
// chain of latencies (shared-memory records, one L2 round trip for the
// border, two barriers), so the design keeps that chain short:
//   - Blocks take their band from an atomic ticket, so a block only ever
//     waits on a band that an already running block owns: no deadlock
//     whether or not every block is resident, no cooperative launch.
//   - need[t] (band_waits) is how many of band b-1's slots must be
//     finished before slot t reads the plane. One thread spins on an
//     acquire load of done[b-1] until it reaches need[t], then a
//     __syncthreads() passes that on to the block; the wait is skipped
//     when an earlier acquire already saw enough.
//   - After a slot's writes: __syncthreads(), __threadfence() and a
//     release store done[b] = slot + 1, but only where the next slot
//     lies in another CTB column (or is padding, or the band ends): every
//     need value of the band below is such a position, so no other store
//     can be waited on. The last thread waits and publishes: it starts
//     no residual copy for TUs below 32x32, so its fence does not wait
//     on one.
//   - L1 is not coherent across SMs: plane samples are read through L2
//     (__ldcg), never through a plain cached load.
//   - The band's records, pool rows, spans and waits are staged in shared
//     memory a chunk at a time with coalesced loads, so a TU's chain
//     starts at shared memory. The next slot's residual is copied into a
//     second shared buffer with cp.async while this slot runs.
//   - One copy of the prediction code, a plain loop over the samples: a
//     large kernel body runs out of the instruction cache on every TU.
//   - Discarded reads: on the fill path every raw lane is read, including
//     unavailable ones (clamped coordinates, below-left lanes in band
//     b+1, above-right lanes past what band b-1 has published). Those
//     reads race with other bands' writes and may return any value; that
//     is harmless only because the fill reads only lanes marked available
//     (ok), so no unavailable raw value ever reaches a reference sample.
//     The clamp path reads available lanes only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LMAX = 4 * 32 + 1;           // border length for n = 32
constexpr int RMAX = 2 * 32 * 32;          // residual samples of a slot
constexpr int CH = 1024;                   // slots staged at a time
constexpr int ONE = THREADS - 1;           // the thread that waits and
                                           // publishes
constexpr unsigned long long WAIT_NS = 4000000000ull;  // then trap

__constant__ int kAngle[35] = {
    0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
    -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ int kInvAngle[35] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638, -910, -630, -482, -390,
    -315, -256, -315, -390, -482, -630, -910, -1638, -4096, 0, 0, 0, 0, 0,
    0, 0, 0, 0};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every copy group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// start copying one slot's residual rows (g0 / g1) into dst, 16 bytes a
// thread and copy: dst[p * n*n + s] = resid[g_p][s]
__device__ __forceinline__ void fetch_resid(int* dst, const int32_t* resid,
                                            int RW, int g0, int g1,
                                            int log2, int nplanes,
                                            int tid) {
  const int nsq = 1 << (2 * log2);
  for (int i = 4 * tid; i < nplanes * nsq; i += 4 * THREADS)
    cp_async16(dst + i, resid + (size_t)(i >= nsq ? g1 : g0) * RW
                            + (i & (nsq - 1)));
}

// reference sample k of the main projection (spec refMain[k]) as an
// index into the border; clamped only for the taps multiplied by 0
__device__ __forceinline__ int main_ref(const int* F, int c2, int L, int k,
                                        int inv, bool vert) {
  int j;
  if (k >= 0) {
    j = vert ? c2 + k : c2 - k;
  } else {
    const int q = (k * inv + 128) >> 8;
    j = vert ? c2 - q : c2 + q;
  }
  return F[min(max(j, 0), L - 1)];
}

__device__ __forceinline__ int predict(const int* F, int mode, int n,
                                       int log2, int r, int c, bool fix,
                                       int dc, int maxv) {
  const int c2 = 2 * n;
  const int L = 4 * n + 1;
  if (mode == 0) {                                    // planar
    return ((n - 1 - c) * F[c2 - 1 - r] + (c + 1) * F[c2 + n + 1]
            + (n - 1 - r) * F[c2 + 1 + c] + (r + 1) * F[c2 - n - 1] + n)
           >> (log2 + 1);
  }
  if (mode == 1) {                                    // DC
    if (fix) {
      if (r == 0 && c == 0)
        return (F[c2 - 1] + 2 * dc + F[c2 + 1] + 2) >> 2;
      if (r == 0) return (F[c2 + 1 + c] + 3 * dc + 2) >> 2;
      if (c == 0) return (F[c2 - 1 - r] + 3 * dc + 2) >> 2;
    }
    return dc;
  }
  if (fix && mode == 26 && c == 0)
    return min(max(F[c2 + 1] + ((F[c2 - 1 - r] - F[c2]) >> 1), 0), maxv);
  if (fix && mode == 10 && r == 0)
    return min(max(F[c2 - 1] + ((F[c2 + 1 + c] - F[c2]) >> 1), 0), maxv);
  const bool vert = mode >= 18;
  const int angle = kAngle[mode];
  const int inv = kInvAngle[mode];
  // vertical modes project along rows (i = r), horizontal along columns
  const int i = vert ? r : c;
  const int j = vert ? c : r;
  const int pos = (i + 1) * angle;
  const int idx = pos >> 5;
  const int fact = pos & 31;
  const int a = main_ref(F, c2, L, j + idx + 1, inv, vert);
  const int b = main_ref(F, c2, L, j + idx + 2, inv, vert);
  return ((32 - fact) * a + fact * b + 16) >> 5;
}

// plane offset of border lane k of the TU at (y, x), clamped into the
// picture (out-of-picture lanes are unavailable)
__device__ __forceinline__ size_t lane_at(int k, int n, int y, int x,
                                          int H, int W) {
  const int c2 = 2 * n;
  const int yy = k < c2 ? y + c2 - 1 - k : y - 1;
  const int xx = k < c2 ? x - 1 : x + k - c2 - 1;
  return (size_t)min(max(yy, 0), H - 1) * W + min(max(xx, 0), W - 1);
}

// smoothed lane k (8.4.4.2.3) of the substituted border R(.): filt 0
// none, 1 [1,2,1], 2 strong bilinear
template <class Ref>
__device__ __forceinline__ int smooth(const Ref& R, int k, int filt, int n) {
  const int v = R(k);
  const int c2 = 2 * n;
  if (filt == 0 || k == 0 || k == 4 * n) return v;
  if (filt == 1) return (R(k - 1) + 2 * v + R(k + 1) + 2) >> 2;
  const int di = abs(k - c2);
  if (di == 0) return v;
  return ((2 * n - di) * R(c2) + di * (k > c2 ? R(4 * n) : R(0)) + n) >> 6;
}

// strong smoothing applies (8.4.4.2.3): flat enough on both sides
template <class Ref>
__device__ __forceinline__ bool strong_ok(const Ref& R, int n,
                                          int bitdepth) {
  const int bt = 1 << (bitdepth - 5);
  const int c2 = 2 * n;
  return abs(R(c2) + R(4 * n) - 2 * R(c2 + n)) < bt
      && abs(R(c2) + R(0) - 2 * R(c2 - n)) < bt;
}

__global__ void __launch_bounds__(THREADS)
intra_wave_kernel(int32_t* plane0, int32_t* plane1, int nplanes, int H,
                  int W, const int32_t* __restrict__ recs,
                  const int32_t* __restrict__ rowg0,
                  const int32_t* __restrict__ rowg1,
                  const int32_t* __restrict__ spans,
                  const uint8_t* __restrict__ avail,
                  const int32_t* __restrict__ resid, int RW, int log2s,
                  int K, int BH, int strong, int luma, int bitdepth,
                  const int32_t* __restrict__ need, int* ticket,
                  int* done) {
  // staged slots [c0, c0 + CH]: one past the chunk, for the prefetch
  __shared__ int s_rec[CH + 1], s_rg0[CH + 1], s_rg1[CH + 1];
  __shared__ int s_sp[CH + 1], s_need[CH + 1];
  __shared__ __align__(16) int s_res[2][RMAX];
  __shared__ int F[2][LMAX];                 // the final border
  __shared__ int raw[2][LMAX];               // fill path only
  __shared__ int ref[2][LMAX];
  __shared__ int okr[LMAX];
  __shared__ int s_band, s_seen;
  const int tid = threadIdx.x;
  const int maxv = (1 << bitdepth) - 1;
  const int mid = 1 << (bitdepth - 1);

  if (tid == 0) s_band = atomicAdd(ticket, 1);
  __syncthreads();
  const int band = s_band;
  const int t0 = band * K;
  const int t1 = t0 + K;
  int seen = 0;          // done[band - 1] as last acquired (every thread)
  int c0 = t0;
  int pf = -1;           // slot whose residual is in s_res[buf ^ 1]
  int buf = 0;

  for (int t = t0; t < t1; ++t) {
    if (t - c0 == CH || t == t0) {
      __syncthreads();               // the previous chunk is read
      c0 = t;
      for (int i = tid; i <= CH && t + i < t1; i += THREADS) {
        const int rec = recs[t + i];
        const int g0 = rowg0[t + i];
        s_rec[i] = rec;
        s_rg0[i] = g0;
        s_rg1[i] = rowg1[t + i];
        s_need[i] = need[t + i];
        s_sp[i] = ((rec >> 27) & 1) ? spans[g0] : 0;
      }
      __syncthreads();
    }
    // every thread reads the same record: control flow stays uniform
    const int j = t - c0;
    const int rec = s_rec[j];
    if (!((rec >> 27) & 1)) continue;
    const int x = rec & 0x1FFF;
    const int y = band * BH + ((rec >> 13) & 63);
    const int mode = (rec >> 21) & 63;
    const bool fflag = (rec >> 28) & 1;
    const int log2 = (log2s >> (8 * ((rec >> 19) & 3))) & 255;
    const int n = 1 << log2;
    const int c2 = 2 * n;
    const int L = 4 * n + 1;

    // residual: copied while the previous slot ran, else now; then the
    // next slot's copy starts (one commit group per slot, maybe empty)
    buf ^= 1;
    if (pf != t) {
      fetch_resid(s_res[buf], resid, RW, s_rg0[j], s_rg1[j], log2, nplanes,
                  tid);
      cp_async_commit();
    }
    const int rec1 = t + 1 < t1 ? s_rec[j + 1] : 0;
    if ((rec1 >> 27) & 1) {
      fetch_resid(s_res[buf ^ 1], resid, RW, s_rg0[j + 1], s_rg1[j + 1],
                  (log2s >> (8 * ((rec1 >> 19) & 3))) & 255, nplanes, tid);
      pf = t + 1;
    }
    cp_async_commit();

    // wait until band - 1 has finished the slots this one may read
    const int nd = s_need[j];
    if (nd > seen) {
      if (tid == ONE) {
        const int* above = done + band - 1;
        int v = ld_acquire(above);
        const unsigned long long start = global_ns();
        while (v < nd) {
          __nanosleep(32);
          v = ld_acquire(above);
          if (global_ns() - start > WAIT_NS) __trap();
        }
        __threadfence();
        s_seen = v;
      }
      __syncthreads();
      seen = s_seen;
    }

    // 1. the border, substituted and smoothed
    const int sp = s_sp[j];
    const int sa = sp & 255;
    const int sb = (sp >> 8) & 511;
    const bool anyok = (sp >> 17) & 1;
    const bool hole = (sp >> 18) & 1;
    int filt = n >= 8 && fflag;
    const bool try_strong = strong && luma && n == 32 && filt;
    if (!hole) {
      const int32_t* P0 = plane0;
      const auto R0 = [&](int k) {
        return __ldcg(P0 + lane_at(min(max(k, sa), sb - 1), n, y, x, H, W));
      };
      if (anyok && try_strong && strong_ok(R0, n, bitdepth)) filt = 2;
      for (int i = tid; i < nplanes * L; i += THREADS) {
        const int p = i >= L;
        const int k = i - p * L;
        const int32_t* Pp = p ? plane1 : plane0;
        const auto R = [&](int kk) {
          return __ldcg(Pp + lane_at(min(max(kk, sa), sb - 1), n, y, x, H,
                                     W));
        };
        F[p][k] = anyok ? smooth(R, k, filt, n) : mid;
      }
    } else {
      const uint8_t* ok = avail + (size_t)s_rg0[j] * 256;
      for (int i = tid; i < nplanes * L; i += THREADS) {
        const int p = i >= L;
        const int k = i - p * L;
        raw[p][k] = __ldcg((p ? plane1 : plane0) + lane_at(k, n, y, x, H, W));
        if (!p) okr[k] = ok[k];
      }
      __syncthreads();
      if (tid < nplanes) {
        int f = 0;
        while (!okr[f]) ++f;
        int last = raw[tid][f];
        for (int k = 0; k < L; ++k) {
          if (okr[k]) last = raw[tid][k];
          ref[tid][k] = k < f ? raw[tid][f] : last;
        }
      }
      __syncthreads();
      const auto R0 = [&](int k) { return ref[0][k]; };
      if (try_strong && strong_ok(R0, n, bitdepth)) filt = 2;
      for (int i = tid; i < nplanes * L; i += THREADS) {
        const int p = i >= L;
        const int* Rp = ref[p];
        F[p][i - p * L] = smooth([&](int kk) { return Rp[kk]; }, i - p * L,
                                 filt, n);
      }
    }
    cp_async_wait_prev();            // this slot's residual has landed
    __syncthreads();

    // 2./3. predict, add residual, clip, write back
    const bool fix = luma && n < 32;
    int dc0 = 0, dc1 = 0;
    if (mode == 1) {                 // every warp sums the 2n neighbours
      const int lane = tid & 31;
      for (int p = 0; p < nplanes; ++p) {
        int sum = lane < n ? F[p][c2 + 1 + lane] + F[p][c2 - 1 - lane] : 0;
        for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
        (p ? dc1 : dc0) = (sum + n) >> (log2 + 1);
      }
    }
    const int nsq = n * n;
    const int* res = s_res[buf];
    for (int i = tid; i < nplanes * nsq; i += THREADS) {
      const int p = i >= nsq;
      const int s = i - p * nsq;
      const int r = s >> log2;
      const int c = s & (n - 1);
      const int v = predict(F[p], mode, n, log2, r, c, fix, p ? dc1 : dc0,
                            maxv) + res[i];
      (p ? plane1 : plane0)[(size_t)(y + r) * W + x + c] =
          min(max(v, 0), maxv);
    }
    __syncthreads();

    // publish where the next slot leaves this CTB column
    if (tid == ONE && (!((rec1 >> 27) & 1)
                       || (rec1 & 0x1FFF) / BH != x / BH)) {
      __threadfence();
      st_release(done + band, t - t0 + 1);
    }
  }
}

}  // namespace

extern "C" int k4_intra_scan(void* plane0, void* plane1, int nplanes, int H,
                             int W, const void* recs, const void* rowg0,
                             const void* rowg1, const void* spans,
                             const void* avail, const void* resid, int RW,
                             int log2s, int nslots, int K, int BH,
                             int strong, int luma, int bitdepth,
                             const void* need, void* ticket, void* done,
                             void* stream) {
  if (nplanes < 1 || nplanes > 2 || K < 1 || nslots % K || RW % 4
      || (uintptr_t)resid % 16)
    return (int)cudaErrorInvalidValue;
  if (nslots == 0) return (int)cudaSuccess;
  intra_wave_kernel<<<nslots / K, THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)plane0, (int32_t*)(nplanes == 2 ? plane1 : plane0), nplanes,
      H, W, (const int32_t*)recs, (const int32_t*)rowg0,
      (const int32_t*)(nplanes == 2 ? rowg1 : rowg0),
      (const int32_t*)spans, (const uint8_t*)avail, (const int32_t*)resid,
      RW, log2s, K, BH, strong, luma, bitdepth, (const int32_t*)need,
      (int*)ticket, (int*)done);
  return (int)cudaGetLastError();
}
