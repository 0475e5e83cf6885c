// Fused broadband shortwave two-stream flux solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel isca_tpu/physics/rrtmg_sw.py:sw_flux_solve
// (kernel body _sw_flux_kernel_body, with _reftra_level and reftra_sw). For
// every (column b, g-point g) it delta-scales tau/w0/g, computes the PIFM
// two-stream reflectances and transmittances and the direct-beam
// transmission exp(-min(tau/mu0, 500)), optionally blends a cloudy set by
// cloud fraction, runs the two adding sweeps of vrtqdr_sw, combines the
// fluxes at each of the L+1 levels and sums them over g weighted by zincflx.
// Outputs swd, swu, dird are (B, L+1). The plain PyTorch version of the same
// function is sw_flux_solve_reference in physics/rrtmg_sw.py.
//
// What bounds it on an H100: instruction issue. The bytes (each input read
// once: 3 or 7 x B*L*G*4 bytes, 0.086 ms clear and 0.196 ms cloudy at T42L25,
// B = 8192, L = 25, G = 112, at 3.35 TB/s) take less time than issuing the
// instructions. One evaluation of a layer's properties costs about 6 exp,
// 1 sqrt and 9 IEEE divisions, each a sequence of SASS instructions under
// --fmad=false. Counted in the SASS of the float32 build on the common path:
// 303 instructions per (column, layer, g) in phase 1 (586 cloudy), 40 per
// level and g in the up sweep and 134 in the down sweep (30 of them the
// warp-shuffle g-sums), so about 480 in all (about 760 cloudy).
//
// Design, against that bound: each layer's properties are computed once,
// by every lane, and the sweeps read them from shared memory.
//  * One block per column, `threads` threads (256), looping over g-chunks of
//    gc = ceil(G / chunks) g-points. The launch plan (threads, chunks, shared
//    memory bytes) comes from the wrapper (sw_flux_plan in
//    physics/rrtmg_sw.py), which picks the fewest chunks whose shared memory
//    fits a block, and two at least for float32 at L <= 32: this file
//    checks the plan.
//  * Phase 1: all threads walk the chunk's (l, g) items in flat order, so
//    consecutive threads read consecutive addresses of x[b, l, g], and
//    compute ref, refd, tra, trad and the direct beam of each item once
//    (both sets and the cloud-fraction blend when cloudy) into shared memory
//    as [5][L][w] (w = the chunk's width). This loop is the only place that
//    evaluates the layer properties.
//  * Up sweep, surface to top, one thread per g of the chunk (stage 2 of the
//    TPU kernel): rup and rupd per level into shared memory as [2][L+1][w].
//    The same thread reads them back in the down sweep, so no barrier
//    between the sweeps.
//  * Down sweep, top to surface, with the flux combine at each level
//    (stage 3): a warp-shuffle g-sum into per-warp partials; after the
//    chunk, thread l adds its level's partials in warp order to a register
//    sum, chunk after chunk, so the result is deterministic; at the end
//    thread l writes the three outputs of level l. Past the threads (L + 1
//    > threads), thread t also owns levels t + threads, t + 2 threads, ...,
//    whose sums it keeps in their outputs (the first chunk writes them).
//  * The sweeps are serial chains of divisions and shuffles over the levels
//    on only gc threads, so they are latency-bound; more resident blocks
//    hide them better than wider chunks do. Two chunks of 56 at the main
//    path (40 KB of shared memory, 4 blocks per SM at 50 registers) took
//    12% (clear) and 22% (cloudy) less time than one chunk of 112 (80.5 KB,
//    2 blocks per SM) on an H100 (PERF.md).
//  * Shared memory per block: ((5L + 2(L+1)) gc + 3(L+1) ceil(gc/32))
//    values, with gc <= threads. Any G (in as many chunks as it takes) and
//    any L whose chunk of one g-point fits a block: 10L + 5 values, so
//    L <= 5810 in float32 and 2905 in float64. Float64 at L = 64 takes two
//    chunks of 56 (G = 112) or three of 43 (G = 128).
//  * Built with --fmad=false so each multiply and add rounds as the plain
//    PyTorch version's separate elementwise kernels do.
//
// C interface (ctypes): sw_flux_f32 / sw_flux_f64 return a cudaError_t as
// int; the cloud pointers are null for the clear variant.
// sw_flux_blocks_per_sm reports the occupancy of a plan.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 384;   // __launch_bounds__; sw_flux_plan uses 256
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90 (SW_FLUX_MAX_SMEM)

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

// NaN-propagating min/max/clip, as jnp/torch minimum, maximum and clip.
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return a > b ? b : a; }
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a < b ? b : a; }
template <typename T>
__device__ __forceinline__ T vclip(T x, T lo, T hi) { return vmin(vmax(x, lo), hi); }

template <typename T>
struct Layer {
  T ref, refd, tra, trad, dbt;
};

// Delta scaling + reftra_sw (kmodts=2 PIFM) + direct-beam transmission of one
// layer, in the order of operations of rrtmg_sw.py's reftra_sw.
template <typename T>
__device__ __forceinline__ Layer<T> layer_properties(T tau, T w0, T g, T mu0) {
  const T one = T(1);
  {
    const T f = g * g;
    const T wf = w0 * f;
    tau = (one - wf) * tau;
    w0 = (w0 - wf) / (one - wf);
    g = (g - f) / (one - f);
  }
  Layer<T> out;
  out.dbt = dev_exp(-vmin(tau / mu0, T(500)));

  const T eps = T(1e-8);
  w0 = vclip(w0, T(0), one);
  g = vclip(g, T(0), T(1.0 - 1e-6));
  const T gamma1 = (T(8) - w0 * (T(5) + T(3) * g)) * T(0.25);
  const T gamma2 = T(3) * (w0 * (one - g)) * T(0.25);
  const T gamma3 = (T(2) - T(3) * g * mu0) * T(0.25);
  const T gamma4 = one - gamma3;
  const T gr = g / (one - g);
  const T zwo = w0 / (one - (one - w0) * (gr * gr));

  if (zwo >= T(0.9999995)) {
    // conservative scattering
    const T za = gamma1 * mu0;
    const T za1 = za - gamma3;
    const T zgt = gamma1 * tau;
    const T ze2c = dev_exp(-vmin(tau / mu0, T(500)));
    out.ref = vclip((zgt - za1 * (one - ze2c)) / (one + zgt), T(0), one);
    out.tra = one - out.ref;
    out.refd = zgt / (one + zgt);
    out.trad = one - out.refd;
    return out;
  }

  const T zrk = dev_sqrt(vmax(gamma1 * gamma1 - gamma2 * gamma2, T(1e-12)));
  const T zrp = zrk * mu0;
  const T zrp1 = one + zrp, zrm1 = one - zrp;
  const T zrk2 = T(2) * zrk;
  T zrpp = one - zrp * zrp;
  // secular singularity mu0 ~ 1/k
  if (fabs(zrpp) < T(1e-12)) {
    const T s = zrpp + T(1e-30);
    zrpp = (s > T(0) ? one : (s < T(0) ? -one : T(0))) * T(1e-12);
  }
  const T zrkg = zrk + gamma1;
  const T za1n = gamma1 * gamma4 + gamma2 * gamma3;
  const T za2n = gamma1 * gamma3 + gamma2 * gamma4;
  const T zr1 = zrm1 * (za2n + zrk * gamma3);
  const T zr2 = zrp1 * (za2n - zrk * gamma3);
  const T zr3 = zrk2 * (gamma3 - za2n * mu0);
  const T zr4 = zrpp * zrkg;
  const T zr5 = zrpp * (zrk - gamma1);
  const T zt1 = zrp1 * (za1n + zrk * gamma4);
  const T zt2 = zrm1 * (za1n - zrk * gamma4);
  const T zt3 = zrk2 * (gamma4 + za1n * mu0);
  const T zbeta = (gamma1 - zrk) / zrkg;

  // exponents capped at 40 so the zr*zep products stay finite in float32
  const T ze1 = vmin(zrk * tau, T(40));
  const T ze2 = vmin(tau / mu0, T(40));
  const T zem1 = dev_exp(-ze1);
  const T zep1 = dev_exp(ze1);
  const T zem2 = dev_exp(-ze2);
  const T zep2 = dev_exp(ze2);
  const T zden = zr4 * zep1 + zr5 * zem1;
  if (fabs(zden) <= eps) {
    out.ref = eps;
    out.tra = zem2;
  } else {
    out.ref = w0 * (zr1 * zep1 - zr2 * zem1 - zr3 * zem2) / zden;
    out.tra = zem2 - zem2 * w0 * (zt1 * zep1 - zt2 * zem1 - zt3 * zep2) / zden;
  }
  const T zemm = zem1 * zem1;
  const T zdend = one / ((one - zbeta * zemm) * zrkg);
  out.refd = gamma2 * (one - zemm) * zdend;
  out.trad = zrk2 * zem1 * zdend;
  return out;
}

// Dynamic shared memory of one block for a chunk of gc g-points: the chunk's
// layer properties [5][L][gc], rup and rupd [2][L+1][gc], and the per-warp
// partial g-sums [L+1][3][ceil(gc/32)]. sw_flux_smem_bytes in
// physics/rrtmg_sw.py computes the same.
template <typename T>
size_t smem_bytes(int L, int gc) {
  const size_t sweep_warps = (gc + 31) / 32;
  return sizeof(T) * ((5 * static_cast<size_t>(L) + 2 * static_cast<size_t>(L + 1)) * gc +
                      3 * static_cast<size_t>(L + 1) * sweep_warps);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// grid: one block per column; block: `threads` (a multiple of 32, >= gc)
// threads; dynamic shared memory: smem_bytes<T>(L, gc).
template <typename T, bool kCloudy>
__global__ void __launch_bounds__(kMaxThreads) sw_flux_kernel(
    const T* __restrict__ tau, const T* __restrict__ w0, const T* __restrict__ asy,
    const T* __restrict__ tau_o, const T* __restrict__ w0_o,
    const T* __restrict__ asy_o, const T* __restrict__ cf,
    const T* __restrict__ mu0, const T* __restrict__ alb_dir,
    const T* __restrict__ alb_dif, const T* __restrict__ zinc,
    T* __restrict__ swd, T* __restrict__ swu, T* __restrict__ dird,
    int L, int G, int gc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_prop = reinterpret_cast<T*>(smem_raw);  // [5][L][w]
  T* s_rup = s_prop + 5 * L * gc;              // [L+1][w]
  T* s_rupd = s_rup + (L + 1) * gc;            // [L+1][w]
  T* s_part = s_rupd + (L + 1) * gc;           // [L+1][3][sweep_warps]
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int sweep_warps = (gc + 31) >> 5;
  const int b = blockIdx.x;
  const T mu = mu0[b];
  const size_t col = static_cast<size_t>(b) * L * G;
  const size_t out0 = static_cast<size_t>(b) * (L + 1);

  // thread t <= L sums level t over the chunks
  T acc_d = T(0), acc_u = T(0), acc_b = T(0);

  for (int g0 = 0; g0 < G; g0 += gc) {
    const int w = min(gc, G - g0);
    const int n = L * w;

    // ---- phase 1: every layer's properties, once, on every thread ----
    // Item i is (l, g) = (i / w, i % w) at x[b, l, g0 + g]; a step of nt
    // items moves dx elements and dg g-points, one row more on a wrap.
    int g = t % w;
    size_t x = col + static_cast<size_t>(t / w) * G + g0 + g;
    const int dg = nt % w;
    const size_t dx = static_cast<size_t>(nt / w) * G + dg;
    // not unrolled: by 2 it spilled at float64 and ran 3% slower at float32
#pragma unroll 1
    for (int i = t; i < n; i += nt) {
      Layer<T> p = layer_properties(tau[x], w0[x], asy[x], mu);
      if (kCloudy) {
        const Layer<T> o = layer_properties(tau_o[x], w0_o[x], asy_o[x], mu);
        const T c = cf[x];
        const T cc = T(1) - c;
        p.ref = cc * p.ref + c * o.ref;
        p.refd = cc * p.refd + c * o.refd;
        p.tra = cc * p.tra + c * o.tra;
        p.trad = cc * p.trad + c * o.trad;
        p.dbt = cc * p.dbt + c * o.dbt;
      }
      s_prop[i] = p.ref;
      s_prop[n + i] = p.refd;
      s_prop[2 * n + i] = p.tra;
      s_prop[3 * n + i] = p.trad;
      s_prop[4 * n + i] = p.dbt;
      x += dx;
      g += dg;
      if (g >= w) {
        g -= w;
        x += G - w;
      }
    }
    __syncthreads();

    if (warp < sweep_warps) {
      const bool active = t < w;
      const size_t bg = static_cast<size_t>(b) * G + g0 + t;
      const T* s_ref = s_prop;
      const T* s_refd = s_prop + n;
      const T* s_tra = s_prop + 2 * n;
      const T* s_trad = s_prop + 3 * n;
      const T* s_dbt = s_prop + 4 * n;

      // ---- up sweep (surface -> top): rup, rupd per level ----
      if (active) {
        T rup = alb_dir[bg], rupd = alb_dif[bg];
        s_rup[L * w + t] = rup;
        s_rupd[L * w + t] = rupd;
        for (int l = L - 1; l >= 0; --l) {
          const int j = l * w + t;
          const T ref = s_ref[j], refd = s_refd[j], tra = s_tra[j];
          const T trad = s_trad[j], dbt = s_dbt[j];
          const T reflect = T(1) / (T(1) - rupd * refd);
          const T rup_new = ref + (trad * ((tra - dbt) * rupd + dbt * rup)) * reflect;
          rupd = refd + trad * trad * rupd * reflect;
          rup = rup_new;
          s_rup[j] = rup;
          s_rupd[j] = rupd;
        }
      }

      // ---- down sweep (top -> surface) with the flux combine per level ----
      // Lanes past the chunk's width add zeros to the warp sums.
      const T z = active ? zinc[bg] : T(0);
      T tdn = T(1), rdnd = T(0), tdb = T(1);
      for (int l = 0;; ++l) {
        T vd = T(0), vu = T(0), vb = T(0);
        if (active) {
          const T rup = s_rup[l * w + t], rupd = s_rupd[l * w + t];
          const T reflect = T(1) / (T(1) - rdnd * rupd);
          vu = z * ((tdb * rup + (tdn - tdb) * rupd) * reflect);
          vd = z * (tdb + (tdn - tdb + tdb * rup * rdnd) * reflect);
          vb = z * tdb;
        }
        vd = warp_sum(vd);
        vu = warp_sum(vu);
        vb = warp_sum(vb);
        if (lane == 0) {
          s_part[(l * 3 + 0) * sweep_warps + warp] = vd;
          s_part[(l * 3 + 1) * sweep_warps + warp] = vu;
          s_part[(l * 3 + 2) * sweep_warps + warp] = vb;
        }
        if (l == L) break;
        if (active) {
          const int j = l * w + t;
          const T ref = s_ref[j], refd = s_refd[j], tra = s_tra[j];
          const T trad = s_trad[j], dbt = s_dbt[j];
          const T reflect = T(1) / (T(1) - refd * rdnd);
          const T tdn_new = tdb * tra + (trad * ((tdn - tdb) + tdb * ref * rdnd)) * reflect;
          rdnd = refd + trad * trad * rdnd * reflect;
          tdn = tdn_new;
          tdb = tdb * dbt;
        }
      }
    }
    __syncthreads();

    // Thread t owns levels t, t + nt, ...: it sums level t over the chunks
    // in registers (summing it in the outputs, a read-modify-write per
    // chunk, cost 2-5% on the cloudy main-path shapes) and the levels past
    // nt (L >= nt only) in their outputs, the first chunk adding to zero.
    // Only thread t touches its levels, so the sums over chunks need no
    // barrier, and both are deterministic.
    for (int lv = t; lv <= L; lv += nt) {
      T sd = T(0), su = T(0), sb = T(0);
      for (int k = 0; k < sweep_warps; ++k) {
        sd += s_part[(lv * 3 + 0) * sweep_warps + k];
        su += s_part[(lv * 3 + 1) * sweep_warps + k];
        sb += s_part[(lv * 3 + 2) * sweep_warps + k];
      }
      if (lv == t) {
        acc_d += sd;
        acc_u += su;
        acc_b += sb;
        continue;
      }
      const size_t o = out0 + lv;
      const bool first_chunk = g0 == 0;
      swd[o] = (first_chunk ? T(0) : swd[o]) + sd;
      swu[o] = (first_chunk ? T(0) : swu[o]) + su;
      dird[o] = (first_chunk ? T(0) : dird[o]) + sb;
    }
    // The next chunk overwrites s_part only after the barrier that ends its
    // phase 1, so this read needs no barrier of its own.
  }

  if (t <= L) {
    swd[out0 + t] = acc_d;
    swu[out0 + t] = acc_u;
    dird[out0 + t] = acc_b;
  }
}

template <typename T>
auto kernel_of(bool cloudy) {
  return cloudy ? sw_flux_kernel<T, true> : sw_flux_kernel<T, false>;
}

// The launch plan's checks; 0 or cudaErrorInvalidValue.
template <typename T>
int check_plan(int L, int G, int threads, int chunks, int smem) {
  if (L < 1 || G < 1) return cudaErrorInvalidValue;
  if (chunks < 1 || chunks > G) return cudaErrorInvalidValue;
  const int gc = (G + chunks - 1) / chunks;
  if ((chunks - 1) * gc >= G) return cudaErrorInvalidValue;  // an empty chunk
  if (threads % 32 != 0 || threads < gc || threads > kMaxThreads)
    return cudaErrorInvalidValue;
  if (smem < 0 || static_cast<size_t>(smem) != smem_bytes<T>(L, gc) || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
int launch(const T* tau, const T* w0, const T* asy, const T* tau_o, const T* w0_o,
           const T* asy_o, const T* cf, const T* mu0, const T* alb_dir,
           const T* alb_dif, const T* zinc, T* swd, T* swu, T* dird,
           int B, int L, int G, int threads, int chunks, int smem,
           cudaStream_t stream) {
  if (B < 1) return cudaErrorInvalidValue;
  if (int err = check_plan<T>(L, G, threads, chunks, smem)) return err;
  const bool cloudy = tau_o != nullptr;
  if (cloudy && (w0_o == nullptr || asy_o == nullptr || cf == nullptr))
    return cudaErrorInvalidValue;
  const int gc = (G + chunks - 1) / chunks;
  auto kernel = kernel_of<T>(cloudy);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(tau, w0, asy, tau_o, w0_o, asy_o, cf, mu0,
                                       alb_dir, alb_dif, zinc, swd, swu, dird,
                                       L, G, gc);
  return cudaGetLastError();
}

template <typename T>
int blocks_per_sm(bool cloudy, int L, int G, int threads, int chunks, int smem,
                  int* blocks) {
  if (int err = check_plan<T>(L, G, threads, chunks, smem)) return err;
  auto kernel = kernel_of<T>(cloudy);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

}  // namespace

extern "C" {

int sw_flux_f32(const float* tau, const float* w0, const float* asy,
                const float* tau_o, const float* w0_o, const float* asy_o,
                const float* cf, const float* mu0, const float* alb_dir,
                const float* alb_dif, const float* zinc, float* swd, float* swu,
                float* dird, int B, int L, int G, int threads, int chunks,
                int smem, void* stream) {
  return launch<float>(tau, w0, asy, tau_o, w0_o, asy_o, cf, mu0, alb_dir, alb_dif,
                       zinc, swd, swu, dird, B, L, G, threads, chunks, smem,
                       static_cast<cudaStream_t>(stream));
}

int sw_flux_f64(const double* tau, const double* w0, const double* asy,
                const double* tau_o, const double* w0_o, const double* asy_o,
                const double* cf, const double* mu0, const double* alb_dir,
                const double* alb_dif, const double* zinc, double* swd,
                double* swu, double* dird, int B, int L, int G, int threads,
                int chunks, int smem, void* stream) {
  return launch<double>(tau, w0, asy, tau_o, w0_o, asy_o, cf, mu0, alb_dir, alb_dif,
                        zinc, swd, swu, dird, B, L, G, threads, chunks, smem,
                        static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the plan (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// into *blocks; returns a cudaError_t as int.
int sw_flux_blocks_per_sm(int f64, int cloudy, int L, int G, int threads, int chunks,
                          int smem, int* blocks) {
  return f64 ? blocks_per_sm<double>(cloudy != 0, L, G, threads, chunks, smem, blocks)
             : blocks_per_sm<float>(cloudy != 0, L, G, threads, chunks, smem, blocks);
}

const char* sw_flux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
