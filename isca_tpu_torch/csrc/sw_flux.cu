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
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s FP32): memory. The clear variant
// must read tau, w0 and g once, 3 x B*L*G*4 bytes, about 275 MB at T42L25
// (B = 8192, L = 25, G = 112), about 82 us; the cloudy variant reads seven
// such arrays, about 640 MB, about 190 us. The arithmetic is about 2 GFLOP of
// FP32 with a handful of exp/sqrt/div per element.
//
// Design:
//  * One block per column, one thread per g-point (G = 112 padded to 128).
//    Thread g reads x[b, l, g], so each warp's loads are contiguous along G,
//    and every input byte comes from device memory once per sweep.
//  * The recurrences over levels are serial per (b, g) and independent across
//    them, so each thread keeps its carries in registers. The down sweep runs
//    first and keeps only tdn, rdnd and the cumulative direct beam per level
//    in shared memory (3*(L+1) values per thread, laid out [level][thread] so
//    the accesses are free of bank conflicts); the up sweep then recomputes
//    the layer properties from tau/w0/g (a second read that the 50 MB L2
//    mostly serves, since a block's column is 3*L*G*4 = 34 KB) instead of
//    storing five more arrays, and combines the fluxes level by level.
//  * The g-sum at each level is a warp shuffle into per-warp partials in
//    shared memory; one barrier at the end, then one thread per level adds
//    the warps' partials and writes the three outputs, coalesced along L+1.
//  * Built with --fmad=false so each multiply and add rounds as the plain
//    PyTorch version's separate elementwise kernels do.
//
// C interface (ctypes): sw_flux_f32 / sw_flux_f64 return a cudaError_t as
// int; the cloud pointers are null for the clear variant.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 64;    // SW_FLUX_MAX_L in physics/rrtmg_sw.py
constexpr int kMaxG = 128;   // SW_FLUX_MAX_G

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

template <typename T, bool kCloudy>
__device__ __forceinline__ Layer<T> column_layer(
    const T* __restrict__ tau, const T* __restrict__ w0, const T* __restrict__ asy,
    const T* __restrict__ tau_o, const T* __restrict__ w0_o,
    const T* __restrict__ asy_o, const T* __restrict__ cf, size_t i, T mu0) {
  Layer<T> p = layer_properties(tau[i], w0[i], asy[i], mu0);
  if (kCloudy) {
    const Layer<T> o = layer_properties(tau_o[i], w0_o[i], asy_o[i], mu0);
    const T c = cf[i];
    const T cc = T(1) - c;
    p.ref = cc * p.ref + c * o.ref;
    p.refd = cc * p.refd + c * o.refd;
    p.tra = cc * p.tra + c * o.tra;
    p.trad = cc * p.trad + c * o.trad;
    p.dbt = cc * p.dbt + c * o.dbt;
  }
  return p;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// grid: one block per column; block: G rounded up to a multiple of 32.
// Dynamic shared memory: 3*(L+1)*blockDim + 3*(L+1)*nwarps values of T.
template <typename T, bool kCloudy>
__global__ void __launch_bounds__(kMaxG) sw_flux_kernel(
    const T* __restrict__ tau, const T* __restrict__ w0, const T* __restrict__ asy,
    const T* __restrict__ tau_o, const T* __restrict__ w0_o,
    const T* __restrict__ asy_o, const T* __restrict__ cf,
    const T* __restrict__ mu0, const T* __restrict__ alb_dir,
    const T* __restrict__ alb_dif, const T* __restrict__ zinc,
    T* __restrict__ swd, T* __restrict__ swu, T* __restrict__ dird, int L, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nt = blockDim.x;
  const int nwarps = nt >> 5;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const bool active = t < G;

  T* s_tdn = smem;                       // [L+1][nt]
  T* s_rdnd = s_tdn + (L + 1) * nt;      // [L+1][nt]
  T* s_tdb = s_rdnd + (L + 1) * nt;      // [L+1][nt]
  T* s_red = s_tdb + (L + 1) * nt;       // [L+1][3][nwarps]

  const T mu = mu0[b];
  const size_t col = static_cast<size_t>(b) * L * G + t;
  // Threads past G carry a transparent dummy layer and zero weight.
  auto layer = [&](int l) -> Layer<T> {
    if (!active) return Layer<T>{T(0), T(0), T(1), T(1), T(1)};
    return column_layer<T, kCloudy>(tau, w0, asy, tau_o, w0_o, asy_o, cf,
                                    col + static_cast<size_t>(l) * G, mu);
  };

  // ---- down sweep (top -> surface): tdn, rdnd, cumulative direct beam ----
  T tdn = T(1), rdnd = T(0), tdb = T(1);
  s_tdn[t] = tdn;
  s_rdnd[t] = rdnd;
  s_tdb[t] = tdb;
  for (int l = 0; l < L; ++l) {
    const Layer<T> p = layer(l);
    const T reflect = T(1) / (T(1) - p.refd * rdnd);
    const T tdn_new = tdb * p.tra + (p.trad * ((tdn - tdb) + tdb * p.ref * rdnd)) * reflect;
    rdnd = p.refd + p.trad * p.trad * rdnd * reflect;
    tdn = tdn_new;
    tdb = tdb * p.dbt;
    s_tdn[(l + 1) * nt + t] = tdn;
    s_rdnd[(l + 1) * nt + t] = rdnd;
    s_tdb[(l + 1) * nt + t] = tdb;
  }

  // ---- up sweep (surface -> top) with the flux combine at each level ----
  const size_t bg = static_cast<size_t>(b) * G + t;
  const T z = active ? zinc[bg] : T(0);
  T rup = active ? alb_dir[bg] : T(0);
  T rupd = active ? alb_dif[bg] : T(0);
  for (int l = L;; --l) {
    if (l < L) {
      const Layer<T> p = layer(l);
      const T reflect = T(1) / (T(1) - rupd * p.refd);
      const T rup_new = p.ref + (p.trad * ((p.tra - p.dbt) * rupd + p.dbt * rup)) * reflect;
      rupd = p.refd + p.trad * p.trad * rupd * reflect;
      rup = rup_new;
    }
    const T dn = s_tdn[l * nt + t];
    const T rd = s_rdnd[l * nt + t];
    const T db = s_tdb[l * nt + t];
    const T reflect = T(1) / (T(1) - rd * rupd);
    const T fu = (db * rup + (dn - db) * rupd) * reflect;
    const T fd = db + (dn - db + db * rup * rd) * reflect;
    const T sd = warp_sum(z * fd);
    const T su = warp_sum(z * fu);
    const T sb = warp_sum(z * db);
    if (lane == 0) {
      s_red[(l * 3 + 0) * nwarps + warp] = sd;
      s_red[(l * 3 + 1) * nwarps + warp] = su;
      s_red[(l * 3 + 2) * nwarps + warp] = sb;
    }
    if (l == 0) break;
  }
  __syncthreads();

  for (int l = t; l <= L; l += nt) {
    T sd = T(0), su = T(0), sb = T(0);
    for (int w = 0; w < nwarps; ++w) {
      sd += s_red[(l * 3 + 0) * nwarps + w];
      su += s_red[(l * 3 + 1) * nwarps + w];
      sb += s_red[(l * 3 + 2) * nwarps + w];
    }
    const size_t o = static_cast<size_t>(b) * (L + 1) + l;
    swd[o] = sd;
    swu[o] = su;
    dird[o] = sb;
  }
}

template <typename T>
int launch(const T* tau, const T* w0, const T* asy, const T* tau_o, const T* w0_o,
           const T* asy_o, const T* cf, const T* mu0, const T* alb_dir,
           const T* alb_dif, const T* zinc, T* swd, T* swu, T* dird,
           int B, int L, int G, cudaStream_t stream) {
  if (B < 1 || L < 1 || L > kMaxL || G < 1 || G > kMaxG) return cudaErrorInvalidValue;
  const bool cloudy = tau_o != nullptr;
  if (cloudy && (w0_o == nullptr || asy_o == nullptr || cf == nullptr))
    return cudaErrorInvalidValue;
  const int threads = (G + 31) / 32 * 32;
  const int nwarps = threads / 32;
  const size_t smem = (3 * static_cast<size_t>(L + 1) * threads +
                       3 * static_cast<size_t>(L + 1) * nwarps) * sizeof(T);
  auto kernel = cloudy ? sw_flux_kernel<T, true> : sw_flux_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(tau, w0, asy, tau_o, w0_o, asy_o, cf, mu0,
                                       alb_dir, alb_dif, zinc, swd, swu, dird, L, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sw_flux_f32(const float* tau, const float* w0, const float* asy,
                const float* tau_o, const float* w0_o, const float* asy_o,
                const float* cf, const float* mu0, const float* alb_dir,
                const float* alb_dif, const float* zinc, float* swd, float* swu,
                float* dird, int B, int L, int G, void* stream) {
  return launch<float>(tau, w0, asy, tau_o, w0_o, asy_o, cf, mu0, alb_dir, alb_dif,
                       zinc, swd, swu, dird, B, L, G,
                       static_cast<cudaStream_t>(stream));
}

int sw_flux_f64(const double* tau, const double* w0, const double* asy,
                const double* tau_o, const double* w0_o, const double* asy_o,
                const double* cf, const double* mu0, const double* alb_dir,
                const double* alb_dif, const double* zinc, double* swd,
                double* swu, double* dird, int B, int L, int G, void* stream) {
  return launch<double>(tau, w0, asy, tau_o, w0_o, asy_o, cf, mu0, alb_dir, alb_dif,
                        zinc, swd, swu, dird, B, L, G,
                        static_cast<cudaStream_t>(stream));
}

const char* sw_flux_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
