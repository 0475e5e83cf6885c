// The spherical transforms' matrix products at "high" (3xTF32) and "default"
// (one TF32 pass) on the tensor cores, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. isca_tpu leaves its transform products to XLA
// with a jax.lax.Precision (isca_tpu/spectral/transforms.py:161, the `prec`
// property), and XLA splits a "high" dot's operands inside the dot. This is
// the port's counterpart: one launch computes one DFT or Legendre product of
// spectral/transforms.py,
//   "high":    x.T = x_hi.T_hi + (x_hi.T_lo + x_lo.T_hi)
//   "default": x.T = x_hi.T_hi
// with hi = round_to_tf32(x) and lo = round_to_tf32(x - hi). The data
// operand x is split in registers as it is loaded; the constant table T was
// split once, when the transforms were built (spectral/precision.py,
// pack_table). The plain PyTorch version is product_reference there: the
// same split, then exact FP32 products.
//
// What bounds it on an H100: the DFT products sit near the balance point of
// the card's 3.35 TB/s and 495 TFLOP/s TF32 (at T213L30 they are bound by the
// tensor cores: 3 x 2 x 28800 x 640 x 428 operations at "high"); the
// Legendre products are bound by bytes, mostly the tables' hi and lo blocks
// (8 bytes an entry). The design does three things about that:
// * x is read from device memory once, in its stored layout, through its
//   strides, and split in registers: no split or permuted copy of it is ever
//   written (the separate split pass this replaces wrote 12 bytes a value and
//   read them back). The table is read as hi and lo blocks, once each per
//   block, laid out as the tensor cores take them.
// * wgmma m64n64k8 TF32: one warpgroup a block, a 64-row tile of x against a
//   64-column tile of the table. A, the split x, comes from registers (32-bit
//   wgmma takes K-major operands only; the fragments are read out of a
//   staged tile in whatever order x is stored, which is where the Legendre
//   synthesis operand gets transposed). B, the table, comes from shared
//   memory, fed by a three-stage cp.async ring (x tiles with 4- or 16-byte
//   copies through the row offsets, table tiles with 16-byte copies).
// * The Legendre tables P and Pw are zero for n < m: a block skips the
//   column tiles (analysis) or the contraction tiles (synthesis) that lie
//   wholly below the first nonzero entry of its m (`nz`, from the table
//   itself). That changes the result only for a non-finite x there: the
//   plain version gives NaN (0 x inf, 0 x NaN) where the kernel gives 0.
// Measured on an H100 (PERF.md, utils/tf32_product_ablation.py): 4 to 7
// times the bound at the main path's shapes. The Legendre analysis spends
// half or more of its time loading x, the Legendre synthesis 40 to 55%
// storing its output: both walk m's (re, im) pairs, 8 bytes of each 32-byte
// sector. The DFT products at "high" spend a quarter to a third of theirs in
// the tensor cores, the rest mostly in loading x and the table, each re-read
// from L2 by every column or row tile.
//
// Sums: hi.hi and the two cross terms go to separate accumulators. The tensor
// cores' sums (which round toward zero) cover one stage of 32 terms of the
// contraction; each stage's partial sums are then added to FP32 totals in
// registers with round-to-nearest adds, and the two totals are added last.
//
// Rounding: to nearest, ties to even, on the 13 low mantissa bits, by integer
// arithmetic on the bits, as round_to_tf32 in precision.py; inf and NaN pass
// unchanged; a value that rounds past the largest float becomes inf. The
// tensor cores flush subnormal operands to zero.
//
// C interface (ctypes): tf32_product_f32 returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;            // rows of x and of the output per block: wgmma's M
constexpr int kBN = 64;            // table columns per block: wgmma's N
constexpr int kBK = 32;            // contraction per stage: the tensor cores' sums, then FP32
constexpr int kStages = 3;
constexpr int kThreads = 128;      // one warpgroup
constexpr int kXPitch = kBK + 4;   // floats a staged x row: conflict-free fragment reads
constexpr int kXTile = kBM * kXPitch;
constexpr int kBTile = kBK * kBN;  // floats of one table part per stage
constexpr int kStep = 8 * kBN;     // floats of one k8 step of a table tile
// The table tile of one k8 step is [column group of 8][K half][8 columns][4 k]:
// 8 x 16-byte core matrices, the two K halves 128 bytes apart (the leading
// byte offset), the column groups 256 bytes apart (the stride byte offset).
constexpr uint64_t kLBO = 128;
constexpr uint64_t kSBO = 256;
constexpr int kMaxGrid = 65535;

struct Params {
  const float* x;
  float* out;
  const float* table;
  const int* nz;
  long long rows;                           // B x I x R: row = (b I + i) R + r
  int I, R;
  long long sxb, sxi, sxr, sxk, sxg;        // x's strides: b, i, r, contraction, group
  long long sob, soi, sor, soc, sog;        // the output's: b, i, r, column, group
  int K, N, Kpad, Npad;
  int skip;   // 0 none; 1 column tiles below nz[g]; 2 contraction tiles below nz[g]
  int load;   // x tiles: 0 one value a thread along k, 1 along (k, r), 2 16-byte rows
};

__host__ __device__ constexpr int smem_bytes(int parts) {
  return (kStages * (parts * kBTile + kXTile)) * 4 + 2 * kBM * 8;
}

__device__ __forceinline__ float tf32_round(float x) {
  unsigned int u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return x;  // inf, NaN
  u += 0xfffu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xffffe000u);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// the staged tiles, written by cp.async, are read next by wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | ((kLBO >> 4) << 16) | ((kSBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the accumulators are final only after the wait: keep their reads after it
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// the split fragments are computed before the fence that precedes the
// products that read them, not sunk between those products
__device__ __forceinline__ void fence_operands(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[s][j]) :: "memory");
}

// d (+)= a . b over 8 of the contraction: a, a 64 x 8 TF32 fragment in
// registers; b, a 64-column x 8 K-major tile in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// grid: (column tiles, row tiles, groups). Table layout (floats):
// [group][part][k8 step (Kpad/8)][column group (Npad/8)][K half][8 columns][4 k],
// parts hi (and lo); zero beyond K and N.
template <int kParts>
__global__ void __launch_bounds__(kThreads) tf32_product_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sB = reinterpret_cast<float*>(smem);           // [stage][part][kBTile]
  float* sX = sB + kStages * kParts * kBTile;           // [stage][kBM][kXPitch]
  long long* rowx = reinterpret_cast<long long*>(sX + kStages * kXTile);
  long long* rowo = rowx + kBM;                         // -1: past the last row

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN;
  const long long row0 = static_cast<long long>(blockIdx.y) * kBM;
  const int g = blockIdx.z;
  const int nz = p.skip ? p.nz[g] : 0;

  if (tid < kBM) {
    const long long row = row0 + tid;
    long long bx = -1, bo = -1;
    if (row < p.rows) {
      const long long r = row % p.R, t = row / p.R;
      const long long i = t % p.I, b = t / p.I;
      bx = b * p.sxb + i * p.sxi + r * p.sxr + g * p.sxg;
      bo = b * p.sob + i * p.soi + r * p.sor + g * p.sog;
    }
    rowx[tid] = bx;
    rowo[tid] = bo;
  }
  __syncthreads();

  if (p.skip == 1 && n0 + kBN <= nz) {  // every column of the tile below the triangle
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int r = e / kBN, c = n0 + e % kBN;
      if (rowo[r] >= 0 && c < p.N) p.out[rowo[r] + c * p.soc] = 0.0f;
    }
    return;
  }
  const int nkt = p.Kpad / kBK;
  int kt0 = p.skip == 2 ? nz / kBK : 0;
  if (kt0 > nkt) kt0 = nkt;

  const long long steps = p.Kpad / 8, groups = p.Npad / 8;
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    float* xs = sX + stage * kXTile;
    if (p.load == 2) {  // K-contiguous rows, 16-byte aligned, K % 4 == 0
#pragma unroll
      for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
        const int c = tid + i * kThreads;   // 16-byte chunk: 8 a row
        const int r = c >> 3, kk = 4 * (c & 7), k = k0 + kk;
        const long long base = rowx[r];
        const bool ok = base >= 0 && k < p.K;
        cp_async16(xs + r * kXPitch + kk, ok ? p.x + base + k : p.x, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBM * kBK / kThreads; ++i) {
        const int e = tid + i * kThreads;
        // 1: neighbouring threads along (r, k), the Legendre operands' (k, 2)
        // pairs; 0: along k
        const int r = p.load == 1 ? 2 * (e >> 6) + (e & 1) : e / kBK;
        const int kk = p.load == 1 ? (e >> 1) & (kBK - 1) : e % kBK;
        const int k = k0 + kk;
        const long long base = rowx[r];
        const bool ok = base >= 0 && k < p.K;
        cp_async4(xs + r * kXPitch + kk, ok ? p.x + base + k * p.sxk : p.x, ok);
      }
    }
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const float* src = p.table + ((static_cast<long long>(g) * kParts + part) * steps
                                    + kt * (kBK / 8)) * groups * 64 + (n0 / 8) * 64;
      float* dst = sB + (stage * kParts + part) * kBTile;
#pragma unroll
      for (int i = 0; i < kBTile / 4 / kThreads; ++i) {
        const int c = tid + i * kThreads;   // 16-byte chunk: k8 step c / 128
        const int s = c / (kStep / 4), w = c % (kStep / 4);
        cp_async16(dst + s * kStep + 4 * w, src + s * groups * 64 + 4 * w, true);
      }
    }
  };

  float tot_hh[32], tot_x[32], acc_hh[32], acc_x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot_hh[i] = tot_x[i] = acc_hh[i] = acc_x[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (kt0 + s < nkt) load_tile(s, kt0 + s);
    cp_async_commit();
  }
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = 16 * warp + gq;   // this thread's fragment rows: ra and ra + 8
  for (int kt = kt0; kt < nkt; ++kt) {
    const int stage = (kt - kt0) % kStages;
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kt + kStages - 1 < nkt) load_tile((kt + kStages - 1 - kt0) % kStages, kt + kStages - 1);
    cp_async_commit();

    // the x fragments of the stage's 4 k8 steps, split in registers:
    // (ra, k), (ra + 8, k), (ra, k + 4), (ra + 8, k + 4), k = 8 s + tq
    const float* xs = sX + stage * kXTile;
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = xs[(ra + 8 * (j & 1)) * kXPitch + 8 * s + tq + 4 * (j >> 1)];
        const float hi = tf32_round(v);
        ahi[s][j] = __float_as_uint(hi);
        alo[s][j] = kParts == 2 ? __float_as_uint(tf32_round(v - hi)) : 0u;
      }
    }
    fence_operands(ahi);
    if (kParts == 2) fence_operands(alo);
    const float* bs = sB + stage * kParts * kBTile;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_tf32(acc_hh, ahi[s], smem_desc(bs + s * kStep), s);
    if (kParts == 2) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wgmma_tf32(acc_x, ahi[s], smem_desc(bs + kBTile + s * kStep), s);
        wgmma_tf32(acc_x, alo[s], smem_desc(bs + s * kStep), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc_hh);
    if (kParts == 2) fence_operands(acc_x);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      tot_hh[i] += acc_hh[i];
      if (kParts == 2) tot_x[i] += acc_x[i];
    }
  }

  // accumulator i: row ra + 8 ((i / 2) % 2), column 8 (i / 4) + 2 tq + i % 2
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const long long base = rowo[ra + 8 * ((i >> 1) & 1)];
    const int c = n0 + 8 * (i >> 2) + 2 * tq + (i & 1);
    if (base >= 0 && c < p.N)
      p.out[base + c * p.soc] = kParts == 2 ? tot_hh[i] + tot_x[i] : tot_hh[i];
  }
}

constexpr int kMaxDevices = 64;

template <int kParts>
cudaError_t launch(const Params& p, int G, cudaStream_t stream) {
  const int smem = smem_bytes(kParts);
  static bool allowed[kMaxDevices];   // the shared-memory limit raised, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(tf32_product_kernel<kParts>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  const dim3 grid(static_cast<unsigned int>(p.Npad / kBN),
                  static_cast<unsigned int>((p.rows + kBM - 1) / kBM),
                  static_cast<unsigned int>(G));
  tf32_product_kernel<kParts><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan's constants, for the wrapper to check its own against:
// {rows, columns and contraction of a block tile, stages, threads, shared
// memory bytes at 1 part, at 2 parts}.
void tf32_product_plan(int* out) {
  const int v[7] = {kBM, kBN, kBK, kStages, kThreads, smem_bytes(1), smem_bytes(2)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// strides: {sxb, sxi, sxr, sxk, sxg, sob, soi, sor, soc, sog}, in floats.
int tf32_product_f32(const float* x, float* out, const float* table, const int* nz,
                     long long rows, int I, int R, const long long* strides, int K, int N,
                     int Kpad, int Npad, int G, int parts, int skip, int load,
                     int smem, void* stream) {
  if (!x || !out || !table || rows < 1 || I < 1 || (R != 1 && R != 2) || K < 1 || N < 1
      || Kpad < K || Kpad % kBK || Npad < N || Npad % kBN || G < 1 || G > kMaxGrid
      || (rows + kBM - 1) / kBM > kMaxGrid || (parts != 1 && parts != 2)
      || skip < 0 || skip > 2 || (skip && !nz) || load < 0 || load > 2
      || smem != smem_bytes(parts))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 10; ++i)
    if (strides[i] < 0) return cudaErrorInvalidValue;
  const Params p{x, out, table, nz, rows, I, R,
                 strides[0], strides[1], strides[2], strides[3], strides[4],
                 strides[5], strides[6], strides[7], strides[8], strides[9],
                 K, N, Kpad, Npad, skip, load};
  if (load == 2 && (reinterpret_cast<uintptr_t>(x) % 16 || p.sxk != 1 || K % 4
                    || p.sxb % 4 || p.sxi % 4 || p.sxr % 4 || p.sxg % 4))
    return cudaErrorInvalidValue;
  if (load == 1 && R != 2) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return parts == 2 ? launch<2>(p, G, s) : launch<1>(p, G, s);
}

const char* tf32_product_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
