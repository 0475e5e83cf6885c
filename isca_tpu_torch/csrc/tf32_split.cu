// TF32 operand split of the spherical transforms' products, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. isca_tpu leaves its transform products to XLA
// with a jax.lax.Precision (isca_tpu/spectral/transforms.py:161, the `prec`
// property), and XLA splits the operands of a "high" (bf16_3x) product
// inside the dot. The port computes "high" as 3xTF32 and "default" as one
// TF32 pass on cuBLAS (spectral/precision.py), with operands rounded to TF32
// beforehand so the tensor cores see values they represent exactly. This
// kernel rounds the data operand in one launch: for each x it writes
// hi = round_to_tf32(x) and, at "high", hi again and
// lo = round_to_tf32(x - hi), as [hi | hi | lo] along the contracted axis,
// the layout that turns the three products into one product three times as
// deep. The constant tables are split once, on the host. The plain PyTorch
// version is split_reference in spectral/precision.py.
//
// What bounds it on an H100: bytes. Each element is read once (4 bytes) and
// written `parts` times (4 or 12 bytes), against a few integer operations.
// Design: a 2D grid, y over the rows before the axis (`outer`), x over the
// elements of a row (`inner`, the axis and what follows it), both
// grid-strided, so consecutive threads read and write consecutive addresses
// and no thread divides an index.
//
// Rounding: to nearest, ties to even, on the 13 low mantissa bits, by
// integer arithmetic on the bits (as round_to_tf32 in precision.py); inf and
// NaN pass unchanged; a value that rounds past the largest float becomes inf.
//
// C interface (ctypes): tf32_split_f32 returns a cudaError_t as int.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;
constexpr long long kMaxGridX = 4096;

__device__ __forceinline__ float tf32_round(float x) {
  unsigned int u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u) return x;  // inf, NaN
  u += 0xfffu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xffffe000u);
}

// x: (outer, inner); out: (outer, parts, inner), parts 1 (hi) or 3 (hi, hi, lo).
__global__ void __launch_bounds__(kThreads) tf32_split_kernel(
    const float* __restrict__ x, float* __restrict__ out, long long outer,
    long long inner, int parts) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long o = blockIdx.y; o < outer; o += gridDim.y) {
    const float* src = x + o * inner;
    float* dst = out + o * parts * inner;
    for (long long i = first; i < inner; i += stride) {
      const float v = src[i];
      const float hi = tf32_round(v);
      dst[i] = hi;
      if (parts == 3) {
        dst[inner + i] = hi;
        dst[2 * inner + i] = tf32_round(v - hi);
      }
    }
  }
}

}  // namespace

extern "C" {

int tf32_split_f32(const float* x, float* out, long long outer, long long inner,
                   int parts, void* stream) {
  if (outer < 1 || inner < 1 || (parts != 1 && parts != 3)) return cudaErrorInvalidValue;
  const long long bx = (inner + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned int>(bx < kMaxGridX ? bx : kMaxGridX),
                  static_cast<unsigned int>(outer < kMaxGridY ? outer : kMaxGridY));
  tf32_split_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, outer, inner, parts);
  return cudaGetLastError();
}

const char* tf32_split_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
