// Four cascaded one-pole recurrences y[n] = x[n] + a*y[n-1] along each row,
// the gammatone denominator 1/(1 - a z^-1)^4, with a per-row pole `a`.
//
// Replaces: nelegan_tpu/ops/pallas_scan.py, `gammatone_cascade_pallas` and
// its body `_cascade_kernel` (pallas_scan.py:37-104), vmapped over rows.
// The TPU kernel turns each 128-sample block into a Toeplitz matmul for
// the TPU's matrix unit; this port does not carry that over: TF32's 10-bit
// mantissa cannot hold the 2e-5 bar where the DC gain is ~1.5e8 (a = 0.991).
//
// What bounds it on an H100: memory.  [64, 36000] float32 in and out is
// 18.4 MB, about 5.5 us at 3.35 TB/s; the 8 flops per sample are far below
// the card's float32 rate.  A thread per row would pay the whole chain of
// n samples x 4 dependent FMAs on two warps.  This design is a chunked
// scan instead, one block of 1024 threads per row:
//   * the row streams into shared memory with cp.async (16 bytes a thread
//     where the row is 16-byte aligned, else 4), all of it in flight at
//     once; rows longer than one segment (54272 samples, 212 KB) are taken
//     segment by segment with the carry passed on, so no length is refused;
//   * the cascade is linear, so a chunk of L samples maps its incoming
//     4-stage carry as carry_out = F_L carry_in + z, with F_L the
//     lower-triangular Toeplitz zero-input transition (the same for every
//     chunk of a segment) and z the chunk's end state from zero;
//   * pass 1: thread c runs chunk c from zero and keeps z.  L is odd, so the
//     threads of a warp, reading smem[c*L + j], hit 32 different banks;
//   * carries: thread 0 computes F_L by L zero-input steps from a unit
//     state (while the loads are in flight) and squares it nine times; a
//     log-depth scan over the chunks' z (shuffles within a warp, then one
//     warp over the warp totals, then the warp scan once more from each
//     warp's true carry) gives every chunk its carry_in;
//   * pass 2: thread c reruns its chunk from carry_in and writes y over x
//     in shared memory; the block stores the segment out coalesced.
// 64 rows use 64 of the 132 SMs; a cluster per row would use the rest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSegment = kThreads * 53;      // samples per segment, L <= 53
constexpr int kPowers = 10;                  // F_L^(2^e), e < 10
constexpr unsigned kFull = 0xffffffffu;

// A 4-stage state, or the first column of a lower-triangular Toeplitz 4x4
// matrix (the cascade's transitions are such matrices).
struct S4 {
  float s0, s1, s2, s3;
};

__device__ __forceinline__ void step(S4& c, float x, float a) {
  c.s0 = x + a * c.s0;
  c.s1 = c.s0 + a * c.s1;
  c.s2 = c.s1 + a * c.s2;
  c.s3 = c.s2 + a * c.s3;
}

// F x + z, F given by its first column f.  With x the first column of G,
// F x is the first column of the product F G.
__device__ __forceinline__ S4 apply_add(const S4& f, const S4& x, const S4& z) {
  S4 y;
  y.s0 = z.s0 + f.s0 * x.s0;
  y.s1 = z.s1 + (f.s1 * x.s0 + f.s0 * x.s1);
  y.s2 = z.s2 + (f.s2 * x.s0 + f.s1 * x.s1 + f.s0 * x.s2);
  y.s3 = z.s3 + (f.s3 * x.s0 + f.s2 * x.s1 + f.s1 * x.s2 + f.s0 * x.s3);
  return y;
}

__device__ __forceinline__ S4 shfl_up(const S4& v, int d) {
  return S4{__shfl_up_sync(kFull, v.s0, d), __shfl_up_sync(kFull, v.s1, d),
            __shfl_up_sync(kFull, v.s2, d), __shfl_up_sync(kFull, v.s3, d)};
}

// Inclusive scan over the 32 lanes of w_i = F w_(i-1) + v_i, F = pw[0]:
// Hillis-Steele, w_i += F^(2^d) w_(i-2^d) with pw[d] = F^(2^d).
__device__ __forceinline__ S4 warp_scan(S4 v, const S4* pw, int lane) {
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const S4 o = shfl_up(v, 1 << d);
    if (lane >= (1 << d)) v = apply_add(pw[d], o, v);
  }
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__global__ void __launch_bounds__(kThreads, 1)
    gammatone_cascade_kernel(const float* __restrict__ x,
                             const float* __restrict__ a,
                             float* __restrict__ y, int n, int vec) {
  extern __shared__ __align__(16) float sm[];    // [cap4] samples, then:
  const int cap4 = (min(n, kSegment) + 3) & ~3;
  S4* pw = reinterpret_cast<S4*>(sm + cap4);     // [kPowers] F_L^(2^e)
  S4* wt = pw + kPowers;                         // [kWarps] totals, carries
  S4* seg = wt + kWarps;                         // carry into the segment
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float ar = a[blockIdx.x];
  const float* xr = x + (size_t)blockIdx.x * n;
  float* yr = y + (size_t)blockIdx.x * n;
  if (tid == 0) *seg = S4{0.f, 0.f, 0.f, 0.f};

  for (int s0 = 0; s0 < n; s0 += kSegment) {
    const int len = min(kSegment, n - s0);
    if (vec) {                                   // len % 4 == 0 here
      for (int i = 4 * tid; i < len; i += 4 * kThreads)
        cp_async16(sm + i, xr + s0 + i);
    } else {
      for (int i = tid; i < len; i += kThreads) cp_async4(sm + i, xr + s0 + i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const int L = ((len + kThreads - 1) / kThreads) | 1;   // odd chunk
    const int nch = (len + L - 1) / L;
    if (tid == 0) {                              // while the loads fly
      S4 f{1.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < L; ++i) step(f, 0.f, ar);
      pw[0] = f;
      for (int e = 1; e < kPowers; ++e)
        pw[e] = apply_add(pw[e - 1], pw[e - 1], S4{0.f, 0.f, 0.f, 0.f});
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // pass 1: each chunk from a zero state
    const int c0 = tid * L, c1 = min(c0 + L, len);
    S4 z{0.f, 0.f, 0.f, 0.f};
    for (int i = c0; i < c1; ++i) step(z, sm[i], ar);

    // carries: warp totals, then one warp over them, seeded with the
    // segment's carry (chunks past the last do no harm: nothing reads the
    // carries after it)
    const S4 w = warp_scan(z, pw, lane);
    if (lane == 31) wt[warp] = w;
    __syncthreads();
    if (warp == 0) {
      const S4 cs = *seg;
      S4 v = wt[lane];
      if (lane == 0) v = apply_add(pw[5], cs, v);   // F_L^32 = F_(32L)
      v = warp_scan(v, pw + 5, lane);
      S4 cw = shfl_up(v, 1);
      if (lane == 0) cw = cs;
      wt[lane] = cw;                             // carry into warp `lane`
    }
    __syncthreads();
    const S4 cw = wt[warp];
    S4 zz = z;
    if (lane == 0) zz = apply_add(pw[0], cw, z);
    const S4 out = warp_scan(zz, pw, lane);
    S4 c = shfl_up(out, 1);
    if (lane == 0) c = cw;

    // pass 2: each chunk from its true carry, y over x
    for (int i = c0; i < c1; ++i) {
      step(c, sm[i], ar);
      sm[i] = c.s3;
    }
    if (tid == nch - 1) *seg = c;                // the segment's end state
    __syncthreads();

    if (vec) {
      for (int i = 4 * tid; i < len; i += 4 * kThreads)
        *reinterpret_cast<float4*>(yr + s0 + i) =
            *reinterpret_cast<const float4*>(sm + i);
    } else {
      for (int i = tid; i < len; i += kThreads) yr[s0 + i] = sm[i];
    }
    __syncthreads();                             // before the next loads
  }
}

}  // namespace

// x, y: [rows, n] float32 contiguous; a: [rows] float32.
extern "C" int gammatone_cascade_f32(const float* x, const float* a, float* y,
                                     int rows, int n, void* stream) {
  if (rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return (int)cudaSuccess;
  const int cap4 = ((n < kSegment ? n : kSegment) + 3) & ~3;
  const size_t smem =
      (size_t)cap4 * sizeof(float) + (kPowers + kWarps + 1) * sizeof(S4);
  static bool attr_set = false;                  // the largest size, once
  if (!attr_set) {
    const int most = kSegment * (int)sizeof(float) +
                     (kPowers + kWarps + 1) * (int)sizeof(S4);
    const cudaError_t err = cudaFuncSetAttribute(
        gammatone_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0) &&
                  (n % 4 == 0);
  gammatone_cascade_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      x, a, y, n, vec);
  return (int)cudaGetLastError();
}
