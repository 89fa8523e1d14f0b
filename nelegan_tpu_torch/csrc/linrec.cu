// First-order linear recurrence y[n] = a[n] * y[n-1] + b[n] along each row
// of [rows, n], from an initial state y[-1] per row (0 when none is given).
// `a` is given per step ([rows, n]) or once per row ([rows]); rows are real
// float32 or complex64 (interleaved re, im).
//
// Replaces: nelegan_tpu/ops/iir.py, the `jax.lax.associative_scan`s of
// `one_pole` (iir.py:38), of the block carries of `one_pole_blocked`
// (iir.py:83) and of `linear_recurrence_2x2` (iir.py:240, which the port
// runs as two complex one-poles of its constant matrix's eigenvalues); the
// next metric (PESQ's short-term gain memory, metrics/pesq.py:211) is the
// same scan.  Torch has no associative scan, and a loop over samples in
// Python costs a launch a sample.
//
// What bounds it on an H100: memory.  [32, 55296] float32 is 7.1 MB of b
// in and 7.1 MB of y out, about 4.2 us at 3.35 TB/s; the scan's 2-8 flops
// a sample are far below the card's float32 rate.  A thread per row would
// pay the whole chain of n dependent multiply-adds on one warp.  This
// design is the chunked scan of csrc/cascade.cu, one block of 1024 threads
// per row:
//   * the row streams into shared memory, a segment at a time (b, and a
//     when it is per step), so no length is refused; the carry passes from
//     one segment to the next;
//   * a chunk of L samples maps its incoming state affinely,
//     y_out = A y_in + z with A the product of its a and z its end state
//     from zero.  Pass 1: thread c runs chunk c from zero and keeps (A, z).
//     L is odd, so the threads of a warp, reading sm[c*L + j], hit
//     different banks (for 8-byte complex elements, within each half warp);
//   * a log-depth scan over the chunks' (A, z) (shuffles within a warp,
//     one warp over the warp totals) gives every chunk the map from the
//     segment's carry to its own start;
//   * pass 2: thread c reruns its chunk from its true start and writes y
//     over b in shared memory; the block stores the segment out coalesced.
// 32 rows use 32 of the 132 SMs; this kernel is right first, not fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Shared-memory words a segment may use (216 KB of the 227 KB a block can
// have): 54 float32 samples a thread for real rows with one a per row.
constexpr int kSegmentWords = kThreads * 54;

struct __align__(8) Cx {
  float re, im;
};

__device__ __forceinline__ float mul(float x, float y) { return x * y; }
__device__ __forceinline__ Cx mul(Cx x, Cx y) {
  return Cx{x.re * y.re - x.im * y.im, x.re * y.im + x.im * y.re};
}
__device__ __forceinline__ float add(float x, float y) { return x + y; }
__device__ __forceinline__ Cx add(Cx x, Cx y) {
  return Cx{x.re + y.re, x.im + y.im};
}
__device__ __forceinline__ float shfl_up(float v, int d) {
  return __shfl_up_sync(kFull, v, d);
}
__device__ __forceinline__ Cx shfl_up(Cx v, int d) {
  return Cx{__shfl_up_sync(kFull, v.re, d), __shfl_up_sync(kFull, v.im, d)};
}
template <class T> __device__ __forceinline__ T one();
template <> __device__ __forceinline__ float one<float>() { return 1.f; }
template <> __device__ __forceinline__ Cx one<Cx>() { return Cx{1.f, 0.f}; }
template <class T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ Cx zero<Cx>() { return Cx{0.f, 0.f}; }

// The affine map y -> A y + z.  `then(e, l)` is e followed by l.
template <class T> struct Map {
  T A, z;
};
template <class T>
__device__ __forceinline__ Map<T> then(const Map<T>& e, const Map<T>& l) {
  return Map<T>{mul(l.A, e.A), add(mul(l.A, e.z), l.z)};
}

// Inclusive scan of the maps over the 32 lanes (lane i: maps 0..i of the
// warp composed in order), Hillis-Steele.
template <class T>
__device__ __forceinline__ Map<T> warp_scan(Map<T> m, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map<T> o{shfl_up(m.A, d), shfl_up(m.z, d)};
    if (lane >= d) m = then(o, m);
  }
  return m;
}

template <class T>
__device__ __forceinline__ Map<T> shift_up_one(const Map<T>& m, int lane) {
  Map<T> o{shfl_up(m.A, 1), shfl_up(m.z, 1)};
  if (lane == 0) o = Map<T>{one<T>(), zero<T>()};
  return o;
}

template <class T>
__host__ __device__ constexpr int segment_len(bool per_step) {
  return kSegmentWords / (int)(sizeof(T) / sizeof(float)) / (per_step ? 2 : 1);
}

template <class T, bool kPerStep>
__global__ void __launch_bounds__(kThreads, 1)
    linrec_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const T* __restrict__ y0, T* __restrict__ y, int n) {
  constexpr int kSeg = segment_len<T>(kPerStep);
  extern __shared__ __align__(16) float smem[];
  T* sb = reinterpret_cast<T*>(smem);            // [kSeg] b, then y
  T* sa = sb + kSeg;                             // [kSeg] a, per step only
  Map<T>* wt = reinterpret_cast<Map<T>*>(sb + (kPerStep ? 2 : 1) * kSeg);
  T* carry = reinterpret_cast<T*>(wt + kWarps);  // the state entering
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const T* br = b + row * n;
  const T* ar = a + (kPerStep ? row * n : row);
  T* yr = y + row * n;
  const T a_row = kPerStep ? zero<T>() : ar[0];
  if (tid == 0) *carry = y0 ? y0[row] : zero<T>();

  for (int s0 = 0; s0 < n; s0 += kSeg) {
    const int len = min(kSeg, n - s0);
    for (int i = tid; i < len; i += kThreads) {
      sb[i] = br[s0 + i];
      if (kPerStep) sa[i] = ar[s0 + i];
    }
    __syncthreads();

    const int L = ((len + kThreads - 1) / kThreads) | 1;   // odd chunk
    const int c0 = min(tid * L, len), c1 = min(c0 + L, len);

    // pass 1: the chunk's map from a zero state
    Map<T> m{one<T>(), zero<T>()};
    for (int i = c0; i < c1; ++i) {
      const T ai = kPerStep ? sa[i] : a_row;
      m.z = add(mul(ai, m.z), sb[i]);
      m.A = mul(ai, m.A);
    }

    // the map from the segment's carry to each chunk's start
    const Map<T> inc = warp_scan(m, lane);
    if (lane == 31) wt[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const Map<T> w = warp_scan(wt[lane], lane);
      const Map<T> before = shift_up_one(w, lane);   // warps 0..lane-1
      __syncwarp();
      wt[lane] = before;
    }
    __syncthreads();
    const Map<T> start = then(wt[warp], shift_up_one(inc, lane));
    const T cin = *carry;
    T s = add(mul(start.A, cin), start.z);

    // pass 2: each chunk from its true start, y over b
    for (int i = c0; i < c1; ++i) {
      const T ai = kPerStep ? sa[i] : a_row;
      s = add(mul(ai, s), sb[i]);
      sb[i] = s;
    }
    __syncthreads();                             // every thread read carry
    if (c1 == len && c0 < c1) *carry = s;        // the segment's end state
    for (int i = tid; i < len; i += kThreads) yr[s0 + i] = sb[i];
    __syncthreads();                             // before the next loads
  }
}

template <class T, bool kPerStep>
int launch(const void* a, const void* b, const void* y0, void* y, int rows,
           int n, cudaStream_t stream) {
  constexpr int kSeg = segment_len<T>(kPerStep);
  const size_t smem = (size_t)(kPerStep ? 2 : 1) * kSeg * sizeof(T) +
                      kWarps * sizeof(Map<T>) + sizeof(T);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        linrec_kernel<T, kPerStep>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  linrec_kernel<T, kPerStep><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(y0), static_cast<T*>(y), n);
  return (int)cudaGetLastError();
}

}  // namespace

// a: [rows, n] (a_per_step) or [rows]; b, y: [rows, n]; y0: [rows] or NULL.
// All contiguous, float32 (is_complex 0) or complex64 (is_complex 1).
extern "C" int linrec(const void* a, const void* b, const void* y0, void* y,
                      int rows, int n, int is_complex, int a_per_step,
                      void* stream) {
  if (rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_complex)
    return a_per_step ? launch<Cx, true>(a, b, y0, y, rows, n, s)
                      : launch<Cx, false>(a, b, y0, y, rows, n, s);
  return a_per_step ? launch<float, true>(a, b, y0, y, rows, n, s)
                    : launch<float, false>(a, b, y0, y, rows, n, s);
}
