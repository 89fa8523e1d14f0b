// First-order linear recurrence y[n] = a[n] * y[n-1] + b[n] along each row
// of [rows, n], from an initial state y[-1] per row (0 when none is given),
// and its adjoint.  `a` is given per step ([rows, n]) or once per row
// ([rows]); rows are real float32, real float64 or complex64 (interleaved
// re, im).  float64 serves parity runs of the metrics on the card (PESQ's
// gain memory, and gradients through it, in the CPU's precision).
//
// Replaces: nelegan_tpu/ops/iir.py, the `jax.lax.associative_scan`s of
// `one_pole` (iir.py:38), of the block carries of `one_pole_blocked`
// (iir.py:83) and of `linear_recurrence_2x2` (iir.py:240, which the port
// runs as two complex one-poles of its constant matrix's eigenvalues), and
// what JAX's autodiff makes of them, and of PESQ's short-term gain memory
// (metrics/pesq.py:211, `_smooth_gain`), the same scan.  Torch has no
// associative scan, and a loop over samples in Python costs a launch a
// sample.
//
// The adjoint (`linrec_bwd`), for the output's gradient g, in torch's
// convention for complex gradients:
//   lambda[n] = g[n] + conj(a[n+1]) lambda[n+1]     from lambda[N] = 0
//   db = lambda;  da[n] = lambda[n] conj(y[n-1]), y[-1] = y0 (summed over
//   n when `a` is per row);  dy0 = conj(a[0]) lambda[0]
// is the same scan run from each row's end with conj(a) one step ahead, so
// one kernel serves both directions.
//
// What bounds it on an H100: memory.  [32, 55296] float32 is 7.1 MB of b
// in and 7.1 MB of y out, about 4.2 us at 3.35 TB/s; the scan's 2-8 flops
// a sample are far below the card's float32 rate.  So the card has to
// stream every row at once from many SMs, which a block per row cannot do
// (32 rows would use 32 of the 132 SMs).  The design:
//   * a row is split into tiles over a cluster of C CTAs (up to 16, chosen
//     so that rows * C reaches about two CTAs an SM, but no more clusters
//     than the card holds at once), which walks the row in windows of C
//     tiles; a long row takes several windows;
//   * a tile of T = 256 * L samples (L odd, so the threads of a warp,
//     reading sm[t*L + j], hit different banks) is fetched with cp.async,
//     the next window's tile into a second buffer while this one is
//     scanned;
//   * in a tile, chunk t of L samples maps its incoming state affinely,
//     y_out = A y_in + z with A the product of its a and z its end state
//     from zero.  Pass 1: thread t runs chunk t from zero and keeps (A, z);
//     a shuffle scan over the warps gives each chunk the map from the tile's
//     start to its own and the tile its aggregate map;
//   * the tiles of a window exchange their aggregate maps through
//     distributed shared memory: after one cluster barrier one warp of each
//     CTA scans the C aggregates in rank order and applies the scan before
//     its rank to the window's carry.  Every CTA composes in the same fixed
//     order, so the result does not depend on timing: two runs agree bit
//     for bit, without atomics;
//   * pass 2: thread t reruns its chunk from its true start, writing y over
//     b in shared memory (the adjoint also da, per step over y, per row
//     into a register); each warp then stores its own stretch with 16-byte
//     stores, without waiting for the others.  A per-row
//     da is summed in a fixed order: each thread over its windows, a
//     shuffle tree in each warp, the warps in order, then a shuffle tree in
//     rank 0 over the cluster's CTAs through distributed shared memory.
// Rows of at most kShortN samples (PESQ's gain memory is [8, 143]) take
// one warp each, kShortWarps rows a CTA, with no cluster: such a launch is
// bound by its latency, not by bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 15;          // samples a thread scans (odd)
constexpr int kMaxCluster = 16;        // CTAs a row is split over
constexpr int kCtasPerSm = 2;          // the grid a plan aims at, per SM
constexpr int kMinShare = 1024;        // fewest samples a CTA of a row takes
// Dynamic shared memory a CTA may use for its tiles: two CTAs fit an SM,
// so a cluster of 16 fits in any of the card's GPCs.
constexpr size_t kSmemBudget = 96 * 1024;
constexpr int kShortN = 512;           // rows this short take a warp each
constexpr int kShortWarps = 8;         // rows a CTA of the short form

struct __align__(8) Cx {
  float re, im;
};

__device__ __forceinline__ float mul(float x, float y) { return x * y; }
__device__ __forceinline__ double mul(double x, double y) { return x * y; }
__device__ __forceinline__ Cx mul(Cx x, Cx y) {
  return Cx{x.re * y.re - x.im * y.im, x.re * y.im + x.im * y.re};
}
__device__ __forceinline__ float add(float x, float y) { return x + y; }
__device__ __forceinline__ double add(double x, double y) { return x + y; }
__device__ __forceinline__ Cx add(Cx x, Cx y) {
  return Cx{x.re + y.re, x.im + y.im};
}
__device__ __forceinline__ float conj_(float x) { return x; }
__device__ __forceinline__ double conj_(double x) { return x; }
__device__ __forceinline__ Cx conj_(Cx x) { return Cx{x.re, -x.im}; }
__device__ __forceinline__ float shfl_up(float v, int d) {
  return __shfl_up_sync(kFull, v, d);
}
__device__ __forceinline__ double shfl_up(double v, int d) {
  return __shfl_up_sync(kFull, v, d);
}
__device__ __forceinline__ Cx shfl_up(Cx v, int d) {
  return Cx{__shfl_up_sync(kFull, v.re, d), __shfl_up_sync(kFull, v.im, d)};
}
__device__ __forceinline__ float shfl_down(float v, int d) {
  return __shfl_down_sync(kFull, v, d);
}
__device__ __forceinline__ double shfl_down(double v, int d) {
  return __shfl_down_sync(kFull, v, d);
}
__device__ __forceinline__ Cx shfl_down(Cx v, int d) {
  return Cx{__shfl_down_sync(kFull, v.re, d),
            __shfl_down_sync(kFull, v.im, d)};
}
__device__ __forceinline__ float shfl_idx(float v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ double shfl_idx(double v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ Cx shfl_idx(Cx v, int src) {
  return Cx{__shfl_sync(kFull, v.re, src), __shfl_sync(kFull, v.im, src)};
}
template <class T> __device__ __forceinline__ T one();
template <> __device__ __forceinline__ float one<float>() { return 1.f; }
template <> __device__ __forceinline__ double one<double>() { return 1.0; }
template <> __device__ __forceinline__ Cx one<Cx>() { return Cx{1.f, 0.f}; }
template <class T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ double zero<double>() { return 0.0; }
template <> __device__ __forceinline__ Cx zero<Cx>() { return Cx{0.f, 0.f}; }

// The affine map y -> A y + z.  `then(e, l)` is e followed by l.
template <class T> struct Map {
  T A, z;
};
template <class T> __device__ __forceinline__ Map<T> identity() {
  return Map<T>{one<T>(), zero<T>()};
}
template <class T>
__device__ __forceinline__ Map<T> then(const Map<T>& e, const Map<T>& l) {
  return Map<T>{mul(l.A, e.A), add(mul(l.A, e.z), l.z)};
}
template <class T>
__device__ __forceinline__ T apply(const Map<T>& m, const T& s) {
  return add(mul(m.A, s), m.z);
}
template <class T>
__device__ __forceinline__ Map<T> shfl_idx(const Map<T>& m, int src) {
  return Map<T>{shfl_idx(m.A, src), shfl_idx(m.z, src)};
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
  if (lane == 0) o = identity<T>();
  return o;
}

// Sum over the 32 lanes in a fixed tree; lane 0 holds the total.
template <class T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = add(v, shfl_down(v, d));
  return v;
}

// ------------------------------------------------------------ asynchronous
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
template <class T>
__device__ __forceinline__ void cp_async_one(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// count elements from global src into shared dst (16-byte aligned), in
// 16-byte pieces where src is aligned too.
template <class T>
__device__ __forceinline__ void fetch(T* dst, const T* src, int count,
                                      int tid, int nthreads) {
  constexpr int kPer = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nvec = count / kPer;
    for (int i = tid; i < nvec; i += nthreads)
      cp_async_16(dst + i * kPer, src + i * kPer);
    done = nvec * kPer;
  }
  for (int i = done + tid; i < count; i += nthreads)
    cp_async_one(dst + i, src + i);
}

// count elements from shared src to global dst: a scalar head up to dst's
// 16-byte boundary, then 16-byte stores where src is aligned there too.
template <class T>
__device__ __forceinline__ void store(T* dst, const T* src, int count,
                                      int tid, int nthreads) {
  constexpr int kPer = 16 / sizeof(T);
  int head = min(count, (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15))
                               & 15) / sizeof(T)));
  if ((reinterpret_cast<uintptr_t>(src + head) & 15) != 0) head = count;
  for (int i = tid; i < head; i += nthreads) dst[i] = src[i];
  const int nvec = (count - head) / kPer;
  for (int i = tid; i < nvec; i += nthreads)
    reinterpret_cast<float4*>(dst + head)[i] =
        reinterpret_cast<const float4*>(src + head)[i];
  for (int i = head + nvec * kPer + tid; i < count; i += nthreads)
    dst[i] = src[i];
}

// ------------------------------------------------------------------ scan
template <class T> struct Args {
  const T* a;    // [rows, n] or [rows]
  const T* b;    // forward: b; adjoint: g, the output's gradient
  const T* y0;   // [rows] or NULL
  const T* y;    // adjoint: the forward's output, when da is wanted
  T* out;        // forward: y; adjoint: db
  T* da;         // adjoint: [rows, n] or [rows], or NULL
  T* dy0;        // adjoint: [rows], or NULL
  int rows, n;
};

// A segment of one row in shared memory: b (or g), a per step (for the
// adjoint one more, a[o + len]), y (adjoint with da).  Position q counts in
// the scan's direction; j = phys(q) is its index in the segment.
template <class T, bool kPerStep, bool kRev> struct Seg {
  T* sb;
  const T* sa;
  T* sy;
  int len;
  T a_row;  // per row: a, or conj(a) for the adjoint
  __device__ __forceinline__ int phys(int q) const {
    return kRev ? len - 1 - q : q;
  }
  // the coefficient of the state entering index j
  __device__ __forceinline__ T coef(int j) const {
    if (!kPerStep) return a_row;
    return kRev ? conj_(sa[j + 1]) : sa[j];
  }
  // the adjoint's conj(a[0]), for a segment that starts the row
  __device__ __forceinline__ T first_coef() const {
    return kPerStep ? conj_(sa[0]) : a_row;
  }
};

// Pass 1: the map of positions [q0, q1) from a zero state.
template <class T, bool P, bool R>
__device__ __forceinline__ Map<T> chunk_map(const Seg<T, P, R>& s, int q0,
                                            int q1) {
  Map<T> m = identity<T>();
  for (int q = q0; q < q1; ++q) {
    const int j = s.phys(q);
    const T c = s.coef(j);
    m.z = add(mul(c, m.z), s.sb[j]);
    m.A = mul(c, m.A);
  }
  return m;
}

// Pass 2: positions [q0, q1) from their true start `st`, written over b.
// The adjoint with y also forms da[j] = lambda[j] conj(y[j-1]): per step
// over y[j] (no longer needed: its one reader, j+1, came first, or read it
// into its y_before), per row into acc; y_before is y before the chunk's
// lowest index.  At the row's index 0 it writes dy0.
template <class T, bool P, bool R>
__device__ __forceinline__ void chunk_run(const Seg<T, P, R>& s, int q0,
                                          int q1, T st, bool has_y,
                                          T y_before, T& acc, T* dy0) {
  for (int q = q0; q < q1; ++q) {
    const int j = s.phys(q);
    st = add(mul(s.coef(j), st), s.sb[j]);
    s.sb[j] = st;
    if (R) {
      if (has_y) {
        const T d = mul(st, conj_(q + 1 < q1 ? s.sy[j - 1] : y_before));
        if (P)
          s.sy[j] = d;
        else
          acc = add(acc, d);
      }
      if (dy0 != nullptr && j == 0) *dy0 = mul(s.first_coef(), st);
    }
  }
}

template <class T> struct Header {
  Map<T> wt[kWarps];     // each warp's exclusive map
  Map<T> slot[2];        // the tile's aggregate map, by window parity
  T start;               // the state entering this CTA's tile
  T y_prev[2];           // adjoint: y before each buffer's segment
  T red[kWarps];         // per-row da: the warps' sums
  T part;                // per-row da: this CTA's sum
};

template <class T> __host__ __device__ constexpr size_t header_bytes() {
  return (sizeof(Header<T>) + 15) & ~size_t(15);
}
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
// Elements of one buffer: b, a per step (+4: the adjoint's a[o + len],
// keeping y aligned), y for the adjoint's da.
__host__ __device__ constexpr int buffer_elems(int tile, bool per_step,
                                               bool has_y) {
  return tile + (per_step ? tile + 4 : 0) + (has_y ? tile : 0);
}

// Long rows: a cluster of C CTAs a row (grid C * rows), `tiles` tiles of
// `tile` = kThreads * chunk samples a row, windows of C tiles.
template <class T, bool kPerStep, bool kRev>
__global__ void __launch_bounds__(kThreads)
    linrec_tiles(Args<T> p, int C, int tile, int chunk, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  Header<T>& h = *reinterpret_cast<Header<T>*>(smem);
  T* const buf0 = reinterpret_cast<T*>(smem + header_bytes<T>());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % C;
  const size_t row = blockIdx.x / C;
  const int n = p.n;
  const bool has_y = kRev && p.y != nullptr;
  const int belems = buffer_elems(tile, kPerStep, has_y);
  const int windows = (tiles + C - 1) / C;
  const T* br = p.b + row * n;
  const T* ar = p.a + (kPerStep ? row * n : row);
  const T* yr = has_y ? p.y + row * n : nullptr;
  T* outr = p.out + row * n;
  T* dar = (kRev && kPerStep && p.da) ? p.da + row * n : nullptr;
  const T a_row = kPerStep ? zero<T>() : (kRev ? conj_(ar[0]) : ar[0]);
  const T y0v = p.y0 ? p.y0[row] : zero<T>();
  cg::cluster_group cluster = cg::this_cluster();

  // window w's tile of this CTA: original offset o, length len (0: none)
  auto tile_of = [&](int w, int& o, int& len) {
    const int s = w * C + rank;
    const int k = kRev ? tiles - 1 - s : s;
    o = k * tile;
    len = s < tiles ? min(tile, n - o) : 0;
  };
  auto prefetch = [&](int w) {
    int o, len;
    tile_of(w, o, len);
    T* sb = buf0 + (w & 1) * belems;
    T* sa = sb + tile;
    T* sy = sa + (kPerStep ? tile + 4 : 0);
    fetch(sb, br + o, len, tid, kThreads);
    if (kPerStep) fetch(sa, ar + o, len, tid, kThreads);
    if (has_y) fetch(sy, yr + o, len, tid, kThreads);
    if (tid == 0 && len > 0) {  // the adjoint's a[o + len] and y[o - 1]
      if (kRev && kPerStep) {
        if (o + len < n)
          cp_async_one(sa + len, ar + o + len);
        else
          sa[len] = zero<T>();
      }
      if (has_y) {
        if (o > 0)
          cp_async_one(&h.y_prev[w & 1], yr + o - 1);
        else
          h.y_prev[w & 1] = y0v;
      }
    }
    cp_async_commit();
  };

  T carry = kRev ? zero<T>() : y0v;  // the window's entering state (warp 0)
  T acc = zero<T>();                 // per-row da: this thread's sum
  prefetch(0);
  for (int w = 0; w < windows; ++w) {
    cp_async_wait_all();
    __syncthreads();  // buffer w & 1 is in; buffer (w + 1) & 1 is free
    if (w + 1 < windows) prefetch(w + 1);
    int o, len;
    tile_of(w, o, len);
    T* sb = buf0 + (w & 1) * belems;
    T* sa = sb + tile;
    T* sy = sa + (kPerStep ? tile + 4 : 0);
    const Seg<T, kPerStep, kRev> sg{sb, sa, sy, len, a_row};
    const int q0 = min(tid * chunk, len), q1 = min(q0 + chunk, len);

    const Map<T> m = chunk_map(sg, q0, q1);
    T y_before = zero<T>();
    if (has_y && q0 < q1) {
      const int jlo = sg.phys(q1 - 1);
      y_before = jlo > 0 ? sy[jlo - 1] : h.y_prev[w & 1];
    }
    const Map<T> inc = warp_scan(m, lane);
    if (lane == 31) h.wt[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      Map<T> v = lane < kWarps ? h.wt[lane] : identity<T>();
      v = warp_scan(v, lane);
      const Map<T> before = shift_up_one(v, lane);
      const Map<T> agg = shfl_idx(v, kWarps - 1);
      __syncwarp();
      if (lane < kWarps) h.wt[lane] = before;
      if (lane == 0) h.slot[w & 1] = agg;
    }
    if (C > 1)
      cluster.sync();  // every tile's aggregate of this window is out
    else
      __syncthreads();
    if (warp == 0) {
      // the window's aggregate maps scanned in rank order: the state
      // entering this tile, and the next window's carry
      Map<T> v = identity<T>();
      if (lane < C)
        v = C > 1 ? *cluster.map_shared_rank(&h.slot[w & 1], lane)
                  : h.slot[w & 1];
      v = warp_scan(v, lane);
      const Map<T> before = shift_up_one(v, lane);
      if (lane == rank) h.start = apply(before, carry);
      carry = apply(shfl_idx(v, C - 1), carry);
    }
    __syncthreads();
    const Map<T> pre = then(h.wt[warp], shift_up_one(inc, lane));
    chunk_run(sg, q0, q1, apply(pre, h.start), has_y, y_before, acc,
              (kRev && p.dy0 && o == 0) ? p.dy0 + row : nullptr);
    // each warp stores its own positions, a contiguous stretch
    __syncwarp();
    const int wq0 = min(warp * 32 * chunk, len);
    const int wq1 = min(wq0 + 32 * chunk, len);
    const int jlo = kRev ? len - wq1 : wq0;
    store(outr + o + jlo, sb + jlo, wq1 - wq0, lane, 32);
    if (dar) store(dar + o + jlo, sy + jlo, wq1 - wq0, lane, 32);
  }

  if (kRev && !kPerStep && p.da) {
    acc = warp_sum(acc);
    if (lane == 0) h.red[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      T total = zero<T>();
      for (int i = 0; i < kWarps; ++i) total = add(total, h.red[i]);
      h.part = total;
    }
    if (C > 1) cluster.sync();
    if (rank == 0 && warp == 0) {
      T v = zero<T>();
      if (lane < C)
        v = C > 1 ? *cluster.map_shared_rank(&h.part, lane) : h.part;
      v = warp_sum(v);
      if (lane == 0) p.da[row] = v;
    }
  }
  if (C > 1) cluster.sync();  // the peers are done with this shared memory
}

// Short rows (n <= kShortN): one warp a row, kShortWarps rows a CTA;
// `stride` elements of shared memory a warp.
template <class T, bool kPerStep, bool kRev>
__global__ void __launch_bounds__(kShortWarps * 32)
    linrec_warps(Args<T> p, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * kShortWarps + warp;
  if (row >= (size_t)p.rows) return;
  const int n = p.n;
  const bool has_y = kRev && p.y != nullptr;
  T* sb = reinterpret_cast<T*>(smem) + warp * stride;
  T* sa = sb + pad4(n);
  T* sy = sa + (kPerStep ? pad4(n) + 4 : 0);
  const T* ar = p.a + (kPerStep ? row * n : row);
  for (int i = lane; i < n; i += 32) {
    sb[i] = p.b[row * n + i];
    if (kPerStep) sa[i] = ar[i];
    if (has_y) sy[i] = p.y[row * n + i];
  }
  if (kRev && kPerStep && lane == 0) sa[n] = zero<T>();
  const T a_row = kPerStep ? zero<T>() : (kRev ? conj_(ar[0]) : ar[0]);
  const T y0v = p.y0 ? p.y0[row] : zero<T>();
  __syncwarp();

  const Seg<T, kPerStep, kRev> sg{sb, sa, sy, n, a_row};
  const int chunk = ((n + 31) / 32) | 1;
  const int q0 = min(lane * chunk, n), q1 = min(q0 + chunk, n);
  const Map<T> inc = warp_scan(chunk_map(sg, q0, q1), lane);
  T y_before = zero<T>();
  if (has_y && q0 < q1) {
    const int jlo = sg.phys(q1 - 1);
    y_before = jlo > 0 ? sy[jlo - 1] : y0v;
  }
  __syncwarp();
  T acc = zero<T>();
  chunk_run(sg, q0, q1, apply(shift_up_one(inc, lane), kRev ? zero<T>() : y0v),
            has_y, y_before, acc, (kRev && p.dy0) ? p.dy0 + row : nullptr);
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    p.out[row * n + i] = sb[i];
    if (kRev && kPerStep && p.da) p.da[row * n + i] = sy[i];
  }
  if (kRev && !kPerStep && p.da) {
    acc = warp_sum(acc);
    if (lane == 0) p.da[row] = acc;
  }
}

// ----------------------------------------------------------------- launch
// A launch of `rows` clusters of C CTAs; attr must outlive the config.
inline cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int C, int rows,
                                 size_t smem, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * (size_t)rows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C CTAs of `smem` bytes of linrec_tiles<T, kPerStep, kRev>
// that the card holds at once (cached: the query costs more than a launch).
template <class T, bool kPerStep, bool kRev>
int resident_clusters(int C, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> known;
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find({C, smem});
  if (it != known.end()) return it->second;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(attr, C, 1, smem, nullptr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(
          &clusters, linrec_tiles<T, kPerStep, kRev>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    clusters = 0;
  }
  known[{C, smem}] = clusters;
  return clusters;
}

// Lets linrec_tiles<T, kPerStep, kRev> take its largest shared memory and
// clusters of kMaxCluster.
template <class T, bool kPerStep, bool kRev> cudaError_t init_tiles() {
  auto kernel = linrec_tiles<T, kPerStep, kRev>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(header_bytes<T>() + kSmemBudget + 64 * sizeof(T)));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// How linrec_tiles splits a row of n over C CTAs: tiles of kThreads *
// chunk samples, as few windows as the shared memory allows.
struct Plan {
  int C, chunk, tile, tiles;
  size_t smem;
};
template <class T, bool kPerStep> Plan split(int C, int n, bool has_y) {
  const int arrays = 1 + (kPerStep ? 1 : 0) + (has_y ? 1 : 0);
  int max_chunk = (int)(kSmemBudget / (2 * arrays * sizeof(T) * kThreads));
  max_chunk = min(kMaxChunk, (max_chunk - 1) | 1);
  const int share = (n + C - 1) / C;
  const int windows = (share + kThreads * max_chunk - 1) /
                      (kThreads * max_chunk);
  const int per_window = (share + windows - 1) / windows;
  Plan pl;
  pl.C = C;
  pl.chunk = ((per_window + kThreads - 1) / kThreads) | 1;
  pl.tile = kThreads * pl.chunk;
  pl.tiles = (n + pl.tile - 1) / pl.tile;
  const int buffers = (pl.tiles + C - 1) / C > 1 ? 2 : 1;
  pl.smem = header_bytes<T>() +
            (size_t)buffers * buffer_elems(pl.tile, kPerStep, has_y) *
                sizeof(T);
  return pl;
}

// The current device's streaming multiprocessors (read once), 0 on error.
int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return sms;
}

// C doubles while the grid is short of kCtasPerSm CTAs an SM; then halves
// while the card cannot hold all the rows' clusters at once, since a second
// wave of clusters would start only as the first ends.
template <class T, bool kPerStep, bool kRev>
Plan plan(int rows, int n, bool has_y, int sms) {
  int C = 1;
  while (C < kMaxCluster && (long)rows * C < (long)kCtasPerSm * sms &&
         (long)C * 2 * kMinShare <= n)
    C *= 2;
  Plan pl = split<T, kPerStep>(C, n, has_y);
  while (pl.C > 1 &&
         resident_clusters<T, kPerStep, kRev>(pl.C, pl.smem) < rows)
    pl = split<T, kPerStep>(pl.C / 2, n, has_y);
  return pl;
}

template <class T, bool kPerStep, bool kRev>
int launch(const Args<T>& p, cudaStream_t stream) {
  const bool has_y = kRev && p.y != nullptr;
  if (p.n <= kShortN) {
    static const cudaError_t ready = cudaFuncSetAttribute(
        linrec_warps<T, kPerStep, kRev>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kShortWarps * buffer_elems(kShortN, true, true) * sizeof(T)));
    if (ready != cudaSuccess) return (int)ready;
    const int stride = buffer_elems(pad4(p.n), kPerStep, has_y);
    const size_t smem = (size_t)kShortWarps * stride * sizeof(T);
    linrec_warps<T, kPerStep, kRev>
        <<<(p.rows + kShortWarps - 1) / kShortWarps, kShortWarps * 32, smem,
           stream>>>(p, stride);
    return (int)cudaGetLastError();
  }
  static const cudaError_t ready = init_tiles<T, kPerStep, kRev>();
  if (ready != cudaSuccess) return (int)ready;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const Plan pl = plan<T, kPerStep, kRev>(p.rows, p.n, has_y, sms);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(attr, pl.C, p.rows, pl.smem, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, linrec_tiles<T, kPerStep, kRev>, p, pl.C, pl.tile, pl.chunk,
      pl.tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The element types, as `kind` names them.
enum Kind { kFloat32 = 0, kComplex64 = 1, kFloat64 = 2 };

template <class T, bool kRev>
int dispatch_type(const void* a, const void* b, const void* y0,
                  const void* y, void* out, void* da, void* dy0, int rows,
                  int n, int a_per_step, cudaStream_t s) {
  const Args<T> p{(const T*)a, (const T*)b, (const T*)y0, (const T*)y,
                  (T*)out, (T*)da, (T*)dy0, rows, n};
  return a_per_step ? launch<T, true, kRev>(p, s)
                    : launch<T, false, kRev>(p, s);
}

template <bool kRev>
int dispatch(const void* a, const void* b, const void* y0, const void* y,
             void* out, void* da, void* dy0, int rows, int n, int kind,
             int a_per_step, void* stream) {
  if (rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kFloat32:
      return dispatch_type<float, kRev>(a, b, y0, y, out, da, dy0, rows, n,
                                        a_per_step, s);
    case kComplex64:
      return dispatch_type<Cx, kRev>(a, b, y0, y, out, da, dy0, rows, n,
                                     a_per_step, s);
    case kFloat64:
      return dispatch_type<double, kRev>(a, b, y0, y, out, da, dy0, rows, n,
                                         a_per_step, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a: [rows, n] (a_per_step) or [rows]; b, y: [rows, n]; y0: [rows] or NULL.
// All contiguous, of the type `kind` names: 0 float32, 1 complex64, 2
// float64.
extern "C" int linrec(const void* a, const void* b, const void* y0, void* y,
                      int rows, int n, int kind, int a_per_step,
                      void* stream) {
  return dispatch<false>(a, b, y0, nullptr, y, nullptr, nullptr, rows, n,
                         kind, a_per_step, stream);
}

// The adjoint of `linrec` for the output's gradient g [rows, n]: writes db
// [rows, n]; da (shaped as a) when not NULL, which needs the forward's
// output y; dy0 [rows] when not NULL.  y0 is the forward's (NULL: 0).
extern "C" int linrec_bwd(const void* a, const void* g, const void* y0,
                          const void* y, void* db, void* da, void* dy0,
                          int rows, int n, int kind, int a_per_step,
                          void* stream) {
  if (da != nullptr && y == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(a, g, y0, da ? y : nullptr, db, da, dy0, rows, n,
                        kind, a_per_step, stream);
}
