// In-block ops for Hopper (sm_90a): lane and row gathers, scans, sort, argmax,
// rotate and bf16 arithmetic.
//
// Replaces the ten TPU probe kernels of scripts/probe_mosaic_ops.py (the
// lambdas at :35-117, each launched by try_kernel's pallas_call at :13). Plain
// PyTorch versions: oxylus_tpu_torch/probes/mosaic_ops.py::*_reference.
//
// What they compute, one kernel per op: take_along_axis on lanes (x (R, n),
// idx (R, m)) and on rows; an inclusive sum along rows or columns; an
// ascending sort of each row; each row's argmax (first index on ties, NaN
// above everything, as float32); a roll along lanes; bf16 x*x + x with each
// operation rounded to bf16. Gather indices in [-n, 0) count from the end, and
// one outside [-n, n) gives NaN, as jnp.take_along_axis's default.
//
// What bounds them on the card: bytes, and at the script's sizes (a 192 KB
// (128, 384) float32 block, 0.1 us at 3.35 TB/s) the launch latency. The
// sort's R * 256 * 45 compare-exchanges (the bitonic network of the padded
// 512-key row) are a fraction of a microsecond of the SMs' rate; a row's 45
// stages run one after another, so their latency is the sort's floor.
//
// What the design does about it: the gathers, the scan and argmax run one
// block per row (per column for the axis-0 scan, which reads with the row
// stride), coalesced along the row; the roll a
// thread per 16-byte chunk of the output where the rows allow it (else per
// element), 256 a block over several rows. The scan is
// a Hillis-Steele scan by shuffles in each warp, then of the warp totals, the
// order oxylus_tpu_torch/probes/mosaic_ops.py::cumsum_reference repeats, so the
// two agree bit for bit. Argmax reduces (value, index) pairs with shuffles and
// one shared-memory step across warps. The sort maps floats to
// order-preserving unsigned keys (NaN above +inf, -0 below +0), pads the row
// to P = the power of two >= max(n, 32) with a key above every float, and
// sorts it with a bitonic network in one warp, the keys in registers: lane l
// holds keys l*K .. l*K + K - 1, K = P / 32 (64 for the widest rows, 2048).
// A stage whose stride is below K is compare-exchanges inside each thread;
// a wider one pairs lane l with lane l ^ (stride / K) by shfl.xor. From
// merge width K on a lane's keys share one direction, so a descending lane
// complements them for the phase (reversing their order) and every stage is
// a plain min and max. A lane's keys move as float4 where the row allows. No
// shared memory and no barrier: one warp a block, a block a row, so up to 132
// rows take an SM each. Any sorting network gives the same keys, so the
// output's bits are those of the sorted keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_LINE = 1024;
constexpr int MAX_SORT = 2048;
constexpr int GATHER_THREADS = 128;
constexpr int ARGMAX_THREADS = 256;
constexpr int ROLL_THREADS = 256;  // output chunks a block of the roll
constexpr uint32_t NAN_KEY = 0xfffffffeu;  // above +inf's key 0xff800000
constexpr uint32_t PAD_KEY = 0xffffffffu;

__device__ __forceinline__ float nan_value() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ int wrap(int k, int n) { return k < 0 ? k + n : k; }

__global__ void take_lanes_kernel(const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out,
                                  int n, int m) {
  const size_t r = blockIdx.x;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int k = wrap(idx[r * m + j], n);
    out[r * m + j] = (k >= 0 && k < n) ? x[r * n + k] : nan_value();
  }
}

__global__ void take_rows_kernel(const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out,
                                 int n_rows, int c) {
  const size_t r = blockIdx.x;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const int k = wrap(idx[r * c + j], n_rows);
    out[r * c + j] = (k >= 0 && k < n_rows) ? x[(size_t)k * c + j] : nan_value();
  }
}

// Inclusive Hillis-Steele scan over the 32 lanes of a warp.
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const float y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = v + y;
  }
  return v;
}

// One block per line of n <= 1024 elements, element e at x[line * s_line + e * s_elem].
__global__ void __launch_bounds__(MAX_LINE) scan_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                                        int s_elem, int s_line) {
  __shared__ float totals[32];
  const int e = threadIdx.x, lane = e % 32, warp = e / 32;
  const size_t at = (size_t)blockIdx.x * s_line + (size_t)e * s_elem;
  float v = warp_scan(e < n ? x[at] : 0.0f, lane);
  if (lane == 31) totals[warp] = v;
  __syncthreads();
  if (warp == 0) totals[lane] = warp_scan(lane < (int)(blockDim.x / 32) ? totals[lane] : 0.0f, lane);
  __syncthreads();
  if (warp > 0) v = v + totals[warp - 1];
  if (e < n) out[at] = v;
}

__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t b = __float_as_uint(f);
  if (isnan(f)) return NAN_KEY;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  if (k == NAN_KEY) return nan_value();
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The stages of one phase of the bitonic network (merge width k), strides j =
// k/2 .. 1, on key i of the padded row at lane i / K, slot i % K, and its
// partner i ^ j. Below K a phase's direction is the slot's ((q & k) == 0);
// from K on it is the lane's, and a descending lane has complemented its keys
// (sort_phases), so every stage sorts ascending: the lower index keeps the
// smaller key.
template <int K, int k, int j>
__device__ __forceinline__ void sort_stages(uint32_t (&key)[K], int lane) {
  if constexpr (j > 0) {
    if constexpr (j < K) {  // inside the thread: slots q and q | j
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (q & j) continue;
        const bool up = k >= K || (q & k) == 0;
        const uint32_t a = key[q], b = key[q | j], lo = a < b ? a : b, hi = a < b ? b : a;
        key[q] = up ? lo : hi;
        key[q | j] = up ? hi : lo;
      }
    } else {  // between lanes l and l ^ (j / K)
      const bool lower = (lane & (j / K)) == 0;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const uint32_t a = key[q], b = __shfl_xor_sync(FULL, a, j / K);
        key[q] = lower == (a < b) ? a : b;
      }
    }
    sort_stages<K, k, j / 2>(key, lane);
  }
}

// The phases k = 2 .. 32 * K. From K on, a lane whose k-block descends
// ((lane * K) & k != 0) complements its keys for the phase, which reverses
// their order.
template <int K, int k>
__device__ __forceinline__ void sort_phases(uint32_t (&key)[K], int lane) {
  if constexpr (k <= 32 * K) {
    const uint32_t flip = k >= K && k < 32 * K && ((lane * K) & k) ? 0xffffffffu : 0u;
#pragma unroll
    for (int q = 0; q < K; ++q) key[q] ^= flip;
    sort_stages<K, k, k / 2>(key, lane);
#pragma unroll
    for (int q = 0; q < K; ++q) key[q] ^= flip;
    sort_phases<K, 2 * k>(key, lane);
  }
}

// One warp (one block) per row of n <= 32 * K keys, padded to 32 * K. vec:
// n % 4 == 0 and both bases 16-byte aligned, so a lane's keys move as float4
// (its K consecutive floats, 64 bytes apart from the next lane's: as single
// floats the loads and stores took 1 us more at (128, 384) on an H100).
template <int K>
__global__ void __launch_bounds__(32) sort_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                                  bool vec) {
  const int lane = threadIdx.x, first = lane * K;
  const float* xr = x + (size_t)blockIdx.x * n;
  float* outr = out + (size_t)blockIdx.x * n;
  uint32_t key[K];
  if constexpr (K >= 4) {
    if (vec) {
#pragma unroll
      for (int c = 0; c < K; c += 4) {
        const bool in = first + c < n;
        const float4 f = in ? *reinterpret_cast<const float4*>(xr + first + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        key[c] = in ? float_key(f.x) : PAD_KEY;
        key[c + 1] = in ? float_key(f.y) : PAD_KEY;
        key[c + 2] = in ? float_key(f.z) : PAD_KEY;
        key[c + 3] = in ? float_key(f.w) : PAD_KEY;
      }
      sort_phases<K, 2>(key, lane);
#pragma unroll
      for (int c = 0; c < K; c += 4)
        if (first + c < n)
          *reinterpret_cast<float4*>(outr + first + c) =
              make_float4(key_float(key[c]), key_float(key[c + 1]), key_float(key[c + 2]), key_float(key[c + 3]));
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < K; ++q) key[q] = first + q < n ? float_key(xr[first + q]) : PAD_KEY;
  sort_phases<K, 2>(key, lane);
#pragma unroll
  for (int q = 0; q < K; ++q)
    if (first + q < n) outr[first + q] = key_float(key[q]);
}

// Whether (bv, bi) beats (av, ai): NaN above all, then the larger value, then the smaller index.
__device__ __forceinline__ bool beats(float bv, int bi, float av, int ai) {
  const bool bn = isnan(bv), an = isnan(av);
  if (bn != an) return bn;
  if (!bn && bv != av) return bv > av;
  return bi < ai;
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) {
    const float ov = __shfl_down_sync(FULL, v, d);
    const int oi = __shfl_down_sync(FULL, i, d);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(ARGMAX_THREADS) argmax_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                                int n) {
  __shared__ float sv[ARGMAX_THREADS / 32];
  __shared__ int si[ARGMAX_THREADS / 32];
  const float* row = x + (size_t)blockIdx.x * n;
  float v = __int_as_float(0xff800000);  // -inf
  int i = 0x7fffffff;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float y = row[e];
    if (beats(y, e, v, i)) {
      v = y;
      i = e;
    }
  }
  warp_argmax(v, i);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < ARGMAX_THREADS / 32 ? sv[lane] : __int_as_float(0xff800000);
    i = lane < ARGMAX_THREADS / 32 ? si[lane] : 0x7fffffff;
    warp_argmax(v, i);
    if (lane == 0) out[blockIdx.x] = (float)i;
  }
}

// out[r, j] = x[r, (j - shift) mod n], shift in [0, n). One output chunk a
// thread, so every load is issued at once (a thread that walks several
// chunks waits a round trip for each). With `vec` (n % 4 ==
// 0, both bases 16-byte aligned) a chunk is a float4: output chunk q of a row
// starts at source element s + 4q (mod n), s = (n - shift) mod n = 4·c0 + o,
// so it is elements o.. of source chunk c0 + q and ..o-1 of the next (both
// mod n / 4); o is the same in every thread, so the select does not diverge.
// Otherwise (n % 4 != 0 or a misaligned base) a chunk is one element.
__global__ void __launch_bounds__(ROLL_THREADS) roll_lanes_kernel(const float* __restrict__ x,
                                                                 float* __restrict__ out, int rows, int n, int shift,
                                                                 bool vec) {
  const size_t e = (size_t)blockIdx.x * ROLL_THREADS + threadIdx.x;
  if (!vec) {
    if (e >= (size_t)rows * n) return;
    const size_t row = e / n * n;
    const int j = (int)(e - row);
    out[e] = x[row + (j >= shift ? j - shift : j - shift + n)];
    return;
  }
  const int nc = n / 4;
  if (e >= (size_t)rows * nc) return;
  const size_t row = e / nc * nc;  // the row's first chunk
  const int q = (int)(e - row), s = shift == 0 ? 0 : n - shift, o = s & 3;
  const float4* x4 = reinterpret_cast<const float4*>(x) + row;
  int c = (s >> 2) + q;
  if (c >= nc) c -= nc;
  const float4 a = x4[c];
  const float4 b = x4[c + 1 == nc ? 0 : c + 1];
  reinterpret_cast<float4*>(out)[e] = o == 0   ? a
                                      : o == 1 ? make_float4(a.y, a.z, a.w, b.x)
                                      : o == 2 ? make_float4(a.z, a.w, b.x, b.y)
                                               : make_float4(a.w, b.x, b.y, b.z);
}

// Each operation rounded to bf16, as PyTorch's separate bf16 ops do.
__global__ void bf16_mul_add_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                                    size_t count) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count; e += (size_t)gridDim.x * blockDim.x) {
    const float a = __bfloat162float(x[e]);
    const float sq = __bfloat162float(__float2bfloat16_rn(a * a));
    out[e] = __float2bfloat16_rn(sq + a);
  }
}

cudaError_t last_error() { return cudaGetLastError(); }

}  // namespace

extern "C" {

// x (rows, n) f32, idx (rows, m) i32 -> out (rows, m) f32.
int probe_take_lanes(const void* x, const void* idx, void* out, int rows, int n, int m, void* stream) {
  if (rows <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  take_lanes_kernel<<<rows, GATHER_THREADS, 0, (cudaStream_t)stream>>>((const float*)x, (const int*)idx,
                                                                         (float*)out, n, m);
  return (int)last_error();
}

// x (n_rows, c) f32, idx (m_rows, c) i32 -> out (m_rows, c) f32.
int probe_take_rows(const void* x, const void* idx, void* out, int n_rows, int m_rows, int c, void* stream) {
  if (n_rows <= 0 || m_rows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  take_rows_kernel<<<m_rows, GATHER_THREADS, 0, (cudaStream_t)stream>>>((const float*)x, (const int*)idx,
                                                                          (float*)out, n_rows, c);
  return (int)last_error();
}

// `lines` inclusive sums of n <= 1024 elements each, element e of line l at l * s_line + e * s_elem.
int probe_scan(const void* x, void* out, int lines, int n, int s_elem, int s_line, void* stream) {
  if (lines <= 0 || n <= 0 || n > MAX_LINE) return (int)cudaErrorInvalidValue;
  scan_kernel<<<lines, 32 * ((n + 31) / 32), 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n, s_elem,
                                                                         s_line);
  return (int)last_error();
}

// x (rows, n) f32, n <= 2048 -> each row sorted ascending.
int probe_sort_rows(const void* x, void* out, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0 || n > MAX_SORT) return (int)cudaErrorInvalidValue;
  int keys = 1;  // K: keys a lane, the padded row's width / 32
  while (32 * keys < n) keys *= 2;
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const float* xf = (const float*)x;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (keys) {
    case 1: sort_kernel<1><<<rows, 32, 0, st>>>(xf, of, n, vec); break;
    case 2: sort_kernel<2><<<rows, 32, 0, st>>>(xf, of, n, vec); break;
    case 4: sort_kernel<4><<<rows, 32, 0, st>>>(xf, of, n, vec); break;
    case 8: sort_kernel<8><<<rows, 32, 0, st>>>(xf, of, n, vec); break;
    case 16: sort_kernel<16><<<rows, 32, 0, st>>>(xf, of, n, vec); break;
    case 32: sort_kernel<32><<<rows, 32, 0, st>>>(xf, of, n, vec); break;
    default: sort_kernel<64><<<rows, 32, 0, st>>>(xf, of, n, vec); break;
  }
  return (int)last_error();
}

// x (rows, n) f32 -> out (rows, 1) f32 holding each row's argmax.
int probe_argmax_rows(const void* x, void* out, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  argmax_kernel<<<rows, ARGMAX_THREADS, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n);
  return (int)last_error();
}

// x (rows, n) f32 rolled by shift in [0, n) along lanes.
int probe_roll_lanes(const void* x, void* out, int rows, int n, int shift, void* stream) {
  if (rows <= 0 || n <= 0 || shift < 0 || shift >= n) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const size_t chunks = (size_t)rows * (vec ? n / 4 : n);
  roll_lanes_kernel<<<(unsigned)((chunks + ROLL_THREADS - 1) / ROLL_THREADS), ROLL_THREADS, 0,
                      (cudaStream_t)stream>>>((const float*)x, (float*)out, rows, n, shift, vec);
  return (int)last_error();
}

// count bf16 values -> x * x + x, each operation rounded to bf16.
int probe_bf16_mul_add(const void* x, void* out, long long count, void* stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  bf16_mul_add_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const __nv_bfloat16*)x, (__nv_bfloat16*)out,
                                                                (size_t)count);
  return (int)last_error();
}

}  // extern "C"
