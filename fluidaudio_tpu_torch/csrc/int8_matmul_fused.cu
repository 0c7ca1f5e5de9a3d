// Dynamic-quantising int8 matmul for Hopper (sm_90a).
//
// Replaces fluidaudio_tpu/ops/quant_pallas.py::int8_matmul_fused (lines
// 60-119, Pallas body `_kernel` at 43-54), which computes the same function
// as fluidaudio_tpu/ops/quant.py::Int8Dense:
//
//   s_row[m]  = max(max_k |x[m,k]|, 1e-8) / 127             (IEEE division)
//   xq[m,k]   = clip(rint(x[m,k] / s_row[m]), -127, 127)    (half to even)
//   acc[m,n]  = sum_k xq[m,k] * wq[n,k]                     (exact int32)
//   out[m,n]  = ((float(acc) * s_row[m]) * s_col[n]) + bias[n], cast to out
//
// x is [M,K] bf16 or f32, wq [N,K] int8 (K contiguous: the `row.col` operand
// of mma.sync), s_col [N] f32, bias [N] f32 or none; out [M,N] bf16 or f32.
// Every rounding step is the reference's (`__fdiv_rn`, `rintf`,
// `__int2float_rn`, `__fmul_rn`, `__fadd_rn`: no contraction into an FMA),
// so the output equals the plain PyTorch version bit for bit.
//
// What bounds it on an H100: at the encoder's shapes (M = 24,064 rows,
// K x N = 1024 x 4096 or 4096 x 1024) one call is 2.0e11 int8 operations,
// 0.10 ms at 1,979 TOP/s, against 0.25 GB of bf16 in and out, 0.075 ms at
// 3.35 TB/s: the tensor cores bound it, narrowly.
//
// What the design does about it: two launches, both counted as this kernel.
// - The row scale needs the whole K row before any code can be written. The
//   TPU holds a [BM, K] x tile in VMEM; a Hopper block cannot (64 rows x
//   4096 x 2 B is 512 KB against 227 KB of shared memory), so a block that
//   quantised its own rows would read its x rows twice and every one of the
//   N/128 column blocks would redo it. Instead one pass (`quantize_rows`,
//   one warp per row, 16-byte loads) reads x once and writes the int8 codes
//   and the row scales: half of x's bytes again, a fraction of what the
//   repeated quantisation would read.
// - The GEMM (`int8_gemm_dequant`) takes 64 x 128 output tiles, 4 warps of
//   32 x 64 each, walks K in 64-byte tiles staged global -> registers ->
//   shared memory (the next tile's loads are in flight during this tile's
//   MMAs) and runs `mma.sync.m16n8k32.s8.s8.s32` with int32 accumulation;
//   the epilogue dequantises in registers and writes bf16 or f32 pairs.
// wgmma with TMA and a deeper pipeline are the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ------------------------------------------------------ row quantisation

constexpr int kQuantThreads = 256;  // 8 warps, one row each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ s_row,
              int M, int K) {
  constexpr int kPer = 16 / sizeof(T);  // elements in one 16-byte load
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kQuantThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * K;

  float amax = 0.f;
  for (int c = lane * kPer; c < K; c += 32 * kPer) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) amax = fmaxf(amax, fabsf(to_f32(v[i])));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (lane == 0) s_row[row] = s;

  int8_t* qr = xq + static_cast<size_t>(row) * K;
  for (int c = lane * kPer; c < K; c += 32 * kPer) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* v = reinterpret_cast<const T*>(&raw);
    alignas(8) int8_t q[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float r = rintf(__fdiv_rn(to_f32(v[i]), s));
      q[i] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
    }
    if constexpr (kPer == 8) {
      *reinterpret_cast<uint2*>(qr + c) = *reinterpret_cast<const uint2*>(q);
    } else {
      *reinterpret_cast<uint32_t*>(qr + c) = *reinterpret_cast<const uint32_t*>(q);
    }
  }
}

// ------------------------------------------------- int8 GEMM + dequant

constexpr int kBM = 64;             // output rows per block
constexpr int kBN = 128;            // output columns per block
constexpr int kBK = 64;             // K bytes per shared-memory tile
constexpr int kGemmThreads = 128;   // 4 warps as 2 x 2, each 32 rows x 64 columns
constexpr int kLd = kBK + 16;       // smem row stride in bytes: 16-byte aligned,
                                    // fragment reads hit 32 distinct banks
constexpr int kXChunks = kBM * kBK / 16 / kGemmThreads;  // 16-byte loads per thread
constexpr int kWChunks = kBN * kBK / 16 / kGemmThreads;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float dequant(int acc, float sr, float sc, const float* bias,
                                         int col) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sr), sc);
  return bias ? __fadd_rn(v, bias[col]) : v;
}

__device__ __forceinline__ void store_pair(float* out, size_t i, float v0, float v1, bool pair,
                                           bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
  } else {
    out[i] = v0;
    if (second) out[i + 1] = v1;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* out, size_t i, float v0, float v1,
                                           bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(v0, v1);
  } else {
    out[i] = __float2bfloat16_rn(v0);
    if (second) out[i + 1] = __float2bfloat16_rn(v1);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kGemmThreads)
int8_gemm_dequant(const int8_t* __restrict__ xq, const float* __restrict__ s_row,
                  const int8_t* __restrict__ wq, const float* __restrict__ s_col,
                  const float* __restrict__ bias, OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t sX[kBM * kLd];
  __shared__ __align__(16) int8_t sW[kBN * kLd];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;  // mma fragment group and thread-in-group
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  // global -> registers; rows past M or N and K past its end load zeros
  // (K is a multiple of 16, so a 16-byte chunk is wholly in or out)
  uint4 rx[kXChunks], rw[kWChunks];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int idx = tid + i * kGemmThreads, r = idx >> 2, c = (idx & 3) * 16;
      const int gr = m0 + r, gk = k0 + c;
      rx[i] = (gr < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(xq + static_cast<size_t>(gr) * K + gk)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int idx = tid + i * kGemmThreads, r = idx >> 2, c = (idx & 3) * 16;
      const int gn = n0 + r, gk = k0 + c;
      rw[i] = (gn < N && gk < K)
                  ? *reinterpret_cast<const uint4*>(wq + static_cast<size_t>(gn) * K + gk)
                  : make_uint4(0, 0, 0, 0);
    }
  };

  const int n_k = (K + kBK - 1) / kBK;
  load_tile(0);
  for (int kt = 0; kt < n_k; ++kt) {
    __syncthreads();  // every warp is done reading the previous tile
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int idx = tid + i * kGemmThreads;
      *reinterpret_cast<uint4*>(sX + (idx >> 2) * kLd + (idx & 3) * 16) = rx[i];
    }
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int idx = tid + i * kGemmThreads;
      *reinterpret_cast<uint4*>(sW + (idx >> 2) * kLd + (idx & 3) * 16) = rw[i];
    }
    __syncthreads();
    if (kt + 1 < n_k) load_tile((kt + 1) * kBK);  // in flight during the MMAs

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = sX + (wm * 32 + mi * 16 + g) * kLd + ks + t * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* p = sW + (wn * 64 + ni * 8 + g) * kLd + ks + t * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  }

  // epilogue: accumulator (mi, ni, h*2 + j) is row g + 8h, column 2t + j of its 16 x 8 tile
  const bool even_n = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + mi * 16 + g + h * 8;
      if (row >= M) continue;
      const float sr = s_row[row];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn * 64 + ni * 8 + t * 2;
        if (col >= N) continue;
        const bool second = col + 1 < N;
        const float v0 = dequant(acc[mi][ni][h * 2], sr, s_col[col], bias, col);
        const float v1 = second ? dequant(acc[mi][ni][h * 2 + 1], sr, s_col[col + 1], bias,
                                          col + 1)
                                : 0.f;
        store_pair(out, static_cast<size_t>(row) * N + col, v0, v1, second && even_n, second);
      }
    }
  }
}

}  // namespace

// Launches both kernels on `stream`: x [M,K] (bf16 if x_is_bf16, else f32)
// -> scratch xq [M,K] int8 and s_row [M] f32 -> out [M,N] (bf16 if
// out_is_bf16, else f32). bias may be null. Does not synchronise, allocates
// nothing; returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape the kernels do not take). x, xq and wq
// must be 16-byte aligned and K a multiple of 16.
extern "C" int int8_matmul_fused_launch(const void* x, void* xq, void* s_row, const void* wq,
                                        const void* s_col, const void* bias, void* out, int M,
                                        int N, int K, int x_is_bf16, int out_is_bf16,
                                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int quant_blocks = (M + kQuantThreads / 32 - 1) / (kQuantThreads / 32);
  if (x_is_bf16) {
    quantize_rows<__nv_bfloat16><<<quant_blocks, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(s_row), M, K);
  } else {
    quantize_rows<float><<<quant_blocks, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(s_row), M,
        K);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const auto* q = static_cast<const int8_t*>(xq);
  const auto* sr = static_cast<const float*>(s_row);
  const auto* w = static_cast<const int8_t*>(wq);
  const auto* sc = static_cast<const float*>(s_col);
  const auto* b = static_cast<const float*>(bias);
  if (out_is_bf16) {
    int8_gemm_dequant<__nv_bfloat16><<<grid, kGemmThreads, 0, s>>>(
        q, sr, w, sc, b, static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    int8_gemm_dequant<float><<<grid, kGemmThreads, 0, s>>>(q, sr, w, sc, b,
                                                           static_cast<float*>(out), M, N, K);
  }
  return cudaGetLastError();
}
