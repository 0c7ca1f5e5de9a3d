// Multi-head self-attention core, f32, for Hopper (sm_90a): the Sortformer
// head's softmax(q k^T / sqrt(Dh)) v in one kernel.
//
// Replaces no TPU kernel. The JAX package's Sortformer head
// (fluidaudio_tpu/models/sortformer.py, `_NemoTfBlock`) leaves this to XLA as
// two einsums around a masked softmax. In PyTorch those are separate passes
// over an f32 [B, H, N, N] score tensor (the product, the scale, the mask,
// the softmax, the product with v): at the offline windows (N 384, H 8,
// Dh 24) ~38 MB of device memory per window and layer for 1.2 MB of inputs
// and output, over 18 layers.
//
// For every batch row b, head h and query n:
//
//   out[b,n,h] = sum_m softmax_m(q[b,n,h] . k[b,m,h] / sqrt(Dh)) v[b,m,h]
//
// over the keys m with valid[b,m], when valid[b,n]; a query with
// valid[b,n] false takes the mean of v over all N keys (the uniform row that
// f32-min scores give the reference), and valid == nullptr means every
// position is valid. q, k and v are [B, N, H, Dh] f32 views with a
// contiguous last axis and other strides that are multiples of 4 elements
// (the reshaped outputs of the head's nn.Linear layers); out is a contiguous
// f32 [B, N, H, Dh]. Dh is any multiple of 8 up to 64.
//
// What bounds it on an H100: at a window (N 384, H 8, Dh 24) its two
// products are 4 N^2 H Dh = 113 MFLOP, 1.7 us at 67 TFLOP/s on the FP32
// pipe (no TF32: the head's numbers stay f32), against 1.2 MB moved (0.35 us
// at 3.35 TB/s). So it is bound by FMAs, and the scores must never leave the
// chip.
//
// What the design does about it:
// - One block of 64 threads per (64 R query rows, h, b); R = 2 rows a thread
//   at Dh <= 32 (128 rows a block: three blocks cover a window's 384), 1 above.
//   A thread holds its rows of q in registers, prescaled by log2(e) /
//   sqrt(Dh) so that the softmax runs on exp2, and its rows of the output.
// - Keys go by in tiles of C = 16: K and V of the next tile are `cp.async`ed
//   (16 bytes, zero fill past N and past Dh) into the other of two
//   shared-memory stages while this one is computed, with one barrier a
//   tile, as `relpos_attention_simt` does.
// - Register tiles: a thread computes its R x C scores with Dh unrolled; all
//   32 lanes of a warp read the same K row, so each 16-byte shared-memory read
//   is one broadcast and feeds 4 R FMAs. The masks are an additive bias per
//   key, staged with the tile: 0 or -inf for a valid query (key validity and
//   the end of the keys), and for a masked query its row of q is zero and
//   its bias masks only the keys past N, which makes the uniform row.
// - The online softmax (running max and sum) stays in registers: a thread
//   owns whole rows, so it needs no shuffles and no exchange of
//   probabilities; the accumulator is rescaled once per tile. Then P.V adds
//   the tile into the R x Dh accumulator, again one broadcast V read per 4 R
//   FMAs. A masked key gets weight exp2(-inf) = 0. The tile's max and sum
//   run in four independent chains.
// - The output is divided by the row sum once and stored as float4.
// - Budget: 2 stages of (K, V: C x Dh floats each, two biases of C) = 6.4 KB
//   at Dh 24, so registers set the occupancy: 183 a thread at Dh 24, five
//   blocks (10 warps) an SM (ptxas's registers and spills are printed by
//   `chip_smoke.py` phase 1). Measured against this (NVIDIA H100 80GB HBM3,
//   700 W, B 16-128 at N 384, Dh 24): tiles of 32 keys, 254 registers and 4
//   blocks an SM, 3-6% slower at B 16 and 64, even at B 128, and a longer
//   build; with those tiles, a cap of 168 registers, which spills,
//   24-33% slower, and blocks of 96 threads (two cover 384 rows, K and V
//   read by 3 warps), 9% faster at B 16 but 21-25% slower at B 64 and 128.
//   At B 128 it reaches ~46% of its bound; by count, ~80% of a tile's
//   instructions are FMAs, the rest its shared-memory reads, softmax and
//   rescaling.
// - Instances at a padded head width of 8, 16, 24, 32, 48 and 64 (Dh 40 and
//   56 run as 48 and 64 with zero columns, which the stores skip).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 64;

// element strides of a [B, N, H, Dh] view along b, n and h
struct Strides {
  long long b, n, h;
};

template <int D>  // D: the padded head width
struct Plan {
  static constexpr int kRows = D <= 32 ? 2 : 1;      // query rows per thread
  static constexpr int kKeys = 16;                   // keys per tile
  static constexpr int kBlockRows = kThreads * kRows;
  static constexpr int kStage = 2 * kKeys * D + 2 * kKeys;  // K, V, two biases (floats)
  static constexpr int kBytes = 4 * 2 * kStage;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool valid) {
  // a source size of 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
self_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const uint8_t* __restrict__ valid,
                   float* __restrict__ out, Strides sq, Strides sk, Strides sv, long long vb,
                   long long vn, int N, int H, int Dh, float qscale) {
  using P = Plan<D>;
  constexpr int R = P::kRows, C = P::kKeys, D4 = D / 4;
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n0 = blockIdx.x * P::kBlockRows;
  const float* const kh = k + b * sk.b + h * sk.h;
  const float* const vh = v + b * sv.b + h * sv.h;
  const uint8_t* const vrow = valid ? valid + b * vb : nullptr;
  const int n_tiles = (N + C - 1) / C;

  // K, V rows of tile i and its two biases into stage i & 1
  auto load_tile = [&](int i) {
    float* const st = sm + (i & 1) * P::kStage;
    const int m0 = i * C;
    for (int c = tid; c < 2 * C * D4; c += kThreads) {
      const int which = c / (C * D4), r = (c / D4) % C, q4 = c % D4, m = m0 + r;
      const bool ok = m < N && 4 * q4 < Dh;
      const float* const src = (which ? vh + m * sv.n : kh + m * sk.n) + 4 * q4;
      cp_async16(smem_addr(st + which * C * D + r * D + 4 * q4), ok ? src : kh, ok);
    }
    cp_async_commit();
    if (tid < C) {
      const int m = m0 + tid;
      const float bound = m < N ? 0.f : -INFINITY;
      st[2 * C * D + tid] = (vrow && m < N && !vrow[m * vn]) ? -INFINITY : bound;
      st[2 * C * D + C + tid] = bound;
    }
  };

  float qr[R][D], o[R][D], m_run[R], l_run[R];
  int bias_off[R];  // the row's bias within a stage: key validity, or the bound alone
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r * kThreads + tid;
    const bool in = n < N;
    const bool qvalid = in && (!vrow || vrow[n * vn]);
    const float* const qp = q + b * sq.b + (in ? n : 0) * sq.n + h * sq.h;
#pragma unroll
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 x = qvalid && 4 * d4 < Dh ? ld4(qp + 4 * d4) : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[r][4 * d4] = x.x * qscale;
      qr[r][4 * d4 + 1] = x.y * qscale;
      qr[r][4 * d4 + 2] = x.z * qscale;
      qr[r][4 * d4 + 3] = x.w * qscale;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) o[r][d] = 0.f;
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
    bias_off[r] = 2 * C * D + (qvalid ? 0 : C);
  }

  load_tile(0);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    // one barrier a tile: tile i has landed for every thread, and every
    // thread is done with tile i - 1, whose stage tile i + 1 fills
    __syncthreads();
    if (i + 1 < n_tiles) load_tile(i + 1);
    const float* const st = sm + (i & 1) * P::kStage;
    const float* const kt = st;
    const float* const vt = st + C * D;

    float s[R][C];
#pragma unroll
    for (int j4 = 0; j4 < C / 4; ++j4) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 bias = ld4(st + bias_off[r] + 4 * j4);
        s[r][4 * j4] = bias.x;
        s[r][4 * j4 + 1] = bias.y;
        s[r][4 * j4 + 2] = bias.z;
        s[r][4 * j4 + 3] = bias.w;
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
#pragma unroll
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 kk = ld4(kt + j * D + 4 * d4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][j] = fmaf(qr[r][4 * d4], kk.x, s[r][j]);
          s[r][j] = fmaf(qr[r][4 * d4 + 1], kk.y, s[r][j]);
          s[r][j] = fmaf(qr[r][4 * d4 + 2], kk.z, s[r][j]);
          s[r][j] = fmaf(qr[r][4 * d4 + 3], kk.w, s[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // the tile's max and sum in four independent chains
      float mx4[4] = {s[r][0], s[r][1], s[r][2], s[r][3]};
#pragma unroll
      for (int j = 4; j < C; ++j) mx4[j % 4] = fmaxf(mx4[j % 4], s[r][j]);
      const float mx = fmaxf(m_run[r], fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3])));
      // a tile with no valid key for the row leaves it as it was
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float corr = exp2f(m_run[r] - m_use);
      m_run[r] = mx;
      float ps4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < C; ++j) {
        s[r][j] = exp2f(s[r][j] - m_use);
        ps4[j % 4] += s[r][j];
      }
      l_run[r] = fmaf(l_run[r], corr, (ps4[0] + ps4[1]) + (ps4[2] + ps4[3]));
#pragma unroll
      for (int d = 0; d < D; ++d) o[r][d] *= corr;
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
#pragma unroll
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 vv = ld4(vt + j * D + 4 * d4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          o[r][4 * d4] = fmaf(s[r][j], vv.x, o[r][4 * d4]);
          o[r][4 * d4 + 1] = fmaf(s[r][j], vv.y, o[r][4 * d4 + 1]);
          o[r][4 * d4 + 2] = fmaf(s[r][j], vv.z, o[r][4 * d4 + 2]);
          o[r][4 * d4 + 3] = fmaf(s[r][j], vv.w, o[r][4 * d4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r * kThreads + tid;
    if (n >= N) continue;
    const float inv = 1.f / l_run[r];
    float* const op = out + ((static_cast<long long>(b) * N + n) * H + h) * Dh;
#pragma unroll
    for (int d4 = 0; d4 < D4; ++d4) {
      if (4 * d4 < Dh) {
        *reinterpret_cast<float4*>(op + 4 * d4) =
            make_float4(o[r][4 * d4] * inv, o[r][4 * d4 + 1] * inv, o[r][4 * d4 + 2] * inv,
                        o[r][4 * d4 + 3] * inv);
      }
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const uint8_t* valid,
                   float* out, const Strides* st, long long vb, long long vn, int B, int N, int H,
                   int Dh, cudaStream_t stream) {
  using P = Plan<D>;
  // log2(e) / sqrt(Dh): scores in base 2, the scale folded into q
  const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(Dh));
  const dim3 grid((N + P::kBlockRows - 1) / P::kBlockRows, H, B);
  self_attention_f32<D><<<grid, kThreads, P::kBytes, stream>>>(
      q, k, v, valid, out, st[0], st[1], st[2], vb, vn, N, H, Dh, qscale);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a launch asks for, in bytes, at head width dh.
extern "C" int self_attention_smem_bytes(int dh) {
  return dh <= 8 ? Plan<8>::kBytes : dh <= 16 ? Plan<16>::kBytes : dh <= 24 ? Plan<24>::kBytes
       : dh <= 32 ? Plan<32>::kBytes : dh <= 48 ? Plan<48>::kBytes : Plan<64>::kBytes;
}

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take). `strides`
// holds 9 element strides: (b, n, h) of q, k and v, whose last axes are
// contiguous; `valid` is a [B, N] bool (one byte each) with element strides
// vb and vn, or null.
extern "C" int self_attention_launch(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, const long long* strides,
                                     long long vb, long long vn, int B, int N, int H, int Dh,
                                     void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1 || Dh % 8 || Dh < 8 || Dh > 64) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[3];
  for (int i = 0; i < 3; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const float* const qq = static_cast<const float*>(q);
  const float* const kk = static_cast<const float*>(k);
  const float* const vv = static_cast<const float*>(v);
  const uint8_t* const m = static_cast<const uint8_t*>(valid);
  float* const o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh <= 8) return (int)launch<8>(qq, kk, vv, m, o, st, vb, vn, B, N, H, Dh, s);
  if (Dh <= 16) return (int)launch<16>(qq, kk, vv, m, o, st, vb, vn, B, N, H, Dh, s);
  if (Dh <= 24) return (int)launch<24>(qq, kk, vv, m, o, st, vb, vn, B, N, H, Dh, s);
  if (Dh <= 32) return (int)launch<32>(qq, kk, vv, m, o, st, vb, vn, B, N, H, Dh, s);
  if (Dh <= 48) return (int)launch<48>(qq, kk, vv, m, o, st, vb, vn, B, N, H, Dh, s);
  return (int)launch<64>(qq, kk, vv, m, o, st, vb, vn, B, N, H, Dh, s);
}
