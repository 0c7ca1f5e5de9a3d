// Transformer-XL relative-position attention for Hopper (sm_90a).
//
// Replaces fluidaudio_tpu/ops/attention_pallas.py::relpos_attention (Pallas
// body `_attn_kernel`). For every batch row b, head h and query t:
//
//   ac[t,s] = (q+u)[t] . k[s]
//   bd[t,s] = (q+w)[t] . p[(T-1) + s - t]      (the XL shift as a direct index)
//   score   = (ac + bd) / sqrt(Dh), key columns s >= min(len[b], T) -> -FLT_MAX
//   out[t]  = softmax_s(score) . v            (f32 softmax and accumulation)
//
// Inputs qu/qw/k/v [B,H,T,Dh] and p [H,2T-1,Dh] are bf16 or f32, lengths [B]
// int32; the output is f32 [B,H,T,Dh]. Dh is any multiple of 16 up to 128.
//
// What bounds it on an H100: at the Parakeet sizes (T <= 188, Dh = 128) one
// (b, h) is ~14 M multiply-adds over ~290 KB of inputs, so the problem is
// small and latency-bound, not HBM-bound: nothing of size [T, T] ever leaves
// the chip; a 15 s batch of 128 rows moves ~300 MB per layer (bf16 in, f32
// out), 0.09 ms at the H100's 3.35 TB/s against 0.71 ms measured on an H100
// SXM; the K/V/p tiles that several query blocks share come from the L2.
//
// What the design does about it:
// - bf16 (the encoder's type): tensor cores through `mma.sync` m16n8k16 with
//   f32 accumulation. One block of 4 warps per (b, h, 64 query rows), each
//   warp owning 16 rows; the block walks 32-key tiles with an online softmax,
//   so shared memory stays ~90 KB at Dh 128 whatever T is and two blocks fit
//   on an SM. The shifted position scores of a key tile need p rows
//   (T-1)+s-t for the warp's 16 rows: one contiguous band of 47 rows, whose
//   16 x 48 product is staged per warp in shared memory and read back along
//   the diagonal. Probabilities are rounded to bf16 for P.V, as the Pallas
//   kernel rounds them to v's type.
// - f32 (the small test fixtures): scalar FMAs, one block per (b, h,
//   16-query tile), the same online softmax over 32-key tiles, all in f32.
// wgmma/TMA pipelines are the next step for the bf16 path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------- bf16 path

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMQ = 16 * kMmaWarps;     // query rows per block
constexpr int kMK = 32;                 // keys per tile
constexpr int kBand = kMQ + kMK;        // p rows a key tile needs (95) + 1
constexpr int kWarpBand = 16 + kMK;     // p rows one warp needs (47) + 1
constexpr int kRawLd = kWarpBand + 4;   // f32 stride of the per-warp band scores

template <int DH>
struct MmaSmem {
  static constexpr int kLd = DH + 8;  // bf16 row stride: 16-byte rows, conflict-free fragments
  static constexpr int kQu = 0;       // offsets in bf16 elements
  static constexpr int kQw = kQu + kMQ * kLd;
  static constexpr int kK = kQw + kMQ * kLd;
  static constexpr int kV = kK + kMK * kLd;
  static constexpr int kP = kV + kMK * kLd;
  static constexpr int kRawByte = 2 * (kP + kBand * kLd);
  static constexpr size_t kBytes = kRawByte + sizeof(float) * kMmaWarps * 16 * kRawLd;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + n_rows) of a row-major [*, DH] bf16 tensor into shared
// memory with row stride DH + 8; rows outside [0, row_end) become zeros
template <int DH>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int n_rows, int row_end) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n_rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks, row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0 && row < row_end)
      v = *reinterpret_cast<const uint4*>(src + (size_t)row * DH + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c * 8) = v;
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
relpos_attention_mma(const __nv_bfloat16* __restrict__ qu, const __nv_bfloat16* __restrict__ qw,
                     const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ p, const int* __restrict__ lengths,
                     float* __restrict__ out, int H, int Tlen, float scale) {
  using L = MmaSmem<DH>;
  constexpr int kLd = L::kLd;
  constexpr int kKSteps = DH / 16;
  constexpr int kOTiles = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sbase = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sQu = sbase + L::kQu;
  __nv_bfloat16* sQw = sbase + L::kQw;
  __nv_bfloat16* sK = sbase + L::kK;
  __nv_bfloat16* sV = sbase + L::kV;
  __nv_bfloat16* sP = sbase + L::kP;

  const int t0 = blockIdx.x * kMQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // fragment row group
  const int tig = lane % 4;  // thread in group
  float* sRaw = reinterpret_cast<float*>(smem + L::kRawByte) + warp * 16 * kRawLd;

  const size_t head = ((size_t)b * H + h) * (size_t)Tlen * DH;
  const int n_pos = 2 * Tlen - 1;
  const __nv_bfloat16* ph = p + (size_t)h * n_pos * DH;
  const int valid_len = min(lengths[b], Tlen);
  const int tw = t0 + 16 * warp;  // this warp's first query row

  stage_rows<DH>(sQu, qu + head, t0, kMQ, Tlen);
  stage_rows<DH>(sQw, qw + head, t0, kMQ, Tlen);

  float o[kOTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};

  const __nv_bfloat16* qa = sQu + 16 * warp * kLd + g * kLd + tig * 2;
  const __nv_bfloat16* qb = sQw + 16 * warp * kLd + g * kLd + tig * 2;
  // the warp's band starts (kMQ - 16) - 16 * warp rows into the block's band
  const __nv_bfloat16* pw = sP + (kMQ - 16 - 16 * warp) * kLd + g * kLd + tig * 2;
  const __nv_bfloat16* kb = sK + g * kLd + tig * 2;

  for (int s0 = 0; s0 < Tlen; s0 += kMK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<DH>(sK, k + head, s0, kMK, Tlen);
    stage_rows<DH>(sV, v + head, s0, kMK, Tlen);
    // p rows (T-1) + s - t for s in the key tile and t in the query tile
    stage_rows<DH>(sP, ph, (Tlen - 1) + s0 - (t0 + kMQ - 1), kBand, n_pos);
    __syncthreads();

    float sc[kMK / 8][4];    // ac, then scores, then probabilities
    float raw[kWarpBand / 8][4];  // (q+w) . p over the warp's band
#pragma unroll
    for (int nt = 0; nt < kMK / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kWarpBand / 8; ++nt)
      raw[nt][0] = raw[nt][1] = raw[nt][2] = raw[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int c = ks * 16;
      const uint32_t a[4] = {ld32(qa + c), ld32(qa + 8 * kLd + c), ld32(qa + c + 8),
                             ld32(qa + 8 * kLd + c + 8)};
      const uint32_t w[4] = {ld32(qb + c), ld32(qb + 8 * kLd + c), ld32(qb + c + 8),
                             ld32(qb + 8 * kLd + c + 8)};
#pragma unroll
      for (int nt = 0; nt < kMK / 8; ++nt) {
        const __nv_bfloat16* kr = kb + nt * 8 * kLd + c;
        mma_bf16(sc[nt], a, ld32(kr), ld32(kr + 8));
      }
#pragma unroll
      for (int nt = 0; nt < kWarpBand / 8; ++nt) {
        const __nv_bfloat16* pr = pw + nt * 8 * kLd + c;
        mma_bf16(raw[nt], w, ld32(pr), ld32(pr + 8));
      }
    }
    // band scores to shared memory, then read back along the diagonal:
    // bd[i][j] = raw[i][j - i + 15] for warp row i and tile key j
#pragma unroll
    for (int nt = 0; nt < kWarpBand / 8; ++nt) {
      const int u = nt * 8 + tig * 2;
      *reinterpret_cast<float2*>(sRaw + g * kRawLd + u) = make_float2(raw[nt][0], raw[nt][1]);
      *reinterpret_cast<float2*>(sRaw + (g + 8) * kRawLd + u) =
          make_float2(raw[nt][2], raw[nt][3]);
    }
    __syncwarp();

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kMK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + (e >> 1) * 8;
        const int j = nt * 8 + tig * 2 + (e & 1);
        const int s = s0 + j;
        const float bd = sRaw[i * kRawLd + (j - i + 15)];
        // columns past the key axis carry no weight; masked columns get f32
        // min like the reference (a row with no valid key averages uniformly)
        const float x = s >= Tlen ? -INFINITY : (s >= valid_len ? -FLT_MAX : (sc[nt][e] + bd) * scale);
        sc[nt][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      // every tile holds column s0 < T, so the new max is finite
      const float m_new = fmaxf(m_run[r], tile_max[r]);
      corr[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kMK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float e_x = expf(sc[nt][e] - m_run[e >> 1]);  // -inf -> 0
        sc[nt][e] = e_x;
        psum[e >> 1] += e_x;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_run[r] = l_run[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int nt = 0; nt < kOTiles; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }
    // P.V: two adjacent score tiles form one m16k16 A fragment
#pragma unroll
    for (int kk = 0; kk < kMK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const unsigned short* vr =
          reinterpret_cast<const unsigned short*>(sV + (kk * 16 + tig * 2) * kLd + g);
#pragma unroll
      for (int nt = 0; nt < kOTiles; ++nt) {
        const unsigned short* vc = vr + nt * 8;
        const uint32_t b0 = vc[0] | ((uint32_t)vc[kLd] << 16);
        const uint32_t b1 = vc[8 * kLd] | ((uint32_t)vc[9 * kLd] << 16);
        mma_bf16(o[nt], a, b0, b1);
      }
    }
  }

  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  const int r0 = tw + g, r1 = tw + g + 8;
#pragma unroll
  for (int nt = 0; nt < kOTiles; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (r0 < Tlen)
      *reinterpret_cast<float2*>(out + head + (size_t)r0 * DH + col) =
          make_float2(o[nt][0] * inv0, o[nt][1] * inv0);
    if (r1 < Tlen)
      *reinterpret_cast<float2*>(out + head + (size_t)r1 * DH + col) =
          make_float2(o[nt][2] * inv1, o[nt][3] * inv1);
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int kTQ = 16;                // query rows per block
constexpr int kTK = 32;                // key columns per inner tile
constexpr int kGroup = 8;              // threads that share one query row
constexpr int kThreads = kTQ * kGroup; // 128
constexpr int kKeysPerThread = kTK / kGroup;

template <int DH>
struct SimtSmem {
  static constexpr int kLd = DH + 1;  // padded row stride (floats)
  static constexpr int kQu = 0;
  static constexpr int kQw = kQu + kTQ * kLd;
  static constexpr int kK = kQw + kTQ * kLd;
  static constexpr int kV = kK + kTK * kLd;
  static constexpr int kP = kV + kTK * kLd;
  static constexpr int kS = kP + (kTQ + kTK - 1) * kLd;
  static constexpr int kSLd = kTK + 1;
  static constexpr int kFloats = kS + kTQ * kSLd;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
relpos_attention_simt(const float* __restrict__ qu, const float* __restrict__ qw,
                      const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ p, const int* __restrict__ lengths,
                      float* __restrict__ out, int H, int Tlen, float scale) {
  using L = SimtSmem<DH>;
  constexpr int kLd = L::kLd;
  constexpr int kDPerThread = DH / kGroup;
  extern __shared__ float fsmem[];
  float* sQu = fsmem + L::kQu;
  float* sQw = fsmem + L::kQw;
  float* sK = fsmem + L::kK;
  float* sV = fsmem + L::kV;
  float* sP = fsmem + L::kP;
  float* sS = fsmem + L::kS;

  const int t0 = blockIdx.x * kTQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / kGroup;  // query row inside the tile
  const int lane = tid % kGroup;

  const size_t head = ((size_t)b * H + h) * (size_t)Tlen * DH;
  const float* quh = qu + head;
  const float* qwh = qw + head;
  const float* kh = k + head;
  const float* vh = v + head;
  const int n_pos = 2 * Tlen - 1;
  const float* ph = p + (size_t)h * n_pos * DH;
  const int valid_len = min(lengths[b], Tlen);

  for (int i = tid; i < kTQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, t = t0 + r;
    sQu[r * kLd + d] = t < Tlen ? quh[(size_t)t * DH + d] : 0.f;
    sQw[r * kLd + d] = t < Tlen ? qwh[(size_t)t * DH + d] : 0.f;
  }

  float acc[kDPerThread];
#pragma unroll
  for (int j = 0; j < kDPerThread; ++j) acc[j] = 0.f;
  float m = -INFINITY;  // running max of this query row
  float l = 0.f;        // running softmax denominator

  for (int s0 = 0; s0 < Tlen; s0 += kTK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTK * DH; i += kThreads) {
      const int r = i / DH, d = i % DH, s = s0 + r;
      sK[r * kLd + d] = s < Tlen ? kh[(size_t)s * DH + d] : 0.f;
      sV[r * kLd + d] = s < Tlen ? vh[(size_t)s * DH + d] : 0.f;
    }
    // position rows this tile reads: (T-1) + s - t for s in the key tile and
    // t in the query tile, i.e. kTQ + kTK - 1 consecutive rows from pbase
    const int pbase = (Tlen - 1) + s0 - (t0 + kTQ - 1);
    for (int i = tid; i < (kTQ + kTK - 1) * DH; i += kThreads) {
      const int j = i / DH, d = i % DH, r = pbase + j;
      sP[j * kLd + d] = (r >= 0 && r < n_pos) ? ph[(size_t)r * DH + d] : 0.f;
    }
    __syncthreads();

    // scores of keys s0 + lane + kGroup*i for this thread's query row
    float ac[kKeysPerThread], bd[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) ac[i] = bd[i] = 0.f;
    const float* qa = sQu + row * kLd;
    const float* qb = sQw + row * kLd;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float a = qa[d], c = qb[d];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i) {
        const int sl = lane + kGroup * i;
        ac[i] = fmaf(a, sK[sl * kLd + d], ac[i]);
        // p row of (t, s) inside the tile: (s - s0) - (t - t0) + kTQ - 1
        bd[i] = fmaf(c, sP[(sl - row + kTQ - 1) * kLd + d], bd[i]);
      }
    }
    float sc[kKeysPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int s = s0 + lane + kGroup * i;
      sc[i] = s >= Tlen ? -INFINITY : (s >= valid_len ? -FLT_MAX : (ac[i] + bd[i]) * scale);
      tile_max = fmaxf(tile_max, sc[i]);
    }
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float e = expf(sc[i] - m_new);  // -inf -> 0
      sS[row * L::kSLd + lane + kGroup * i] = e;
      psum += e;
    }
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) acc[j] *= corr;
    __syncwarp();  // the row's probabilities come from lanes of this warp

    const int n_keys = min(kTK, Tlen - s0);
    for (int sl = 0; sl < n_keys; ++sl) {
      const float w = sS[row * L::kSLd + sl];
      const float* vr = sV + sl * kLd;
#pragma unroll
      for (int j = 0; j < kDPerThread; ++j) acc[j] = fmaf(w, vr[lane + kGroup * j], acc[j]);
    }
  }

  const int t = t0 + row;
  if (t < Tlen) {
    const float inv = 1.f / l;
    float* o = out + head + (size_t)t * DH;
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) o[lane + kGroup * j] = acc[j] * inv;
  }
}

// ----------------------------------------------------------------- launch

template <int DH>
cudaError_t launch(bool is_bf16, const void* qu, const void* qw, const void* k, const void* v,
                   const void* p, const void* lengths, void* out, int B, int H, int T_,
                   cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)DH);
  const int* lens = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (is_bf16) {
    using E = __nv_bfloat16;
    auto kernel = relpos_attention_mma<DH>;
    const size_t smem = MmaSmem<DH>::kBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T_ + kMQ - 1) / kMQ, H, B);
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const E*>(qu), static_cast<const E*>(qw), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const E*>(p), lens, o, H, T_, scale);
  } else {
    auto kernel = relpos_attention_simt<DH>;
    const size_t smem = SimtSmem<DH>::kBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T_ + kTQ - 1) / kTQ, H, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(qu), static_cast<const float*>(qw),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(p), lens, o, H, T_, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take). bf16 inputs
// must be 16-byte aligned.
extern "C" int relpos_attention_launch(const void* qu, const void* qw, const void* k,
                                       const void* v, const void* p, const void* lengths,
                                       void* out, int B, int H, int T, int Dh, int is_bf16,
                                       void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  switch (Dh) {
    case 16: return (int)launch<16>(bf, qu, qw, k, v, p, lengths, out, B, H, T, s);
    case 32: return (int)launch<32>(bf, qu, qw, k, v, p, lengths, out, B, H, T, s);
    case 48: return (int)launch<48>(bf, qu, qw, k, v, p, lengths, out, B, H, T, s);
    case 64: return (int)launch<64>(bf, qu, qw, k, v, p, lengths, out, B, H, T, s);
    case 80: return (int)launch<80>(bf, qu, qw, k, v, p, lengths, out, B, H, T, s);
    case 96: return (int)launch<96>(bf, qu, qw, k, v, p, lengths, out, B, H, T, s);
    case 112: return (int)launch<112>(bf, qu, qw, k, v, p, lengths, out, B, H, T, s);
    case 128: return (int)launch<128>(bf, qu, qw, k, v, p, lengths, out, B, H, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
