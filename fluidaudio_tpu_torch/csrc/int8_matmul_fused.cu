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
// x is [M,K] bf16 or f32, wq [N,K] int8 (K contiguous), s_col [N] f32, bias
// [N] f32 or none; out [M,N] bf16 or f32. Every rounding step is the
// reference's (`__fdiv_rn`, `rintf`, `__int2float_rn`, `__fmul_rn`,
// `__fadd_rn`: no contraction into an FMA), so the output equals the plain
// PyTorch version bit for bit.
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
//   N/256 column tiles would redo it. Instead one pass (`quantize_rows`,
//   one warp per row, 16-byte loads) reads x once and writes the int8 codes
//   and the row scales: half of x's bytes again, a fraction of what the
//   repeated quantisation would read.
// - The GEMM (`int8_gemm_dequant`) is one warp-specialised, persistent
//   kernel for every shape. Only `wgmma` reaches the full int8 rate, and it
//   takes 8-bit operands K-major from shared memory, which is how both xq
//   [M,K] and wq [N,K] lie in device memory. Warpgroup 0 is the producer: one
//   thread issues TMA loads (`cp.async.bulk.tensor`) of 128 x 128-byte x
//   tiles and 256 x 128-byte weight tiles, with the 128-byte swizzle, into a
//   ring of 4 stages (192 KB), each guarded by a full/empty `mbarrier` pair.
//   Warpgroups 1 and 2 each run `wgmma.m64n256k32.s32.s8.s8` on their 64
//   rows of a 128 x 256 output tile, 4 per stage, keeping 128 int32
//   accumulators a thread in registers (`setmaxnreg` moves registers from
//   the producer to them), and release a stage as soon as the products that
//   read it are done. One block per SM walks the output tiles N-fastest, so
//   the blocks in flight share a few M panels of x codes and all of the
//   weights (at most 4 MB) in the L2, and the producer loads the next tile's
//   stages during a tile's epilogue. Edges are TMA's zero fill: rows past M
//   or N and K past its end arrive as zero codes, which add nothing to the
//   exact sum.
// - The epilogue is not overlapped with the tensor cores, so it is kept
//   short: each warpgroup stages the tile's 256 column scales and biases in
//   shared memory once (loaded during the K loop), each warp dequantises its
//   16 rows in registers and passes them through its own shared-memory stage,
//   128 bytes of a row at a time, so that the device-memory writes are whole
//   16-byte vectors along rows (pairs written straight from the accumulator
//   layout, 8 rows x 16 bytes a warp, took longer than the products). Masked
//   at M and N; a row that is not 16-byte aligned (N * sizeof(out) % 16) is
//   written element by element.

#include <cuda.h>  // CUtensorMap and its enums only: the library links no libcuda
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

constexpr int kBM = 128;           // output rows per tile, 64 per consumer warpgroup
constexpr int kBN = 256;           // output columns per tile: one m64n256k32 per K step
constexpr int kBK = 128;           // K bytes per stage: one row of the 128-byte swizzle
constexpr int kStages = 4;
constexpr int kThreads = 384;      // warpgroup 0 loads, warpgroups 1 and 2 multiply
constexpr int kATile = kBM * kBK;  // 16 KB of x codes per stage
constexpr int kBTile = kBN * kBK;  // 32 KB of weight codes per stage
constexpr int kStageBytes = kATile + kBTile;
// |acc| <= K * 127^2 must stay below 2^31: the largest multiple of 16 that keeps it
constexpr int kMaxK = (0x7fffffff / (127 * 127)) / 16 * 16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// spins until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One TMA box (128 K bytes x the map's box rows, from K byte k and row `row`)
// into shared memory at dst; its bytes complete on bar. Elements past the
// tensor's end arrive as zeros, and count towards the bytes all the same.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// wgmma descriptor of a K-major tile as TMA writes it with the 128-byte
// swizzle: 128-byte rows, 8-row groups 1024 bytes apart (stride offset), the
// leading offset unused by this layout (1), layout type 1 (128-byte swizzle).
// The tile starts on a 1024-byte boundary, so the base offset is 0, and a
// step of 32 K bytes inside the swizzle row adds 2 to the address field.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256 s32, the warpgroup's accumulator) = A (64 x 32 s8) * B (256 x
// 32 s8)^T + (accumulate ? d : 0), both operands K-major in shared memory
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// keeps the compiler from moving accumulator accesses across a fence or a wait
__device__ __forceinline__ void pin(int* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ float dequant(int acc, float sr, float sc, bool has_bias, float b) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sr), sc);
  return has_bias ? __fadd_rn(v, b) : v;
}

__device__ __forceinline__ void put_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// How a warp's 16 output rows pass through its shared-memory stage: 128
// bytes of each row at a time, rows padded so that the accumulator pairs
// land in distinct banks, then read back and stored as 16-byte vectors.
template <typename OutT>
struct OutStage {
  static constexpr int kCols = 128 / sizeof(OutT);  // columns staged at a time
  static constexpr int kPer = 16 / sizeof(OutT);    // columns in one 16-byte store
  static constexpr int kLd = 128 + 8 * sizeof(OutT);  // staged row stride in bytes
};
constexpr int kWarpStageBytes = 16 * OutStage<float>::kLd;  // the larger of the two types
constexpr int kColBytes = 2 * kBN * 4;  // a consumer warpgroup's copy of the tile's s_col and bias
constexpr int kSmemBytes =
    kStages * kStageBytes + 8 * kWarpStageBytes + 2 * kColBytes + 1024;  // + 1 KB alignment

__device__ __forceinline__ void warpgroup_sync(int c) {  // named barrier 1 + c, 128 threads
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// Dequantises a warp's 16 x 256 slice of the accumulators (rows row0 ..
// row0 + 15, columns col0 .. col0 + 255) and writes it, masked at M and N.
// The m64nNk32 accumulator layout puts d[4i + 2h + j] at row lane / 4 + 8h
// of the warp's slice and column 8i + 2 * (lane % 4) + j. `cols` holds the
// tile's 256 column scales, then its 256 biases (zeros past N).
template <typename OutT>
__device__ __forceinline__ void store_tile(const int* d, uint8_t* stage, const float* cols,
                                           const float* __restrict__ s_row, bool has_bias,
                                           OutT* __restrict__ out, int M, int N, int row0,
                                           int col0, int lane) {
  using S = OutStage<OutT>;
  if (row0 >= M) return;
  const int g = lane / 4, t = lane % 4;
  float sr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) sr[h] = row0 + g + 8 * h < M ? s_row[row0 + g + 8 * h] : 0.f;
  const bool vec = (static_cast<size_t>(N) * sizeof(OutT)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
#pragma unroll
  for (int chunk = 0; chunk < kBN / S::kCols; ++chunk) {
    const int chunk_col = col0 + chunk * S::kCols;
    if (chunk_col >= N) break;
#pragma unroll
    for (int j = 0; j < S::kCols / 8; ++j) {
      const int i = chunk * (S::kCols / 8) + j;
      const float2 sc = *reinterpret_cast<const float2*>(cols + 8 * i + 2 * t);
      const float2 b = *reinterpret_cast<const float2*>(cols + kBN + 8 * i + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        put_pair(reinterpret_cast<OutT*>(stage + (g + 8 * h) * S::kLd) + 8 * j + 2 * t,
                 dequant(d[4 * i + 2 * h], sr[h], sc.x, has_bias, b.x),
                 dequant(d[4 * i + 2 * h + 1], sr[h], sc.y, has_bias, b.y));
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // 16 rows x 8 vectors, 4 per lane
      const int r = q * 4 + lane / 8, v = lane % 8;
      const int row = row0 + r, col = chunk_col + v * S::kPer;
      const uint4 bits = *reinterpret_cast<const uint4*>(stage + r * S::kLd + v * 16);
      if (row < M && col < N) {
        OutT* dst = out + static_cast<size_t>(row) * N + col;
        if (vec && col + S::kPer <= N) {
          *reinterpret_cast<uint4*>(dst) = bits;
        } else {
          const OutT* e = reinterpret_cast<const OutT*>(&bits);
#pragma unroll
          for (int k = 0; k < S::kPer; ++k) {
            if (col + k < N) dst[k] = e[k];
          }
        }
      }
    }
    __syncwarp();
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_dequant(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map, const float* __restrict__ s_row,
                  const float* __restrict__ s_col, const float* __restrict__ bias,
                  OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // kStages full, then kStages empty
  const uint32_t ring = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t full = smem_addr(bars), empty = full + 8 * kStages;  // + 8 * stage
  const uint32_t a_ring = ring, b_ring = ring + kStages * kATile;

  const int n_tiles = (N + kBN - 1) / kBN;
  const long long tiles = static_cast<long long>((M + kBM - 1) / kBM) * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrive, then the TMA bytes
      mbar_init(empty + 8 * s, 2);  // one arrive from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The stage ring is walked in the same order by both roles, tile after
  // tile: stage s is on its n-th use with parity n & 1, carried across tiles.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&x_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&w_map))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = static_cast<int>(t / n_tiles) * kBM;
        const int n0 = static_cast<int>(t % n_tiles) * kBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // the first use finds the stage free
          mbar_arrive_expect_tx(full + 8 * stage, kStageBytes);
          tma_load(a_ring + stage * kATile, &x_map, full + 8 * stage, kt * kBK, m0);
          tma_load(b_ring + stage * kBTile, &w_map, full + 8 * stage, kt * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // this warpgroup's rows: 64c .. 64c + 63 of each tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    uint8_t* const ring_ptr = smem + (ring - smem_addr(smem));
    uint8_t* const stage_out =
        ring_ptr + kStages * kStageBytes + (c * 4 + warp) * kWarpStageBytes;
    float* const cols =
        reinterpret_cast<float*>(ring_ptr + kStages * kStageBytes + 8 * kWarpStageBytes) +
        c * 2 * kBN;
    int stage = 0;
    uint32_t phase = 0;
    int d[128];
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = static_cast<int>(t / n_tiles) * kBM;
      const int n0 = static_cast<int>(t % n_tiles) * kBN;
      float col_vals[4];  // loaded now, staged after the K loop: s_col then bias at n0 + tid, + 128
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = n0 + tid + 128 * (k % 2);
        const float* src = k < 2 ? s_col : bias;
        col_vals[k] = src && col < N ? src[col] : 0.f;
      }
      int held = 0;  // the previous K step's stage, freed once its products are done
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        const uint64_t da = smem_desc(a_ring + stage * kATile + c * 64 * kBK);
        const uint64_t db = smem_desc(b_ring + stage * kBTile);
        pin(d);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks) {
          wgmma_s8(d, da + 2 * ks, db + 2 * ks, kt > 0 || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous K step's group is done with its stage
        pin(d);
        if (kt > 0 && tid == 0) mbar_arrive(empty + 8 * held);
        held = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      pin(d);
      if (tid == 0) mbar_arrive(empty + 8 * held);

      warpgroup_sync(c);  // every warp is done with the previous tile's columns
#pragma unroll
      for (int k = 0; k < 4; ++k) cols[tid + 128 * k] = col_vals[k];
      warpgroup_sync(c);
      store_tile(d, stage_out, cols, s_row, bias != nullptr, out, M, N, m0 + c * 64 + warp * 16,
                 n0, lane);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library links no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a [rows, K] int8 matrix, K contiguous, read in boxes of 128 K
// bytes x box_rows rows with the 128-byte swizzle and zero fill past its end.
bool encode_codes(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int K,
                  int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};  // bytes from row to row
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
cudaError_t launch_gemm(const void* xq, const float* s_row, const void* wq, const float* s_col,
                        const float* bias, OutT* out, int M, int N, int K, cudaStream_t s) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap x_map, w_map;
  if (!encode_codes(encode, &x_map, xq, M, K, kBM) ||
      !encode_codes(encode, &w_map, wq, N, K, kBN)) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(int8_gemm_dequant<OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // persistent: one block per SM
  int8_gemm_dequant<OutT><<<grid, kThreads, kSmemBytes, s>>>(x_map, w_map, s_row, s_col, bias,
                                                             out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the GEMM asks for at launch, in bytes.
extern "C" int int8_gemm_dequant_smem_bytes() { return kSmemBytes; }

// Launches both kernels on `stream`: x [M,K] (bf16 if x_is_bf16, else f32)
// -> scratch xq [M,K] int8 and s_row [M] f32 -> out [M,N] (bf16 if
// out_is_bf16, else f32). bias may be null. Does not synchronise, allocates
// nothing; returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape the kernels do not take). x, xq and wq
// must be 16-byte aligned, K a multiple of 16 and at most 133,136 (so that
// the int32 sum cannot overflow).
extern "C" int int8_matmul_fused_launch(const void* x, void* xq, void* s_row, const void* wq,
                                        const void* s_col, const void* bias, void* out, int M,
                                        int N, int K, int x_is_bf16, int out_is_bf16,
                                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || K > kMaxK) return cudaErrorInvalidValue;
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

  const auto* sr = static_cast<const float*>(s_row);
  const auto* sc = static_cast<const float*>(s_col);
  const auto* b = static_cast<const float*>(bias);
  if (out_is_bf16) {
    return launch_gemm(xq, sr, wq, sc, b, static_cast<__nv_bfloat16*>(out), M, N, K, s);
  }
  return launch_gemm(xq, sr, wq, sc, b, static_cast<float*>(out), M, N, K, s);
}
