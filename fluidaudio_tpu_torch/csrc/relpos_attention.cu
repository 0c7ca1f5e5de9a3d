// Transformer-XL relative-position attention for Hopper (sm_90a).
//
// Replaces fluidaudio_tpu/ops/attention_pallas.py::relpos_attention (Pallas
// body `_attn_kernel`, lines 49-98, called at 151). For every batch row b,
// head h and query t:
//
//   ac[t,s] = (q+u)[t] . k[s]
//   bd[t,s] = (q+w)[t] . p[(T-1) + s - t]      (the XL shift as a direct index)
//   score   = (ac + bd) * (1/sqrt(Dh)); key columns s >= min(len[b], T) get
//             -FLT_MAX, so a row with no valid key averages v uniformly
//   out[t]  = softmax_s(score) . v            (f32 softmax and accumulation)
//
// qu/qw/k/v are [B,H,T,Dh] views and p a [H,2T-1,Dh] view, bf16 or f32,
// with a contiguous last axis and any other strides (multiples of 16 bytes):
// the encoder hands over the transposes of its [B,T,H,Dh] projections as
// they lie. lengths is [B] int32. The output is a [B,H,T,Dh] view under the
// same rule, f32 or bf16 (rounded once, to nearest even). Dh is any multiple
// of 16 up to 128.
//
// What bounds it on an H100: at the v3 encoder's call (B=128, H=8, T=188,
// Dh=128) it reads 198 MB of bf16 and writes 49 MB of bf16, 0.074 ms at
// 3.35 TB/s; its three products are 27.8 GFLOP, 0.028 ms at 989 TFLOP/s. So
// the bytes bound it, and nothing of size [T, T] may leave the chip.
//
// What the design does about it (bf16, `relpos_attention_wgmma`):
// - One block per (64 query rows, h, b): 3 x 8 x 128 = 3,072 blocks at v3
//   (192 rows computed for 188), 256 threads. Warpgroup 0 is the producer:
//   one thread issues TMA loads (`cp.async.bulk.tensor`, 128-byte swizzle,
//   boxes of 64 columns, zero fill past Dh, past T and before row 0): the
//   block's qu and qw tiles once, then per 32-key tile its K and V tiles into
//   a ring of two stages guarded by full/empty mbarrier pairs. The tensor
//   maps are 4-D (Dh, T, H, B) over the caller's strides, so no copy is made.
// - The p rows a key tile needs form a 95-row band, (T-1) + s0 - (t0 + 63)
//   onwards, and the next tile's band is this one's moved on by 32 rows. So
//   p lives in a ring of four 32-row chunks: the first tile loads three, every
//   later tile one, with its K and V.
// - Warpgroup 1 owns the 64 query rows. Per key tile it runs
//   `wgmma.m64n32k16` for (q+u)K^T and three more, one per chunk, for (q+w)
//   times the band (both operands K-major from shared memory), with f32
//   accumulators in registers.
// - The XL shift stays a direct index: bd[i][j] = band[i][j - i + 63]. Each
//   thread writes the band values that some key column needs into a skewed
//   f32 stage (row i, column j - i + 63 -> j, padded rows of 40), and reads
//   them back at its own score positions. Row i lives in one warp, so a
//   __syncwarp orders the exchange.
// - The online softmax runs in registers on the accumulator layout (row
//   16w + l/4 + 8h, column 8i + 2(l%4) + j for register 4i + 2h + j). The
//   probabilities, rounded to bf16 as the Pallas kernel rounds them to v's
//   type, become the register A operand of `wgmma.m64nDk16` for P.V (the
//   accumulator layout of two 8-column groups is the A fragment of a 16-key
//   step); V comes from shared memory through the bf16 transpose bit.
// - The epilogue divides by the row sum and passes each warp's 16 rows
//   through a swizzled 2 KB shared-memory stage, 128 bytes of a row at a
//   time, so that device memory sees 16-byte stores along rows; f32 and
//   bf16 out run the same code up to the store, so bf16 out equals f32 out
//   rounded to bf16, bit for bit.
// - Budget at Dh 128 (Dh <= 64 takes one 64-column atom, half of each):
//   qu + qw 32 KB, two K/V stages of 16 KB, the p ring 32 KB, the skewed
//   band stage 10 KB: 107 KB with alignment, so two blocks (16 warps) share
//   an SM and one block's loads and epilogue run under the other's products.
//   ptxas (sm_90a): 128 registers at launch (the consumer raises its own to
//   216 with `setmaxnreg`), no spills; printed by `chip_smoke.py` phase 1.
// - What is left: each key tile is a chain (score products, band exchange,
//   softmax, P.V) that one warpgroup walks in order; `scripts/
//   torch_attention_probe.py` measures its cost per tile against the
//   tensor-core time (PERF.md).
//
// f32 (Sortformer, the converted f32 encoders, the f32 test fixtures): all
// arithmetic in f32 on the FP32 pipe (TF32 failed Dh 8 in the encoders, so
// it stays off). What bounds it: at Sortformer's offline windows (B 16, H 8,
// T 384, Dh 64) its three products are 7.2 GFLOP, 0.108 ms at 67 TFLOP/s,
// against 64 MB moved (0.019 ms at 3.35 TB/s); at its streaming chunks
// (B 1024, T 6) it moves 63 MB, 0.019 ms, for 0.11 GFLOP. So long T is
// bound by FMAs and short T by bytes, and the two get their own kernels.
// Both are built at Dh padded to 16, 32, 64 or 128 (the copies fill the
// columns past Dh with zeros, the stores skip them) and take the output
// type at run time: 8 instances in all, which keeps the build short.
//
// `relpos_attention_simt` (T > 16): one block of 256 threads per (64 query
// rows, h, b), key tiles of 64 (padded Dh <= 64) or 32 (padded Dh 128, to
// fit two stages in shared memory).
// - Register tiles. Thread (ty, tx) = (tid / 16, tid % 16) owns query rows
//   4ty .. 4ty + 3 and keys tx + 16j of a tile, and the output columns
//   4tx + 64c (padded Dh 64, 128) or tx + 16c. Q.K^T, the band product and
//   P.V read shared memory as float4: per 4 head columns 4 qu rows (a
//   broadcast in the half-warp) and 4 K rows feed 64 FMAs; per 4 keys 4
//   probability float4s and 4 V rows feed 4 x 4 x Dh/16. Rows are padded to
//   Dh + 4 floats, so the 8 lanes of a 16-byte load phase read 8 distinct
//   bank groups. (Measured at T 384, against this: two rows by eight keys a
//   thread, fewer shared-memory wavefronts but more load instructions, 20%
//   slower; persistent blocks that copy the next tile's inputs in during
//   the last step, no faster. It is bound by issue and latency, with one
//   block of 8 warps an SM, more than by shared memory or its start-up.)
// - The band. Tile kt of the 64 query rows needs p rows (T-1) + s - t, a
//   band of 64 + keys - 1 rows; the next tile's band is this one moved on by
//   one tile of keys. So step i computes one band chunk, qw . (p rows
//   pbase + i * keys ..), as a plain register-tiled product, into a ring
//   of 2 (or 3) chunks in shared memory (rows padded to 5 mod 8 floats, so
//   the two half-warps' reads land on different banks); the first step (or
//   two) fill the ring only. Every band value is computed once, which keeps
//   the FMAs at the three products' count. bd[t][s] is read back from ring
//   column (kt * keys + s - t + 63) mod ring: the XL shift as a direct
//   index. A half-warp writes and reads only its own rows of the ring and
//   of the probabilities, so __syncwarp orders both.
// - Copies. K, V and the band chunk of step i + 1 are `cp.async`ed (16
//   bytes, zero fill past T, before p row 0 and past 2T - 1) into the other
//   of two stages while step i computes; qu and qw arrive with step 0. One
//   barrier a step: the copies are issued after it, into the stage that
//   every thread has left.
// - The online softmax stays in registers (row max and sum over the 16
//   lanes of a half-warp by shuffles), with f32 expf; the output is divided
//   by the row sum once and stored as float4 (f32) or 4 bf16 (rounded once).
// - Budget: 191 KB of shared memory at Dh 64 and 204 KB at Dh 128, one block
//   (8 warps) per SM; ptxas's registers and spills are printed by
//   `chip_smoke.py` phase 1.
//
// `relpos_attention_short_simt` (T <= 16): a warp per (b, h) pair, so that
// a chunk of T 6 is not one 64-row block with 6 live rows. As many blocks of
// two warps as fit on the card at once; each warp walks its pairs, the next
// pair's qu, qw, k, v (T rows each) and p (2T - 1 rows) `cp.async`ed into
// the other of its two buffers while it computes this one, so the copies
// that bound it never stop. Per pair: every (t, s) score as two float4 dot
// products (one score per lane), each row's softmax on one lane, and P.V
// with lanes along Dh (V's column in registers), so that the output rows
// leave coalesced.

#include <cuda.h>  // CUtensorMap and its enums only: the library links no libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

// strides in elements of a [B, H, T, Dh] view along b, h and t
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ void put_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------- bf16 path

constexpr int kQRows = 64;      // query rows per block: one consumer warpgroup's
constexpr int kKeys = 32;       // keys per stage
constexpr int kBand = 96;       // p rows a key tile needs: kQRows + kKeys - 1, rounded up
constexpr int kStages = 2;      // K and V tiles in flight
// The band of a key tile is held as 3 chunks of kKeys p rows. The next tile's
// band is this one's moved on by kKeys rows, so each tile loads one new chunk
// into a ring of slots; a chunk is read by 3 tiles, and the slot it
// overwrites was last read kStages tiles before the one it is loaded for.
constexpr int kPChunks = kBand / kKeys;
constexpr int kPSlots = kPChunks - 1 + kStages;
constexpr int kThreads = 256;   // warpgroup 0 loads, warpgroup 1 computes
constexpr int kRowBytes = 128;  // one row of the 128-byte swizzle: 64 bf16
constexpr int kSkewLd = 40;     // f32 row stride of the skewed band stage

template <int DP>  // padded head width: 64 or 128, one or two 64-column atoms
struct Layout {
  static constexpr int kAtoms = DP / 64;
  static constexpr int kQTile = kAtoms * kQRows * kRowBytes;  // qu or qw
  static constexpr int kKTile = kAtoms * kKeys * kRowBytes;   // K or V
  static constexpr int kStageBytes = 2 * kKTile;              // K, then V
  static constexpr int kQu = 0;
  static constexpr int kQw = kQTile;
  static constexpr int kStage0 = 2 * kQTile;
  static constexpr int kP = kStage0 + kStages * kStageBytes;  // kPSlots chunks of kKTile bytes
  static constexpr int kSkew = kP + kPSlots * kKTile;
  static constexpr int kBytes = kSkew + kQRows * kSkewLd * 4 + 1024;  // + 1 KB alignment
};

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

// One TMA box into shared memory at dst; its bytes complete on bar. Elements
// outside the tensor (negative coordinates included) arrive as zeros, and
// count towards the bytes all the same.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma descriptor of a K-major tile as TMA writes it with the 128-byte
// swizzle: 128-byte rows, 8-row groups 1024 bytes apart (stride offset), the
// leading offset unused by this layout (1), layout type 1 (128-byte swizzle).
// Tiles start on 1024-byte boundaries (base offset 0); a step of 16 bf16
// (32 bytes) inside the swizzle row adds 2 to the address field.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same bytes read N-major (V as the B operand of P.V, keys along K): the
// 64-column atoms of one V tile are kKeys x 128 bytes apart (leading offset),
// 8-key groups 1024 bytes apart (stride offset).
__device__ __forceinline__ uint64_t nmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((kKeys * kRowBytes) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 32 f32) = A (64 x 16 bf16) * B (32 x 16 bf16)^T + (accumulate ? d : 0),
// both operands K-major in shared memory
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) = A (64 x 16 bf16, registers) * B (16 x 64 bf16), B N-major
// in shared memory (the transpose bit), + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_pv64(float* d, const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128 f32) = A (64 x 16 bf16, registers) * B (16 x 128 bf16), B N-major
// in shared memory (the transpose bit), + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_pv128(float* d, const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (DP == 64) {
    wgmma_pv64(d, a, b, accumulate);
  } else {
    wgmma_pv128(d, a, b, accumulate);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across a fence or a wait
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Writes a warp's 16 output rows (row0 .. row0 + 15 of the query axis)
// from the P.V accumulators, divided by the row sums: 128 bytes of each row
// at a time go through the warp's shared-memory stage (16-byte chunks XOR
// the row, so that neither side conflicts) and leave as 16-byte stores.
template <int DP, typename OutT>
__device__ __forceinline__ void store_rows(const float* o, const float (&inv)[2], uint8_t* stage,
                                           OutT* __restrict__ dst, long long row_stride,
                                           int row0, int T, int Dh, int lane) {
  constexpr int kCols = 128 / sizeof(OutT);  // columns staged at a time
  constexpr int kPer = 16 / sizeof(OutT);    // columns in one 16-byte store
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int chunk = 0; chunk < DP / kCols; ++chunk) {
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
      const int i = chunk * (kCols / 8) + jj;  // accumulator columns 8i .. 8i + 7
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh;
        const int byte = (8 * jj + 2 * t) * static_cast<int>(sizeof(OutT));
        OutT* p = reinterpret_cast<OutT*>(stage + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) +
                                          (byte & 15));
        put_pair(p, __fmul_rn(o[4 * i + 2 * hh], inv[hh]),
                 __fmul_rn(o[4 * i + 2 * hh + 1], inv[hh]));
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // 16 rows x 8 vectors, 4 per lane
      const int r = q * 4 + lane / 8, v = lane % 8;
      const uint4 bits = *reinterpret_cast<const uint4*>(stage + r * 128 + ((v ^ (r & 7)) << 4));
      const int row = row0 + r, col = chunk * kCols + v * kPer;
      if (row < T && col < Dh) {
        *reinterpret_cast<uint4*>(dst + row * row_stride + col) = bits;
      }
    }
  }
}

template <int DP, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
relpos_attention_wgmma(const __grid_constant__ CUtensorMap qu_map,
                       const __grid_constant__ CUtensorMap qw_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap p_map, const int* __restrict__ lengths,
                       OutT* __restrict__ out, Strides os, int T, int Dh, float scale) {
  using L = Layout<DP>;
  constexpr int kAtoms = L::kAtoms;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q, kStages full, kStages empty
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem + (base - smem_addr(smem));
  const uint32_t qbar = smem_addr(bars), full = qbar + 8, empty = full + 8 * kStages;

  const int t0 = blockIdx.x * kQRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T + kKeys - 1) / kKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrive, then the TMA bytes
      mbar_init(empty + 8 * s, 1);  // the consumer warpgroup's arrive
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&qu_map);
      prefetch_map(&qw_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      prefetch_map(&p_map);
      mbar_arrive_expect_tx(qbar, 2 * L::kQTile);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_4d(base + L::kQu + a * kQRows * kRowBytes, &qu_map, qbar, 64 * a, t0, h, b);
        tma_load_4d(base + L::kQw + a * kQRows * kRowBytes, &qw_map, qbar, 64 * a, t0, h, b);
      }
      const int p0 = (T - 1) - (t0 + kQRows - 1);  // p row of (t0 + 63, s = 0)
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s0 = kt * kKeys;
        const uint32_t st = base + L::kStage0 + stage * L::kStageBytes;
        const uint32_t bar = full + 8 * stage;
        // the first tile loads chunks 0 .. 2 of the p band, every later one chunk kt + 2
        const int n0 = kt == 0 ? 0 : kt + kPChunks - 1;
        const int n1 = kt + kPChunks;
        mbar_wait(empty + 8 * stage, phase ^ 1);  // the first use finds the stage free
        mbar_arrive_expect_tx(bar, L::kStageBytes + (n1 - n0) * L::kKTile);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_4d(st + a * kKeys * kRowBytes, &k_map, bar, 64 * a, s0, h, b);
          tma_load_4d(st + L::kKTile + a * kKeys * kRowBytes, &v_map, bar, 64 * a, s0, h, b);
          for (int n = n0; n < n1; ++n) {  // chunk n: p rows p0 + 32n .., slot n % kPSlots
            tma_load_3d(base + L::kP + (n % kPSlots) * L::kKTile + a * kKeys * kRowBytes, &p_map,
                        bar, 64 * a, p0 + kKeys * n, h);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int valid_len = min(lengths[b], T);
    float* const skew = reinterpret_cast<float*>(base_ptr + L::kSkew);
    const uint32_t qa = base + L::kQu, qb = base + L::kQw;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows 16 warp + g and + 8
    float l_run[2] = {0.f, 0.f};

    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s0 = kt * kKeys;
      const uint32_t st = base + L::kStage0 + stage * L::kStageBytes;
      mbar_wait(full + 8 * stage, phase);

      float sc[kKeys / 2];   // (q+u).k, then scores, then probabilities
      float bd[kBand / 2];  // (q+w).p over the band: chunks kt .. kt + 2, row j - i + 63
      wgmma_fence();
// step ks covers head columns 16ks .. 16ks + 15: atom ks / 4, 32 bytes into its rows
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_n32(sc, kmajor_desc(qa + (ks / 4) * kQRows * kRowBytes + col),
                  kmajor_desc(st + (ks / 4) * kKeys * kRowBytes + col), ks > 0);
      }
#pragma unroll
      for (int q = 0; q < kPChunks; ++q) {  // band rows 32q .. 32q + 31
        const uint32_t chunk = base + L::kP + ((kt + q) % kPSlots) * L::kKTile;
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          const uint32_t col = (ks % 4) * 32;
          wgmma_n32(bd + q * kKeys / 2, kmajor_desc(qb + (ks / 4) * kQRows * kRowBytes + col),
                    kmajor_desc(chunk + (ks / 4) * kKeys * kRowBytes + col), ks > 0);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      pin<kKeys / 2>(sc);
      pin<kBand / 2>(bd);

      // band values to the skewed stage: row r, band column u -> key column
      // u - 63 + r; then each thread reads bd at its own score positions
      __syncwarp();  // this warp's reads of the previous tile are done
#pragma unroll
      for (int i = 0; i < kBand / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * warp + g + 8 * (e >> 1);
          const int j = 8 * i + 2 * t + (e & 1) - 63 + r;
          if (j >= 0 && j < kKeys) skew[r * kSkewLd + j] = bd[4 * i + e];
        }
      }
      __syncwarp();

      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * warp + g + 8 * hh;
          const float2 band = *reinterpret_cast<const float2*>(skew + r * kSkewLd + 8 * i + 2 * t);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int s = s0 + 8 * i + 2 * t + j;
            float& x = sc[4 * i + 2 * hh + j];
            // columns past the key axis carry no weight; masked columns get f32
            // min like the reference (a row with no valid key averages uniformly)
            x = s >= T ? -INFINITY
                       : (s >= valid_len ? -FLT_MAX
                                         : __fmul_rn(__fadd_rn(x, j ? band.y : band.x), scale));
            tile_max[hh] = fmaxf(tile_max[hh], x);
          }
        }
      }
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tile_max[hh] = fmaxf(tile_max[hh], __shfl_xor_sync(0xffffffffu, tile_max[hh], 1));
        tile_max[hh] = fmaxf(tile_max[hh], __shfl_xor_sync(0xffffffffu, tile_max[hh], 2));
        // every tile holds column s0 < T, so the new max is finite
        const float m_new = fmaxf(m_run[hh], tile_max[hh]);
        corr[hh] = expf(__fsub_rn(m_run[hh], m_new));
        m_run[hh] = m_new;
      }
#pragma unroll
      for (int e = 0; e < kKeys / 2; ++e) {
        const float e_x = expf(__fsub_rn(sc[e], m_run[(e >> 1) & 1]));  // -inf -> 0
        sc[e] = e_x;
        psum[(e >> 1) & 1] = __fadd_rn(psum[(e >> 1) & 1], e_x);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        psum[hh] = __fadd_rn(psum[hh], __shfl_xor_sync(0xffffffffu, psum[hh], 1));
        psum[hh] = __fadd_rn(psum[hh], __shfl_xor_sync(0xffffffffu, psum[hh], 2));
        l_run[hh] = __fadd_rn(__fmul_rn(l_run[hh], corr[hh]), psum[hh]);
      }
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * i + e] = __fmul_rn(o[4 * i + e], corr[e >> 1]);
      }
      // P.V: score columns 16kk .. 16kk + 15 form the A fragment of one step
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_pv<DP>(o, pa[kk], nmajor_desc(st + L::kKTile + kk * 16 * kRowBytes), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      pin<DP / 2>(o);
      if (tid == 0) mbar_arrive(empty + 8 * stage);  // K, V and the band are read
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const float inv[2] = {__frcp_rn(l_run[0]), __frcp_rn(l_run[1])};
    // the warp's own 16 rows of the skewed stage (2,560 bytes) hold its output stage
    uint8_t* const stage_out = reinterpret_cast<uint8_t*>(skew + 16 * warp * kSkewLd);
    store_rows<DP>(o, inv, stage_out, out + b * os.b + h * os.h, os.t, t0 + 16 * warp, T, Dh,
                   lane);
  }
}

// ----------------------------------------------------------------- f32 path

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool valid) {
  // a source size of 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + rows - 1 of an [n, cols] f32 view (rows `stride` elements
// apart, cols contiguous) into shared memory at dst as rows of DP floats
// (DP >= cols), ld floats apart, in 16-byte cp.async copies shared out over
// `threads` threads; rows outside [0, n) and columns past cols arrive as
// zeros.
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long stride,
                                          int r0, int rows, int n, int cols, int tid,
                                          int threads) {
  constexpr int kChunks = DP / 4;
  for (int c = tid; c < rows * kChunks; c += threads) {
    const int r = c / kChunks, q = c % kChunks, row = r0 + r;
    const bool ok = row >= 0 && row < n && 4 * q < cols;
    cp_async16(smem_addr(dst + r * ld + 4 * q), ok ? src + row * stride + 4 * q : src, ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ float lane_of(float4 a, int e) {
  return e == 0 ? a.x : (e == 1 ? a.y : (e == 2 ? a.z : a.w));
}
__device__ __forceinline__ void put4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 bits;
  bits.x = *reinterpret_cast<uint32_t*>(&lo);
  bits.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = bits;
}
// element i of an output that is bf16 or f32 at run time: one instance of
// each f32 kernel serves both
__device__ __forceinline__ void put_at(void* out, bool bf16, long long i, float a) {
  if (bf16) {
    put(static_cast<__nv_bfloat16*>(out) + i, a);
  } else {
    put(static_cast<float*>(out) + i, a);
  }
}
__device__ __forceinline__ void put4_at(void* out, bool bf16, long long i, float a, float b,
                                        float c, float d) {
  if (bf16) {
    put4(static_cast<__nv_bfloat16*>(out) + i, a, b, c, d);
  } else {
    put4(static_cast<float*>(out) + i, a, b, c, d);
  }
}

constexpr int kF32Rows = 64;      // query rows per block
constexpr int kF32Threads = 256;  // thread (ty, tx) = (tid / kLanes, tid % kLanes)
constexpr int kRpt = 4;           // query rows per thread: rows kRpt * ty ..
constexpr int kLanes = 4 * kRpt;  // lanes that share rows: a warp holds 8 rows

template <int D>  // D: the padded head width, 16, 32, 64 or 128
struct F32Plan {
  static constexpr int kKeys = D <= 64 ? 64 : 32;       // keys per tile
  static constexpr int kKpt = kKeys / kLanes;            // keys (and band columns) per thread
  static constexpr int kChunks = kF32Rows / kKeys + 1;   // band chunks of kKeys p rows a tile reads
  static constexpr int kRing = kChunks * kKeys;          // band ring columns
  static constexpr int kLd = D + 4;                      // floats per row of a Q, K, V or p tile
  static constexpr int kLdBand = kRing + 5;              // 5 mod 8: see the header
  static constexpr int kLdProb = kKeys + 4;
  static constexpr int kQu = 0;
  static constexpr int kQw = kQu + kF32Rows * kLd;
  static constexpr int kStage0 = kQw + kF32Rows * kLd;  // two stages of K, V and a p chunk
  static constexpr int kStage = 3 * kKeys * kLd;
  static constexpr int kBand = kStage0 + 2 * kStage;
  static constexpr int kProb = kBand + kF32Rows * kLdBand;
  static constexpr int kBytes = 4 * (kProb + kF32Rows * kLdProb);
};

// g[r][j] = qw row kRpt ty + r . band row tx + kLanes j and, with kScores,
// ac[r][j] = qu row kRpt ty + r . k row tx + kLanes j: rows of D + 4 floats
// in shared memory, read as float4 (each load feeds 4 kKpt or 4 kRpt FMAs).
template <int D, int kKpt, bool kScores>
__device__ __forceinline__ void row_products(const float* qw, const float* pc, const float* qu,
                                             const float* kt, float (&g)[kRpt][kKpt],
                                             float (&ac)[kRpt][kKpt], int ty, int tx) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
#pragma unroll
    for (int j = 0; j < kKpt; ++j) g[r][j] = ac[r][j] = 0.f;
  }
  // the operands of head columns d .. d + 3, loaded one step ahead of
  // their FMAs, so that shared-memory latency hides under the products
  float4 a[2][kRpt], c[2][kKpt], u[2][kRpt], w[2][kKpt];
#pragma unroll
  for (int d = 0; d < D + 4; d += 4) {
    const int nb = (d / 4) & 1;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < kRpt; ++r) a[nb][r] = ld4(qw + (kRpt * ty + r) * kLd + d);
#pragma unroll
      for (int j = 0; j < kKpt; ++j) c[nb][j] = ld4(pc + (tx + kLanes * j) * kLd + d);
      if constexpr (kScores) {
#pragma unroll
        for (int r = 0; r < kRpt; ++r) u[nb][r] = ld4(qu + (kRpt * ty + r) * kLd + d);
#pragma unroll
        for (int j = 0; j < kKpt; ++j) w[nb][j] = ld4(kt + (tx + kLanes * j) * kLd + d);
      }
    }
    if (d > 0) {
      const int cb = nb ^ 1;
#pragma unroll
      for (int r = 0; r < kRpt; ++r) {
#pragma unroll
        for (int j = 0; j < kKpt; ++j) g[r][j] = dot4(a[cb][r], c[cb][j], g[r][j]);
      }
      if constexpr (kScores) {
#pragma unroll
        for (int r = 0; r < kRpt; ++r) {
#pragma unroll
          for (int j = 0; j < kKpt; ++j) ac[r][j] = dot4(u[cb][r], w[cb][j], ac[r][j]);
        }
      }
    }
  }
}

template <int D>  // head width Dh <= D, padded with zero columns
__global__ void __launch_bounds__(kF32Threads, 1)
relpos_attention_simt(const float* __restrict__ qu, const float* __restrict__ qw,
                      const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ p, const int* __restrict__ lengths,
                      void* __restrict__ out, bool out_bf16, Strides squ, Strides sqw,
                      Strides sk, Strides sv, Strides so, long long p_h, long long p_row, int T,
                      int Dh, float scale) {
  using L = F32Plan<D>;
  constexpr int kKeys = L::kKeys, kKpt = L::kKpt, kChunks = L::kChunks, kLd = L::kLd;
  constexpr int kCols = D / kLanes;  // output columns per thread
  extern __shared__ __align__(16) float fsm[];
  const int t0 = blockIdx.x * kF32Rows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / kLanes, tx = tid % kLanes;
  const float* const kh = k + b * sk.b + h * sk.h;
  const float* const vh = v + b * sv.b + h * sv.h;
  const float* const ph = p + h * p_h;
  const int n_pos = 2 * T - 1;
  const int valid_len = min(lengths[b], T);
  const int n_tiles = (T + kKeys - 1) / kKeys;
  // step i computes band chunk i and, from step kChunks - 1 on, key tile
  // i - (kChunks - 1): the first steps fill the band ring only
  const int n_steps = n_tiles + kChunks - 1;
  const int pbase = (T - 1) - t0 - (kF32Rows - 1);  // p row of band column 0 in key tile 0
  float* const band = fsm + L::kBand;
  float* const prob = fsm + L::kProb;

  load_rows<D>(fsm + L::kQu, kLd, qu + b * squ.b + h * squ.h, squ.t, t0, kF32Rows, T, Dh, tid,
               kF32Threads);
  load_rows<D>(fsm + L::kQw, kLd, qw + b * sqw.b + h * sqw.h, sqw.t, t0, kF32Rows, T, Dh, tid,
               kF32Threads);
  auto load_step = [&](int i) {  // K and V of key tile i - (kChunks - 1), band chunk i
    float* const st = fsm + L::kStage0 + (i & 1) * L::kStage;
    const int kt = i - (kChunks - 1);
    if (kt >= 0) {
      load_rows<D>(st, kLd, kh, sk.t, kt * kKeys, kKeys, T, Dh, tid, kF32Threads);
      load_rows<D>(st + kKeys * kLd, kLd, vh, sv.t, kt * kKeys, kKeys, T, Dh, tid, kF32Threads);
    }
    load_rows<D>(st + 2 * kKeys * kLd, kLd, ph, p_row, pbase + i * kKeys, kKeys, n_pos, Dh, tid,
                 kF32Threads);
    cp_async_commit();
  };

  float o[kRpt][kCols];
  float m_run[kRpt], l_run[kRpt];
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[r][c] = 0.f;
  }

  load_step(0);  // with qu and qw
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<0>();
    // one barrier a step: step i's copies have landed for every thread, and
    // every thread is done with step i - 1, whose stage step i + 1 fills
    __syncthreads();
    if (i + 1 < n_steps) load_step(i + 1);
    const float* const st = fsm + L::kStage0 + (i & 1) * L::kStage;
    const int kt = i - (kChunks - 1);
    float g[kRpt][kKpt], ac[kRpt][kKpt];
    if (kt < 0) {
      row_products<D, kKpt, false>(fsm + L::kQw, st + 2 * kKeys * kLd, nullptr, nullptr, g, ac,
                                   ty, tx);
    } else {
      row_products<D, kKpt, true>(fsm + L::kQw, st + 2 * kKeys * kLd, fsm + L::kQu, st, g, ac,
                                  ty, tx);
    }
    // band chunk i into ring slot i % kChunks. The thread's rows are
    // written and read by its kLanes lanes alone, so a __syncwarp orders it.
    const int slot = (i % kChunks) * kKeys;
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
#pragma unroll
      for (int j = 0; j < kKpt; ++j) {
        band[(kRpt * ty + r) * L::kLdBand + slot + tx + kLanes * j] = g[r][j];
      }
    }
    __syncwarp();
    if (kt >= 0) {
      const int s0 = kt * kKeys;
      // bd[t][s] is band column s - t + 63 of this tile, ring column
      // (kt * kKeys + s - t + 63) mod kRing: the XL shift as a direct index
      const int ring0 = (kt % kChunks) * kKeys + kF32Rows - 1;
#pragma unroll
      for (int r = 0; r < kRpt; ++r) {
        const int t = kRpt * ty + r;
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKpt; ++j) {
          const int s = tx + kLanes * j;
          int col = ring0 + s - t;
          if (col >= L::kRing) col -= L::kRing;
          const int sg = s0 + s;
          // keys past T carry no weight; masked keys get f32 min like the
          // reference (a row with no valid key averages uniformly)
          const float bd = band[t * L::kLdBand + col];
          const float x = sg >= T ? -INFINITY
                                  : (sg >= valid_len ? -FLT_MAX : (ac[r][j] + bd) * scale);
          ac[r][j] = x;
          tile_max = fmaxf(tile_max, x);
        }
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1) {
          tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
        }
        const float m_new = fmaxf(m_run[r], tile_max);  // finite: key s0 < T is in the tile
        const float corr = expf(m_run[r] - m_new);
        m_run[r] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < kKpt; ++j) {
          const float e = expf(ac[r][j] - m_new);  // -inf -> 0
          prob[t * L::kLdProb + tx + kLanes * j] = e;
          psum += e;
        }
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1) {
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        }
        l_run[r] = l_run[r] * corr + psum;
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[r][c] *= corr;
      }
      __syncwarp();  // the thread's rows of prob are written

      // P.V: per 4 keys, kRpt float4 of P (broadcast among the kLanes
      // lanes) and 4 rows of V feed 4 x kRpt x kCols FMAs
      const float* const sv_tile = st + kKeys * kLd;
#pragma unroll
      for (int s = 0; s < kKeys; s += 4) {
        float4 pr[kRpt];
#pragma unroll
        for (int r = 0; r < kRpt; ++r) pr[r] = ld4(prob + (kRpt * ty + r) * L::kLdProb + s);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* const vr = sv_tile + (s + e) * kLd;
          float vv[kCols];
          if constexpr (D % (4 * kLanes) == 0) {  // columns 4 kLanes c + 4tx .. + 3: float4
#pragma unroll
            for (int c = 0; c < D / (4 * kLanes); ++c) {
              const float4 x = ld4(vr + 4 * kLanes * c + 4 * tx);
              vv[4 * c] = x.x;
              vv[4 * c + 1] = x.y;
              vv[4 * c + 2] = x.z;
              vv[4 * c + 3] = x.w;
            }
          } else {  // columns tx + kLanes c
#pragma unroll
            for (int c = 0; c < kCols; ++c) vv[c] = vr[tx + kLanes * c];
          }
#pragma unroll
          for (int r = 0; r < kRpt; ++r) {
            const float w = lane_of(pr[r], e);
#pragma unroll
            for (int c = 0; c < kCols; ++c) o[r][c] = fmaf(w, vv[c], o[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    const int t = t0 + kRpt * ty + r;
    if (t >= T) continue;
    const float inv = 1.f / l_run[r];
    const long long row = b * so.b + h * so.h + t * so.t;
    if constexpr (D % (4 * kLanes) == 0) {  // Dh is a multiple of 16: a group of 4 is in or out
#pragma unroll
      for (int c = 0; c < D / (4 * kLanes); ++c) {
        const int col = 4 * kLanes * c + 4 * tx;
        if (col < Dh) {
          put4_at(out, out_bf16, row + col, o[r][4 * c] * inv, o[r][4 * c + 1] * inv,
                  o[r][4 * c + 2] * inv, o[r][4 * c + 3] * inv);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (tx + kLanes * c < Dh) put_at(out, out_bf16, row + tx + kLanes * c, o[r][c] * inv);
      }
    }
  }
}

// short T: each warp walks (b, h) pairs, one at a time, with the next
// pair's copy in flight
constexpr int kShortT = 16;  // T at or below takes relpos_attention_short_simt
constexpr int kShortWarps = 2;

// floats of one pair's shared memory: qu, qw, k, v (T rows each), p (2T - 1
// rows), the T x (T + 1) probabilities, rounded up to whole float4s
__host__ __device__ constexpr int short_floats(int D, int T) {
  return ((6 * T - 1) * (D + 4) + T * (T + 1) + 3) / 4 * 4;
}

template <int D>
__device__ __forceinline__ void short_load(float* dst, const float* qu, const float* qw,
                                           const float* k, const float* v, const float* p,
                                           const Strides& squ, const Strides& sqw,
                                           const Strides& sk, const Strides& sv, long long p_h,
                                           long long p_row, int b, int h, int T, int Dh,
                                           int lane) {
  constexpr int kLd = D + 4;
  load_rows<D>(dst, kLd, qu + b * squ.b + h * squ.h, squ.t, 0, T, T, Dh, lane, 32);
  load_rows<D>(dst + T * kLd, kLd, qw + b * sqw.b + h * sqw.h, sqw.t, 0, T, T, Dh, lane, 32);
  load_rows<D>(dst + 2 * T * kLd, kLd, k + b * sk.b + h * sk.h, sk.t, 0, T, T, Dh, lane, 32);
  load_rows<D>(dst + 3 * T * kLd, kLd, v + b * sv.b + h * sv.h, sv.t, 0, T, T, Dh, lane, 32);
  load_rows<D>(dst + 4 * T * kLd, kLd, p + h * p_h, p_row, 0, 2 * T - 1, 2 * T - 1, Dh, lane,
               32);
  cp_async_commit();
}

template <int D>  // head width Dh <= D, padded with zero columns
__global__ void __launch_bounds__(32 * kShortWarps)
relpos_attention_short_simt(const float* __restrict__ qu, const float* __restrict__ qw,
                            const float* __restrict__ k, const float* __restrict__ v,
                            const float* __restrict__ p, const int* __restrict__ lengths,
                            void* __restrict__ out, bool out_bf16, Strides squ, Strides sqw,
                            Strides sk, Strides sv, Strides so, long long p_h, long long p_row,
                            int B, int H, int T, int Dh, float scale) {
  constexpr int kLd = D + 4;
  extern __shared__ __align__(16) float fsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = short_floats(D, T);
  const long long pairs = static_cast<long long>(B) * H;
  const long long stride = static_cast<long long>(gridDim.x) * kShortWarps;
  long long pair = static_cast<long long>(blockIdx.x) * kShortWarps + warp;
  if (pair < pairs) {
    short_load<D>(fsm + 2 * warp * per, qu, qw, k, v, p, squ, sqw, sk, sv, p_h, p_row,
                  static_cast<int>(pair / H), static_cast<int>(pair % H), T, Dh, lane);
  }
  for (int it = 0; pair < pairs; ++it, pair += stride) {  // no block-wide barrier below
    const long long next = pair + stride;
    if (next < pairs) {  // into the buffer that the previous pair used
      short_load<D>(fsm + (2 * warp + ((it + 1) & 1)) * per, qu, qw, k, v, p, squ, sqw, sk, sv,
                    p_h, p_row, static_cast<int>(next / H), static_cast<int>(next % H), T, Dh,
                    lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int b = static_cast<int>(pair / H), h = static_cast<int>(pair % H);
    float* const sqa = fsm + (2 * warp + (it & 1)) * per;
    float* const sqb = sqa + T * kLd;
    float* const skk = sqb + T * kLd;
    float* const svv = skk + T * kLd;
    float* const spp = svv + T * kLd;
    float* const prob = spp + (2 * T - 1) * kLd;  // row t: T values, then 1 / their sum

    const int valid_len = min(lengths[b], T);
    for (int e = lane; e < T * T; e += 32) {  // one (t, s) score per lane and pass
      const int t = e / T, s = e % T;
      const float* const a = sqa + t * kLd;
      const float* const kr = skk + s * kLd;
      const float* const w = sqb + t * kLd;
      const float* const pr = spp + (T - 1 + s - t) * kLd;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const int q = (d / 4) % 2;
        acc[q] = dot4(ld4(a + d), ld4(kr + d), acc[q]);
        acc[2 + q] = dot4(ld4(w + d), ld4(pr + d), acc[2 + q]);
      }
      const float x = ((acc[0] + acc[1]) + (acc[2] + acc[3])) * scale;
      prob[t * (T + 1) + s] = s < valid_len ? x : -FLT_MAX;
    }
    __syncwarp();
    if (lane < T) {  // row `lane`'s softmax, unnormalised
      float* const row = prob + lane * (T + 1);
      float m = -INFINITY;
      for (int s = 0; s < T; ++s) m = fmaxf(m, row[s]);
      float l = 0.f;
      for (int s = 0; s < T; ++s) {
        const float e = expf(row[s] - m);
        row[s] = e;
        l += e;
      }
      row[T] = 1.f / l;
    }
    __syncwarp();
    const long long dst = b * so.b + h * so.h;
    for (int c = lane; c < D; c += 32) {  // lanes along Dh: the stores leave coalesced
      if (c >= Dh) break;
      float vc[kShortT];
#pragma unroll
      for (int s = 0; s < kShortT; ++s) vc[s] = s < T ? svv[s * kLd + c] : 0.f;
      for (int t = 0; t < T; ++t) {
        const float* const row = prob + t * (T + 1);
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < kShortT; ++s) {
          if (s < T) acc = fmaf(row[s], vc[s], acc);
        }
        put_at(out, out_bf16, dst + t * so.t + c, acc * row[T]);
      }
    }
    __syncwarp();  // this buffer is refilled at the next pair but one
  }
}

// ----------------------------------------------------------------- launch

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

// The map of a bf16 tensor of `rank` axes, innermost first (the innermost
// contiguous, the others at `strides` elements), read in boxes of 64
// elements x box_rows rows (x 1 on the outer axes) with the 128-byte
// swizzle and zero fill outside the tensor.
bool encode_bf16(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rank,
                 const long long* dims, const long long* strides, int box_rows) {
  cuuint64_t d[4], s[3];
  cuuint32_t box[4], elem[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    box[i] = i == 0 ? 64 : (i == 1 ? box_rows : 1);
    elem[i] = 1;
    if (i > 0) s[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * 2;  // bytes
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, s, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, typename OutT>
cudaError_t launch_wgmma(const void* qu, const void* qw, const void* k, const void* v,
                         const void* p, const int* lengths, OutT* out, const Strides* st,
                         long long p_h, long long p_row, int B, int H, int T, int Dh,
                         float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap maps[5];
  const void* ptrs[4] = {qu, qw, k, v};
  const int rows[4] = {kQRows, kQRows, kKeys, kKeys};
  for (int i = 0; i < 4; ++i) {
    const long long dims[4] = {Dh, T, H, B};
    const long long strides[3] = {st[i].t, st[i].h, st[i].b};
    if (!encode_bf16(encode, &maps[i], ptrs[i], 4, dims, strides, rows[i])) {
      return cudaErrorInvalidValue;
    }
  }
  const long long p_dims[3] = {Dh, 2LL * T - 1, H};
  const long long p_strides[2] = {p_row, p_h};
  if (!encode_bf16(encode, &maps[4], p, 3, p_dims, p_strides, kKeys)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = relpos_attention_wgmma<DP, OutT>;
  const int smem = Layout<DP>::kBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kQRows - 1) / kQRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], lengths,
                                           out, st[4], T, Dh, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_simt(const void* qu, const void* qw, const void* k, const void* v,
                        const void* p, const int* lengths, void* out, bool out_bf16,
                        const Strides* st, long long p_h, long long p_row, int B, int H, int T,
                        int Dh, float scale, cudaStream_t stream) {
  const float* const a = static_cast<const float*>(qu);
  const float* const w = static_cast<const float*>(qw);
  const float* const kk = static_cast<const float*>(k);
  const float* const vv = static_cast<const float*>(v);
  const float* const pp = static_cast<const float*>(p);
  if (T <= kShortT) {
    auto kernel = relpos_attention_short_simt<D>;
    const int smem = static_cast<int>(sizeof(float)) * 2 * kShortWarps * short_floats(D, T);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int device = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kShortWarps, smem);
    }
    if (err != cudaSuccess) return err;
    // as many blocks as fit at once (each warp then walks its pairs), no more than the pairs
    const long long needed = (static_cast<long long>(B) * H + kShortWarps - 1) / kShortWarps;
    const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    const long long blocks = needed < resident ? needed : resident;
    kernel<<<static_cast<unsigned>(blocks), 32 * kShortWarps, smem, stream>>>(
        a, w, kk, vv, pp, lengths, out, out_bf16, st[0], st[1], st[2], st[3], st[4], p_h, p_row,
        B, H, T, Dh, scale);
  } else {
    auto kernel = relpos_attention_simt<D>;
    const int smem = F32Plan<D>::kBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T + kF32Rows - 1) / kF32Rows, H, B);
    kernel<<<grid, kF32Threads, smem, stream>>>(a, w, kk, vv, pp, lengths, out, out_bf16, st[0],
                                                st[1], st[2], st[3], st[4], p_h, p_row, T, Dh,
                                                scale);
  }
  return cudaGetLastError();
}

// f32 inputs: the kernels at Dh padded to 16, 32, 64 or 128 (Dh 48 runs as
// 64, 80-112 as 128; no model of the repo has those widths)
cudaError_t launch_f32(const void* qu, const void* qw, const void* k, const void* v,
                       const void* p, const int* lengths, void* out, bool out_bf16,
                       const Strides* st, long long p_h, long long p_row, int B, int H, int T,
                       int Dh, cudaStream_t s) {
  const float scale = 1.0f / sqrtf((float)Dh);
  if (Dh <= 16) {
    return launch_simt<16>(qu, qw, k, v, p, lengths, out, out_bf16, st, p_h, p_row, B, H, T, Dh,
                           scale, s);
  }
  if (Dh <= 32) {
    return launch_simt<32>(qu, qw, k, v, p, lengths, out, out_bf16, st, p_h, p_row, B, H, T, Dh,
                           scale, s);
  }
  if (Dh <= 64) {
    return launch_simt<64>(qu, qw, k, v, p, lengths, out, out_bf16, st, p_h, p_row, B, H, T, Dh,
                           scale, s);
  }
  return launch_simt<128>(qu, qw, k, v, p, lengths, out, out_bf16, st, p_h, p_row, B, H, T, Dh,
                          scale, s);
}

// bf16 inputs: the wgmma kernel at Dh padded to 64 or 128
template <typename OutT>
cudaError_t launch_bf16(const void* qu, const void* qw, const void* k, const void* v,
                        const void* p, const int* lengths, OutT* out, const Strides* st,
                        long long p_h, long long p_row, int B, int H, int T, int Dh,
                        cudaStream_t s) {
  const float scale = 1.0f / sqrtf((float)Dh);
  if (Dh <= 64) {
    return launch_wgmma<64>(qu, qw, k, v, p, lengths, out, st, p_h, p_row, B, H, T, Dh, scale, s);
  }
  return launch_wgmma<128>(qu, qw, k, v, p, lengths, out, st, p_h, p_row, B, H, T, Dh, scale, s);
}

}  // namespace

// Dynamic shared memory the bf16 kernel asks for at launch, in bytes, at a
// padded head width of 64 or 128.
extern "C" int relpos_attention_smem_bytes(int dp) {
  return dp == 64 ? Layout<64>::kBytes : Layout<128>::kBytes;
}

// Dynamic shared memory the f32 kernel for T > 16 asks for at launch, in
// bytes, at head width 64 or 128.
extern "C" int relpos_attention_f32_smem_bytes(int dh) {
  return dh == 64 ? F32Plan<64>::kBytes : F32Plan<128>::kBytes;
}

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take). `strides`
// holds 17 element strides: (b, h, t) of qu, qw, k, v and out, then (h, row)
// of p. Every last axis is contiguous; for bf16 inputs every pointer and
// every other stride must be a multiple of 16 bytes, and out's too.
extern "C" int relpos_attention_launch(const void* qu, const void* qw, const void* k,
                                       const void* v, const void* p, const void* lengths,
                                       void* out, const long long* strides, int B, int H, int T,
                                       int Dh, int is_bf16, int out_is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || T < 1 || Dh % 16 || Dh < 16 || Dh > 128) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const long long p_h = strides[15], p_row = strides[16];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (!is_bf16) {
    return (int)launch_f32(qu, qw, k, v, p, lens, out, out_is_bf16 != 0, st, p_h, p_row, B, H, T,
                           Dh, s);
  }
  if (out_is_bf16) {
    return (int)launch_bf16(qu, qw, k, v, p, lens, static_cast<__nv_bfloat16*>(out), st, p_h,
                            p_row, B, H, T, Dh, s);
  }
  return (int)launch_bf16(qu, qw, k, v, p, lens, static_cast<float*>(out), st, p_h, p_row, B, H,
                          T, Dh, s);
}
