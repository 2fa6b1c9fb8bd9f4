// GQA flash attention, forward, bf16, for Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, body _flash_kernel) for bf16 at head dims 64, 80
// and 128; the CUDA-core kernel in flash_attention.cu keeps fp32 (every hd)
// and bf16 at hd 16 and 32.  The function is _flash_kernel's: scale
// 1/sqrt(hd); (m, l, acc) in fp32 across K/V tiles; P rounded to bf16
// before the PV product; the causal mask aligned top-left (key j visible to
// query i iff j <= i) with tiles wholly above the diagonal skipped; ragged
// S and T masked inside the kernel; l = max(l, 1e-30); head h reads kv head
// h / (H / K).  A masked score contributes p = 0 exactly.
//
// Bound on this card.  granite-8b prefill, B=8, S=T=1024, H=32, K=8,
// hd=128, causal: 4*B*H*hd*S(S+1)/2 = 68.8 GFLOP -> 69.6 us at 989 TFLOP/s;
// 168 MB of q, k, v, o -> 50 us at 3.35 TB/s: bound by operations.
// zamba2-2.7b's shared block (H=K=32, hd=80): 43.0 GFLOP -> 43 us against
// 168 MB -> 50 us: bound by bytes.  Both products must therefore run on the
// tensor cores, and the K/V stream must overlap them.
//
// Design.
// - A block is 3 warpgroups.  WG 0 is the producer (setmaxnreg 40): one
//   thread issues every TMA copy.  WGs 1 and 2 are consumers (setmaxnreg
//   232), 64 q rows each, so a work item is a 128-row q tile of one (head,
//   batch).  ptxas: 168 registers at entry, no spills.
// - Persistent: one block per SM walks its share of the items, so a
//   block's set-up and the next item's first loads hide behind the current
//   item.  Items are numbered heaviest first (the last causal q tiles lead)
//   and dealt out in a snake (block b takes the b-th item of even rounds
//   and the (G-1-b)-th of odd ones), which evens out the causal work.
// - TMA, not cp.async: the tensor maps are 4-D over (hd, heads, seq,
//   batch) with a box of (64, 1, 128, 1) and the 128-byte swizzle, encoded
//   on the host by cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPointByVersion (nothing new to link), and passed as
//   __grid_constant__ CUtensorMap.  hd is loaded in 64-column boxes; at
//   hd 80 the second box's columns 80-127 lie out of bounds and TMA fills
//   them with zeros.  Rows past S or T are zero-filled the same way.  The
//   bases must be 16-byte aligned (the launcher checks).
// - Q lands once per item; its slot is refilled when both consumers' last
//   S of the item is done.  K and V tiles of BK = 128 rows stream through
//   a ring of STAGES = 2 slots that runs on across items; a slot's "full"
//   mbarrier completes on the copies' bytes, its "empty" one on the 8
//   consumer warps' release, so tile j+1 lands while tile j is multiplied.
// - S = Q K^T: wgmma m64n128k16, A (Q) and B (K) both K-major in shared
//   memory, hd/16 steps, fp32 accumulators in registers.
// - The online softmax runs on the accumulator registers: each row lives
//   in one quad of threads, so its max is two xor-shuffles; the row sum
//   is kept per thread and reduced once at the end.  Only tiles that cross
//   T or the diagonal are masked.
// - O += P V: P is packed to bf16 straight from the S accumulators into the
//   A-operand registers (the accumulator and A-fragment layouts coincide),
//   no shared-memory round trip; V is B, MN-major (transposed) in shared
//   memory; wgmma m64n{hd}k16, BK/16 steps.  At hd 80 the product is
//   m64n80 and reads columns 64-79 of the second box, so no MMA work is
//   spent on the zero columns.  hd 96 would be one more instantiation
//   (and an m64n96 wrapper).
// - The epilogue divides by max(l, 1e-30) and stores bf16 pairs.
//
// Shared memory: Q 128 x ceil(hd/64)*64 bf16 (32 KB at hd 80/128, 16 KB at
// hd 64) plus 2 stages of K and V tiles of the same size: 160 KB at hd
// 80/128, 80 KB at hd 64, plus 1 KB for alignment and the barriers.
#include <cuda.h>            // CUtensorMap and its enums: types only
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // q rows per block (64 per consumer WG)
constexpr int BK = 128;          // key rows per K/V tile
constexpr int STAGES = 2;        // K/V ring depth
constexpr int NTHREADS = 384;    // producer WG + 2 consumer WGs
constexpr int ROW_BYTES = 128;   // one swizzled row of a 64-column box
constexpr int BOX_COLS = 64;

template <int HD>
struct Tile {
  static constexpr int NCB = (HD + BOX_COLS - 1) / BOX_COLS;  // column boxes
  static constexpr int Q_BOX = BQ * ROW_BYTES;                 // one box
  static constexpr int KV_BOX = BK * ROW_BYTES;
  static constexpr int Q_BYTES = NCB * Q_BOX;
  static constexpr int KV_BYTES = NCB * KV_BOX;                // K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;   // + barriers, alignment
  static_assert(2 * 8 + 2 * STAGES * 8 <= 64, "barriers");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity ``parity`` has completed; a wait past
// ~2^34 cycles (seconds) traps, so a broken pipeline faults, not hangs
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
        "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
       | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= A B, A and B both K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A (bf16) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A (bf16) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A (bf16) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// One work item: a 128-row q tile of one (head, batch).  Items are
// numbered heaviest first (the last q tiles lead), heads of one batch
// adjacent so that a GQA group's blocks share K/V in L2.  Block bx takes
// item r*G + bx in even rounds r and r*G + G-1-bx in odd ones (G blocks):
// the snake evens out the causal work, which falls with the item number.
__device__ __forceinline__ int item_index(int r, int G) {
  const int bx = static_cast<int>(blockIdx.x);
  return r * G + ((r & 1) ? G - 1 - bx : bx);
}

struct Item {
  int q0, h, b, kvh, nk;
};

__device__ __forceinline__ Item item(int w, int nq, int B, int S, int Tn,
                                     int H, int KH, int causal) {
  Item it;
  const int hb = w % (H * B);
  it.q0 = (nq - 1 - w / (H * B)) * BQ;
  it.h = hb % H;
  it.b = hb / H;
  it.kvh = it.h / (H / KH);
  it.nk = (Tn + BK - 1) / BK;
  // causal: skip the tiles wholly above the diagonal
  if (causal) it.nk = min(it.nk, (min(it.q0 + BQ, S) - 1) / BK + 1);
  return it;
}

// q (B,S,H,HD), k and v (B,T,KH,HD) through the tensor maps; o (B,S,H,HD).
// Persistent: each block walks its items (item_index); the K/V ring runs
// on across items, so the next item's Q and first tiles load while this
// one finishes.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int B, int S, int Tn, int H,
                int KH, int causal, float scale_log2) {
  using L = Tile<HD>;
  static_assert(HD % 16 == 0 && HD <= L::NCB * BOX_COLS, "head dim");
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + L::Q_BYTES;
  const uint32_t sv = sk + STAGES * L::KV_BYTES;
  const uint32_t bar_q_full = base + L::BAR_OFF;
  const uint32_t bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full = bar_q_empty + 8;            // STAGES of them
  const uint32_t bar_empty = bar_full + 8 * STAGES;     // STAGES of them

  const int nq = (S + BQ - 1) / BQ;
  const int items = nq * H * B;

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, 8);               // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;                                 // K/V tiles issued so far
      for (int n = 0; item_index(n, gridDim.x) < items; ++n) {
        const Item u = item(item_index(n, gridDim.x), nq, B, S, Tn, H, KH,
                            causal);
        // Q's slot is free once both consumers' last S = Q K^T is done
        if (n > 0) mbar_wait(bar_q_empty, (n - 1) & 1);
        mbar_expect_tx(bar_q_full, L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < L::NCB; ++c)
          tma_load(sq + c * L::Q_BOX, &tm_q, bar_q_full, c * BOX_COLS, u.h,
                   u.q0, u.b);
        for (int j = 0; j < u.nk; ++j, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(bar_empty + 8 * s, (g / STAGES - 1) & 1);
          const uint32_t full = bar_full + 8 * s;
          mbar_expect_tx(full, 2 * L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < L::NCB; ++c) {
            tma_load(sk + s * L::KV_BYTES + c * L::KV_BOX, &tm_k, full,
                     c * BOX_COLS, u.kvh, j * BK, u.b);
            tma_load(sv + s * L::KV_BYTES + c * L::KV_BOX, &tm_v, full,
                     c * BOX_COLS, u.kvh, j * BK, u.b);
          }
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;                       // 0 or 1: q rows 64*cw..
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int col_lane = 2 * (lane % 4);
    const uint32_t q_wg = sq + 64 * cw * ROW_BYTES;
    int g = 0;
    for (int n = 0; item_index(n, gridDim.x) < items; ++n) {
      const Item u = item(item_index(n, gridDim.x), nq, B, S, Tn, H, KH,
                          causal);
      const int row0 = u.q0 + 64 * cw + 16 * warp + lane / 4;  // and + 8

      float acc[HD / 2];
#pragma unroll
      for (int r = 0; r < HD / 2; ++r) acc[r] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

      mbar_wait(bar_q_full, n & 1);
      for (int j = 0; j < u.nk; ++j, ++g) {
        const int s = g % STAGES;
        mbar_wait(bar_full + 8 * s, (g / STAGES) & 1);
        const uint32_t k_s = sk + s * L::KV_BYTES;
        const uint32_t v_s = sv + s * L::KV_BYTES;

        // S = Q K^T over hd in steps of 16 (32 bytes inside a swizzled row)
        float sc[BK / 2];
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          const uint64_t da = sw128_desc(q_wg + (kk / 4) * L::Q_BOX + off,
                                         16, 8 * ROW_BYTES);
          const uint64_t db = sw128_desc(k_s + (kk / 4) * L::KV_BOX + off,
                                         16, 8 * ROW_BYTES);
          wgmma_ss(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        if (j == u.nk - 1) {                     // done with this Q
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_q_empty);
        }

        // mask: keys past T, and (causal) keys after the query
        const int k0 = j * BK;
        if (k0 + BK > Tn || (causal && k0 + BK - 1 > u.q0 + 64 * cw)) {
#pragma unroll
          for (int r = 0; r < BK / 2; ++r) {
            const int col = k0 + 8 * (r / 4) + col_lane + (r % 2);
            const int row = row0 + 8 * ((r / 2) % 2);
            if (col >= Tn || (causal && col > row)) sc[r] = -INFINITY;
          }
        }

        // online softmax in the log2 domain, one quad of threads per row
        float corr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int r = 0; r < BK / 2; ++r)
            if ((r / 2) % 2 == i) mx = fmaxf(mx, sc[r]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx * scale_log2);
          // a row with every key masked so far: keep p and corr at 0
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          corr[i] = exp2f(m[i] - m_use);
          m[i] = m_new;
          float rs = 0.f;
#pragma unroll
          for (int r = 0; r < BK / 2; ++r) {
            if ((r / 2) % 2 != i) continue;
            const float p = exp2f(sc[r] * scale_log2 - m_use);
            sc[r] = p;
            rs += p;
          }
          l[i] = l[i] * corr[i] + rs;
        }

        // P in bf16, straight into the A fragments of the PV product
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
        }
#pragma unroll
        for (int r = 0; r < HD / 2; ++r) acc[r] *= corr[(r / 2) % 2];

        // O += P V: V MN-major; 16 keys (two 8-row groups) a step
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = sw128_desc(v_s + kk * 16 * ROW_BYTES, L::KV_BOX,
                                         8 * ROW_BYTES);
          wgmma_rs(acc, pa[kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);

        // this warp is done with the slot
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      }

      // epilogue: the row sums over the quad, then o = acc / max(l, 1e-30)
      float den[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float li = l[i];
        li += __shfl_xor_sync(0xffffffffu, li, 1);
        li += __shfl_xor_sync(0xffffffffu, li, 2);
        den[i] = fmaxf(li, 1e-30f);
      }
#pragma unroll
      for (int r = 0; r < HD / 2; r += 2) {
        const int i = (r / 2) % 2;
        const int row = row0 + 8 * i;
        if (row < S) {
          const __nv_bfloat162 v2 = __floats2bfloat162_rn(
              acc[r] / den[i], acc[r + 1] / den[i]);
          *reinterpret_cast<__nv_bfloat162*>(
              o + ((static_cast<size_t>(u.b) * S + row) * H + u.h) * HD +
              8 * (r / 4) + col_lane) = v2;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// (hd, heads, seq, batch) of a contiguous (batch, seq, heads, hd) bf16
// tensor, a box of (64, 1, 128, 1), 128-byte swizzle, zeros out of bounds
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd,
            int heads, int seq, int batch) {
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {BOX_COLS, 1, BQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  static_assert(BQ == BK, "one box shape for Q, K and V");
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tn, int H, int KH, int causal, float scale,
           cudaStream_t stream) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -1;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, HD, H, S, B) || !encode(fn, &tk, k, HD, KH, Tn, B) ||
      !encode(fn, &tv, v, HD, KH, Tn, B))
    return -2;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = Tile<HD>::SMEM;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block per SM, each walking its share of the work items
  const int items = (S + BQ - 1) / BQ * H * B;
  flash_fwd_wgmma<HD><<<min(items, sms), NTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, Tn, H, KH, causal,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only, hd 64, 80 or 128; q, k, v 16-byte aligned and contiguous.
// Launches on ``stream`` and allocates nothing.  Returns 0 on success, a
// cudaError_t after the launch, -1 if the driver's cuTensorMapEncodeTiled
// cannot be reached, -2 if a tensor map is refused.
extern "C" int repro_flash_attention_wgmma_fwd(const void* q, const void* k,
                                               const void* v, void* o, int B,
                                               int S, int Tn, int H, int KH,
                                               int HD, int causal,
                                               float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tn <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64: return launch<64>(q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    case 80: return launch<80>(q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    case 128: return launch<128>(q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
