// Offload copy (the paper's DSA copy-engine stand-in), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/offload_copy.py
// (offload_copy_pallas, body _copy_kernel): y = cast(x * scale, out_dtype)
// over a 2-D slab, streamed through on-chip memory by a depth-k ring of
// asynchronous copies (depth 1 = sync, 2 = async, k >= 2 = pipelined), and
// with `inject` the fp32 sum of x * scale taken while the data is on chip
// (the fused consumer), instead of a second pass over device memory.
//
// Copy form: TMA bulk copies.  A copy-in is one cp.async.bulk global ->
// shared that completes on the stage's mbarrier (arrive.expect_tx = the DMA
// semaphore); a copy-out is one cp.async.bulk shared -> global in its own
// bulk group, and cp.async.bulk.wait_group.read <depth - 1> is the wait for
// the copy-out that last used a slot.  One thread issues every copy, so the
// copies in flight per CTA are exactly the ring's depth.
//
// What changes from the TPU kernel.  The Pallas grid walks row blocks in
// order on one core; here a persistent grid of one CTA per SM (132 on the
// H100 SXM) splits the slab into contiguous ranges, and each CTA runs the
// ring over its own range.  The transform is elementwise, so a stage is a
// flat range of elements (16 KB of input at depth <= 4, smaller for deeper
// rings so depth x (in + out) stays within 200 KB of shared memory): a
// Pallas block of 256 x 1024 fp32 is 1 MiB and does not fit in shared
// memory.  block_rows stays the wrapper's contract (divisibility and the
// depth clamp), not the tile.  Per stage i, in _copy_kernel's order:
//   1. wait for stage i's copy-in (mbarrier phase parity = lap & 1);
//   2. wait for the copy-out of block i - depth from the same slot;
//   3. transform (one fp32 multiply, round-to-nearest-even cast);
//   4. start the copy-out of i (after fence.proxy.async: the transform
//      wrote the stage through the generic proxy, the bulk copy reads it
//      through the async proxy);
//   5. start the copy-in of i + depth into the slot just read.
// So even depth 1 overlaps the store of i with the load of i + 1.  The
// warm-up starts min(depth, blocks) copy-ins and the drain waits on every
// bulk group, so a range shorter than the ring waits on no copy never made.
//
// y is bit-equal to the plain version: each element is one __fmul_rn by the
// fp32 scale, then __float2bfloat16_rn or a plain store.  The sum: each
// thread adds its products of a stage, then that stage sum into its fp32
// accumulator; warp shuffles and shared memory reduce the CTA; each CTA
// writes its partial to its own slot, and the last CTA to finish (an atomic
// ticket after __threadfence) adds the partials in CTA order.  No float
// atomics, so two launches on the same input give the same bits.
//
// Bound on this card.  Bytes only: each input element read once and each
// output element written once.  The main shape, a (65536, 1024) fp32 slab
// cast to bf16, moves 402,653,184 B -> 0.120 ms at 3.35 TB/s (fp32 out:
// 0.160 ms); its 67 M multiplies are 1 us at the fp32 rate.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads per CTA
constexpr int MAX_DEPTH = 8;            // deepest ring the launcher takes
constexpr int STAGE_IN_BYTES = 16384;   // input bytes of a stage
constexpr int SMEM_BUDGET = 200 * 1024; // dynamic shared memory of the ring
constexpr int STAGE_ALIGN = NT * 4;     // a stage is a multiple of this
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most N bulk groups of this thread still reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// x, y: n contiguous elements, 16-byte aligned, n * sizeof of each type a
// multiple of 16.  The slab is cut into n_chunks stages of `stage` elements
// (the last may be shorter); CTA b takes chunks [c0, c1).  With inject,
// partial[gridDim.x], *total and *ticket (zeroed) take the sum.
template <typename Tin, typename Tout, int DEPTH>
__global__ void __launch_bounds__(NT, 1)
offload_copy_kernel(const Tin* __restrict__ x, Tout* __restrict__ y,
                    float scale, long long n, int stage, long long n_chunks,
                    int inject, float* partial, float* total,
                    unsigned int* ticket) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[DEPTH];
  __shared__ float warp_sum[NT / 32];
  Tin* in_buf = reinterpret_cast<Tin*>(smem);
  Tout* out_buf = reinterpret_cast<Tout*>(
      smem + (size_t)DEPTH * stage * sizeof(Tin));

  const int tid = threadIdx.x;
  const long long c0 = n_chunks * blockIdx.x / gridDim.x;
  const long long c1 = n_chunks * (blockIdx.x + 1) / gridDim.x;
  const int nb = (int)(c1 - c0);

  auto count = [&](int b) -> int {
    const long long lo = (c0 + b) * stage;
    const long long hi = lo + stage < n ? lo + stage : n;
    return (int)(hi - lo);
  };
  auto copy_in = [&](int b) {
    const int s = b % DEPTH;
    const uint32_t bytes = (uint32_t)count(b) * sizeof(Tin);
    mbar_expect_tx(&full[s], bytes);
    bulk_load(in_buf + (size_t)s * stage, x + (c0 + b) * stage, bytes,
              &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < DEPTH; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)                                   // warm-up
    for (int b = 0; b < DEPTH && b < nb; ++b) copy_in(b);

  float acc = 0.f;
  for (int i = 0; i < nb; ++i) {
    const int s = i % DEPTH;
    mbar_wait(&full[s], (uint32_t)((i / DEPTH) & 1));   // 1. copy-in of i
    if (tid == 0) bulk_wait_read<DEPTH - 1>();          // 2. copy-out i-DEPTH
    __syncthreads();
    const int cnt = count(i);
    const Tin* src = in_buf + (size_t)s * stage;
    Tout* dst = out_buf + (size_t)s * stage;
    float part = 0.f;
    for (int e = tid * 4; e < cnt; e += NT * 4) {       // 3. transform
      float v[4];
      load4(src + e, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = __fmul_rn(v[k], scale);
        part = __fadd_rn(part, v[k]);
      }
      store4(dst + e, v);
    }
    acc = __fadd_rn(acc, part);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_store(y + (c0 + i) * stage, dst,             // 4. copy-out of i
                 (uint32_t)cnt * sizeof(Tout));
      if (i + DEPTH < nb) copy_in(i + DEPTH);           // 5. copy-in i+DEPTH
    }
  }
  if (tid == 0) bulk_wait_all();                        // drain

  if (!inject) return;
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(FULL, acc, off));
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid != 0) return;
  float p = 0.f;
  for (int w = 0; w < NT / 32; ++w) p = __fadd_rn(p, warp_sum[w]);
  partial[blockIdx.x] = p;
  __threadfence();
  if (atomicAdd(ticket, 1u) != gridDim.x - 1) return;
  __threadfence();                                      // last CTA: total
  const volatile float* parts = partial;
  float t = 0.f;
  for (unsigned b = 0; b < gridDim.x; ++b) t = __fadd_rn(t, parts[b]);
  *total = t;
}

// Elements of a stage for this ring: 16 KB of input, fewer when depth x
// (in + out) would pass the budget; a multiple of STAGE_ALIGN elements.
int stage_elems(int depth, int in_size, int out_size) {
  int s = STAGE_IN_BYTES / in_size;
  const int fit = SMEM_BUDGET / (depth * (in_size + out_size));
  if (fit < s) s = fit;
  return s / STAGE_ALIGN * STAGE_ALIGN;
}

template <typename Tin, typename Tout, int DEPTH>
cudaError_t launch(const void* x, void* y, float scale, long long n,
                   int max_ctas, int inject, float* scratch,
                   cudaStream_t st) {
  const int stage = stage_elems(DEPTH, sizeof(Tin), sizeof(Tout));
  const size_t smem = (size_t)DEPTH * stage * (sizeof(Tin) + sizeof(Tout));
  auto kern = offload_copy_kernel<Tin, Tout, DEPTH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_chunks = (n + stage - 1) / stage;
  const int grid = (int)(n_chunks < max_ctas ? n_chunks : max_ctas);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(y), scale, n, stage,
      n_chunks, inject, scratch, scratch + max_ctas,
      reinterpret_cast<unsigned int*>(scratch + max_ctas + 1));
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t by_depth(int depth, const void* x, void* y, float scale,
                     long long n, int max_ctas, int inject, float* scratch,
                     cudaStream_t st) {
  switch (depth) {
    case 1: return launch<Tin, Tout, 1>(x, y, scale, n, max_ctas, inject, scratch, st);
    case 2: return launch<Tin, Tout, 2>(x, y, scale, n, max_ctas, inject, scratch, st);
    case 3: return launch<Tin, Tout, 3>(x, y, scale, n, max_ctas, inject, scratch, st);
    case 4: return launch<Tin, Tout, 4>(x, y, scale, n, max_ctas, inject, scratch, st);
    case 5: return launch<Tin, Tout, 5>(x, y, scale, n, max_ctas, inject, scratch, st);
    case 6: return launch<Tin, Tout, 6>(x, y, scale, n, max_ctas, inject, scratch, st);
    case 7: return launch<Tin, Tout, 7>(x, y, scale, n, max_ctas, inject, scratch, st);
    case 8: return launch<Tin, Tout, 8>(x, y, scale, n, max_ctas, inject, scratch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x -> y over n elements; dtype codes 0 = fp32, 1 = bf16; depth 1..8 stages
// in flight per CTA; at most max_ctas CTAs.  With inject, scratch holds
// max_ctas + 2 zeroed floats: the CTA partials, then the total (read by the
// caller), then the ticket.  Returns a cudaError_t (0 on success).
extern "C" int repro_offload_copy(const void* x, void* y, float scale,
                                  long long n, int in_dtype, int out_dtype,
                                  int depth, int max_ctas, int inject,
                                  void* scratch, void* stream) {
  const int in_size = in_dtype == 0 ? 4 : 2;
  const int out_size = out_dtype == 0 ? 4 : 2;
  if (n <= 0 || in_dtype < 0 || in_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1 || depth < 1 || depth > MAX_DEPTH || max_ctas < 1 ||
      (n * in_size) % 16 != 0 || (n * out_size) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      (inject && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_dtype * 2 + out_dtype) {
    case 0: return (int)by_depth<float, float>(depth, x, y, scale, n, max_ctas, inject, sc, st);
    case 1: return (int)by_depth<float, __nv_bfloat16>(depth, x, y, scale, n, max_ctas, inject, sc, st);
    case 2: return (int)by_depth<__nv_bfloat16, float>(depth, x, y, scale, n, max_ctas, inject, sc, st);
    default: return (int)by_depth<__nv_bfloat16, __nv_bfloat16>(depth, x, y, scale, n, max_ctas, inject, sc, st);
  }
}
