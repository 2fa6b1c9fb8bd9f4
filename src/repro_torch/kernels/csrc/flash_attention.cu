// GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, body _flash_kernel): the same function — an
// online softmax (m, l, acc) kept in fp32 across K/V tiles, scale 1/sqrt(hd),
// causal mask aligned top-left (key j visible to query i iff j <= i), tiles
// wholly above the diagonal skipped, P rounded to V's type before the PV
// product, fully masked rows guarded with l = max(l, 1e-30).
//
// What changes from the TPU kernel.  The Pallas grid walks K/V tiles in
// order and carries (m, l, acc) in VMEM scratch from one grid step to the
// next; CUDA blocks run in no order, so one block owns one (64-row q tile,
// head, batch) and a loop inside it walks the K/V tiles.  K/V tiles of 64
// rows are staged through shared memory (64 x 128 bf16 = 16 KB each); the
// kv head of query head h is h / (H / K).  Ragged S and T are masked inside
// the kernel, so no divisibility is required.  Masked scores contribute
// p = 0 exactly (the Pallas kernel relies on the first tile holding key 0).
//
// Bound on this card.  granite-8b prefill at B=8, S=T=1024, H=32, K=8,
// hd=128, causal, bf16: 4*B*H*hd*S(S+1)/2 = 68.8 GFLOP -> 69.6 us at
// 989 TFLOP/s (bf16 tensor cores); bytes q+k+v+o = 168 MB -> 50 us at
// 3.35 TB/s.  So the bound is ~70 us a layer and it is compute-bound.
// zamba2-2.7b's shared block at B=8, S=T=1024, H=K=32, hd=80, bf16:
// 43.0 GFLOP -> 43 us; 168 MB -> 50 us, so bytes bound it at ~50 us.
// Instantiated for hd 16, 32, 64, 80 and 128 (hd / 16 output columns a
// thread).
//
// Which calls it serves: fp32 at every hd (the 2e-5 gate is beyond TF32
// tensor cores) and bf16 at hd 16 and 32.  bf16 at hd 64, 80 and 128 --
// every served prefill attention -- goes to the tensor-core kernel in
// flash_attention_wgmma.cu; the choice is fixed by (dtype, hd) in
// kernels/flash_attention.py::variant.
//
// Design: right and simple first.  Each of 256 threads computes a 4x4
// register tile of the 64x64 score tile with fp32 FMAs (4-wide shared loads,
// rows padded by 4 elements so the loads are free of bank conflicts), then
// a 4 x hd/16 slice of the output.  No tensor cores, no TMA: far from the
// compute bound above.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // key rows per tile
constexpr int NT = 256;    // threads per block: 16 x 16
constexpr int PAD = 4;     // row padding (elements) of the Q/K tiles
constexpr int PLD = BK + 1;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + BK) * (HD + PAD) * sizeof(T)   // Qs, Ks
       + (size_t)BK * HD * sizeof(T)                  // Vs
       + (size_t)BQ * PLD * sizeof(float);            // Ps
}

// q (B,S,H,HD); k, v (B,T,KH,HD); o (B,S,H,HD); all contiguous.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          int S, int Tn, int H, int KH, int causal, float scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int LD = HD + PAD;
  constexpr int NC = HD / 16;          // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + BK * HD);

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T zero = from_f<T>(0.f);

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * LD + d] = s < S ? q[(((size_t)b * S + s) * H + h) * HD + d] : zero;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int nk = (Tn + BK - 1) / BK;
  if (causal) {
    // skip tiles wholly above the diagonal: tile kt is needed iff
    // kt*BK <= last query row of this block
    const int last_q = min(q0 + BQ, S) - 1;
    nk = min(nk, last_q / BK + 1);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done (and Qs landed)
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      const size_t off = (((size_t)b * Tn + t) * KH + kvh) * HD + d;
      Ks[r * LD + d] = t < Tn ? k[off] : zero;
      Vs[r * HD + d] = t < Tn ? v[off] : zero;
    }
    __syncthreads();

    // scores for rows ty*4+i, keys tx+16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qa[4][4], ka[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(&Qs[(ty * 4 + i) * LD + d], qa[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load4(&Ks[(tx + 16 * j) * LD + d], ka[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][j] = fmaf(qa[i][e], ka[j][e], sc[i][j]);
    }

    // online softmax, fp32; a row's 16 threads are lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[4];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Tn && (!causal || kpos <= qpos);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - mx) : 0.f;
        rs += p;
        // P goes into the PV product in V's type, as p.astype(v.dtype)
        Ps[(ty * 4 + i) * PLD + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V for rows ty*4+i, columns tx+16c
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = to_f(Vs[kk * HD + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * S + s) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / li);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tn, int H, int KH, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tn, H, KH, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int HD, const void* q, const void* k, const void* v,
                        void* o, int B, int S, int Tn, int H, int KH,
                        int causal, float scale, cudaStream_t st) {
  switch (HD) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on ``stream``, allocates
// nothing, and returns cudaGetLastError() after the launch (0 = success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int S,
                                         int Tn, int H, int KH, int HD,
                                         int dtype, int causal, float scale,
                                         void* stream) {
  if (B <= 0 || S <= 0 || Tn <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_hd<float>(HD, q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    case 1: return (int)dispatch_hd<__nv_bfloat16>(HD, q, k, v, o, B, S, Tn, H, KH, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
