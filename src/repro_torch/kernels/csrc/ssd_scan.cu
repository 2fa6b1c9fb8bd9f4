// Mamba2 SSD chunk scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan_pallas,
// body _ssd_kernel): the same function as the JAX model's ssd_chunked
// (src/repro/models/ssm.py).  Per (batch, head), the chunks of `q` tokens are
// walked in order with an fp32 (N, P) state h carried across them; within a
// chunk, with s the inclusive cumsum of da,
//   y_j  = sum_{i<=j} (C_j . B_i) exp(s_j - s_i) dt_i x_i     (intra-chunk)
//        + exp(s_j) C_j . h                                  (carried state)
//        + D x_j                                             (skip)
//   h    = exp(s_last) h + sum_i B_i (exp(s_last - s_i) dt_i x_i)
// Head h reads the B/C group h / (H/G).  x is fp32 or bf16 and is upcast on
// load; everything else, and every product, is fp32 FMAs (no TF32).
//
// What changes from the TPU kernel.  The Pallas grid (B, H, chunks) runs its
// chunk axis in order and keeps the state in VMEM scratch between grid steps;
// CUDA blocks run in no order, so one block owns one (P slice, head, batch)
// and a loop inside it walks the chunks, the state in shared memory.  y[:, p]
// and h[:, p] depend only on x[:, p], so P splits across blocks with no
// reduction: the launcher halves the P slice (64 -> 32 -> 16) until the grid
// has at least one block per SM (B=8, H=80: 640 blocks of P 64; B=1: 160 of
// P 32).  A chunk is cut into tiles of 64 tokens and worked like causal
// attention: for each 64-row output tile, the carried-state term first, then
// the scores C_j B_i^T of each input tile i <= j, decayed and masked, times
// dt x.  exp(s_j - s_i) is taken only where i <= j: above the diagonal it can
// overflow, and inf * 0 would give NaN.  The state update is accumulated in
// registers while each input tile is resident on the diagonal, and folded
// into the state at the chunk's end.  A ragged S is masked in the kernel:
// the last chunk is shorter, which equals ssd_chunked's identity-step
// padding, and h_final is the state after the last real token.
//
// Bound on this card.  zamba2-2.7b prefill at B=8, S=1024, H=80, P=N=64,
// G=1, chunk 256, bf16 x: bytes x 84 MB + y 168 MB + h_final 10.5 MB +
// B/C/dt/da 9.4 MB = 272 MB -> 81 us at 3.35 TB/s.  The function needs
// fewer operations than the chunked form: the plain recurrence takes, per
// (b, h, token), NP to decay h, 2NP to add B (dt x), 2NP for C h and 3P for
// dt x and D x, 5NP + 3P = 20,672; over 655,360 (b, h, token) 13.5 GFLOP
// -> 0.20 ms at 67 TFLOP/s (fp32 without tensor cores).  (The chunked form
// at chunk 256 needs 20.3 GFLOP.)  So it is compute-bound at ~0.20 ms a
// layer; at B=1, S=4096 at ~0.10 ms.
//
// Design: right and simple first.  256 threads; each holds a 4x4 register
// tile of the 64x64 score tile and a 4 x P/16 tile of the output and of the
// state update, fp32 FMAs from shared memory (rows padded by 4 floats so the
// 16-byte loads are free of bank conflicts).  It recomputes C B^T for every
// head and P slice and multiplies the zero half of the diagonal tiles, so it
// does ~37.6 GFLOP at the shape above, 2.8x the bound's operations.  No
// tensor cores, no TMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TR = 64;      // tokens per tile
constexpr int NT = 256;     // threads per block: 16 x 16
constexpr int MAXN = 64;    // the widest state (N) a block takes
constexpr int MAXQ = 2048;  // the longest chunk
constexpr int PAD = 4;      // row padding (floats) of the B, C, x tiles
constexpr int SLD = TR + 1; // row stride of the score tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

size_t smem_bytes(int q, int N, int PS) {
  const int qp = (q + 3) / 4 * 4;
  return sizeof(float) * ((size_t)2 * qp + 2 * TR * (N + PAD)
                          + TR * (PS + PAD) + TR * SLD + (size_t)N * PS);
}

// x (B,S,H,P); bm, cm (B,S,G,N); dt, da (B,S,H); dsk (H,); y (B,S,H,P);
// hfin (B,H,N,P); all contiguous.  Block (p slice, h, b); PS = 16 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(NT)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ bm,
        const float* __restrict__ cm, const float* __restrict__ dt,
        const float* __restrict__ da, const float* __restrict__ dsk,
        float* __restrict__ y, float* __restrict__ hfin,
        int S, int H, int G, int N, int P, int q) {
  constexpr int PS = 16 * NC;
  constexpr int LDX = PS + PAD;
  const int LDN = N + PAD;
  const int qp = (q + 3) / 4 * 4;
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;               // cumsum of da over the chunk
  float* dts = sg + qp;           // dt over the chunk
  float* Cs = dts + qp;           // C of the output tile   (TR x LDN)
  float* Bs = Cs + TR * LDN;      // B of the input tile    (TR x LDN)
  float* Xs = Bs + TR * LDN;      // dt x of the input tile (TR x LDX)
  float* Ss = Xs + TR * LDX;      // decayed, masked scores (TR x SLD)
  float* Hs = Ss + TR * SLD;      // carried state          (N x PS)

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool owns_state = ty * 4 < N;     // rows n = ty*4 .. ty*4+3
  const float dskip = dsk[h];
  const size_t tok0 = (size_t)b * S;      // first token of this batch row

  for (int e = tid; e < N * PS; e += NT) Hs[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += q) {
    const int L = min(q, S - c0);
    __syncthreads();   // the previous chunk's readers of sg, dts, Hs are done
    for (int i = tid; i < L; i += NT) {
      const size_t o = (tok0 + c0 + i) * H + h;
      dts[i] = dt[o];
      sg[i] = da[o];
    }
    __syncthreads();
    if (tid < 32) {    // inclusive cumsum, 32 tokens a step
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int i = base + tid;
        float v = i < L ? sg[i] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(FULL, v, off);
          if (tid >= off) v += u;
        }
        if (i < L) sg[i] = v + carry;
        carry += __shfl_sync(FULL, v, 31);
      }
    }
    __syncthreads();
    const float s_last = sg[L - 1];

    float hu[4][NC];   // this chunk's state update, rows ty*4+r, cols tx+16c
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) hu[r][c] = 0.f;

    for (int j0 = 0; j0 < L; j0 += TR) {
      __syncthreads();   // the previous tile's readers of Cs are done
      for (int e = tid; e < TR * N; e += NT) {
        const int r = e / N, n = e % N;
        Cs[r * LDN + n] = j0 + r < L
            ? cm[((tok0 + c0 + j0 + r) * G + g) * N + n] : 0.f;
      }
      __syncthreads();

      // carried state: acc = exp(s_j) C_j . h
      float acc[4][NC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty * 4 + r) * LDN + n];
#pragma unroll
        for (int c = 0; c < NC; ++c) hv[c] = Hs[n * PS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(cv[r], hv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + ty * 4 + r;
        const float e = j < L ? expf(sg[j]) : 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] *= e;
      }

      for (int i0 = 0; i0 <= j0; i0 += TR) {
        __syncthreads();   // the previous tile's readers of Bs, Xs, Ss are done
        for (int e = tid; e < TR * N; e += NT) {
          const int r = e / N, n = e % N;
          Bs[r * LDN + n] = i0 + r < L
              ? bm[((tok0 + c0 + i0 + r) * G + g) * N + n] : 0.f;
        }
        for (int e = tid; e < TR * PS; e += NT) {
          const int r = e / PS, p = e % PS;
          Xs[r * LDX + p] = i0 + r < L
              ? dts[i0 + r] * to_f(x[((tok0 + c0 + i0 + r) * H + h) * P + p0 + p])
              : 0.f;
        }
        __syncthreads();

        // scores C_j . B_i for rows ty*4+r, columns tx+16k
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[r][k] = 0.f;
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float ca[4][4], ba[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) load4(&Cs[(ty * 4 + r) * LDN + n], ca[r]);
#pragma unroll
          for (int k = 0; k < 4; ++k) load4(&Bs[(tx + 16 * k) * LDN + n], ba[k]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[r][k] = fmaf(ca[r][e], ba[k][e], sc[r][k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + ty * 4 + r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int i = i0 + tx + 16 * k;
            // only i <= j < L: exp(s_j - s_i) may overflow above the diagonal
            Ss[(ty * 4 + r) * SLD + tx + 16 * k] =
                (i <= j && j < L) ? sc[r][k] * expf(sg[j] - sg[i]) : 0.f;
          }
        }
        __syncthreads();

        // acc += scores . (dt x)
#pragma unroll 4
        for (int k = 0; k < TR; ++k) {
          float sv[4], xv[NC];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = Ss[(ty * 4 + r) * SLD + k];
#pragma unroll
          for (int c = 0; c < NC; ++c) xv[c] = Xs[k * LDX + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(sv[r], xv[c], acc[r][c]);
        }

        // on the diagonal the input tile is seen for the last time: add its
        // share of the state update, B_i^T (exp(s_last - s_i) dt_i x_i)
        if (i0 == j0 && owns_state) {
          const int kend = min(TR, L - i0);
          for (int k = 0; k < kend; ++k) {
            const float w = expf(s_last - sg[i0 + k]);
            float bv[4], xv[NC];
            load4(&Bs[k * LDN + ty * 4], bv);
#pragma unroll
            for (int c = 0; c < NC; ++c) xv[c] = w * Xs[k * LDX + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < NC; ++c) hu[r][c] = fmaf(bv[r], xv[c], hu[r][c]);
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + ty * 4 + r;
        if (j >= L) continue;
        const size_t row = ((tok0 + c0 + j) * H + h) * P + p0;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int p = tx + 16 * c;
          y[row + p] = acc[r][c] + dskip * to_f(x[row + p]);
        }
      }
    }

    __syncthreads();   // every reader of the carried state is done
    if (owns_state) {
      const float e = expf(s_last);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float* hp = &Hs[(ty * 4 + r) * PS + tx + 16 * c];
          *hp = e * *hp + hu[r][c];
        }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * PS; e += NT) {
    const int n = e / PS, p = e % PS;
    hfin[(((size_t)b * H + h) * N + n) * P + p0 + p] = Hs[e];
  }
}

template <typename T, int NC>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const void* dt, const void* da, const void* dsk, void* y,
                   void* hfin, int B, int S, int H, int G, int N, int P,
                   int q, cudaStream_t stream) {
  const size_t smem = smem_bytes(q, N, 16 * NC);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(P / (16 * NC), H, B);
  ssd_fwd<T, NC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(dt),
      static_cast<const float*>(da), static_cast<const float*>(dsk),
      static_cast<float*>(y), static_cast<float*>(hfin), S, H, G, N, P, q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ps(int PS, const void* x, const void* bm, const void* cm,
                        const void* dt, const void* da, const void* dsk,
                        void* y, void* hfin, int B, int S, int H, int G,
                        int N, int P, int q, cudaStream_t st) {
  switch (PS) {
    case 16: return launch<T, 1>(x, bm, cm, dt, da, dsk, y, hfin, B, S, H, G, N, P, q, st);
    case 32: return launch<T, 2>(x, bm, cm, dt, da, dsk, y, hfin, B, S, H, G, N, P, q, st);
    case 64: return launch<T, 4>(x, bm, cm, dt, da, dsk, y, hfin, B, S, H, G, N, P, q, st);
    default: return cudaErrorInvalidValue;
  }
}

// The P slice a launch uses: the widest of 64, 32, 16 that divides P, halved
// while the grid would have fewer blocks than the card has SMs.
int p_slice(int B, int H, int P) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int ps = P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16;
  while (ps > 16 && (long long)B * H * (P / ps) < sms) ps /= 2;
  return ps;
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16; everything else float32.  Chunks of
// min(chunk, S) tokens.  Launches on ``stream``, allocates nothing, and
// returns cudaGetLastError() after the launch (0 = success).
extern "C" int repro_ssd_scan_fwd(const void* x, const void* bm, const void* cm,
                                  const void* dt, const void* da,
                                  const void* dsk, void* y, void* hfin, int B,
                                  int S, int H, int G, int N, int P, int chunk,
                                  int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || chunk <= 0 ||
      N <= 0 || N > MAXN || N % 4 != 0 || P <= 0 || P % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int q = chunk < S ? chunk : S;
  if (q > MAXQ) return (int)cudaErrorInvalidValue;
  const int ps = p_slice(B, H, P);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_ps<float>(ps, x, bm, cm, dt, da, dsk, y, hfin, B, S, H, G, N, P, q, st);
    case 1: return (int)dispatch_ps<__nv_bfloat16>(ps, x, bm, cm, dt, da, dsk, y, hfin, B, S, H, G, N, P, q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
