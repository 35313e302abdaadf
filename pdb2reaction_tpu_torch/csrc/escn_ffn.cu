// K2: the eSCN per-node S2-grid feed-forward network, forward and
// backward, f32, for Hopper (sm_90a).
//
// Replaces pdb2reaction_tpu/mlip/escn_ffn_kernel.py: _ffn_fwd_kernel
// (forward) and _ffn_bwd_kernel (input cotangent), reached from
// fused_node_ffn through _ffn_fwd_call / _ffn_bwd_call.
//
// Per node i:  grid = tg[G,M] @ x_i[M,C]
//              h    = silu(grid @ W1 + b1)          [G, H]
//              y    = h @ W2 + b2                   [G, C]
//              out  = fg[M,G] @ y
// The backward recomputes from the saved input x:
//              dy = fg^T @ g_i;  dpre = (dy @ W2^T) * silu'(pre)
//              dx_i = tg^T @ (dpre @ W1^T)
//
// What bounds it: arithmetic (~66 MFLOP per node forward at escn-md:
// G = 460, M = 25, C = 128, H = 256), provided the [G, H] hidden
// activations never reach device memory (at P = 320 they would be 151 MB
// per tensor, written and read several times). That is the point of the
// TPU kernel and of this one: one block per node walks the grid in chunks
// of GC = 32 points; each chunk's table rows, grid rows, hidden rows and
// outputs live in shared memory, and the node's output accumulates in
// shared memory across chunks (two blocks fit on one SM at escn-md). Device memory sees only x (and g) in, the node result
// out, and the weights, which every block reads through L2.
// Every in-block product (to-grid, the two FFN products, from-grid) runs
// through one register-tiled routine: each thread owns 4 rows x 4..16
// columns; the left operand sits in shared memory k-major (so the 4 rows
// of one k are one float4) and the right one is read as float4 strips,
// so one shared-memory load feeds 8 to 16 multiply-adds. Weights stream
// through a 16-row shared-memory slab, the next slab prefetched into
// registers while the current one is multiplied.

#include <cuda_runtime.h>

#define GC 32           // grid points per chunk
#define LT (GC + 4)     // row stride of k-major chunk buffers (bank skew)

namespace {

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

constexpr int KS = 16;                      // slab rows
constexpr int SV = KS * 512 / 4 / 256;      // float4 per thread, N <= 512

// registers <-> one slab of KS rows of a right operand in device memory
struct Slab {
  float4 v[SV];
  __device__ void fetch(const float* B, int ldb, int k0, int kb, int N) {
    const int nv = kb * N / 4;
#pragma unroll
    for (int u = 0; u < SV; ++u) {
      const int i = threadIdx.x + u * blockDim.x;
      if (i < nv) {
        const int e = 4 * i, kk = e / N, n = e - kk * N;
        v[u] = *reinterpret_cast<const float4*>(B + (size_t)(k0 + kk) * ldb +
                                                n);
      }
    }
  }
  __device__ void put(float* slab, int kb, int N) const {
    const int nv = kb * N / 4;
#pragma unroll
    for (int u = 0; u < SV; ++u) {
      const int i = threadIdx.x + u * blockDim.x;
      if (i < nv) reinterpret_cast<float4*>(slab)[i] = v[u];
    }
  }
};

__device__ __forceinline__ float apply(int mode, float old, float v) {
  if (mode == 0) return v;
  if (mode == 1) return silu(v);
  if (mode == 2) {
    const float s = 1.f / (1.f + expf(-v));
    return s * (1.f + v * (1.f - s));
  }
  if (mode == 3) return old * v;
  return old + v;
}

// C (op)= f(A @ B + bias) for R rows x N columns, depth Kd.
// A is given k-major: AT[k * ldaT + r] (rows padded to a multiple of 4).
// B in device memory (through the slab) or, with BSM, in shared memory.
// C is row-major Cs[r * ldc + n], or with ct k-major Cs[n * ldc + r].
// mode 0: C = v; 1: silu(v); 2: silu'(v); 3: C *= v; 4: C += v.
// Thread t owns rows 4*(t / ncg) .. +3 and TN columns as TN/4 float4
// strips, strip s at s * N / (TN/4) + 4 * (t % ncg).
template <int TN, bool BSM>
__device__ void chunk_gemm(const float* AT, int ldaT, const float* B, int ldb,
                           const float* __restrict__ bias, float* Cs, int ldc,
                           bool ct, int R, int N, int Kd, int mode,
                           float* slab) {
  constexpr int S = TN / 4;
  const int t = threadIdx.x;
  const int ncg = N / TN, strip = N / S;
  const int rg = t / ncg, cg = t - rg * ncg;
  const int r0 = rg * 4;
  const bool active = r0 < R;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  Slab pre;
  if (!BSM) {
    pre.fetch(B, ldb, 0, min(KS, Kd), N);
    __syncthreads();                       // previous users of slab done
    pre.put(slab, min(KS, Kd), N);
    __syncthreads();
  }
  for (int k0 = 0; k0 < Kd; k0 += KS) {
    const int kb = min(KS, Kd - k0);
    const bool more = k0 + KS < Kd;
    const int kn = more ? min(KS, Kd - k0 - KS) : 0;
    if (!BSM && more) pre.fetch(B, ldb, k0 + KS, kn, N);
    const float* bk = BSM ? B + (size_t)k0 * ldb : slab;
    const int ldk = BSM ? ldb : N;
    if (active) {
#pragma unroll 4
      for (int kk = 0; kk < kb; ++kk) {
        const float4 a =
            *reinterpret_cast<const float4*>(AT + (k0 + kk) * ldaT + r0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float bv[TN];
#pragma unroll
        for (int q = 0; q < S; ++q) {
          const float4 b = *reinterpret_cast<const float4*>(
              bk + kk * ldk + q * strip + 4 * cg);
          bv[4 * q] = b.x;
          bv[4 * q + 1] = b.y;
          bv[4 * q + 2] = b.z;
          bv[4 * q + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (!BSM && more) {
      __syncthreads();                     // current slab consumed
      pre.put(slab, kn, N);
      __syncthreads();
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = (j / 4) * strip + 4 * cg + (j % 4);
    const float bn = bias ? bias[n] : 0.f;
    if (ct && r0 + 3 < R) {                // 4 rows of column n: one float4
      float4* o = reinterpret_cast<float4*>(Cs + n * ldc + r0);
      const float4 w = *o;
      *o = make_float4(apply(mode, w.x, acc[0][j] + bn),
                       apply(mode, w.y, acc[1][j] + bn),
                       apply(mode, w.z, acc[2][j] + bn),
                       apply(mode, w.w, acc[3][j] + bn));
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= R) continue;
      float* o = ct ? Cs + n * ldc + r0 + i : Cs + (r0 + i) * ldc + n;
      *o = apply(mode, *o, acc[i][j] + bn);
    }
  }
}

// tile width: at most 32 column groups, so the GC rows fit 256 threads
template <bool BSM>
__device__ void gemm_any(const float* AT, int ldaT, const float* B, int ldb,
                         const float* bias, float* Cs, int ldc, bool ct,
                         int R, int N, int Kd, int mode, float* slab) {
  if (N <= 128)
    chunk_gemm<4, BSM>(AT, ldaT, B, ldb, bias, Cs, ldc, ct, R, N, Kd, mode,
                       slab);
  else if (N <= 256)
    chunk_gemm<8, BSM>(AT, ldaT, B, ldb, bias, Cs, ldc, ct, R, N, Kd, mode,
                       slab);
  else
    chunk_gemm<16, BSM>(AT, ldaT, B, ldb, bias, Cs, ldc, ct, R, N, Kd, mode,
                        slab);
}

// the chunk's rows g0 .. g0+R of tg [G, M] and columns of fg [M, G], in
// the layouts the products read: tt [M, LT] and tr [GC, MS] of tg, fc
// [M, LT] and ft [GC, MS] of fg. A null destination is skipped.
__device__ void stage_tables(const float* __restrict__ tg,
                             const float* __restrict__ fg, int M, int MS,
                             int G, int g0, int R, float* tt, float* tr,
                             float* fc, float* ft) {
  for (int i = threadIdx.x; i < R * M; i += blockDim.x) {
    const int r = i / M, m = i - r * M;
    const float tv = tg[(size_t)(g0 + r) * M + m];
    const float fv = fg[(size_t)m * G + g0 + r];
    if (tt) tt[m * LT + r] = tv;
    if (tr) tr[r * MS + m] = tv;
    if (fc) fc[m * LT + r] = fv;
    if (ft) ft[r * MS + m] = fv;
  }
}

__host__ __device__ inline int pad4(int v) { return (v + 3) & ~3; }

// shared memory (floats): node rows, chunk tables, the grid/output rows,
// the hidden rows (k-major), the slab
__host__ __device__ inline size_t smem_floats(int M, int C, int H,
                                              bool bwd) {
  const size_t tables = bwd ? 2 * M * LT + GC * pad4(M)
                            : M * LT + GC * pad4(M);
  return 2 * (size_t)M * C + tables + (size_t)C * LT + (size_t)H * LT +
         KS * (C > H ? C : H);
}

__global__ void __launch_bounds__(256)
ffn_fwd(int M, int C, int H, int G, const float* __restrict__ x,
        const float* __restrict__ w1, const float* __restrict__ b1,
        const float* __restrict__ w2, const float* __restrict__ b2,
        const float* __restrict__ tg, const float* __restrict__ fg,
        float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int MC = M * C, MS = pad4(M);
  float* xs = sm;                 // [M, C]
  float* acc = xs + MC;           // [M, C]
  float* tt = acc + MC;           // [M, LT]   tg chunk, k-major
  float* ft = tt + M * LT;        // [GC, MS]  fg chunk, k-major
  float* gr = ft + GC * MS;       // [C, LT] grid (k-major), then y [GC, C]
  float* hs = gr + C * LT;        // [H, LT]   hidden rows, k-major
  float* slab = hs + H * LT;      // [KS, max(C, H)]
  const size_t p = blockIdx.x;
  for (int i = threadIdx.x; i < MC; i += blockDim.x) {
    xs[i] = x[p * MC + i];
    acc[i] = 0.f;
  }
  for (int g0 = 0; g0 < G; g0 += GC) {
    const int R = min(GC, G - g0);
    __syncthreads();
    stage_tables(tg, fg, M, MS, G, g0, R, tt, nullptr, nullptr, ft);
    __syncthreads();
    gemm_any<true>(tt, LT, xs, C, nullptr, gr, LT, true, R, C, M, 0,
                   slab);                                      // grid
    __syncthreads();
    gemm_any<false>(gr, LT, w1, H, b1, hs, LT, true, R, H, C, 1, slab);  // h
    __syncthreads();
    gemm_any<false>(hs, LT, w2, C, b2, gr, C, false, R, C, H, 0, slab);  // y
    __syncthreads();
    gemm_any<true>(ft, MS, gr, C, nullptr, acc, C, false, M, C, R, 4,
                   slab);                                      // fg y
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MC; i += blockDim.x) out[p * MC + i] = acc[i];
}

__global__ void __launch_bounds__(256)
ffn_bwd(int M, int C, int H, int G, const float* __restrict__ x,
        const float* __restrict__ gin, const float* __restrict__ w1,
        const float* __restrict__ b1, const float* __restrict__ w1t,
        const float* __restrict__ w2t, const float* __restrict__ tg,
        const float* __restrict__ fg, float* __restrict__ dx) {
  extern __shared__ __align__(16) float sm[];
  const int MC = M * C, MS = pad4(M);
  float* xs = sm;                 // [M, C]
  float* acc = xs + MC;           // [M, C]
  float* tt = acc + MC;           // [M, LT]   tg chunk, k-major
  float* fc = tt + M * LT;        // [M, LT]   fg chunk, k-major
  float* tr = fc + M * LT;        // [GC, MS]  tg chunk rows
  float* gr = tr + GC * MS;       // [C, LT] grid, dy (k-major); dgrid rows
  float* hs = gr + C * LT;        // [H, LT]   silu'(pre), then dpre
  float* slab = hs + H * LT;      // [KS, max(C, H)]
  const size_t p = blockIdx.x;
  const float* gp = gin + p * MC; // node cotangent, read through the slab
  for (int i = threadIdx.x; i < MC; i += blockDim.x) {
    xs[i] = x[p * MC + i];
    acc[i] = 0.f;
  }
  for (int g0 = 0; g0 < G; g0 += GC) {
    const int R = min(GC, G - g0);
    __syncthreads();
    stage_tables(tg, fg, M, MS, G, g0, R, tt, tr, fc, nullptr);
    __syncthreads();
    gemm_any<true>(tt, LT, xs, C, nullptr, gr, LT, true, R, C, M, 0,
                   slab);                                      // grid
    __syncthreads();
    gemm_any<false>(gr, LT, w1, H, b1, hs, LT, true, R, H, C, 2,
                    slab);                                     // silu'(pre)
    __syncthreads();
    gemm_any<false>(fc, LT, gp, C, nullptr, gr, LT, true, R, C, M, 0,
                    slab);                                     // dy
    __syncthreads();
    gemm_any<false>(gr, LT, w2t, H, nullptr, hs, LT, true, R, H, C, 3,
                    slab);                                     // dpre
    __syncthreads();
    gemm_any<false>(hs, LT, w1t, C, nullptr, gr, C, false, R, C, H, 0,
                    slab);                                     // dgrid
    __syncthreads();
    gemm_any<true>(tr, MS, gr, C, nullptr, acc, C, false, M, C, R, 4,
                   slab);                                      // tg^T dgrid
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MC; i += blockDim.x) dx[p * MC + i] = acc[i];
}

// the tile widths need N % TN == 0 for N in {C, H}
bool dims_ok(int M, int C, int H) {
  auto ok = [](int n) {
    return n <= 128 ? n % 4 == 0 : n <= 256 ? n % 8 == 0 : n % 16 == 0;
  };
  return M <= GC && C <= 512 && H <= 512 && ok(C) && ok(H);
}

}  // namespace

extern "C" {

int k2_fwd(int P, int M, int C, int H, int G, const float* x,
           const float* w1, const float* b1, const float* w2,
           const float* b2, const float* tg, const float* fg, float* out,
           void* stream) {
  if (!dims_ok(M, C, H)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(M, C, H, false);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return (int)err;
  ffn_fwd<<<P, 256, smem, (cudaStream_t)stream>>>(M, C, H, G, x, w1, b1, w2,
                                                  b2, tg, fg, out);
  return (int)cudaGetLastError();
}

int k2_bwd(int P, int M, int C, int H, int G, const float* x, const float* g,
           const float* w1, const float* b1, const float* w1t,
           const float* w2t, const float* tg, const float* fg, float* dx,
           void* stream) {
  if (!dims_ok(M, C, H)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(M, C, H, true);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return (int)err;
  ffn_bwd<<<P, 256, smem, (cudaStream_t)stream>>>(M, C, H, G, x, g, w1, b1,
                                                  w1t, w2t, tg, fg, dx);
  return (int)cudaGetLastError();
}

}  // extern "C"
