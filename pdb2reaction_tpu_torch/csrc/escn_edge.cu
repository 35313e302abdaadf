// The eSCN edge-message kernels, forward and backward, f32, for Hopper
// (sm_90a). Three entry pairs share one chain of stages:
//   K1 k1_fwd / k1_bwd: the node-resident layer ("mega"). Replaces
//      pdb2reaction_tpu/mlip/escn_edge_kernel.py _fwd_kernel_mega and
//      _bwd_kernel_mega (fused_edge_mega).
//   K3 k3_fwd / k3_bwd: the same chain on per-edge source and target rows
//      that the caller gathered, with a per-edge output that the caller
//      K-sums. Replaces _fwd_kernel_full and _bwd_kernel_full
//      (fused_edge_block, edge_kernel="pallas-full").
//   K4 k4_fwd / k4_bwd: conv 1 -> S2 activation -> conv 2 alone, on
//      rotated pair rows the caller built. Replaces _fwd_kernel and
//      _bwd_kernel (fused_edge_chain, edge_kernel="pallas").
// src_scatter is the deterministic backward of the callers' source
// gather on the K3/K4 paths (no TPU kernel: XLA's scatter there).
// conv_pair runs the two conv products of one direction alone (timing).
//
// K1 in detail (K3 and K4 drop stages of it, as said at their entries):
//
// What it computes, per edge e = p*K + k (target atom p, source src[e]):
//   rotate the source and target node rows into the reduced |m| <= mmax
//   edge-frame basis with the packed Wigner nonzeros Dp (block-sparse),
//   SO(2) conv 1 (m0 block also takes the edge scalars; each m>0 real/imag
//   pair is one merged block), separable S2 activation on the edge grid,
//   SO(2) conv 2, rotate back with Dpe (envelope folded in) and sum the K
//   edges of each target atom.
//
// What bounds it: arithmetic. At escn-md (C = h = 128, K = 32, P = 320)
// one layer is ~132 GFLOP forward against ~45 MB of inputs; the conv
// products are 95% of it. K3 and K4 do the same conv products against
// 0.4-0.9 GB of per-edge inputs and outputs, still far below the bytes
// the card moves in that time. So:
//   - the conv products run on the tensor cores in the 3xTF32 split (f32
//     accuracy at three TF32 products per product), one grouped launch per
//     conv for all |m| blocks (conv_tf32 of tf32_gemm.cuh: 128 x 128
//     output tiles of all blocks in one grid, the blocks with the longest
//     k first, so the tails of the blocks' waves overlap), multiplied by
//     wgmma from shared memory. Operands arrive by cp.async in a
//     three-stage ring; each thread splits the 16-byte chunks it copied
//     into hi and lo planes once. The three products of a 32-k slice go
//     into an accumulator that starts the slice at zero and is added to
//     the sum on CUDA cores (the tensor cores round their accumulator
//     toward zero, a bias that grows with the k steps summed in it). Both
//     operands are k-contiguous: the forward multiplies by the transposed
//     weight packs, the backward by the untransposed ones;
//   - the block-sparse rotations are bound by bytes and latency: the
//     rotation tables are staged in shared memory once per block; threads
//     own (row, 4 channels) and move float4s; the per-atom sums (the
//     forward K-sum, the backward node cotangent) run one block per (atom,
//     32-channel slice); the per-nonzero reductions (g_Dp, g_Dpe) stage the
//     edge's rows in shared memory and give each nonzero one thread;
//   - the S2 activation is a small per-(edge, channel) kernel;
//   - the backward's source scatter is deterministic: each atom's block
//     reduces the cotangents of the edges whose source is that atom in the
//     order of a source-sorted edge permutation (CSR) the wrapper builds
//     once per call. No atomics anywhere, so results repeat bit for bit.
// Intermediates between the stages live in device memory (~0.7 GB per
// layer at escn-md); conv 1 and conv 2 outputs are saved for the backward
// as the TPU kernel saves them.
//
// Layouts (the wrapper converts from the public [features, edges] ones):
//   x      [P, M*C]   node rows, m-major, channel-minor
//   es     [E, Ce]    edge scalars
//   dp/dpe [E, nnz]   packed rotation nonzeros
//   abuf   [E, Dtot]  conv-1 input: [m0 rows (nl0*2C), es (Ce), m1 rows,
//                     m2 rows, ...], each rotated row = 2C (source C then
//                     target C); Dtot = U*2C + Ce
//   msg    [E, U*H]   conv-1 output (u-major, h-minor), saved
//   act    [E, U*H]   S2 activation output
//   outsv  [E, U*C]   conv-2 output, saved
//   y      [P, M*C]   K-summed message per target atom
// Weights come packed per |m| block, in row-vector orientation [in, out]
// (w1, w2) and transposed [out, in] (w1t, w2t); block m>0 is the merged
// [[Wr, Wi], [-Wi, Wr]]. Every column offset and row stride is a multiple
// of 4 floats (C, H and Ce are), which the 16-byte copies need; the
// entries return cudaErrorInvalidValue otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_gemm.cuh"

#define MAXU 32

namespace {

// the conv products of K1, K3 and K4: C = A B^T (+ bias), one grouped
// launch (conv_tf32 in tf32_gemm.cuh)
cudaError_t run_conv(cudaStream_t st, const Group& gr) {
  return run_group<EPI_BIAS, edge_conv>(st, gr);
}

__device__ __forceinline__ void fma4(float4& a, float s, const float4& b) {
  a.x = fmaf(s, b.x, a.x);
  a.y = fmaf(s, b.y, a.y);
  a.z = fmaf(s, b.z, a.z);
  a.w = fmaf(s, b.w, a.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// sizes the rotation stages share
struct Dims {
  int K;          // edges per target atom (1: per-edge rows, K3)
  int C, Ce, U, M, nl0, nnz, MC, Dtot;
};

// column of rotated row u (channel 0) in abuf / gpr
__device__ __forceinline__ int rot_col(Dims d, int u) {
  return u * 2 * d.C + (u >= d.nl0 ? d.Ce : 0);
}

// Rotation tables, int arrays packed back to back (the wrapper's order):
// u_of_j[nnz], m_of_j[nnz], byu_ptr[U+1], byu_idx[nnz], bym_ptr[M+1],
// bym_idx[nnz]; staged in shared memory once per block
struct Tabs {
  const int *u_of_j, *m_of_j, *byu_ptr, *byu_idx, *bym_ptr, *bym_idx;
};

// ints of the staged tables, rounded up to 16 bytes
__host__ __device__ int tab_words(Dims d) {
  return (4 * d.nnz + d.U + d.M + 2 + 3) & ~3;
}

// copy the tables into s; the caller synchronises before reading them
__device__ Tabs stage_tabs(Dims d, const int* __restrict__ t, int* s) {
  const int n = 4 * d.nnz + d.U + d.M + 2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = t[i];
  Tabs r;
  r.u_of_j = s;
  r.m_of_j = s + d.nnz;
  r.byu_ptr = s + 2 * d.nnz;
  r.byu_idx = r.byu_ptr + d.U + 1;
  r.bym_ptr = r.byu_idx + d.nnz;
  r.bym_idx = r.bym_ptr + d.M + 1;
  return r;
}

// n rows of w floats (w a multiple of 4) at stride ld -> shared at pitch pp
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int ld, int n, int w, float* dst,
                                           int pp) {
  const int w4 = w >> 2;
  for (int q = threadIdx.x; q < n * w4; q += blockDim.x) {
    const int r = q / w4, c = q - r * w4;
    reinterpret_cast<float4*>(dst + r * pp)[c] =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)r * ld) + c);
  }
}

constexpr int EB = 4;            // edges per block of rotate_in
constexpr int CS4 = 8;           // float4s per channel slice (32 channels)

// --------------------------------------------------------------------------
// forward stages
// --------------------------------------------------------------------------

// EB edges a block, one thread per (edge, row u, 4 channels): gather +
// block-sparse rotation into abuf; copy es. The source row of edge e is
// row src[e] of x_s (row e when src is null), its target row is row e / K
// of x_t.
__global__ void __launch_bounds__(256)
rotate_in(Dims d, int E, const float* __restrict__ x_s,
          const int64_t* __restrict__ src, const float* __restrict__ x_t,
          const float* __restrict__ es, const float* __restrict__ dp,
          const int* __restrict__ tabs, float* __restrict__ abuf) {
  extern __shared__ __align__(16) int tsm[];
  const Tabs tb = stage_tabs(d, tabs, tsm);
  __syncthreads();
  const int C4 = d.C >> 2, per = d.U * C4, e0 = blockIdx.x * EB;
  const int ne = min(EB, E - e0);
  for (int q = threadIdx.x; q < ne * per; q += blockDim.x) {
    const int el = q / per, r = q - el * per, u = r / C4, c4 = r - u * C4;
    const int e = e0 + el;
    const float4* xs = reinterpret_cast<const float4*>(
                           x_s + (size_t)(src ? src[e] : e) * d.MC) + c4;
    const float4* xt =
        reinterpret_cast<const float4*>(x_t + (size_t)(e / d.K) * d.MC) + c4;
    const float* de = dp + (size_t)e * d.nnz;
    float4 rs = make_float4(0.f, 0.f, 0.f, 0.f), rt = rs;
    for (int p = tb.byu_ptr[u]; p < tb.byu_ptr[u + 1]; ++p) {
      const int j = tb.byu_idx[p];
      const float dj = __ldg(de + j);
      const int mo = tb.m_of_j[j] * C4;
      fma4(rs, dj, __ldg(xs + mo));
      fma4(rt, dj, __ldg(xt + mo));
    }
    float4* row = reinterpret_cast<float4*>(abuf + (size_t)e * d.Dtot +
                                            rot_col(d, u));
    row[c4] = rs;
    row[C4 + c4] = rt;
  }
  const int Ce4 = d.Ce >> 2;
  for (int q = threadIdx.x; q < ne * Ce4; q += blockDim.x) {
    const int el = q / Ce4, c = q - el * Ce4;
    const size_t e = e0 + el;
    reinterpret_cast<float4*>(abuf + e * d.Dtot + d.nl0 * 2 * d.C)[c] =
        __ldg(reinterpret_cast<const float4*>(es + e * d.Ce) + c);
  }
}

// one thread per (edge, hidden channel): separable S2 activation. UM is
// U rounded up to the next instantiated size, so the unrolled per-row
// register arrays carry few unused rows.
template <int UM>
__global__ void act_fwd(int E, int H, int U, int G,
                        const float* __restrict__ msg,
                        const float* __restrict__ tg,
                        const float* __restrict__ fg,
                        float* __restrict__ act) {
  extern __shared__ float sm[];
  float* tgs = sm;            // [G, U]
  float* fgs = sm + G * U;    // [U, G]
  for (int i = threadIdx.x; i < G * U; i += blockDim.x) {
    tgs[i] = tg[i];
    fgs[i] = fg[i];
  }
  __syncthreads();
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)E * H) return;
  const size_t e = t / H;
  const int c = (int)(t % H);
  const float* mrow = msg + e * U * H + c;
  float m[UM], acc[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    m[u] = u < U ? mrow[(size_t)u * H] : 0.f;
    acc[u] = 0.f;
  }
  for (int g = 0; g < G; ++g) {
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < UM; ++u)
      if (u < U) s = fmaf(tgs[g * U + u], m[u], s);
    const float a = silu(s);
#pragma unroll
    for (int u = 0; u < UM; ++u)
      if (u < U) acc[u] = fmaf(fgs[u * G + g], a, acc[u]);
  }
  float* arow = act + e * U * H + c;
  arow[0] = silu(m[0]);
#pragma unroll
  for (int u = 1; u < UM; ++u)
    if (u < U) arow[(size_t)u * H] = acc[u];
}

// one block per (target atom, 32-channel slice), one thread per (m, 4
// channels): rotate back with Dpe and sum the atom's K edges in edge
// order (K = 1, a block per edge: the per-edge back-rotation of K3)
__global__ void __launch_bounds__(256)
back_ksum(Dims d, const float* __restrict__ outsv,
          const float* __restrict__ dpe, const int* __restrict__ tabs,
          float* __restrict__ y) {
  extern __shared__ __align__(16) int tsm[];
  const Tabs tb = stage_tabs(d, tabs, tsm);
  __syncthreads();
  const int p = blockIdx.x, C4 = d.C >> 2, c4a = blockIdx.y * CS4;
  const int cw = min(CS4, C4 - c4a);
  for (int q = threadIdx.x; q < d.M * cw; q += blockDim.x) {
    const int m = q / cw, c4 = c4a + q - m * cw;
    const int q0 = tb.bym_ptr[m], q1 = tb.bym_ptr[m + 1];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < d.K; ++k) {
      const size_t e = (size_t)p * d.K + k;
      const float* de = dpe + e * d.nnz;
      const float4* o =
          reinterpret_cast<const float4*>(outsv + e * d.U * d.C) + c4;
      for (int i = q0; i < q1; ++i) {
        const int j = tb.bym_idx[i];
        fma4(acc, __ldg(de + j), __ldg(o + tb.u_of_j[j] * C4));
      }
    }
    reinterpret_cast<float4*>(y + (size_t)p * d.MC + m * d.C)[c4] = acc;
  }
}

// --------------------------------------------------------------------------
// backward stages
// --------------------------------------------------------------------------

// one block per edge: back-rotation transpose (g_out, a thread per (row u,
// 4 channels)) and g_Dpe (a thread per nonzero) from the edge's cotangent
// row (row e / K of gnode) and conv-2 output row, both staged in shared
// memory at a pitch of C + 4 floats
__global__ void __launch_bounds__(128)
rot_out_bwd(Dims d, const float* __restrict__ gnode,
            const float* __restrict__ dpe, const float* __restrict__ outsv,
            const int* __restrict__ tabs, float* __restrict__ gout,
            float* __restrict__ gdpe) {
  extern __shared__ __align__(16) int tsm[];
  const Tabs tb = stage_tabs(d, tabs, tsm);
  const int pc = d.C + 4, C4 = d.C >> 2, pc4 = pc >> 2;
  float* gn = reinterpret_cast<float*>(tsm + tab_words(d));   // [M][pc]
  float* os = gn + d.M * pc;                                  // [U][pc]
  const size_t e = blockIdx.x;
  stage_rows(gnode + (e / d.K) * d.MC, d.C, d.M, d.C, gn, pc);
  stage_rows(outsv + e * d.U * d.C, d.C, d.U, d.C, os, pc);
  __syncthreads();
  const float* de = dpe + e * d.nnz;
  const float4* gn4 = reinterpret_cast<const float4*>(gn);
  const float4* os4 = reinterpret_cast<const float4*>(os);
  for (int q = threadIdx.x; q < d.U * C4; q += blockDim.x) {
    const int u = q / C4, c4 = q - u * C4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tb.byu_ptr[u]; i < tb.byu_ptr[u + 1]; ++i) {
      const int j = tb.byu_idx[i];
      fma4(acc, __ldg(de + j), gn4[tb.m_of_j[j] * pc4 + c4]);
    }
    reinterpret_cast<float4*>(gout + e * d.U * d.C)[q] = acc;
  }
  for (int j = threadIdx.x; j < d.nnz; j += blockDim.x) {
    const float4* o = os4 + tb.u_of_j[j] * pc4;
    const float4* g = gn4 + tb.m_of_j[j] * pc4;
    float s = 0.f;
    for (int c4 = 0; c4 < C4; ++c4) s = dot4(o[c4], g[c4], s);
    gdpe[e * d.nnz + j] = s;
  }
}

// one thread per (edge, hidden channel): S2 activation VJP, in place
// (g_act in, g_msg out)
template <int UM>
__global__ void act_bwd(int E, int H, int U, int G,
                        const float* __restrict__ msg,
                        const float* __restrict__ tg,
                        const float* __restrict__ fg,
                        float* __restrict__ g) {
  extern __shared__ float sm[];
  float* tgs = sm;
  float* fgs = sm + G * U;
  for (int i = threadIdx.x; i < G * U; i += blockDim.x) {
    tgs[i] = tg[i];
    fgs[i] = fg[i];
  }
  __syncthreads();
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)E * H) return;
  const size_t e = t / H;
  const int c = (int)(t % H);
  const float* mrow = msg + e * U * H + c;
  float* grow = g + e * U * H + c;
  float m[UM], ga[UM], gm[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    m[u] = u < U ? mrow[(size_t)u * H] : 0.f;
    ga[u] = u < U ? grow[(size_t)u * H] : 0.f;
    gm[u] = 0.f;
  }
  for (int gi = 0; gi < G; ++gi) {
    float s = 0.f, gg = 0.f;
#pragma unroll
    for (int u = 0; u < UM; ++u)
      if (u < U) s = fmaf(tgs[gi * U + u], m[u], s);
#pragma unroll
    for (int u = 1; u < UM; ++u)      // row 0 of the grid branch is unused
      if (u < U) gg = fmaf(fgs[u * G + gi], ga[u], gg);
    const float sg = 1.f / (1.f + expf(-s));
    gg *= sg * (1.f + s * (1.f - sg));
#pragma unroll
    for (int u = 0; u < UM; ++u)
      if (u < U) gm[u] = fmaf(tgs[gi * U + u], gg, gm[u]);
  }
  const float s0 = m[0];
  const float sg0 = 1.f / (1.f + expf(-s0));
  gm[0] += ga[0] * sg0 * (1.f + s0 * (1.f - sg0));
#pragma unroll
  for (int u = 0; u < UM; ++u)
    if (u < U) grow[(size_t)u * H] = gm[u];
}

// one block per edge, a thread per nonzero: g_Dp from the rotated-pair
// cotangent; the edge's source and target node rows (picked as in
// rotate_in) and its rotated gpr rows staged in shared memory
__global__ void __launch_bounds__(128)
gdp_bwd(Dims d, const float* __restrict__ x_s,
        const int64_t* __restrict__ src, const float* __restrict__ x_t,
        const float* __restrict__ gpr, const int* __restrict__ tabs,
        float* __restrict__ gdp) {
  extern __shared__ __align__(16) int tsm[];
  const Tabs tb = stage_tabs(d, tabs, tsm);
  const int pc = d.C + 4, pg = 2 * d.C + 4, C4 = d.C >> 2;
  float* xs = reinterpret_cast<float*>(tsm + tab_words(d));   // [M][pc]
  float* xt = xs + d.M * pc;                                  // [M][pc]
  float* gp = xt + d.M * pc;                                  // [U][pg]
  const size_t e = blockIdx.x;
  stage_rows(x_s + (size_t)(src ? src[e] : e) * d.MC, d.C, d.M, d.C, xs, pc);
  stage_rows(x_t + (e / d.K) * d.MC, d.C, d.M, d.C, xt, pc);
  const float* gr = gpr + e * d.Dtot;
  for (int q = threadIdx.x; q < d.U * 2 * C4; q += blockDim.x) {
    const int u = q / (2 * C4), c = q - u * 2 * C4;
    reinterpret_cast<float4*>(gp + u * pg)[c] =
        __ldg(reinterpret_cast<const float4*>(gr + rot_col(d, u)) + c);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d.nnz; j += blockDim.x) {
    const float4* a = reinterpret_cast<const float4*>(xs + tb.m_of_j[j] * pc);
    const float4* b = reinterpret_cast<const float4*>(xt + tb.m_of_j[j] * pc);
    const float4* g = reinterpret_cast<const float4*>(gp + tb.u_of_j[j] * pg);
    float s = 0.f;
    for (int c4 = 0; c4 < C4; ++c4) {
      s = dot4(a[c4], g[c4], s);
      s = dot4(b[c4], g[C4 + c4], s);
    }
    gdp[e * d.nnz + j] = s;
  }
}

// one block per (atom, 32-channel slice), one thread per (m, 4 channels):
// node cotangent = rotation transpose of the target halves of the atom's
// own K edges + the source halves of the edges whose source it is, in
// source-sorted (CSR) order: a deterministic scatter
__global__ void __launch_bounds__(256)
gx_bwd(Dims d, const float* __restrict__ dp, const float* __restrict__ gpr,
       const int* __restrict__ src_ptr, const int* __restrict__ src_perm,
       const int* __restrict__ tabs, float* __restrict__ gx) {
  extern __shared__ __align__(16) int tsm[];
  const Tabs tb = stage_tabs(d, tabs, tsm);
  __syncthreads();
  const int p = blockIdx.x, C4 = d.C >> 2, c4a = blockIdx.y * CS4;
  const int cw = min(CS4, C4 - c4a);
  const int s0 = src_ptr[p], s1 = src_ptr[p + 1];
  for (int q = threadIdx.x; q < d.M * cw; q += blockDim.x) {
    const int m = q / cw, c4 = c4a + q - m * cw;
    const int q0 = tb.bym_ptr[m], q1 = tb.bym_ptr[m + 1];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < d.K; ++k) {
      const size_t e = (size_t)p * d.K + k;
      const float* de = dp + e * d.nnz;
      const float* gr = gpr + e * d.Dtot + d.C;
      for (int i = q0; i < q1; ++i) {
        const int j = tb.bym_idx[i];
        fma4(acc, __ldg(de + j),
             __ldg(reinterpret_cast<const float4*>(
                       gr + rot_col(d, tb.u_of_j[j])) + c4));
      }
    }
    for (int t = s0; t < s1; ++t) {
      const size_t e = (size_t)src_perm[t];
      const float* de = dp + e * d.nnz;
      const float* gr = gpr + e * d.Dtot;
      for (int i = q0; i < q1; ++i) {
        const int j = tb.bym_idx[i];
        fma4(acc, __ldg(de + j),
             __ldg(reinterpret_cast<const float4*>(
                       gr + rot_col(d, tb.u_of_j[j])) + c4));
      }
    }
    reinterpret_cast<float4*>(gx + (size_t)p * d.MC + m * d.C)[c4] = acc;
  }
}

// one block per (edge, 32-channel slice): rotation transpose of K3, the
// source and target halves of the rotated-pair cotangent back to per-edge
// node rows (the caller's gather and repeat reduce them; no scatter here)
__global__ void __launch_bounds__(256)
rot_in_bwd(Dims d, const float* __restrict__ dp,
           const float* __restrict__ gpr, const int* __restrict__ tabs,
           float* __restrict__ gxs, float* __restrict__ gxt) {
  extern __shared__ __align__(16) int tsm[];
  const Tabs tb = stage_tabs(d, tabs, tsm);
  __syncthreads();
  const size_t e = blockIdx.x;
  const int C4 = d.C >> 2, c4a = blockIdx.y * CS4;
  const int cw = min(CS4, C4 - c4a);
  const float* de = dp + e * d.nnz;
  const float* gr = gpr + e * d.Dtot;
  for (int q = threadIdx.x; q < d.M * cw; q += blockDim.x) {
    const int m = q / cw, c4 = c4a + q - m * cw;
    float4 as = make_float4(0.f, 0.f, 0.f, 0.f), at = as;
    for (int i = tb.bym_ptr[m]; i < tb.bym_ptr[m + 1]; ++i) {
      const int j = tb.bym_idx[i];
      const float dj = __ldg(de + j);
      const float4* g =
          reinterpret_cast<const float4*>(gr + rot_col(d, tb.u_of_j[j]));
      fma4(as, dj, __ldg(g + c4));
      fma4(at, dj, __ldg(g + C4 + c4));
    }
    reinterpret_cast<float4*>(gxs + e * d.MC + m * d.C)[c4] = as;
    reinterpret_cast<float4*>(gxt + e * d.MC + m * d.C)[c4] = at;
  }
}

// one block per atom: out[p] = sum of the rows g[perm[t]] over
// t in [ptr[p], ptr[p+1]), in that order (deterministic, no atomics)
__global__ void csr_rows_sum(int F, const int* __restrict__ ptr,
                             const int* __restrict__ perm,
                             const float* __restrict__ g,
                             float* __restrict__ out) {
  const int p = blockIdx.x;
  const int t0 = ptr[p], t1 = ptr[p + 1];
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc = 0.f;
    for (int t = t0; t < t1; ++t) acc += g[(size_t)perm[t] * F + f];
    out[(size_t)p * F + f] = acc;
  }
}

template <bool BWD>
cudaError_t launch_act(cudaStream_t st, int E, int H, int U, int G,
                       const float* msg, const float* tg, const float* fg,
                       float* io) {
  const size_t nt = (size_t)E * H;
  const unsigned blocks = (unsigned)((nt + 127) / 128);
  const size_t smem = 2 * sizeof(float) * G * U;
#define ACT(UMV)                                                          \
  if (U <= UMV) {                                                         \
    if (BWD)                                                              \
      act_bwd<UMV><<<blocks, 128, smem, st>>>(E, H, U, G, msg, tg, fg, io); \
    else                                                                  \
      act_fwd<UMV><<<blocks, 128, smem, st>>>(E, H, U, G, msg, tg, fg, io); \
    return cudaGetLastError();                                            \
  }
  ACT(8) ACT(12) ACT(20) ACT(MAXU)
#undef ACT
  return cudaErrorInvalidValue;
}

// a rotation stage's launch: dynamic shared memory above 48 KB is asked
// for first (a refused launch never runs; the caller reads the error)
template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, dim3 grid, int threads, size_t smem,
                   cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  kern<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// block geometry of the packed weights
// --------------------------------------------------------------------------
struct Geo {
  int nb;                  // number of |m| blocks (mmax + 1)
  int U;                   // reduced rows in all
  int nl[MAXMB];           // rows of the reduced basis per half-block
  int inC[MAXMB];          // conv-1 input width per block
  int in_col[MAXMB];       // column of block b in abuf / gpr
  int pr_col[MAXMB];       // column of block b in K4's pair rows (no es)
  int hid_col[MAXMB];      // column of block b in msg / act  (x H)
  int out_col[MAXMB];      // column of block b in outsv      (x C)
  size_t w1_off[MAXMB], b1_off[MAXMB], w2_off[MAXMB], b2_off[MAXMB];
};

Geo make_geo(int C, int H, int Ce, int lmax, int mmax) {
  Geo g;
  g.nb = mmax + 1;
  const int nl0 = lmax + 1;
  int in_col = 0, hid = 0, out = 0;
  size_t w1 = 0, b1 = 0, w2 = 0, b2 = 0;
  g.U = 0;
  for (int b = 0; b < g.nb && b < MAXMB; ++b) {
    const int rows = b == 0 ? nl0 : 2 * (lmax + 1 - b);   // U rows in block
    g.nl[b] = rows;
    g.U += rows;
    g.inC[b] = rows * 2 * C + (b == 0 ? Ce : 0);
    g.in_col[b] = in_col;
    g.pr_col[b] = in_col - (b == 0 ? 0 : Ce);
    g.hid_col[b] = hid;
    g.out_col[b] = out;
    g.w1_off[b] = w1;
    g.b1_off[b] = b1;
    g.w2_off[b] = w2;
    g.b2_off[b] = b2;
    in_col += g.inC[b];
    hid += rows * H;
    out += rows * C;
    w1 += (size_t)g.inC[b] * rows * H;
    b1 += (size_t)rows * H;
    w2 += (size_t)rows * H * rows * C;
    b2 += (size_t)rows * C;
  }
  return g;
}

// a configuration the kernels do not take: too many blocks or rows, or
// widths whose column offsets are not 16-byte aligned
bool bad_geo(const Geo& g, int mmax, int C, int H, int Ce) {
  return mmax + 1 > MAXMB || g.U > MAXU || C % 4 || H % 4 || Ce % 4;
}

Dims make_dims(const Geo& g, int K, int C, int Ce, int lmax, int nnz) {
  Dims d;
  d.K = K;
  d.C = C;
  d.Ce = Ce;
  d.U = g.U;
  d.nl0 = lmax + 1;
  d.M = d.nl0 * d.nl0;
  d.nnz = nnz;
  d.MC = d.M * C;
  d.Dtot = g.U * 2 * C + Ce;
  return d;
}

// the four convs, each one grouped launch over the |m| blocks
// conv 1: block b reads its input columns at a[b] with row stride lda[b],
// times the transposed pack w1t (block b is [nl*H, inC], k contiguous)
Group conv1_fwd(const Geo& g, int E, int H, const float* const* a,
                const int* lda, const float* w1t, const float* b1,
                float* msg) {
  Group gr;
  gr.nb = 0;
  gr.m = E;
  for (int b = 0; b < g.nb; ++b)
    add_op(gr, a[b], lda[b], w1t + g.w1_off[b], g.inC[b], b1 + g.b1_off[b],
           msg + g.hid_col[b], g.U * H, g.nl[b] * H, g.inC[b]);
  return gr;
}

// conv 2: act times w2t (block b is [nl*C, nl*H])
Group conv2_fwd(const Geo& g, int E, int C, int H, const float* act,
                const float* w2t, const float* b2, float* outsv) {
  Group gr;
  gr.nb = 0;
  gr.m = E;
  for (int b = 0; b < g.nb; ++b)
    add_op(gr, act + g.hid_col[b], g.U * H, w2t + g.w2_off[b], g.nl[b] * H,
           b2 + g.b2_off[b], outsv + g.out_col[b], g.U * C, g.nl[b] * C,
           g.nl[b] * H);
  return gr;
}

// conv2^T: the conv-2 output cotangent times w2 (block b is [nl*H, nl*C])
Group conv2_bwd(const Geo& g, int E, int C, int H, const float* gout,
                const float* w2, float* gact) {
  Group gr;
  gr.nb = 0;
  gr.m = E;
  for (int b = 0; b < g.nb; ++b)
    add_op(gr, gout + g.out_col[b], g.U * C, w2 + g.w2_off[b], g.nl[b] * C,
           nullptr, gact + g.hid_col[b], g.U * H, g.nl[b] * H, g.nl[b] * C);
  return gr;
}

// conv1^T: g_msg times w1 (block b is [inC, nl*H]); block b of the conv-1
// input cotangent goes to c[b] with row stride ldc[b]
Group conv1_bwd(const Geo& g, int E, int H, const float* gact,
                const float* w1, float* const* c, const int* ldc) {
  Group gr;
  gr.nb = 0;
  gr.m = E;
  for (int b = 0; b < g.nb; ++b)
    add_op(gr, gact + g.hid_col[b], g.U * H, w1 + g.w1_off[b], g.nl[b] * H,
           nullptr, c[b], ldc[b], g.inC[b], g.nl[b] * H);
  return gr;
}

// conv 1 -> S2 activation -> conv 2 over E edges
cudaError_t chain_fwd(cudaStream_t st, const Geo& g, int E, int C, int H,
                      int G, const float* const* a, const int* lda,
                      const float* w1t, const float* b1, const float* w2t,
                      const float* b2, const float* tg, const float* fg,
                      float* msg, float* act, float* outsv) {
  cudaError_t err;
  if ((err = run_conv(st, conv1_fwd(g, E, H, a, lda, w1t, b1, msg))))
    return err;
  if ((err = launch_act<false>(st, E, H, g.U, G, msg, tg, fg, act)))
    return err;
  return run_conv(st, conv2_fwd(g, E, C, H, act, w2t, b2, outsv));
}

// conv2^T -> S2 activation VJP -> conv1^T from the conv-2 output
// cotangent gout [E, U*C]
cudaError_t chain_bwd(cudaStream_t st, const Geo& g, int E, int C, int H,
                      int G, const float* gout, const float* msg,
                      const float* w1, const float* w2, const float* tg,
                      const float* fg, float* gact, float* const* c,
                      const int* ldc) {
  cudaError_t err;
  if ((err = run_conv(st, conv2_bwd(g, E, C, H, gout, w2, gact))))
    return err;
  if ((err = launch_act<true>(st, E, H, g.U, G, msg, tg, fg, gact)))
    return err;
  return run_conv(st, conv1_bwd(g, E, H, gact, w1, c, ldc));
}

// abuf-layout operand pointers: block b at column in_col[b], stride Dtot
void abuf_cols(const Geo& g, float* base, int Dtot, float** p, int* ld) {
  for (int b = 0; b < g.nb; ++b) {
    p[b] = base + g.in_col[b];
    ld[b] = Dtot;
  }
}

// [rows, w] column block copy between two row-major matrices
cudaError_t copy_cols(cudaStream_t st, float* dst, int ldd, const float* src,
                      int lds, int w, int rows) {
  return cudaMemcpy2DAsync(dst, (size_t)ldd * sizeof(float), src,
                           (size_t)lds * sizeof(float),
                           (size_t)w * sizeof(float), rows,
                           cudaMemcpyDeviceToDevice, st);
}

// the launches of the rotation stages, shared by K1 and K3
size_t tab_bytes(const Dims& d) { return sizeof(int) * tab_words(d); }

dim3 slices(int rows, const Dims& d) {
  return dim3(rows, ((d.C >> 2) + CS4 - 1) / CS4);
}

cudaError_t run_rotate_in(cudaStream_t st, const Dims& d, int E,
                          const float* x_s, const int64_t* src,
                          const float* x_t, const float* es, const float* dp,
                          const int* tabs, float* abuf) {
  return launch(rotate_in, dim3((E + EB - 1) / EB), 256, tab_bytes(d), st, d,
                E, x_s, src, x_t, es, dp, tabs, abuf);
}

cudaError_t run_rot_out_bwd(cudaStream_t st, const Dims& d, int E,
                            const float* gnode, const float* dpe,
                            const float* outsv, const int* tabs, float* gout,
                            float* gdpe) {
  const size_t smem = tab_bytes(d) + sizeof(float) * (d.M + d.U) * (d.C + 4);
  return launch(rot_out_bwd, dim3(E), 128, smem, st, d, gnode, dpe, outsv,
                tabs, gout, gdpe);
}

cudaError_t run_gdp_bwd(cudaStream_t st, const Dims& d, int E,
                        const float* x_s, const int64_t* src,
                        const float* x_t, const float* gpr, const int* tabs,
                        float* gdp) {
  const size_t smem = tab_bytes(d) + sizeof(float) * (2 * d.M * (d.C + 4) +
                                                      d.U * (2 * d.C + 4));
  return launch(gdp_bwd, dim3(E), 128, smem, st, d, x_s, src, x_t, gpr, tabs,
                gdp);
}

}  // namespace

extern "C" {

// K1 forward. Returns the first CUDA error of the launch sequence (0 = ok).
int k1_fwd(int P, int K, int C, int H, int Ce, int lmax, int mmax, int nnz,
           int G, const float* x, const int64_t* src, const float* es,
           const float* dp, const float* dpe, const float* w1t,
           const float* b1, const float* w2t, const float* b2,
           const float* tg, const float* fg, const int* tabs, float* abuf,
           float* msg, float* act, float* outsv, float* y, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Geo g = make_geo(C, H, Ce, lmax, mmax);
  if (bad_geo(g, mmax, C, H, Ce)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(g, K, C, Ce, lmax, nnz);
  const int E = P * K;
  cudaError_t err;
  if ((err = run_rotate_in(st, d, E, x, src, x, es, dp, tabs, abuf)))
    return (int)err;
  float* a[MAXMB];
  int lda[MAXMB];
  abuf_cols(g, abuf, d.Dtot, a, lda);
  if ((err = chain_fwd(st, g, E, C, H, G, a, lda, w1t, b1, w2t, b2, tg, fg,
                       msg, act, outsv)))
    return (int)err;
  return (int)launch(back_ksum, slices(P, d), 256, tab_bytes(d), st, d,
                     (const float*)outsv, dpe, tabs, y);
}

// K1 backward: input cotangents gx [P, M*C], g_Dp / g_Dpe [E, nnz]; the
// edge-scalar cotangent is columns [nl0*2C, nl0*2C + Ce) of gpr.
int k1_bwd(int P, int K, int C, int H, int Ce, int lmax, int mmax, int nnz,
           int G, const float* x, const float* gnode, const int64_t* src,
           const int* src_ptr, const int* src_perm, const float* dp,
           const float* dpe, const float* msg, const float* outsv,
           const float* w1, const float* w2, const float* tg,
           const float* fg, const int* tabs, float* gout, float* gact,
           float* gpr, float* gx, float* gdp, float* gdpe, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Geo g = make_geo(C, H, Ce, lmax, mmax);
  if (bad_geo(g, mmax, C, H, Ce)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(g, K, C, Ce, lmax, nnz);
  const int E = P * K;
  cudaError_t err;
  if ((err = run_rot_out_bwd(st, d, E, gnode, dpe, outsv, tabs, gout, gdpe)))
    return (int)err;
  float* c[MAXMB];
  int ldc[MAXMB];
  abuf_cols(g, gpr, d.Dtot, c, ldc);
  if ((err = chain_bwd(st, g, E, C, H, G, gout, msg, w1, w2, tg, fg, gact,
                       c, ldc)))
    return (int)err;
  if ((err = run_gdp_bwd(st, d, E, x, src, x, gpr, tabs, gdp)))
    return (int)err;
  return (int)launch(gx_bwd, slices(P, d), 256, tab_bytes(d), st, d, dp,
                     (const float*)gpr, src_ptr, src_perm, tabs, gx);
}

// K3 forward: K1's stages on per-edge rows xs, xt [E, M*C] (edge e reads
// row e of each), back-rotated per edge into y [E, M*C] with no K-sum.
int k3_fwd(int E, int C, int H, int Ce, int lmax, int mmax, int nnz, int G,
           const float* xs, const float* xt, const float* es,
           const float* dp, const float* dpe, const float* w1t,
           const float* b1, const float* w2t, const float* b2,
           const float* tg, const float* fg, const int* tabs, float* abuf,
           float* msg, float* act, float* outsv, float* y, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Geo g = make_geo(C, H, Ce, lmax, mmax);
  if (bad_geo(g, mmax, C, H, Ce)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(g, 1, C, Ce, lmax, nnz);
  cudaError_t err;
  if ((err = run_rotate_in(st, d, E, xs, nullptr, xt, es, dp, tabs, abuf)))
    return (int)err;
  float* a[MAXMB];
  int lda[MAXMB];
  abuf_cols(g, abuf, d.Dtot, a, lda);
  if ((err = chain_fwd(st, g, E, C, H, G, a, lda, w1t, b1, w2t, b2, tg, fg,
                       msg, act, outsv)))
    return (int)err;
  return (int)launch(back_ksum, slices(E, d), 256, tab_bytes(d), st, d,
                     (const float*)outsv, dpe, tabs, y);
}

// K3 backward: from the per-edge output cotangent gy [E, M*C], the
// per-edge input cotangents gxs, gxt [E, M*C], g_Dp / g_Dpe [E, nnz]; the
// edge-scalar cotangent is columns [nl0*2C, nl0*2C + Ce) of gpr.
int k3_bwd(int E, int C, int H, int Ce, int lmax, int mmax, int nnz, int G,
           const float* xs, const float* xt, const float* gy,
           const float* dp, const float* dpe, const float* msg,
           const float* outsv, const float* w1, const float* w2,
           const float* tg, const float* fg, const int* tabs, float* gout,
           float* gact, float* gpr, float* gxs, float* gxt, float* gdp,
           float* gdpe, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Geo g = make_geo(C, H, Ce, lmax, mmax);
  if (bad_geo(g, mmax, C, H, Ce)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(g, 1, C, Ce, lmax, nnz);
  cudaError_t err;
  if ((err = run_rot_out_bwd(st, d, E, gy, dpe, outsv, tabs, gout, gdpe)))
    return (int)err;
  float* c[MAXMB];
  int ldc[MAXMB];
  abuf_cols(g, gpr, d.Dtot, c, ldc);
  if ((err = chain_bwd(st, g, E, C, H, G, gout, msg, w1, w2, tg, fg, gact,
                       c, ldc)))
    return (int)err;
  if ((err = run_gdp_bwd(st, d, E, xs, nullptr, xt, gpr, tabs, gdp)))
    return (int)err;
  return (int)launch(rot_in_bwd, slices(E, d), 256, tab_bytes(d), st, d, dp,
                     (const float*)gpr, tabs, gxs, gxt);
}

// K4 forward: conv 1 -> S2 activation -> conv 2 on rotated pair rows
// pr [E, U*2C] (u-major, source C then target C) and es [E, Ce], into
// out [E, U*C]. The m0 block's input (its pair rows, then es) is staged
// into x0 [E, nl0*2C + Ce]; the m > 0 blocks read pr in place.
int k4_fwd(int E, int C, int H, int Ce, int lmax, int mmax, int G,
           const float* pr, const float* es, const float* w1t,
           const float* b1, const float* w2t, const float* b2,
           const float* tg, const float* fg, float* x0, float* msg,
           float* act, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nl0 = lmax + 1;
  const Geo g = make_geo(C, H, Ce, lmax, mmax);
  if (bad_geo(g, mmax, C, H, Ce)) return (int)cudaErrorInvalidValue;
  const int PR = g.U * 2 * C, W0 = nl0 * 2 * C;
  cudaError_t err;
  if ((err = copy_cols(st, x0, g.inC[0], pr, PR, W0, E))) return (int)err;
  if ((err = copy_cols(st, x0 + W0, g.inC[0], es, Ce, Ce, E)))
    return (int)err;
  const float* a[MAXMB];
  int lda[MAXMB];
  for (int b = 0; b < g.nb; ++b) {
    a[b] = b == 0 ? x0 : pr + g.pr_col[b];
    lda[b] = b == 0 ? g.inC[0] : PR;
  }
  return (int)chain_fwd(st, g, E, C, H, G, a, lda, w1t, b1, w2t, b2, tg, fg,
                        msg, act, out);
}

// K4 backward: from the output cotangent gout [E, U*C], gpr [E, U*2C] and
// ges [E, Ce]. The m0 block's cotangent lands in g0 [E, nl0*2C + Ce] and
// is split into gpr and ges.
int k4_bwd(int E, int C, int H, int Ce, int lmax, int mmax, int G,
           const float* msg, const float* gout, const float* w1,
           const float* w2, const float* tg, const float* fg, float* gact,
           float* g0, float* gpr, float* ges, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nl0 = lmax + 1;
  const Geo g = make_geo(C, H, Ce, lmax, mmax);
  if (bad_geo(g, mmax, C, H, Ce)) return (int)cudaErrorInvalidValue;
  const int PR = g.U * 2 * C, W0 = nl0 * 2 * C;
  cudaError_t err;
  float* c[MAXMB];
  int ldc[MAXMB];
  for (int b = 0; b < g.nb; ++b) {
    c[b] = b == 0 ? g0 : gpr + g.pr_col[b];
    ldc[b] = b == 0 ? g.inC[0] : PR;
  }
  if ((err = chain_bwd(st, g, E, C, H, G, gout, msg, w1, w2, tg, fg, gact,
                       c, ldc)))
    return (int)err;
  if ((err = copy_cols(st, gpr, PR, g0, g.inC[0], W0, E))) return (int)err;
  return (int)copy_cols(st, ges, Ce, g0 + W0, g.inC[0], Ce, E);
}

// The two conv products of one direction alone, on K1's layouts (for
// timing the GEMM): bwd = 0 runs conv 1 (abuf-layout in [E, Dtot] -> mid
// [E, U*H], w = w1t) then conv 2 (mid -> out [E, U*C], w = w2t); bwd = 1
// runs conv2^T (in [E, U*C] -> mid, w = w2) then conv1^T (mid -> out
// [E, Dtot], w = w1). Biases are used by the forward only.
int conv_pair(int E, int C, int H, int Ce, int lmax, int mmax, int bwd,
              const float* in, const float* wa, const float* ba,
              const float* wb, const float* bb, float* mid, float* out,
              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Geo g = make_geo(C, H, Ce, lmax, mmax);
  if (bad_geo(g, mmax, C, H, Ce)) return (int)cudaErrorInvalidValue;
  const int Dtot = g.U * 2 * C + Ce;
  float* p[MAXMB];
  int ld[MAXMB];
  cudaError_t err;
  if (!bwd) {
    abuf_cols(g, const_cast<float*>(in), Dtot, p, ld);
    if ((err = run_conv(st, conv1_fwd(g, E, H, p, ld, wa, ba, mid))))
      return (int)err;
    return (int)run_conv(st, conv2_fwd(g, E, C, H, mid, wb, bb, out));
  }
  abuf_cols(g, out, Dtot, p, ld);
  if ((err = run_conv(st, conv2_bwd(g, E, C, H, in, wa, mid))))
    return (int)err;
  return (int)run_conv(st, conv1_bwd(g, E, H, mid, wb, p, ld));
}

// Deterministic backward of a row gather: out [P, F] row p = sum of the
// rows g[perm[t]] for t in [ptr[p], ptr[p+1]) (a source-sorted CSR).
int src_scatter(int P, int F, const int* ptr, const int* perm,
                const float* g, float* out, void* stream) {
  csr_rows_sum<<<P, 256, 0, (cudaStream_t)stream>>>(F, ptr, perm, g, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
