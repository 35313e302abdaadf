// K1: the eSCN node-resident edge-message layer ("mega" kernel), forward
// and backward, f32, for Hopper (sm_90a).
//
// Replaces pdb2reaction_tpu/mlip/escn_edge_kernel.py: _fwd_kernel_mega
// (forward) and _bwd_kernel_mega (input cotangents), reached from
// fused_edge_mega through _fwd_call_mega / _bwd_call_mega.
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
// products are 95% of it. The design therefore spends its effort on the
// products and keeps the rest simple:
//   - the conv products run as a shared-memory tiled SGEMM (128x128
//     tiles, 8x8 outputs per thread, register-prefetched double-buffered
//     k slices) over all E edges at once, one launch per |m| block,
//     reading the weights once per 128-edge tile instead of once per edge;
//   - the gathers are indexed loads (no one-hot products: those were a
//     TPU compiler workaround);
//   - the block-sparse rotations, the S2 activation and the K-sum are
//     small per-edge kernels between the products;
//   - the forward K-sum runs one block per target atom over that atom's
//     K edges, so it needs no atomics;
//   - the backward's source scatter is deterministic: one block per atom
//     reduces the cotangents of the edges whose source is that atom,
//     through a source-sorted edge permutation (CSR) the wrapper builds
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
// Weights come packed per |m| block in row-vector orientation [in, out];
// block m>0 is the merged [[Wr, Wi], [-Wi, Wr]].

#include <cuda_runtime.h>
#include <stdint.h>

#define MAXU 32
#define MAXMB 5

namespace {

// --------------------------------------------------------------------------
// tiled SGEMM: C[M,N] = A[M,K] @ B[K,N] (+ bias[N]), row-major
// 128 x 128 block tile, 8-deep k slices, 256 threads with 8 x 8 outputs
// each (two 4-row and two 4-column strips, so shared-memory reads are
// float4 and conflict-free). The next k slice is loaded into registers
// while the current one is multiplied, into the other of two shared
// buffers: one barrier per slice, load latency hidden behind arithmetic.
// --------------------------------------------------------------------------
constexpr int BM = 128, BN = 128, BK = 8;

__global__ void __launch_bounds__(256)
sgemm_nn(int M, int N, int K, const float* __restrict__ A, int lda,
         const float* __restrict__ B, int ldb, const float* __restrict__ bias,
         float* __restrict__ Cm, int ldc) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // loader mapping: A tile 128 x 8 -> thread loads rows ar, ar+64 at k ak..
  const int ar = tid >> 2, ak = (tid & 3) * 2;     // 2 k per row, 2 rows
  const int bk = tid >> 5, bc = (tid & 31) * 4;    // 4 cols of one k row
  float ra[4], rb[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int gr = row0 + ar + 64 * h, gk = k0 + ak + q;
        ra[2 * h + q] = (gr < M && gk < K) ? A[(size_t)gr * lda + gk] : 0.f;
      }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gk = k0 + bk, gc = col0 + bc + q;
      rb[q] = (gk < K && gc < N) ? B[(size_t)gk * ldb + gc] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) As[buf][ak + q][ar + 64 * h] = ra[2 * h + q];
    *reinterpret_cast<float4*>(&Bs[buf][bk][bc]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gc < N)
        Cm[(size_t)gr * ldc + gc] = acc[i][j] + (bias ? bias[gc] : 0.f);
    }
  }
}

cudaError_t gemm(cudaStream_t st, int M, int N, int K, const float* A,
                 int lda, const float* B, int ldb, const float* bias,
                 float* Cm, int ldc) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  sgemm_nn<<<grid, 256, 0, st>>>(M, N, K, A, lda, B, ldb, bias, Cm, ldc);
  return cudaGetLastError();
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rotation tables, device int arrays packed back to back:
// u_of_j[nnz], m_of_j[nnz], byu_ptr[U+1], byu_idx[nnz], bym_ptr[M+1],
// bym_idx[nnz].
struct Tabs {
  const int *u_of_j, *m_of_j, *byu_ptr, *byu_idx, *bym_ptr, *bym_idx;
};

Tabs make_tabs(const int* t, int nnz, int U, int M) {
  Tabs r;
  r.u_of_j = t;
  r.m_of_j = t + nnz;
  r.byu_ptr = t + 2 * nnz;
  r.byu_idx = r.byu_ptr + U + 1;
  r.bym_ptr = r.byu_idx + nnz;
  r.bym_idx = r.bym_ptr + M + 1;
  return r;
}

// column of rotated row u (channel 0) in abuf / gpr
__device__ __forceinline__ int rot_col(int u, int C, int Ce, int nl0) {
  return u * 2 * C + (u >= nl0 ? Ce : 0);
}

// --------------------------------------------------------------------------
// forward stages
// --------------------------------------------------------------------------

// one warp per edge: gather + block-sparse rotation into abuf; copy es
__global__ void rotate_in(int E, int K, int C, int Ce, int U, int nl0,
                          int nnz, int MC, int Dtot,
                          const float* __restrict__ x,
                          const int64_t* __restrict__ src,
                          const float* __restrict__ es,
                          const float* __restrict__ dp, Tabs tb,
                          float* __restrict__ abuf) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= E) return;
  const int p = e / K;
  const float* xs = x + (size_t)src[e] * MC;
  const float* xt = x + (size_t)p * MC;
  const float* d = dp + (size_t)e * nnz;
  float* row = abuf + (size_t)e * Dtot;
  for (int u = 0; u < U; ++u) {
    const int col = rot_col(u, C, Ce, nl0);
    const int q0 = tb.byu_ptr[u], q1 = tb.byu_ptr[u + 1];
    for (int c = lane; c < C; c += 32) {
      float rs = 0.f, rt = 0.f;
      for (int q = q0; q < q1; ++q) {
        const int j = tb.byu_idx[q];
        const int m = tb.m_of_j[j];
        const float dj = d[j];
        rs = fmaf(dj, xs[m * C + c], rs);
        rt = fmaf(dj, xt[m * C + c], rt);
      }
      row[col + c] = rs;
      row[col + C + c] = rt;
    }
  }
  for (int i = lane; i < Ce; i += 32)
    row[nl0 * 2 * C + i] = es[(size_t)e * Ce + i];
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

// one block per target atom: rotate back with Dpe and sum its K edges
__global__ void back_ksum(int K, int C, int U, int M, int nnz,
                          const float* __restrict__ outsv,
                          const float* __restrict__ dpe, Tabs tb,
                          float* __restrict__ y) {
  const int p = blockIdx.x;
  const int MC = M * C;
  for (int idx = threadIdx.x; idx < MC; idx += blockDim.x) {
    const int m = idx / C, c = idx - m * C;
    const int q0 = tb.bym_ptr[m], q1 = tb.bym_ptr[m + 1];
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const size_t e = (size_t)p * K + k;
      const float* d = dpe + e * nnz;
      const float* o = outsv + e * U * C;
      for (int q = q0; q < q1; ++q) {
        const int j = tb.bym_idx[q];
        acc = fmaf(d[j], o[tb.u_of_j[j] * C + c], acc);
      }
    }
    y[(size_t)p * MC + idx] = acc;
  }
}

// --------------------------------------------------------------------------
// backward stages
// --------------------------------------------------------------------------

// one warp per edge: back-rotation transpose (g_out) and g_Dpe
__global__ void rot_out_bwd(int E, int K, int C, int U, int nnz, int MC,
                            const float* __restrict__ gnode,
                            const float* __restrict__ dpe,
                            const float* __restrict__ outsv, Tabs tb,
                            float* __restrict__ gout,
                            float* __restrict__ gdpe) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= E) return;
  const float* gb = gnode + (size_t)(e / K) * MC;
  const float* d = dpe + (size_t)e * nnz;
  const float* o = outsv + (size_t)e * U * C;
  float* go = gout + (size_t)e * U * C;
  for (int u = 0; u < U; ++u) {
    const int q0 = tb.byu_ptr[u], q1 = tb.byu_ptr[u + 1];
    for (int c = lane; c < C; c += 32) {
      float acc = 0.f;
      for (int q = q0; q < q1; ++q) {
        const int j = tb.byu_idx[q];
        acc = fmaf(d[j], gb[tb.m_of_j[j] * C + c], acc);
      }
      go[u * C + c] = acc;
    }
  }
  for (int j = 0; j < nnz; ++j) {
    const float* ou = o + tb.u_of_j[j] * C;
    const float* gm = gb + tb.m_of_j[j] * C;
    float part = 0.f;
    for (int c = lane; c < C; c += 32) part = fmaf(ou[c], gm[c], part);
    part = warp_sum(part);
    if (lane == 0) gdpe[(size_t)e * nnz + j] = part;
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

// one warp per edge: g_Dp from the rotated-pair cotangent
__global__ void gdp_bwd(int E, int K, int C, int Ce, int nl0, int nnz,
                        int MC, int Dtot, const float* __restrict__ x,
                        const int64_t* __restrict__ src,
                        const float* __restrict__ gpr, Tabs tb,
                        float* __restrict__ gdp) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= E) return;
  const float* xs = x + (size_t)src[e] * MC;
  const float* xt = x + (size_t)(e / K) * MC;
  const float* gr = gpr + (size_t)e * Dtot;
  for (int j = 0; j < nnz; ++j) {
    const int col = rot_col(tb.u_of_j[j], C, Ce, nl0);
    const int mo = tb.m_of_j[j] * C;
    float part = 0.f;
    for (int c = lane; c < C; c += 32) {
      part = fmaf(xs[mo + c], gr[col + c], part);
      part = fmaf(xt[mo + c], gr[col + C + c], part);
    }
    part = warp_sum(part);
    if (lane == 0) gdp[(size_t)e * nnz + j] = part;
  }
}

// one block per atom: node cotangent = rotation transpose of the target
// halves of its own K edges + the source halves of the edges whose source
// it is (deterministic scatter through the source-sorted permutation)
__global__ void gx_bwd(int K, int C, int Ce, int M, int nl0, int nnz,
                       int Dtot, const float* __restrict__ dp,
                       const float* __restrict__ gpr,
                       const int* __restrict__ src_ptr,
                       const int* __restrict__ src_perm, Tabs tb,
                       float* __restrict__ gx) {
  const int p = blockIdx.x;
  const int MC = M * C;
  const int s0 = src_ptr[p], s1 = src_ptr[p + 1];
  for (int idx = threadIdx.x; idx < MC; idx += blockDim.x) {
    const int m = idx / C, c = idx - m * C;
    const int q0 = tb.bym_ptr[m], q1 = tb.bym_ptr[m + 1];
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const size_t e = (size_t)p * K + k;
      const float* d = dp + e * nnz;
      const float* gr = gpr + e * Dtot + C + c;
      for (int q = q0; q < q1; ++q) {
        const int j = tb.bym_idx[q];
        acc = fmaf(d[j], gr[rot_col(tb.u_of_j[j], C, Ce, nl0)], acc);
      }
    }
    for (int t = s0; t < s1; ++t) {
      const size_t e = (size_t)src_perm[t];
      const float* d = dp + e * nnz;
      const float* gr = gpr + e * Dtot + c;
      for (int q = q0; q < q1; ++q) {
        const int j = tb.bym_idx[q];
        acc = fmaf(d[j], gr[rot_col(tb.u_of_j[j], C, Ce, nl0)], acc);
      }
    }
    gx[(size_t)p * MC + idx] = acc;
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

// --------------------------------------------------------------------------
// block geometry of the packed weights
// --------------------------------------------------------------------------
struct Geo {
  int nb;                  // number of |m| blocks (mmax + 1)
  int nl[MAXMB];           // rows of the reduced basis per half-block
  int inC[MAXMB];          // conv-1 input width per block
  int in_col[MAXMB];       // column of block b in abuf / gpr
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
  for (int b = 0; b < g.nb; ++b) {
    const int rows = b == 0 ? nl0 : 2 * (lmax + 1 - b);   // U rows in block
    g.nl[b] = rows;
    g.inC[b] = rows * 2 * C + (b == 0 ? Ce : 0);
    g.in_col[b] = in_col;
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

}  // namespace

extern "C" {

// K1 forward. Returns the first CUDA error of the launch sequence (0 = ok).
int k1_fwd(int P, int K, int C, int H, int Ce, int lmax, int mmax, int nnz,
           int G, const float* x, const int64_t* src, const float* es,
           const float* dp, const float* dpe, const float* w1,
           const float* b1, const float* w2, const float* b2,
           const float* tg, const float* fg, const int* tabs, float* abuf,
           float* msg, float* act, float* outsv, float* y, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = (lmax + 1) * (lmax + 1);
  const int nl0 = lmax + 1;
  const Geo g = make_geo(C, H, Ce, lmax, mmax);
  int U = 0;
  for (int b = 0; b < g.nb; ++b) U += g.nl[b];
  if (U > MAXU || mmax + 1 > MAXMB) return (int)cudaErrorInvalidValue;
  const int E = P * K, MC = M * C, Dtot = U * 2 * C + Ce;
  const Tabs tb = make_tabs(tabs, nnz, U, M);
  cudaError_t err;

  rotate_in<<<(E * 32 + 255) / 256, 256, 0, st>>>(
      E, K, C, Ce, U, nl0, nnz, MC, Dtot, x, src, es, dp, tb, abuf);
  if ((err = cudaGetLastError())) return (int)err;
  for (int b = 0; b < g.nb; ++b) {
    err = gemm(st, E, g.nl[b] * H, g.inC[b], abuf + g.in_col[b], Dtot,
               w1 + g.w1_off[b], g.nl[b] * H, b1 + g.b1_off[b],
               msg + g.hid_col[b], U * H);
    if (err) return (int)err;
  }
  if ((err = launch_act<false>(st, E, H, U, G, msg, tg, fg, act)))
    return (int)err;
  for (int b = 0; b < g.nb; ++b) {
    err = gemm(st, E, g.nl[b] * C, g.nl[b] * H, act + g.hid_col[b], U * H,
               w2 + g.w2_off[b], g.nl[b] * C, b2 + g.b2_off[b],
               outsv + g.out_col[b], U * C);
    if (err) return (int)err;
  }
  back_ksum<<<P, 256, 0, st>>>(K, C, U, M, nnz, outsv, dpe, tb, y);
  return (int)cudaGetLastError();
}

// K1 backward: input cotangents gx [P, M*C], g_Dp / g_Dpe [E, nnz]; the
// edge-scalar cotangent is columns [nl0*2C, nl0*2C + Ce) of gpr.
int k1_bwd(int P, int K, int C, int H, int Ce, int lmax, int mmax, int nnz,
           int G, const float* x, const float* gnode, const int64_t* src,
           const int* src_ptr, const int* src_perm, const float* dp,
           const float* dpe, const float* msg, const float* outsv,
           const float* w1t, const float* w2t, const float* tg,
           const float* fg, const int* tabs, float* gout, float* gact,
           float* gpr, float* gx, float* gdp, float* gdpe, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = (lmax + 1) * (lmax + 1);
  const int nl0 = lmax + 1;
  const Geo g = make_geo(C, H, Ce, lmax, mmax);
  int U = 0;
  for (int b = 0; b < g.nb; ++b) U += g.nl[b];
  if (U > MAXU || mmax + 1 > MAXMB) return (int)cudaErrorInvalidValue;
  const int E = P * K, MC = M * C, Dtot = U * 2 * C + Ce;
  const Tabs tb = make_tabs(tabs, nnz, U, M);
  cudaError_t err;

  rot_out_bwd<<<(E * 32 + 255) / 256, 256, 0, st>>>(
      E, K, C, U, nnz, MC, gnode, dpe, outsv, tb, gout, gdpe);
  if ((err = cudaGetLastError())) return (int)err;
  // conv2^T: block b of w2t is [nl*C, nl*H]
  for (int b = 0; b < g.nb; ++b) {
    err = gemm(st, E, g.nl[b] * H, g.nl[b] * C, gout + g.out_col[b], U * C,
               w2t + g.w2_off[b], g.nl[b] * H, nullptr,
               gact + g.hid_col[b], U * H);
    if (err) return (int)err;
  }
  if ((err = launch_act<true>(st, E, H, U, G, msg, tg, fg, gact)))
    return (int)err;
  // conv1^T: block b of w1t is [nl*H, inC]
  for (int b = 0; b < g.nb; ++b) {
    err = gemm(st, E, g.inC[b], g.nl[b] * H, gact + g.hid_col[b], U * H,
               w1t + g.w1_off[b], g.inC[b], nullptr, gpr + g.in_col[b],
               Dtot);
    if (err) return (int)err;
  }
  gdp_bwd<<<(E * 32 + 255) / 256, 256, 0, st>>>(E, K, C, Ce, nl0, nnz, MC,
                                                Dtot, x, src, gpr, tb, gdp);
  if ((err = cudaGetLastError())) return (int)err;
  gx_bwd<<<P, 256, 0, st>>>(K, C, Ce, M, nl0, nnz, Dtot, dp, gpr, src_ptr,
                            src_perm, tb, gx);
  return (int)cudaGetLastError();
}

}  // extern "C"
