// K2: the eSCN per-node S2-grid feed-forward network, forward and
// backward, f32, for Hopper (sm_90a).
//
// Replaces pdb2reaction_tpu/mlip/escn_ffn_kernel.py: _ffn_fwd_kernel
// (forward) and _ffn_bwd_kernel (input cotangent), reached from
// fused_node_ffn through _ffn_fwd_call / _ffn_bwd_call.
//
// Per node p:  grid = tg[G,M] @ x_p[M,C]
//              h    = silu(grid @ W1 + b1)          [G, H]
//              y    = h @ W2 + b2                   [G, C]
//              out  = fg[M,G] @ y
// The backward recomputes from the saved input x:
//              dy = fg^T @ g_p;  dpre = (dy @ W2^T) * silu'(grid @ W1 + b1)
//              dx_p = tg^T @ (dpre @ W1^T)
//
// What bounds it: arithmetic. At escn-md (P = 320, G = 460, M = 25,
// C = 128, H = 256) a forward is 21.2 GFLOP, 91% of it the two FFN
// products [G, C] x [C, H] and [G, H] x [H, C] of every node, against
// ~9 MB of inputs and outputs. Only the tensor cores pass the CUDA cores'
// 67 TFLOP/s, and at f32 accuracy that means the 3xTF32 split. So each
// step runs as one plain GEMM on the grouped 3xTF32 wgmma kernel of
// tf32_gemm.cuh (conv_tf32, tagged node_ffn), with the activation in its
// epilogue, and the (node, grid point) rows in (g, p) order: the grid is
// [G, P, C] = [G*P, C], so the table products over m are plain GEMMs too
// (tg [G, Mp] times x laid out [P*C, Mp]; Mp = M rounded up to 4 with zero
// columns, which both operands carry), the FFN products are [G*P, C] x
// [C, H] and back, and only the sums over g that return to the nodes need
// a kernel of their own (grid_sum). The price is that the [G*P, H] hidden
// activations and two [G*P, C] grids pass through device memory (~0.6 GB
// a forward, ~1.1 GB a backward at escn-md, ~0.2 / 0.3 ms of HBM time);
// the TPU kernel keeps them on chip. Scratch comes from the caller.
//
// Forward:  grid = tgp xc^T                      [G, P*C]  (conv_tf32)
//           h    = silu(grid W1t^T + b1)         [G*P, H]  (conv_tf32)
//           y    = h W2t^T + b2, over grid       [G*P, C]  (conv_tf32)
//           out[p, m, c] = sum_g fgtp[g, m] y[g, p*C + c]  (grid_sum)
// Backward: grid = tgp xc^T;  s = silu'(grid W1t^T + b1)   [G*P, H]
//           dy   = fgtp gc^T, over grid          [G, P*C]
//           s   *= dy W2^T  (dpre, in place)     [G*P, H]
//           dgrid = s W1^T, over grid            [G*P, C]
//           dx[p, m, c] = sum_g tgp[g, m] dgrid[g, p*C + c] (grid_sum)
// No atomics: every sum runs in a fixed order, so results repeat bit for
// bit.

#include <cuda_runtime.h>

#include "tf32_gemm.cuh"

namespace {

// grid_sum: a block owns GS_COLS columns n = p*C + c of Y; its GS_WARPS
// warps split g into GS_WARPS contiguous ranges, each lane walks its
// range in order with one accumulator per m (M <= 32), loading GS_DEPTH
// rows of its column before it uses them and reading the table's row g
// (the same 16-byte chunks for the whole warp) through L1. Then the
// warps' sums are added in warp order. Its bound is the read of Y (75 MB
// at escn-md, 0.022 ms on an H100); it takes ~0.11 ms there, and deeper
// batches, more columns a lane or more warps a block were no faster (a
// cp.async ring of Y rows is untried).
constexpr int GS_COLS = 32, GS_WARPS = 8, GS_MAXM = 32, GS_DEPTH = 4;

// out[p, m, c] = sum_g T[g, m] Y[g, p*C + c] for m < M; T [G, Mp] with
// Mp a multiple of 4 (the padded tables tgp and fgtp)
__global__ void __launch_bounds__(GS_COLS * GS_WARPS)
    grid_sum(int M, int Mp, int G, int N, int C, const float* __restrict__ T,
             const float* __restrict__ Y, float* __restrict__ out) {
  __shared__ float red[GS_WARPS * GS_MAXM * GS_COLS];  // the warps' sums
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = blockIdx.x * GS_COLS + lane;
  const bool live = n < N;
  const int per = (G + GS_WARPS - 1) / GS_WARPS;
  const int ga = min(G, w * per), gb = min(G, ga + per);
  float acc[GS_MAXM];
#pragma unroll
  for (int m = 0; m < GS_MAXM; ++m) acc[m] = 0.f;
  for (int g0 = ga; g0 < gb; g0 += GS_DEPTH) {
    // rows past gb read as 0 (and the table's last row, finite)
    float yv[GS_DEPTH];
#pragma unroll
    for (int u = 0; u < GS_DEPTH; ++u)
      yv[u] = live && g0 + u < gb ? Y[(size_t)(g0 + u) * N + n] : 0.f;
#pragma unroll
    for (int u = 0; u < GS_DEPTH; ++u) {
      const float4* t4 = reinterpret_cast<const float4*>(
          T + (size_t)min(g0 + u, G - 1) * Mp);
#pragma unroll
      for (int q = 0; q < GS_MAXM / 4; ++q) {
        if (4 * q < Mp) {
          const float4 t = __ldg(t4 + q);
          acc[4 * q] = fmaf(t.x, yv[u], acc[4 * q]);
          acc[4 * q + 1] = fmaf(t.y, yv[u], acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(t.z, yv[u], acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(t.w, yv[u], acc[4 * q + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < GS_MAXM; ++m)
    red[(w * GS_MAXM + m) * GS_COLS + lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < M * GS_COLS; i += blockDim.x) {
    const int m = i / GS_COLS, col = i - m * GS_COLS;
    const int nn = blockIdx.x * GS_COLS + col;
    if (nn >= N) continue;
    float s = 0.f;
    for (int v = 0; v < GS_WARPS; ++v)
      s += red[(v * GS_MAXM + m) * GS_COLS + col];
    const int p = nn / C, c = nn - p * C;
    out[((size_t)p * M + m) * C + c] = s;
  }
}

cudaError_t run_grid_sum(cudaStream_t st, int M, int Mp, int G, int P,
                         int C, const float* T, const float* Y, float* out) {
  if (M > Mp || Mp > GS_MAXM || Mp % 4 || !al16(T))
    return cudaErrorInvalidValue;
  const int N = P * C;
  grid_sum<<<(N + GS_COLS - 1) / GS_COLS, GS_COLS * GS_WARPS, 0, st>>>(
      M, Mp, G, N, C, T, Y, out);
  return cudaGetLastError();
}

// one conv_tf32 launch of K2: C[rows, n] = f(A[rows, k] B[n, k]^T + bias)
template <int EPI>
cudaError_t gemm(cudaStream_t st, int rows, int n, int k, const float* a,
                 const float* b, const float* bias, float* c, int ldc) {
  Group gr;
  gr.nb = 0;
  gr.m = rows;
  add_op(gr, a, k, b, k, bias, c, ldc, n, k);
  return run_group<EPI, node_ffn>(st, gr);
}

bool dims_bad(int M, int Mp, int C, int H) {
  return Mp > GS_MAXM || Mp < M || Mp % 4 || C % 4 || H % 4;
}

}  // namespace

extern "C" {

// xc [P*C, Mp]: x[p, m, c] at row p*C + c, column m, zero columns M..Mp;
// tgp [G, Mp] and fgtp [G, Mp] the zero-padded tg and fg^T; w1t [H, C],
// w2t [C, H]; scratch grid [G*P*C], hid [G*P*H]; out [P, M, C].
int k2_fwd(int P, int M, int Mp, int C, int H, int G, const float* xc,
           const float* tgp, const float* fgtp, const float* w1t,
           const float* b1, const float* w2t, const float* b2, float* grid,
           float* hid, float* out, void* stream) {
  if (dims_bad(M, Mp, C, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int R = G * P;
  cudaError_t err;
  if ((err = gemm<EPI_BIAS>(st, G, P * C, Mp, tgp, xc, nullptr, grid,
                            P * C)))
    return (int)err;
  if ((err = gemm<EPI_SILU>(st, R, H, C, grid, w1t, b1, hid, H)))
    return (int)err;
  if ((err = gemm<EPI_BIAS>(st, R, C, H, hid, w2t, b2, grid, C)))
    return (int)err;
  return (int)run_grid_sum(st, M, Mp, G, P, C, fgtp, grid, out);
}

// gc [P*C, Mp] the output cotangent laid out as xc; w1 [C, H] and
// w2 [H, C] as stored; scratch grid [G*P*C], s [G*P*H]; dx [P, M, C].
int k2_bwd(int P, int M, int Mp, int C, int H, int G, const float* xc,
           const float* gc, const float* tgp, const float* fgtp,
           const float* w1t, const float* b1, const float* w1,
           const float* w2, float* grid, float* s, float* dx,
           void* stream) {
  if (dims_bad(M, Mp, C, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int R = G * P;
  cudaError_t err;
  if ((err = gemm<EPI_BIAS>(st, G, P * C, Mp, tgp, xc, nullptr, grid,
                            P * C)))
    return (int)err;
  if ((err = gemm<EPI_DSILU>(st, R, H, C, grid, w1t, b1, s, H)))
    return (int)err;
  if ((err = gemm<EPI_BIAS>(st, G, P * C, Mp, fgtp, gc, nullptr, grid,
                            P * C)))
    return (int)err;
  if ((err = gemm<EPI_MUL>(st, R, H, C, grid, w2, nullptr, s, H)))
    return (int)err;
  if ((err = gemm<EPI_BIAS>(st, R, C, H, s, w1, nullptr, grid, C)))
    return (int)err;
  return (int)run_grid_sum(st, M, Mp, G, P, C, tgp, grid, dx);
}

// The steps alone (tests and timing; no K2 launch is counted): one K2
// GEMM, c[rows, n] = f(a[rows, k] b[n, k]^T + bias) with epi the Epi
// mode (EPI_MUL multiplies into c), and one grid_sum.
int k2_gemm(int epi, int rows, int n, int k, const float* a, const float* b,
            const float* bias, float* c, int ldc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (epi == EPI_BIAS)
    err = gemm<EPI_BIAS>(st, rows, n, k, a, b, bias, c, ldc);
  else if (epi == EPI_SILU)
    err = gemm<EPI_SILU>(st, rows, n, k, a, b, bias, c, ldc);
  else if (epi == EPI_DSILU)
    err = gemm<EPI_DSILU>(st, rows, n, k, a, b, bias, c, ldc);
  else if (epi == EPI_MUL)
    err = gemm<EPI_MUL>(st, rows, n, k, a, b, bias, c, ldc);
  return (int)err;
}

int k2_grid_sum(int M, int Mp, int G, int P, int C, const float* T,
                const float* Y, float* out, void* stream) {
  return (int)run_grid_sum((cudaStream_t)stream, M, Mp, G, P, C, T, Y, out);
}

}  // extern "C"
