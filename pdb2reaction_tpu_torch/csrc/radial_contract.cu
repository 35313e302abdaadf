// K5: the radial contraction of the PaiNN-class model's pallas mode,
// forward and both gradients, f32 on CUDA cores, for Hopper (sm_90a).
//
//   T[i, r, f] = sum_j A[i, j, r] feats[j, f]                 (rc_fwd)
//   A[i, j, r] = sqrt(2/rc) sin((r+1) pi d/rc) / d^p * env(d)   r < R
//   A[i, j, R] = env(d) / d^(p-1)            p = 2 with div_d, else 1
//
// over pairs inside the cutoff, both atoms real (mask > 0), i != j by
// global index; d = sqrt(max(d^2, 1e-12)), and d = 1 outside the cutoff.
//
// Replaces pdb2reaction_tpu/mlip/pallas_ops.py, reached from
// radial_contract through radial_contract_tpu / _radial_contract_impl:
//   rc_fwd          <- _fwd_kernel:129
//   rc_bwd_feats    <- _transpose_kernel:352 (via _grad_feats)
//                      dfeats[j, f] = sum_{i, r} A[j, i, r] g[i, r, f]
//   rc_bwd_coords   <- _grad_coords_fused_kernel:256 (via _grad_coords_fused)
//                      dx_i = sum_j (G1 + G2^T)[i, j] (x_i - x_j) / d,
//                      G = sum_r dA_r/dd S_r, S1 = g_I feats_J^T,
//                      S2 = g_J feats_I^T (receiver and sender sides)
//
// What bounds them: arithmetic over the pairs inside the cutoff,
// 2 (R + 1) F FLOP per pair and launch (one S product for the coordinate
// gradient, since S2[i, j] = S1[j, i]); at the slice's shapes (P = 4096,
// F = 1024, R + 1 = 25, ~3% of pairs inside 6 A) that is ~26 GFLOP,
// about 0.4 ms at the f32 peak, against ~0.4 GB of device memory
// traffic. These kernels compute every pair instead: a dense
// [P*25, P] x [P, F] product (0.86 TFLOP; the coordinate gradient forms
// both S products, twice that). The adjacency itself (1.7 GB per stream
// at that size) never reaches device memory: every block builds its
// [25, TI, TJ] tile in shared memory from the coordinates (one sincosf
// per pair; the sin((r+1) t) ladder by the coupled rotation recurrence,
// whose f32 error grows linearly in r) and contracts it at once with a
// register-tiled
// product (8 x 8 outputs a thread, float4 shared-memory loads, 64
// multiply-adds per 4 loads). The coordinate gradient accumulates both S
// products over all of F in registers for a [25, 32, 32] pair tile, then
// applies the radial derivative once per pair. A block owns its output
// tile and loops over the contraction axis itself (the TPU's sequential
// grid axis); nothing is reduced across blocks and no atomics are used,
// so every result repeats bit for bit.
//
// Every tile is computed, as on the TPU, though only ~3% of pairs lie
// inside the cutoff at the slice's density. Later redesigns: a
// coordinate gradient with one S product (each (I, J) tile writes the
// partial dx of both sides to a [P/TI, P, 3] buffer that a second pass
// reduces in a fixed order), then skipping tiles with no pair inside the
// cutoff.
//
// K6: the same contraction for one block of Pr rows against all Pc
// columns (atom-axis sharding: each rank owns rows off .. off + Pr - 1 of
// the system and holds every column). Self-pairs are excluded by global
// index, off + i against j, so every shard drops exactly its own diagonal.
// Replaces pdb2reaction_tpu/mlip/pallas_ops.py, reached from
// radial_contract_rect through radial_contract_rect_tpu:
//   rc_rect_fwd        <- _fwd_kernel_rect:474 (via _rc_rect_impl)
//   rc_rect_bwd_feats  <- _transpose_kernel_rect:568 (via _rc_rect_bwd)
//                         dfeats[j, f] = sum_{i in rows, r} A[i, j, r] g[i, r, f]
//   rc_rect_bwd_xyz<rows> <- _grad_rows_kernel:594
//                         dx_rows[i] = sum_j G[i, j] (x_i - x_j) / d
//   rc_rect_bwd_xyz<cols> <- _grad_cols_kernel:623
//                         dx_cols[j] = sum_{i in rows} G[i, j] (x_j - x_i) / d
//   with G = sum_r dA_r/dd S_r and S = g_I feats_J^T (one product: K5's
//   S1 + S2 needs both sides of the square).
//
// What bounds them: as K5, the arithmetic over the pairs inside the
// cutoff with one atom in the row block, 2 (R + 1) F FLOP per pair and
// launch; at the sharded slice (Pr = 1024, Pc = 4096, F = 1024, R + 1 =
// 25) ~6.5 GFLOP, ~0.1 ms at the f32 peak, against ~0.12 GB of device
// memory. The kernels compute every pair, a dense 2 (R + 1) Pr Pc F
// (215 GFLOP). The design is K5's: the adjacency is built per tile in
// shared memory and contracted at once with register tiles of 8 x 8; a
// block owns its outputs and loops over the other axis itself, so
// nothing is reduced across blocks, no atomics are used and results
// repeat bit for bit. The forward and the feats gradient tile as K5's
// (the row loop runs over Pr). The row-coordinate gradient owns 8 rows
// a block against column tiles of 128 (64 above R + 1 = 32), so that a
// 1024-row block still gives 128 blocks; the column-coordinate gradient
// owns 32 columns against row tiles of 32 (16 above R + 1 = 32). Fusing
// the two coordinate gradients into one S product, and skipping empty
// tiles, are later redesigns.

#include <cuda_runtime.h>

namespace {

constexpr float PI_F = 3.14159265358979323846f;

struct Geo {
  float d, env, denv, s1, c1;
  bool in;
};

__device__ __forceinline__ Geo pair_geo(float xi, float yi, float zi,
                                        float mi, int gi, float xj, float yj,
                                        float zj, float mj, int gj,
                                        float rc) {
  const float dx = xi - xj, dy = yi - yj, dz = zi - zj;
  const float d = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f));
  Geo g;
  g.in = d <= rc && gi != gj && mi > 0.f && mj > 0.f;
  g.d = g.in ? d : 1.f;
  sincosf((PI_F / rc) * g.d, &g.s1, &g.c1);
  g.env = g.in ? 0.5f * (g.c1 + 1.f) : 0.f;
  g.denv = g.in ? -0.5f * (PI_F / rc) * g.s1 : 0.f;
  return g;
}

// the R + 1 adjacency values of one pair, written with a stride
template <bool DIVD>
__device__ __forceinline__ void a_column(const Geo& g, int R, float rc,
                                         float* dst, int stride) {
  const float inv = 1.f / g.d;
  float scale = g.env * inv * sqrtf(2.f / rc);
  float ench = g.env;
  if (DIVD) {
    scale *= inv;
    ench *= inv;
  }
  float s = g.s1, c = g.c1;
  for (int r = 0; r < R; ++r) {
    dst[r * stride] = s * scale;
    const float sn = s * g.c1 + c * g.s1;
    c = c * g.c1 - s * g.s1;
    s = sn;
  }
  dst[R * stride] = ench;
}

// G = sum_r dA_r/dd S_r for one pair (pallas_ops.py:_accum_G)
template <bool DIVD>
__device__ __forceinline__ float accum_g(const Geo& g, int R, float rc,
                                         const float* S, int stride) {
  if (!g.in) return 0.f;
  const float inv = 1.f / g.d;
  const float p = DIVD ? 2.f : 1.f;
  const float base = sqrtf(2.f / rc) * (DIVD ? inv * inv : inv);
  const float w = PI_F / rc;
  float s = g.s1, c = g.c1, G = 0.f;
  for (int r = 0; r < R; ++r) {
    const float dA = base * ((r + 1) * w * c * g.env + s * g.denv -
                             p * s * g.env * inv);
    G = fmaf(dA, S[r * stride], G);
    const float sn = s * g.c1 + c * g.s1;
    c = c * g.c1 - s * g.s1;
    s = sn;
  }
  // env-only channel: A_R = env / d^(p-1)
  const float pe = p - 1.f;
  G += (DIVD ? inv : 1.f) * (g.denv - pe * g.env * inv) * S[R * stride];
  return G;
}

__device__ __forceinline__ void ld8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void st8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float4 ld4_or_zero(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p)
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// forward: block = 8 rows i x 64 features, one thread per (r, 8 features)
// owning 8 i x 8 f outputs; loops over j in tiles of 32
// ---------------------------------------------------------------------------
constexpr int F_TI = 8, F_TJ = 32, F_FT = 64;

template <bool DIVD>
__global__ void __launch_bounds__(512)
rc_fwd(int P, int F, int R, float rc, const float* __restrict__ X,
       const float* __restrict__ M, const float* __restrict__ feats,
       float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float Xi[F_TI][4];
  const int R1 = R + 1;
  float* As = sm;                          // [F_TJ][R1][F_TI]
  float* Fs = sm + F_TJ * R1 * F_TI;       // [F_TJ][F_FT]
  const int t = threadIdx.x, nt = blockDim.x;
  const int i0 = blockIdx.x * F_TI, fb = blockIdx.y * F_FT;
  const int r = t / (F_FT / 8), fo = (t % (F_FT / 8)) * 8;
  if (t < F_TI) {
    const int gi = i0 + t;
    const bool ok = gi < P;
    Xi[t][0] = ok ? X[3 * gi] : 0.f;
    Xi[t][1] = ok ? X[3 * gi + 1] : 0.f;
    Xi[t][2] = ok ? X[3 * gi + 2] : 0.f;
    Xi[t][3] = ok ? M[gi] : 0.f;
  }
  float acc[F_TI][8];
#pragma unroll
  for (int a = 0; a < F_TI; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  for (int j0 = 0; j0 < P; j0 += F_TJ) {
    __syncthreads();
    for (int p = t; p < F_TI * F_TJ; p += nt) {
      const int ii = p % F_TI, jj = p / F_TI, gj = j0 + jj;
      const bool ok = gj < P;
      const Geo g = pair_geo(Xi[ii][0], Xi[ii][1], Xi[ii][2], Xi[ii][3],
                             i0 + ii, ok ? X[3 * gj] : 0.f,
                             ok ? X[3 * gj + 1] : 0.f,
                             ok ? X[3 * gj + 2] : 0.f, ok ? M[gj] : 0.f, gj,
                             rc);
      a_column<DIVD>(g, R, rc, As + jj * R1 * F_TI + ii, F_TI);
    }
    for (int q = t; q < F_TJ * F_FT / 4; q += nt) {
      const int jj = q / (F_FT / 4), c = (q % (F_FT / 4)) * 4, gj = j0 + jj;
      reinterpret_cast<float4*>(Fs + jj * F_FT + c)[0] = ld4_or_zero(
          feats + (size_t)gj * F + fb + c, gj < P && fb + c < F);
    }
    __syncthreads();
    for (int jj = 0; jj < F_TJ; ++jj) {
      float a[8], b[8];
      ld8(As + (jj * R1 + r) * F_TI, a);
      ld8(Fs + jj * F_FT + fo, b);
#pragma unroll
      for (int x = 0; x < F_TI; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
  }
  if (fb + fo < F) {
    for (int x = 0; x < F_TI; ++x) {
      const int gi = i0 + x;
      if (gi < P) st8(out + ((size_t)gi * R1 + r) * F + fb + fo, acc[x]);
    }
  }
}

// ---------------------------------------------------------------------------
// feats gradient: block = 64 rows j x 128 features, 128 threads each
// owning 8 j x 8 f; contracts over (i, r) in tiles of 2 atoms
// ---------------------------------------------------------------------------
constexpr int G_TJ = 64, G_TI = 2, G_FT = 128;

template <bool DIVD>
__global__ void __launch_bounds__(128)
rc_bwd_feats(int P, int F, int R, float rc, const float* __restrict__ X,
             const float* __restrict__ M, const float* __restrict__ g,
             float* __restrict__ dfeats) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float Xj[G_TJ][4];
  const int R1 = R + 1, K = G_TI * R1;
  float* At = sm;                  // [K][G_TJ], k = ii * R1 + r
  float* Gs = sm + K * G_TJ;       // [K][G_FT]
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * G_TJ, fb = blockIdx.y * G_FT;
  const int jo = (t / 16) * 8, fo = (t % 16) * 8;
  for (int q = t; q < G_TJ; q += blockDim.x) {
    const int gj = j0 + q;
    const bool ok = gj < P;
    Xj[q][0] = ok ? X[3 * gj] : 0.f;
    Xj[q][1] = ok ? X[3 * gj + 1] : 0.f;
    Xj[q][2] = ok ? X[3 * gj + 2] : 0.f;
    Xj[q][3] = ok ? M[gj] : 0.f;
  }
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  for (int i0 = 0; i0 < P; i0 += G_TI) {
    __syncthreads();
    for (int p = t; p < G_TI * G_TJ; p += blockDim.x) {
      const int jj = p % G_TJ, ii = p / G_TJ, gi = i0 + ii;
      const bool ok = gi < P;
      const Geo pg = pair_geo(Xj[jj][0], Xj[jj][1], Xj[jj][2], Xj[jj][3],
                              j0 + jj, ok ? X[3 * gi] : 0.f,
                              ok ? X[3 * gi + 1] : 0.f,
                              ok ? X[3 * gi + 2] : 0.f, ok ? M[gi] : 0.f, gi,
                              rc);
      a_column<DIVD>(pg, R, rc, At + ii * R1 * G_TJ + jj, G_TJ);
    }
    // rows (i, r) of g are the contiguous global rows i0 * R1 + k
    for (int q = t; q < K * G_FT / 4; q += blockDim.x) {
      const int k = q / (G_FT / 4), c = (q % (G_FT / 4)) * 4;
      const bool ok = i0 + k / R1 < P && fb + c < F;
      reinterpret_cast<float4*>(Gs + k * G_FT + c)[0] =
          ld4_or_zero(g + ((size_t)i0 * R1 + k) * F + fb + c, ok);
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      float a[8], b[8];
      ld8(At + k * G_TJ + jo, a);
      ld8(Gs + k * G_FT + fo, b);
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
  }
  if (fb + fo < F) {
    for (int x = 0; x < 8; ++x) {
      const int gj = j0 + jo + x;
      if (gj < P) st8(dfeats + (size_t)gj * F + fb + fo, acc[x]);
    }
  }
}

// ---------------------------------------------------------------------------
// coordinate gradient: block = 32 rows i; loops over j tiles of TJ; one
// thread per (r, 8 i, 8 j) accumulates S1 + S2 over all of F (chunks of
// 16 features staged k-major in shared memory), then the pair phase
// applies dA/dd once per pair and sums (x_i - x_j)/d-weighted terms in a
// fixed order
// ---------------------------------------------------------------------------
constexpr int C_TI = 32, C_FC = 16;

template <int TJ>
__host__ __device__ constexpr int coords_gemm_floats(int R1) {
  return C_FC * R1 * (C_TI + 4) + C_FC * R1 * (TJ + 4) + C_FC * C_TI +
         C_FC * TJ;
}

template <int TJ>
__host__ __device__ constexpr int coords_s_floats(int R1) {
  return R1 * C_TI * (TJ + 1);
}

template <int TJ, bool DIVD>
__global__ void __launch_bounds__(512)
rc_bwd_coords(int P, int F, int R, float rc, const float* __restrict__ X,
              const float* __restrict__ M, const float* __restrict__ feats,
              const float* __restrict__ g, float* __restrict__ dx) {
  extern __shared__ __align__(16) float sm[];
  constexpr int TIP = C_TI + 4, TJP = TJ + 4, TJS = TJ + 1;
  constexpr int NIG = C_TI / 8, NJG = TJ / 8, NQ = TJ / 4;
  __shared__ float Xi[C_TI][4], Xj[TJ][4];
  __shared__ float red[C_TI][NQ][3];
  const int R1 = R + 1;
  float* gIs = sm;                         // [C_FC][R1][TIP]
  float* gJs = gIs + C_FC * R1 * TIP;      // [C_FC][R1][TJP]
  float* fIs = gJs + C_FC * R1 * TJP;      // [C_FC][C_TI]
  float* fJs = fIs + C_FC * C_TI;          // [C_FC][TJ]
  float* Ss = sm;                          // [R1][C_TI][TJS], aliases them
  const int t = threadIdx.x, nt = blockDim.x;
  const int i0 = blockIdx.x * C_TI;
  const int r = t / (NIG * NJG);
  const int io = ((t / NJG) % NIG) * 8, jo = (t % NJG) * 8;
  for (int q = t; q < C_TI; q += nt) {
    const int gi = i0 + q;
    const bool ok = gi < P;
    Xi[q][0] = ok ? X[3 * gi] : 0.f;
    Xi[q][1] = ok ? X[3 * gi + 1] : 0.f;
    Xi[q][2] = ok ? X[3 * gi + 2] : 0.f;
    Xi[q][3] = ok ? M[gi] : 0.f;
  }
  for (int q = t; q < C_TI * NQ * 3; q += nt) (&red[0][0][0])[q] = 0.f;

  for (int j0 = 0; j0 < P; j0 += TJ) {
    __syncthreads();                      // the last pair phase is done
    for (int q = t; q < TJ; q += nt) {
      const int gj = j0 + q;
      const bool ok = gj < P;
      Xj[q][0] = ok ? X[3 * gj] : 0.f;
      Xj[q][1] = ok ? X[3 * gj + 1] : 0.f;
      Xj[q][2] = ok ? X[3 * gj + 2] : 0.f;
      Xj[q][3] = ok ? M[gj] : 0.f;
    }
    float S[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) S[a][b] = 0.f;

    for (int fc = 0; fc < F; fc += C_FC) {
      __syncthreads();
      for (int q = t; q < C_TI * R1 * (C_FC / 4); q += nt) {
        const int c = (q % (C_FC / 4)) * 4, row = q / (C_FC / 4);
        const int rr = row % R1;
        const float4 v = ld4_or_zero(g + ((size_t)i0 * R1 + row) * F + fc + c,
                                     i0 + row / R1 < P && fc + c < F);
        float* d = gIs + (c * R1 + rr) * TIP + row / R1;
        d[0] = v.x;
        d[R1 * TIP] = v.y;
        d[2 * R1 * TIP] = v.z;
        d[3 * R1 * TIP] = v.w;
      }
      for (int q = t; q < TJ * R1 * (C_FC / 4); q += nt) {
        const int c = (q % (C_FC / 4)) * 4, row = q / (C_FC / 4);
        const int rr = row % R1;
        const float4 v = ld4_or_zero(g + ((size_t)j0 * R1 + row) * F + fc + c,
                                     j0 + row / R1 < P && fc + c < F);
        float* d = gJs + (c * R1 + rr) * TJP + row / R1;
        d[0] = v.x;
        d[R1 * TJP] = v.y;
        d[2 * R1 * TJP] = v.z;
        d[3 * R1 * TJP] = v.w;
      }
      for (int q = t; q < (C_TI + TJ) * (C_FC / 4); q += nt) {
        const int c = (q % (C_FC / 4)) * 4, row = q / (C_FC / 4);
        const bool isI = row < C_TI;
        const int a = isI ? row : row - C_TI;
        const int ga = (isI ? i0 : j0) + a;
        const float4 v = ld4_or_zero(feats + (size_t)ga * F + fc + c,
                                     ga < P && fc + c < F);
        const int ld = isI ? C_TI : TJ;
        float* d = (isI ? fIs : fJs) + c * ld + a;
        d[0] = v.x;
        d[ld] = v.y;
        d[2 * ld] = v.z;
        d[3 * ld] = v.w;
      }
      __syncthreads();
      if (r < R1) {
        for (int f = 0; f < C_FC; ++f) {
          float a[8], b[8];
          ld8(gIs + (f * R1 + r) * TIP + io, a);
          ld8(fJs + f * TJ + jo, b);
#pragma unroll
          for (int x = 0; x < 8; ++x)
#pragma unroll
            for (int y = 0; y < 8; ++y) S[x][y] = fmaf(a[x], b[y], S[x][y]);
          ld8(fIs + f * C_TI + io, a);
          ld8(gJs + (f * R1 + r) * TJP + jo, b);
#pragma unroll
          for (int x = 0; x < 8; ++x)
#pragma unroll
            for (int y = 0; y < 8; ++y) S[x][y] = fmaf(a[x], b[y], S[x][y]);
        }
      }
    }
    __syncthreads();                      // staging buffers free for Ss
    if (r < R1) {
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y)
          Ss[(r * C_TI + io + x) * TJS + jo + y] = S[x][y];
    }
    __syncthreads();
    // each (row, quarter) slot has one owner thread: a fixed order
    for (int q = t; q < C_TI * NQ; q += nt) {
      const int pi = q / NQ, pq = q % NQ;
      float px = 0.f, py = 0.f, pz = 0.f;
      for (int k = 0; k < 4; ++k) {
        const int jj = pq * 4 + k;
        const Geo pg = pair_geo(Xi[pi][0], Xi[pi][1], Xi[pi][2], Xi[pi][3],
                                i0 + pi, Xj[jj][0], Xj[jj][1], Xj[jj][2],
                                Xj[jj][3], j0 + jj, rc);
        const float G = accum_g<DIVD>(pg, R, rc, Ss + pi * TJS + jj,
                                      C_TI * TJS);
        const float w = G / pg.d;
        px = fmaf(w, Xi[pi][0] - Xj[jj][0], px);
        py = fmaf(w, Xi[pi][1] - Xj[jj][1], py);
        pz = fmaf(w, Xi[pi][2] - Xj[jj][2], pz);
      }
      red[pi][pq][0] += px;
      red[pi][pq][1] += py;
      red[pi][pq][2] += pz;
    }
  }
  // deterministic reduction over the NQ slots of each row
  __syncthreads();
  for (int q = t; q < C_TI * 3; q += nt) {
    const int i = q / 3, k = q % 3;
    float s = 0.f;
    for (int u = 0; u < NQ; ++u) s += red[i][u][k];
    if (i0 + i < P) dx[(size_t)(i0 + i) * 3 + k] = s;
  }
}

// ---------------------------------------------------------------------------
// K6 forward: rc_fwd's tiling; rows (local i, global off + i) from Xr/Mr,
// the column loop over Pc from Xc/Mc
// ---------------------------------------------------------------------------
template <bool DIVD>
__global__ void __launch_bounds__(512)
rc_rect_fwd(int Pr, int Pc, int off, int F, int R, float rc,
            const float* __restrict__ Xr, const float* __restrict__ Mr,
            const float* __restrict__ Xc, const float* __restrict__ Mc,
            const float* __restrict__ feats, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float Xi[F_TI][4];
  const int R1 = R + 1;
  float* As = sm;                          // [F_TJ][R1][F_TI]
  float* Fs = sm + F_TJ * R1 * F_TI;       // [F_TJ][F_FT]
  const int t = threadIdx.x, nt = blockDim.x;
  const int i0 = blockIdx.x * F_TI, fb = blockIdx.y * F_FT;
  const int r = t / (F_FT / 8), fo = (t % (F_FT / 8)) * 8;
  if (t < F_TI) {
    const int li = i0 + t;
    const bool ok = li < Pr;
    Xi[t][0] = ok ? Xr[3 * li] : 0.f;
    Xi[t][1] = ok ? Xr[3 * li + 1] : 0.f;
    Xi[t][2] = ok ? Xr[3 * li + 2] : 0.f;
    Xi[t][3] = ok ? Mr[li] : 0.f;
  }
  float acc[F_TI][8];
#pragma unroll
  for (int a = 0; a < F_TI; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  for (int j0 = 0; j0 < Pc; j0 += F_TJ) {
    __syncthreads();
    for (int p = t; p < F_TI * F_TJ; p += nt) {
      const int ii = p % F_TI, jj = p / F_TI, gj = j0 + jj;
      const bool ok = gj < Pc;
      const Geo g = pair_geo(Xi[ii][0], Xi[ii][1], Xi[ii][2], Xi[ii][3],
                             off + i0 + ii, ok ? Xc[3 * gj] : 0.f,
                             ok ? Xc[3 * gj + 1] : 0.f,
                             ok ? Xc[3 * gj + 2] : 0.f, ok ? Mc[gj] : 0.f,
                             gj, rc);
      a_column<DIVD>(g, R, rc, As + jj * R1 * F_TI + ii, F_TI);
    }
    for (int q = t; q < F_TJ * F_FT / 4; q += nt) {
      const int jj = q / (F_FT / 4), c = (q % (F_FT / 4)) * 4, gj = j0 + jj;
      reinterpret_cast<float4*>(Fs + jj * F_FT + c)[0] = ld4_or_zero(
          feats + (size_t)gj * F + fb + c, gj < Pc && fb + c < F);
    }
    __syncthreads();
    for (int jj = 0; jj < F_TJ; ++jj) {
      float a[8], b[8];
      ld8(As + (jj * R1 + r) * F_TI, a);
      ld8(Fs + jj * F_FT + fo, b);
#pragma unroll
      for (int x = 0; x < F_TI; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
  }
  if (fb + fo < F) {
    for (int x = 0; x < F_TI; ++x) {
      const int li = i0 + x;
      if (li < Pr) st8(out + ((size_t)li * R1 + r) * F + fb + fo, acc[x]);
    }
  }
}

// ---------------------------------------------------------------------------
// K6 feats gradient: rc_bwd_feats's tiling; a block owns 64 columns j and
// contracts over the Pr local rows (i, r)
// ---------------------------------------------------------------------------
template <bool DIVD>
__global__ void __launch_bounds__(128)
rc_rect_bwd_feats(int Pr, int Pc, int off, int F, int R, float rc,
                  const float* __restrict__ Xr, const float* __restrict__ Mr,
                  const float* __restrict__ Xc, const float* __restrict__ Mc,
                  const float* __restrict__ g, float* __restrict__ dfeats) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float Xj[G_TJ][4];
  const int R1 = R + 1, K = G_TI * R1;
  float* At = sm;                  // [K][G_TJ], k = ii * R1 + r
  float* Gs = sm + K * G_TJ;       // [K][G_FT]
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * G_TJ, fb = blockIdx.y * G_FT;
  const int jo = (t / 16) * 8, fo = (t % 16) * 8;
  for (int q = t; q < G_TJ; q += blockDim.x) {
    const int gj = j0 + q;
    const bool ok = gj < Pc;
    Xj[q][0] = ok ? Xc[3 * gj] : 0.f;
    Xj[q][1] = ok ? Xc[3 * gj + 1] : 0.f;
    Xj[q][2] = ok ? Xc[3 * gj + 2] : 0.f;
    Xj[q][3] = ok ? Mc[gj] : 0.f;
  }
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  for (int i0 = 0; i0 < Pr; i0 += G_TI) {
    __syncthreads();
    for (int p = t; p < G_TI * G_TJ; p += blockDim.x) {
      const int jj = p % G_TJ, ii = p / G_TJ, li = i0 + ii;
      const bool ok = li < Pr;
      const Geo pg = pair_geo(Xj[jj][0], Xj[jj][1], Xj[jj][2], Xj[jj][3],
                              j0 + jj, ok ? Xr[3 * li] : 0.f,
                              ok ? Xr[3 * li + 1] : 0.f,
                              ok ? Xr[3 * li + 2] : 0.f, ok ? Mr[li] : 0.f,
                              off + li, rc);
      a_column<DIVD>(pg, R, rc, At + ii * R1 * G_TJ + jj, G_TJ);
    }
    // rows (i, r) of g are the contiguous local rows i0 * R1 + k
    for (int q = t; q < K * G_FT / 4; q += blockDim.x) {
      const int k = q / (G_FT / 4), c = (q % (G_FT / 4)) * 4;
      const bool ok = i0 + k / R1 < Pr && fb + c < F;
      reinterpret_cast<float4*>(Gs + k * G_FT + c)[0] =
          ld4_or_zero(g + ((size_t)i0 * R1 + k) * F + fb + c, ok);
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      float a[8], b[8];
      ld8(At + k * G_TJ + jo, a);
      ld8(Gs + k * G_FT + fo, b);
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
  }
  if (fb + fo < F) {
    for (int x = 0; x < 8; ++x) {
      const int gj = j0 + jo + x;
      if (gj < Pc) st8(dfeats + (size_t)gj * F + fb + fo, acc[x]);
    }
  }
}

// ---------------------------------------------------------------------------
// K6 coordinate gradients. A block owns a tile of one side (TI rows when
// !COLS, TJ columns when COLS) and loops over tiles of the other. For each
// (TI rows, TJ columns) pair tile, one thread per (r, 8 i, 8 j)
// accumulates S = g_I feats_J^T over all of F (chunks of 16 features
// staged k-major in shared memory); then one thread per (owned atom,
// quarter of the other tile) applies dA/dd once per pair and sums the
// (x_own - x_other)/d-weighted terms in a fixed order.
// ---------------------------------------------------------------------------
template <int TI, int TJ>
__host__ __device__ constexpr int rect_xyz_floats(int R1) {
  return C_FC * R1 * (TI + 4) + C_FC * TJ > R1 * TI * (TJ + 1)
             ? C_FC * R1 * (TI + 4) + C_FC * TJ
             : R1 * TI * (TJ + 1);
}

template <int TI, int TJ, bool COLS, bool DIVD>
__global__ void __launch_bounds__(512)
rc_rect_bwd_xyz(int Pr, int Pc, int off, int F, int R, float rc,
                const float* __restrict__ Xr, const float* __restrict__ Mr,
                const float* __restrict__ Xc, const float* __restrict__ Mc,
                const float* __restrict__ feats, const float* __restrict__ g,
                float* __restrict__ dx) {
  extern __shared__ __align__(16) float sm[];
  constexpr int TIP = TI + 4, TJS = TJ + 1;
  constexpr int NIG = TI / 8, NJG = TJ / 8;
  constexpr int OWN = COLS ? TJ : TI, OTHER = COLS ? TI : TJ;
  constexpr int NQ = OTHER / 4;
  __shared__ float Xi[TI][4], Xj[TJ][4];
  __shared__ float red[OWN][NQ][3];
  const int R1 = R + 1;
  float* gIs = sm;                         // [C_FC][R1][TIP]
  float* fJs = gIs + C_FC * R1 * TIP;      // [C_FC][TJ]
  float* Ss = sm;                          // [R1][TI][TJS], aliases them
  const int t = threadIdx.x, nt = blockDim.x;
  const int own0 = blockIdx.x * OWN;
  const int r = t / (NIG * NJG);
  const int io = ((t / NJG) % NIG) * 8, jo = (t % NJG) * 8;
  for (int q = t; q < OWN * NQ * 3; q += nt) (&red[0][0][0])[q] = 0.f;

  const int n_other = COLS ? Pr : Pc;
  for (int o0 = 0; o0 < n_other; o0 += OTHER) {
    const int i0 = COLS ? o0 : own0, j0 = COLS ? own0 : o0;
    __syncthreads();                      // the last pair phase is done
    for (int q = t; q < TI; q += nt) {
      const int li = i0 + q;
      const bool ok = li < Pr;
      Xi[q][0] = ok ? Xr[3 * li] : 0.f;
      Xi[q][1] = ok ? Xr[3 * li + 1] : 0.f;
      Xi[q][2] = ok ? Xr[3 * li + 2] : 0.f;
      Xi[q][3] = ok ? Mr[li] : 0.f;
    }
    for (int q = t; q < TJ; q += nt) {
      const int gj = j0 + q;
      const bool ok = gj < Pc;
      Xj[q][0] = ok ? Xc[3 * gj] : 0.f;
      Xj[q][1] = ok ? Xc[3 * gj + 1] : 0.f;
      Xj[q][2] = ok ? Xc[3 * gj + 2] : 0.f;
      Xj[q][3] = ok ? Mc[gj] : 0.f;
    }
    float S[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) S[a][b] = 0.f;

    for (int fc = 0; fc < F; fc += C_FC) {
      __syncthreads();
      // g rows (i, r) of the row tile, transposed to [f][r][i]
      for (int q = t; q < TI * R1 * (C_FC / 4); q += nt) {
        const int c = (q % (C_FC / 4)) * 4, row = q / (C_FC / 4);
        const int rr = row % R1;
        const float4 v = ld4_or_zero(g + ((size_t)i0 * R1 + row) * F + fc + c,
                                     i0 + row / R1 < Pr && fc + c < F);
        float* d = gIs + (c * R1 + rr) * TIP + row / R1;
        d[0] = v.x;
        d[R1 * TIP] = v.y;
        d[2 * R1 * TIP] = v.z;
        d[3 * R1 * TIP] = v.w;
      }
      // feats of the column tile, transposed to [f][j]
      for (int q = t; q < TJ * (C_FC / 4); q += nt) {
        const int c = (q % (C_FC / 4)) * 4, a = q / (C_FC / 4);
        const int gj = j0 + a;
        const float4 v = ld4_or_zero(feats + (size_t)gj * F + fc + c,
                                     gj < Pc && fc + c < F);
        float* d = fJs + c * TJ + a;
        d[0] = v.x;
        d[TJ] = v.y;
        d[2 * TJ] = v.z;
        d[3 * TJ] = v.w;
      }
      __syncthreads();
      if (r < R1) {
        for (int f = 0; f < C_FC; ++f) {
          float a[8], b[8];
          ld8(gIs + (f * R1 + r) * TIP + io, a);
          ld8(fJs + f * TJ + jo, b);
#pragma unroll
          for (int x = 0; x < 8; ++x)
#pragma unroll
            for (int y = 0; y < 8; ++y) S[x][y] = fmaf(a[x], b[y], S[x][y]);
        }
      }
    }
    __syncthreads();                      // staging buffers free for Ss
    if (r < R1) {
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y)
          Ss[(r * TI + io + x) * TJS + jo + y] = S[x][y];
    }
    __syncthreads();
    // each (owned atom, quarter) slot has one owner thread: a fixed order
    for (int q = t; q < OWN * NQ; q += nt) {
      const int po = q / NQ, pq = q % NQ;
      float px = 0.f, py = 0.f, pz = 0.f;
      for (int k = 0; k < 4; ++k) {
        const int pt = pq * 4 + k;
        const int ii = COLS ? pt : po, jj = COLS ? po : pt;
        const Geo pg = pair_geo(Xi[ii][0], Xi[ii][1], Xi[ii][2], Xi[ii][3],
                                off + i0 + ii, Xj[jj][0], Xj[jj][1],
                                Xj[jj][2], Xj[jj][3], j0 + jj, rc);
        const float G = accum_g<DIVD>(pg, R, rc, Ss + ii * TJS + jj,
                                      TI * TJS);
        // rows: G (x_i - x_j) / d; columns: G (x_j - x_i) / d
        const float w = (COLS ? -G : G) / pg.d;
        px = fmaf(w, Xi[ii][0] - Xj[jj][0], px);
        py = fmaf(w, Xi[ii][1] - Xj[jj][1], py);
        pz = fmaf(w, Xi[ii][2] - Xj[jj][2], pz);
      }
      red[po][pq][0] += px;
      red[po][pq][1] += py;
      red[po][pq][2] += pz;
    }
  }
  // deterministic reduction over the NQ slots of each owned atom
  __syncthreads();
  const int n_own = COLS ? Pc : Pr;
  for (int q = t; q < OWN * 3; q += nt) {
    const int o = q / 3, k = q % 3;
    float s = 0.f;
    for (int u = 0; u < NQ; ++u) s += red[o][u][k];
    if (own0 + o < n_own) dx[(size_t)(own0 + o) * 3 + k] = s;
  }
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int TJ, bool DIVD>
int launch_coords(int P, int F, int R, float rc, const float* X,
                  const float* M, const float* feats, const float* g,
                  float* dx, cudaStream_t s) {
  const int R1 = R + 1;
  const int threads = R1 * (C_TI / 8) * (TJ / 8);
  if (threads > 512) return (int)cudaErrorInvalidValue;
  const int fl = coords_gemm_floats<TJ>(R1) > coords_s_floats<TJ>(R1)
                     ? coords_gemm_floats<TJ>(R1)
                     : coords_s_floats<TJ>(R1);
  const size_t smem = sizeof(float) * fl;
  int err = prepare(rc_bwd_coords<TJ, DIVD>, smem);
  if (err) return err;
  rc_bwd_coords<TJ, DIVD><<<(P + C_TI - 1) / C_TI, threads, smem, s>>>(
      P, F, R, rc, X, M, feats, g, dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [P, R+1, F]; F % 8 == 0; (R+1) * 8 <= 512 threads
int rc_fwd_launch(int P, int F, int R, int div_d, float rc, const float* X,
                  const float* M, const float* feats, float* out,
                  void* stream) {
  const int R1 = R + 1;
  if (F % 8 != 0 || R1 * (F_FT / 8) > 512) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (F_TJ * R1 * F_TI + F_TJ * F_FT);
  const dim3 grid((P + F_TI - 1) / F_TI, (F + F_FT - 1) / F_FT);
  const cudaStream_t s = (cudaStream_t)stream;
  int err = div_d ? prepare(rc_fwd<true>, smem) : prepare(rc_fwd<false>, smem);
  if (err) return err;
  if (div_d)
    rc_fwd<true><<<grid, R1 * (F_FT / 8), smem, s>>>(P, F, R, rc, X, M,
                                                     feats, out);
  else
    rc_fwd<false><<<grid, R1 * (F_FT / 8), smem, s>>>(P, F, R, rc, X, M,
                                                      feats, out);
  return (int)cudaGetLastError();
}

// g [P, R+1, F] -> dfeats [P, F]
int rc_bwd_feats_launch(int P, int F, int R, int div_d, float rc,
                        const float* X, const float* M, const float* g,
                        float* dfeats, void* stream) {
  const int R1 = R + 1;
  if (F % 8 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (G_TI * R1 * (G_TJ + G_FT));
  const dim3 grid((P + G_TJ - 1) / G_TJ, (F + G_FT - 1) / G_FT);
  const cudaStream_t s = (cudaStream_t)stream;
  int err = div_d ? prepare(rc_bwd_feats<true>, smem)
                  : prepare(rc_bwd_feats<false>, smem);
  if (err) return err;
  if (div_d)
    rc_bwd_feats<true><<<grid, 128, smem, s>>>(P, F, R, rc, X, M, g, dfeats);
  else
    rc_bwd_feats<false><<<grid, 128, smem, s>>>(P, F, R, rc, X, M, g, dfeats);
  return (int)cudaGetLastError();
}

// g [P, R+1, F], feats [P, F] -> dx [P, 3]; j tiles of 32 up to R+1 = 32,
// of 16 up to R+1 = 63 (at 64 the 16-column tile's shared memory, dynamic
// and static, passes the 227 KB a block may have). The 16-column tiling
// exists for uma-m-1p1 (R+1 = 33) alone; uma-s-1p1 and small take the
// 32-column one.
int rc_bwd_coords_launch(int P, int F, int R, int div_d, float rc,
                         const float* X, const float* M, const float* feats,
                         const float* g, float* dx, void* stream) {
  if (F % 8 != 0 || R + 1 > 63) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (R + 1 <= 32)
    return div_d ? launch_coords<32, true>(P, F, R, rc, X, M, feats, g, dx, s)
                 : launch_coords<32, false>(P, F, R, rc, X, M, feats, g, dx,
                                            s);
  return div_d ? launch_coords<16, true>(P, F, R, rc, X, M, feats, g, dx, s)
               : launch_coords<16, false>(P, F, R, rc, X, M, feats, g, dx, s);
}

// ---- K6: rows [Pr, 3] (global indices off ..), columns [Pc, 3] ----------

// feats [Pc, F] -> out [Pr, R+1, F]; F % 8 == 0; (R+1) * 8 <= 512 threads
int rc_rect_fwd_launch(int Pr, int Pc, int off, int F, int R, int div_d,
                       float rc, const float* Xr, const float* Mr,
                       const float* Xc, const float* Mc, const float* feats,
                       float* out, void* stream) {
  const int R1 = R + 1;
  if (F % 8 != 0 || R1 * (F_FT / 8) > 512) return (int)cudaErrorInvalidValue;
  if (Pr == 0) return 0;
  const size_t smem = sizeof(float) * (F_TJ * R1 * F_TI + F_TJ * F_FT);
  const dim3 grid((Pr + F_TI - 1) / F_TI, (F + F_FT - 1) / F_FT);
  const cudaStream_t s = (cudaStream_t)stream;
  int err = div_d ? prepare(rc_rect_fwd<true>, smem)
                  : prepare(rc_rect_fwd<false>, smem);
  if (err) return err;
  if (div_d)
    rc_rect_fwd<true><<<grid, R1 * (F_FT / 8), smem, s>>>(
        Pr, Pc, off, F, R, rc, Xr, Mr, Xc, Mc, feats, out);
  else
    rc_rect_fwd<false><<<grid, R1 * (F_FT / 8), smem, s>>>(
        Pr, Pc, off, F, R, rc, Xr, Mr, Xc, Mc, feats, out);
  return (int)cudaGetLastError();
}

// g [Pr, R+1, F] -> dfeats [Pc, F]
int rc_rect_bwd_feats_launch(int Pr, int Pc, int off, int F, int R,
                             int div_d, float rc, const float* Xr,
                             const float* Mr, const float* Xc,
                             const float* Mc, const float* g, float* dfeats,
                             void* stream) {
  const int R1 = R + 1;
  if (F % 8 != 0) return (int)cudaErrorInvalidValue;
  if (Pc == 0) return 0;
  const size_t smem = sizeof(float) * (G_TI * R1 * (G_TJ + G_FT));
  const dim3 grid((Pc + G_TJ - 1) / G_TJ, (F + G_FT - 1) / G_FT);
  const cudaStream_t s = (cudaStream_t)stream;
  int err = div_d ? prepare(rc_rect_bwd_feats<true>, smem)
                  : prepare(rc_rect_bwd_feats<false>, smem);
  if (err) return err;
  if (div_d)
    rc_rect_bwd_feats<true><<<grid, 128, smem, s>>>(
        Pr, Pc, off, F, R, rc, Xr, Mr, Xc, Mc, g, dfeats);
  else
    rc_rect_bwd_feats<false><<<grid, 128, smem, s>>>(
        Pr, Pc, off, F, R, rc, Xr, Mr, Xc, Mc, g, dfeats);
  return (int)cudaGetLastError();
}

}  // extern "C"

namespace {

template <int TI, int TJ, bool COLS>
int launch_rect_xyz(int Pr, int Pc, int off, int F, int R, int div_d,
                    float rc, const float* Xr, const float* Mr,
                    const float* Xc, const float* Mc, const float* feats,
                    const float* g, float* dx, cudaStream_t s) {
  const int R1 = R + 1;
  const int threads = R1 * (TI / 8) * (TJ / 8);
  if (F % 8 != 0 || threads > 512) return (int)cudaErrorInvalidValue;
  const int n_own = COLS ? Pc : Pr, own = COLS ? TJ : TI;
  if (n_own == 0) return 0;
  const size_t smem = sizeof(float) * rect_xyz_floats<TI, TJ>(R1);
  const int blocks = (n_own + own - 1) / own;
  int err = div_d ? prepare(rc_rect_bwd_xyz<TI, TJ, COLS, true>, smem)
                  : prepare(rc_rect_bwd_xyz<TI, TJ, COLS, false>, smem);
  if (err) return err;
  if (div_d)
    rc_rect_bwd_xyz<TI, TJ, COLS, true><<<blocks, threads, smem, s>>>(
        Pr, Pc, off, F, R, rc, Xr, Mr, Xc, Mc, feats, g, dx);
  else
    rc_rect_bwd_xyz<TI, TJ, COLS, false><<<blocks, threads, smem, s>>>(
        Pr, Pc, off, F, R, rc, Xr, Mr, Xc, Mc, feats, g, dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g [Pr, R+1, F], feats [Pc, F] -> dx_rows [Pr, 3]; 8 rows a block
// against column tiles of 128 up to R+1 = 32, of 64 up to R+1 = 63
int rc_rect_bwd_rows_launch(int Pr, int Pc, int off, int F, int R,
                            int div_d, float rc, const float* Xr,
                            const float* Mr, const float* Xc,
                            const float* Mc, const float* feats,
                            const float* g, float* dx, void* stream) {
  if (R + 1 > 63) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (R + 1 <= 32)
    return launch_rect_xyz<8, 128, false>(Pr, Pc, off, F, R, div_d, rc, Xr,
                                          Mr, Xc, Mc, feats, g, dx, s);
  return launch_rect_xyz<8, 64, false>(Pr, Pc, off, F, R, div_d, rc, Xr, Mr,
                                       Xc, Mc, feats, g, dx, s);
}

// g [Pr, R+1, F], feats [Pc, F] -> dx_cols [Pc, 3]; 32 columns a block
// against row tiles of 32 up to R+1 = 32, of 16 up to R+1 = 63
int rc_rect_bwd_cols_launch(int Pr, int Pc, int off, int F, int R,
                            int div_d, float rc, const float* Xr,
                            const float* Mr, const float* Xc,
                            const float* Mc, const float* feats,
                            const float* g, float* dx, void* stream) {
  if (R + 1 > 63) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (R + 1 <= 32)
    return launch_rect_xyz<32, 32, true>(Pr, Pc, off, F, R, div_d, rc, Xr,
                                         Mr, Xc, Mc, feats, g, dx, s);
  return launch_rect_xyz<16, 32, true>(Pr, Pc, off, F, R, div_d, rc, Xr, Mr,
                                       Xc, Mc, feats, g, dx, s);
}

}  // extern "C"
