// K5: the radial contraction of the PaiNN-class model's pallas mode,
// forward and both gradients, f32, for Hopper (sm_90a).
//
//   T[i, r, f] = sum_j A[i, j, r] feats[j, f]                 (rc_fwd)
//   A[i, j, r] = sqrt(2/rc) sin((r+1) pi d/rc) / d^p * env(d)   r < R
//   A[i, j, R] = env(d) / d^(p-1)            p = 2 with div_d, else 1
//
// over pairs inside the cutoff, both atoms real (mask > 0), i != j by
// index; d = sqrt(max(d^2, 1e-12)), and d = 1 outside the cutoff.
//
// Replaces pdb2reaction_tpu/mlip/pallas_ops.py, reached from
// radial_contract through radial_contract_tpu / _radial_contract_impl:
//   rc_fwd_tc, rc_fwd_fma  <- _fwd_kernel:129
//   rc_feats_plan   <- _transpose_kernel:352 (via _grad_feats)
//                      dfeats[j, f] = sum_{i, r} A[j, i, r] g[i, r, f]
//   rc_coords_pairs, rc_coords_reduce
//                   <- _grad_coords_fused_kernel:256 (via _grad_coords_fused)
//                      dx_i = sum_j C_ij (x_i - x_j) / d,
//                      C_ij = sum_r dA_r/dd (S1[r, i, j] + S1[r, j, i]),
//                      S1 = g_I feats_J^T; C is symmetric
//
// What bounds them: arithmetic over the pairs inside the cutoff,
// 2 (R + 1) F FLOP per pair and launch; at the slice's shapes (P = 4096,
// F = 1024, R + 1 = 25, ~3% of pairs inside 6 A) ~26 GFLOP, about 0.4 ms
// at the f32 peak, against ~0.4 GB of device memory traffic. The
// adjacency itself (1.7 GB per stream at that size) never reaches device
// memory: every block builds its tile of it in shared memory from the
// coordinates (one sincosf per pair; the sin((r+1) t) ladder by the
// coupled rotation recurrence, whose f32 error grows linearly in r) and
// contracts it at once.
//
// Which pairs: all three kernels run on one tile plan of the call's
// coordinates (mlip/radial_contract.py: tile_plan; the PaiNN pallas mode
// builds one per energy evaluation and hands it to every contraction):
// atoms in a spatial order (Xp: coordinates and mask in plan order, perm:
// their original rows), tiles of 32, and for each row tile the list of
// column tiles whose boxes lie within the cutoff. Only listed tile pairs
// are computed (~22% of them at the slice's density); rows of feats, g,
// out and dfeats are read and written through perm, whole rows at a time.
// Indices are plan positions, so i != j holds as before. What bounds the
// kernels then is the work on the listed tile pairs, ~7x what the
// function needs (14% of a listed tile's pairs lie inside the cutoff at
// the slice's density), and the throughput of its products.
//
// rc_fwd: a block owns 16 (tensor cores) or 8 (CUDA cores) rows of one
// row tile and 64 features, and loops over its row's column tiles; the
// next tile's feats rows and coordinates arrive by double-buffered
// cp.async while the current [R+1, rows, 32] adjacency tile is built and
// contracted. Rows whose tile reaches nothing (no real atom) get zeros.
// rc_bwd_coords: one block per listed tile pair I <= J forms
// Ssym = S1[i, j] + S1[j, i] over all of F for its 32 x 32 pair tile (the
// g and feats rows k-contiguous, double-buffered by cp.async), applies
// dA/dd once per pair, and writes the I side's partial dx to the slot of
// (I, J) and, off the diagonal, the J side's to the slot of (J, I): one
// product per ordered tile pair, half what the dense kernel formed. A
// second pass sums each atom's slots in the order of its reach list.
// rc_feats_plan, the forward's transpose: a block owns one row tile J (32
// rows j) and 64 features and walks J's reach list in list order (the
// reach relation is symmetric, so it lists every tile I with a pair inside
// the cutoff), in chunks of 4 atoms of I: A[j][(i, r)] is built in
// shared memory while the next chunk's g rows arrive by double-buffered
// cp.async (k = (i, r) lies contiguous in g), then contracted; the block
// owns its outputs, so no atomics.
// Up to R + 1 = 32 the products run on the tensor cores in the 3xTF32
// split (a = hi + lo, hi*hi + hi*lo + lo*hi, each k step's products added
// to the f32 accumulator on CUDA cores: f32 accuracy), which beat the
// CUDA-core loops on the forward and the coordinate gradient on an H100;
// above, where the tiles no longer fit, on CUDA cores with register tiles
// of 8 x 8. Nothing is reduced across blocks except through those slots,
// and no atomics are used, so every result repeats bit for bit.
//
// K6: the same contraction for one block of Pr rows against all Pc
// columns (atom-axis sharding: each rank owns rows off .. off + Pr - 1 of
// the system and holds every column). Self-pairs are excluded by global
// index, off + i against j, so every shard drops exactly its own diagonal.
// Replaces pdb2reaction_tpu/mlip/pallas_ops.py, reached from
// radial_contract_rect through radial_contract_rect_tpu:
//   rc_rect_plan_fwd_tc, rc_rect_plan_fwd_fma
//                      <- _fwd_kernel_rect:474 (via _rc_rect_impl)
//   rc_rect_plan_feats <- _transpose_kernel_rect:568 (via _rc_rect_bwd)
//                         dfeats[j, f] = sum_{i in rows, r} A[i, j, r] g[i, r, f]
//   rc_rect_coords_pairs, rc_rect_coords_reduce
//                      <- _grad_rows_kernel:594 and _grad_cols_kernel:623
//                         dx_rows[i] = sum_j G[i, j] (x_i - x_j) / d
//                         dx_cols[j] = sum_{i in rows} G[i, j] (x_j - x_i) / d
//   with G = sum_r dA_r/dd S_r and S = g_I feats_J^T: one product serves
//   both gradients (K5's S1 + S2 needs both sides of the square).
//
// What bounds them: as K5, the arithmetic over the pairs inside the
// cutoff with one atom in the row block, 2 (R + 1) F FLOP per pair and
// launch; at the sharded slice (Pr = 1024, Pc = 4096, F = 1024, R + 1 =
// 25) ~6.5 GFLOP, 0.040 ms at the 3xTF32 route's 165 TFLOP/s, against
// ~0.12 GB of device memory. All three run on one rect tile plan
// (mlip/radial_contract.py: rect_tile_plan; the sharded PaiNN pallas mode
// builds one per energy evaluation): rows and columns each in K5's spatial
// order and tiles of 32, and the (row tile, column tile) pairs whose boxes
// lie within the cutoff, as a CSR by row tile (row_ptr, cols), a CSR by
// column tile (col_ptr, rows) and a list of pairs (I, J, e_row, e_col).
// Only listed tile pairs are computed (17-29% of them at the slice's
// density), with K5's tilings: 3xTF32 tensor cores up to R + 1 = 32, CUDA
// cores up to 63. The forward and the feats gradient are K5's bodies with
// RECT set (fwd_tc / fwd_fma, feats_plan): a forward block of rows walks
// its row tile's column list, a feats block owns one column tile and walks
// that tile's row list, so every output has one owner; rows and columns
// are read and written through their own permutations, and the pair test
// compares global indices (off + perm_r[i] against perm_c[j]) staged in
// shared memory beside each tile's coordinates, since a plan position
// names different atoms on the two sides. A tile whose list is empty
// writes zeros. The coordinate kernel: one block per listed pair forms S
// once over all of F, applies dA/dd once per pair and writes the row
// side's partial dx to slot e_row and the column side's to slot e_col;
// rc_rect_coords_reduce sums each row's slots in row-list order and each
// column's in column-list order, through the plans' permutations. Nothing
// is reduced across blocks except through those slots, no atomics are
// used, and every result repeats bit for bit.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

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

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : v.z;
}

// A fragment (16 x 8, row-major, k contiguous) of rows p[0..15] at
// stride ld, and B fragment (8 x 8, n-major, k contiguous) of columns
// p[0..7] at stride ld; lane = 4 g + t
__device__ __forceinline__ void frag_a(const float* p, int ld, int g, int t,
                                       unsigned* hi, unsigned* lo) {
  split_tf32(p[g * ld + t], hi[0], lo[0]);
  split_tf32(p[(g + 8) * ld + t], hi[1], lo[1]);
  split_tf32(p[g * ld + t + 4], hi[2], lo[2]);
  split_tf32(p[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

__device__ __forceinline__ void frag_b(const float* p, int ld, int g, int t,
                                       unsigned* hi, unsigned* lo) {
  split_tf32(p[g * ld + t], hi[0], lo[0]);
  split_tf32(p[g * ld + t + 4], hi[1], lo[1]);
}

constexpr int TILE = 32;                 // the tile plan's tile
constexpr int F_TI = 8, F_FT = 64;

// The arguments of a forward or feats-gradient launch on a plan. K5: one
// square plan, so the columns' fields fold into the rows' at compile time
// and its kernels take their scalar arguments as before; K6 (RECT): a
// rect plan, rows (global indices off ..) and columns each in their own
// order, so self-pairs are tested by global index.
struct PlanArgs {
  int Pr, Pc, off;            // rows, columns, global index of row 0
  const float4* Xr;           // rows' coordinates and mask, plan order
  const float4* Xc;           // columns'
  const int* perm_r;          // local row at each row plan position
  const int* perm_c;          // local column at each column plan position
  const int* ptr;             // the walked CSR: the forward's, each row
  const int* list;            //   tile's column tiles; the feats
                              //   gradient's, each column tile's row tiles
  const float* in;            // forward: feats [Pc, F]; feats: g [Pr, R1, F]
  float* out;                 // forward: [Pr, R1, F]; feats: dfeats [Pc, F]
};

// stages column tile j0 / TILE of a plan: its coordinates and mask into
// xj[TILE], its feats rows (features fb .. fb + F_FT) through perm into fs
// at pitch fp and (RECT) the columns' global indices into gj; columns past
// P are zeros (index -2)
template <bool RECT>
__device__ __forceinline__ void stage_cols(int P, int F, int fb, int j0,
                                           const float4* Xp, const int* perm,
                                           const float* feats, float* fs,
                                           int fp, float4* xj, int* gj) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int q = t; q < TILE * F_FT / 4; q += nt) {
    const int jj = q / (F_FT / 4), c = (q % (F_FT / 4)) * 4, pj = j0 + jj;
    const bool ok = pj < P && fb + c < F;
    cp_async16(fs + jj * fp + c,
               ok ? feats + (size_t)perm[pj] * F + fb + c : feats, ok);
  }
  for (int q = t; q < TILE; q += nt) {
    const bool ok = j0 + q < P;
    cp_async16(xj + q, ok ? Xp + j0 + q : Xp, ok);
    if constexpr (RECT) gj[q] = ok ? perm[j0 + q] : -2;
  }
}

// ---------------------------------------------------------------------------
// forward on CUDA cores: block = 8 plan rows x 64 features, one thread
// per (r, 8 features) owning 8 rows x 8 features; loops over the row
// tile's listed column tiles
// ---------------------------------------------------------------------------
template <bool DIVD, bool RECT>
__device__ __forceinline__ void fwd_fma(int F, int R, float rc,
                                        const PlanArgs& pa) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float4 Xi[F_TI];
  __shared__ float4 Xj[2][TILE];
  __shared__ int Gi[RECT ? F_TI : 1], Gj[2][RECT ? TILE : 1];
  const int Pr = pa.Pr, Pc = RECT ? pa.Pc : Pr;
  const float4* __restrict__ Xr = pa.Xr;
  const float4* __restrict__ Xc = RECT ? pa.Xc : Xr;
  const int* __restrict__ perm_r = pa.perm_r;
  const int* __restrict__ perm_c = RECT ? pa.perm_c : perm_r;
  const int* __restrict__ row_ptr = pa.ptr;
  const int* __restrict__ cols = pa.list;
  const float* __restrict__ feats = pa.in;
  float* __restrict__ out = pa.out;
  const int R1 = R + 1;
  float* As = sm;                          // [TILE][R1][F_TI]
  float* Fs = sm + TILE * R1 * F_TI;       // [2][TILE][F_FT]
  const int t = threadIdx.x, nt = blockDim.x;
  const int i0 = blockIdx.x * F_TI, fb = blockIdx.y * F_FT;
  const int r = t / (F_FT / 8), fo = (t % (F_FT / 8)) * 8;
  const int kb = row_ptr[i0 / TILE], nJ = row_ptr[i0 / TILE + 1] - kb;
  if (t < F_TI) {
    Xi[t] = i0 + t < Pr ? Xr[i0 + t] : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (RECT) Gi[t] = i0 + t < Pr ? pa.off + perm_r[i0 + t] : -1;
  }
  float acc[F_TI][8];
#pragma unroll
  for (int a = 0; a < F_TI; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  if (nJ > 0)
    stage_cols<RECT>(Pc, F, fb, cols[kb] * TILE, Xc, perm_c, feats, Fs,
                     F_FT, Xj[0], Gj[0]);
  cp_commit();
  for (int k = 0; k < nJ; ++k) {
    const int buf = k & 1;
    if (k + 1 < nJ)
      stage_cols<RECT>(Pc, F, fb, cols[kb + k + 1] * TILE, Xc, perm_c,
                       feats, Fs + (buf ^ 1) * TILE * F_FT, F_FT,
                       Xj[buf ^ 1], Gj[buf ^ 1]);
    cp_commit();
    cp_wait<1>();
    __syncthreads();                      // tile k has landed for all
    const int j0 = cols[kb + k] * TILE;
    for (int p = t; p < F_TI * TILE; p += nt) {
      const int ii = p % F_TI, jj = p / F_TI;
      const float4 a = Xi[ii], b = Xj[buf][jj];
      const Geo g = pair_geo(a.x, a.y, a.z, a.w, RECT ? Gi[ii] : i0 + ii,
                             b.x, b.y, b.z, b.w,
                             RECT ? Gj[buf][jj] : j0 + jj, rc);
      a_column<DIVD>(g, R, rc, As + jj * R1 * F_TI + ii, F_TI);
    }
    __syncthreads();
    const float* Fb = Fs + buf * TILE * F_FT;
    for (int jj = 0; jj < TILE; ++jj) {
      float a[8], b[8];
      ld8(As + (jj * R1 + r) * F_TI, a);
      ld8(Fb + jj * F_FT + fo, b);
#pragma unroll
      for (int x = 0; x < F_TI; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
    __syncthreads();                      // As and buffer buf are free
  }
  if (fb + fo < F) {
    for (int x = 0; x < F_TI; ++x) {
      const int pi = i0 + x;
      if (pi < Pr)
        st8(out + ((size_t)perm_r[pi] * R1 + r) * F + fb + fo, acc[x]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward on the tensor cores (R + 1 <= 32): block = 16 plan rows x 64
// features; the adjacency tile A[r][i][j] is the A operand (m = 16 rows
// for one r, k = j), feats the B operand (n = features); warp w owns
// r = 2w, 2w + 1 against all 8 feature tiles of 8, in 3xTF32
// ---------------------------------------------------------------------------
constexpr int T_RB = 16, T_AP = TILE + 4, T_FP = F_FT + 8;

template <bool DIVD, bool RECT>
__device__ __forceinline__ void fwd_tc(int F, int R, float rc,
                                       const PlanArgs& pa) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float4 Xi[T_RB];
  __shared__ float4 Xj[2][TILE];
  __shared__ int Gi[RECT ? T_RB : 1], Gj[2][RECT ? TILE : 1];
  const int Pr = pa.Pr, Pc = RECT ? pa.Pc : Pr;
  const float4* __restrict__ Xr = pa.Xr;
  const float4* __restrict__ Xc = RECT ? pa.Xc : Xr;
  const int* __restrict__ perm_r = pa.perm_r;
  const int* __restrict__ perm_c = RECT ? pa.perm_c : perm_r;
  const int* __restrict__ row_ptr = pa.ptr;
  const int* __restrict__ cols = pa.list;
  const float* __restrict__ feats = pa.in;
  float* __restrict__ out = pa.out;
  const int R1 = R + 1;
  float* As = sm;                          // [R1][T_RB][T_AP]
  float* Fs = sm + R1 * T_RB * T_AP;       // [2][TILE][T_FP]
  const int t = threadIdx.x, nt = blockDim.x, w = t >> 5;
  const int gq = (t & 31) >> 2, tq = t & 3;
  const int i0 = blockIdx.x * T_RB, fb = blockIdx.y * F_FT;
  const int kb = row_ptr[i0 / TILE], nJ = row_ptr[i0 / TILE + 1] - kb;
  if (t < T_RB) {
    Xi[t] = i0 + t < Pr ? Xr[i0 + t] : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (RECT) Gi[t] = i0 + t < Pr ? pa.off + perm_r[i0 + t] : -1;
  }
  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  if (nJ > 0)
    stage_cols<RECT>(Pc, F, fb, cols[kb] * TILE, Xc, perm_c, feats, Fs,
                     T_FP, Xj[0], Gj[0]);
  cp_commit();
  for (int k = 0; k < nJ; ++k) {
    const int buf = k & 1;
    if (k + 1 < nJ)
      stage_cols<RECT>(Pc, F, fb, cols[kb + k + 1] * TILE, Xc, perm_c,
                       feats, Fs + (buf ^ 1) * TILE * T_FP, T_FP,
                       Xj[buf ^ 1], Gj[buf ^ 1]);
    cp_commit();
    cp_wait<1>();
    __syncthreads();                      // tile k has landed for all
    const int j0 = cols[kb + k] * TILE;
    for (int p = t; p < T_RB * TILE; p += nt) {
      const int jj = p % TILE, ii = p / TILE;
      const float4 a = Xi[ii], b = Xj[buf][jj];
      const Geo g = pair_geo(a.x, a.y, a.z, a.w, RECT ? Gi[ii] : i0 + ii,
                             b.x, b.y, b.z, b.w,
                             RECT ? Gj[buf][jj] : j0 + jj, rc);
      a_column<DIVD>(g, R, rc, As + ii * T_AP + jj, T_RB * T_AP);
    }
    __syncthreads();
    // B[k = j][n = f] = Fs[j][f]: n-major at stride 1, so the fragment
    // reads Fs transposed: b0 = Fs[k0 + t][n0 + g]
    const float* Fb = Fs + buf * TILE * T_FP;
#pragma unroll
    for (int k0 = 0; k0 < TILE; k0 += 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* q = Fb + (k0 + tq) * T_FP + (h * 4 + n) * 8 + gq;
          split_tf32(q[0], bh[n][0], bl[n][0]);
          split_tf32(q[4 * T_FP], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = 2 * w + rr;
          if (r < R1) {                   // warp-uniform
            unsigned ah[4], al[4];
            frag_a(As + r * T_RB * T_AP + k0, T_AP, gq, tq, ah, al);
#pragma unroll
            for (int n = 0; n < 4; ++n)
              mma3(acc[rr][h * 4 + n], ah, al, bh[n], bl[n]);
          }
        }
      }
    }
    __syncthreads();                      // As and buffer buf are free
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 2 * w + rr;
    if (r >= R1) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int f = fb + n * 8 + 2 * tq;
      if (f >= F) continue;
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int pi = i0 + gq + 8 * hrow;
        if (pi < Pr)
          *reinterpret_cast<float2*>(out + ((size_t)perm_r[pi] * R1 + r) *
                                               F +
                                     f) =
              make_float2(acc[rr][n][2 * hrow], acc[rr][n][2 * hrow + 1]);
      }
    }
  }
}

// the forward kernels, each its own name in a profile: K5's on a square
// plan, K6's on a rect plan
template <bool DIVD>
__global__ void __launch_bounds__(512)
rc_fwd_fma(int P, int F, int R, float rc, const float4* __restrict__ Xp,
           const int* __restrict__ perm, const int* __restrict__ row_ptr,
           const int* __restrict__ cols, const float* __restrict__ feats,
           float* __restrict__ out) {
  fwd_fma<DIVD, false>(
      F, R, rc, PlanArgs{P, P, 0, Xp, Xp, perm, perm, row_ptr, cols, feats,
                         out});
}

template <bool DIVD>
__global__ void __launch_bounds__(512)
rc_fwd_tc(int P, int F, int R, float rc, const float4* __restrict__ Xp,
          const int* __restrict__ perm, const int* __restrict__ row_ptr,
          const int* __restrict__ cols, const float* __restrict__ feats,
          float* __restrict__ out) {
  fwd_tc<DIVD, false>(
      F, R, rc, PlanArgs{P, P, 0, Xp, Xp, perm, perm, row_ptr, cols, feats,
                         out});
}

template <bool DIVD>
__global__ void __launch_bounds__(512)
rc_rect_plan_fwd_fma(int F, int R, float rc, PlanArgs pa) {
  fwd_fma<DIVD, true>(F, R, rc, pa);
}

template <bool DIVD>
__global__ void __launch_bounds__(512)
rc_rect_plan_fwd_tc(int F, int R, float rc, PlanArgs pa) {
  fwd_tc<DIVD, true>(F, R, rc, pa);
}

// ---------------------------------------------------------------------------
// feats gradient on the plan: block = one column tile J (32 columns j) x
// 64 features, 256 threads; loops over J's listed row tiles I in list
// order (K5: J's reach list, which lists every I with a pair inside the
// cutoff since the reach relation is symmetric; K6: the rect plan's
// column list), in chunks of FG_NA = 4 row atoms (k = (i, r), K = 4 (R +
// 1) values, padded to KP, a multiple of 8, by zero columns of A and zero
// rows of g): A[j][k] built in shared memory from the plan's coordinates,
// the chunk's g rows staged k-contiguous by double-buffered cp.async. The
// threads form NKQ groups that split the k steps; their partial sums are
// added in group order at the end, in the shared memory the stages used.
// 74 KB of shared memory at R + 1 = 25: three blocks an SM, so one
// block's A build overlaps another's products.
//   TC (R + 1 <= 32): warp w owns all 32 columns (two m tiles) x features
//     (w & 1) * 32 .. + 32 (four n tiles) for the k steps (w >> 1) mod 4,
//     in 3xTF32 (mma3: each k step's products in a zeroed fragment, added
//     to the accumulator on CUDA cores);
//   CUDA cores (R + 1 <= 63): A stored [k][j]; thread t owns 8 columns x
//     8 features for the k values (t >> 5) mod 8.
// ---------------------------------------------------------------------------
constexpr int FG_THREADS = 256, FG_NA = 4, FG_GP = F_FT + 8,
              FG_RP = F_FT + 4;

__host__ __device__ constexpr int fg_kp(int R1) {
  return (FG_NA * R1 + 7) / 8 * 8;
}

template <bool TC>
__host__ __device__ constexpr int fg_groups() { return TC ? 4 : 8; }

// A: [TILE][KP + 4] (TC) or [KP][TILE]; then two g stages [KP][FG_GP],
// aliased after the loop by the groups' sums [groups][TILE][FG_RP]
template <bool TC>
__host__ __device__ constexpr int fg_a_floats(int R1) {
  return TC ? TILE * (fg_kp(R1) + 4) : fg_kp(R1) * TILE;
}

template <bool TC>
__host__ __device__ constexpr int fg_smem_floats(int R1) {
  return fg_a_floats<TC>(R1) +
         (2 * fg_kp(R1) * FG_GP > fg_groups<TC>() * TILE * FG_RP
              ? 2 * fg_kp(R1) * FG_GP
              : fg_groups<TC>() * TILE * FG_RP);
}

template <bool TC, bool DIVD, bool RECT>
__device__ __forceinline__ void feats_plan(int F, int R, float rc,
                                           const PlanArgs& pa) {
  constexpr int NA = FG_NA, NKQ = fg_groups<TC>(), NS = TILE / NA;
  extern __shared__ __align__(16) float sm[];
  __shared__ float4 Xj[TILE];
  __shared__ float4 Xi[2][NA];
  __shared__ int Gj[RECT ? TILE : 1], Gi[2][RECT ? NA : 1];
  // the block's own tile J is of the columns, the walked tiles I of the
  // rows
  const int Pr = pa.Pr, Pc = RECT ? pa.Pc : Pr;
  const float4* __restrict__ Xr = pa.Xr;
  const float4* __restrict__ Xc = RECT ? pa.Xc : Xr;
  const int* __restrict__ perm_r = pa.perm_r;
  const int* __restrict__ perm_c = RECT ? pa.perm_c : perm_r;
  const int* __restrict__ ptr = pa.ptr;
  const int* __restrict__ list = pa.list;
  const float* __restrict__ g = pa.in;
  float* __restrict__ dfeats = pa.out;
  const int R1 = R + 1, K = NA * R1, KP = fg_kp(R1), AP = KP + 4;
  float* As = sm;
  float* Gs = sm + fg_a_floats<TC>(R1);    // [2][KP][FG_GP]
  float* red = Gs;                         // [NKQ][TILE][FG_RP], at the end
  const int t = threadIdx.x, nt = blockDim.x, w = t >> 5;
  const int gq = (t & 31) >> 2, tq = t & 3;
  const int j0 = blockIdx.x * TILE, fb = blockIdx.y * F_FT;
  const int kb = ptr[blockIdx.x];
  const int nC = (ptr[blockIdx.x + 1] - kb) * NS;
  for (int q = t; q < TILE; q += nt) {
    Xj[q] = j0 + q < Pc ? Xc[j0 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (RECT) Gj[q] = j0 + q < Pc ? perm_c[j0 + q] : -2;
  }
  // the padding k in [K, KP): zero columns of A, zero rows of both stages
  for (int q = t; q < (KP - K) * TILE; q += nt) {
    const int k = K + q / TILE, j = q % TILE;
    As[TC ? j * AP + k : k * TILE + j] = 0.f;
  }
  for (int q = t; q < 2 * (KP - K) * F_FT; q += nt) {
    const int b = q / ((KP - K) * F_FT), r = q % ((KP - K) * F_FT);
    Gs[(b * KP + K + r / F_FT) * FG_GP + r % F_FT] = 0.f;
  }

  // chunk c: row atoms i0 .. i0 + NA - 1 of the (c / NS)-th listed tile;
  // its g rows perm_r[i] * R1 + r (contiguous per atom) and coordinates
  // (RECT: and global indices) into buffer b; atoms past Pr are zeros
  auto chunk_i0 = [&](int c) {
    return list[kb + c / NS] * TILE + (c % NS) * NA;
  };
  auto stage = [&](int c, int b) {
    const int i0 = chunk_i0(c);
    float* gs = Gs + b * KP * FG_GP;
    for (int q = t; q < K * (F_FT / 4); q += nt) {
      const int k = q / (F_FT / 4), ch = (q % (F_FT / 4)) * 4;
      const int a = k / R1, pa_ = i0 + a;
      const bool ok = pa_ < Pr && fb + ch < F;
      cp_async16(gs + k * FG_GP + ch,
                 ok ? g + ((size_t)perm_r[pa_] * R1 + (k - a * R1)) * F +
                          fb + ch
                    : g,
                 ok);
    }
    for (int q = t; q < NA; q += nt) {
      const bool ok = i0 + q < Pr;
      cp_async16(&Xi[b][q], ok ? Xr + i0 + q : Xr, ok);
      if constexpr (RECT) Gi[b][q] = ok ? pa.off + perm_r[i0 + q] : -1;
    }
  };

  float acc[2][4][4];                      // TC: [m][n][fragment]
  float S[8][8];                           // CUDA cores: 8 j x 8 f
  if constexpr (TC) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.f;
  } else {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) S[a][b] = 0.f;
  }

  if (nC > 0) stage(0, 0);
  cp_commit();
  for (int c = 0; c < nC; ++c) {
    const int buf = c & 1;
    cp_wait<0>();
    __syncthreads();          // chunk c has landed; chunk c - 1 is contracted
    if (c + 1 < nC) stage(c + 1, buf ^ 1);
    cp_commit();
    const int i0 = chunk_i0(c);
    for (int p = t; p < TILE * NA; p += nt) {
      // TC: a warp's lanes span 4 atoms x 8 columns (fewer bank conflicts
      // on the row-major stores); CUDA cores: 32 columns of one atom
      const int ii = TC ? p % NA : p / TILE, jj = TC ? p / NA : p % TILE;
      const float4 a = Xj[jj], b = Xi[buf][ii];
      const Geo pg = pair_geo(a.x, a.y, a.z, a.w, RECT ? Gj[jj] : j0 + jj,
                              b.x, b.y, b.z, b.w,
                              RECT ? Gi[buf][ii] : i0 + ii, rc);
      if constexpr (TC)
        a_column<DIVD>(pg, R, rc, As + jj * AP + ii * R1, 1);
      else
        a_column<DIVD>(pg, R, rc, As + ii * R1 * TILE + jj, TILE);
    }
    __syncthreads();
    const float* gs = Gs + buf * KP * FG_GP;
    if constexpr (TC) {
      const int nh = (w & 1) * 32;
      for (int ks = w >> 1; ks < KP / 8; ks += NKQ) {
        const int k0 = ks * 8;
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          frag_a(As + m * 16 * AP + k0, AP, gq, tq, ah[m], al[m]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          // B[k][n] = g[k][f]: b0 = gs[k0 + t][n0 + g], b1 = gs[k0 + t + 4][..]
          const float* q = gs + (k0 + tq) * FG_GP + nh + n * 8 + gq;
          unsigned bh[2], bl[2];
          split_tf32(q[0], bh[0], bl[0]);
          split_tf32(q[4 * FG_GP], bh[1], bl[1]);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma3(acc[m][n], ah[m], al[m], bh, bl);
        }
      }
    } else {
      const int jo = ((t >> 3) & 3) * 8, fo = (t & 7) * 8;
      for (int k = t >> 5; k < K; k += NKQ) {
        float a[8], b[8];
        ld8(As + k * TILE + jo, a);
        ld8(gs + k * FG_GP + fo, b);
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int y = 0; y < 8; ++y) S[x][y] = fmaf(a[x], b[y], S[x][y]);
      }
    }
  }
  __syncthreads();                         // the stages hold no more chunks
  if constexpr (TC) {
    const int kq = w >> 1, nh = (w & 1) * 32;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float* d =
            red + (kq * TILE + m * 16 + gq) * FG_RP + nh + n * 8 + 2 * tq;
        d[0] = acc[m][n][0];
        d[1] = acc[m][n][1];
        d[8 * FG_RP] = acc[m][n][2];
        d[8 * FG_RP + 1] = acc[m][n][3];
      }
  } else {
    const int kq = t >> 5, jo = ((t >> 3) & 3) * 8, fo = (t & 7) * 8;
#pragma unroll
    for (int x = 0; x < 8; ++x)
      st8(red + (kq * TILE + jo + x) * FG_RP + fo, S[x]);
  }
  __syncthreads();
  // the groups' sums in group order; every column of the tile is written
  for (int q = t; q < TILE * (F_FT / 4); q += nt) {
    const int jj = q / (F_FT / 4), c4 = (q % (F_FT / 4)) * 4;
    if (j0 + jj >= Pc || fb + c4 >= F) continue;
    float4 s = *reinterpret_cast<const float4*>(red + jj * FG_RP + c4);
    for (int k = 1; k < NKQ; ++k) {
      const float4 v =
          *reinterpret_cast<const float4*>(red + (k * TILE + jj) * FG_RP + c4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(dfeats + (size_t)perm_c[j0 + jj] * F + fb +
                               c4) = s;
  }
}

template <bool TC, bool DIVD>
__global__ void __launch_bounds__(FG_THREADS)
rc_feats_plan(int P, int F, int R, float rc, const float4* __restrict__ Xp,
              const int* __restrict__ perm, const int* __restrict__ row_ptr,
              const int* __restrict__ cols, const float* __restrict__ g,
              float* __restrict__ dfeats) {
  feats_plan<TC, DIVD, false>(
      F, R, rc, PlanArgs{P, P, 0, Xp, Xp, perm, perm, row_ptr, cols, g,
                         dfeats});
}

template <bool TC, bool DIVD>
__global__ void __launch_bounds__(FG_THREADS)
rc_rect_plan_feats(int F, int R, float rc, PlanArgs pa) {
  feats_plan<TC, DIVD, true>(F, R, rc, pa);
}

// ---------------------------------------------------------------------------
// coordinate gradients: one block per listed tile pair of a plan
// (coords_pairs, the body of rc_coords_pairs and rc_rect_coords_pairs).
// K5 (!RECT): the pairs (I, J), I <= J, of one square plan (I, J, slot of
// (I, J), slot of (J, I)). Per column sub-tile of TJH, Ssym[r][i][j] =
// sum_f g[i, r, f] feats[j, f] + g[j, r, f] feats[i, f] over all of F,
// chunks of FC features staged k-contiguous ([atom][r][f], as g lies in
// memory) by double-buffered cp.async; then w_ij = sum_r dA_r/dd Ssym / d
// once per pair, the I side's sums over j kept in shared memory and the J
// side's over i written to slot (J, I). On a diagonal tile (I = J) Ssym
// already holds both orders, so only the I side is written. Indices are
// plan positions.
// K6 (RECT): the pairs (I, J, e_row, e_col) of a rect plan, I a tile of
// the row block, J of the columns, each side in its own order. One
// product S = g_I feats_J^T (half the staging: no g_J, no feats_I); the
// row side's sums go to slot e_row of part_r, the column side's, negated,
// to slot e_col of part_c. Self-pairs are excluded by global index
// (off + perm_r[a] against perm_c[b]): plan positions of the two sides
// name different atoms.
//   TJH = 32, FC = 8 (R + 1 <= 32): tensor cores; warp w owns
//     r = 2w, 2w + 1, each a 32 x 32 tile of 2 x 4 mma tiles, in 3xTF32;
//   TJH = 16, FC = 4 (R + 1 <= 63): CUDA cores; one thread per
//     (r, 8 i, 8 j), two features a step.
// ---------------------------------------------------------------------------
struct PairArgs {
  int Pr, Pc, off;            // rows, columns, global index of row 0
  const float4* Xr;           // rows' coordinates and mask, plan order
  const float4* Xc;           // columns' (K5: the same plan)
  const int* perm_r;          // local row at each row plan position
  const int* perm_c;
  const int4* pairs;
  const float* feats;         // [Pc, F]
  const float* g;             // [Pr, R+1, F]
  float* part_r;              // the I side's slots (K5: both sides')
  float* part_c;              // the J side's slots
  const int* n_live;          // K5's fixed-capacity plan: its listed pairs
                              // (on the device); the blocks past them exit
                              // at once. NULL: every block has a pair
};

template <int TJH, int FC, bool RECT>
__host__ __device__ constexpr int cg_stage_floats(int R1) {
  return RECT ? (TILE * R1 + TJH) * (FC + 4)
              : (TILE + TJH) * (R1 + 1) * (FC + 4);
}

template <int TJH>
__host__ __device__ constexpr int cg_s_floats(int R1) {
  return R1 * TILE * (TJH + 1);
}

template <int TJH, int FC, bool DIVD, bool RECT>
__device__ __forceinline__ void coords_pairs(int F, int R, float rc,
                                             const PairArgs& pa) {
  constexpr bool TC = TJH == TILE;        // tensor cores on the full tile
  static_assert(TC ? FC == 8 : (TJH == 16 && FC == 4), "tiling");
  constexpr int FCP = FC + 4, TJS = TJH + 1, CH = FC / 4;
  constexpr int NJG = TJH / 8;
  extern __shared__ __align__(16) float sm[];
  __shared__ float4 Xi[TILE], Xj[TJH];
  __shared__ int Gi[TILE], Gj[TJH];       // RECT: global indices
  __shared__ float Ws[TILE][TJS];
  __shared__ float red[TILE][3];
  const int R1 = R + 1;
  const int st = cg_stage_floats<TJH, FC, RECT>(R1);
  float* Ss = sm;                  // [R1][TILE][TJS], aliases the stages
  const int t = threadIdx.x, nt = blockDim.x;
  const int w = t >> 5, gq = (t & 31) >> 2, tq = t & 3;
  const int r = t / (4 * NJG), io = ((t / NJG) % 4) * 8, jo = (t % NJG) * 8;
  if (pa.n_live != nullptr && (int)blockIdx.x >= *pa.n_live) return;
  const int4 pr = pa.pairs[blockIdx.x];
  const int i0 = pr.x * TILE;
  const bool diag = !RECT && pr.x == pr.y;
  // K5: one set of atoms, so the columns' fields fold into the rows'
  const int Pr = pa.Pr, Pc = RECT ? pa.Pc : Pr;
  const float4* __restrict__ Xr = pa.Xr;
  const float4* __restrict__ Xc = RECT ? pa.Xc : Xr;
  const int* __restrict__ perm_r = pa.perm_r;
  const int* __restrict__ perm_c = RECT ? pa.perm_c : perm_r;
  const float* __restrict__ g = pa.g;
  const float* __restrict__ feats = pa.feats;
  float* part_r = pa.part_r;
  float* part_c = RECT ? pa.part_c : part_r;
  for (int q = t; q < TILE; q += nt) {
    const bool ok = i0 + q < Pr;
    Xi[q] = ok ? Xr[i0 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (RECT) Gi[q] = ok ? pa.off + perm_r[i0 + q] : -1;
  }
  for (int q = t; q < TILE * 3; q += nt) (&red[0][0])[q] = 0.f;
  const int nF = F / FC;

  for (int js = 0; js < TILE / TJH; ++js) {
    const int j0 = pr.y * TILE + js * TJH;
    __syncthreads();                      // the last sub-tile is done
    for (int q = t; q < TJH; q += nt) {
      const bool ok = j0 + q < Pc;
      Xj[q] = ok ? Xc[j0 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (RECT) Gj[q] = ok ? perm_c[j0 + q] : -2;
    }
    // chunk c into buffer b: gI [TILE][R1][FCP], then (K5 only) gJ
    // [TJH][R1][FCP] and fI [TILE][FCP], then fJ [TJH][FCP]
    auto stage = [&](int c, int b) {
      float* gIs = sm + b * st;
      float* gJs = gIs + TILE * R1 * FCP;
      float* fIs = gJs + TJH * R1 * FCP;
      float* fJs = RECT ? gJs : fIs + TILE * FCP;
      const int fc = c * FC;
      for (int q = t; q < (RECT ? TILE : TILE + TJH) * R1 * CH; q += nt) {
        const int ch = q % CH, row = q / CH;
        const bool isI = row < TILE * R1;
        const int rw = isI ? row : row - TILE * R1;
        const int a = rw / R1, rr = rw - a * R1;
        const int p = (isI ? i0 : j0) + a;
        const bool ok = p < (isI ? Pr : Pc);
        cp_async16((isI ? gIs : gJs) + rw * FCP + ch * 4,
                   ok ? g + ((size_t)(isI ? perm_r : perm_c)[p] * R1 +
                             rr) * F + fc + ch * 4
                      : g,
                   ok);
      }
      constexpr int A0 = RECT ? TILE : 0;   // feats rows: fI (K5), fJ
      for (int q = t; q < (TILE + TJH - A0) * CH; q += nt) {
        const int ch = q % CH, a = A0 + q / CH;
        const bool isI = a < TILE;
        const int aa = isI ? a : a - TILE;
        const int p = (isI ? i0 : j0) + aa;
        const bool ok = p < (isI ? Pr : Pc);
        cp_async16((isI ? fIs : fJs) + aa * FCP + ch * 4,
                   ok ? feats + (size_t)(isI ? perm_r : perm_c)[p] * F +
                            fc + ch * 4
                      : feats,
                   ok);
      }
    };

    float acc[2][2][4][4];                // TC: [r][m][n][fragment]
    float S[8][8];                        // CUDA cores: 8 i x 8 j
    if constexpr (TC) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][m][n][c] = 0.f;
    } else {
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) S[a][b] = 0.f;
    }

    stage(0, 0);
    cp_commit();
    for (int c = 0; c < nF; ++c) {
      const int buf = c & 1;
      if (c + 1 < nF) stage(c + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();                    // chunk c has landed for all
      const float* gIs = sm + buf * st;
      const float* gJs = gIs + TILE * R1 * FCP;
      const float* fIs = gJs + TJH * R1 * FCP;
      const float* fJs = RECT ? gJs : fIs + TILE * FCP;
      if constexpr (TC) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int rv = 2 * w + rr;
          if (rv < R1) {                  // warp-uniform
            unsigned ah[2][4], al[2][4], bh[2], bl[2];
            // S1[i, j] += sum_f g[i, r, f] feats[j, f]
#pragma unroll
            for (int m = 0; m < 2; ++m)
              frag_a(gIs + (m * 16 * R1 + rv) * FCP, R1 * FCP, gq, tq,
                     ah[m], al[m]);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              frag_b(fJs + n * 8 * FCP, FCP, gq, tq, bh, bl);
#pragma unroll
              for (int m = 0; m < 2; ++m)
                mma3(acc[rr][m][n], ah[m], al[m], bh, bl);
            }
            if constexpr (!RECT) {
              // S2[i, j] = S1[j, i] += sum_f feats[i, f] g[j, r, f]
#pragma unroll
              for (int m = 0; m < 2; ++m)
                frag_a(fIs + m * 16 * FCP, FCP, gq, tq, ah[m], al[m]);
#pragma unroll
              for (int n = 0; n < 4; ++n) {
                frag_b(gJs + (n * 8 * R1 + rv) * FCP, R1 * FCP, gq, tq, bh,
                       bl);
#pragma unroll
                for (int m = 0; m < 2; ++m)
                  mma3(acc[rr][m][n], ah[m], al[m], bh, bl);
              }
            }
          }
        }
      } else if (r < R1) {
#pragma unroll
        for (int f = 0; f < FC; f += 2) {
          float2 a[8], b[8];
#pragma unroll
          for (int x = 0; x < 8; ++x)
            a[x] = *reinterpret_cast<const float2*>(
                gIs + ((io + x) * R1 + r) * FCP + f);
#pragma unroll
          for (int y = 0; y < 8; ++y)
            b[y] = *reinterpret_cast<const float2*>(fJs + (jo + y) * FCP + f);
#pragma unroll
          for (int x = 0; x < 8; ++x)
#pragma unroll
            for (int y = 0; y < 8; ++y)
              S[x][y] = fmaf(a[x].y, b[y].y, fmaf(a[x].x, b[y].x, S[x][y]));
          if constexpr (!RECT) {
#pragma unroll
            for (int x = 0; x < 8; ++x)
              a[x] = *reinterpret_cast<const float2*>(fIs + (io + x) * FCP +
                                                      f);
#pragma unroll
            for (int y = 0; y < 8; ++y)
              b[y] = *reinterpret_cast<const float2*>(
                  gJs + ((jo + y) * R1 + r) * FCP + f);
#pragma unroll
            for (int x = 0; x < 8; ++x)
#pragma unroll
              for (int y = 0; y < 8; ++y)
                S[x][y] =
                    fmaf(a[x].y, b[y].y, fmaf(a[x].x, b[y].x, S[x][y]));
          }
        }
      }
      __syncthreads();                    // buffer buf is free
    }
    cp_wait<0>();
    // S into shared memory (the staging buffers are no longer read)
    if constexpr (TC) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int rv = 2 * w + rr;
        if (rv >= R1) continue;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float* d = Ss + (rv * TILE + m * 16 + gq) * TJS + n * 8 + 2 * tq;
            d[0] = acc[rr][m][n][0];
            d[1] = acc[rr][m][n][1];
            d[8 * TJS] = acc[rr][m][n][2];
            d[8 * TJS + 1] = acc[rr][m][n][3];
          }
      }
    } else if (r < R1) {
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y)
          Ss[(r * TILE + io + x) * TJS + jo + y] = S[x][y];
    }
    __syncthreads();
    // dA/dd once per pair: w_ij = G_ij / d_ij (0 outside the cutoff)
    for (int q = t; q < TILE * TJH; q += nt) {
      const int i = q / TJH, j = q % TJH;
      const float4 a = Xi[i], b = Xj[j];
      const Geo pg = pair_geo(a.x, a.y, a.z, a.w, RECT ? Gi[i] : i0 + i, b.x,
                              b.y, b.z, b.w, RECT ? Gj[j] : j0 + j, rc);
      Ws[i][j] = accum_g<DIVD>(pg, R, rc, Ss + i * TJS + j, TILE * TJS) /
                 pg.d;
    }
    __syncthreads();
    // I side: one thread per (i, axis) sums over j in order
    for (int q = t; q < TILE * 3; q += nt) {
      const int i = q / 3, c = q % 3;
      const float xi = comp(Xi[i], c);
      float s = red[i][c];
      for (int j = 0; j < TJH; ++j) s = fmaf(Ws[i][j], xi - comp(Xj[j], c), s);
      red[i][c] = s;
    }
    // J side: one thread per (j, axis) sums over i in order; slot (J, I)
    // (K5) or e_col (K6)
    if (!diag) {
      for (int q = t; q < TJH * 3; q += nt) {
        const int j = q / 3, c = q % 3;
        const float xj = comp(Xj[j], c);
        float s = 0.f;
        for (int i = 0; i < TILE; ++i)
          s = fmaf(Ws[i][j], xj - comp(Xi[i], c), s);
        part_c[((size_t)pr.w * TILE + js * TJH + j) * 3 + c] = s;
      }
    }
  }
  __syncthreads();
  for (int q = t; q < TILE * 3; q += nt)
    part_r[(size_t)pr.z * TILE * 3 + q] = (&red[0][0])[q];
}

// the two kernels, each its own name in a profile
template <int TJH, int FC, bool DIVD>
__global__ void __launch_bounds__(512)
rc_coords_pairs(int F, int R, float rc, PairArgs pa) {
  coords_pairs<TJH, FC, DIVD, false>(F, R, rc, pa);
}

template <int TJH, int FC, bool DIVD>
__global__ void __launch_bounds__(512)
rc_rect_coords_pairs(int F, int R, float rc, PairArgs pa) {
  coords_pairs<TJH, FC, DIVD, true>(F, R, rc, pa);
}

// dx[perm[a]] = the atom's slots summed in the order of its tile's list
// (ptr: the plan's CSR of that side); atoms of a tile with no reach get 0
__device__ __forceinline__ void sum_slots(int a, int c,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ ptr,
                                          const float* __restrict__ part,
                                          float* __restrict__ dx) {
  const int I = a / TILE, l = a % TILE;
  float s = 0.f;
  for (int e = ptr[I]; e < ptr[I + 1]; ++e)
    s += part[((size_t)e * TILE + l) * 3 + c];
  dx[(size_t)perm[a] * 3 + c] = s;
}

__global__ void rc_coords_reduce(int P, const int* __restrict__ perm,
                                 const int* __restrict__ row_ptr,
                                 const float* __restrict__ part,
                                 float* __restrict__ dx) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < P * 3) sum_slots(q / 3, q % 3, perm, row_ptr, part, dx);
}

// K6: both sides in one grid, the rows' slots in row-list order, the
// columns' in column-list order
__global__ void rc_rect_coords_reduce(int Pr, int Pc,
                                      const int* __restrict__ perm_r,
                                      const int* __restrict__ perm_c,
                                      const int* __restrict__ row_ptr,
                                      const int* __restrict__ col_ptr,
                                      const float* __restrict__ part_r,
                                      const float* __restrict__ part_c,
                                      float* __restrict__ dx_r,
                                      float* __restrict__ dx_c) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < Pr * 3)
    sum_slots(q / 3, q % 3, perm_r, row_ptr, part_r, dx_r);
  else if (q < (Pr + Pc) * 3)
    sum_slots(q / 3 - Pr, q % 3, perm_c, col_ptr, part_c, dx_c);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename K>
int launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
           int P, int F, int R, float rc, const float4* Xp, const int* perm,
           const int* a, const int* b, const float* c, float* d) {
  int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, threads, smem, s>>>(P, F, R, rc, Xp, perm, a, b, c, d);
  return (int)cudaGetLastError();
}

template <typename K>
int launch_rect(K kernel, dim3 grid, int threads, size_t smem,
                cudaStream_t s, int F, int R, float rc, const PlanArgs& pa) {
  int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<grid, threads, smem, s>>>(F, R, rc, pa);
  return (int)cudaGetLastError();
}

// the launch shapes of K5's and K6's kernels on a plan
struct Shape {
  dim3 grid;
  int threads;
  size_t smem;
};

// forward over `rows` rows: tensor cores up to R+1 = 32 (warps own two
// radial channels: at most 16 warps), CUDA cores above
Shape fwd_shape(int rows, int F, int R1) {
  if (R1 <= 32)
    return {dim3((rows + T_RB - 1) / T_RB, (F + F_FT - 1) / F_FT),
            32 * ((R1 + 1) / 2),
            sizeof(float) * (R1 * T_RB * T_AP + 2 * TILE * T_FP)};
  return {dim3((rows + F_TI - 1) / F_TI, (F + F_FT - 1) / F_FT),
          R1 * (F_FT / 8),
          sizeof(float) * (TILE * R1 * F_TI + 2 * TILE * F_FT)};
}

// feats gradient over `cols` columns: tensor cores up to R+1 = 32 (91 KB
// of shared memory there), CUDA cores above (177 KB at R+1 = 63)
Shape feats_shape(int cols, int F, int R1) {
  return {dim3((cols + TILE - 1) / TILE, (F + F_FT - 1) / F_FT), FG_THREADS,
          sizeof(float) * (R1 <= 32 ? fg_smem_floats<true>(R1)
                                    : fg_smem_floats<false>(R1))};
}

template <int TJH, int FC, bool DIVD, bool RECT>
int launch_coords(int F, int R, float rc, int n_pairs, const PairArgs& pa,
                  cudaStream_t s) {
  const int R1 = R + 1;
  const int threads =
      TJH == TILE ? 32 * ((R1 + 1) / 2) : R1 * 4 * (TJH / 8);
  if (threads > 512) return (int)cudaErrorInvalidValue;
  const int fl = 2 * cg_stage_floats<TJH, FC, RECT>(R1) > cg_s_floats<TJH>(R1)
                     ? 2 * cg_stage_floats<TJH, FC, RECT>(R1)
                     : cg_s_floats<TJH>(R1);
  const size_t smem = sizeof(float) * fl;
  void (*kernel)(int, int, float, PairArgs) =
      RECT ? rc_rect_coords_pairs<TJH, FC, DIVD>
           : rc_coords_pairs<TJH, FC, DIVD>;
  int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<n_pairs, threads, smem, s>>>(F, R, rc, pa);
  return (int)cudaGetLastError();
}

// the tiling by R + 1: tensor cores on full 32 x 32 pair tiles up to 32,
// CUDA cores on two column halves of 16 above
template <bool RECT>
int launch_coords_any(int F, int R, int div_d, float rc, int n_pairs,
                      const PairArgs& pa, cudaStream_t s) {
  if (R + 1 <= 32)
    return div_d ? launch_coords<32, 8, true, RECT>(F, R, rc, n_pairs, pa, s)
                 : launch_coords<32, 8, false, RECT>(F, R, rc, n_pairs, pa, s);
  return div_d ? launch_coords<16, 4, true, RECT>(F, R, rc, n_pairs, pa, s)
               : launch_coords<16, 4, false, RECT>(F, R, rc, n_pairs, pa, s);
}

}  // namespace

extern "C" {

// the plan's Xp [P, 4], perm [P], row_ptr [T + 1], cols; feats [P, F] ->
// out [P, R+1, F]; F % 8 == 0, R + 1 <= 63. Tensor cores up to R+1 = 32,
// CUDA cores above.
int rc_fwd_launch(int P, int F, int R, int div_d, float rc, const float* Xp,
                  const int* perm, const int* row_ptr, const int* cols,
                  const float* feats, float* out, void* stream) {
  const int R1 = R + 1;
  if (F % 8 != 0 || R1 > 63) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* X4 = reinterpret_cast<const float4*>(Xp);
  const Shape sh = fwd_shape(P, F, R1);
  if (R1 <= 32)
    return div_d ? launch(rc_fwd_tc<true>, sh.grid, sh.threads, sh.smem, s,
                          P, F, R, rc, X4, perm, row_ptr, cols, feats, out)
                 : launch(rc_fwd_tc<false>, sh.grid, sh.threads, sh.smem, s,
                          P, F, R, rc, X4, perm, row_ptr, cols, feats, out);
  return div_d ? launch(rc_fwd_fma<true>, sh.grid, sh.threads, sh.smem, s, P,
                        F, R, rc, X4, perm, row_ptr, cols, feats, out)
               : launch(rc_fwd_fma<false>, sh.grid, sh.threads, sh.smem, s,
                        P, F, R, rc, X4, perm, row_ptr, cols, feats, out);
}

// the plan's Xp, perm, row_ptr, cols; g [P, R+1, F] -> dfeats [P, F], every
// row written; F % 8 == 0, R + 1 <= 63.
int rc_bwd_feats_launch(int P, int F, int R, int div_d, float rc,
                        const float* Xp, const int* perm, const int* row_ptr,
                        const int* cols, const float* g, float* dfeats,
                        void* stream) {
  const int R1 = R + 1;
  if (F % 8 != 0 || R1 > 63) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* X4 = reinterpret_cast<const float4*>(Xp);
  const Shape sh = feats_shape(P, F, R1);
  if (R1 <= 32)
    return div_d ? launch(rc_feats_plan<true, true>, sh.grid, sh.threads,
                          sh.smem, s, P, F, R, rc, X4, perm, row_ptr, cols, g,
                          dfeats)
                 : launch(rc_feats_plan<true, false>, sh.grid, sh.threads,
                          sh.smem, s, P, F, R, rc, X4, perm, row_ptr, cols, g,
                          dfeats);
  return div_d ? launch(rc_feats_plan<false, true>, sh.grid, sh.threads,
                        sh.smem, s, P, F, R, rc, X4, perm, row_ptr, cols, g,
                        dfeats)
               : launch(rc_feats_plan<false, false>, sh.grid, sh.threads,
                        sh.smem, s, P, F, R, rc, X4, perm, row_ptr, cols, g,
                        dfeats);
}

// the plan's Xp, perm, row_ptr and n_pairs pairs [n_pairs, 4]; g [P, R+1,
// F], feats [P, F]; part [>= listed ordered pairs, 32, 3] scratch -> dx
// [P, 3]. n_live: NULL, or (a fixed-capacity plan, whose count a captured
// graph cannot read on the host) the listed pairs on the device, the
// first *n_live of the n_pairs slots; the grid stays n_pairs blocks. Up
// to R+1 = 32 full 32 x 32 pair tiles in chunks of 8 features
// (double-buffered, 203 KB of shared memory at R+1 = 32); above, two
// column halves of 16 in chunks of 4, on CUDA cores (at R+1 = 64 the
// 16-column stages pass the 227 KB a block may have). The 16-column tiling
// exists for uma-m-1p1 (R+1 = 33) alone; uma-s-1p1 and small take the
// 32-column one.
int rc_bwd_coords_launch(int P, int F, int R, int div_d, float rc,
                         int n_pairs, const int* n_live, const float* Xp,
                         const int* perm, const int* row_ptr,
                         const int* pairs,
                         const float* feats, const float* g, float* part,
                         float* dx, void* stream) {
  if (F % 8 != 0 || R + 1 > 63) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* X4 = reinterpret_cast<const float4*>(Xp);
  const PairArgs pa{P,     P,
                    0,     X4,
                    X4,    perm,
                    perm,  reinterpret_cast<const int4*>(pairs),
                    feats, g,
                    part,  part,
                    n_live};
  if (n_pairs > 0) {
    const int err = launch_coords_any<false>(F, R, div_d, rc, n_pairs, pa, s);
    if (err) return err;
  }
  rc_coords_reduce<<<(3 * P + 255) / 256, 256, 0, s>>>(P, perm, row_ptr,
                                                        part, dx);
  return (int)cudaGetLastError();
}

// ---- K6 on a rect plan: rows (global indices off ..), columns ----------

// the rect plan's Xr [Pr, 4], Xc [Pc, 4], perm_r, perm_c, row_ptr, cols;
// feats [Pc, F] -> out [Pr, R+1, F], every row written (rows of a tile
// that lists nothing get zeros). F % 8 == 0, R + 1 <= 63: K5's tilings,
// tensor cores up to R+1 = 32, CUDA cores above.
int rc_rect_plan_fwd_launch(int Pr, int Pc, int off, int F, int R, int div_d,
                            float rc, const float* Xr, const float* Xc,
                            const int* perm_r, const int* perm_c,
                            const int* row_ptr, const int* cols,
                            const float* feats, float* out, void* stream) {
  const int R1 = R + 1;
  if (F % 8 != 0 || R1 > 63) return (int)cudaErrorInvalidValue;
  if (Pr == 0 || F == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const PlanArgs pa{Pr,     Pc,     off,     reinterpret_cast<const float4*>(Xr),
                    reinterpret_cast<const float4*>(Xc), perm_r, perm_c,
                    row_ptr, cols, feats, out};
  const Shape sh = fwd_shape(Pr, F, R1);
  if (R1 <= 32)
    return div_d ? launch_rect(rc_rect_plan_fwd_tc<true>, sh.grid,
                               sh.threads, sh.smem, s, F, R, rc, pa)
                 : launch_rect(rc_rect_plan_fwd_tc<false>, sh.grid,
                               sh.threads, sh.smem, s, F, R, rc, pa);
  return div_d ? launch_rect(rc_rect_plan_fwd_fma<true>, sh.grid, sh.threads,
                             sh.smem, s, F, R, rc, pa)
               : launch_rect(rc_rect_plan_fwd_fma<false>, sh.grid,
                             sh.threads, sh.smem, s, F, R, rc, pa);
}

// the rect plan's Xr, Xc, perm_r, perm_c, col_ptr [Tc + 1], rows; g [Pr,
// R+1, F] -> dfeats [Pc, F], every column written (columns of a tile that
// lists nothing get zeros). F % 8 == 0, R + 1 <= 63: tensor cores up to
// R+1 = 32, CUDA cores above.
int rc_rect_plan_feats_launch(int Pr, int Pc, int off, int F, int R,
                              int div_d, float rc, const float* Xr,
                              const float* Xc, const int* perm_r,
                              const int* perm_c, const int* col_ptr,
                              const int* rows, const float* g, float* dfeats,
                              void* stream) {
  const int R1 = R + 1;
  if (F % 8 != 0 || R1 > 63) return (int)cudaErrorInvalidValue;
  if (Pc == 0 || F == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const PlanArgs pa{Pr,     Pc,     off,     reinterpret_cast<const float4*>(Xr),
                    reinterpret_cast<const float4*>(Xc), perm_r, perm_c,
                    col_ptr, rows, g, dfeats};
  const Shape sh = feats_shape(Pc, F, R1);
  if (R1 <= 32)
    return div_d ? launch_rect(rc_rect_plan_feats<true, true>, sh.grid,
                               sh.threads, sh.smem, s, F, R, rc, pa)
                 : launch_rect(rc_rect_plan_feats<true, false>, sh.grid,
                               sh.threads, sh.smem, s, F, R, rc, pa);
  return div_d ? launch_rect(rc_rect_plan_feats<false, true>, sh.grid,
                             sh.threads, sh.smem, s, F, R, rc, pa)
               : launch_rect(rc_rect_plan_feats<false, false>, sh.grid,
                             sh.threads, sh.smem, s, F, R, rc, pa);
}

// the rect plan's Xr [Pr, 4], Xc [Pc, 4], perm_r, perm_c, row_ptr,
// col_ptr and n_pairs pairs [n_pairs, 4]; feats [Pc, F], g [Pr, R+1, F];
// part_r, part_c [n_pairs, 32, 3] scratch -> dx_r [Pr, 3], dx_c [Pc, 3],
// every row and column written. F % 8 == 0, R + 1 <= 63. Up to R+1 = 32
// full 32 x 32 pair tiles on the tensor cores (111.5 KB of shared memory
// at R+1 = 25), above two column halves of 16 on CUDA cores (140.6 KB at
// R+1 = 63).
int rc_rect_bwd_coords_launch(int Pr, int Pc, int off, int F, int R,
                              int div_d, float rc, int n_pairs,
                              const float* Xr, const float* Xc,
                              const int* perm_r, const int* perm_c,
                              const int* row_ptr, const int* col_ptr,
                              const int* pairs, const float* feats,
                              const float* g, float* part_r, float* part_c,
                              float* dx_r, float* dx_c, void* stream) {
  if (F % 8 != 0 || R + 1 > 63) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const PairArgs pa{Pr,
                    Pc,
                    off,
                    reinterpret_cast<const float4*>(Xr),
                    reinterpret_cast<const float4*>(Xc),
                    perm_r,
                    perm_c,
                    reinterpret_cast<const int4*>(pairs),
                    feats,
                    g,
                    part_r,
                    part_c};
  if (n_pairs > 0) {
    const int err = launch_coords_any<true>(F, R, div_d, rc, n_pairs, pa, s);
    if (err) return err;
  }
  if (Pr + Pc > 0)
    rc_rect_coords_reduce<<<(3 * (Pr + Pc) + 255) / 256, 256, 0, s>>>(
        Pr, Pc, perm_r, perm_c, row_ptr, col_ptr, part_r, part_c, dx_r,
        dx_c);
  return (int)cudaGetLastError();
}

}  // extern "C"
