// The grouped GEMM on the tensor cores in the 3xTF32 split, with wgmma,
// shared by the eSCN edge kernels (escn_edge.cu: the SO(2) conv products
// of K1, K3 and K4) and the node FFN (escn_ffn.cu: K2's products). Each
// user instantiates conv_tf32 with its own tag type, so a profiler shows
// the two users' launches under their own names. cuda_build hashes every
// header of csrc/ into each library's key, so an edit here rebuilds both.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int MAXMB = 5;     // ops of one grouped launch (|m| blocks)

// what the epilogue stores at C[r, n] for v = (A B^T)[r, n] + bias[n]
enum Epi {
  EPI_BIAS,     // v
  EPI_SILU,     // silu(v)
  EPI_DSILU,    // silu'(v)
  EPI_MUL,      // v * C[r, n]: the old value of C (C is its own aux
                // operand), read and written by the same thread
};

// tag types: one conv_tf32 kernel name per user
struct edge_conv;
struct node_ffn;

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = 1.f / (1.f + expf(-x));
  return s * (1.f + x * (1.f - s));
}

// two neighbouring elements of C at c, v0 and v1 their values of A B^T +
// bias, o0 and o1 their old values (read by EPI_MUL only)
template <int EPI>
__device__ __forceinline__ void store2(float* c, float v0, float v1,
                                       float o0, float o1) {
  if constexpr (EPI == EPI_SILU) {
    v0 = silu(v0);
    v1 = silu(v1);
  } else if constexpr (EPI == EPI_DSILU) {
    v0 = dsilu(v0);
    v1 = dsilu(v1);
  } else if constexpr (EPI == EPI_MUL) {
    v0 *= o0;
    v1 *= o1;
  }
  *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
}

// --------------------------------------------------------------------------
// grouped GEMM on the tensor cores, 3xTF32, with wgmma:
//   C_b[M, n_b] = f(A_b[M, k_b] B_b[n_b, k_b]^T (+ bias_b[n_b]))
// for the ops b of one group (the |m| blocks of one conv; one op for K2),
// rows at the given strides, k contiguous in both operands, f the
// epilogue EPI. A block owns a 128 x 128 output tile; each
// of its two warpgroups owns 64 rows of it and multiplies with wgmma
// m64n128k8 (TF32), both operands read from shared memory.
//
// Shared memory holds each operand slice (128 rows x GK = 32 k) in the
// K-major layout wgmma reads without swizzling: 8 column blocks of 4 k,
// each 128 rows x 16 bytes, so an 8-row x 16-byte core matrix is 128
// contiguous bytes (8-row groups 128 B apart, column blocks 2 KB apart).
// --------------------------------------------------------------------------
constexpr int GM = 128, GN = 128, GK = 32, GST = 3;
static_assert(GM == GN, "both operand slices share one layout");
constexpr int G_THREADS = 256;
constexpr int G_SLICE = GM * GK;         // floats of an operand slice
constexpr int G_SMEM =
    (int)sizeof(float) * G_SLICE * (2 * GST + 4);  // 160 KB
constexpr int G_LBO = GM * 16;           // bytes between column blocks
constexpr int G_SBO = 8 * 16;            // bytes between 8-row groups

struct GemmOp {
  const float* a;       // [M, k] at stride lda
  const float* b;       // [n, k] at stride ldb
  const float* bias;    // [n] or null
  float* c;             // [M, n] at stride ldc
  int lda, ldb, ldc, n, k;
  int tile0, ntn;       // first tile of the op in the grid, column tiles
};

struct Group {
  GemmOp op[MAXMB];
  int nb, m;
};

// hi in place, lo beside it: each element split once
__device__ __forceinline__ void split4(float* hi, float* lo) {
  float4 v = *reinterpret_cast<float4*>(hi);
  unsigned h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  *reinterpret_cast<float4*>(hi) =
      make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                  __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo) =
      make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                  __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// shared-memory offset (floats) of 16-byte chunk q of a slice, and its row
// and k: a warp's 32 chunks are 16 rows x 2 column blocks, so 8 lanes write
// 8 consecutive rows of one column block (no bank conflict) and lanes l and
// l + 8 read the two halves of one 32-byte sector of a row
__device__ __forceinline__ int chunk(int q, int& r, int& kc) {
  const int w = q >> 5, l = q & 31;
  const int kb = 2 * (w >> 3) + ((l >> 3) & 1);
  r = 16 * (w & 7) + (l & 7) + 8 * (l >> 4);
  kc = 4 * kb;
  return kb * GM * 4 + r * 4;
}

// wgmma matrix descriptor of a K-major operand at p, no swizzle
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(G_LBO >> 4) << 16) |
         ((uint64_t)(G_SBO >> 4) << 32);
}

// d[64] = (scale_d ? d : 0) + A[64 x 8] B[128 x 8]^T, TF32, asynchronous
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// keeps the compiler from moving accesses of d across wgmma's
// asynchronous use of the registers
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int EPI, class Tag>
__global__ void __launch_bounds__(G_THREADS, 1) conv_tf32(const Group g) {
  extern __shared__ __align__(128) float gsm[];
  float* stA = gsm;                       // [GST] slices: raw, then hi
  float* stB = gsm + GST * G_SLICE;       // [GST]
  float* lo = stB + GST * G_SLICE;        // [2][A, B]: lo of two slices
  const int t = blockIdx.x;
  GemmOp op = g.op[0];
#pragma unroll
  for (int i = 1; i < MAXMB; ++i)
    if (i < g.nb && t >= g.op[i].tile0) op = g.op[i];
  const int local = t - op.tile0;
  const int m0 = (local / op.ntn) * GM, n0 = (local % op.ntn) * GN;
  const int M = g.m, N = op.n, K = op.k;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int nk = (K + GK - 1) / GK;

  float acc[64], p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = p[i] = 0.f;

  // thread tid copies (and later splits) chunks tid + 256 i, i < 4, of the
  // A and B slices
  auto load = [&](int slot, int kt) {
    const int k0 = kt * GK;
    float* As = stA + slot * G_SLICE;
    float* Bs = stB + slot * G_SLICE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r, kc;
      const int off = chunk(tid + i * G_THREADS, r, kc);
      const bool kok = k0 + kc < K;
      const bool oa = kok && m0 + r < M;
      cp_async16(As + off,
                 oa ? op.a + (size_t)(m0 + r) * op.lda + k0 + kc : op.a, oa);
      const bool ob = kok && n0 + r < N;
      cp_async16(Bs + off,
                 ob ? op.b + (size_t)(n0 + r) * op.ldb + k0 + kc : op.b, ob);
    }
  };
  auto split = [&](int slot, float* lA, float* lB) {
    float* As = stA + slot * G_SLICE;
    float* Bs = stB + slot * G_SLICE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r, kc;
      const int off = chunk(tid + i * G_THREADS, r, kc);
      split4(As + off, lA + off);
      split4(Bs + off, lB + off);
    }
  };
  // the three products of slice kt, the small cross terms first, into p,
  // which starts the slice at zero; asynchronous (one k8 step is two
  // column blocks)
  auto products = [&](int slot, const float* lA, const float* lB) {
    const float* Ah = stA + slot * G_SLICE + wg * 64 * 4;
    const float* Al = lA + wg * 64 * 4;
    const float* Bh = stB + slot * G_SLICE;
    fence_regs(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < GK / 8; ++kk) {
      const int o = kk * 2 * GM * 4;
      wgmma_tf32(p, smem_desc(Al + o), smem_desc(Bh + o), kk > 0);
      wgmma_tf32(p, smem_desc(Ah + o), smem_desc(lB + o), 1);
      wgmma_tf32(p, smem_desc(Ah + o), smem_desc(Bh + o), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  // the tensor cores round their accumulator toward zero, a bias that
  // grows with the k steps summed in it: p sums 4 k steps, acc the slices
  // on CUDA cores
  auto collect = [&]() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(p);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += p[i];
  };

  // Slice kt is split while slice kt - 1's products run; one barrier a
  // slice. The lo planes alternate between two buffers.
#pragma unroll
  for (int s = 0; s < GST - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % GST;
    float* lA = lo + (kt & 1) * 2 * G_SLICE;
    float* lB = lA + G_SLICE;
    cp_wait<GST - 2>();        // this thread's copies of slice kt landed
    split(slot, lA, lB);
    // the splits are generic-proxy writes that wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (kt > 0) collect();     // this warpgroup's products of slice kt - 1
    __syncthreads();           // slice kt split; slice kt - 1's products
                               // done: its slot and lo planes are free
    if (kt + GST - 1 < nk) load((kt + GST - 1) % GST, kt + GST - 1);
    cp_commit();
    products(slot, lA, lB);
  }
  if (nk > 0) collect();
  cp_wait<0>();

  // epilogue: warp w of the warpgroup holds rows 16 w + gq (+8), columns
  // 8 j + 2 tq (+1) in acc[4 j ..]
  const int r0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + gq;
  if constexpr (EPI == EPI_MUL) {
    // the old values of C into p (free now), all loads issued before the
    // first store, which the compiler could not otherwise move them past
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      if (col >= N) continue;
      if (r0 < M) {
        const float2 o =
            *reinterpret_cast<const float2*>(op.c + (size_t)r0 * op.ldc + col);
        p[4 * j] = o.x;
        p[4 * j + 1] = o.y;
      }
      if (r0 + 8 < M) {
        const float2 o = *reinterpret_cast<const float2*>(
            op.c + (size_t)(r0 + 8) * op.ldc + col);
        p[4 * j + 2] = o.x;
        p[4 * j + 3] = o.y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * tq;
    if (col >= N) continue;
    const float b0 = op.bias ? op.bias[col] : 0.f;
    const float b1 = op.bias ? op.bias[col + 1] : 0.f;
    if (r0 < M)
      store2<EPI>(op.c + (size_t)r0 * op.ldc + col, acc[4 * j] + b0,
                  acc[4 * j + 1] + b1, p[4 * j], p[4 * j + 1]);
    if (r0 + 8 < M)
      store2<EPI>(op.c + (size_t)(r0 + 8) * op.ldc + col,
                  acc[4 * j + 2] + b0, acc[4 * j + 3] + b1, p[4 * j + 2],
                  p[4 * j + 3]);
  }
}

bool al16(const void* p) { return ((uintptr_t)p & 15) == 0; }

void add_op(Group& gr, const float* a, int lda, const float* b, int ldb,
            const float* bias, float* c, int ldc, int n, int k) {
  GemmOp& o = gr.op[gr.nb++];
  o.a = a;
  o.lda = lda;
  o.b = b;
  o.ldb = ldb;
  o.bias = bias;
  o.c = c;
  o.ldc = ldc;
  o.n = n;
  o.k = k;
}

// one launch for the group: ops sorted by k, longest first; the tiles of
// op b are tile0 .. tile0 + ceil(M/GM) * ntn - 1, column tile fastest
template <int EPI, class Tag>
cudaError_t run_group(cudaStream_t st, Group gr) {
  for (int i = 1; i < gr.nb; ++i)
    for (int j = i; j > 0 && gr.op[j].k > gr.op[j - 1].k; --j) {
      const GemmOp tmp = gr.op[j];
      gr.op[j] = gr.op[j - 1];
      gr.op[j - 1] = tmp;
    }
  const int tm = (gr.m + GM - 1) / GM;
  int tiles = 0;
  for (int b = 0; b < gr.nb; ++b) {
    GemmOp& o = gr.op[b];
    if (!al16(o.a) || !al16(o.b) || !al16(o.c) || o.lda % 4 || o.ldb % 4 ||
        o.ldc % 4 || o.k % 4 || o.n % 4 || (o.bias && ((uintptr_t)o.bias & 7)))
      return cudaErrorInvalidValue;
    o.ntn = (o.n + GN - 1) / GN;
    o.tile0 = tiles;
    tiles += tm * o.ntn;
  }
  if (tiles == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      conv_tf32<EPI, Tag>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G_SMEM);
  if (err) return err;
  conv_tf32<EPI, Tag><<<tiles, G_THREADS, G_SMEM, st>>>(gr);
  return cudaGetLastError();
}

}  // namespace
