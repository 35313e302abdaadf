// Shared helpers of the hand-written kernels: asynchronous 16-byte copies
// into shared memory and f32-accurate products on the tensor cores in the
// 3xTF32 split (K5 in radial_contract.cu, the grouped GEMM in
// tf32_gemm.cuh). cuda_build hashes every header of csrc/ into each
// library's key, so an edited header rebuilds its users.
#pragma once

#include <cuda_runtime.h>

// 16 bytes global -> shared, asynchronous; zero-filled when !ok (src is
// then not read)
static __device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                                  bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

static __device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 3xTF32: x = hi + lo, each exact in TF32; a b ~ ah bh + ah bl + al bh
static __device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

static __device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                                  unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

static __device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                                const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[16 x 8] += a[16 x 8] b[8 x 8], the small cross terms first. The
// tensor cores round their accumulator toward zero, a bias that grows with
// the number of k steps summed into it; so the three products of one step
// go into a zeroed fragment, which is added to c on CUDA cores (rounded
// to nearest).
static __device__ __forceinline__ void mma3(float* c, const unsigned* ah,
                                            const unsigned* al,
                                            const unsigned* bh,
                                            const unsigned* bl) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, al, bh);
  mma_tf32(p, ah, bl);
  mma_tf32(p, ah, bh);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] += p[q];
}
