// The k-NN plugin's score transforms, shared by every exact-kNN kernel
// (through knn_tile.cuh) and the fixed-order rescore (knn_rescore.cu):
//   l2      1 / (1 + max(|q|^2 - 2 q.v + |v|^2, 0))
//   cosine  (1 + q.v / (max(|q|^2,1e-24)^.5 * max(|v|^2,1e-24)^.5)) / 2
//   dot     q.v >= 0 ? q.v + 1 : 1 / (1 - q.v)
// Each rounds after every operation (__fmul_rn etc., and the libraries are
// built with -fmad=false), so it rounds like the plain PyTorch versions, one
// eager operation at a time.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp

enum { SIM_L2 = 0, SIM_COSINE = 1, SIM_DOT = 2 };

__device__ __forceinline__ float transform_score(float dots, float qsq,
                                                 float nsq, int sim) {
  if (sim == SIM_L2) {
    float t = __fsub_rn(qsq, __fmul_rn(2.0f, dots));
    t = __fadd_rn(t, nsq);
    const float d_sq = fmaxf(t, 0.0f);
    return __fdiv_rn(1.0f, __fadd_rn(1.0f, d_sq));
  }
  if (sim == SIM_COSINE) {
    const float qn = __fsqrt_rn(fmaxf(qsq, 1e-24f));
    const float vn = __fsqrt_rn(fmaxf(nsq, 1e-24f));
    const float c = __fdiv_rn(dots, __fmul_rn(qn, vn));
    return __fdiv_rn(__fadd_rn(1.0f, c), 2.0f);
  }
  return dots >= 0.0f ? __fadd_rn(dots, 1.0f)
                      : __fdiv_rn(1.0f, __fsub_rn(1.0f, dots));
}

}  // namespace
