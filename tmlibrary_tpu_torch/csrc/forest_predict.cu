// forest_predict for Hopper: the classification tool's random forest
// over every object of a store.
//
// Replaces no TPU kernel: the JAX package predicts with scikit-learn's
// RandomForestClassifier on the host (tmlibrary_tpu/tools/classification.py,
// method `randomforest`), which the port reproduces tree for tree
// (tmlibrary_tpu_torch/tools/forest.py).  Prediction is the part that
// grows with the store, so it runs here, on the tool's device.
//
// Same function as the reference's predict_proba / predict: object i
// walks each tree from its root, going left when x[i, f] <= threshold
// (the float32 feature promoted to double, as sklearn compares it) and,
// for a NaN feature, where the node's `missing_left` says; the leaf's
// class fractions (float64) are added to the object's sums in tree
// order, each sum divided by the tree count, and the first largest
// class wins (np.argmax).  Every step is the reference's IEEE operation
// in the reference's order, so classes and probabilities are bit-equal
// to `forest_predict_plain`.
//
// Design: one thread an object, 256 a block, the class sums in
// registers (at most FP_MAX_CLASSES; the wrapper refuses more).  The
// flattened nodes (feature int32, threshold float64, children int32,
// missing_left uint8, value float64 x classes) are read from global
// memory; a forest of 100 trees grown on 600 examples is a few MB and
// stays in the 50 MB L2, and the threads of a warp walk the same tree at
// once, so the nodes near the roots are shared.
//
// Bound: each object's row of x (4 * F bytes) read once and its class
// (8 bytes) and, when asked, its probabilities (8 * C bytes) written
// once, plus the nodes read once: bytes over the HBM rate.  The walk
// itself is a chain of dependent loads (node -> feature -> x -> child),
// latency that only many objects in flight hide.
#include "common.cuh"

#define FP_BLOCK 256
#define FP_MAX_CLASSES 32

__global__ void __launch_bounds__(FP_BLOCK)
fp_kernel(const float* __restrict__ x, const int* __restrict__ feature,
          const double* __restrict__ threshold, const int* __restrict__ left,
          const int* __restrict__ right, const uint8_t* __restrict__ missing_left,
          const double* __restrict__ value, const int* __restrict__ roots,
          double* __restrict__ proba, long long* __restrict__ pred, int N, int F, int C, int T,
          int write_proba) {
    const long long i = (long long)blockIdx.x * FP_BLOCK + threadIdx.x;
    if (i >= N) return;
    const float* xi = x + i * F;
    double acc[FP_MAX_CLASSES];
#pragma unroll
    for (int c = 0; c < FP_MAX_CLASSES; ++c) acc[c] = 0.0;
    for (int t = 0; t < T; ++t) {
        int n = roots[t];
        int l = left[n];
        while (l != -1) {
            const float v = xi[feature[n]];
            const bool go = (v != v) ? missing_left[n] != 0 : (double)v <= threshold[n];
            n = go ? l : right[n];
            l = left[n];
        }
        const double* leaf = value + (size_t)n * C;
#pragma unroll
        for (int c = 0; c < FP_MAX_CLASSES; ++c)
            if (c < C) acc[c] += leaf[c];
    }
    int best = 0;
    double top = 0.0;
#pragma unroll
    for (int c = 0; c < FP_MAX_CLASSES; ++c) {
        if (c >= C) break;
        const double p = acc[c] / (double)T;
        if (write_proba) proba[i * C + c] = p;
        if (c == 0 || p > top) {
            top = p;
            best = c;
        }
    }
    pred[i] = best;
}

extern "C" int tm_forest_predict(const void* x, const void* feature, const void* threshold,
                                 const void* left, const void* right, const void* missing_left,
                                 const void* value, const void* roots, void* proba, void* pred,
                                 int N, int F, int C, int T, int write_proba, void* stream) {
    if (N <= 0) return (int)cudaGetLastError();
    if (C < 1 || C > FP_MAX_CLASSES || T < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (N + FP_BLOCK - 1) / FP_BLOCK;
    fp_kernel<<<blocks, FP_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int*)feature, (const double*)threshold, (const int*)left,
        (const int*)right, (const uint8_t*)missing_left, (const double*)value, (const int*)roots,
        (double*)proba, (long long*)pred, N, F, C, T, write_proba);
    return (int)cudaGetLastError();
}
