// svm_smo for Hopper: the SMO solver of the classification tool's SVM.
//
// Replaces no TPU kernel: the JAX package trains scikit-learn's
// SVC(kernel="rbf", gamma="scale") on the host (tmlibrary_tpu/tools/
// classification.py, method `svm`), whose libsvm solves one C-SVC dual a
// pair of classes.  The port solves those duals here, all at once, on
// the Gram matrix its caller computed on the card
// (tmlibrary_tpu_torch/tools/svm.py).
//
// Same iteration as libsvm's Solver::Solve without shrinking, step for
// step as `svm_smo_plain`: alpha = 0 and gradient G = -1; each step picks
// i = the largest -y_t G_t over I_up (y = +1 below C, y = -1 above 0) and
// j over I_low by the second-order rule (WSS3, Fan, Chen & Lin 2005):
// least -(g_i + g_j)^2 / (QD_i + QD_j - 2 K_ij) among grad_diff > 0,
// TAU = 1e-12 where the curvature is not positive; ties go to the larger
// index, as libsvm's `>=`/`<=` scan leaves them; stop when
// Gmax + Gmax2 < eps (the KKT gap, sklearn's `tol`) or no j is left;
// libsvm's clipped two-variable update of alpha_i, alpha_j; then
// G_t += Q_it dA_i + Q_jt dA_j with Q_it = y_i y_t K_it.  rho is libsvm's
// calculate_rho: the mean of y_t G_t over free alphas, summed by one
// thread in index order, or the middle of the bounds when none is free.
// Every product that meets a sum is written with the _rn intrinsics
// (__dmul_rn, __dadd_rn, __dsub_rn), which the compiler does not contract
// into a fused multiply-add, so each rounds on its own, as on the CPU, and
// alpha and rho are bit-equal to the plain version's on the same Gram
// matrix.
//
// Design: one block a sub-problem (a pair of classes), all sub-problems
// in one launch; each block keeps its alpha and G (float64) in global
// scratch, reads its rows of K through its index table, and iterates on
// the card until it stops: block-wide arg-max and arg-min reductions
// (warp shuffles, then one warp over the warps' results), the update by
// thread 0, the gradient by all threads, with no host sync a step.
//
// Bound: each step reads two rows of the sub-problem's Gram entries
// (8 * l bytes each) and alpha, G and y, and writes G: about 40 * l
// bytes a step, from L2 at the tool's sizes (l = 400: 1.3 MB of K).  The
// steps are sequential and each waits on three block reductions, so the
// latency of a step, not bytes, bounds a launch.
#include "common.cuh"

#define SMO_BLOCK 256
#define SMO_WARPS (SMO_BLOCK / 32)
#define SMO_TAU 1e-12

struct SmoBest {
    double v;
    int i;
};

// (a better than b): larger v (want_max) or smaller v, ties to the larger index
__device__ __forceinline__ bool smo_better(double av, int ai, double bv, int bi, bool want_max) {
    if (av != bv) return want_max ? av > bv : av < bv;
    return ai > bi;
}

// Block-wide best of (v, i) over all threads, returned to every thread.
__device__ SmoBest smo_reduce(double v, int i, bool want_max, SmoBest* scratch) {
    for (int off = 16; off > 0; off >>= 1) {
        const double ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (smo_better(ov, oi, v, i, want_max)) {
            v = ov;
            i = oi;
        }
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) scratch[warp] = SmoBest{v, i};
    __syncthreads();
    if (warp == 0) {
        SmoBest b = lane < SMO_WARPS ? scratch[lane] : SmoBest{want_max ? -INFINITY : INFINITY, -1};
        for (int off = 16; off > 0; off >>= 1) {
            const double ov = __shfl_down_sync(0xffffffffu, b.v, off);
            const int oi = __shfl_down_sync(0xffffffffu, b.i, off);
            if (smo_better(ov, oi, b.v, b.i, want_max)) {
                b.v = ov;
                b.i = oi;
            }
        }
        if (lane == 0) scratch[SMO_WARPS] = b;
    }
    __syncthreads();
    const SmoBest out = scratch[SMO_WARPS];
    __syncthreads();  // scratch is reused by the next reduction
    return out;
}

__global__ void __launch_bounds__(SMO_BLOCK)
smo_kernel(const double* __restrict__ K, int n, const int* __restrict__ rows,
           const int* __restrict__ ys, const int* __restrict__ offsets, double Cb, double eps,
           long long max_iter, double* __restrict__ alpha_all, double* __restrict__ grad_all,
           double* __restrict__ rho_out, long long* __restrict__ iters_out) {
    __shared__ SmoBest scratch[SMO_WARPS + 1];
    __shared__ double s_delta[2];
    const int p = blockIdx.x, tid = threadIdx.x;
    const int o = offsets[p], l = offsets[p + 1] - o;
    const int* r = rows + o;
    const int* y = ys + o;
    double* a = alpha_all + o;
    double* G = grad_all + o;
    for (int t = tid; t < l; t += SMO_BLOCK) {
        a[t] = 0.0;
        G[t] = -1.0;
    }
    __syncthreads();
    long long iter = 0;
    while (iter < max_iter) {
        // i: the largest -y_t G_t over I_up
        double v = -INFINITY;
        int vi = -1;
        for (int t = tid; t < l; t += SMO_BLOCK) {
            const bool up = y[t] == 1 ? a[t] < Cb : a[t] > 0.0;
            if (up) {
                const double g = y[t] == 1 ? -G[t] : G[t];
                if (g >= v) {
                    v = g;
                    vi = t;
                }
            }
        }
        const SmoBest bi = smo_reduce(v, vi, true, scratch);
        const double gmax = bi.v;
        const int i = bi.i;
        // j: WSS3 over I_low, and Gmax2
        double gmax2 = -INFINITY, omin = INFINITY;
        int oj = -1;
        if (i != -1) {
            const double* Ki = K + (size_t)r[i] * n;
            const double qdi = Ki[r[i]];
            for (int t = tid; t < l; t += SMO_BLOCK) {
                const bool low = y[t] == 1 ? a[t] > 0.0 : a[t] < Cb;
                if (!low) continue;
                const double g2 = y[t] == 1 ? G[t] : -G[t];
                if (g2 >= gmax2) gmax2 = g2;
                const double gd = gmax + g2;
                if (gd > 0.0) {
                    const double quad = __dsub_rn(__dadd_rn(qdi, K[(size_t)r[t] * n + r[t]]),
                                                  __dmul_rn(2.0, Ki[r[t]]));
                    const double obj = quad > 0.0 ? -(gd * gd) / quad : -(gd * gd) / SMO_TAU;
                    if (obj <= omin) {
                        omin = obj;
                        oj = t;
                    }
                }
            }
        }
        gmax2 = smo_reduce(gmax2, 0, true, scratch).v;
        const int j = smo_reduce(omin, oj, false, scratch).i;
        if (gmax + gmax2 < eps || j == -1) break;
        ++iter;
        if (tid == 0) {
            const double kij = K[(size_t)r[i] * n + r[j]];
            const double qij = (double)(y[i] * y[j]) * kij;
            const double qdi = K[(size_t)r[i] * n + r[i]], qdj = K[(size_t)r[j] * n + r[j]];
            const double old_i = a[i], old_j = a[j];
            double ai = old_i, aj = old_j;
            if (y[i] != y[j]) {
                double quad = __dadd_rn(__dadd_rn(qdi, qdj), __dmul_rn(2.0, qij));
                if (quad <= 0.0) quad = SMO_TAU;
                const double delta = (-G[i] - G[j]) / quad;
                const double diff = ai - aj;
                ai += delta;
                aj += delta;
                if (diff > 0.0) {
                    if (aj < 0.0) { aj = 0.0; ai = diff; }
                } else {
                    if (ai < 0.0) { ai = 0.0; aj = -diff; }
                }
                if (diff > Cb - Cb) {
                    if (ai > Cb) { ai = Cb; aj = Cb - diff; }
                } else {
                    if (aj > Cb) { aj = Cb; ai = Cb + diff; }
                }
            } else {
                double quad = __dsub_rn(__dadd_rn(qdi, qdj), __dmul_rn(2.0, qij));
                if (quad <= 0.0) quad = SMO_TAU;
                const double delta = (G[i] - G[j]) / quad;
                const double sum = ai + aj;
                ai -= delta;
                aj += delta;
                if (sum > Cb) {
                    if (ai > Cb) { ai = Cb; aj = sum - Cb; }
                } else {
                    if (aj < 0.0) { aj = 0.0; ai = sum; }
                }
                if (sum > Cb) {
                    if (aj > Cb) { aj = Cb; ai = sum - Cb; }
                } else {
                    if (ai < 0.0) { ai = 0.0; aj = sum; }
                }
            }
            a[i] = ai;
            a[j] = aj;
            s_delta[0] = ai - old_i;
            s_delta[1] = aj - old_j;
        }
        __syncthreads();
        const double dai = s_delta[0], daj = s_delta[1];
        const double* Ki = K + (size_t)r[i] * n;
        const double* Kj = K + (size_t)r[j] * n;
        const double yi = (double)y[i], yj = (double)y[j];
        for (int t = tid; t < l; t += SMO_BLOCK) {
            const double yt = (double)y[t];
            const double qit = __dmul_rn(__dmul_rn(yi, yt), Ki[r[t]]);
            const double qjt = __dmul_rn(__dmul_rn(yj, yt), Kj[r[t]]);
            G[t] = __dadd_rn(G[t], __dadd_rn(__dmul_rn(qit, dai), __dmul_rn(qjt, daj)));
        }
        __syncthreads();
    }
    if (tid == 0) {
        double ub = INFINITY, lb = -INFINITY, sum_free = 0.0;
        int nr_free = 0;
        for (int t = 0; t < l; ++t) {
            const double yg = __dmul_rn((double)y[t], G[t]);
            if (a[t] >= Cb) {
                if (y[t] == -1) ub = ub < yg ? ub : yg;
                else lb = lb > yg ? lb : yg;
            } else if (a[t] <= 0.0) {
                if (y[t] == 1) ub = ub < yg ? ub : yg;
                else lb = lb > yg ? lb : yg;
            } else {
                ++nr_free;
                sum_free += yg;
            }
        }
        rho_out[p] = nr_free > 0 ? sum_free / nr_free : (ub + lb) / 2;
        iters_out[p] = iter;
    }
}

extern "C" int tm_svm_smo(const void* K, const void* rows, const void* ys, const void* offsets,
                          void* grad, void* rho, void* iters, void* alpha, int n, int P,
                          double C, double eps, long long max_iter, void* stream) {
    if (P <= 0) return (int)cudaGetLastError();
    smo_kernel<<<P, SMO_BLOCK, 0, (cudaStream_t)stream>>>(
        (const double*)K, n, (const int*)rows, (const int*)ys, (const int*)offsets, C, eps,
        max_iter, (double*)alpha, (double*)grad, (double*)rho, (long long*)iters);
    return (int)cudaGetLastError();
}
