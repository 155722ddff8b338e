// The surface-area filter of the match cascade, for Hopper (sm_90a): each
// image pair's two PCA-plane oriented-bounding-box areas in one warp, all
// pairs in one launch.
//
// Replaces `surface_area_filter_pair` under `vmap` of
// bundlefusion_tpu/ops/filters.py:234-280 (XLA inside the jitted
// `match_and_filter`, no Pallas). Its plain version is
// `surface_area_filter_ref` (bundlefusion_tpu_torch/ops/filters.py): batched
// torch ops with four `torch.linalg.eigh` calls, each of which makes the host
// wait for the card, so the per-frame span could not be captured in a CUDA
// graph while it ran there.
//
// What it computes, per pair and per image (source, then target), in the
// plain version's order:
//   - weights w = the inlier mask, 0 where a point is not finite; such points
//     count as the origin;
//   - wsum = max(sum w, 1e-12), the weighted mean mu and the weighted 3x3
//     covariance of the points about it (divided by wsum);
//   - its eigendecomposition, eigenvalues ascending: the smallest vector is
//     the plane's normal n, the largest e0 and the middle e1 span the plane;
//   - each point's offset from mu, its normal part removed, in plane
//     coordinates q = (s . e0, s . e1);
//   - the weighted mean and 2x2 covariance of q and its eigendecomposition,
//     eigenvalues ascending; the extents of q along both vectors over the
//     points with w > 0; the area is their product if both exceed 1e-5,
//     else 0;
//   - keep = !(a0 < t && a1 < t) && (any inlier).
// Eigenvectors are defined up to sign, and up to a rotation where two
// eigenvalues are equal; the area does not depend on the sign, and where it
// would depend on the rotation (two equal eigenvalues of either matrix) the
// reference is ill-posed itself. The symmetric eigenproblems are solved by
// cyclic Jacobi rotations in registers (the 2x2 one in one rotation), which
// give orthonormal vectors to float32 rounding also for close eigenvalues.
// Every product, sum, division and square root is rounded as IEEE float32
// (built with --fmad=false, -prec-div=true, -prec-sqrt=true); sums are taken
// in another order than the plain version's reductions and LAPACK / cuSOLVER
// solve the eigenproblems another way, so the two agree to rounding, not bit
// for bit.
//
// What bounds it. Neither bytes nor operations: per pair it reads 25 bytes
// and does about 250 operations per match, and two 3x3 and two 2x2
// eigen-solves of a few hundred operations each; at the main path's shapes
// (10 pairs of 128 matches a frame, up to 640 at a global match) that is
// well under a microsecond of either. The time is the launch and each warp's
// dependent chain: five passes over the matches per image, each ending in a
// 5-level shuffle butterfly, and the Jacobi sweeps between them. The design
// keeps that chain in one warp with no shared memory and no CTA barrier:
// lane l takes matches l, l + 32, ..., every sum is a per-lane partial in
// match order followed by a fixed xor butterfly of __shfl_xor_sync (x + y ==
// y + x, so every lane holds the same bits and control flow stays uniform
// in the warp), and every lane solves the small eigenproblems on those same
// bits, so no result has to be broadcast.

#include <cuda_runtime.h>
#include <stdint.h>

#define SA_WARPS 4      // pairs (warps) per CTA
#define SA_MAX_R 1024   // matches per pair
#define SA_SWEEPS 32    // cap on Jacobi sweeps (3x3 converges in a handful)
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

// Eigendecomposition of the symmetric N x N matrix A (destroyed) by cyclic
// Jacobi rotations: on return the eigenvalues ascend in w and V's column k is
// the unit vector of w[k]. Each rotation zeroes A[p][q] (the tangent of the
// angle from cot 2phi = (a_qq - a_pp) / (2 a_pq), the smaller root); a pair
// whose off-diagonal entry no longer changes either diagonal entry is set to
// zero and skipped.
template <int N>
__device__ __forceinline__ void sym_eig(float (&A)[N][N], float (&V)[N][N], float (&w)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) V[i][j] = i == j ? 1.0f : 0.0f;
    for (int sweep = 0; sweep < SA_SWEEPS; ++sweep) {
        bool rotated = false;
#pragma unroll
        for (int p = 0; p < N - 1; ++p) {
#pragma unroll
            for (int q = p + 1; q < N; ++q) {
                const float apq = A[p][q];
                const float g = 100.0f * fabsf(apq);
                if (apq == 0.0f) continue;
                if (fabsf(A[p][p]) + g == fabsf(A[p][p]) && fabsf(A[q][q]) + g == fabsf(A[q][q])) {
                    A[p][q] = A[q][p] = 0.0f;
                    continue;
                }
                const float theta = (A[q][q] - A[p][p]) / (2.0f * apq);
                // |theta| beyond 1e18 squares to infinity: the angle is 0 there
                float t = 1.0f / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
                if (theta < 0.0f) t = -t;
                const float c = 1.0f / sqrtf(t * t + 1.0f);
                const float s = t * c;
#pragma unroll
                for (int k = 0; k < N; ++k) {   // A <- A J (columns p, q)
                    const float akp = A[k][p], akq = A[k][q];
                    A[k][p] = c * akp - s * akq;
                    A[k][q] = s * akp + c * akq;
                }
#pragma unroll
                for (int k = 0; k < N; ++k) {   // A <- J^T A (rows p, q)
                    const float apk = A[p][k], aqk = A[q][k];
                    A[p][k] = c * apk - s * aqk;
                    A[q][k] = s * apk + c * aqk;
                }
                A[p][q] = A[q][p] = 0.0f;
#pragma unroll
                for (int k = 0; k < N; ++k) {   // V <- V J
                    const float vkp = V[k][p], vkq = V[k][q];
                    V[k][p] = c * vkp - s * vkq;
                    V[k][q] = s * vkp + c * vkq;
                }
                rotated = true;
            }
        }
        if (!rotated) break;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = A[i][i];
    // ascending, by exchanges (N <= 3); equal eigenvalues keep their order
#pragma unroll
    for (int i = 0; i < N - 1; ++i) {
#pragma unroll
        for (int j = 0; j < N - 1 - i; ++j) {
            if (w[j + 1] < w[j]) {
                const float tw = w[j];
                w[j] = w[j + 1];
                w[j + 1] = tw;
#pragma unroll
                for (int k = 0; k < N; ++k) {
                    const float tv = V[k][j];
                    V[k][j] = V[k][j + 1];
                    V[k][j + 1] = tv;
                }
            }
        }
    }
}

// One match of one image: its weight (the mask, 0 where the point is not
// finite) and the point (the origin where the weight is 0).
__device__ __forceinline__ float load_point(const float* __restrict__ pts,
                                            const uint8_t* __restrict__ mask, int r,
                                            float& x, float& y, float& z) {
    x = pts[3 * r];
    y = pts[3 * r + 1];
    z = pts[3 * r + 2];
    const bool finite = isfinite(x) && isfinite(y) && isfinite(z);
    const float w = (mask[r] && finite) ? 1.0f : 0.0f;
    if (!(w > 0.0f)) x = y = z = 0.0f;
    return w;
}

// The PCA-plane OBB area of one image's matches (``_surface_area_one``).
__device__ float plane_obb_area(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                                int R, int lane) {
    float x, y, z;
    // pass 1: weight and first moments
    float sw = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
    for (int r = lane; r < R; r += 32) {
        const float w = load_point(pts, mask, r, x, y, z);
        sw += w;
        sx += x * w;
        sy += y * w;
        sz += z * w;
    }
    const float wsum = fmaxf(warp_sum(sw), 1e-12f);
    const float mx = warp_sum(sx) / wsum, my = warp_sum(sy) / wsum, mz = warp_sum(sz) / wsum;

    // pass 2: the covariance about the mean
    float c00 = 0.0f, c01 = 0.0f, c02 = 0.0f, c11 = 0.0f, c12 = 0.0f, c22 = 0.0f;
    for (int r = lane; r < R; r += 32) {
        const float w = load_point(pts, mask, r, x, y, z);
        const float dx = x - mx, dy = y - my, dz = z - mz;
        const float wx = dx * w, wy = dy * w, wz = dz * w;
        c00 += wx * dx;
        c01 += wx * dy;
        c02 += wx * dz;
        c11 += wy * dy;
        c12 += wy * dz;
        c22 += wz * dz;
    }
    float A[3][3], V[3][3], ev[3];
    A[0][0] = warp_sum(c00) / wsum;
    A[0][1] = A[1][0] = warp_sum(c01) / wsum;
    A[0][2] = A[2][0] = warp_sum(c02) / wsum;
    A[1][1] = warp_sum(c11) / wsum;
    A[1][2] = A[2][1] = warp_sum(c12) / wsum;
    A[2][2] = warp_sum(c22) / wsum;
    sym_eig<3>(A, V, ev);
    // columns: 0 the normal (smallest), 2 the dominant, 1 the middle
    const float n0 = V[0][0], n1 = V[1][0], n2 = V[2][0];
    const float e00 = V[0][2], e01 = V[1][2], e02 = V[2][2];
    const float e10 = V[0][1], e11 = V[1][1], e12 = V[2][1];

    // pass 3: plane coordinates and their weighted mean
    float su = 0.0f, sv = 0.0f;
    for (int r = lane; r < R; r += 32) {
        const float w = load_point(pts, mask, r, x, y, z);
        const float dx = x - mx, dy = y - my, dz = z - mz;
        const float d = dx * n0 + dy * n1 + dz * n2;
        const float s0 = dx - d * n0, s1 = dy - d * n1, s2 = dz - d * n2;
        const float u = s0 * e00 + s1 * e01 + s2 * e02;
        const float v = s0 * e10 + s1 * e11 + s2 * e12;
        su += u * w;
        sv += v * w;
    }
    const float mu_u = warp_sum(su) / wsum, mu_v = warp_sum(sv) / wsum;

    // pass 4: their 2x2 covariance
    float b00 = 0.0f, b01 = 0.0f, b11 = 0.0f;
    for (int r = lane; r < R; r += 32) {
        const float w = load_point(pts, mask, r, x, y, z);
        const float dx = x - mx, dy = y - my, dz = z - mz;
        const float d = dx * n0 + dy * n1 + dz * n2;
        const float s0 = dx - d * n0, s1 = dy - d * n1, s2 = dz - d * n2;
        const float du = (s0 * e00 + s1 * e01 + s2 * e02) - mu_u;
        const float dv = (s0 * e10 + s1 * e11 + s2 * e12) - mu_v;
        const float wu = du * w, wv = dv * w;
        b00 += wu * du;
        b01 += wu * dv;
        b11 += wv * dv;
    }
    float B[2][2], U[2][2], bw[2];
    B[0][0] = warp_sum(b00) / wsum;
    B[0][1] = B[1][0] = warp_sum(b01) / wsum;
    B[1][1] = warp_sum(b11) / wsum;
    sym_eig<2>(B, U, bw);

    // pass 5: extents along both box axes over the points with w > 0
    float lo0 = 1e18f, hi0 = -1e18f, lo1 = 1e18f, hi1 = -1e18f;
    for (int r = lane; r < R; r += 32) {
        const float w = load_point(pts, mask, r, x, y, z);
        if (!(w > 0.0f)) continue;
        const float dx = x - mx, dy = y - my, dz = z - mz;
        const float d = dx * n0 + dy * n1 + dz * n2;
        const float s0 = dx - d * n0, s1 = dy - d * n1, s2 = dz - d * n2;
        const float u = s0 * e00 + s1 * e01 + s2 * e02;
        const float v = s0 * e10 + s1 * e11 + s2 * e12;
        const float p0 = u * U[0][0] + v * U[1][0];
        const float p1 = u * U[0][1] + v * U[1][1];
        lo0 = fminf(lo0, p0);
        hi0 = fmaxf(hi0, p0);
        lo1 = fminf(lo1, p1);
        hi1 = fmaxf(hi1, p1);
    }
    const float ext0 = warp_max(hi0) - warp_min(lo0);
    const float ext1 = warp_max(hi1) - warp_min(lo1);
    return (ext0 > 1e-5f && ext1 > 1e-5f) ? ext0 * ext1 : 0.0f;
}

__global__ void __launch_bounds__(32 * SA_WARPS)
surface_area_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                    const uint8_t* __restrict__ mask, uint8_t* __restrict__ keep_out,
                    float* __restrict__ a0_out, float* __restrict__ a1_out, int P, int R,
                    float thresh) {
    const int p = blockIdx.x * SA_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (p >= P) return;   // a whole warp leaves together
    const size_t base = (size_t)p * R;
    const uint8_t* m = mask + base;
    const float a0 = plane_obb_area(src + 3 * base, m, R, lane);
    const float a1 = plane_obb_area(tgt + 3 * base, m, R, lane);
    bool any = false;
    for (int r = lane; r < R; r += 32) any = any || m[r] != 0;
    any = __any_sync(FULL_MASK, any);
    if (lane == 0) {
        a0_out[p] = a0;
        a1_out[p] = a1;
        keep_out[p] = (!(a0 < thresh && a1 < thresh) && any) ? 1 : 0;
    }
}

extern "C" int bf_surface_area(const float* src, const float* tgt, const uint8_t* mask,
                               uint8_t* keep, float* a0, float* a1, int P, int R,
                               float thresh, void* stream) {
    if (P <= 0 || R < 0 || R > SA_MAX_R) return (int)cudaErrorInvalidValue;
    const int blocks = (P + SA_WARPS - 1) / SA_WARPS;
    surface_area_kernel<<<blocks, 32 * SA_WARPS, 0, (cudaStream_t)stream>>>(
        src, tgt, mask, keep, a0, a1, P, R, thresh);
    return (int)cudaGetLastError();
}
