// The greedy Kabsch filter of the match cascade, for Hopper (sm_90a): the
// whole candidate scan of an image pair in one CTA, all pairs in one launch.
//
// Replaces `kabsch_filter_pair` under `vmap` of
// bundlefusion_tpu/ops/filters.py:80-226: two nested `lax.while_loop`s (the
// candidate scan and the strip loop) that XLA runs on the device inside the
// jitted `match_and_filter`. Its plain version is `kabsch_filter_ref`
// (bundlefusion_tpu_torch/ops/filters.py), which runs the loops on the host:
// one device -> host read per candidate step and strip round, and dozens of
// small torch ops per fit.
//
// The rule, per pair, over the candidates i = 0..R-1 in descriptor order
// (`valid` is a contiguous prefix):
//   - the scan ends at the first invalid entry or when count == max_filtered;
//   - a candidate within 5 px (<=) of a current inlier, in either image, is
//     skipped;
//   - otherwise it is added; with fewer than 3 inliers it is accepted without
//     a fit. From 3 on, the set is fitted (`geo`: weighted centroids over the
//     finite points, the cross-covariance H, Horn's rotation by squaring the
//     shifted 4x4 N matrix 7 times, t, the largest squared residual over the
//     mask from the raw points, and the three condition numbers of H^T H and
//     of either point set's covariance, each against 100). While that
//     residual exceeds max_res2 and more than 3 inliers are left, the worst
//     inlier (the first index on a tie; NaN above every number, as torch.max
//     and torch.argmax have it) is stripped and the set refitted; stripping
//     down to 3 that is still bad, or that kills a fit the add had made
//     valid, restores the post-add transform and stops.
//   - valid_pair = count >= min_num_matches && maxres < max_res2 && validT;
//     the mask and count of an invalid pair are zeroed.
// The arithmetic follows the plain version's order with every product and
// sum rounded (built with --fmad=false); the plain version's tiny products
// go through cuBLAS, so the two agree to rounding, not bit for bit.
//
// Layout. One CTA per pair, one thread per raw match (R <= 1024, padded to a
// whole warp). A thread keeps its match's points and its mask bits in
// registers; the pixels sit in shared memory, where every thread reads the
// candidate's. Every sum and maximum over the matches is a block reduction
// of fixed shape (a butterfly of shuffles in each warp, then the warps'
// partials in order), so two runs are equal bit for bit. Every thread then
// does the same 4x4 algebra on the same sums, so control flow stays uniform
// across the CTA without another broadcast. Nothing is read back: the host
// enqueues one launch and the outputs stay on the card.
//
// What bounds it. Neither bytes nor operations: per pair it reads 44 bytes
// and writes 1 byte per match, and a fit is ~2 000 operations; at the main
// path's shapes that is microseconds of either. The time is the serial chain
// of each pair's scan: up to R candidate steps, each one fit (four block
// reductions and the 4x4 power iteration, all dependent) plus one per strip
// round. Pairs run side by side on separate SMs, so the launch takes about
// as long as its longest pair.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KF_MAX_R 1024
#define KF_MAX_WARPS (KF_MAX_R / 32)
#define KF_RED 21        // the widest reduction: H (9) and two covariances (6 + 6)
#define FULL_MASK 0xffffffffu
#define PIXEL_DIST_THRESH 5.0f     // MATCH_FILTER_PIXEL_DIST_THRESH
#define CONDITION_THRESH 100.0f    // KABSCH_CONDITION_THRESH
#define TWO_THIRDS_PI 2.0943951023931953f

struct Fit {
    float R[9];
    float t[3];
    float maxres;   // largest squared residual over the mask (NaN propagates)
    int worst;      // its first index
    bool ok;        // the three condition numbers under 100
};

// one thread's match
struct Match {
    float s[3], d[3];     // raw points: the residuals use them
    float s0[3], d0[3];   // non-finite points as 0: the sums use them
    float fs, fd, fb;     // finite src / tgt / both, as 0 or 1
};

// block reductions: two buffers used in turns, so one barrier per round
// suffices (a buffer is written again only after a later round's barrier,
// which every thread reaches after reading it)
struct Red {
    float* buf;
    int nwarps;
    int flip;
    __device__ float* next() {
        float* b = buf + flip * (KF_MAX_WARPS * KF_RED);
        flip ^= 1;
        return b;
    }
};

template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], Red& red) {
    float* buf = red.next();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float x = v[k];
        // x + y == y + x: every lane of the butterfly ends with the same sum
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) x = __fadd_rn(x, __shfl_xor_sync(FULL_MASK, x, s));
        v[k] = x;
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) buf[warp * KF_RED + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float acc = buf[k];
        for (int w = 1; w < red.nwarps; ++w) acc = __fadd_rn(acc, buf[w * KF_RED + k]);
        v[k] = acc;
    }
}

// a total order: NaN above every number, then the larger value, then the
// lower index (torch.max / torch.argmax)
__device__ __forceinline__ bool ranks_above(float va, int ia, float vb, int ib) {
    const bool na = va != va, nb = vb != vb;
    if (na || nb) return na && (!nb || ia < ib);
    return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void block_argmax(float& v, int& idx, Red& red) {
    float* buf = red.next();
    int* ibuf = (int*)(buf + KF_MAX_WARPS);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const float vo = __shfl_xor_sync(FULL_MASK, v, s);
        const int io = __shfl_xor_sync(FULL_MASK, idx, s);
        if (ranks_above(vo, io, v, idx)) {
            v = vo;
            idx = io;
        }
    }
    if (lane == 0) {
        buf[warp] = v;
        ibuf[warp] = idx;
    }
    __syncthreads();
    v = buf[0];
    idx = ibuf[0];
    for (int w = 1; w < red.nwarps; ++w) {
        if (ranks_above(buf[w], ibuf[w], v, idx)) {
            v = buf[w];
            idx = ibuf[w];
        }
    }
}

// torch.clamp(x, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float frob16(const float* M) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) s = __fadd_rn(s, __fmul_rn(M[k], M[k]));
    return sqrtf(s);
}

// analytic eigenvalues of a symmetric 3x3 matrix, ascending (`sym3_eigenvalues`)
__device__ void sym3_eigenvalues(float a00, float a11, float a22, float a01, float a02,
                                 float a12, float* e) {
    const float q = (a00 + a11 + a22) / 3.0f;
    const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
    const float p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0f
                     + (a01 * a01 + a02 * a02 + a12 * a12) / 3.0f;
    const float p = sqrtf(clamp_min(p2, 1e-30f));
    const float detB = b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
                       + a02 * (a01 * a12 - b11 * a02);
    float r = detB / (2.0f * p * p * p);
    r = r < -1.0f ? -1.0f : (r > 1.0f ? 1.0f : r);
    const float phi = acosf(r) / 3.0f;
    e[2] = q + 2.0f * p * cosf(phi);
    e[0] = q + 2.0f * p * cosf(phi + TWO_THIRDS_PI);
    e[1] = 3.0f * q - e[0] - e[2];
}

// Horn's rotation from the cross-covariance H (`_horn_rotation`): the top
// eigenvector of the shifted N matrix, by squaring it 7 times
__device__ void horn_rotation(const float* H, float* R) {
    const float Sxx = H[0], Sxy = H[1], Sxz = H[2];
    const float Syx = H[3], Syy = H[4], Syz = H[5];
    const float Szx = H[6], Szy = H[7], Szz = H[8];
    float M[16] = {
        Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
        Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
        Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
        Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz,
    };
    const float shift = frob16(M) + 1e-12f;
#pragma unroll
    for (int k = 0; k < 4; ++k) M[5 * k] = M[5 * k] + shift;
    float f = frob16(M);
#pragma unroll
    for (int k = 0; k < 16; ++k) M[k] = M[k] / f;
#pragma unroll 1
    for (int it = 0; it < 7; ++it) {
        float P[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float acc = __fmul_rn(M[4 * i], M[j]);
#pragma unroll
                for (int k = 1; k < 4; ++k) acc = __fadd_rn(acc, __fmul_rn(M[4 * i + k], M[4 * k + j]));
                P[4 * i + j] = acc;
            }
        }
        f = clamp_min(frob16(P), 1e-30f);
#pragma unroll
        for (int k = 0; k < 16; ++k) M[k] = P[k] / f;
    }
    // every column of the limit is proportional to the top eigenvector
    int col = 0;
    float best = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        float n2 = 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) n2 = __fadd_rn(n2, __fmul_rn(M[4 * r + c], M[4 * r + c]));
        if (c == 0 || ranks_above(n2, c, best, col)) {
            best = n2;
            col = c;
        }
    }
    float q[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) q[r] = M[4 * r + col];
    const float nq = clamp_min(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]),
                               1e-20f);
#pragma unroll
    for (int r = 0; r < 4; ++r) q[r] = q[r] / nq;
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    R[0] = 1.0f + 2.0f * (-(qy * qy + qz * qz));
    R[1] = 2.0f * (qx * qy - qz * qw);
    R[2] = 2.0f * (qx * qz + qy * qw);
    R[3] = 2.0f * (qx * qy + qz * qw);
    R[4] = 1.0f + 2.0f * (-(qx * qx + qz * qz));
    R[5] = 2.0f * (qy * qz - qx * qw);
    R[6] = 2.0f * (qx * qz - qy * qw);
    R[7] = 2.0f * (qy * qz + qx * qw);
    R[8] = 1.0f + 2.0f * (-(qx * qx + qy * qy));
}

// |largest / second| of a symmetric 3x3 matrix's eigenvalues (coplanar is fine)
__device__ __forceinline__ float cov_condition(const float* c) {
    float e[3];
    sym3_eigenvalues(c[0], c[1], c[2], c[3], c[4], c[5], e);
    return fabsf(e[2] / (fabsf(e[1]) > 1e-12f ? e[1] : 1e-12f));
}

// fit + stats of the masked consensus (`geo` of the plain version); every
// thread of the CTA calls it with its own mask bit and gets the same fit
__device__ void geo(bool m, const Match& x, int r, Red& red, Fit& f) {
    const float mf = m ? 1.0f : 0.0f;
    const float w = mf * x.fb, ws = mf * x.fs, wt = mf * x.fd;
    // weight sums and the covariances' weighted sums
    float a[9] = {w, ws, wt,
                  x.s0[0] * ws, x.s0[1] * ws, x.s0[2] * ws,
                  x.d0[0] * wt, x.d0[1] * wt, x.d0[2] * wt};
    block_sum(a, red);
    const float wn = w / (a[0] + 1e-12f);
    const float cws = clamp_min(a[1], 1e-12f), cwt = clamp_min(a[2], 1e-12f);
    // the fit's centroids
    float b[6] = {x.s0[0] * wn, x.s0[1] * wn, x.s0[2] * wn,
                  x.d0[0] * wn, x.d0[1] * wn, x.d0[2] * wn};
    block_sum(b, red);
    // H, and the upper triangles of both covariances (00 11 22 01 02 12)
    float c[KF_RED];
    float sc[3], dc[3], cs[3], ct[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        sc[k] = (x.s0[k] - b[k]) * wn;
        dc[k] = x.d0[k] - b[3 + k];
        cs[k] = x.s0[k] - a[3 + k] / cws;
        ct[k] = x.d0[k] - a[6 + k] / cwt;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) c[3 * i + j] = sc[i] * dc[j];
    }
    const int ui[6] = {0, 1, 2, 0, 0, 1}, uj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        c[9 + k] = (cs[ui[k]] * ws) * cs[uj[k]];
        c[15 + k] = (ct[ui[k]] * wt) * ct[uj[k]];
    }
    block_sum(c, red);

    horn_rotation(c, f.R);
#pragma unroll
    for (int k = 0; k < 3; ++k)
        f.t[k] = b[3 + k] - ((f.R[3 * k] * b[0] + f.R[3 * k + 1] * b[1]) + f.R[3 * k + 2] * b[2]);

    // condition numbers: singular values of H, eigenvalues of each covariance
    const float* H = c;
    float hh[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        const int i = ui[k], j = uj[k];
        hh[k] = (H[i] * H[j] + H[3 + i] * H[3 + j]) + H[6 + i] * H[6 + j];
    }
    float e[3];
    sym3_eigenvalues(hh[0], hh[1], hh[2], hh[3], hh[4], hh[5], e);
    const float s1 = sqrtf(clamp_min(e[1], 0.0f)), s2 = sqrtf(clamp_min(e[2], 0.0f));
    const float c1 = fabsf(s2 / (s1 > 1e-12f ? s1 : 1e-12f));
    float cov_s[6], cov_t[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        cov_s[k] = c[9 + k] / cws;
        cov_t[k] = c[15 + k] / cwt;
    }
    f.ok = c1 < CONDITION_THRESH && cov_condition(cov_s) < CONDITION_THRESH
           && cov_condition(cov_t) < CONDITION_THRESH;

    // the largest squared residual over the mask, from the raw points
    float res = -INFINITY;
    if (m) {
        float e2 = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float y = ((x.s[0] * f.R[3 * k] + x.s[1] * f.R[3 * k + 1])
                             + x.s[2] * f.R[3 * k + 2]) + f.t[k] - x.d[k];
            e2 = k == 0 ? y * y : e2 + y * y;
        }
        res = e2;
    }
    int idx = r;
    block_argmax(res, idx, red);
    f.maxres = res;
    f.worst = idx;
}

template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
kabsch_filter_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                     const float* __restrict__ pix_src, const float* __restrict__ pix_tgt,
                     const uint8_t* __restrict__ valid, uint8_t* __restrict__ inlier_out,
                     int64_t* __restrict__ count_out, float* __restrict__ transform_out,
                     uint8_t* __restrict__ valid_pair_out, int R, int max_filtered,
                     int min_num_matches, float max_res2) {
    extern __shared__ float smem[];
    Red red{smem, (int)(blockDim.x >> 5), 0};
    float2* ps = (float2*)(smem + 2 * KF_MAX_WARPS * KF_RED);
    float2* pt = ps + R;
    uint8_t* live = (uint8_t*)(pt + R);

    const int p = blockIdx.x, r = threadIdx.x;
    const bool mine = r < R;
    const size_t base = (size_t)p * R;
    Match x;
    float2 my_ps = make_float2(0.0f, 0.0f), my_pt = my_ps;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        x.s[k] = mine ? src[3 * (base + r) + k] : 0.0f;
        x.d[k] = mine ? tgt[3 * (base + r) + k] : 0.0f;
    }
    const bool fin_s = mine && isfinite(x.s[0]) && isfinite(x.s[1]) && isfinite(x.s[2]);
    const bool fin_d = mine && isfinite(x.d[0]) && isfinite(x.d[1]) && isfinite(x.d[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        x.s0[k] = fin_s ? x.s[k] : 0.0f;
        x.d0[k] = fin_d ? x.d[k] : 0.0f;
    }
    x.fs = fin_s ? 1.0f : 0.0f;
    x.fd = fin_d ? 1.0f : 0.0f;
    x.fb = (fin_s && fin_d) ? 1.0f : 0.0f;
    if (mine) {
        my_ps = make_float2(pix_src[2 * (base + r)], pix_src[2 * (base + r) + 1]);
        my_pt = make_float2(pix_tgt[2 * (base + r)], pix_tgt[2 * (base + r) + 1]);
        ps[r] = my_ps;
        pt[r] = my_pt;
        live[r] = valid[base + r];
    }
    __syncthreads();

    bool inl = false;
    int count = 0;
    Fit cur;
#pragma unroll
    for (int k = 0; k < 9; ++k) cur.R[k] = (k % 4 == 0) ? 1.0f : 0.0f;
    cur.t[0] = cur.t[1] = cur.t[2] = 0.0f;
    cur.maxres = 100.0f;
    cur.worst = 0;
    cur.ok = false;

    for (int i = 0; i < R; ++i) {
        // the scan ends at the first invalid entry or once full
        if (!live[i] || count >= max_filtered) break;
        // pixel-distance dedup against the current inliers, in either image
        const float2 cs = ps[i], ct = pt[i];
        bool near = false;
        if (inl) {
            const float dxs = cs.x - my_ps.x, dys = cs.y - my_ps.y;
            const float dxt = ct.x - my_pt.x, dyt = ct.y - my_pt.y;
            near = sqrtf(dxs * dxs + dys * dys) <= PIXEL_DIST_THRESH
                   || sqrtf(dxt * dxt + dyt * dyt) <= PIXEL_DIST_THRESH;
        }
        if (__syncthreads_or(near)) continue;
        bool tent = inl || r == i;
        int n_new = count + 1;
        if (n_new >= 3) {
            Fit f1;
            geo(tent, x, r, red, f1);
            bool mask_s = tent, stop = false;
            int n_s = n_new;
            Fit fs = f1;
            while (fs.maxres > max_res2 && n_s > 3 && !stop) {
                // strip the worst inlier under the current fit and refit
                const bool mask2 = mask_s && r != fs.worst;
                const int n2 = n_s - 1;
                Fit f2;
                geo(mask2, x, r, red, f2);
                // stripped to 3 and still bad (or killed a valid fit):
                // restore the post-add transform and stop
                const bool revert = n2 == 3 && (f2.maxres > max_res2 || (f1.ok && !f2.ok));
                if (!revert) {
                    mask_s = mask2;
                    n_s = n2;
                    fs = f2;
                } else {
#pragma unroll
                    for (int k = 0; k < 9; ++k) fs.R[k] = f1.R[k];
#pragma unroll
                    for (int k = 0; k < 3; ++k) fs.t[k] = f1.t[k];
                    fs.ok = f1.ok;
                }
                stop = revert || f2.maxres < max_res2;
            }
            cur = fs;
            tent = mask_s;
            n_new = n_s;
        }
        inl = tent;
        count = n_new;
    }

    const bool vp = count >= min_num_matches && cur.maxres < max_res2 && cur.ok;
    if (mine) inlier_out[base + r] = (inl && vp) ? 1 : 0;
    if (r == 0) {
        count_out[p] = vp ? count : 0;
        float* T = transform_out + 16 * (size_t)p;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) T[4 * i + j] = cur.R[3 * i + j];
            T[4 * i + 3] = cur.t[i];
        }
        T[12] = T[13] = T[14] = 0.0f;
        T[15] = 1.0f;
        valid_pair_out[p] = vp ? 1 : 0;
    }
}

extern "C" int bf_kabsch_filter(const float* src, const float* tgt, const float* pix_src,
                                const float* pix_tgt, const uint8_t* valid, uint8_t* inlier,
                                int64_t* count, float* transform, uint8_t* valid_pair, int P,
                                int R, int max_filtered, int min_num_matches, float max_res2,
                                void* stream) {
    if (P <= 0 || R < 0 || R > KF_MAX_R) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = R <= 32 ? 32 : (R + 31) / 32 * 32;
    const size_t smem = sizeof(float) * (2 * KF_MAX_WARPS * KF_RED + 4 * (size_t)R) + R;
    if (threads <= 256) {
        kabsch_filter_kernel<256><<<P, threads, smem, st>>>(
            src, tgt, pix_src, pix_tgt, valid, inlier, count, transform, valid_pair, R,
            max_filtered, min_num_matches, max_res2);
    } else {
        kabsch_filter_kernel<KF_MAX_R><<<P, threads, smem, st>>>(
            src, tgt, pix_src, pix_tgt, valid, inlier, count, transform, valid_pair, R,
            max_filtered, min_num_matches, max_res2);
    }
    return (int)cudaGetLastError();
}
