// The greedy Kabsch filter of the match cascade, for Hopper (sm_90a): the
// whole candidate scan of an image pair in one warp, all pairs in one launch.
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
// The arithmetic follows the plain version's formulas with every product,
// sum, division and square root rounded as IEEE float32 (built with
// --fmad=false, -prec-div=true, -prec-sqrt=true); sums are taken in another
// order than the plain version's reductions and its tiny products go through
// cuBLAS, so the two agree to rounding, not bit for bit.
//
// What bounds it. Neither bytes nor operations: per pair it reads 44 bytes
// and writes 1 byte per match, and a fit is ~2 000 operations; at the main
// path's shapes that is microseconds of either. The time is the dependent
// chain of each pair's scan: up to R candidate steps, each one fit plus one
// per strip round, and inside a fit three dependent sums over the matches,
// the 7 squarings of Horn's 4x4 matrix with a norm, a square root and a
// division each, and a (value, index) maximum. Pairs run side by side, so the
// launch takes about as long as its longest pair. The design shortens that
// chain; throughput is not what is short. A layout of one CTA per pair and
// one thread per match, with block reductions behind __syncthreads and the
// whole 4x4 algebra on every thread, took 0.41 ms for the 10 pairs of one
// frame (14 us a fit on the longest pair) on an H100 80GB HBM3 at 700 W.
//
// Layout.
//   - One warp per pair. Lane l holds matches l, l + 32, l + 64, ... in
//     registers (slot j holds match 32 j + l), K = 4, 8 or 32 slots for
//     R <= 128, 256 or 1024; its mask bits are one word. Several pairs (warps)
//     share a CTA only once every SM has one; they share no barrier and no
//     shared memory, so there is no __syncthreads and no shared-memory round
//     trip anywhere in the scan.
//   - Two fits at once (geo2). Horn's algebra needs 16 lanes, so each
//     half-warp runs one fit's: lane l holds entry l & 15 of its 4x4 matrix,
//     a squaring takes its row and column operands by shuffle and sums them
//     in the order k = 0..3, the Frobenius norm is a 16-lane butterfly, and
//     each lane divides its own entry (one IEEE division a lane, not 16 on
//     one thread). The second fit is speculative: beside each fit of a
//     candidate step, the other half fits the next candidate onto the mask
//     being fitted, which is that step's add-fit if this step ends with that
//     mask (it does unless a strip reverts); the step after then starts from
//     it. A fit's result does not depend on its partner, so the outputs are
//     those of one fit at a time, bit for bit.
//   - Every sum over the matches is a per-lane partial over the slots in
//     order, then a fixed xor butterfly of __shfl_xor_sync: x + y == y + x,
//     so both lanes of every exchange get the same bits, control flow stays
//     uniform in the warp, and two runs are equal bit for bit. With two
//     fits, the first level (xor 16) leaves fit h's sums on half h, so a
//     level moves one fit's values. The three dependent sums are the weights
//     with the covariances' first moments; the centroids with both
//     covariances (which need only the first); then H (which needs the
//     centroids). Divisions by a sum are spread over the lanes, one a lane,
//     and shuffled back.
//   - The three symmetric 3x3 eigenvalue solves of the condition numbers
//     (H^T H and the two covariances) run on different lanes at once
//     ((lane & 15) % 3 picks the matrix), in nine steps placed after Horn's
//     nine norm butterflies, whose shuffle latency they fill; the verdicts
//     meet in one __ballot_sync.
//   - The worst inlier is a per-lane maximum over the slots of an unsigned
//     key that orders floats as torch.max does (NaN first), then one
//     __reduce_max_sync and one __reduce_min_sync for the lowest index with
//     that key (redux.sync): the order is total, so the result does not
//     depend on the order of the reduction.
//   - The candidate's pixels come from the lane that holds it by
//     __shfl_sync; the 5 px dedup compares squared distances with the
//     largest float whose sqrtf is <= 5 (the same test, without a square
//     root) over the lane's inliers, then one __any_sync.
//   - K = 32 keeps 320 values a lane and spills to local memory: that width
//     (R > 256) is not on the main path, which hands 128 raw matches.
// Nothing is read back: the host enqueues one launch and the outputs stay on
// the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KF_MAX_R 1024
#define KF_WARPS 4                 // most pairs (warps) in one CTA
#define FULL_MASK 0xffffffffu
#define CONDITION_THRESH 100.0f    // KABSCH_CONDITION_THRESH
// the largest float whose sqrtf is <= 5 px (MATCH_FILTER_PIXEL_DIST_THRESH)
#define NEAR_D2_MAX 0x1.900002p+4f
#define TWO_THIRDS_PI 2.0943951023931953f

struct Fit {
    float R[9];
    float t[3];
    float maxres;   // largest squared residual over the mask (NaN propagates)
    int worst;      // its first index
    bool ok;        // the three condition numbers under 100
};

// one lane's matches: slot j holds match 32 j + lane
template <int K>
struct Lane {
    float s[K][3], d[K][3];       // raw points: the residuals use them
    float ps[K][2], pt[K][2];     // pixels in either image
    uint32_t fin_s, fin_d;        // bit j: slot j's point is finite (src / tgt)
};

// the sum of x over the 16 lanes of each half-warp
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) x = x + __shfl_xor_sync(FULL_MASK, x, s);
    return x;
}

// two fits' sums over the warp, v[k] of fit 0 and v[N + k] of fit 1 on
// every lane: half-warp h ends with fit h's sums in out[]. The first level
// (xor 16) sends the other half the values it keeps, so a level moves N
// values, not 2 N; every sum is that of the full xor butterfly (both lanes
// of an exchange add the same two values), the same on every lane of a half.
template <int N>
__device__ __forceinline__ void warp_sum_split(const float (&v)[2 * N], int half,
                                               float (&out)[N]) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const float keep = half ? v[N + k] : v[k], send = half ? v[k] : v[N + k];
        out[k] = keep + __shfl_xor_sync(FULL_MASK, send, 16);
    }
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) {
#pragma unroll
        for (int k = 0; k < N; ++k) out[k] = out[k] + __shfl_xor_sync(FULL_MASK, out[k], s);
    }
}

// num[d] / den[d], d < D <= 16, of this half's fit: one IEEE division on
// lane d of the half; returns it (lane d's quotient)
template <int D>
__device__ __forceinline__ float half_div(const float (&num)[D], const float (&den)[D],
                                          int lane) {
    const int e = lane & 15;
    float n = num[0], dn = den[0];
#pragma unroll
    for (int k = 1; k < D; ++k) {
        if (e == k) {
            n = num[k];
            dn = den[k];
        }
    }
    return n / dn;
}

// a total order: NaN above every number, then the larger value, then the
// lower index (torch.max / torch.argmax)
__device__ __forceinline__ bool ranks_above(float va, int ia, float vb, int ib) {
    const bool na = va != va, nb = vb != vb;
    if (na || nb) return na && (!nb || ia < ib);
    return va > vb || (va == vb && ia < ib);
}

// a float's place in that order as an unsigned key, for redux.sync: NaN
// above +inf above the numbers above -inf, -0 taken as +0
__device__ __forceinline__ uint32_t order_key(float v) {
    const uint32_t u = __float_as_uint(v + 0.0f);
    return v != v ? 0xffffffffu : (u >> 31 ? ~u : u | 0x80000000u);
}

// the float of a key (a NaN for the NaN key)
__device__ __forceinline__ float key_value(uint32_t k) {
    return k == 0xffffffffu ? __uint_as_float(0x7fffffffu)
                            : __uint_as_float(k >> 31 ? k & 0x7fffffffu : ~k);
}

// torch.clamp(x, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// One lane's condition number: the analytic eigenvalues e0 <= e1 <= e2 of a
// symmetric 3x3 matrix (`sym3_eigenvalues`), then |s2 / s1| of the singular
// values sqrt(e) when the matrix is H^T H (`sv`), else |e2 / e1|. In nine
// steps, each with at most one division, square root or trigonometric call:
// horn_rotation runs one after each of its norm butterflies, so that the
// solve's latency hides in theirs.
struct Cond3 {
    float a00, a11, a22, a01, a02, a12;
    bool sv;
    float q, t6, p2, p, r, phi, e0, e2, cond;

    __device__ __forceinline__ void step(int k) {
        switch (k) {
        case 0:
            q = (a00 + a11 + a22) / 3.0f;
            break;
        case 1: {
            const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
            t6 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0f;
            break;
        }
        case 2:
            p2 = t6 + (a01 * a01 + a02 * a02 + a12 * a12) / 3.0f;
            break;
        case 3:
            p = sqrtf(clamp_min(p2, 1e-30f));
            break;
        case 4: {
            const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
            const float detB = b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
                               + a02 * (a01 * a12 - b11 * a02);
            r = detB / (2.0f * p * p * p);
            r = r < -1.0f ? -1.0f : (r > 1.0f ? 1.0f : r);
            break;
        }
        case 5:
            phi = acosf(r) / 3.0f;
            break;
        case 6:
            e2 = q + 2.0f * p * cosf(phi);
            break;
        case 7:
            e0 = q + 2.0f * p * cosf(phi + TWO_THIRDS_PI);
            break;
        default: {
            const float e1 = 3.0f * q - e0 - e2;
            const float s1 = sqrtf(clamp_min(e1, 0.0f)), s2 = sqrtf(clamp_min(e2, 0.0f));
            const float cn = sv ? s2 : e2;
            const float cd = sv ? (s1 > 1e-12f ? s1 : 1e-12f) : (fabsf(e1) > 1e-12f ? e1 : 1e-12f);
            cond = fabsf(cn / cd);
        }
        }
    }
};

// Horn's rotation from the cross-covariance H (`_horn_rotation`): the top
// eigenvector of the shifted N matrix, by squaring it 7 times. Each half-warp
// works on its own H: lane l holds entry e = l & 15 (row e / 4, column e % 4),
// and every lane of a half gets that half's R. After each of the 9 norms it
// runs one step of `c`.
__device__ __forceinline__ void horn_rotation(const float* H, int lane, float* R, Cond3& c) {
    const float Sxx = H[0], Sxy = H[1], Sxz = H[2];
    const float Syx = H[3], Syy = H[4], Syz = H[5];
    const float Szx = H[6], Szy = H[7], Szz = H[8];
    const float N[16] = {
        Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
        Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
        Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
        Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz,
    };
    const int base = lane & 16, e = lane & 15, row = e >> 2, col = e & 3;
    float m = N[0];
#pragma unroll
    for (int k = 1; k < 16; ++k) m = e == k ? N[k] : m;
    const float n0 = sum16(m * m);
    c.step(0);
    const float shift = sqrtf(n0) + 1e-12f;
    if (row == col) m = m + shift;
    const float n1 = sum16(m * m);
    c.step(1);
    m = m / sqrtf(n1);
#pragma unroll
    for (int it = 0; it < 7; ++it) {
        float a[4], b[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            a[k] = __shfl_sync(FULL_MASK, m, base + 4 * row + k);
            b[k] = __shfl_sync(FULL_MASK, m, base + 4 * k + col);
        }
        float acc = a[0] * b[0];
#pragma unroll
        for (int k = 1; k < 4; ++k) acc = acc + a[k] * b[k];
        const float n = sum16(acc * acc);
        c.step(2 + it);
        m = acc / clamp_min(sqrtf(n), 1e-30f);
    }
    // every column of the limit is proportional to the top eigenvector: take
    // the one of largest norm (the first on a tie)
    float n2 = m * m;
    n2 = n2 + __shfl_xor_sync(FULL_MASK, n2, 4);
    n2 = n2 + __shfl_xor_sync(FULL_MASK, n2, 8);
    int best = col;
#pragma unroll
    for (int s = 2; s > 0; s >>= 1) {
        const float vo = __shfl_xor_sync(FULL_MASK, n2, s);
        const int io = __shfl_xor_sync(FULL_MASK, best, s);
        if (ranks_above(vo, io, n2, best)) {
            n2 = vo;
            best = io;
        }
    }
    float q[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) q[r] = __shfl_sync(FULL_MASK, m, base + 4 * r + best);
    const float nq = clamp_min(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]),
                               1e-20f);
    // q[e] / nq on lane e < 4 of the half, shuffled to the half
    float qe = q[0];
#pragma unroll
    for (int r = 1; r < 4; ++r) qe = e == r ? q[r] : qe;
    qe = qe / nq;
#pragma unroll
    for (int r = 0; r < 4; ++r) q[r] = __shfl_sync(FULL_MASK, qe, base + r);
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

// two fits at once (`geo` of the plain version) of the masked consensus:
// bit j of m[h] masks slot j of this lane for fit h. Sums carry both masks;
// half-warp h runs fit h's 4x4 algebra, lanes 16 h + 0..2 its three
// eigenvalue solves. Every lane gets both fits, each the bits it would get
// alone.
template <int K>
__device__ __forceinline__ void geo2(const uint32_t (&m)[2], const Lane<K>& x, int lane,
                                     Fit (&f)[2]) {
    const int ui[6] = {0, 1, 2, 0, 0, 1}, uj[6] = {0, 1, 2, 1, 2, 2};
    const int half = lane >> 4;
    // weights (w: both points finite, 0 or 1) and the covariances' first
    // moments, 9 a fit
    float a[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) a[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const bool fs = (x.fin_s >> j) & 1u, fd = (x.fin_d >> j) & 1u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const bool mj = (m[h] >> j) & 1u;
            const float ws = mj && fs ? 1.0f : 0.0f, wt = mj && fd ? 1.0f : 0.0f;
            float* ah = a + 9 * h;
            ah[0] = ah[0] + (mj && fs && fd ? 1.0f : 0.0f);
            ah[1] = ah[1] + ws;
            ah[2] = ah[2] + wt;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                ah[3 + k] = ah[3 + k] + (fs ? x.s[j][k] : 0.0f) * ws;
                ah[6 + k] = ah[6 + k] + (fd ? x.d[j][k] : 0.0f) * wt;
            }
        }
    }
    float ah[9];
    warp_sum_split(a, half, ah);
    // this half's fit: w / (sum w + 1e-12) for w in {0, 1} (0 or
    // 1 / (sum w + 1e-12), as the division rounds it) and the covariances'
    // means, one division a lane; then both fits' quotients on every lane
    const float cws = clamp_min(ah[1], 1e-12f), cwt = clamp_min(ah[2], 1e-12f);
    const float num[7] = {1.0f, ah[3], ah[4], ah[5], ah[6], ah[7], ah[8]};
    const float den[7] = {ah[0] + 1e-12f, cws, cws, cws, cwt, cwt, cwt};
    const float qa = half_div(num, den, lane);
    float quo[14];
#pragma unroll
    for (int k = 0; k < 14; ++k) quo[k] = __shfl_sync(FULL_MASK, qa, 16 * (k / 7) + k % 7);
    // per fit: the centroids (0-5) and the covariances' upper triangles, 00
    // 11 22 01 02 12 (6-11 src, 12-17 tgt)
    float b[36];
#pragma unroll
    for (int k = 0; k < 36; ++k) b[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const bool fs = (x.fin_s >> j) & 1u, fd = (x.fin_d >> j) & 1u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const bool mj = (m[h] >> j) & 1u;
            const float ws = mj && fs ? 1.0f : 0.0f, wt = mj && fd ? 1.0f : 0.0f;
            const float wn = mj && fs && fd ? quo[7 * h] : 0.0f;
            float* bh = b + 18 * h;
            float cs[3], ct[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float s0 = fs ? x.s[j][k] : 0.0f, d0 = fd ? x.d[j][k] : 0.0f;
                bh[k] = bh[k] + s0 * wn;
                bh[3 + k] = bh[3 + k] + d0 * wn;
                cs[k] = s0 - quo[7 * h + 1 + k];
                ct[k] = d0 - quo[7 * h + 4 + k];
            }
#pragma unroll
            for (int u = 0; u < 6; ++u) {
                bh[6 + u] = bh[6 + u] + (cs[ui[u]] * ws) * cs[uj[u]];
                bh[12 + u] = bh[12 + u] + (ct[ui[u]] * wt) * ct[uj[u]];
            }
        }
    }
    float bh[18];
    warp_sum_split(b, half, bh);
    // both fits' centroids on every lane
    float cen[12];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        const float o = __shfl_xor_sync(FULL_MASK, bh[k], 16);
        cen[k] = half ? o : bh[k];
        cen[6 + k] = half ? bh[k] : o;
    }
    // H, 9 a fit
    float H[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) H[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const bool fs = (x.fin_s >> j) & 1u, fd = (x.fin_d >> j) & 1u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const bool mj = (m[h] >> j) & 1u;
            const float wn = mj && fs && fd ? quo[7 * h] : 0.0f;
            float sc[3], dc[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                sc[k] = ((fs ? x.s[j][k] : 0.0f) - cen[6 * h + k]) * wn;
                dc[k] = (fd ? x.d[j][k] : 0.0f) - cen[6 * h + 3 + k];
            }
#pragma unroll
            for (int r = 0; r < 3; ++r) {
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    H[9 * h + 3 * r + c] = H[9 * h + 3 * r + c] + sc[r] * dc[c];
            }
        }
    }
    float Hh[9];   // this half's fit's H
    warp_sum_split(H, half, Hh);
    // this half's covariances (H^T H's entries need no division), one
    // division a lane: src on lanes 0-5 of the half, tgt on 6-11
    float cnum[12], cden[12];
#pragma unroll
    for (int u = 0; u < 6; ++u) {
        cnum[u] = bh[6 + u];
        cden[u] = cws;
        cnum[6 + u] = bh[12 + u];
        cden[6 + u] = cwt;
    }
    const float qc = half_div(cnum, cden, lane);

    // condition numbers, one matrix a lane: (lane & 15) % 3 == 0 the singular
    // values of the half's H (eigenvalues of H^T H), 1 / 2 the eigenvalues of
    // its src / tgt covariance; solved inside horn_rotation
    const int sel = (lane & 15) % 3;
    float A[6];
#pragma unroll
    for (int u = 0; u < 6; ++u) {
        const int i = ui[u], j = uj[u];
        const float hh = (Hh[i] * Hh[j] + Hh[3 + i] * Hh[3 + j]) + Hh[6 + i] * Hh[6 + j];
        const float c = __shfl_sync(FULL_MASK, qc, (lane & 16) + (sel == 2 ? 6 : 0) + u);
        A[u] = sel == 0 ? hh : c;
    }
    Cond3 cn{A[0], A[1], A[2], A[3], A[4], A[5], sel == 0};

    float R[9], t[3];
    horn_rotation(Hh, lane, R, cn);
    const uint32_t ok = __ballot_sync(FULL_MASK, cn.cond < CONDITION_THRESH);
    f[0].ok = (ok & 7u) == 7u;
    f[1].ok = ((ok >> 16) & 7u) == 7u;
#pragma unroll
    for (int k = 0; k < 3; ++k)
        t[k] = bh[3 + k] - ((R[3 * k] * bh[0] + R[3 * k + 1] * bh[1]) + R[3 * k + 2] * bh[2]);
    // both fits' R and t on every lane
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const float o = __shfl_xor_sync(FULL_MASK, R[k], 16);
        f[0].R[k] = half ? o : R[k];
        f[1].R[k] = half ? R[k] : o;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float o = __shfl_xor_sync(FULL_MASK, t[k], 16);
        f[0].t[k] = half ? o : t[k];
        f[1].t[k] = half ? t[k] : o;
    }

    // the largest squared residual over each mask, from the raw points: a
    // lane's first largest key over its slots, then the warp's largest key
    // and the lowest index that has it (redux.sync)
    uint32_t key[2] = {0u, 0u};
    int idx[2] = {lane, lane};
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float e2 = 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float y = ((x.s[j][0] * f[h].R[3 * k] + x.s[j][1] * f[h].R[3 * k + 1])
                                 + x.s[j][2] * f[h].R[3 * k + 2]) + f[h].t[k] - x.d[j][k];
                e2 = k == 0 ? y * y : e2 + y * y;
            }
            const uint32_t kj = order_key((m[h] >> j) & 1u ? e2 : -INFINITY);
            if (j == 0 || kj > key[h]) {
                key[h] = kj;
                idx[h] = 32 * j + lane;
            }
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t top = __reduce_max_sync(FULL_MASK, key[h]);
        f[h].worst = (int)__reduce_min_sync(FULL_MASK, key[h] == top ? (uint32_t)idx[h] : ~0u);
        f[h].maxres = key_value(top);
    }
}

// the candidate's bit in this lane's mask word (0 off its lane)
__device__ __forceinline__ uint32_t bit_of(int i, int lane) {
    return lane == (i & 31) ? 1u << (i >> 5) : 0u;
}

// the first candidate at or after i that the scan takes in (before the
// first invalid entry `end`, the set of `count` inliers `inl` not yet full,
// and not within 5 px of one of them in either image); -1 when the scan ends
template <int K>
__device__ __forceinline__ int next_candidate(int i, uint32_t inl, int count, int end,
                                              int max_filtered, const Lane<K>& x, int lane) {
    if (count >= max_filtered) return -1;
    for (; i < end; ++i) {
        // the candidate's pixels, from the lane that holds it
        const int owner = i & 31, slot = i >> 5;
        float c[4] = {x.ps[0][0], x.ps[0][1], x.pt[0][0], x.pt[0][1]};
#pragma unroll
        for (int j = 1; j < K; ++j) {
            if (j == slot) {
                c[0] = x.ps[j][0];
                c[1] = x.ps[j][1];
                c[2] = x.pt[j][0];
                c[3] = x.pt[j][1];
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) c[k] = __shfl_sync(FULL_MASK, c[k], owner);
        // sqrtf(d2) <= 5 exactly when d2 <= NEAR_D2_MAX (sqrtf rounds correctly
        // and is monotonic); every slot is tested, then masked by its bit
        bool near = false;
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const float dxs = c[0] - x.ps[j][0], dys = c[1] - x.ps[j][1];
            const float dxt = c[2] - x.pt[j][0], dyt = c[3] - x.pt[j][1];
            const bool nj = dxs * dxs + dys * dys <= NEAR_D2_MAX
                            || dxt * dxt + dyt * dyt <= NEAR_D2_MAX;
            near = near || (((inl >> j) & 1u) && nj);
        }
        if (!__any_sync(FULL_MASK, near)) return i;
    }
    return -1;
}

template <int K>
__global__ void __launch_bounds__(KF_WARPS * 32)
kabsch_filter_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                     const float* __restrict__ pix_src, const float* __restrict__ pix_tgt,
                     const uint8_t* __restrict__ valid, uint8_t* __restrict__ inlier_out,
                     int64_t* __restrict__ count_out, float* __restrict__ transform_out,
                     uint8_t* __restrict__ valid_pair_out, int P, int R, int max_filtered,
                     int min_num_matches, float max_res2) {
    const int lane = threadIdx.x & 31;
    const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (p >= P) return;   // the whole warp: no barrier is shared with another
    const size_t base = (size_t)p * R;

    Lane<K> x;
    x.fin_s = x.fin_d = 0u;
    int end = R;   // the first invalid entry ends the scan
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const int r = 32 * j + lane;
        const bool mine = r < R;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            x.s[j][k] = mine ? src[3 * (base + r) + k] : 0.0f;
            x.d[j][k] = mine ? tgt[3 * (base + r) + k] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            x.ps[j][k] = mine ? pix_src[2 * (base + r) + k] : 0.0f;
            x.pt[j][k] = mine ? pix_tgt[2 * (base + r) + k] : 0.0f;
        }
        if (isfinite(x.s[j][0]) && isfinite(x.s[j][1]) && isfinite(x.s[j][2])) x.fin_s |= 1u << j;
        if (isfinite(x.d[j][0]) && isfinite(x.d[j][1]) && isfinite(x.d[j][2])) x.fin_d |= 1u << j;
        const uint32_t bad = __ballot_sync(FULL_MASK, mine && !valid[base + r]);
        if (bad) end = min(end, 32 * j + __ffs(bad) - 1);
    }

    uint32_t inl = 0u;   // bit j: slot j is an inlier
    int count = 0;
    Fit cur;             // the current fit: R, t, maxres, ok
#pragma unroll
    for (int k = 0; k < 9; ++k) cur.R[k] = (k % 4 == 0) ? 1.0f : 0.0f;
    cur.t[0] = cur.t[1] = cur.t[2] = 0.0f;
    cur.maxres = 100.0f;
    cur.worst = 0;
    cur.ok = false;
    // the add-fit of candidate i onto inl, when the last fit computed it
    bool have_pre = false;
    Fit pre;

    int i = next_candidate(0, inl, count, end, max_filtered, x, lane);
    while (i >= 0) {
        uint32_t tent = inl | bit_of(i, lane);
        int n_new = count + 1;
        bool guessed = false;   // `pre` holds the next step's add-fit
        int next = -1;
        if (n_new >= 3) {
            // fit the set with the candidate; while its worst residual is too
            // large, strip the worst inlier and refit. Beside each fit, the
            // second half of the warp fits the next step's candidate onto the
            // mask of this one, in case the step ends with that mask.
            uint32_t mask_s = tent, mask_f = tent;
            int n_s = n_new;
            bool stop = false;
            Fit f1, fs;
            for (int round = 0;; ++round) {
                Fit f[2];
                if (round == 0 && have_pre) {
                    f[0] = pre;
                    guessed = false;
                } else {
                    const int n_f = round == 0 ? n_new : n_s - 1;
                    next = next_candidate(i + 1, mask_f, n_f, end, max_filtered, x, lane);
                    const uint32_t m[2] = {mask_f, next >= 0 ? mask_f | bit_of(next, lane) : mask_f};
                    geo2(m, x, lane, f);
                    pre = f[1];
                    guessed = next >= 0;
                }
                if (round == 0) {
                    f1 = f[0];
                    fs = f[0];
                } else {
                    // stripped to 3 and still bad (or killed a valid fit):
                    // restore the post-add transform and stop
                    const int n2 = n_s - 1;
                    const bool revert =
                        n2 == 3 && (f[0].maxres > max_res2 || (f1.ok && !f[0].ok));
                    if (!revert) {
                        mask_s = mask_f;
                        n_s = n2;
                        fs = f[0];
                    } else {
#pragma unroll
                        for (int k = 0; k < 9; ++k) fs.R[k] = f1.R[k];
#pragma unroll
                        for (int k = 0; k < 3; ++k) fs.t[k] = f1.t[k];
                        fs.ok = f1.ok;
                        guessed = false;   // the step ends with the mask before the strip
                    }
                    stop = revert || f[0].maxres < max_res2;
                }
                if (!(fs.maxres > max_res2 && n_s > 3 && !stop)) break;
                // the worst inlier under the current fit leaves the mask
                mask_f = mask_s & ~bit_of(fs.worst, lane);
            }
            cur = fs;
            tent = mask_s;
            n_new = n_s;
        }
        inl = tent;
        count = n_new;
        have_pre = guessed;
        i = guessed ? next : next_candidate(i + 1, inl, count, end, max_filtered, x, lane);
    }

    const bool vp = count >= min_num_matches && cur.maxres < max_res2 && cur.ok;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const int r = 32 * j + lane;
        if (r < R) inlier_out[base + r] = (((inl >> j) & 1u) && vp) ? 1 : 0;
    }
    if (lane == 0) {
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
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    // one pair a warp; spread the pairs over the SMs first, and put several
    // in one CTA only once every SM has one
    int warps = (P + sms - 1) / sms;
    warps = warps < 1 ? 1 : (warps > KF_WARPS ? KF_WARPS : warps);
    const int blocks = (P + warps - 1) / warps;
    cudaStream_t st = (cudaStream_t)stream;
#define KF_LAUNCH(K)                                                                        \
    kabsch_filter_kernel<K><<<blocks, 32 * warps, 0, st>>>(                                 \
        src, tgt, pix_src, pix_tgt, valid, inlier, count, transform, valid_pair, P, R,      \
        max_filtered, min_num_matches, max_res2)
    if (R <= 4 * 32) {
        KF_LAUNCH(4);
    } else if (R <= 8 * 32) {
        KF_LAUNCH(8);
    } else {
        KF_LAUNCH(32);
    }
#undef KF_LAUNCH
    return (int)cudaGetLastError();
}
