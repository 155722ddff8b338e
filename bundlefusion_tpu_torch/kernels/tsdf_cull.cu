// Per-block frustum cull of the fused TSDF op, for Hopper (sm_90a): all ops
// in one launch, into a row list and a row count that stay on the card.
//
// Replaces the scheduler `active_tile_indices` of
// bundlefusion_tpu/tsdf/apply_pallas.py:554-617, at block rather than
// 128-row tile granularity. Its plain version is `active_block_rows`
// (bundlefusion_tpu_torch/tsdf/apply_ops.py), and the rule is the same: a
// live block is kept for an op with sign != 0 if, with all 8 corners in
// front of the camera (z > 1e-3), their projections overlap the image
// widened by half a pixel and the nearest corner is not beyond the op's far
// bound, dm + truncation + truncation_scale * dm with dm the smaller of the
// depth limit and the op image's largest sampled depth (read from the card:
// the image pass left it there); a block that straddles the camera plane is
// kept. Arithmetic follows the plain version's order with rounded products,
// but the test has half a voxel of margin, so the list need not match row for
// row: it must hold every row the sweep would change.
//
// Output. Per kept row one int32 row index and one 64-bit mask whose bit o
// says that op o can touch the row; rows are appended with one atomicAdd per
// warp (ballot + popc), so the order of the list changes from run to run.
// Rows are independent in the sweep, so its result does not. The count is
// zeroed on the stream before the launch and read by the sweep on the card:
// the host never sees the list.
//
// What bounds it. Bytes, barely: 4 bytes of key per payload row (0.8 MB at
// 200 064 rows, 0.24 us at 3.35 TB/s) plus 12 bytes per listed row; the
// arithmetic is ~60 machine instructions per corner, 8 corners per live row
// and op. Neither limit is near when the table is far from full: live rows
// sit in a prefix of the table (slots are handed out ascending), so a few
// CTAs carry all the corner tests and the kernel's time is the latency of one
// thread's ops x 8 corners, a few microseconds. One thread per row and small
// CTAs (128 threads) spread that prefix over more SMs; the 8 corners of an op
// are unrolled, so a thread has independent work in flight. (Splitting a
// row's ops over the warps of a CTA shortens that thread but makes every
// all-dead CTA eight warps wide; on an H100 it lost at 1 op what it won at
// 11, so the simple layout stays.)

#include <cuda_runtime.h>
#include <stdint.h>

#define CULL_THREADS 128
#define MAX_OPS 64
#define GRID_BITS 10
#define GRID_DIM (1 << GRID_BITS)
#define GRID_HALF (GRID_DIM / 2)
#define EMPTY_KEY 0x7fffffff

// ((m0 * x + m1 * y) + m2 * z) + m3, every product and sum rounded: one row
// of a world-to-camera transform, in the plain version's order
__device__ __forceinline__ float affine_row(const float* m, float x, float y, float z) {
    const float xy = __fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y));
    return __fadd_rn(__fadd_rn(xy, __fmul_rn(m[2], z)), m[3]);
}

struct CullParams {
    int n;     // payload rows to scan (the dummy row is not among them)
    int ops;
    int imgs;
    float fx, fy, cx, cy;
    float block_extent;  // BLOCK_SIZE * voxel_size, rounded once to float
    float u_hi, v_hi;    // W - 0.5, H - 0.5
    float truncation;
    float truncation_scale;
    float depth_max;     // min(depth_max, max_integration_distance)
    float sign[MAX_OPS];
    int img[MAX_OPS];
};

__global__ void __launch_bounds__(CULL_THREADS)
tsdf_cull_kernel(const int* __restrict__ slot_keys, const float* __restrict__ w2c,
                 const float* __restrict__ img_dmax, int* __restrict__ rows,
                 unsigned long long* __restrict__ masks, int* __restrict__ n_rows,
                 CullParams p) {
    __shared__ float s_m[MAX_OPS * 12];  // per op the 3x4 world-to-camera rows
    __shared__ float s_zmax[MAX_OPS];
    for (int i = threadIdx.x; i < p.ops * 12; i += blockDim.x) s_m[i] = w2c[i];
    for (int o = threadIdx.x; o < p.ops; o += blockDim.x) {
        const int img = p.img[o];
        float zmax = -1.0f;  // an op the wrapper would reject touches nothing
        if (img >= 0 && img < p.imgs) {
            const float dm = fminf(img_dmax[img], p.depth_max);
            zmax = __fadd_rn(__fadd_rn(dm, p.truncation), __fmul_rn(p.truncation_scale, dm));
        }
        s_zmax[o] = zmax;
    }
    __syncthreads();

    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    int key = EMPTY_KEY;
    if (row < p.n) key = slot_keys[row];
    unsigned long long mask = 0ull;
    if (key != EMPTY_KEY) {
        float X[2], Y[2], Z[2];
        X[0] = __fmul_rn((float)((key & (GRID_DIM - 1)) - GRID_HALF), p.block_extent);
        Y[0] = __fmul_rn((float)(((key >> GRID_BITS) & (GRID_DIM - 1)) - GRID_HALF),
                         p.block_extent);
        Z[0] = __fmul_rn((float)(((key >> (2 * GRID_BITS)) & (GRID_DIM - 1)) - GRID_HALF),
                         p.block_extent);
        X[1] = __fadd_rn(X[0], p.block_extent);
        Y[1] = __fadd_rn(Y[0], p.block_extent);
        Z[1] = __fadd_rn(Z[0], p.block_extent);
        for (int o = 0; o < p.ops; ++o) {
            if (p.sign[o] == 0.0f) continue;
            const float* m = s_m + o * 12;
            float umin = 3.0e38f, umax = -3.0e38f, vmin = 3.0e38f, vmax = -3.0e38f;
            float zmin = 3.0e38f, zmaxc = -3.0e38f;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float x = X[c >> 2], y = Y[(c >> 1) & 1], z = Z[c & 1];
                const float px = affine_row(m, x, y, z);
                const float py = affine_row(m + 4, x, y, z);
                const float pz = affine_row(m + 8, x, y, z);
                const float zs = fmaxf(pz, 1e-3f);
                const float u = __fadd_rn(__fmul_rn(__fdiv_rn(px, zs), p.fx), p.cx);
                const float v = __fadd_rn(__fmul_rn(__fdiv_rn(py, zs), p.fy), p.cy);
                umin = fminf(umin, u);
                umax = fmaxf(umax, u);
                vmin = fminf(vmin, v);
                vmax = fmaxf(vmax, v);
                zmin = fminf(zmin, pz);
                zmaxc = fmaxf(zmaxc, pz);
            }
            bool keep;
            if (zmin > 1e-3f) {  // all corners in front
                keep = (umax >= -0.5f) && (umin <= p.u_hi) && (vmax >= -0.5f) &&
                       (vmin <= p.v_hi) && (zmin <= s_zmax[o]);
            } else {             // straddles the camera plane, or lies behind it
                keep = zmaxc > 0.0f;
            }
            if (keep) mask |= 1ull << o;
        }
    }
    // warp-aggregated append; every thread of the block gets here
    const bool listed = mask != 0ull;
    const unsigned int ballot = __ballot_sync(0xffffffffu, listed);
    if (ballot != 0u) {
        const int lane = threadIdx.x & 31;
        const int leader = __ffs(ballot) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(n_rows, __popc(ballot));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (listed) {
            const int pos = base + __popc(ballot & ((1u << lane) - 1u));
            rows[pos] = row;
            masks[pos] = mask;
        }
    }
}

extern "C" int bf_tsdf_cull(const int* slot_keys, const float* w2c, const float* img_dmax,
                            int* rows, long long* masks, int* n_rows,
                            const float* signs_host, const int* imgs_host, int n, int ops,
                            int imgs, int H, int W, float fx, float fy, float cx, float cy,
                            float block_extent, float truncation, float truncation_scale,
                            float depth_max, void* stream) {
    if (ops > MAX_OPS || ops <= 0 || n < 0 || imgs <= 0) return (int)cudaErrorInvalidValue;
    CullParams p;
    p.n = n;
    p.ops = ops;
    p.imgs = imgs;
    p.fx = fx;
    p.fy = fy;
    p.cx = cx;
    p.cy = cy;
    p.block_extent = block_extent;
    p.u_hi = (float)W - 0.5f;
    p.v_hi = (float)H - 0.5f;
    p.truncation = truncation;
    p.truncation_scale = truncation_scale;
    p.depth_max = depth_max;
    for (int o = 0; o < MAX_OPS; ++o) {
        p.sign[o] = o < ops ? signs_host[o] : 0.0f;
        p.img[o] = o < ops ? imgs_host[o] : 0;
    }
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(n_rows, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    // always launch (an empty table still launches one idle CTA), so one call
    // of the wrapper is one launch
    const unsigned grid = n > 0 ? (unsigned)((n + CULL_THREADS - 1) / CULL_THREADS) : 1u;
    tsdf_cull_kernel<<<grid, CULL_THREADS, 0, st>>>(
        slot_keys, w2c, img_dmax, rows, (unsigned long long*)masks, n_rows, p);
    return (int)cudaGetLastError();
}
