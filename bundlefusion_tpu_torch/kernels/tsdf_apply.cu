// Fused multi-op TSDF integrate / de-integrate sweep, in place, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `_apply_kernel` of
// bundlefusion_tpu/tsdf/apply_pallas.py:104-551 (launched by
// `apply_tsdf_ops`, :644-787, `pl.pallas_call` at :742). It computes what
// the plain version `apply_tsdf_ops_ref`
// (bundlefusion_tpu_torch/tsdf/apply_ops.py) computes, bit for bit, over
// the payload rows that the cull kernel (tsdf_cull.cu) listed on the card.
//
// What bounds it. Bytes: each listed row moves 10 KB in (sdf 2 KB + weight
// 2 KB + colour 6 KB) and 10 KB out, ~6 ns a row at 3.35 TB/s, plus each op
// image once (16 bytes a pixel). A 1-op batch runs near that bound. A batch
// of many ops does not: the op loop is ~150 machine instructions per voxel and
// op (18 for the projection, ~10 for each of three IEEE divisions, the rest
// gates, the gather's address and the update), so at ~9 ops a row the card's
// instruction rate, not its memory, sets the time.
//
// Design, and what each part is for.
// - Persistent grid. The launch has a fixed number of CTAs (as many as the
//   card holds at once, from the occupancy query) that stride over the row
//   list up to a count read from device memory. The host therefore needs
//   neither the list nor its length: the launch is enqueued right behind the
//   cull, and nothing waits.
// - Per-row op masks. The cull gives each row the bit mask of the ops whose
//   frustum can touch it; the op loop walks only those bits, ascending, so
//   array order is kept. Skipping an op the cull excluded is bitwise the
//   same as running it: its update gate is false for every voxel of the
//   block, and a false gate leaves the voxel unchanged.
// - One CTA iteration per row, 512 threads, one thread per voxel of the 8^3
//   block: sdf, weight and three colour channels are read once (coalesced),
//   the row's ops are applied in registers, and each is written once. The
//   next row's index and mask are fetched an iteration ahead and the row's
//   key beside its payload, so a row costs one round trip to device memory.
// - One 16-byte gather per voxel and op: the image pass (tsdf_prepare.cu)
//   packed each pixel as (d_q, r_q, g_q, b_q), so depth and colour arrive in
//   one load from L1 / L2 (an image is 1.2 MB).
// - Fewer instructions per op: the mask is walked in 32-bit halves, the pixel
//   index is 32-bit, and the voxel's offset inside the block is hoisted.
// - Per-op world-to-camera rows are staged in shared memory once per CTA;
//   signs and image indices come in the kernel's arguments.
// Nothing else of the TPU design carries over: no one-hot MXU sampling
// windows, no DMA double-buffering, no 128-lane geometry rows.
//
// Exactness. Built with --fmad=false and without fast math, and written
// with __fmul_rn/__fadd_rn/__fdiv_rn, so no multiply-add is contracted (a
// contracted FMA can move a voxel to the neighbouring pixel). Pixel
// coordinates round half-to-even (rintf, as torch.round and jnp.round do),
// in the order (px / max(z, 1e-6)) * fx + cx. A voxel whose update gate is
// false is left bitwise unchanged, which is what the plain version computes
// for it; sign-0 ops are skipped; dead rows are skipped.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK_VOL 512
#define MAX_OPS 64
#define GRID_BITS 10
#define GRID_DIM (1 << GRID_BITS)
#define GRID_HALF (GRID_DIM / 2)
#define EMPTY_KEY 0x7fffffff
// CTAs per SM the register budget is held to. 3 gives 40 registers and no
// spills; 4 (32 registers) spills 16 bytes and measured no faster on an H100.
#define APPLY_MIN_CTAS 3

// ((m0 * x + m1 * y) + m2 * z) + m3, every product and sum rounded: one row
// of a world-to-camera transform, in the plain version's order
__device__ __forceinline__ float affine_row(const float* m, float x, float y, float z) {
    const float xy = __fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y));
    return __fadd_rn(__fadd_rn(xy, __fmul_rn(m[2], z)), m[3]);
}

struct ApplyParams {
    int ops;
    int imgs;
    int H;
    int W;
    float fx, fy, cx, cy;
    float voxel_size;
    float block_extent;  // BLOCK_SIZE * voxel_size, rounded once to float
    float truncation;
    float truncation_scale;
    float depth_min;
    float depth_max;     // min(depth_max, max_integration_distance)
    float w_sample;
    float w_max;
    float sign[MAX_OPS];
    int img[MAX_OPS];
};

__global__ void __launch_bounds__(BLOCK_VOL, APPLY_MIN_CTAS)
tsdf_apply_kernel(float* __restrict__ sdf, float* __restrict__ weight,
                  float* __restrict__ color, const int* __restrict__ rows,
                  const unsigned long long* __restrict__ masks,
                  const int* __restrict__ n_rows, const int* __restrict__ slot_keys,
                  const float4* __restrict__ packed, const float* __restrict__ w2c,
                  ApplyParams p) {
    __shared__ float s_m[MAX_OPS * 12];  // per op the 3x4 world-to-camera rows
    for (int i = threadIdx.x; i < p.ops * 12; i += blockDim.x) s_m[i] = w2c[i];
    __syncthreads();

    const int t = threadIdx.x;
    const float ox = __fmul_rn(__fadd_rn((float)(t % 8), 0.5f), p.voxel_size);
    const float oy = __fmul_rn(__fadd_rn((float)((t / 8) % 8), 0.5f), p.voxel_size);
    const float oz = __fmul_rn(__fadd_rn((float)(t / 64), 0.5f), p.voxel_size);
    const int plane = p.H * p.W;
    const float wf = (float)p.W, hf = (float)p.H;
    const int n = *n_rows;  // written by the cull, an earlier launch on this stream

    // the next row's index and mask are fetched one iteration ahead, and the
    // key travels with the payload loads, so a row waits for one round trip
    // to device memory, not three in a chain
    int i = blockIdx.x;
    int row = 0;
    unsigned long long todo = 0ull;
    if (i < n) {
        row = rows[i];
        todo = masks[i];
    }
    for (; i < n; i += gridDim.x) {
        const int i_next = i + gridDim.x;
        int row_next = 0;
        unsigned long long todo_next = 0ull;
        if (i_next < n) {
            row_next = rows[i_next];
            todo_next = masks[i_next];
        }
        const size_t base = (size_t)row * BLOCK_VOL + t;
        const size_t cbase = (size_t)row * (3 * BLOCK_VOL) + t;
        const int key = slot_keys[row];
        float s = sdf[base];
        float w = weight[base];
        float cr = color[cbase];
        float cg = color[cbase + BLOCK_VOL];
        float cb = color[cbase + 2 * BLOCK_VOL];
        row = row_next;
        if (key == EMPTY_KEY) {  // dead row: the update gate is false everywhere
            todo = todo_next;
            continue;
        }

        const float wx = __fadd_rn(
            __fmul_rn((float)((key & (GRID_DIM - 1)) - GRID_HALF), p.block_extent), ox);
        const float wy = __fadd_rn(
            __fmul_rn((float)(((key >> GRID_BITS) & (GRID_DIM - 1)) - GRID_HALF), p.block_extent),
            oy);
        const float wz = __fadd_rn(
            __fmul_rn((float)(((key >> (2 * GRID_BITS)) & (GRID_DIM - 1)) - GRID_HALF),
                      p.block_extent),
            oz);

        // the mask is walked as two 32-bit halves: a 64-bit find-first-set is
        // a dozen instructions on this card, a 32-bit one is one
        for (int half = 0; half < 2; ++half) {
            unsigned int bits = half == 0 ? (unsigned int)todo : (unsigned int)(todo >> 32);
            while (bits != 0u) {
                const int o = half * 32 + __ffs((int)bits) - 1;
                bits &= bits - 1u;
                if (o >= p.ops) break;
                const float sign = p.sign[o];
                if (sign == 0.0f) continue;
                const int img = p.img[o];
                // the wrapper rejects such ops; this keeps a bad argument from
                // reading outside the images
                if (img < 0 || img >= p.imgs) continue;
                const float* m = s_m + o * 12;
                const float px = affine_row(m, wx, wy, wz);
                const float py = affine_row(m + 4, wx, wy, wz);
                const float z = affine_row(m + 8, wx, wy, wz);
                const float zs = fmaxf(z, 1e-6f);
                const float uf = rintf(__fadd_rn(__fmul_rn(__fdiv_rn(px, zs), p.fx), p.cx));
                const float vf = rintf(__fadd_rn(__fmul_rn(__fdiv_rn(py, zs), p.fy), p.cy));
                const bool inb =
                    (uf >= 0.0f) && (uf < wf) && (vf >= 0.0f) && (vf < hf) && (z > 0.0f);
                if (!inb) continue;
                // 32-bit pixel index: the launcher holds imgs * H * W below 2^31
                const float4 smp = __ldg(packed + (img * plane + (int)vf * p.W + (int)uf));
                const float d = smp.x;
                if (!(d >= p.depth_min && d <= p.depth_max)) continue;
                const float sd = __fsub_rn(d, z);
                const float trunc = __fadd_rn(__fmul_rn(d, p.truncation_scale), p.truncation);
                if (!(sd > -trunc)) continue;
                // the update gate is true from here on
                const float sd_cl = fminf(sd, trunc);
                const float w_new = __fmul_rn(p.w_sample, sign);
                const float new_w = fminf(fmaxf(__fadd_rn(w, w_new), 0.0f), p.w_max);
                const float applied = __fsub_rn(new_w, w);
                if (applied != 0.0f) {
                    const float sum_sdf = __fadd_rn(__fmul_rn(s, w), __fmul_rn(sd_cl, applied));
                    s = (new_w > 0.0f) ? __fdiv_rn(sum_sdf, fmaxf(new_w, 1e-12f)) : 0.0f;
                }
                cr = fmaxf(__fadd_rn(cr, __fmul_rn(smp.y, applied)), 0.0f);
                cg = fmaxf(__fadd_rn(cg, __fmul_rn(smp.z, applied)), 0.0f);
                cb = fmaxf(__fadd_rn(cb, __fmul_rn(smp.w, applied)), 0.0f);
                w = new_w;
            }
        }
        sdf[base] = s;
        weight[base] = w;
        color[cbase] = cr;
        color[cbase + BLOCK_VOL] = cg;
        color[cbase + 2 * BLOCK_VOL] = cb;
        todo = todo_next;
    }
}

// CTAs of the sweep that the current card holds at once (0 on failure).
extern "C" int bf_tsdf_apply_wave() {
    static int wave[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (wave[dev] == 0) {
        int sms = 0, per_sm = 0;
        cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tsdf_apply_kernel,
                                                                BLOCK_VOL, 0);
        if (err != cudaSuccess) return 0;
        wave[dev] = sms * per_sm;
    }
    return wave[dev];
}

extern "C" int bf_tsdf_apply(float* sdf, float* weight, float* color, const int* rows,
                             const long long* masks, const int* n_rows, const int* slot_keys,
                             const float* packed, const float* w2c, const float* signs_host,
                             const int* imgs_host, int ops, int imgs, int H, int W,
                             int grid_ctas, float fx, float fy, float cx, float cy,
                             float voxel_size, float block_extent, float truncation,
                             float truncation_scale, float depth_min, float depth_max,
                             float w_sample, float w_max, void* stream) {
    if (ops > MAX_OPS || ops <= 0 || imgs <= 0 || H <= 0 || W <= 0 ||
        (long long)imgs * H * W >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    if (grid_ctas <= 0) grid_ctas = bf_tsdf_apply_wave();
    if (grid_ctas <= 0) return (int)cudaErrorInvalidConfiguration;
    ApplyParams p;
    p.ops = ops;
    p.imgs = imgs;
    p.H = H;
    p.W = W;
    p.fx = fx;
    p.fy = fy;
    p.cx = cx;
    p.cy = cy;
    p.voxel_size = voxel_size;
    p.block_extent = block_extent;
    p.truncation = truncation;
    p.truncation_scale = truncation_scale;
    p.depth_min = depth_min;
    p.depth_max = depth_max;
    p.w_sample = w_sample;
    p.w_max = w_max;
    for (int o = 0; o < MAX_OPS; ++o) {
        p.sign[o] = o < ops ? signs_host[o] : 0.0f;
        p.img[o] = o < ops ? imgs_host[o] : 0;
    }
    tsdf_apply_kernel<<<(unsigned)grid_ctas, BLOCK_VOL, 0, (cudaStream_t)stream>>>(
        sdf, weight, color, rows, (const unsigned long long*)masks, n_rows, slot_keys,
        (const float4*)packed, w2c, p);
    return (int)cudaGetLastError();
}
