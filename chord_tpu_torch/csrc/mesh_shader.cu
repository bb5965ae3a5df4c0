// Kernel K2: mesh-shader draw expansion + homogeneous triangle setup.
//
// Replaces chord_tpu/ops/mesh_shader.py::_mesh_shader_kernel (:58). One
// block per draw slot, one thread per triangle lane (128). Each thread
// transforms its triangle's three corners by the draw's local->clip matrix,
// builds the Olano-Greer cofactor planes, the depth N/D planes and the 5
// attribute numerator planes, the back-face / two-sided cull, the pixel bbox
// and the validity flag, exactly as chord_tpu does on (1,128) lanes. The
// window is then sorted by key*256+lane with key = (invalid, y/8, x/32):
// each lane's rank among the 128 distinct keys (128 compares against keys in
// shared memory) is its output row, the same permutation chord_tpu applies
// with exact one-hot matmuls. Slots >= count write poison blocks (lanes
// 10-12 = -1.0f); block `cap` writes the appended poison window.
//
// Bound by its ~400 f32 operations per triangle and the 128 B coefficient
// row it stores per triangle; the corner loads are coalesced across lanes.
//
// Every product and sum is rounded separately and evaluated in chord_tpu's
// order: the library is built with -fmad=false (a choice a tuned version
// may revisit), so the kernel matches the plain PyTorch version
// (chord_tpu_torch/ops/mesh_shader.py mesh_shader_plain) bit for bit.
//
// Outputs: coef ((cap+1)*128, 32) int32 bit patterns, meta (5, cap*128) f32
// [valid, ix0, iy0, ix1, iy1].

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 128;
constexpr int kCoef = 32;
constexpr int kMeta = 5;
constexpr int kMatStride = 26;
constexpr float kEpsW = 1e-6f;

__device__ __forceinline__ void write_poison(int* row) {
  for (int r = 0; r < kCoef; ++r) {
    row[r] = (r >= 10 && r < 13) ? __float_as_int(-1.0f) : 0;
  }
}

struct Corner {
  float X, Y, w, z, rw;
};

__device__ __forceinline__ Corner corner(const float* __restrict__ pos,
                                         int ncols, int col, int k,
                                         const float* m, float fw, float fh) {
  float x = pos[(4 * k) * ncols + col];
  float y = pos[(4 * k + 1) * ncols + col];
  float z = pos[(4 * k + 2) * ncols + col];
  // row-vector homogeneous transform (w_local = 1); m is row-major 4x4
  float cx = x * m[0] + y * m[4] + z * m[8] + m[12];
  float cy = x * m[1] + y * m[5] + z * m[9] + m[13];
  float cz = x * m[2] + y * m[6] + z * m[10] + m[14];
  float cw = x * m[3] + y * m[7] + z * m[11] + m[15];
  float X = (cx * 0.5f + cw * 0.5f) * fw;
  float Y = (cw * 0.5f - cy * 0.5f) * fh;
  float s = 1.0f / fmaxf(fmaxf(fabsf(X), fabsf(Y)), fmaxf(fabsf(cw), kEpsW));
  Corner c;
  c.X = X * s;
  c.Y = Y * s;
  c.w = cw * s;
  c.z = cz * s;
  c.rw = cw;
  return c;
}

__global__ void __launch_bounds__(kWindow)
mesh_shader_kernel(const int* __restrict__ dm, const int* __restrict__ tcnt,
                   const int* __restrict__ count, const float* __restrict__ mats,
                   const float* __restrict__ posT,
                   const float* __restrict__ attrT, int ncols, int cap,
                   int width, int height, int payload_base, int backface_cull,
                   int sort_tris, int* __restrict__ coef,
                   float* __restrict__ meta) {
  __shared__ float keys[kWindow];
  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t meta_stride = (size_t)cap * kWindow;
  if (i >= count[0]) {   // uniform across the block
    write_poison(coef + ((size_t)i * kWindow + lane) * kCoef);
    if (i < cap) {
      for (int r = 0; r < kMeta; ++r)
        meta[r * meta_stride + (size_t)i * kWindow + lane] = 0.0f;
    }
    return;
  }
  const float* mrow = mats + (size_t)i * kMatStride;
  float m[16], nm[9];
  for (int k = 0; k < 16; ++k) m[k] = mrow[k];
  for (int k = 0; k < 9; ++k) nm[k] = mrow[16 + k];
  const float fw = (float)width, fh = (float)height;
  const int col = dm[i] * kWindow + lane;

  Corner c0 = corner(posT, ncols, col, 0, m, fw, fh);
  Corner c1 = corner(posT, ncols, col, 1, m, fw, fh);
  Corner c2 = corner(posT, ncols, col, 2, m, fw, fh);

  // cofactor rows: l_i = cross(v_j, v_k)
  float l0[3] = {c1.Y * c2.w - c1.w * c2.Y, c1.w * c2.X - c1.X * c2.w,
                 c1.X * c2.Y - c1.Y * c2.X};
  float l1[3] = {c2.Y * c0.w - c2.w * c0.Y, c2.w * c0.X - c2.X * c0.w,
                 c2.X * c0.Y - c2.Y * c0.X};
  float l2[3] = {c0.Y * c1.w - c0.w * c1.Y, c0.w * c1.X - c0.X * c1.w,
                 c0.X * c1.Y - c0.Y * c1.X};
  float det = c0.X * l0[0] + c0.Y * l0[1] + c0.w * l0[2];
  float flip = det < 0.0f ? -1.0f : 1.0f;
  bool front;
  if (backface_cull) {
    bool two_sided = mrow[25] > 0.5f;
    front = (det < 0.0f) || (two_sided && det != 0.0f);
  } else {
    front = det != 0.0f;
  }
  for (int k = 0; k < 3; ++k) {
    l0[k] = flip * l0[k];
    l1[k] = flip * l1[k];
    l2[k] = flip * l2[k];
  }
  float N[3], D[3];
  for (int k = 0; k < 3; ++k) {
    N[k] = l0[k] * c0.z + l1[k] * c1.z + l2[k] * c2.z;
    D[k] = l0[k] * c0.w + l1[k] * c1.w + l2[k] * c2.w;
  }
  // sample at pixel centres: fold +0.5 into the constant terms
  l0[2] = l0[2] + 0.5f * l0[0] + 0.5f * l0[1];
  l1[2] = l1[2] + 0.5f * l1[0] + 0.5f * l1[1];
  l2[2] = l2[2] + 0.5f * l2[0] + 0.5f * l2[1];
  N[2] = N[2] + 0.5f * N[0] + 0.5f * N[1];
  D[2] = D[2] + 0.5f * D[0] + 0.5f * D[1];

  // pixel bbox (full screen when a corner crosses the eye plane)
  bool f0 = c0.rw > kEpsW, f1 = c1.rw > kEpsW, f2 = c2.rw > kEpsW;
  bool all_front = f0 && f1 && f2;
  float iw0 = 1.0f / (f0 ? c0.w : 1.0f);
  float iw1 = 1.0f / (f1 ? c1.w : 1.0f);
  float iw2 = 1.0f / (f2 ? c2.w : 1.0f);
  float sx0 = c0.X * iw0, sx1 = c1.X * iw1, sx2 = c2.X * iw2;
  float sy0 = c0.Y * iw0, sy1 = c1.Y * iw1, sy2 = c2.Y * iw2;
  float xmin = all_front ? fminf(fminf(sx0, sx1), sx2) : 0.0f;
  float xmax = all_front ? fmaxf(fmaxf(sx0, sx1), sx2) : fw;
  float ymin = all_front ? fminf(fminf(sy0, sy1), sy2) : 0.0f;
  float ymax = all_front ? fmaxf(fmaxf(sy0, sy1), sy2) : fh;
  float ix0 = fminf(fmaxf(floorf(xmin), 0.0f), fw - 1.0f);
  float ix1 = fminf(fmaxf(ceilf(xmax), 0.0f), fw - 1.0f);
  float iy0 = fminf(fmaxf(floorf(ymin), 0.0f), fh - 1.0f);
  float iy1 = fminf(fmaxf(ceilf(ymax), 0.0f), fh - 1.0f);
  bool onscreen = (xmax >= 0.0f) && (xmin < fw) && (ymax >= 0.0f) &&
                  (ymin < fh);
  bool covers_center =
      !all_front || ((ceilf(xmin - 0.5f) <= floorf(xmax - 0.5f)) &&
                     (ceilf(ymin - 0.5f) <= floorf(ymax - 0.5f)));
  bool any_front = f0 || f1 || f2;
  bool valid = (lane < tcnt[i]) && front && (det != 0.0f) && onscreen &&
               covers_center && any_front;
  int payload = valid ? (i + payload_base + 1) * kWindow + lane : 0;

  // attribute corners: normals through the normal matrix, uv as is
  float a[3][5];
  for (int k = 0; k < 3; ++k) {
    const float* at = attrT + (size_t)(5 * k) * ncols + col;
    float nx = at[0], ny = at[(size_t)ncols], nz = at[2 * (size_t)ncols];
    a[k][0] = nx * nm[0] + ny * nm[3] + nz * nm[6];
    a[k][1] = nx * nm[1] + ny * nm[4] + nz * nm[7];
    a[k][2] = nx * nm[2] + ny * nm[5] + nz * nm[8];
    a[k][3] = at[3 * (size_t)ncols];
    a[k][4] = at[4 * (size_t)ncols];
  }

  const float validf = valid ? 1.0f : 0.0f;
  int out[kCoef];
  const float raster_rows[15] = {l0[0], l1[0], l2[0], N[0], D[0],
                                 l0[1], l1[1], l2[1], N[1], D[1],
                                 l0[2], l1[2], l2[2], N[2], D[2]};
  for (int r = 0; r < 10; ++r) out[r] = __float_as_int(raster_rows[r] * validf);
  for (int r = 10; r < 15; ++r)
    out[r] = __float_as_int(valid ? raster_rows[r] : -1.0f);
  out[15] = payload;
  for (int r = 16; r < 31; ++r) {
    int k = (r - 16) / 3, comp = (r - 16) % 3;
    float plane = a[0][k] * l0[comp] + a[1][k] * l1[comp] + a[2][k] * l2[comp];
    out[r] = __float_as_int(plane * validf);
  }
  out[31] = 0;
  float mrows[kMeta] = {validf, valid ? ix0 : 1e9f, valid ? iy0 : 1e9f,
                        valid ? ix1 : -1.0f, valid ? iy1 : -1.0f};

  int rank = lane;
  if (sort_tris) {
    // (invalid, y-bucket, x-bucket) key; key*256+lane is an exact distinct
    // f32 integer for every lane
    float x_buckets = (float)((width + 31) / 32);
    float inv_bucket = ((float)((height + 7) / 8) + 1.0f) * x_buckets;
    float key = valid ? floorf(iy0 * 0.125f) * x_buckets +
                            floorf(ix0 * 0.03125f)
                      : inv_bucket;
    float keyj = key * 256.0f + (float)lane;
    keys[lane] = keyj;
    __syncthreads();
    rank = 0;
    for (int j = 0; j < kWindow; ++j) rank += keys[j] < keyj ? 1 : 0;
  }
  int* dst = coef + ((size_t)i * kWindow + rank) * kCoef;
  for (int r = 0; r < kCoef; ++r) dst[r] = out[r];
  for (int r = 0; r < kMeta; ++r)
    meta[r * meta_stride + (size_t)i * kWindow + rank] = mrows[r];
}

}  // namespace

extern "C" int chord_mesh_shader(const void* dm, const void* tcnt,
                                 const void* count, const void* mats,
                                 const void* posT, const void* attrT,
                                 int ncols, int cap, int width, int height,
                                 int payload_base, int backface_cull,
                                 int sort_tris, void* coef, void* meta,
                                 void* stream) {
  mesh_shader_kernel<<<cap + 1, kWindow, 0, (cudaStream_t)stream>>>(
      (const int*)dm, (const int*)tcnt, (const int*)count,
      (const float*)mats, (const float*)posT, (const float*)attrT, ncols, cap,
      width, height, payload_base, backface_cull, sort_tris, (int*)coef,
      (float*)meta);
  return (int)cudaGetLastError();
}
