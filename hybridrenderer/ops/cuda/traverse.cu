// Binary-BVH ray traversal, one thread per ray, called from JAX through
// the XLA foreign function interface (ops/trace_cuda.py).
//
// Node layout (ops/trace_cuda.pack_nodes): every internal node is one
// 64-byte record that stores BOTH children's boxes (Aila & Laine 2009),
// so one visit is one 4 x float4 fetch:
//   [lmin.xyz lmax.x] [lmax.yz rmin.xy] [rmin.z rmax.xyz] [lref rref 0 0]
// A child reference >= 0 is an internal node index; ~ref (< 0) is a leaf
// slot into the triangle records, 48 bytes each:
//   [v0.xyz v1.x] [v1.yz v2.xy] [v2.z tri_id 0 0]
//
// The walk reproduces ops/trace.intersect_bvh step for step: pop a node,
// test both child boxes against the current t, push the far child first
// and the near one last, test leaf triangles with Moller-Trumbore. The
// arithmetic follows ops/trace.ray_triangle / ray_aabb term by term and
// the library is built without FMA contraction, so hits, ties and t
// agree with the jnp reference.
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStackDepth = 64;
constexpr float kTriEps = 1e-9f;
constexpr int kBlock = 128;

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 sub(Vec3 a, Vec3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot(Vec3 a, Vec3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// ray_aabb: slab test against [tmin, tcur]; returns hit, writes tnear.
__device__ __forceinline__ bool slab(Vec3 o, Vec3 inv, float x0, float y0,
                                     float z0, float x1, float y1, float z1,
                                     float tmin, float tcur, float* tnear) {
  float ax = (x0 - o.x) * inv.x, bx = (x1 - o.x) * inv.x;
  float ay = (y0 - o.y) * inv.y, by = (y1 - o.y) * inv.y;
  float az = (z0 - o.z) * inv.z, bz = (z1 - o.z) * inv.z;
  float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  *tnear = tn;
  return (tn <= tf) && (tf >= tmin) && (tn <= tcur);
}

__device__ __forceinline__ float safe_inv(float d) {
  float s = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return 1.0f / s;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(const float4* __restrict__ nodes,
                    const float4* __restrict__ tris,
                    const float* __restrict__ orig,
                    const float* __restrict__ dir,
                    const float* __restrict__ tmax_in,
                    const bool* __restrict__ active, float tmin,
                    int32_t root, int64_t n_rays, float* __restrict__ t_out,
                    int32_t* __restrict__ tri_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (r >= n_rays) return;
  Vec3 o = {orig[3 * r], orig[3 * r + 1], orig[3 * r + 2]};
  Vec3 d = {dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};
  float tcur = tmax_in[r];
  int32_t hit_tri = -1;
  float hit_u = 0.0f, hit_v = 0.0f;

  if (active[r]) {
    Vec3 inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
    int32_t stack[kStackDepth];
    int sp = 0;
    stack[sp++] = root;
    while (sp > 0) {
      int32_t ref = stack[--sp];
      if (ref < 0) {
        const float4* tr = tris + 3 * static_cast<int64_t>(~ref);
        float4 a = __ldg(tr), b = __ldg(tr + 1), c = __ldg(tr + 2);
        Vec3 p0 = {a.x, a.y, a.z}, p1 = {a.w, b.x, b.y},
             p2 = {b.z, b.w, c.x};
        Vec3 e1 = sub(p1, p0), e2 = sub(p2, p0);
        Vec3 pvec = cross(d, e2);
        float det = dot(e1, pvec);
        bool ok = fabsf(det) >= kTriEps;
        float inv_det = 1.0f / (ok ? det : kTriEps);
        Vec3 tvec = sub(o, p0);
        float u = dot(tvec, pvec) * inv_det;
        Vec3 qvec = cross(tvec, e1);
        float v = dot(d, qvec) * inv_det;
        float t = dot(e2, qvec) * inv_det;
        if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin &&
            t <= tcur) {
          tcur = t;
          hit_tri = __float_as_int(c.y);
          hit_u = u;
          hit_v = v;
          if (kAnyHit) break;
        }
      } else {
        const float4* nd = nodes + 4 * static_cast<int64_t>(ref);
        float4 n0 = __ldg(nd), n1 = __ldg(nd + 1), n2 = __ldg(nd + 2),
               n3 = __ldg(nd + 3);
        float lt, rt;
        bool lhit = slab(o, inv, n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, tmin,
                         tcur, &lt);
        bool rhit = slab(o, inv, n1.z, n1.w, n2.x, n2.y, n2.z, n2.w, tmin,
                         tcur, &rt);
        int32_t lref = __float_as_int(n3.x), rref = __float_as_int(n3.y);
        bool l_nearer = lt <= rt;
        int32_t far_ref = l_nearer ? rref : lref;
        int32_t near_ref = l_nearer ? lref : rref;
        bool far_ok = l_nearer ? rhit : lhit;
        bool near_ok = l_nearer ? lhit : rhit;
        if (far_ok && sp < kStackDepth) stack[sp++] = far_ref;
        if (near_ok && sp < kStackDepth) stack[sp++] = near_ref;
      }
    }
  }
  bool missed = hit_tri < 0;
  t_out[r] = missed ? __int_as_float(0x7f800000) : tcur;
  tri_out[r] = hit_tri;
  u_out[r] = hit_u;
  v_out[r] = hit_v;
}

template <bool kAnyHit>
ffi::Error Traverse(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                    ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> orig,
                    ffi::Buffer<ffi::F32> dir, ffi::Buffer<ffi::F32> tmax,
                    ffi::Buffer<ffi::PRED> active, float tmin, int32_t root,
                    ffi::ResultBuffer<ffi::F32> t,
                    ffi::ResultBuffer<ffi::S32> tri,
                    ffi::ResultBuffer<ffi::F32> u,
                    ffi::ResultBuffer<ffi::F32> v) {
  int64_t n = static_cast<int64_t>(tmax.element_count());
  if (orig.element_count() != 3 * static_cast<size_t>(n) ||
      dir.element_count() != 3 * static_cast<size_t>(n) ||
      active.element_count() != static_cast<size_t>(n)) {
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "traverse: ray buffers disagree in length");
  }
  if (n == 0) return ffi::Error::Success();
  int64_t grid = (n + kBlock - 1) / kBlock;
  traverse_kernel<kAnyHit><<<grid, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()), orig.typed_data(),
      dir.typed_data(), tmax.typed_data(), active.typed_data(), tmin, root,
      n, t->typed_data(), tri->typed_data(), u->typed_data(),
      v->typed_data());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

#define HR_TRAVERSE_BINDING                          \
  ffi::Ffi::Bind()                                   \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()      \
      .Arg<ffi::Buffer<ffi::F32>>()                  \
      .Arg<ffi::Buffer<ffi::F32>>()                  \
      .Arg<ffi::Buffer<ffi::F32>>()                  \
      .Arg<ffi::Buffer<ffi::F32>>()                  \
      .Arg<ffi::Buffer<ffi::F32>>()                  \
      .Arg<ffi::Buffer<ffi::PRED>>()                 \
      .Attr<float>("tmin")                           \
      .Attr<int32_t>("root")                         \
      .Ret<ffi::Buffer<ffi::F32>>()                  \
      .Ret<ffi::Buffer<ffi::S32>>()                  \
      .Ret<ffi::Buffer<ffi::F32>>()                  \
      .Ret<ffi::Buffer<ffi::F32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(HrTraverseClosest, Traverse<false>,
                              HR_TRAVERSE_BINDING);
XLA_FFI_DEFINE_HANDLER_SYMBOL(HrTraverseAny, Traverse<true>,
                              HR_TRAVERSE_BINDING);
