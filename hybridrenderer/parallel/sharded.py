"""Sharded frame execution — pjit the whole frame over a device mesh.

Strategy (SURVEY §2.9 / §5.8 design): one traced frame program, GSPMD-
partitioned. Image-space tensors (visibility buffer, G-buffer planes,
SVGF/TAA history, output) are sharded over rows (`P('y')`); scene,
camera, params are replicated. XLA then:

  * splits the jnp raster's edge-function/depth-resolve loops row-wise
    (each device rasterizes the full triangle list against its rows —
    raster is embarrassingly data-parallel in screen space),
  * inserts halo collective-permutes for the shifted reads in SVGF/TAA
    stencils,
  * runs ray passes on each device's own pixels (BVH replicated, so no
    ray forwarding is needed; see SURVEY §5.7).

GSPMD cannot partition a custom call (the CUDA traversal, the Triton
raster kernel): it would replicate it. Those calls run under
``jax.shard_map`` on each device's rows instead — the only manual
sharding decisions in the frame.
"""
from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..graph.params import FrameState
from ..graph.passes import FrameContext
from ..ops import backend, raster_tile


def _state_shardings(state: FrameState, mesh, axis: str):
    """History images are (H, W, ...) → shard rows; scalars replicated."""

    def spec(x):
        if hasattr(x, "ndim") and x.ndim >= 2:
            return NamedSharding(mesh, P(axis))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(spec, state)


class ShardedRenderer:
    """Multi-chip wrapper around a RenderPath: same API as the
    single-chip Renderer but the jitted frame is GSPMD-sharded."""

    def __init__(self, settings, scene_data, mesh, axis: str = "y",
                 tracer=None, shard_rays: bool = True):
        from ..paths.factory import create_render_path

        self.settings = settings
        self.scene = scene_data
        self.mesh = mesh
        self.axis = axis
        self.path = create_render_path(settings)
        self.tracer = tracer
        # Ray passes are communication-free under row sharding (BVH
        # replicated), but GSPMD treats a kernel call as opaque and would
        # all-gather its inputs and replicate the launch. shard_map pins
        # the traversal to each device's own rows instead.
        self.shard_rays = shard_rays and tracer is not None
        self.state = FrameState.empty()
        self.frame_count = 0
        self._fns = {}
        if settings.height % mesh.devices.size != 0:
            raise ValueError(
                f"height {settings.height} not divisible by mesh size "
                f"{mesh.devices.size}")

    @classmethod
    def for_scene(cls, settings, scene_data, mesh, **kw):
        """Construct with RT hooks auto-attached (Renderer.for_scene
        analog); the tracer's packed arrays are replicated per chip."""
        from ..core.types import RenderFlags, RenderPathType

        tracer = None
        needs_rt = (settings.path == RenderPathType.RAYTRACED) or bool(
            settings.flags & (RenderFlags.SHADOW | RenderFlags.AO
                              | RenderFlags.REFLECTION | RenderFlags.GI))
        if needs_rt:
            from ..ops import trace as trace_ops

            tracer = trace_ops.SceneTracer.build(scene_data, settings)
        return cls(settings, scene_data, mesh, tracer=tracer, **kw)

    def _get_frame_fn(self, history_valid: bool):
        if history_valid in self._fns:
            return self._fns[history_valid]

        path, settings = self.path, self.settings
        mesh, axis = self.mesh, self.axis
        has_tracer = self.tracer is not None
        shard_rays = self.shard_rays
        raster_kernel = backend.resolve(settings.raster_backend) == "kernel"
        out_sharding = NamedSharding(mesh, P(axis))

        def frame(scene, host_packed, state, tracer):
            from ..core.camera import CameraState
            from ..graph.params import FrameParams

            cam_state = CameraState.unpack(host_packed)
            off = CameraState.PACKED_SIZE
            params = FrameParams(
                sun_direction=scene.sun.direction,
                sun_color=scene.sun.color,
                sun_intensity=scene.sun.intensity,
                ambient_strength=scene.sun.ambient,
                exposure=host_packed[off],
                svgf_phi=host_packed[off + 1:off + 5],
                frame_index=host_packed[off + 5].astype(jax.numpy.uint32),
            )
            shadow_query = None
            trace_radiance = None
            img = P(axis)
            rasterize = None
            if raster_kernel:
                n_dev = mesh.devices.size
                h_local = settings.height // n_dev

                def rasterize(tris):
                    def local(tris_):
                        row0 = jax.lax.axis_index(axis) * h_local
                        return raster_tile.rasterize(
                            tris_, settings.width, h_local, row0)

                    return jax.shard_map(
                        local, mesh=mesh, in_specs=(P(),), out_specs=img,
                        check_vma=False)(tris)
            if has_tracer:
                if shard_rays:
                    def shadow_query(p, n, d, t, active=None, **kw):
                        if active is None:
                            active = jax.numpy.ones(p.shape[:2], bool)

                        def local(sc_, tr_, p_, n_, d_, a_):
                            return tr_.shadow_query(sc_, p_, n_, d_, t,
                                                    active=a_, **kw)

                        return jax.shard_map(
                            local, mesh=mesh,
                            in_specs=(P(), P(), img, img, img, img),
                            out_specs=img, check_vma=False,
                        )(scene, tracer, p, n, d, active)

                    def trace_radiance(o, d, c, dep, active=None,
                                       layout="tile"):
                        if active is None:
                            active = jax.numpy.ones(o.shape[:-1], bool)

                        # minimal per-shard context: trace shading uses
                        # only params (traced, passed through) + settings
                        # (static) — never cam/state
                        def local(sc_, tr_, params_, o_, d_, a_):
                            ctx_ = FrameContext(
                                scene=sc_, cam=None, params=params_,
                                settings=settings, state=None,
                                history_valid=False)
                            # global pixel index base for the NEE seed
                            # stream: shard row offset × row width, so
                            # sharded == single-device bit-for-bit
                            off = (jax.lax.axis_index(axis)
                                   * (o_.shape[0] * o_.shape[1])
                                   ).astype(jax.numpy.uint32)
                            return tr_.trace_radiance(sc_, o_, d_, ctx_,
                                                      dep, active=a_,
                                                      pix_offset=off,
                                                      layout=layout)

                        return jax.shard_map(
                            local, mesh=mesh,
                            in_specs=(P(), P(), P(), img, img, img),
                            out_specs=(img, img), check_vma=False,
                        )(scene, tracer, c.params, o, d, active)
                else:
                    def shadow_query(p, n, d, t, active=None, **kw):
                        return tracer.shadow_query(scene, p, n, d, t,
                                                   active=active, **kw)

                    def trace_radiance(o, d, c, dep, active=None, **kw):
                        return tracer.trace_radiance(scene, o, d, c, dep,
                                                     active=active, **kw)
            ctx = FrameContext(
                scene=scene, cam=cam_state, params=params, settings=settings,
                state=state, history_valid=history_valid,
                shadow_query=shadow_query, trace_radiance=trace_radiance,
                rasterize=rasterize)
            out, new_state, _ = path.run(ctx, state)
            out = jax.lax.with_sharding_constraint(out, out_sharding)
            return out, new_state

        fn = jax.jit(frame, donate_argnums=(2,))
        self._fns[history_valid] = fn
        return fn

    def render(self, cam_state, exposure: float = 1.0,
               svgf_phi=(4.0, 128.0, 0.02, 0.0)):
        import numpy as np

        packed = np.concatenate([
            cam_state.pack(),
            np.asarray([exposure], np.float32),
            np.asarray(svgf_phi, np.float32),
            np.asarray([self.frame_count], np.float32),
        ])
        fn = self._get_frame_fn(self.frame_count > 0)
        with self.mesh:
            out, self.state = fn(self.scene, packed, self.state, self.tracer)
        self.frame_count += 1
        return out
