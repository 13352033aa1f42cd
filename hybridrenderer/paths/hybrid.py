"""Hybrid render path (HybridRenderPath.cpp:30-104):

GBuffer → [RT shadow+AO / reflections / diffuse GI] → [SVGF ×3 signals] →
Composition → PostProcess. Note: the reference hybrid path has no TAA pass
(HybridRenderPath.cpp:103 comment) — matched here.

RT passes are added only when a ray tracer is wired (the reference skips
them when the device lacks RT support, HybridRenderPath.cpp:44-47; here
"support" = the frame context provides trace hooks).
"""
from __future__ import annotations

from ..core.types import RenderFlags
from ..graph import passes
from ..graph.params import RS
from ..ops.svgf import SVGFConfig
from .base import RenderPath


class HybridRenderPath(RenderPath):
    kind = "hybrid"

    def build_graph(self, graph):
        s = self.settings
        f = s.flags
        self.add(graph, "GBufferPass", passes.make_gbuffer_pass(s), "graphics")

        rt_available = getattr(s, "_rt_available", True)
        want_rt = bool(f & (RenderFlags.SHADOW | RenderFlags.AO
                            | RenderFlags.REFLECTION | RenderFlags.GI))
        have_rt = rt_available and want_rt

        shadow_name, gi_name, refl_name = None, None, None
        variance_name = None
        if have_rt:
            from ..graph import rt_passes  # lazy: needs ops/trace

            if f & (RenderFlags.SHADOW | RenderFlags.AO):
                self.add(graph, "RTShadowPass",
                         rt_passes.make_rt_shadow_pass(s), "raytracing")
                shadow_name = RS.CUR_COLOR
            if f & RenderFlags.REFLECTION:
                self.add(graph, "RTReflectionPass",
                         rt_passes.make_rt_reflection_pass(s), "raytracing")
                refl_name = RS.REFLECTION_RAW
            if f & RenderFlags.GI:
                self.add(graph, "RTDiffuseGIPass",
                         rt_passes.make_rt_gi_pass(s), "raytracing")
                gi_name = RS.GI_RAW

        # SVGF chains (HybridRenderPath.cpp:57-87): ShadowAO no-demod,
        # Reflection demod, GI demod
        svgf_on = bool(f & RenderFlags.SVGF)
        temporal = bool(f & RenderFlags.SVGF_TEMPORAL)
        spatial = bool(f & RenderFlags.SVGF_SPATIAL)
        if svgf_on and (temporal or spatial):
            def cfg(prefix, demod):
                return SVGFConfig(
                    prefix=prefix, atrous_iterations=s.svgf_atrous_iterations,
                    temporal_enabled=temporal, spatial_enabled=spatial,
                    use_albedo_demod=demod, bits=s.svgf_bits)

            # all active chains run as ONE fused pass: per-signal
            # semantics are identical (equality-pinned), but the
            # temporal reprojection tests are computed once and shared
            # (the batched analog of the reference's 3× SVGFPass::Add)
            chains = []
            if shadow_name:
                chains.append((cfg("SVGF_ShadowAO", False), shadow_name,
                               "ShadowAO_Denoised"))
                shadow_name = "ShadowAO_Denoised"
                variance_name = "SVGF_ShadowAO_Variance"
            if refl_name:
                chains.append((cfg("SVGF_Refl", True), refl_name,
                               "Reflection_Denoised"))
                refl_name = "Reflection_Denoised"
            if gi_name:
                chains.append((cfg("SVGF_GI", True), gi_name,
                               "GI_Denoised"))
                gi_name = "GI_Denoised"
            if chains:
                # diagnostic: env SVGF_CHAIN_ORDER="GI,Refl,ShadowAO"
                # reorders the fused chains (position vs signal cost)
                import os

                order = os.environ.get("SVGF_CHAIN_ORDER")
                if order:
                    rank = {f"SVGF_{n.strip()}": i for i, n in
                            enumerate(order.split(","))}
                    chains.sort(key=lambda c: rank.get(c[0].prefix, 99))
                self.add(graph, "SVGFPass",
                         passes.make_svgf_multi_pass(s, chains), "compute")

        self.add(graph, "CompositionPass",
                 passes.make_composition_pass(
                     s, shadow_name or "__none__", gi_name or "__none__",
                     refl_name or "__none__", variance_name), "graphics")
        self.add(graph, "PostProcessPass",
                 passes.make_postprocess_pass(s, RS.FINAL_COLOR), "graphics")
