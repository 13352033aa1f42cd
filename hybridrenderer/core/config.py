"""Static render configuration.

The reference routes all configuration through a UBO + RenderFlags bitmask
read dynamically by shaders (SURVEY §5.6). Here we split:

* ``RenderSettings`` — *static*, hashable: anything that changes the traced
  program structure (resolution, which passes exist, SVGF iteration count,
  kernel backend). It is the jit cache key — the analog of the reference's
  PipelineManager name+spec-constant pipeline cache (PipelineManager.cpp:89-103).
* ``FrameParams`` (graph/passes.py) — *traced*: camera matrices, sun light,
  exposure, svgf alpha/phi, frame counter. Changing these never recompiles.
"""
from __future__ import annotations

import dataclasses

from .types import DisplayMode, RenderFlags, RenderPathType


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    width: int = 512
    height: int = 512
    path: RenderPathType = RenderPathType.FORWARD
    flags: RenderFlags = RenderFlags.LIGHT | RenderFlags.IBL
    display_mode: DisplayMode = DisplayMode.FINAL

    # SVGF structure (SVGFPass.h:82-101: Config{atrousIterations=3, ...})
    svgf_atrous_iterations: int = 3

    # Kernel selection per layer (ops/backend.py): "auto" (kernels on
    # the GPU, jnp references on the CPU), "jnp" or "kernel".
    raster_backend: str = "auto"
    trace_backend: str = "auto"

    # Hit-shading attribute fetch: None → env SHADE_FETCH → "auto"
    # (scene.shade_rows u16 fast-gather table when present, else the
    # f32 attr_rows wide row, else the narrow per-attribute gathers);
    # "attr" forces attr_rows, "pixel" forces the narrow path.
    # A settings field (static) so in-process A/Bs retrace instead of
    # silently reusing the first-traced variant.
    shade_fetch: "str | None" = None
    # Back-face culling of opaque single-sided triangles ("back") or
    # two-sided rendering of everything ("none"). The reference culls
    # back faces in the forward pipeline (ForwardPass.cpp:45) and
    # renders the G-buffer two-sided (GBufferPass.cpp:74); "back" +
    # per-material double_sided/cut-out exemptions preserves both
    # intents while halving live raster candidates on closed meshes.
    raster_cull: str = "back"

    # Ray tracing
    bvh_leaf_size: int = 4
    # Acceleration-structure build: "auto" (= binned SAH, the
    # PREFER_FAST_TRACE analog), "sah", or "lbvh" (fast build; also what
    # dynamic refits preserve topologically).
    bvh_builder: str = "auto"
    ao_radius: float = 10.0  # rt_shadow.rgen:96 traces AO rays to 10 units
    # Interleaved AO sampling (one direction per 8×8 block pattern per
    # frame + pattern-major relayout) — direction-coherent AO rays.
    # False reproduces the reference's per-pixel draw (rt_shadow.rgen:85-96).
    ao_interleaved: bool = True
    # Ray order for interleaved-AO rays: "pattern" groups rays by
    # interleave pattern (shared direction), "tile" groups by 32×32
    # pixel tile (compact origin footprint, mixed directions). Results
    # are identical (pure relayout).
    ao_layout: str = "tile"
    # Interleaved GI bounce sampling — the AO trick applied to the
    # diffuse-GI cosine rays (diffuse_gi.rgen:30-40 draws per-pixel):
    # one bounce direction per block pattern per frame, decorrelated
    # from AO by seed salt; SVGF temporal accumulation integrates the
    # per-frame pattern rotations exactly as for AO. False reproduces
    # the reference's per-pixel draw.
    gi_interleaved: bool = True
    # Ray order for interleaved-GI rays: "tile" | "pattern"
    # (trace_radiance relayout; see ao_layout).
    gi_layout: str = "tile"
    # Interleave block size (pixels) for the AO / GI pattern samplers:
    # one direction per block pattern per frame; SVGF integrates the
    # coarser noise structure. These sizes change images, and the
    # goldens pin block=8 explicitly. They were sized for an earlier
    # accelerator's ray packets and await an H100 re-decision (ROADMAP).
    ao_block: int = 128
    gi_block: int = 64

    # Reflection roughness cutoff (reflection.rgen:55-63)
    reflection_roughness_cutoff: float = 0.6
    # Half-resolution secondary rays (reflection / diffuse GI) with
    # depth-aware upsample, off by default for reference parity (reflection.rgen / diffuse_gi.rgen
    # trace full-res). reflection_half_res is production-grade
    # (converged err mean 0.38 / p99 1 u8, gate in
    # tests/test_half_res_ao.py); gi_half_res is EXPERIMENTAL — its
    # converged error is p99 ~32 u8 (visible banding territory; the
    # half-grid interleave pattern interacts with the block-shared
    # directions) and its gate only bounds regression, not quality.
    # Use for previews, not comparisons.
    reflection_half_res: bool = False
    gi_half_res: bool = False

    # SVGF history-plane storage width: 16 (bf16 — DEFAULT; the
    # reference's RGBA16F analog, SVGFPass.cpp:24-164; halves history
    # HBM traffic, filter math stays f32) or 32 (f32 exact). Quality is
    # gated by tests/test_svgf_bits.py (8-frame drift vs the f32 chain)
    # and the golden ladder is generated under this default — a width
    # change must regenerate goldens AND pass the drift gate.
    svgf_bits: int = 16
    # Pass-output materialization barriers (graph/graph.py): "multi"
    # barriers only fan-out resources (>= 2 consumers / history saves),
    # "all" barriers every pass output (round-1 behavior), "none"
    # disables. The vkCmdPipelineBarrier2-ladder analog.
    graph_barriers: str = "multi"

    # Blue-noise sample draws for 1-spp GI / per-pixel AO (the reference
    # fetches a tiled blue-noise texture with a per-frame integer offset,
    # raygen.rgen:29-31, common.glsl:86-92). False falls back to the TEA
    # hash draws of rt_shadow.rgen:53.
    use_blue_noise: bool = True

    # DIAGNOSTIC ONLY — truncates trace_radiance so frame-level A/B
    # ladders can attribute the in-frame cost of a radiance pass.
    # "full" (default) | "noshade" (closest-hit
    # traversal only; hits shade to black) | "noocc" (full shading math
    # but the sun/NEE occlusion traversals are skipped — treated as
    # unoccluded) | "noattr" (noocc + constant surface attributes: no
    # attr-row gather) | "nonee" (noocc + emissive-light NEE block
    # skipped). Never set in production configs.
    debug_radiance_stage: str = "full"

    def has(self, flag: RenderFlags) -> bool:
        return bool(self.flags & flag)

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @property
    def resolution(self):
        return (self.height, self.width)
