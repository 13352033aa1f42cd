"""Shared enums/flags — the CPU/GPU ABI of the reference.

Mirrors ShaderCommon.h:38-115 (MaterialType, DisplayMode, RenderFlags).
Unlike the reference these never cross an ABI boundary: arrays are plain
pytrees, so only the *semantics* are kept.
"""
from __future__ import annotations

import enum


INVALID_ID = -1


class MaterialType(enum.IntEnum):  # ShaderCommon.h:41-48
    MATTE = 0
    PBR = 1
    VOLUMETRIC = 2
    GLASS = 3
    SUBSURFACE = 4


class DisplayMode(enum.IntEnum):  # ShaderCommon.h:50-62
    FINAL = 0
    ALBEDO = 1
    NORMAL = 2
    MATERIAL = 3
    MOTION = 4
    DEPTH = 5
    SHADOW = 6
    AO = 7
    REFLECTION = 8
    GI = 9
    EMISSIVE = 10
    SVGF_VARIANCE = 11


class RenderFlags(enum.IntFlag):  # ShaderCommon.h:64-80
    NONE = 0
    LIGHT = 1 << 0
    SHADOW = 1 << 1
    AO = 1 << 2
    REFLECTION = 1 << 3
    GI = 1 << 4
    TAA = 1 << 5
    TAA_HISTORY = 1 << 6
    SVGF = 1 << 7
    SVGF_TEMPORAL = 1 << 8
    SVGF_SPATIAL = 1 << 9
    IBL = 1 << 10
    EMISSIVE = 1 << 11

    @classmethod
    def default_hybrid(cls) -> "RenderFlags":
        """EditorLayer.cpp:41-60 default flag set."""
        return (
            cls.LIGHT | cls.SHADOW | cls.SVGF | cls.SVGF_TEMPORAL
            | cls.SVGF_SPATIAL | cls.IBL | cls.AO | cls.EMISSIVE
        )


class RenderPathType(enum.IntEnum):  # RenderPathFactory.cpp:9-22
    FORWARD = 0
    HYBRID = 1
    RAYTRACED = 2
