"""Render graph: validation, Mermaid export, pass ordering."""
import pytest

from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import RenderFlags, RenderPathType
from hybridrenderer.graph.graph import RenderGraph
from hybridrenderer.graph.params import FrameState
from hybridrenderer.paths.factory import create_render_path


def test_undeclared_read_rejected():
    g = RenderGraph(64, 64)
    g.add_pass("p", lambda reg, ctx: {}, reads=("Missing",), writes=("Out",))
    with pytest.raises(ValueError, match="undeclared resource"):
        g.compile()


def test_history_read_needs_saver_or_fallback():
    g = RenderGraph(64, 64)
    g.add_pass("p", lambda reg, ctx: {"Out": 1}, reads=("History_X",),
               writes=("Out",))
    with pytest.raises(ValueError, match="History_X"):
        g.compile()  # nobody saves X and no current-frame X exists
    g.reset()
    g.add_pass("p", lambda reg, ctx: {"Out": 1}, reads=("History_Out",),
               writes=("Out",), save_as_history={"Out": "Out"})
    g.compile()  # self-perpetuating history (TAA pattern) is fine


def test_hybrid_graph_structure():
    s = RenderSettings(width=64, height=64, path=RenderPathType.HYBRID,
                       flags=RenderFlags.default_hybrid())
    path = create_render_path(s)
    names = [p.name for p in path.graph.passes]
    assert names[0] == "GBufferPass"
    assert "RTShadowPass" in names
    # all active SVGF chains run as ONE fused pass (make_svgf_multi_pass)
    assert "SVGFPass" in names
    assert names[-1] == "PostProcessPass"
    assert names.index("RTShadowPass") < names.index("SVGFPass") \
        < names.index("CompositionPass")


def test_mermaid_export():
    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.TAA)
    path = create_render_path(s)
    m = path.export_mermaid()
    assert m.startswith("graph TD")
    assert "TAAPass" in m and "RENDER_OUTPUT" in m


def test_forward_no_rt_passes():
    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT)
    path = create_render_path(s)
    names = [p.name for p in path.graph.passes]
    assert "RTShadowPass" not in names


def test_graph_write_mismatch_raises():
    """A pass producing something other than its declared writes fails
    loudly (the reference's tracked ResourceState caught this at runtime)."""
    g = RenderGraph(8, 8, barrier_passes=False)
    g.add_pass("bad", lambda reg, ctx: {"B": 1}, reads=(), writes=("A",))
    with pytest.raises(ValueError, match="write mismatch"):
        g.execute({}, None, FrameState.empty())


def test_graph_unsatisfiable_history_read_raises():
    g = RenderGraph(8, 8, barrier_passes=False)
    g.add_pass("p", lambda reg, ctx: {"A": 1}, reads=("History_Zed",),
               writes=("A",))
    with pytest.raises(ValueError, match="History_Zed"):
        g.compile()


def test_graph_history_fallback_accepted():
    """History read of a resource that exists current-frame passes
    validation (ReadHistorySafe fallback, RenderGraph.cpp:446-456)."""
    g = RenderGraph(8, 8, barrier_passes=False)
    g.add_pass("prod", lambda reg, ctx: {"A": 1}, reads=(), writes=("A",))
    g.add_pass("cons", lambda reg, ctx: {"B": reg["History_A"]},
               reads=("History_A",), writes=("B",))
    reg, _ = g.execute({}, None, FrameState.empty())
    assert reg["B"] == 1
