"""Interactive HTTP viewer (app/viewer.py) — the Window/Input/ImGuiLayer
analog. Drives the real server over a socket: page, frame, state, and
every input-message kind (orbit / zoom / path switch / display mode /
flag toggle)."""
import json
import threading
import urllib.request

import numpy as np
import pytest

from hybridrenderer.app.viewer import Viewer, make_server
from hybridrenderer.core.camera import OrbitCamera
from hybridrenderer.core.config import RenderSettings
from hybridrenderer.core.types import (DisplayMode, RenderFlags,
                                           RenderPathType)
from hybridrenderer.runtime.renderer import Renderer
from hybridrenderer.scene import scene as scene_mod


@pytest.fixture(scope="module")
def server_url():
    data = scene_mod.cube_scene().build()
    settings = RenderSettings(
        width=64, height=64, path=RenderPathType.FORWARD,
        flags=RenderFlags.LIGHT | RenderFlags.IBL)
    renderer = Renderer.for_scene(settings, data)
    cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                      yaw=0.6, focal_point=(0, 0.7, 0))
    viewer = Viewer(renderer, cam)
    srv = make_server(viewer, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address
    yield f"http://{host}:{port}", viewer
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def _post(url, msg):
    req = urllib.request.Request(url, data=json.dumps(msg).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_page_and_frame(server_url):
    url, _viewer = server_url
    status, body = _get(url + "/")
    assert status == 200 and b"HybridRenderer" in body
    status, png = _get(url + "/frame.png")
    assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    status, raw = _get(url + "/state")
    state = json.loads(raw)
    assert state["path"] == "forward" and state["size"] == [64, 64]
    assert state["frame"] >= 1


def test_orbit_changes_frame(server_url):
    url, _viewer = server_url
    _, png_a = _get(url + "/frame.png")
    _post(url + "/input", {"orbit": [0.8, 0.2], "zoom": -1.0})
    # frame pipelining keeps ONE frame in flight, so the first fetch
    # after an input may serve the pre-input frame; the second fetch
    # must reflect the moved camera
    _get(url + "/frame.png")
    _, png_b = _get(url + "/frame.png")
    assert png_a != png_b  # camera moved → different pixels


def test_display_mode_switch(server_url):
    url, viewer = server_url
    _, state = _post(url + "/input", {"display": "normal"})
    assert state["display"] == "normal"
    assert viewer.renderer.settings.display_mode == DisplayMode.NORMAL
    _, png = _get(url + "/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    _post(url + "/input", {"display": "final"})


def test_flag_toggle(server_url):
    url, viewer = server_url
    before = viewer.renderer.settings.flags
    _, state = _post(url + "/input", {"toggle": "IBL"})
    assert viewer.renderer.settings.flags == before ^ RenderFlags.IBL
    assert "IBL" not in state["flags"]
    _post(url + "/input", {"toggle": "IBL"})
    assert viewer.renderer.settings.flags == before


def test_bad_input_is_400_not_crash(server_url):
    url, _viewer = server_url
    req = urllib.request.Request(url + "/input", data=b"not json",
                                 method="POST")
    try:
        urllib.request.urlopen(req, timeout=60)
        assert False, "expected HTTPError"
    except urllib.error.HTTPError as e:
        assert e.code == 400
    # server still alive
    status, _ = _get(url + "/state")
    assert status == 200
