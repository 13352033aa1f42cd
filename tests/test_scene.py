"""Scene flattening tests: instances, triangle soup, lights CDF."""
import numpy as np

from hybridrenderer.scene import geometry, scene


def test_cube_mesh_shape():
    m = geometry.cube()
    assert m.num_vertices == 24
    assert m.num_triangles == 12
    n = np.linalg.norm(m.normals, axis=-1)
    np.testing.assert_allclose(n, 1.0, atol=1e-6)
    t = np.linalg.norm(m.tangents[:, :3], axis=-1)
    np.testing.assert_allclose(t, 1.0, atol=1e-5)


def test_sphere_normals_outward():
    m = geometry.uv_sphere(radius=2.0)
    np.testing.assert_allclose(
        m.positions, m.normals * 2.0, atol=1e-5
    )


def test_scene_build_flatten():
    sc = scene.cube_scene()
    data = sc.build()
    assert data.instances.count == 2
    assert data.num_triangles == 2 + 12  # plane + cube
    # instance 1 (cube) world AABB centered at (0, 0.75, 0)
    amin = np.asarray(data.instances.aabb_min[1])
    amax = np.asarray(data.instances.aabb_max[1])
    np.testing.assert_allclose((amin + amax) / 2, [0, 0.75, 0], atol=1e-5)
    # triangle soup world-space: cube triangles centered around y=0.75
    v0 = np.asarray(data.triangles.v0)
    assert v0.shape == (14, 3)
    cube_tris = v0[np.asarray(data.triangles.instance) == 1]
    assert cube_tris[:, 1].min() >= 0.75 - 0.76


def test_objectid_contract():
    """Triangle instance ids index InstanceTable rows (instanceCustomIndex
    contract, Scene.cpp:323-440)."""
    sc = scene.cube_scene()
    data = sc.build()
    inst = np.asarray(data.triangles.instance)
    assert inst.min() == 0 and inst.max() == data.instances.count - 1
    mats = np.asarray(data.instances.material)[inst]
    assert mats.shape == (data.num_triangles,)


def test_emissive_light_cdf():
    sc = scene.cornell_scene()
    data = sc.build()
    assert data.lights.count == 1  # single emissive ceiling quad
    cdf = np.asarray(data.lights.cdf)
    start = int(data.lights.cdf_start[0])
    count = int(data.lights.cdf_count[0])
    assert count == 2  # quad = 2 triangles
    seg = cdf[start:start + count]
    assert np.all(np.diff(seg) > 0) or count == 1
    # total area of 1.5x1.5 quad = 2.25
    np.testing.assert_allclose(seg[-1], 2.25, rtol=1e-5)


def test_no_lights_in_cube_scene():
    data = scene.cube_scene().build()
    assert data.lights.count == 0


def test_stress_scene_scale():
    sc = scene.stress_scene(num_objects=20, seed=1)
    data = sc.build()
    assert data.num_triangles > 1000
    assert data.instances.count == len(sc.entities)


def test_blue_noise_distribution():
    data = scene.cube_scene().build()
    bn = np.asarray(data.blue_noise)
    assert bn.shape == (64, 64, 4)
    assert 0.45 < bn.mean() < 0.55
    assert bn.min() >= 0.0 and bn.max() <= 1.0
