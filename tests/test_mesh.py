"""Tests for voxel refinement, marching cubes, welding and the full pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest

from bsdmg_tpu.config import MeshGenConfig
from bsdmg_tpu.mesh import (
    create_voxel_field,
    generate_mesh,
    refine_field,
    triangles_to_mesh,
)
from bsdmg_tpu.mesh.pipeline import field_to_triangles
from bsdmg_tpu.models import reference_object, sphere_scene
from bsdmg_tpu.ops.compact import compact
from bsdmg_tpu.ops.tables import (
    MC_CASE_TRIANGLE_COUNT,
    MC_CORNER_OFFSETS,
    MC_EDGE_TABLE,
    MC_TRIANGLE_CASES,
)

SPHERE = sphere_scene(1.0).bind()


class TestCompact:
    def test_basic(self):
        data = jnp.arange(10, dtype=jnp.float32).reshape(10, 1)
        mask = jnp.asarray([1, 0, 1, 0, 0, 1, 1, 0, 0, 1], bool)
        out, count = compact(data, mask)
        assert int(count) == 5
        np.testing.assert_array_equal(
            np.asarray(out[:5, 0]), [0.0, 2.0, 5.0, 6.0, 9.0]
        )

    def test_capacity_overflow_detectable(self):
        data = jnp.ones((8, 2))
        mask = jnp.ones(8, bool)
        out, count = compact(data, mask, capacity=4)
        assert int(count) == 8  # true count reported
        assert out.shape == (4, 2)

    def test_empty_mask(self):
        data = jnp.ones((4, 3))
        out, count = compact(data, jnp.zeros(4, bool), fill=7.0)
        assert int(count) == 0
        assert np.all(np.asarray(out) == 7.0)


class TestTables:
    def test_case_counts(self):
        # empty cases have no triangles; single-corner cases have exactly one
        assert MC_CASE_TRIANGLE_COUNT[0] == 0
        assert MC_CASE_TRIANGLE_COUNT[255] == 0
        for corner in range(8):
            assert MC_CASE_TRIANGLE_COUNT[1 << corner] == 1
            # complement cases triangulate the same (single-vertex) surface
            assert MC_CASE_TRIANGLE_COUNT[255 ^ (1 << corner)] == 1

    def test_edges_reference_valid_corners(self):
        assert MC_EDGE_TABLE.shape == (12, 2)
        assert MC_EDGE_TABLE.min() == 0 and MC_EDGE_TABLE.max() == 7
        # every edge connects corners that differ in exactly one axis
        diffs = MC_CORNER_OFFSETS[MC_EDGE_TABLE[:, 0]] - MC_CORNER_OFFSETS[MC_EDGE_TABLE[:, 1]]
        assert np.all(np.abs(diffs).sum(axis=1) == 1)

    def test_triangle_edges_in_range(self):
        used = MC_TRIANGLE_CASES[MC_TRIANGLE_CASES >= 0]
        assert used.min() >= 0 and used.max() <= 11

    def test_case_edges_straddle_surface(self):
        # every edge used by a case must connect an inside to an outside corner
        for case in range(256):
            inside = [(case >> i) & 1 for i in range(8)]
            for tri in MC_TRIANGLE_CASES[case]:
                for e in tri:
                    if e < 0:
                        continue
                    c0, c1 = MC_EDGE_TABLE[e]
                    assert inside[c0] != inside[c1], (case, e)


class TestVoxelField:
    def test_initial_field(self):
        cfg = MeshGenConfig(init_factor=8, bb_size=4.0)
        field = create_voxel_field(cfg)
        assert field.count == 512
        assert np.isclose(field.voxel_size, 0.5)
        lows = field.to_numpy()
        assert lows.min() == -2.0
        assert np.isclose(lows.max(), 2.0 - 0.5)

    def test_refine_keeps_only_border(self):
        cfg = MeshGenConfig(init_factor=8, bb_size=4.0)
        field = create_voxel_field(cfg)
        refined = refine_field(SPHERE, field, cfg)
        assert refined.voxel_size == 0.25
        assert 0 < refined.count < field.count * 8
        # every surviving voxel straddles the sphere: |sd(center)| <= half diag
        lows = refined.to_numpy()
        centers = lows + refined.voxel_size / 2.0
        sd = np.asarray(SPHERE(jnp.asarray(centers)))
        half_diag = refined.voxel_size * np.sqrt(3) / 2
        assert np.all(np.abs(sd) <= half_diag + 1e-5)

    def test_refine_voxel_count_scales_with_area(self):
        cfg = MeshGenConfig(init_factor=8, bb_size=4.0)
        field = create_voxel_field(cfg)
        f1 = refine_field(SPHERE, field, cfg)
        f2 = refine_field(SPHERE, f1, cfg)
        # surface refinement grows ~4x per level (area-like), not 8x
        ratio = f2.count / f1.count
        assert 2.5 < ratio < 6.0

    def test_refine_matches_reference_semantics(self):
        # brute-force oracle: child kept iff its 8 corners disagree on sd<=0
        cfg = MeshGenConfig(init_factor=4, bb_size=4.0)
        field = create_voxel_field(cfg)
        refined = refine_field(SPHERE, field, cfg)

        lows = field.to_numpy()
        child_size = field.voxel_size / 2.0
        expected = []
        for base in lows:
            for i in range(2):
                for j in range(2):
                    for k in range(2):
                        lower = base + np.array([i, j, k]) * child_size
                        signs = []
                        for c in range(8):
                            corner = lower + np.array(
                                [c & 1, (c >> 1) & 1, (c >> 2) & 1]
                            ) * child_size
                            signs.append(
                                float(SPHERE(jnp.asarray(corner)[None])[0]) <= 0.0
                            )
                        if any(s != signs[0] for s in signs):
                            expected.append(lower)
        expected = np.asarray(expected)
        got = refined.to_numpy()
        assert got.shape == expected.shape
        # same set of voxels (order-insensitive)
        got_sorted = got[np.lexsort(got.T)]
        exp_sorted = expected[np.lexsort(expected.T)]
        np.testing.assert_allclose(got_sorted, exp_sorted, atol=1e-6)


class TestMarchingCubes:
    def test_sphere_mesh_on_surface(self):
        cfg = MeshGenConfig(init_factor=16, bb_size=4.0)
        mesh = generate_mesh(SPHERE, refine_steps=1, config=cfg)
        assert mesh.triangle_count > 100
        r = np.linalg.norm(mesh.vertices, axis=1)
        # Newton projection should put vertices on the unit sphere
        np.testing.assert_allclose(r, 1.0, atol=1e-3)

    def test_sphere_normals_radial(self):
        cfg = MeshGenConfig(init_factor=16, bb_size=4.0)
        mesh = generate_mesh(SPHERE, refine_steps=1, config=cfg)
        radial = mesh.vertices / np.linalg.norm(mesh.vertices, axis=1, keepdims=True)
        dots = np.sum(mesh.normals * radial, axis=1)
        assert dots.min() > 0.95

    def test_sphere_watertight_euler(self):
        cfg = MeshGenConfig(init_factor=16, bb_size=4.0)
        mesh = generate_mesh(SPHERE, refine_steps=0, config=cfg)
        # Euler characteristic of a sphere: V - E + F = 2
        edges = set()
        for tri in mesh.faces:
            for a, b in ((0, 1), (1, 2), (2, 0)):
                e = (min(tri[a], tri[b]), max(tri[a], tri[b]))
                edges.add(e)
        euler = mesh.vertex_count - len(edges) + mesh.triangle_count
        assert euler == 2

    def test_winding_outward(self):
        cfg = MeshGenConfig(init_factor=16, bb_size=4.0)
        mesh = generate_mesh(SPHERE, refine_steps=1, config=cfg)
        v = mesh.vertices[mesh.faces]  # (T, 3, 3)
        geo = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        norms = np.linalg.norm(geo, axis=1)
        ok = norms > 1e-10
        geo = geo[ok] / norms[ok, None]
        centroid = v[ok].mean(axis=1)
        outward = centroid / np.linalg.norm(centroid, axis=1, keepdims=True)
        frac_outward = np.mean(np.sum(geo * outward, axis=1) > 0)
        assert frac_outward > 0.99

    def test_reference_object_mesh(self):
        scene = reference_object().bind()
        cfg = MeshGenConfig()
        mesh = generate_mesh(scene, refine_steps=1, config=cfg)
        assert mesh.triangle_count > 1000
        sd = np.asarray(scene(jnp.asarray(mesh.vertices)))
        assert np.abs(sd).max() < 1e-3

    def test_empty_field_gives_empty_mesh(self):
        far_scene = lambda p: sphere_scene(0.01).bind()(p)  # tiny sphere
        cfg = MeshGenConfig(init_factor=4, bb_size=100.0)
        # voxels are 25 units; the sphere fits entirely inside corner cells
        # but more robust: use an sdf with no surface inside the bb
        always_pos = lambda p: jnp.full(p.shape[:-1], 10.0)
        mesh = generate_mesh(always_pos, refine_steps=1, config=cfg)
        assert mesh.triangle_count == 0
        assert mesh.vertex_count == 0


class TestWeld:
    def test_shared_vertices_welded(self):
        from bsdmg_tpu.mesh.weld import weld_vertices

        # two triangles sharing an edge
        tri0 = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        tri1 = np.asarray([[1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
        pos = np.stack([tri0, tri1])
        nrm = np.zeros_like(pos)
        nrm[..., 2] = 1.0
        verts, normals, faces = weld_vertices(pos, nrm)
        assert verts.shape == (4, 3)
        assert faces.shape == (2, 3)
        np.testing.assert_array_equal(faces[0], [0, 1, 2])
        # shared vertices reference the same indices
        assert faces[1][0] == 1 and faces[1][2] == 2

    def test_quantization_tolerance(self):
        from bsdmg_tpu.mesh.weld import weld_vertices

        eps = 1e-7  # below the 1e-5 weld quantum
        tri0 = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        tri1 = tri0 + eps
        pos = np.stack([tri0, tri1])
        nrm = np.zeros_like(pos)
        verts, _, faces = weld_vertices(pos, nrm)
        assert verts.shape == (3, 3)
        np.testing.assert_array_equal(faces[0], faces[1])


class TestComponentFormParity:
    """The SoA (csdf) fast path must produce identical results to the
    points-API path for built-in scenes."""

    def test_refine_csdf_matches_default(self):
        from bsdmg_tpu.config import MeshGenConfig
        from bsdmg_tpu.mesh import create_voxel_field, refine_field
        from bsdmg_tpu.models import reference_object
        from bsdmg_tpu.ops.pallas import compile_scene_csdf

        scene = reference_object()
        cfg = MeshGenConfig(init_factor=16)
        f0 = create_voxel_field(cfg)
        a = refine_field(scene.bind(), f0, cfg)
        b = refine_field(scene.bind(), f0, cfg, csdf=compile_scene_csdf(scene))
        assert a.count == b.count
        np.testing.assert_allclose(
            np.asarray(a.lowers[: a.count]), np.asarray(b.lowers[: b.count]), atol=1e-6
        )

    def test_extract_csdf_matches_default(self):
        from bsdmg_tpu.config import MeshGenConfig
        from bsdmg_tpu.mesh import create_voxel_field, refine_field
        from bsdmg_tpu.mesh.pipeline import field_to_triangles
        from bsdmg_tpu.models import reference_object
        from bsdmg_tpu.ops.pallas import compile_scene_csdf

        scene = reference_object()
        csdf = compile_scene_csdf(scene)
        cfg = MeshGenConfig(init_factor=16)
        field = refine_field(scene.bind(), create_voxel_field(cfg), cfg, csdf=csdf)
        a = field_to_triangles(scene.bind(), field, cfg)
        b = field_to_triangles(scene.bind(), field, cfg, csdf=csdf)
        np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
        np.testing.assert_allclose(
            np.asarray(a.positions), np.asarray(b.positions), atol=2e-5
        )
        np.testing.assert_allclose(
            np.asarray(a.normals), np.asarray(b.normals), atol=2e-4
        )


def _mc_oracle(sdf_np, lowers, vs, tol, iters):
    """NumPy marching cubes in float64, one voxel at a time: 256-case table,
    edge midpoints (marching_cubes.cu:14), Newton projection with the
    reference's fd4 normal (signed_distance.cu:181-240). Returns each
    triangle as a (3, 3) array of its vertices."""
    from bsdmg_tpu.ops.tables import MC_EDGE_MIDPOINTS

    def fd4(p, e=1e-3):
        g = np.zeros(3)
        for a in range(3):
            h = np.zeros(3)
            h[a] = e
            g[a] = (-sdf_np(p + 2 * h) + 8 * sdf_np(p + h)
                    - 8 * sdf_np(p - h) + sdf_np(p - 2 * h))
        return g / np.linalg.norm(g)

    def project(p):
        for _ in range(iters):
            sd = sdf_np(p)
            if abs(sd) <= tol:
                break
            p = p - sd * fd4(p)
        return p

    tris = []
    for lo in lowers:
        vals = [sdf_np(lo + MC_CORNER_OFFSETS[i] * vs) for i in range(8)]
        case = sum(1 << i for i in range(8) if vals[i] <= 0.0)
        for edges in MC_TRIANGLE_CASES[case]:
            if edges[0] < 0:
                break
            verts = [project(lo + MC_EDGE_MIDPOINTS[e] * vs) for e in edges]
            tris.append(verts)
    return np.asarray(tris)


class TestStagedProjection:
    @pytest.mark.parametrize("edge_budget", [6, 12])
    def test_staged_mc_matches_numpy_oracle(self, edge_budget):
        """The staged XLA extraction (corner classify, table gather,
        rank-compacted Newton projection, slot pick, winding fix) emits the
        same triangles as a float64 per-voxel NumPy oracle, with the
        compacted (6) and full (12) edge layouts alike."""
        import dataclasses

        from bsdmg_tpu.ops.marching_cubes import extract_triangles
        from bsdmg_tpu.ops.pallas import compile_scene_csdf

        scene = reference_object()
        csdf = compile_scene_csdf(scene)
        cfg = dataclasses.replace(MeshGenConfig(init_factor=8), edge_budget=edge_budget)
        field = refine_field(scene.bind(), create_voxel_field(cfg), cfg, csdf=csdf)
        soup = extract_triangles(
            scene.bind(), field.lowers, jnp.float32(field.voxel_size),
            jnp.int32(field.count), cfg, csdf,
        )
        from scipy.spatial import cKDTree

        valid = np.asarray(soup.valid).reshape(-1)
        got = np.asarray(soup.positions).reshape(-1, 3, 3)[valid]

        import oracle

        want = _mc_oracle(
            oracle.sd_obj, np.asarray(field.live_lowers(), np.float64),
            field.voxel_size, cfg.newton_tolerance, cfg.newton_iters,
        )
        assert got.shape == want.shape

        # match triangles as vertex sets (the winding fix may swap vertex
        # order): one-to-one nearest neighbours within 1e-4
        flat = lambda t: np.stack(
            [t[i, np.lexsort(t[i].round(3).T[::-1])] for i in range(len(t))]
        ).reshape(len(t), 9)
        dist, idx = cKDTree(flat(want)).query(flat(got))
        assert dist.max() < 1e-4, dist.max()
        assert len(set(idx.tolist())) == len(idx)


class TestMeshQuality:
    def test_extracted_mesh_is_watertight_and_on_surface(self):
        """Closed-surface extraction: every edge shared by exactly 2 faces
        and every welded vertex within Newton tolerance of the isosurface."""
        import jax.numpy as jnp

        from bsdmg_tpu.config import MeshGenConfig
        from bsdmg_tpu.mesh import create_voxel_field, refine_field
        from bsdmg_tpu.mesh.pipeline import field_to_triangles, triangles_to_mesh
        from bsdmg_tpu.models import reference_object
        from bsdmg_tpu.ops.pallas import compile_scene_csdf

        scene = reference_object()
        csdf = compile_scene_csdf(scene)
        cfg = MeshGenConfig(init_factor=16)
        field = refine_field(scene.bind(), create_voxel_field(cfg), cfg, csdf=csdf)
        mesh = triangles_to_mesh(
            field_to_triangles(scene.bind(), field, cfg, csdf=csdf), cfg
        )
        assert mesh.triangle_count > 100

        sd = np.asarray(scene.bind()(jnp.asarray(mesh.vertices)))
        assert np.abs(sd).max() < 5 * cfg.newton_tolerance

        f = mesh.faces
        edges = np.sort(
            np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1
        )
        _, counts = np.unique(edges, axis=0, return_counts=True)
        assert (counts == 2).all(), (
            f"non-manifold edges: {dict(zip(*np.unique(counts, return_counts=True)))}"
        )


class TestBlockedCompactionOverflow:
    def test_refine_retries_when_most_blocks_survive(self):
        """A surface crossing nearly every voxel overflows the quarter-alive
        block_cap guess; refine_field must detect it (unclipped counts) and
        retry wider, landing on exactly the generic path's survivor set."""
        from bsdmg_tpu.mesh.field import _pad_to, _round_capacity
        from bsdmg_tpu.ops.refine import refine_step

        # rapid sign oscillation: ~every child voxel straddles a zero
        # crossing, so survivors fill far more than a quarter of the blocks
        # (init 32 -> nb=512 blocks, first guess block_cap=128)
        wavy = lambda p: jnp.sin(p[..., 0] * 40.0) * 0.01
        cfg = MeshGenConfig(init_factor=32, bb_size=4.0)
        field = create_voxel_field(cfg)

        refined = refine_field(wavy, field, cfg)

        cap = _round_capacity(field.count)
        out, cnt, _ = refine_step(
            wavy, _pad_to(field.lowers, cap), jnp.int32(field.count),
            jnp.float32(field.voxel_size),
        )
        assert refined.count == int(cnt)
        # genuinely overflows the first quarter-alive guess
        from bsdmg_tpu.ops.refine import _BLOCK_ROWS

        nb = 8 * _round_capacity(field.count) // _BLOCK_ROWS
        assert refined.count > (nb // 4) * _BLOCK_ROWS * 0.3
        a = np.asarray(refined.lowers[: refined.count])
        b = np.asarray(out[: int(cnt)])
        np.testing.assert_allclose(
            a[np.lexsort(a.T)], b[np.lexsort(b.T)], atol=1e-6
        )


class TestEdgeCompaction:
    """Rank-compacted projection layout (config.edge_budget < 12)."""

    def _field(self, scene_name="reference_object", init=16):
        from bsdmg_tpu.config import MeshGenConfig
        from bsdmg_tpu.mesh import create_voxel_field, refine_field
        from bsdmg_tpu.models import get_scene
        from bsdmg_tpu.ops.pallas import compile_scene_csdf

        scene = get_scene(scene_name)
        csdf = compile_scene_csdf(scene)
        cfg = MeshGenConfig(init_factor=init)
        field = refine_field(scene.bind(), create_voxel_field(cfg), cfg, csdf=csdf)
        return scene, csdf, cfg, field

    def test_compacted_equals_uncompacted(self):
        """edge_budget=6 must reproduce the 12-lane layout's soup exactly
        on a smooth scene (no overflow)."""
        import dataclasses

        from bsdmg_tpu.ops.marching_cubes import extract_triangles

        scene, csdf, cfg, field = self._field()
        vs = jnp.float32(field.voxel_size)
        cnt = jnp.int32(field.count)
        assert cfg.edge_budget == 6  # production default
        a = extract_triangles(scene.bind(), field.lowers, vs, cnt, cfg, csdf)
        b = extract_triangles(
            scene.bind(), field.lowers, vs, cnt,
            dataclasses.replace(cfg, edge_budget=12), csdf,
        )
        assert int(a.edge_overflow) == 0
        np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
        np.testing.assert_array_equal(
            np.asarray(a.positions), np.asarray(b.positions)
        )
        np.testing.assert_array_equal(np.asarray(a.normals), np.asarray(b.normals))

    def test_overflow_detected_and_retried(self):
        """A checkerboard SDF (every corner alternates sign) drives all 12
        edges crossing -> overflow with budget 6; the pipeline wrapper must
        rerun uncompacted and produce the full triangle set."""
        import dataclasses

        from bsdmg_tpu.mesh.pipeline import field_to_triangles
        from bsdmg_tpu.mesh.field import VoxelField
        from bsdmg_tpu.config import MeshGenConfig
        from bsdmg_tpu.ops.marching_cubes import extract_triangles

        # unit voxels at integer corners; SDF sign alternates per corner
        def checker(p):
            s = jnp.sin(np.pi * (p[..., 0] + 0.5)) * jnp.sin(
                np.pi * (p[..., 1] + 0.5)
            ) * jnp.sin(np.pi * (p[..., 2] + 0.5))
            return 0.2 * s

        def checker_c(x, y, z):
            return 0.2 * (
                jnp.sin(np.pi * (x + 0.5))
                * jnp.sin(np.pi * (y + 0.5))
                * jnp.sin(np.pi * (z + 0.5))
            )

        lowers = jnp.asarray(
            [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1e6] * 3],
            jnp.float32,
        )
        cfg = MeshGenConfig(newton_iters=4)
        soup = extract_triangles(
            checker, lowers, jnp.float32(1.0), jnp.int32(3), cfg, checker_c
        )
        assert int(soup.edge_overflow) > 0
        # overflowed voxels' triangles are dropped, not garbage
        full = extract_triangles(
            checker, lowers, jnp.float32(1.0), jnp.int32(3),
            dataclasses.replace(cfg, edge_budget=12), checker_c,
        )
        assert int(np.asarray(soup.valid).sum()) < int(np.asarray(full.valid).sum())

        # the wrapper retry restores the full set
        field = VoxelField(lowers=lowers, count=3, voxel_size=1.0, level=0)
        via_wrapper = field_to_triangles(checker, field, cfg, csdf=checker_c)
        np.testing.assert_array_equal(
            np.asarray(via_wrapper.valid), np.asarray(full.valid)
        )
        np.testing.assert_array_equal(
            np.asarray(via_wrapper.positions), np.asarray(full.positions)
        )

    def test_winding_estimators_agree(self):
        """vertex_mean (default) and the reference's centroid_fd4 must make
        identical flip decisions on the reference object."""
        import dataclasses

        from bsdmg_tpu.mesh.pipeline import field_to_triangles

        scene, csdf, cfg, field = self._field()
        a = field_to_triangles(scene.bind(), field, cfg, csdf=csdf)
        b = field_to_triangles(
            scene.bind(), field,
            dataclasses.replace(cfg, winding_normals="centroid_fd4"), csdf=csdf,
        )
        np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
        np.testing.assert_array_equal(
            np.asarray(a.positions), np.asarray(b.positions)
        )


def test_packed_fine_sort_matches_generic():
    """refine_step_blocked's packed 2-column lattice sort (origin given)
    must produce exactly the generic 4-column float sort's survivor SET —
    order may differ (survivors are a set; both paths are compared sorted)."""
    import jax.numpy as jnp

    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import create_voxel_field
    from bsdmg_tpu.mesh.field import _pad_to, _round_capacity
    from bsdmg_tpu.models import reference_object
    from bsdmg_tpu.ops.refine import refine_step_blocked

    scene = reference_object()
    sdf = scene.bind()
    cfg = MeshGenConfig(init_factor=32)
    field = create_voxel_field(cfg)
    cap = _round_capacity(field.count)
    lowers = _pad_to(field.lowers, cap)
    count = jnp.int32(field.count)
    size = jnp.float32(field.voxel_size)
    nb = 8 * cap // 512
    a, na, _, _ = refine_step_blocked(
        sdf, lowers, count, size, block_cap=nb
    )
    b, nb_, _, _ = refine_step_blocked(
        sdf, lowers, count, size, block_cap=nb, origin=cfg.bb_min
    )
    assert int(na) == int(nb_) > 0
    av = np.asarray(a[: int(na)])
    bv = np.asarray(b[: int(nb_)])
    np.testing.assert_allclose(
        av[np.lexsort(av.T)], bv[np.lexsort(bv.T)], atol=0.0
    )
