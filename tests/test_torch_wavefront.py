"""The port's sorted-wavefront mesh path against rtow_tpu on the CPU:
the sort keys, the window ladder, the Morton pixel order, one bounce of
K3's plain version against ``bounce_step_pallas`` in interpret mode, the
triangle hierarchy against the flat sweep, and whole frames.

Tolerances:

* ``sort_keys``: equal on at least 99.9% of lanes (the key quantises the
  unit direction, which JAX normalises with XLA's rsqrt and the port with
  1/sqrt; a last-bit difference can move a lane across a cell edge), dead
  lanes exactly ``DEAD_KEY``.  ``_window_ladder`` and
  ``_morton_pixel_perm``: equal.
* One bounce of 1,024 lanes, from the same input state on both sides:
  alive codes and bounce counts equal on at least 99.5% of lanes (an ulp
  of XLA's against PyTorch's float32 sin/cos/rsqrt can flip a discrete
  choice), and on the lanes that agree every continuous row within
  2e-5 * (1 + |value|).
* The hierarchical and the flat plain sweeps: the same winners and t,
  exactly (culling never changes the winner).
* Sample accounting: every pixel of a white-background frame that hits
  nothing is exactly 1.
* One small frame against the JAX package's own CPU render
  (``rtow_tpu.render.render``, the jnp path, threefry camera rays): the
  mean |difference| of 8x8-pixel block means below the Monte Carlo sigma
  of one block, 1 / sqrt(spp * 64), and the largest below 3 sigma (the
  PARITY.json method of ``tools/golden_compare.py``).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rtow_tpu.config import Config as JaxConfig
from rtow_tpu.models.camera import make_camera as jax_make_camera
from rtow_tpu.models.scene import SceneBuilder as JaxSceneBuilder
from rtow_tpu.ops import pallas_megakernel as jmk
from rtow_tpu.ops import wavefront_sorted as jwf
from rtow_tpu.render import render as jax_render
from rtow_tpu_torch.config import Config
from rtow_tpu_torch.models.camera import make_camera
from rtow_tpu_torch.models.scene import SceneBuilder
from rtow_tpu_torch.ops import flat_bounce as fb
from rtow_tpu_torch.ops import megakernel as mk
from rtow_tpu_torch.ops import wavefront as wf
from rtow_tpu_torch.pipeline import render_auto

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_mesh import make_knot  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain sweeps are many small PyTorch ops: one intra-op thread
    runs them as fast here and keeps them from contending with the
    threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAM = dict(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
           fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0, focus_dist=3.0)


def _knot_scenes(segments, rings, spheres=False):
    """(JAX scene, port scene) of a knot, with the mixed case's ground
    and a glass ball when ``spheres``."""
    verts, faces = make_knot(segments, rings)
    out = []
    for b in (JaxSceneBuilder(), SceneBuilder()):
        m = b.add_lambertian((0.6, 0.5, 0.4))
        b.add_mesh(verts[faces], m)
        if spheres:
            b.add_sphere((0.0, -101.0, 0.0), 100.0,
                         b.add_metal((0.5, 0.5, 0.5), 0.1))
            b.add_sphere((0.6, 0.2, 0.5), 0.3, b.add_dielectric(1.5))
        out.append(b.build() if isinstance(b, JaxSceneBuilder)
                   else b.build(device="cpu"))
    return out


def _camera_state(n, dead, seed):
    """A (16, n) state of camera rays through random points of the view,
    the last ``dead`` lanes dead, made with numpy."""
    rng = np.random.default_rng(seed)
    cam = make_camera(device="cpu", **CAM)
    s = rng.random(n).astype(np.float32)
    t = rng.random(n).astype(np.float32)
    o = cam.origin.numpy()
    d = (cam.lower_left.numpy() + s[:, None] * cam.horizontal.numpy()
         + t[:, None] * cam.vertical.numpy() - o).astype(np.float32)
    st = np.zeros((16, n), np.float32)
    st[0:3] = o[:, None]
    st[3:6] = d.T
    st[7:10] = 1.0
    st[13, :n - dead] = 1.0
    st[15] = np.arange(n)
    return st


def _jax_state(st):
    return tuple(jnp.asarray(st[j]) if j < 13 else
                 jnp.asarray(st[j].astype(np.int32)) for j in range(16))


# ---------------------------------------------------------------------------
# Keys, ladder, pixel order


def test_sort_keys_match_jax():
    rng = np.random.default_rng(5)
    n = 20_000
    st = np.zeros((16, n), np.float32)
    st[0:3] = rng.uniform(-1.2, 1.2, (3, n))
    st[3:6] = rng.normal(size=(3, n))
    st[13] = rng.random(n) < 0.8
    bmin = np.array([-1.0, -0.9, -0.5], np.float32)
    inv_ext = (1.0 / np.array([2.0, 1.8, 1.0], np.float32)).astype(np.float32)
    want = np.asarray(jwf.sort_keys(*map(jnp.asarray, st[:6]),
                                    jnp.asarray(st[13].astype(np.int32)),
                                    jnp.asarray(bmin), jnp.asarray(inv_ext)))
    got = wf.sort_keys(torch.from_numpy(st), torch.from_numpy(st[13]),
                       torch.from_numpy(bmin), torch.from_numpy(inv_ext)).numpy()
    dead = st[13] == 0
    assert (got[dead] == wf.DEAD_KEY).all() and (want[dead] == wf.DEAD_KEY).all()
    assert np.mean(got == want) >= 0.999
    assert len(np.unique(got[~dead])) > 1000


def test_sort_keys_give_k3_keys_bit_for_bit():
    """The keys from a packed state's rows (K3's loop) and from the
    gradient path's (cont, int32 alive) rows are equal bit for bit
    (test_sort_keys_match_jax holds their values against JAX)."""
    rng = np.random.default_rng(9)
    n = 20_000
    st = np.zeros((16, n), np.float32)
    st[0:3] = rng.uniform(-1.2, 1.2, (3, n))
    st[3:6] = rng.normal(size=(3, n))
    st[13] = (rng.random(n) < 0.8) * rng.integers(1, 3, n)
    state = torch.from_numpy(st)
    bmin = torch.tensor([-1.0, -0.9, -0.5])
    inv_ext = 1.0 / torch.tensor([2.0, 1.8, 1.0])
    k3 = wf.sort_keys(state, state[13], bmin, inv_ext)
    grad_path = wf.sort_keys(state[:13].clone(), state[13].to(torch.int32),
                             bmin, inv_ext)
    assert torch.equal(k3, grad_path)
    assert (k3 == wf.DEAD_KEY).sum() == (st[13] == 0).sum()
    assert len(torch.unique(k3)) > 1000


@pytest.mark.parametrize("n", [1024, 5120, 262144, 10_240_000])
def test_window_ladder_matches_jax(n):
    assert wf._window_ladder(n) == jwf._window_ladder(n)


@pytest.mark.parametrize("wh", [(400, 400), (37, 21)])
def test_morton_pixel_perm_matches_jax(wh):
    np.testing.assert_array_equal(wf._morton_pixel_perm(*wh),
                                  jwf._morton_pixel_perm(*wh))


# ---------------------------------------------------------------------------
# One bounce of K3's plain version against the Pallas kernel


@pytest.mark.parametrize("segments,rings,spheres", [
    (16, 12, True),  # 384 triangles and two spheres: the mixed case
    (64, 64, False),  # 8,192 triangles: the super level
])
def test_bounce_step_matches_pallas(segments, rings, spheres):
    jscene, scene = _knot_scenes(segments, rings, spheres)
    tables, _bmin, _inv = wf.scene_tables(scene)
    st = _camera_state(mk.TILE, 24, seed=segments)
    depth, seed = 5, 11
    with jmk.tri_block_for(jscene.n_triangles):
        jtables, counts, _, _ = jwf._scene_tables(jscene)
        n_blocks, n_tri_blocks, n_super = counts
        assert (n_tri_blocks, n_super) == (tables.tris.n_blocks,
                                           tables.tris.n_super)
        for it in range(2):
            with pltpu.force_tpu_interpret_mode():
                out = jmk.bounce_step_pallas(
                    _jax_state(st), it, seed, depth, jtables,
                    n_blocks=n_blocks, n_tri_blocks=n_tri_blocks,
                    n_super=n_super)
            want = np.stack([np.asarray(x, np.float32) for x in out])
            got = fb.bounce_step_reference(torch.from_numpy(st), it, seed,
                                           depth, tables).numpy()
            same = ((got[13] == want[13]) & (got[14] == want[14]))
            assert np.mean(same) >= 0.995, it
            np.testing.assert_array_equal(got[15], want[15])
            err = np.abs(got[:13, same] - want[:13, same])
            assert (err <= 2e-5 * (1.0 + np.abs(want[:13, same]))).all(), it
            assert 0 < (want[13] > 0).sum() < mk.TILE - 24
            st = want  # the next bounce starts both sides from one state


def test_hierarchy_finds_the_flat_winners():
    """The 131,072-triangle knot (hypers, supers, blocks) against the flat
    sweep, for 4,096 random rays."""
    _, scene = _knot_scenes(256, 256)
    tris = mk.build_tri_table(scene, mk.pick_tri_block(scene.n_triangles))
    assert tris.n_hyper == 2 and tris.n_super == 32
    rng = np.random.default_rng(3)
    n = 4096
    o = rng.normal(size=(3, n))
    o = (2.0 * o / np.linalg.norm(o, axis=0)).astype(np.float32)
    d = (rng.uniform(-0.8, 0.8, (3, n)) - o).astype(np.float32)
    ray = [torch.from_numpy(x) for x in (*o, *d)]
    start = (torch.full((n,), mk.BIG), torch.zeros(n, dtype=torch.int64))
    tally = [0, 0]
    hier = mk.nearest_triangle(tris, *ray, *start, 0, tally=tally)
    flat = mk.nearest_triangle(tris, *ray, *start, 0, flat=True)
    assert torch.equal(hier[0], flat[0]) and torch.equal(hier[1], flat[1])
    hits = int((hier[0] < mk.BIG).sum())
    assert 500 < hits < n
    assert tally[1] < n * tris.count // 20  # the hierarchy culls


# ---------------------------------------------------------------------------
# Frames


def test_exact_sample_accounting():
    """A mesh past WAVEFRONT_MIN_TRIS behind the camera and a white
    background: every sample adds exactly 1, over several chunks."""
    verts, faces = make_knot(128, 72)  # 18,432 triangles
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.5,) * 3),
               translate=(0.0, 0.0, 50.0))
    scene = b.build(background=(1.0, 1.0, 1.0), device="cpu")
    assert scene.n_triangles > wf.WAVEFRONT_MIN_TRIS
    cfg = Config(device="cpu", image_width=24, aspect_ratio=1.2,
                 samples_per_pixel=3, max_child_rays=4, rays_per_batch=1024)
    assert wf.chunk_plan(cfg)[1] == 2
    before = fb.bounce_step.launches
    img = render_auto(scene, make_camera(device="cpu", **CAM), cfg)
    assert img.shape == (20, 24, 3)
    np.testing.assert_array_equal(img, 1.0)
    assert fb.bounce_step.launches == before == 0  # the CPU runs no kernel


def test_small_frame_matches_jax_render():
    jscene, scene = _knot_scenes(16, 12)
    kw = dict(image_width=32, aspect_ratio=1.0, samples_per_pixel=8,
              max_child_rays=4)
    want = np.asarray(jax_render(jscene, jax_make_camera(**CAM),
                                 JaxConfig(backend="jnp", **kw),
                                 key=jax.random.key(0)))
    got = wf.render_wavefront(scene, make_camera(device="cpu", **CAM),
                              Config(device="cpu", **kw))
    assert got.shape == want.shape == (32, 32, 3)
    bs = 8

    def blocks(img):
        return img.reshape(32 // bs, bs, 32 // bs, bs, 3).mean(axis=(1, 3))

    diff = np.abs(blocks(got) - blocks(want))
    sigma = 1.0 / np.sqrt(8 * bs * bs)
    assert diff.mean() < sigma and diff.max() < 3 * sigma
    assert got.std() > 0.05  # the knot is in view


def test_wrapper_rejects_other_devices_and_bad_inputs():
    _, scene = _knot_scenes(16, 12)
    tables, _, _ = wf.scene_tables(scene)
    st = torch.from_numpy(_camera_state(mk.TILE, 0, seed=1))
    with pytest.raises(ValueError, match="no flat bounce"):
        fb.bounce_step(st.to("meta"), 0, 0, 2,
                       fb.Tables(tables.sph.to("meta"), tables.tris))
    with pytest.raises(ValueError, match="state"):
        fb.bounce_step(st[:15].contiguous(), 0, 0, 2, tables)
    with pytest.raises(ValueError, match="stats"):
        fb.bounce_step(st, 0, 0, 2, tables, stats=torch.zeros(2))
    for live in (-1, mk.TILE + 1):
        with pytest.raises(ValueError, match="live"):
            fb.bounce_step(st, 0, 0, 2, tables, live=live)


def test_trace_lanes_picks_k3_form_by_live_count(monkeypatch):
    """``trace_lanes`` hands each bounce's live-lane count to
    ``bounce_step`` (K3's form is picked from it on the card); on the
    CPU a count changes nothing and launches no kernel."""
    _, scene = _knot_scenes(16, 12)
    tables, bmin, inv_ext = wf.scene_tables(scene)
    st = torch.from_numpy(_camera_state(2 * mk.TILE, 300, seed=2))
    seen, step = [], fb.bounce_step

    def spy(state, *a, live=None, **k):
        seen.append((int((state[13] > 0).sum()), live))
        return step(state, *a, live=live, **k)

    monkeypatch.setattr(wf, "bounce_step", spy)
    wf.trace_lanes(st, 3, max_depth=6, tables=tables, bmin=bmin,
                   inv_ext=inv_ext)
    assert len(seen) > 2 and seen[0] == (2 * mk.TILE - 300,) * 2
    assert all(n == live for n, live in seen)
    before = (fb.bounce_step.launches, fb.bounce_step.warp_launches)
    want = fb.bounce_step_reference(st, 0, 3, 6, tables)
    for live in (None, 0, st.shape[1]):
        out = fb.bounce_step(st, 0, 3, 6, tables, live=live)
        assert torch.equal(out, want)
    assert (fb.bounce_step.launches, fb.bounce_step.warp_launches) == before
