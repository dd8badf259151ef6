"""The CUDA megakernels K1 (with the analytical, SDF, mesh and big mesh
backends), K2 (analytical, SDF and mesh, each with and without media) and
K3 (K1 with the bounces each
path entered alive, on every backend), the march-step counter K6 and the
uniform stream K4, against their plain PyTorch versions, on the card.

Marked `cuda`: each test asks the `cuda_device` fixture for the card and
skips without one. This file imports no JAX; the JAX side is the committed
renders tests/golden_torch/analytical_64x48_d4_k3.npy,
sdf_64x48_d4_k3.npy, mesh_64x48_d4_k3.npy and bigmesh_64x48_d4_k3.npy and
gradients tests/golden_torch/grad_analytical_64x48_d4_k3.npz and
grad_mesh_64x48_d4_k3.npz. Run on a CUDA host
(the conftest imports JAX, which that host may lack):
`python -m pytest --noconftest tests/test_torch_kernel_cuda.py -q`.

K3, as chip_smoke.py phase 25: its frame bit-equal to K1's, its per-lane
counts equal to the plain version's on at least 99.9% of the lanes (a
knife-edge lane may take the other branch, as K1's pixels may), its alive
fractions within 1e-3 of the plain version's. K4 bit-equal to its plain
version.

K1's and K3's media instantiations, as chip_smoke.py phases 27 and 29: the
glass-and-medium scenes of tests/test_torch_media_kernel_host.py (the
mesh's pixels whose plain path meets two coplanar triangles at once left
out of the gate), the committed JAX render
tests/golden_torch/media_analytical_64x48_d6_k3.npy, K3's media frame
bit-equal to K1's. K2's media instantiation, as chip_smoke.py phase 30:
one launch a backward through the autograd Function, against its plain
version at K2's tolerance (the mesh's coplanar-tie pixels masked too), the
Scatter density's entry exactly 0; a CUDA big mesh media scene that
requires grad raises and launches nothing.

Scene-backend plugins, as chip_smoke.py phase 38 (tests/torch_plugin_toy.py:
the toy, the toy with its sphere in an extra tensor, the stripes hook; the
toy's glass with a Scatter medium): K1 against the plain version, K3's
frame K1's, the toy's K2 against its plain version at K2's tolerance, the
forward-only plugins' gradients refused before any launch, the toy over
pixel ranges bit for bit.

K1 and K2 over a pixel range, as chip_smoke.py phase 37: K1 over the
ranges of parallel/mesh.shard_ranges (2 and 3 ranks) and over unaligned
ranges, on every backend and the media instantiation, each launch the
single launch's pixels bit for bit and nothing else written; K2's range
gradients over 2 ranks summed within rtol 1e-5 of the whole frame's
largest entry.

K2's tolerance, as chip_smoke.py phase 6: with the cotangent zeroed at the
knife-edge pixels (the two forward frames differ by more than 1e-3 there:
K2 differentiates K1's branch, the plain version the other),
max|g_k - g_p| <= 1e-2 max|g_p| and entries above 1e-2 max|g_p| agree to
rtol 2e-2; K2-mesh also with the pixels whose plain path passes near an
edge masked (chip_smoke.py phase 21). Against the JAX gradient fixtures,
the tolerances of tests/test_torch_grad.py.
"""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator import inverse
from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM, bounces_entered
from pathtracer_tpu_torch.models import families, sdf
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import megakernel_mesh as MM
from pathtracer_tpu_torch.ops import megakernel_sdf as MS
from pathtracer_tpu_torch.ops import _build, rng
from pathtracer_tpu_torch.models.material import MediumType
from pathtracer_tpu_torch.tools import validate_rng
from test_torch_media_kernel_host import DEMO, media_scene
import torch_plugin_toy as toy

FIXTURE = os.path.join(os.path.dirname(__file__), "golden_torch", "analytical_64x48_d4_k3.npy")
SDF_FIXTURE = os.path.join(os.path.dirname(__file__), "golden_torch", "sdf_64x48_d4_k3.npy")
GRAD_FIXTURE = os.path.join(os.path.dirname(__file__), "golden_torch", "grad_analytical_64x48_d4_k3.npz")
MESH_GRAD_FIXTURE = os.path.join(os.path.dirname(__file__), "golden_torch", "grad_mesh_64x48_d4_k3.npz")
MEDIA_FIXTURE = os.path.join(os.path.dirname(__file__), "golden_torch", "media_analytical_64x48_d6_k3.npy")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the megakernel has no CPU mode")
    return torch.device("cuda", 0)


def assert_image_close(img, ref):
    img, ref = np.asarray(img, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5


@pytest.mark.parametrize(
    "spp,quirks,seed", [(1, VERBATIM, 11), (2, VERBATIM, 12), (1, FIXED, 13)],
    ids=["spp1", "spp2", "fixed"],
)
def test_kernel_matches_plain_version(cuda_device, spp, quirks, seed):
    scene = make_scene(device=cuda_device)
    key = rng.prng_key(seed)
    launches = MK.render_frame_megakernel.launches
    img = MK.render_frame_megakernel(scene, key, 320, 240, spp, quirks)
    ref = MK.render_frame_reference(scene, key, 320, 240, spp, quirks)
    torch.cuda.synchronize()
    assert MK.render_frame_megakernel.launches == launches + 1
    assert img.shape == (240, 320, 4) and img.device == cuda_device
    assert_image_close(img.cpu(), ref.cpu())


def test_kernel_matches_jax_fixture(cuda_device):
    img = MK.render_frame_megakernel(make_scene(device=cuda_device), rng.prng_key(3), 64, 48)
    assert_image_close(img.cpu(), np.load(FIXTURE))


def test_kernel_refuses_float64(cuda_device):
    with pytest.raises(ValueError, match="float32"):
        MK.render_frame_megakernel(make_scene(dtype=torch.float64, device=cuda_device), rng.prng_key(0), 8, 8)


@pytest.mark.parametrize(
    "spp,quirks,seed", [(1, VERBATIM, 21), (2, VERBATIM, 22), (1, FIXED, 23)], ids=["spp1", "spp2", "fixed"],
)
def test_backward_kernel_matches_plain_version(cuda_device, spp, quirks, seed):
    scene = make_scene(device=cuda_device)
    key, (w, h) = rng.prng_key(seed), (320, 240)
    k = MK.prepare_launch(scene, key, w, h, spp, quirks)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32)).to(cuda_device)
    fn = MK.render_frame_megakernel
    launches = (fn.bwd_launches, fn.record_launches, fn.adjoint_launches)
    g = MK.launch_backward(k, ct)
    assert (fn.bwd_launches, fn.record_launches, fn.adjoint_launches) == (
        launches[0] + 1, launches[1] + 1, launches[2] + 1) and g.shape == (1, k.sv.shape[1])
    assert torch.equal(MK.launch_backward(k, ct), g)  # reproducible bit for bit
    assert torch.isfinite(g).all()
    edge = (MK.launch(k) - MK.render_frame_reference(scene, key, w, h, spp, quirks)).abs()[..., :3].amax(-1) > 1e-3
    ct_m = ct * (~edge)[..., None]
    g = MK.launch_backward(k, ct_m).cpu().double().numpy().ravel()
    r = MK.render_grad_reference(k.sv, scene, key, ct_m, w, h, spp, quirks).cpu().double().numpy().ravel()
    assert np.isfinite(g).all() and np.abs(g - r).max() <= 1e-2 * np.abs(r).max()
    big = np.abs(r) > 1e-2 * np.abs(r).max()
    np.testing.assert_allclose(g[big], r[big], rtol=2e-2)


def test_backward_kernel_matches_jax_fixture(cuda_device):
    scene = make_scene(device=cuda_device)
    leaves = dict(inverse.named_leaves(scene))
    names = [f"lights.emission.{c}" for c in "xyz"] + [f"params.materials.rgb.{c}" for c in "xyz"]
    names += ["params.materials.roughness", "params.sphere_center.x", "camera.origin.z"]
    for n in names:
        leaves[n].requires_grad_(True)
    counts = (MK.render_frame_megakernel.launches, MK.render_frame_megakernel.bwd_launches)
    img = MK.render_frame_megakernel(scene, rng.prng_key(3), 64, 48)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in names])
    assert (MK.render_frame_megakernel.launches, MK.render_frame_megakernel.bwd_launches) == (
        counts[0] + 1, counts[1] + 1)
    with np.load(GRAD_FIXTURE) as want:
        for n, got in zip(names, grads):
            got, ref = got.cpu().numpy(), want[n]
            if n.startswith(("params.sphere", "camera")):
                np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-7, err_msg=n)
            else:
                np.testing.assert_allclose(got, ref, rtol=5e-3, atol=1e-8, err_msg=n)


def test_training_step_is_two_forward_and_one_backward_launch(cuda_device):
    MK.render_frame_megakernel.launches = MK.render_frame_megakernel.bwd_launches = 0
    report = inverse.recover_demo(key=rng.prng_key(1), width=32, height=16, steps=2, recursion_depth=2,
                                  device=cuda_device, verbose=False)
    assert (MK.render_frame_megakernel.launches, MK.render_frame_megakernel.bwd_launches) == (4 + 2 * 2, 2)
    assert np.isfinite(report.losses.numpy()).all()


def enclosed_scene(depth, device):
    """The demo scene inside sphere 1 grown to radius 20 about the origin
    (tests/test_torch_kernel_bwd_host.enclosed_scene): paths end only on the
    light or at `depth`."""
    scene = make_scene(recursion_depth=depth, device=device)
    with torch.no_grad():
        p = scene.params
        p.sphere_center.x[1], p.sphere_radius[1] = 0.0, 20.0
    return scene


def test_backward_kernel_takes_deep_paths(cuda_device):
    """Depth 20 (the records hold any depth; the adjoint once held 16
    bounces a thread): K2 against its plain version at 64x48, the
    knife-edge pixels masked."""
    scene = enclosed_scene(20, cuda_device)
    key, (w, h) = rng.prng_key(7), (64, 48)
    assert int(bounces_entered(scene, key, w, h).max()) == 20
    k = MK.prepare_launch(scene, key, w, h, 1, FIXED)
    ct = torch.from_numpy(np.random.default_rng(7).standard_normal((h, w, 4)).astype(np.float32)).to(cuda_device)
    edge = (MK.launch(k) - MK.render_frame_reference(scene, key, w, h, 1, FIXED)).abs()[..., :3].amax(-1) > 1e-3
    ct_m = ct * (~edge)[..., None]
    g = MK.launch_backward(k, ct_m).cpu().double().numpy().ravel()
    r = MK.render_grad_reference(k.sv, scene, key, ct_m, w, h, 1, FIXED).cpu().double().numpy().ravel()
    assert np.isfinite(g).all() and np.abs(g - r).max() <= 1e-2 * np.abs(r).max()
    big = np.abs(r) > 1e-2 * np.abs(r).max()
    np.testing.assert_allclose(g[big], r[big], rtol=2e-2)


def test_backward_record_chunks(cuda_device):
    """A record buffer capped below one frame's records: the frame in
    chunks of whole blocks of pixels gives the one-chunk gradient bit for
    bit (each block sums as before); chunks of samples add the later
    samples' block sums to the earlier ones', a float32 sum in another
    order. Each chunk is one record kernel and one adjoint kernel launch,
    and the call one reduction. The two kernels launched apart on one
    record buffer, chunk by chunk, and the reduction give the gradient of
    the whole."""
    scene = make_scene(recursion_depth=3, device=cuda_device)
    key, (w, h) = rng.prng_key(31), (200, 150)
    ct = torch.from_numpy(np.random.default_rng(31).standard_normal((h, w, 4)).astype(np.float32)).to(cuda_device)
    for spp in (1, 3):
        k = MK.prepare_launch(scene, key, w, h, spp, VERBATIM)
        whole, pixels, samples = MK.record_plan(k)
        assert (pixels, samples) == (w * h, spp)
        g = MK.launch_backward(k, ct)
        per = whole // (w * h * spp)  # one pixel's sample
        for cap, chunks in ((per * 6400, 5 * spp), (per * w * h * 2, 2 if spp == 3 else 1)):
            nbytes, pixels, samples = MK.record_plan(k, cap)
            assert nbytes <= cap and -(-w * h // pixels) * -(-spp // samples) == chunks
            fn = MK.render_frame_megakernel
            before = (fn.bwd_launches, fn.record_launches, fn.adjoint_launches)
            g_cap = MK.launch_backward(k, ct, cap=cap)
            assert (fn.bwd_launches, fn.record_launches, fn.adjoint_launches) == (
                before[0] + 1, before[1] + chunks, before[2] + chunks)
            assert len(MK.record_chunks(k, cap)) == chunks
            if spp == 1:
                assert torch.equal(g_cap, g)
            else:
                assert float((g_cap - g).abs().max()) <= 1e-5 * float(g.abs().max())
        rec = MK.record_buffer(k)
        partial = torch.empty((-(-w * h // 128), k.sv.shape[1]), device=cuda_device)
        for chunk in MK.record_chunks(k):
            MK.launch_record(k, rec, chunk)
            MK.launch_adjoint(k, ct, rec, partial, chunk)
        grad = torch.empty_like(g)
        lib = _build.load("megakernel_bwd")
        assert lib.pt_backward_reduce(partial.data_ptr(), partial.shape[0], partial.shape[1], grad.data_ptr(),
                                      torch.cuda.current_stream(cuda_device).cuda_stream) == 0
        assert torch.equal(grad, g)


@pytest.mark.parametrize(
    "spp,quirks,seed,smooth_k", [(1, VERBATIM, 41, 0.0), (2, VERBATIM, 42, 0.0), (1, FIXED, 43, 0.0),
                                 (1, VERBATIM, 44, 0.3)],
    ids=["spp1", "spp2", "fixed", "smooth"],
)
def test_sdf_kernel_matches_plain_version(cuda_device, spp, quirks, seed, smooth_k):
    scene = sdf.make_scene(device=cuda_device)
    scene.params.smooth_k = torch.tensor(smooth_k, device=cuda_device)  # 0.3: the smooth union
    key = rng.prng_key(seed)
    launches = MK.render_frame_megakernel.launches
    img = MK.render_frame_megakernel(scene, key, 320, 240, spp, quirks)
    ref = MK.render_frame_reference(scene, key, 320, 240, spp, quirks)
    torch.cuda.synchronize()
    assert MK.render_frame_megakernel.launches == launches + 1
    assert_image_close(img.cpu(), ref.cpu())


def test_sdf_kernel_matches_jax_fixture(cuda_device):
    img = MK.render_frame_megakernel(sdf.make_scene(device=cuda_device), rng.prng_key(3), 64, 48)
    assert_image_close(img.cpu(), np.load(SDF_FIXTURE))


def test_sdf_library_takes_only_its_counts(cuda_device):
    """The SDF backend is built for each scene's counts: the twin-sphere
    scene (2, 1, 1) renders through a library of its own within the image
    gate, and the demo's library refuses its counts."""
    from test_torch_sdf_kernel_bwd_host import sdf_scene

    twin = sdf_scene(twin=True).to(cuda_device)
    key = rng.prng_key(45)
    img = MK.render_frame_megakernel(twin, key, 160, 120)
    assert_image_close(img.cpu(), MK.render_frame_reference(twin, key, 160, 120).cpu())
    k = MK.prepare_launch(twin, key, 160, 120, 1, VERBATIM)
    demo_lib = _build.load("megakernel_sdf", counts=(1, 1, 1))
    assert demo_lib.pt_render_forward_sdf(
        k.sv.data_ptr(), k.sv.shape[1], k.keys.data_ptr(), k.out.data_ptr(), 160, 120, 1, k.depth, k.n_lights,
        k.n_materials, k.flags, *k.counts, 0, 160 * 120, torch.cuda.current_stream(cuda_device).cuda_stream) != 0


def test_sdf_launches_on_two_streams(cuda_device):
    """Two scenes of the same counts share one SDF library: launched on two
    streams at once, each renders its own frame, as it does alone."""
    a, b = sdf.make_scene(device=cuda_device), sdf.make_scene(device=cuda_device)
    with torch.no_grad():
        b.params.sphere_radius.mul_(0.7)
    key = rng.prng_key(46)
    want = [MK.render_frame_megakernel(scene, key, 320, 240).clone() for scene in (a, b)]
    assert not torch.equal(*want)
    streams = torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device)
    torch.cuda.synchronize()
    frames = []
    for _ in range(4):
        for scene, stream in zip((a, b), streams):
            with torch.cuda.stream(stream):
                frames.append(MK.render_frame_megakernel(scene, key, 320, 240))
    torch.cuda.synchronize()
    assert all(torch.equal(f, want[i % 2]) for i, f in enumerate(frames))


def test_bigmesh_tables_built_once(cuda_device):
    """Frames of one big mesh scene share its tables: one build, the same
    frame as a scene whose tables are built anew."""
    from pathtracer_tpu_torch.ops import megakernel_bigmesh as MB

    scene = families.make_family_scene("bigmesh", device=cuda_device)
    builds = MB.bigmesh_tables.builds
    frames = [MK.render_frame_megakernel(scene, rng.prng_key(71), 128, 96) for _ in range(3)]
    assert MB.bigmesh_tables.builds == builds + 1
    fresh = MK.render_frame_megakernel(families.make_family_scene("bigmesh", device=cuda_device), rng.prng_key(71),
                                       128, 96)
    assert all(torch.equal(f, fresh) for f in frames)


def dim_first_material(scene):
    scene.params.materials.rgb.x[0] *= 0.5


@pytest.mark.parametrize("family", ["analytical", "sdf"])
def test_frames_of_an_unchanged_scene_reuse_its_vector(cuda_device, family):
    """Two frames of one scene pack it once and are bit-equal to each other
    and to a freshly built copy's; after an in-place edit of a material the
    next frame packs again and is a fresh scene's with that edit, bit for
    bit."""
    key = rng.prng_key(72)
    scene = families.make_family_scene(family, device=cuda_device)
    packs, reuses = MK.prepare_launch.packs, MK.prepare_launch.pack_reuses
    frames = [MK.render_frame_megakernel(scene, key, 320, 240) for _ in range(2)]
    assert (MK.prepare_launch.packs - packs, MK.prepare_launch.pack_reuses - reuses) == (1, 1)
    fresh = MK.render_frame_megakernel(families.make_family_scene(family, device=cuda_device), key, 320, 240)
    assert torch.equal(frames[0], frames[1]) and torch.equal(frames[0], fresh)
    with torch.no_grad():
        dim_first_material(scene)
    edited = MK.render_frame_megakernel(scene, key, 320, 240)
    assert MK.prepare_launch.packs - packs == 3
    other = families.make_family_scene(family, device=cuda_device)
    with torch.no_grad():
        dim_first_material(other)
    assert torch.equal(edited, MK.render_frame_megakernel(other, key, 320, 240))
    assert not torch.equal(edited, fresh)


class GradsOf:
    """Stands in for paired_step's optimizer: keeps the gradients it steps on."""

    def __init__(self, train):
        self.train, self.grads = train, None

    def zero_grad(self, set_to_none=True):
        for t in self.train:
            t.grad = None

    def step(self):
        self.grads = [t.grad.clone() for t in self.train]


def packing_render(width, height):
    """render_frame_megakernel as it was before scenes kept their vectors:
    the scene packed for every render."""

    def render(s, key):
        k = MK.prepare_launch(s, key, width, height, 1, VERBATIM)
        k = k._replace(sv=MK.BACKENDS[k.backend].pack(s, width, height, k.media).contiguous())
        if torch.is_grad_enabled() and k.sv.requires_grad:
            return MK.MegakernelRender.apply(k.sv, k)
        return MK.launch(k)

    return render


@pytest.mark.parametrize("family", ["analytical", "sdf"])
def test_paired_step_packs_every_render(cuda_device, family):
    """paired_step's rebuilt scene requires grad: both its renders pack, none
    reuses, and its loss and gradient are bit-equal to those of renders that
    pack every call."""
    true, start = inverse.demo_scenes(4, cuda_device, family)
    train, rebuild, _ = inverse.select_leaves(start, inverse.DEMO_SELECTS[family])
    render = inverse.make_renderer("megakernel", 160, 120, 1, VERBATIM)
    with torch.no_grad():
        target = render(true, rng.prng_key(73))
    results = []
    for r in (render, packing_render(160, 120)):
        opt = GradsOf(train)
        packs, reuses = MK.prepare_launch.packs, MK.prepare_launch.pack_reuses
        loss = inverse.paired_step(train, rebuild, inverse.PROJECTIONS[family], opt, r, target, rng.prng_key(74))
        results.append((loss, opt.grads, MK.prepare_launch.packs - packs, MK.prepare_launch.pack_reuses - reuses))
    (loss, grads, packs, reuses), (want_loss, want_grads, _, _) = results
    assert (packs, reuses) == (2, 0)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(grads, want_grads))


def test_march_step_kernel_matches_plain_version(cuda_device):
    scene = sdf.make_scene(device=cuda_device)
    launches = MS.measure_march_steps.launches
    got = MS.measure_march_steps(scene, 320, 240)
    assert MS.measure_march_steps.launches == launches + 1
    ref = MS.march_steps_reference(scene, 320, 240)
    for name, r in zip(("steps", "shadow_steps"), ref):
        assert got[name].device == cuda_device and got[name].shape == (240, 320)
        assert (got[name] == r).double().mean().item() >= 0.999, name


@pytest.mark.parametrize("smooth_k", [0.0, 0.3], ids=["hard", "smooth"])
def test_sdf_backward_kernel_matches_plain_version(cuda_device, smooth_k):
    """K2 with the SDF backend at 64x48, depth 4: through the autograd
    Function (one K1 and one K2 launch, both with the SDF backend), then
    against autograd of the plain version with knife-edge pixels masked."""
    scene = sdf.make_scene(device=cuda_device)
    scene.params.smooth_k = torch.tensor(smooth_k, device=cuda_device)
    key, (w, h) = rng.prng_key(41), (64, 48)
    leaf = scene.params.sphere_radius.requires_grad_(True)
    counts = (MK.render_frame_megakernel.sdf_launches, MK.render_frame_megakernel.sdf_bwd_launches)
    (g_leaf,) = torch.autograd.grad((MK.render_frame_megakernel(scene, key, w, h)[..., :3] ** 2).mean(), leaf)
    assert (MK.render_frame_megakernel.sdf_launches, MK.render_frame_megakernel.sdf_bwd_launches) == (
        counts[0] + 1, counts[1] + 1)
    assert torch.isfinite(g_leaf).all() and float(g_leaf.abs()) > 0
    leaf.requires_grad_(False)
    k = MK.prepare_launch(scene, key, w, h, 1, VERBATIM)
    ct = torch.from_numpy(np.random.default_rng(41).standard_normal((h, w, 4)).astype(np.float32)).to(cuda_device)
    assert torch.equal(MK.launch_backward(k, ct), MK.launch_backward(k, ct))  # reproducible bit for bit
    edge = (MK.launch(k) - MK.render_frame_reference(scene, key, w, h)).abs()[..., :3].amax(-1) > 1e-3
    ct_m = ct * (~edge)[..., None]
    g = MK.launch_backward(k, ct_m).cpu().double().numpy().ravel()
    r = MK.render_grad_reference(k.sv, scene, key, ct_m, w, h).cpu().double().numpy().ravel()
    assert np.isfinite(g).all() and np.abs(g - r).max() <= 1e-2 * np.abs(r).max()
    big = np.abs(r) > 1e-2 * np.abs(r).max()
    np.testing.assert_allclose(g[big], r[big], rtol=2e-2)


MESH_FIXTURES = {
    "mesh": os.path.join(os.path.dirname(__file__), "golden_torch", "mesh_64x48_d4_k3.npy"),
    "bigmesh": os.path.join(os.path.dirname(__file__), "golden_torch", "bigmesh_64x48_d4_k3.npy"),
}


@pytest.mark.parametrize("family", ["mesh", "bigmesh"])
@pytest.mark.parametrize("spp,quirks,seed", [(1, VERBATIM, 51), (2, VERBATIM, 52), (1, FIXED, 53)],
                         ids=["spp1", "spp2", "fixed"])
def test_mesh_kernel_matches_plain_version(cuda_device, family, spp, quirks, seed):
    """K1 with the mesh (K7) and the big mesh (K8) backend at 320x240,
    depth 4, one launch each, within the image gate."""
    scene = families.make_family_scene(family, device=cuda_device)
    key = rng.prng_key(seed)
    launches = getattr(MK.render_frame_megakernel, f"{family}_launches")
    img = MK.render_frame_megakernel(scene, key, 320, 240, spp, quirks)
    ref = MK.render_frame_reference(scene, key, 320, 240, spp, quirks)
    torch.cuda.synchronize()
    assert getattr(MK.render_frame_megakernel, f"{family}_launches") == launches + 1
    assert_image_close(img.cpu(), ref.cpu())


@pytest.mark.parametrize("family", ["mesh", "bigmesh"])
def test_mesh_kernel_matches_jax_fixture(cuda_device, family):
    img = MK.render_frame_megakernel(families.make_family_scene(family, device=cuda_device), rng.prng_key(3), 64, 48)
    assert_image_close(img.cpu(), np.load(MESH_FIXTURES[family]))


@pytest.mark.parametrize("family", ["bigmesh"])
def test_mesh_gradient_on_the_card_raises(cuda_device, family):
    """K2 takes no big mesh: its gradient on the card raises, and never
    runs eager autograd instead."""
    scene = families.make_family_scene(family, device=cuda_device)
    scene.params.vertices.x.requires_grad_(True)
    launches = MK.render_frame_megakernel.launches
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        MK.render_frame_megakernel(scene, rng.prng_key(0), 16, 8)
    assert MK.render_frame_megakernel.launches == launches


@pytest.mark.parametrize("spp,quirks,seed", [(1, VERBATIM, 91), (2, VERBATIM, 92), (1, FIXED, 93)],
                         ids=["spp1", "spp2", "fixed"])
def test_mesh_backward_kernel_matches_plain_version(cuda_device, spp, quirks, seed):
    """K2 with the mesh backend at 160x120, depth 4: through the autograd
    Function (one K1 and one K2 launch, both with the mesh backend), then
    against autograd of the plain version with the knife-edge pixels and
    those near an edge masked."""
    scene = families.make_family_scene("mesh", device=cuda_device)
    key, (w, h) = rng.prng_key(seed), (160, 120)
    leaf = scene.params.vertices.y.requires_grad_(True)
    counts = (MK.render_frame_megakernel.mesh_launches, MK.render_frame_megakernel.mesh_bwd_launches)
    (g_leaf,) = torch.autograd.grad((MK.render_frame_megakernel(scene, key, w, h, spp, quirks)[..., :3] ** 2).mean(),
                                    leaf)
    assert (MK.render_frame_megakernel.mesh_launches, MK.render_frame_megakernel.mesh_bwd_launches) == (
        counts[0] + 1, counts[1] + 1)
    assert torch.isfinite(g_leaf).all() and float(g_leaf.abs().max()) > 0
    leaf.requires_grad_(False)
    k = MK.prepare_launch(scene, key, w, h, spp, quirks)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32)).to(cuda_device)
    assert torch.equal(MK.launch_backward(k, ct), MK.launch_backward(k, ct))  # reproducible bit for bit
    edge = (MK.launch(k) - MK.render_frame_reference(scene, key, w, h, spp, quirks)).abs()[..., :3].amax(-1) > 1e-3
    margin, det = MM.hit_margins(scene, key, w, h, spp, quirks)
    near = ((margin < 3e-5) | (det < 1e-5)).flatten(0, 1).any(0).reshape(h, w)
    assert int(near.sum()) <= 1e-3 * w * h
    ct_m = ct * (~(edge | near))[..., None]
    g = MK.launch_backward(k, ct_m).cpu().double().numpy().ravel()
    r = MK.render_grad_reference(k.sv, scene, key, ct_m, w, h, spp, quirks).cpu().double().numpy().ravel()
    assert np.isfinite(g).all() and np.abs(g - r).max() <= 1e-2 * np.abs(r).max()
    big = np.abs(r) > 1e-2 * np.abs(r).max()
    np.testing.assert_allclose(g[big], r[big], rtol=2e-2)


def test_mesh_backward_kernel_matches_jax_fixture(cuda_device):
    """Every float leaf of the mesh scene through the autograd Function and
    pack_mesh_scene, at tests/test_torch_grad.py's tolerances (the
    geometry's for the vertices and the camera)."""
    scene = families.make_family_scene("mesh", device=cuda_device)
    leaves = dict(inverse.named_leaves(scene))
    with np.load(MESH_GRAD_FIXTURE) as data:
        want = {n: data[n] for n in data.files}
    names = sorted(want)
    for n in names:
        leaves[n].requires_grad_(True)
    counts = (MK.render_frame_megakernel.mesh_launches, MK.render_frame_megakernel.mesh_bwd_launches)
    img = MK.render_frame_megakernel(scene, rng.prng_key(3), 64, 48)
    grads = torch.autograd.grad((img[..., :3] ** 2).mean(), [leaves[n] for n in names], allow_unused=True)
    assert (MK.render_frame_megakernel.mesh_launches, MK.render_frame_megakernel.mesh_bwd_launches) == (
        counts[0] + 1, counts[1] + 1)
    for n, got in zip(names, grads):
        got = np.zeros(want[n].shape) if got is None else got.cpu().numpy()
        rtol, atol = (1e-2, 1e-7) if n.startswith(("params.vertices", "camera")) else (5e-3, 1e-8)
        np.testing.assert_allclose(got, want[n], rtol=rtol, atol=atol, err_msg=n)


def test_mesh_backward_kernel_refuses_what_its_shared_memory_cannot_hold(cuda_device):
    """A mesh whose packed vector fits K1's shared memory but whose gradient
    table exceeds K2's budget (the card's opt-in maximum) raises with its
    sizes."""
    scene = families.make_family_scene("mesh", device=cuda_device)
    p = scene.params.unpack()
    extra = torch.zeros(200, device=cuda_device)
    scene = scene.replace(params=p._replace(vertices=type(p.vertices)(*(torch.cat([c, extra]) for c in p.vertices))))
    k = MK.prepare_launch(scene, rng.prng_key(0), 8, 8, 1, VERBATIM)
    with pytest.raises(ValueError, match="shared memory"):
        MK.launch_backward(k, torch.zeros((8, 8, 4), device=cuda_device))


def test_mesh_training_step_is_two_forward_and_one_backward_launch(cuda_device):
    """inverse_render(kernel="megakernel") on a CUDA mesh scene: 2 K1-mesh
    launches and 1 K2-mesh launch a step, no other backend's."""
    scene = families.make_family_scene("mesh", recursion_depth=2, device=cuda_device)
    target = torch.full((16, 32, 4), 0.5, device=cuda_device)
    names = ("launches", "bwd_launches", "mesh_launches", "mesh_bwd_launches", "sdf_launches", "sdf_bwd_launches",
             "bigmesh_launches")
    before = {n: getattr(MK.render_frame_megakernel, n) for n in names}
    out = inverse.inverse_render(scene, target, rng.prng_key(3), ("params.vertices.y", "lights.emission"), 32, 16,
                                 steps=2, lr=3e-2, spp=1, kernel="megakernel")
    counts = {n: getattr(MK.render_frame_megakernel, n) - before[n] for n in names}
    assert counts == dict(launches=4, bwd_launches=2, mesh_launches=4, mesh_bwd_launches=2, sdf_launches=0,
                          sdf_bwd_launches=0, bigmesh_launches=0)
    assert np.isfinite(out.losses.cpu().numpy()).all()


@pytest.mark.parametrize("media", [False, True], ids=["plain", "media"])
def test_mesh_records_follow_k3_paths(cuda_device, media):
    """K2's record kernel traces K1's paths on the small mesh, both built
    without FMA contraction (csrc/megakernel_mesh.cu; K2 MEDIA's
    megakernel_bwd_media.cu): the bounces each path entered in its records
    equal K3's counts for the same keys, lane for lane (chip_smoke.py phase
    21 at 1920x1080)."""
    if media:
        scene = media_scene("mesh", MediumType.SCATTER, anisotropy=0.4, device=cuda_device, **DEMO)
    else:
        scene = families.make_family_scene("mesh", device=cuda_device)
    w, h, spp = 320, 240, 2
    k = MK.prepare_launch(scene, rng.prng_key(7), w, h, spp, VERBATIM)
    assert k.media == media
    entered = torch.empty((spp, h, w), dtype=torch.int32, device=cuda_device)
    MK.launch(k, entered)
    (chunk,) = MK.record_chunks(k)
    rec = MK.record_buffer(k)
    MK.launch_record(k, rec, chunk)
    lens = rec[rec.numel() - entered.numel():].view(torch.int32).reshape(entered.shape)
    assert torch.equal(lens, entered)


@pytest.mark.parametrize("family", ["analytical", "sdf", "mesh", "bigmesh"])
@pytest.mark.parametrize("spp,quirks,seed", [(1, VERBATIM, 101), (2, VERBATIM, 102), (1, FIXED, 103)],
                         ids=["spp1", "spp2", "fixed"])
def test_occupancy_kernel_matches_plain_version(cuda_device, family, spp, quirks, seed):
    """K3 at 320x240, depth 4, through measure_occupancy_megakernel: one K3
    launch with the scene's backend and no K1 launch; the counts against
    the plain version's; its frame bit-equal to K1's."""
    scene = families.make_family_scene(family, device=cuda_device)
    key, (w, h) = rng.prng_key(seed), (320, 240)
    occ, k1 = MK.measure_occupancy_megakernel, MK.render_frame_megakernel
    before = (occ.launches, getattr(occ, f"{family}_launches", 0), k1.launches)
    got = occ(scene, key, w, h, spp, quirks)
    assert (occ.launches, getattr(occ, f"{family}_launches", 0), k1.launches) == (
        before[0] + 1, before[1] + (family != "analytical"), before[2])
    ref = bounces_entered(scene, key, w, h, spp, quirks)
    assert got["entered"].shape == (spp, h, w) and got["entered"].device == cuda_device
    assert (got["entered"] == ref).double().mean().item() >= 0.999
    want = torch.stack([(ref > b).double().mean() for b in range(scene.recursion_depth)]).cpu()
    assert (got["alive_fraction"] - want).abs().max().item() <= 1e-3
    k = MK.prepare_launch(scene, key, w, h, spp, quirks)
    entered = torch.empty((spp, h, w), dtype=torch.int32, device=cuda_device)
    frame = MK.launch(k, entered).clone()
    assert torch.equal(entered, got["entered"])  # reproducible
    assert torch.equal(frame, MK.launch(k))
    # the compacted figure is that of the launch's tile, and none where the
    # backend runs the per-thread loop
    tile = MK.forward_layout(k)["tile_paths"]
    assert (tile > 0) == (family in ("analytical", "sdf", "mesh"))
    want = MK.occupancy_stats(got["entered"], scene.recursion_depth, tile)["compacted_wasted_fraction"]
    assert got["compacted_wasted_fraction"] == want and (want is None) == (tile == 0)


@pytest.mark.parametrize("family", ["analytical", "sdf", "mesh", "media"])
@pytest.mark.parametrize("w,h", [(33, 7), (1100, 3)])
def test_compacted_kernel_takes_a_part_empty_tile(cuda_device, family, w, h):
    """K1 and K3 of the backends that run the compacted loop (the analytical
    scene's and the small mesh's tiles of 1536 paths, the SDF scene's of
    256, and the analytical MEDIA instantiation's of 1536: csrc/
    megakernel_fwd.cuh Tiling) on frames whose last tile is part empty, spp 2:
    against the plain version, K3's frame bit-equal to K1's and its counts
    the plain version's on 99.9% of the lanes."""
    if family == "media":
        scene = media_scene("analytical", MediumType.SCATTER, anisotropy=0.4, device=cuda_device, **DEMO)
    else:
        scene = families.make_family_scene(family, device=cuda_device)
    key = rng.prng_key(w + h)
    k = MK.prepare_launch(scene, key, w, h, 2, VERBATIM)
    assert MK.forward_layout(k)["tile_paths"] > 0
    entered = torch.empty((2, h, w), dtype=torch.int32, device=cuda_device)
    frame = MK.launch(k, entered).clone()
    assert torch.equal(frame, MK.launch(k))
    assert_image_close(frame.cpu(), MK.render_frame_reference(scene, key, w, h, 2, VERBATIM).cpu())
    assert (entered == bounces_entered(scene, key, w, h, 2, VERBATIM)).double().mean().item() >= 0.999


@pytest.mark.parametrize("media", [False, True], ids=["plain", "media"])
def test_forward_kernel_refuses_what_its_shared_memory_cannot_hold(cuda_device, media):
    """An analytical scene whose packed vector and tile of paths need more
    shared memory a block than the card's opt-in maximum raises with both
    sizes before K1 launches; one that fits launches."""
    scene = media_scene("analytical", MediumType.SCATTER, anisotropy=0.4, device=cuda_device, **DEMO)
    k = MK.prepare_launch(scene, rng.prng_key(0), 8, 8, 1, VERBATIM)
    k = k._replace(media=media, sv=MK.pack_scene(scene, 8, 8, media).contiguous())
    budget = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    room = (budget - MK.forward_layout(k)["shared_bytes"]) // 4  # the scalars the vector may still take
    assert room > 0
    launches = MK.render_frame_megakernel.launches
    MK.launch(k._replace(sv=torch.cat([k.sv, torch.zeros((1, room - 4), device=cuda_device)], 1)))
    big = k._replace(sv=torch.cat([k.sv, torch.zeros((1, room + 4), device=cuda_device)], 1))
    with pytest.raises(ValueError, match=f"needs {MK.forward_layout(big)['shared_bytes']} bytes of shared memory.*"
                                         f"holds {budget}"):
        MK.launch(big)
    assert MK.render_frame_megakernel.launches == launches + 1


@pytest.mark.parametrize("media", [False, True], ids=["plain", "media"])
def test_mesh_kernel_refuses_what_its_shared_memory_cannot_hold(cuda_device, media):
    """A small mesh whose triangle table and tile of paths need more shared
    memory a block than the card's opt-in maximum (the demo's topology
    repeated to 3,000 triangles) raises with both sizes before K1 or K3
    launches; the demo itself fits."""
    scene = families.make_family_scene("mesh", device=cuda_device)
    if media:
        scene = media_scene("mesh", MediumType.SCATTER, anisotropy=0.4, depth=4, device=cuda_device, **DEMO)
    p = scene.params.unpack()
    budget = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    k = MK.prepare_launch(scene, rng.prng_key(0), 8, 8, 1, VERBATIM)
    assert MK.forward_layout(k)["shared_bytes"] <= budget
    reps = -(-3000 // p.tri_idx.shape[0])
    big = scene.replace(params=p._replace(tri_idx=p.tri_idx.repeat(reps, 1), tri_mat=p.tri_mat.repeat(reps)))
    k = MK.prepare_launch(big, rng.prng_key(0), 8, 8, 1, VERBATIM)
    assert k.media == media
    need = MK.forward_layout(k)["shared_bytes"]
    assert need > budget
    counts = (MK.render_frame_megakernel.launches, MK.measure_occupancy_megakernel.launches)
    with pytest.raises(ValueError, match=f"{k.counts[0]} triangles needs {need} bytes of shared memory.*holds {budget}"):
        MK.render_frame_megakernel(big, rng.prng_key(0), 8, 8)
    with pytest.raises(ValueError, match=f"needs {need} bytes"):
        MK.measure_occupancy_megakernel(big, rng.prng_key(0), 8, 8)
    assert (MK.render_frame_megakernel.launches, MK.measure_occupancy_megakernel.launches) == counts


@pytest.mark.parametrize("seed,num_tiles,n_uniforms,tile_rows", [(1234, 16, 16, 8), (7, 3, 34, 8), (-5, 2, 1, 4)])
def test_uniform_stream_kernel_matches_plain_version(cuda_device, seed, num_tiles, n_uniforms, tile_rows):
    launches = MK.debug_uniform_stream.launches
    got = MK.debug_uniform_stream(seed, num_tiles, n_uniforms, tile_rows, device=cuda_device)
    assert MK.debug_uniform_stream.launches == launches + 1
    assert got.device == cuda_device
    assert torch.equal(got, MK.debug_uniform_stream_reference(seed, num_tiles, n_uniforms, tile_rows, cuda_device))


def test_uniform_stream_kernel_passes_the_validation(cuda_device):
    result = validate_rng.validate(cuda_device)
    assert result["ok"], result


MEDIA_CASES = {
    "absorb": ("analytical", MediumType.ABSORB, DEMO),
    "emissive": ("analytical", MediumType.EMISSIVE, dict(density=0.5, color=(0.2, 0.8, 0.3))),
    "scatter": ("analytical", MediumType.SCATTER, dict(anisotropy=0.4, **DEMO)),
    "scatter_g0": ("analytical", MediumType.SCATTER, dict(density=2.0, color=(1.0, 1.0, 1.0))),
    "sdf_scatter": ("sdf", MediumType.SCATTER, dict(anisotropy=0.4, **DEMO)),
    "mesh_scatter": ("mesh", MediumType.SCATTER, dict(anisotropy=0.4, **DEMO)),
    "bigmesh_scatter": ("bigmesh", MediumType.SCATTER, dict(anisotropy=0.4, **DEMO)),
}


@pytest.mark.parametrize("spp,quirks,seed", [(1, VERBATIM, 111), (2, VERBATIM, 112), (1, FIXED, 113)],
                         ids=["spp1", "spp2", "fixed"])
@pytest.mark.parametrize("case", sorted(MEDIA_CASES))
def test_media_kernel_matches_plain_version(cuda_device, case, spp, quirks, seed):
    """K1's media instantiation at 320x240, depth 6: one launch, counted
    in media_launches, within the image gate of the plain version."""
    family, med_type, medium = MEDIA_CASES[case]
    scene = media_scene(family, med_type, device=cuda_device, **medium)
    key, (w, h) = rng.prng_key(seed), (320, 240)
    before = (MK.render_frame_megakernel.launches, MK.render_frame_megakernel.media_launches)
    img = MK.render_frame_megakernel(scene, key, w, h, spp, quirks)
    assert (MK.render_frame_megakernel.launches, MK.render_frame_megakernel.media_launches) == (
        before[0] + 1, before[1] + 1)
    ref = MK.render_frame_reference(scene, key, w, h, spp, quirks)
    keep = torch.ones((h, w), dtype=torch.bool)
    if family == "mesh":
        keep = ~(MM.hit_ties(scene, key, w, h, spp, quirks) < 1e-6).any(1).any(0).reshape(h, w).cpu()
    assert_image_close(img.cpu()[keep], ref.cpu()[keep])


def test_media_kernel_matches_jax_fixture(cuda_device):
    scene = media_scene("analytical", MediumType.SCATTER, device=cuda_device, anisotropy=0.4, **DEMO)
    img = MK.render_frame_megakernel(scene, rng.prng_key(3), 64, 48)
    assert_image_close(img.cpu(), np.load(MEDIA_FIXTURE))


@pytest.mark.parametrize("family", ["analytical", "sdf", "mesh", "bigmesh"])
def test_media_occupancy_kernel_matches_plain_version(cuda_device, family):
    """K3's media instantiation: one launch (counted in media_launches), its
    counts against bounces_entered on 99.9% of the lanes (the mesh's
    coplanar ties left out), its frame bit-equal to K1's media frame."""
    scene = media_scene(family, MediumType.SCATTER, device=cuda_device, anisotropy=0.4, **DEMO)
    key, (w, h) = rng.prng_key(121), (320, 240)
    occ = MK.measure_occupancy_megakernel
    before = (occ.launches, occ.media_launches)
    got = occ(scene, key, w, h)
    assert (occ.launches, occ.media_launches) == (before[0] + 1, before[1] + 1)
    keep = torch.ones((h, w), dtype=torch.bool, device=cuda_device)
    if family == "mesh":
        keep = ~(MM.hit_ties(scene, key, w, h) < 1e-6).any(1).any(0).reshape(h, w)
    same = got["entered"][:, keep] == bounces_entered(scene, key, w, h)[:, keep]
    assert same.double().mean().item() >= 0.999
    k = MK.prepare_launch(scene, key, w, h, 1, VERBATIM)
    assert k.media
    entered = torch.empty((1, h, w), dtype=torch.int32, device=cuda_device)
    frame = MK.launch(k, entered).clone()
    assert torch.equal(entered, got["entered"])
    assert torch.equal(frame, MK.launch(k))


@pytest.mark.parametrize("family", ["analytical", "sdf", "mesh"])
def test_media_backward_kernel_matches_plain_version(cuda_device, family):
    """K2's MEDIA instantiation at 160x120, depth 6, on each backend's glass
    Scatter scene: through the autograd Function (one K1 MEDIA and one K2
    MEDIA launch), then against autograd of the plain version with the
    knife-edge pixels (and the mesh's coplanar ties) masked."""
    scene = media_scene(family, MediumType.SCATTER, device=cuda_device, anisotropy=0.4, **DEMO)
    key, (w, h) = rng.prng_key(121), (160, 120)
    leaf = scene.params.materials.medium.color.x.requires_grad_(True)
    names = ("launches", "bwd_launches", "media_launches", "media_bwd_launches")
    before = {n: getattr(MK.render_frame_megakernel, n) for n in names}
    (g_leaf,) = torch.autograd.grad((MK.render_frame_megakernel(scene, key, w, h)[..., :3] ** 2).mean(), leaf)
    assert {n: getattr(MK.render_frame_megakernel, n) - before[n] for n in names} == dict.fromkeys(names, 1)
    assert torch.isfinite(g_leaf).all() and float(g_leaf.abs().max()) > 0
    leaf.requires_grad_(False)
    k = MK.prepare_launch(scene, key, w, h, 1, VERBATIM)
    assert k.media
    ct = torch.from_numpy(np.random.default_rng(121).standard_normal((h, w, 4)).astype(np.float32)).to(cuda_device)
    g0 = MK.launch_backward(k, ct)
    assert torch.equal(MK.launch_backward(k, ct), g0)  # reproducible bit for bit
    edge = (MK.launch(k) - MK.render_frame_reference(scene, key, w, h)).abs()[..., :3].amax(-1) > 1e-3
    if family == "mesh":
        edge |= (MM.hit_ties(scene, key, w, h) < 1e-6).any(1).any(0).reshape(h, w)
    ct_m = ct * (~edge)[..., None]
    g = MK.launch_backward(k, ct_m).cpu().double().numpy().ravel()
    r = MK.render_grad_reference(k.sv, scene, key, ct_m, w, h).cpu().double().numpy().ravel()
    assert np.isfinite(g).all() and np.abs(g - r).max() <= 1e-2 * np.abs(r).max()
    big = np.abs(r) > 1e-2 * np.abs(r).max()
    np.testing.assert_allclose(g[big], r[big], rtol=2e-2)
    glass = 0 if family == "sdf" else 1
    at = k.sv.shape[1] - 26 * (k.n_materials - glass) + 21
    assert g0[0, at] == 0.0 and float(g0[0, at + 1:at + 4].abs().max()) > 0  # density: the free flight is detached


def test_media_gradient_on_the_card_raises(cuda_device):
    """K2 takes no big mesh, with or without a medium: a CUDA big mesh media
    scene whose leaves require grad raises before any launch."""
    scene = media_scene("bigmesh", MediumType.SCATTER, device=cuda_device, anisotropy=0.4, **DEMO)
    scene.params.materials.medium.density.requires_grad_(True)
    before = (MK.render_frame_megakernel.launches, MK.render_frame_megakernel.bwd_launches)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        MK.render_frame_megakernel(scene, rng.prng_key(0), 16, 8)
    assert (MK.render_frame_megakernel.launches, MK.render_frame_megakernel.bwd_launches) == before


RANGE_FAMILIES = ("analytical", "sdf", "mesh", "bigmesh", "media")


def range_scene(family, device):
    if family == "media":
        return media_scene("analytical", MediumType.SCATTER, anisotropy=0.4, device=device, **DEMO)
    return families.make_family_scene(family, device=device)


@pytest.mark.parametrize("family", RANGE_FAMILIES)
def test_forward_kernel_over_pixel_ranges(cuda_device, family):
    """K1 over each rank's range of 2 and 3 ranks (parallel/mesh.
    shard_ranges) and over unaligned ranges at 320x240, spp 2: one launch
    a range, the single launch's pixels bit for bit, zeros elsewhere; the
    ranges summed are the single launch's frame."""
    from pathtracer_tpu_torch.parallel.mesh import shard_ranges

    scene, key, (w, h) = range_scene(family, cuda_device), rng.prng_key(121), (320, 240)
    n = w * h
    whole = MK.render_frame_megakernel(scene, key, w, h, 2).reshape(-1, 4)
    for ranges in (shard_ranges(n, 2), shard_ranges(n, 3), [(100, 777), (3001, 1), (257, n - 257)]):
        total = torch.zeros_like(whole)
        for begin, count in ranges:
            before = MK.render_frame_megakernel.launches
            part = MK.render_frame_megakernel(scene, key, w, h, 2, pixels=(begin, count)).reshape(-1, 4)
            assert MK.render_frame_megakernel.launches == before + 1
            assert torch.equal(part[begin:begin + count], whole[begin:begin + count]), (begin, count)
            assert not part[:begin].any() and not part[begin + count:].any()
            total += part
        if sum(c for _, c in ranges) == n:
            assert torch.equal(total, whole)


@pytest.mark.parametrize("family", ["analytical", "sdf", "mesh"])
def test_backward_kernel_range_gradients_sum_to_the_frame(cuda_device, family):
    """K2 over each of 2 ranks' ranges at 320x240: the two gradients summed
    are the whole frame's within 1e-5 of its largest entry (the reduction
    reads only the range's blocks; a block of another range, or one left
    unwritten, would show)."""
    from pathtracer_tpu_torch.parallel.mesh import shard_ranges

    scene, key, (w, h) = families.make_family_scene(family, device=cuda_device), rng.prng_key(122), (320, 240)
    ct = torch.from_numpy(np.random.default_rng(122).standard_normal((h, w, 4)).astype(np.float32)).to(cuda_device)
    whole = MK.launch_backward(MK.prepare_launch(scene, key, w, h, 1, VERBATIM), ct)
    parts = [MK.launch_backward(MK.prepare_launch(scene, key, w, h, 1, VERBATIM, r), ct)
             for r in shard_ranges(w * h, 2)]
    assert (parts[0] + parts[1] - whole).abs().max() <= 1e-5 * whole.abs().max()
    with pytest.raises(ValueError, match="block of 128"):
        MK.launch_backward(MK.prepare_launch(scene, key, w, h, 1, VERBATIM, (100, 300)), ct)


# Scene-backend plugins (tests/torch_plugin_toy.py), as chip_smoke.py phase
# 38: each plugin's library built from its header at the first launch.
PLUGIN_SCENES = {
    "toy": lambda device: toy.make_toy_scene(recursion_depth=4, device=device),
    "toy_extra": lambda device: toy.make_toy_scene(recursion_depth=4, device=device, extra=True),
    "stripes": lambda device: toy.make_stripes_scene(device=device),
    "toy_media": lambda device: toy.make_toy_media_scene(device=device),
}


@pytest.mark.parametrize("name", sorted(PLUGIN_SCENES))
def test_plugin_kernel_matches_plain_version(cuda_device, name):
    """Each plugin's K1 against its plain version at 320x240, spp 2, one
    launch counted in `<plugin>_launches` (the media toy's in
    media_launches too); K3's frame K1's bit for bit and its counts the
    plain version's on at least 99.9% of the lanes."""
    scene = PLUGIN_SCENES[name](cuda_device)
    family = families.family_of(scene)
    key, (w, h) = rng.prng_key(131), (320, 240)
    fn = MK.render_frame_megakernel
    before = (fn.launches, getattr(fn, f"{family}_launches"), fn.media_launches)
    img = fn(scene, key, w, h, 2)
    assert (fn.launches, getattr(fn, f"{family}_launches"), fn.media_launches) == (
        before[0] + 1, before[1] + 1, before[2] + int(name == "toy_media"))
    assert_image_close(img.cpu(), MK.render_frame_reference(scene, key, w, h, 2).cpu())
    k = MK.prepare_launch(scene, key, w, h, 2, VERBATIM)
    entered = torch.zeros((2, h, w), dtype=torch.int32, device=cuda_device)
    assert torch.equal(MK.launch(k, entered), img)
    same = float((entered == bounces_entered(scene, key, w, h, 2)).double().mean())
    assert same >= 0.999


@pytest.mark.parametrize("name", ["toy", "toy_media"])
def test_plugin_backward_kernel_matches_plain_version(cuda_device, name):
    """The toy's K2 (its adjoint struct; MEDIA on the glass toy) through the
    autograd Function against its plain version at K2's tolerance, one
    record and one adjoint launch counted in `toy_bwd_launches`."""
    scene = PLUGIN_SCENES[name](cuda_device)
    key, (w, h), seed = rng.prng_key(132), (320, 240), 132
    k = MK.prepare_launch(scene, key, w, h, 1, VERBATIM)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal((h, w, 4)).astype(np.float32)).to(cuda_device)
    edge = (MK.launch(k) - MK.render_frame_reference(scene, key, w, h)).abs()[..., :3].amax(-1) > 1e-3
    ct = ct * (~edge)[..., None]
    sv = k.sv.clone().requires_grad_(True)
    before = (MK.render_frame_megakernel.toy_bwd_launches, MK.render_frame_megakernel.record_launches)
    (g,) = torch.autograd.grad((MK.MegakernelRender.apply(sv, k) * ct).sum(), [sv])
    assert (MK.render_frame_megakernel.toy_bwd_launches, MK.render_frame_megakernel.record_launches) == (
        before[0] + 1, before[1] + 1)
    g = g.cpu().double().numpy().ravel()
    r = MK.render_grad_reference(k.sv, scene, key, ct, w, h).cpu().double().numpy().ravel()
    assert np.isfinite(g).all() and np.abs(g - r).max() <= 1e-2 * np.abs(r).max()
    big = np.abs(r) > 1e-2 * np.abs(r).max()
    np.testing.assert_allclose(g[big], r[big], rtol=2e-2)


@pytest.mark.parametrize("name", ["toy_extra", "stripes"])
def test_forward_only_plugin_gradient_on_the_card_raises(cuda_device, name):
    """A plugin with extras (toy_extra) or without an adjoint struct
    (stripes), whose CUDA scene requires grad, raises before any launch."""
    scene = PLUGIN_SCENES[name](cuda_device)
    leaf = scene.params.center.x if name == "toy_extra" else scene.params.sphere_radius
    leaf.requires_grad_(True)
    before = (MK.render_frame_megakernel.launches, MK.render_frame_megakernel.bwd_launches)
    with pytest.raises(NotImplementedError, match="extra tensors" if name == "toy_extra" else "no adjoint struct"):
        MK.render_frame_megakernel(scene, rng.prng_key(0), 16, 8)
    assert (MK.render_frame_megakernel.launches, MK.render_frame_megakernel.bwd_launches) == before


def test_plugin_kernel_over_pixel_ranges(cuda_device):
    """The toy's K1 over 2 and 3 ranks' ranges: the single launch's pixels
    bit for bit, one launch a range."""
    from pathtracer_tpu_torch.parallel.mesh import shard_ranges

    scene, key, (w, h) = PLUGIN_SCENES["toy"](cuda_device), rng.prng_key(133), (320, 240)
    whole = MK.render_frame_megakernel(scene, key, w, h).reshape(-1, 4)
    for ranks in (2, 3):
        total = torch.zeros_like(whole)
        for begin, count in shard_ranges(w * h, ranks):
            part = MK.render_frame_megakernel(scene, key, w, h, pixels=(begin, count)).reshape(-1, 4)
            assert torch.equal(part[begin:begin + count], whole[begin:begin + count])
            total += part
        assert torch.equal(total, whole)
