"""The megakernels: one CUDA launch renders a frame, two more (K2's record
and adjoint kernels) give its gradient.

Port of `pathtracer_tpu/ops/megakernel.py`. The TPU kernels
`_pallas_forward` (K1) and `_pallas_backward` (K2) become
`csrc/megakernel_fwd.cu` and `csrc/megakernel_bwd.cu`, hand-written CUDA
kernels for sm_90a with one thread per pixel. Both are generic over the
scene backend, as the JAX package's `KernelBackend` is: the analytical
scene (`csrc/analytical.cuh`, its adjoint `analytical_adj.cuh`), the
sphere-traced SDF scene (`csrc/sdf.cuh`, the port of the SDF backend K5,
`ops/megakernel_sdf.py`; its adjoint `sdf_adj.cuh`), the small triangle
mesh (`csrc/mesh.cuh`, K7, `ops/megakernel_mesh.py`; its adjoint
`mesh_adj.cuh`) and, in K1 only, the big one (`csrc/bigmesh.cuh`, K8,
`ops/megakernel_bigmesh.py`). The SDF backend is built for each scene's
primitive counts, as the JAX kernel is traced for them: its K1, K3, K6 and
K2 are `csrc/megakernel_sdf.cu` (and `megakernel_sdf_bwd_media.cu`), one
library for each count triple (`forward_library`, `backward_library`).
The scene reaches them packed into one float32 vector in the JAX
package's layout (`pack_scene`: camera basis,
analytical params, L light records of 15, M material records of 20, or 26
with the medium's six when a material declares one; each family's packer
in its module), with the tensors a backend takes beside it
(the mesh's topology, the big mesh's tables). A scene of a built-in family
whose leaves, frame size and medium have not changed since its last frame
is not packed again: it keeps its vector (`packed_scene`), as the big mesh
keeps its tables; one with a leaf that requires grad packs every frame,
and a plugin's does too. The random numbers are
threefry drawn in the kernel, bit-equal to `ops/rng`, so K1 renders the
same image as `integrator/tracer.render_frame` for the same key and K2
replays exactly K1's paths.

`render_frame_megakernel` is the wrapper. On a CUDA scene it launches K1,
through `MegakernelRender` (the port of `_diff_render`) when a scene leaf
requires grad, whose backward launches K2 (`launch_backward`: a record
kernel that traces each sample's path once and writes what each bounce
decided, then an adjoint kernel that runs the reverse sweep from those
records, and a reduction); `pack_scene` is ordinary torch
ops, so autograd carries d/d(sv) on to the scene leaves. A failed launch
raises; nothing falls back to autograd. On a CPU scene it runs the plain
version, the eager integrator under the detached-sampling estimator, with
autograd on every backend. A scene whose material table declares a
medium goes through K1's (and K3's) media instantiation, the port of
`_tile_bounce(has_media=True)`, on every backend, and its gradient
through K2's (`_make_grad_kernel(has_media=True)`'s counterpart,
`csrc/megakernel_bwd_media.cu`, built without FMA contraction) on the
analytical, SDF and mesh ones. The kernels take no procedural hooks (a
plugin whose struct wraps a backend's closest hit takes their place,
`tests/torch_plugin_toy.py` `stripes`), and K2 no big mesh: a CUDA big mesh
scene that requires grad raises (the JAX package differentiates it through
its XLA twin).

Every entry point takes a pixel range `pixels=(p_begin, p_count)` of the
frame, the whole frame by default, as the TPU kernels take a tile base and
a tile count: K1 (and K3) launch over the range's pixels only, drawing
each pixel's random numbers at its global counters, so the range's pixels
are the whole frame's bit for bit, and write nothing else (the frame is
zero there); K2 walks only the range's chunks and reduces only its blocks,
the gradient of the range's pixels. `parallel/mesh` gives each rank its
range.

Scene-backend plugins, the port of the JAX package's `KernelBackend` and
`register_backend`: code outside the package describes a scene family (its
packer and the packer's inverse, optional extra tensors, a `.cuh` header
with its backend structs) and registers it; `models/families.family_of`
then names it for the scenes its `matches` claims, and the wrappers below
take it as they take a built-in family, through K1, K3 and, where it gives
an adjoint struct and no extras, K2, built from `csrc/megakernel_plugin.cu`
at first use (`ops/_build.load_plugin`). A plugin's CUDA scene that
requires grad without them raises before any launch; on the CPU it runs
the plain version with autograd.

The instruments: `measure_occupancy_megakernel` (the port of
`measure_occupancy_pallas`) launches K3, `_pallas_forward_occupancy`'s
counterpart, which is K1's template compiled with a count of the bounces
each sample's path entered alive, on every backend; `occupancy_stats`
reduces the counts per block and per warp. `debug_uniform_stream` launches
K4 (`csrc/uniform_stream.cu`), which writes the uniforms K1's threads draw.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from ..integrator.tracer import VERBATIM, Quirks, bounces_entered, check_pixels, draw_uniforms, has_media, render_frame
from ..models import analytical, families
from ..models.families import family_of
from ..models.scene import Scene
from ..utils.metrics import Span
from . import megakernel_bigmesh, megakernel_mesh, megakernel_sdf, rng
from .pack import cols, pack_camera, pack_lights, pack_materials, unpack_camera, unpack_lights, unpack_materials
from .vecmath import V3

_FLAG_STALE_EMITTER_GATE = 1
_FLAG_PRIMARY_MIS = 2
_FLAG_RESPECT_MAX_DIST = 4

# The wrappers' host phases (utils/metrics.Span), read by the benchmark's
# k1_keys_host_ms.frames, k1_pack_host_ms.frames, k1_enqueue_host_ms.frames
# and k2_wrapper_host_ms.train
K1_KEYS = Span("k1_keys")  # prepare_launch: the keys split on the host and uploaded
K1_PACK = Span("k1_pack")  # prepare_launch: packed_scene, the key check or the packer as enqueued
K1_ENQUEUE = Span("k1_enqueue")  # launch: the checks, the library and the entry call
K2_WRAPPER = Span("k2_wrapper")  # launch_backward, the whole call


def pack_scene(scene: Scene, width: int, height: int, with_medium: bool = False) -> torch.Tensor:
    """The analytical scene as one [1, P] float32 vector on its device:
    P = 37 + 15 L + 20 M (26 M with_medium), 112 for the demo scene."""
    p = scene.params.unpack()
    sc = p.sphere_center
    head = torch.stack(
        cols(
            sc.x[0], sc.y[0], sc.z[0], sc.x[1], sc.y[1], sc.z[1],
            p.sphere_radius[0], p.sphere_radius[1],
            p.plane_point, p.plane_normal,
            p.checker_scale, p.checker_offset, p.checker_albedo[0], p.checker_albedo[1],
            p.sky_horizon, p.sky_zenith, p.sky_scale,
        )
    )
    flat = torch.cat(
        [
            pack_camera(scene, width, height),
            head,
            pack_lights(scene),
            pack_materials(p.materials, with_medium),
        ]
    )
    return flat[None, :]


def _check_supported(scene: Scene) -> None:
    """What the kernel does not take raises, on every device."""
    family_of(scene)
    if scene.procedural_fn is not None:
        raise NotImplementedError("procedural material hooks run on the eager integrator only; on the card, register "
                                  "a plugin whose backend struct wraps the family's closest hit and changes the "
                                  "material there (register_backend; tests/torch_plugin_toy.py, stripes)")


def scene_media(scene: Scene) -> bool:
    """Whether the scene's material table declares a medium, which selects
    the kernels' media instantiation and the 26-scalar material records.
    The check reads the device, which would make every frame wait for the
    card; a scene remembers the medium_type tensor and version it was
    checked with, and editing or replacing that tensor checks again. Each
    check that reads the device is counted in `scene_media.device_reads`."""
    mt = scene.params.materials.medium.medium_type
    seen = getattr(scene, "_media", None)
    if seen is None or seen[0] is not mt or seen[1] != mt._version:
        seen = (mt, mt._version, has_media(scene))
        scene._media = seen
        if mt.device.type != "cpu":
            scene_media.device_reads += 1
    return seen[2]


scene_media.device_reads = 0


def sample_keys(key, spp: int) -> torch.Tensor:
    """[spp, 4] int64 (kc0, kc1, kb0, kb1): sample s uses key (spp 1) or
    split(key, spp)[s], and draws its camera and bounce uniforms from
    (kc, kb) = split(k_s), as render_frame does."""
    ks = [key] if spp == 1 else list(rng.split(key, spp))
    return torch.stack([rng.split(k).reshape(-1) for k in ks])


def launch_keys(key, spp: int) -> torch.Tensor:
    """sample_keys as the kernels take them: [spp, 4] int32 holding the
    uint32 bits, on the host."""
    keys = sample_keys(key, spp)
    return torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)


def kernel_flags(scene: Scene, quirks: Quirks) -> int:
    """The quirk flags and the scene's shadow-ray semantics as the
    kernel's bit flags."""
    return (
        (_FLAG_STALE_EMITTER_GATE if quirks.stale_emitter_gate else 0)
        | (_FLAG_PRIMARY_MIS if quirks.primary_mis else 0)
        | (_FLAG_RESPECT_MAX_DIST if scene.any_hit_fn is analytical.any_hit_respecting_max_dist else 0)
    )


def unpack_scene(sv: torch.Tensor, scene: Scene) -> tuple[Scene, tuple]:
    """The inverse of pack_scene, with or without the medium: `scene` with every
    packed float leaf replaced by its entry of sv (so autograd through a
    render of it is d/d sv), and the camera basis (lower_left, horizontal,
    vertical, origin) that sv holds in place of the camera."""
    v = sv.reshape(-1)
    at3 = lambda i: V3(v[i], v[i + 1], v[i + 2])
    p = scene.params.unpack()
    params = p._replace(
        sphere_center=V3(v[[12, 15]], v[[13, 16]], v[[14, 17]]),
        sphere_radius=v[18:20], plane_point=at3(20), plane_normal=at3(23),
        checker_scale=v[26], checker_offset=v[27], checker_albedo=v[28:30],
        sky_horizon=at3(30), sky_zenith=at3(33), sky_scale=v[36],
    )
    lights_at = 37
    params = params._replace(materials=unpack_materials(v, lights_at + 15 * scene.num_lights, p.materials))
    return scene.replace(params=params, lights=unpack_lights(v, lights_at, scene)), unpack_camera(v)


class Backend(NamedTuple):
    """How the kernels take a scene family: its packer (with_medium as its
    fourth argument) and the packer's inverse (for the plain versions), the
    extra ints its entry points take after the flags, K1's and K3's entry
    points and the stem of K2's (`<stem>_record` and `<stem>_adjoint`; None
    where K2 does not take the family), the device tensors its entry points
    take before those ints, and K1's, K3's and K2's media entry points (the
    same arguments; K2's None as its media-free one); for a plugin, its
    KernelBackend (its library and its extras' pointer table)."""

    pack: Callable[..., torch.Tensor]
    unpack: Callable[[torch.Tensor, Scene], tuple]
    counts: Callable[[Scene], tuple]
    entry: str
    occupancy: str
    backward: str | None
    extras: Callable[[Scene], tuple]
    media_entry: str
    media_occupancy: str
    media_backward: str | None
    plugin: KernelBackend | None = None


class KernelBackend(NamedTuple):
    """A scene family that code outside the package registers for the
    kernels (register_backend), the port of the JAX package's KernelBackend:

    - `name` (the family's name, `family_of`'s answer) and `matches(scene)`,
      which claims a scene (the built-in families are asked first, then the
      plugins in registration order);
    - `pack(scene, width, height, with_medium)`: the [1, P] float32 packed
      vector on the scene's device, by torch ops (autograd carries d/d sv to
      the leaves): the camera (ops/pack.pack_camera), the plugin's own
      records, the lights (pack_lights) and the materials (pack_materials),
      in that order;
    - `unpack(sv, scene)`: its inverse, (the scene with its packed float
      leaves read from sv, the camera basis: unpack_camera), the plain
      version's input (render_frame_packed, render_grad_reference);
    - `header`: the path of a .cuh file that defines, in CUDA C++ over
      csrc/'s headers, the forward struct `forward` (tracer.cuh's hooks:
      closest_hit, a template over the material it fills, any_hit,
      background, reading the vector through SceneView) and, for K2, the
      adjoint struct `adjoint` (tracer_adj.cuh's: closest_hit_rec, surface,
      closest_hit_adj, background_adj), each named as code at global scope
      names it;
    - `extras(scene)`, optional: float32 tensors on the scene's device beside
      the vector (SceneView::extras, as the JAX package's `extra_of`); a
      plugin with extras is forward-only on the card."""

    name: str
    matches: Callable[[Scene], bool]
    pack: Callable[..., torch.Tensor]
    unpack: Callable[[torch.Tensor, Scene], tuple]
    header: str
    forward: str
    adjoint: str | None = None
    extras: Callable[[Scene], tuple] | None = None


BACKENDS = {
    "analytical": Backend(
        pack_scene, unpack_scene, lambda scene: (), "pt_render_forward", "pt_render_forward_occupancy",
        "pt_render_backward", lambda scene: (), "pt_render_forward_media", "pt_render_forward_occupancy_media",
        "pt_render_backward_media",
    ),
    "sdf": Backend(
        megakernel_sdf.pack_sdf_scene, megakernel_sdf.unpack_sdf_scene, megakernel_sdf.sdf_counts,
        "pt_render_forward_sdf", "pt_render_forward_occupancy_sdf", "pt_render_backward_sdf", lambda scene: (),
        "pt_render_forward_media_sdf", "pt_render_forward_occupancy_media_sdf", "pt_render_backward_media_sdf",
    ),
    "mesh": Backend(
        megakernel_mesh.pack_mesh_scene, megakernel_mesh.unpack_mesh_scene, megakernel_mesh.mesh_counts,
        "pt_render_forward_mesh", "pt_render_forward_occupancy_mesh", "pt_render_backward_mesh",
        megakernel_mesh.mesh_topology, "pt_render_forward_media_mesh", "pt_render_forward_occupancy_media_mesh",
        "pt_render_backward_media_mesh",
    ),
    "bigmesh": Backend(
        megakernel_bigmesh.pack_bigmesh_scene, megakernel_bigmesh.unpack_bigmesh_scene,
        megakernel_bigmesh.bigmesh_counts, "pt_render_forward_bigmesh", "pt_render_forward_occupancy_bigmesh", None,
        megakernel_bigmesh.bigmesh_tables, "pt_render_forward_media_bigmesh",
        "pt_render_forward_occupancy_media_bigmesh", None,
    ),
}


@functools.lru_cache(maxsize=None)
def plugin_source(plugin: KernelBackend):
    """What a plugin's library is built from (ops/_build.PluginSource), its
    header read at the first call for the plugin in the process, which
    keys its library from then on: a launch reads no file."""
    from . import _build

    return _build.plugin_source(plugin.name, plugin.header, plugin.forward, plugin.adjoint)


def register_backend(plugin: KernelBackend) -> None:
    """Register a scene-backend plugin, the port of the JAX package's
    register_backend: `family_of` names it for the scenes its `matches`
    claims (after the built-in families and the plugins registered before
    it), and render_frame_megakernel and measure_occupancy_megakernel launch
    K1 and K3 built for its `forward` struct, and its gradient K2 built for
    its `adjoint` struct (none: forward-only), from one library built at the
    first launch (ops/_build.load_plugin). Its launches are counted in
    `render_frame_megakernel.<name>_launches` and `.<name>_bwd_launches`
    and `measure_occupancy_megakernel.<name>_launches` too. A name that a
    built-in family or another plugin holds raises ValueError; nothing is
    built here."""
    families.register_plugin(plugin.name, plugin.matches)
    stem = "pt_render_backward_plugin" if plugin.adjoint is not None and plugin.extras is None else None
    BACKENDS[plugin.name] = Backend(
        plugin.pack, plugin.unpack, lambda scene: (), "pt_render_forward_plugin", "pt_render_forward_occupancy_plugin",
        stem, plugin.extras or (lambda scene: ()), "pt_render_forward_media_plugin",
        "pt_render_forward_occupancy_media_plugin", stem and "pt_render_backward_media_plugin", plugin,
    )
    for fn, counter in ((render_frame_megakernel, "launches"), (render_frame_megakernel, "bwd_launches"),
                        (measure_occupancy_megakernel, "launches")):
        setattr(fn, f"{plugin.name}_{counter}", 0)


def render_frame_reference(
    scene: Scene, key, width: int, height: int, spp: int = 1, quirks: Quirks = VERBATIM, pixels=None
) -> torch.Tensor:
    """The plain version of K1: the eager integrator's frame under the
    detached-sampling estimator, whose autograd is the plain version of K2
    (forward values are those of detach=False); over the pixel range
    `pixels` (p_begin, p_count), the frame's pixels there and zeros
    elsewhere."""
    return render_frame(scene, key, width, height, spp=spp, quirks=quirks, detach=True, pixels=pixels)


def render_frame_packed(
    sv: torch.Tensor, scene: Scene, key, width: int, height: int, spp: int = 1,
    quirks: Quirks = VERBATIM, pixels=None,
) -> torch.Tensor:
    """The plain version of K1 as a function of the packed scene vector
    (the kernel's own input): the eager frame of the scene its family's
    unpack (unpack_scene, megakernel_sdf.unpack_sdf_scene) reads from sv,
    the medium's fields too where sv holds 26-scalar material records."""
    s, basis = BACKENDS[family_of(scene)].unpack(sv, scene)
    return render_frame(s, key, width, height, spp=spp, quirks=quirks, detach=True, basis=basis, pixels=pixels)


def render_grad_reference(
    sv: torch.Tensor, scene: Scene, key, ct: torch.Tensor, width: int, height: int,
    spp: int = 1, quirks: Quirks = VERBATIM, pixels=None,
) -> torch.Tensor:
    """The plain version of K2: d(sum(ct * frame))/d(sv) [1, P] by autograd
    of render_frame_packed, over the pixel range `pixels` the gradient of
    its pixels only."""
    sv = sv.detach().requires_grad_(True)
    with torch.enable_grad():
        img = render_frame_packed(sv, scene, key, width, height, spp, quirks, pixels)
        (grad,) = torch.autograd.grad(img, sv, grad_outputs=ct)
    return grad


class KernelLaunch(NamedTuple):
    """Device inputs and scalars of one kernel launch."""

    sv: torch.Tensor  # [1, P] float32 packed scene
    keys: torch.Tensor  # [spp, 4] uint32 bits in int32: (kc0, kc1, kb0, kb1)
    out: torch.Tensor  # [H, W, 4] float32
    spp: int
    depth: int
    n_lights: int
    n_materials: int
    flags: int
    backend: str = "analytical"  # a key of BACKENDS
    counts: tuple = ()  # the backend's extra ints, e.g. the SDF scene's (spheres, boxes, tori)
    extras: tuple = ()  # the backend's device tensors, e.g. the mesh's topology
    media: bool = False  # the media instantiation, over 26-scalar material records
    pixels: tuple | None = None  # (p_begin, p_count) of the frame's flat pixels; None: the whole frame
    held: tuple = ()  # a plugin's extra tensors, which `extras` holds a device table of pointers to


def pixel_range(k: KernelLaunch) -> tuple[int, int]:
    """(p_begin, p_count) of launch `k`'s pixel range."""
    height, width = k.out.shape[:2]
    return check_pixels(width * height, k.pixels)


def prepare_launch(scene: Scene, key, width: int, height: int, spp: int, quirks: Quirks,
                   pixels=None) -> KernelLaunch:
    """Pack the scene and upload the sample keys for one frame, or for its
    pixel range `pixels` (p_begin, p_count; None: the whole frame), on the
    scene's CUDA device (on the CPU, what the host builds of the kernels'
    code take); a scene with a medium takes the media instantiation. A
    range's frame is zero outside it. The keys' split and upload are timed
    in the span `k1_keys`, the packing in `k1_pack` (`packed_scene`: a
    scene that has not changed since its last frame reuses that frame's
    vector, the key check inside the span)."""
    device = scene.device
    with K1_KEYS:
        keys = launch_keys(key, spp)
        if device.type == "cuda":
            keys = keys.pin_memory().to(device, non_blocking=True)
    backend = family_of(scene)
    b = BACKENDS[backend]
    media = scene_media(scene)
    begin, count = check_pixels(width * height, pixels)
    alloc = torch.empty if count == width * height else torch.zeros
    extras, counts, held = b.extras(scene), b.counts(scene), ()
    if b.plugin is not None:
        held, extras, counts = extras, (extras_table(backend, extras, device),), (len(extras),)
    with K1_PACK:
        sv = packed_scene(scene, backend, width, height, media)
    return KernelLaunch(
        sv=sv,
        keys=keys,
        out=alloc((height, width, 4), dtype=torch.float32, device=device),
        spp=spp,
        depth=scene.recursion_depth,
        n_lights=scene.num_lights,
        n_materials=int(scene.params.materials.roughness.shape[0]),
        flags=kernel_flags(scene, quirks),
        backend=backend,
        counts=counts,
        extras=extras,
        media=media,
        pixels=(begin, count),
        held=held,
    )


prepare_launch.packs = 0
prepare_launch.pack_reuses = 0


def _leaves(module, out: list) -> list:
    """`module`'s buffers and its children's, appended to `out` (the
    tensors of `module.buffers()`, walked at a quarter of its cost)."""
    out.extend(module._buffers.values())
    for child in module._modules.values():
        _leaves(child, out)
    return out


def _pack_key(scene: Scene, head: tuple) -> tuple:
    """(key, leaves): `head` and each scene leaf's identity, version and
    whether it requires grad, and the leaves, which the stored key keeps
    alive so that no other tensor takes one's identity."""
    leaves = _leaves(scene, [])
    return (head, [(id(t), t._version, t.requires_grad) for t in leaves]), leaves


def packed_scene(scene: Scene, backend: str, width: int, height: int, media: bool) -> torch.Tensor:
    """The scene packed by its backend's packer, contiguous. A progressive
    render packs the same scene every frame, some eighty small operations
    on the card for the same bits, so a scene of a built-in family keeps
    the vector it was last packed into with what the packer reads: every
    scene leaf (params, camera, lights) with its version and whether it
    requires grad, the frame's width and height, `media`, and the card's
    current stream, on which the vector was made and on which alone it is
    used again; with the vector's own version too, so that a caller that
    edits a launch's `sv` in place packs again. An in-place edit, a
    replaced leaf, `scene.to(...)` or a new scene (`scene.replace(...)`)
    packs again. An edit through `.data` is not seen: that alias has a
    version counter of its own, so such an edit keeps the old vector; edit
    the tensor itself under `torch.no_grad()` instead. A scene with a leaf
    that requires grad, whatever the grad mode, and a plugin's scene (its
    packer is code outside the package, which may read more than the
    leaves) keep nothing and pack every call, as does a vector made under
    `torch.inference_mode()`. Each pack is counted in
    `prepare_launch.packs`, each vector used again in
    `prepare_launch.pack_reuses`."""
    b = BACKENDS[backend]
    stream = torch.cuda.current_stream(scene.device) if scene.device.type == "cuda" else None
    head = (backend, width, height, media, stream)
    seen = getattr(scene, "_packed", None)
    key = None
    if seen is not None:
        key, leaves = _pack_key(scene, head)
        if key == seen[0] and seen[2]._version == seen[3]:
            prepare_launch.pack_reuses += 1
            return seen[2]
    sv = b.pack(scene, width, height, media).contiguous()
    prepare_launch.packs += 1
    if b.plugin is None and not sv.requires_grad and not sv.is_inference():
        if key is None:
            key, leaves = _pack_key(scene, head)
        if not any(grad for _, _, grad in key[1]):
            scene._packed = (key, leaves, sv, sv._version)
    return sv


def extras_table(backend: str, extras: tuple, device) -> torch.Tensor:
    """A plugin's extra tensors as its entry points take them: an int64
    table of their data pointers on `device` (SceneView::extras); each must
    be a contiguous float32 tensor there, or this raises."""
    for i, t in enumerate(extras):
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"the {backend} plugin's extra tensor {i} must be contiguous float32 on {device}, got "
                             f"{t.dtype} on {t.device}")
    table = torch.tensor([t.data_ptr() for t in extras], dtype=torch.int64)
    return table.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else table


def forward_library(k: KernelLaunch, csrc=None):
    """The library of K1's and K3's entry points for launch `k`'s backend,
    in this checkout's build or in that of the sources `csrc`
    (tools/k1_pair): the SDF scene's built for its primitive counts
    (`megakernel_sdf.cu`, where the tree has it), the small mesh's built
    without FMA contraction (`megakernel_mesh.cu`), the others'
    `megakernel_fwd`."""
    from . import _build

    csrc = csrc or _build.CSRC
    plugin = BACKENDS[k.backend].plugin
    if plugin is not None:
        return _build.load_plugin(plugin_source(plugin), csrc=csrc)
    if k.backend == "sdf" and "megakernel_sdf" in _build.per_count_kernels(csrc):
        return _build.load("megakernel_sdf", csrc=csrc, counts=k.counts)
    return _build.load("megakernel_mesh" if k.backend == "mesh" else "megakernel_fwd", csrc=csrc)


# The built-in backends' numbers in the libraries' resource and layout
# entry points; a plugin's library answers to PLUGIN_INDEX (and, for K2's
# MEDIA instantiation's resources, PLUGIN_INDEX + 1: megakernel_plugin.cu).
BUILT_IN_INDEX = ("analytical", "sdf", "mesh", "bigmesh")
PLUGIN_INDEX = 4


def _backend_index(k: KernelLaunch) -> int:
    """The backend's number in the libraries' resource and layout entry
    points."""
    return PLUGIN_INDEX if BACKENDS[k.backend].plugin is not None else BUILT_IN_INDEX.index(k.backend)


def _n_tris(k: KernelLaunch) -> int:
    """The triangles whose table K1 stages in shared memory (the small
    mesh's), else 0."""
    return k.counts[0] if k.backend == "mesh" else 0


def forward_layout(k: KernelLaunch) -> dict:
    """K1's and K3's layout for launch `k` in this checkout's kernels, read
    from their library without a call to the card: `shared_bytes`, the
    dynamic shared memory a block (the packed vector, the small mesh's
    triangle table and, compacted, the tile's path state), and
    `tile_paths`, the pixels of a block's tile in the compacted loop, 0 for
    a backend and instantiation that runs the per-thread loop
    (csrc/megakernel_fwd.cuh Tiling)."""
    from . import _build

    lib = forward_library(k, _build.CSRC)  # this checkout's, also where tools/k1_pair launches another's
    out = (ctypes.c_longlong * 2)()
    err = lib.pt_forward_layout(_backend_index(k), int(k.media), k.sv.shape[1], _n_tris(k), out)
    if err != 0:
        raise RuntimeError(f"forward megakernel layout: {lib.pt_error_string(err).decode()}")
    return {"shared_bytes": out[0], "tile_paths": out[1]}


def backward_library(k: KernelLaunch, csrc=None):
    """The library of K2's record and adjoint entry points for launch `k`'s
    backend and instantiation, in this checkout's build or in that of the
    sources `csrc` (tools/k2_pair): the SDF scene's built for its counts
    (`megakernel_sdf.cu`, `megakernel_sdf_bwd_media.cu`), where the tree
    has them; the small mesh's media-free one built with its K1
    (`megakernel_mesh.cu`); a plugin's, its K1's library."""
    from . import _build

    csrc = csrc or _build.CSRC
    if BACKENDS[k.backend].plugin is not None:
        return forward_library(k, csrc)
    if k.backend == "sdf" and "megakernel_sdf" in _build.per_count_kernels(csrc):
        return _build.load("megakernel_sdf_bwd_media" if k.media else "megakernel_sdf", csrc=csrc, counts=k.counts)
    if k.backend == "mesh" and not k.media:
        return _build.load("megakernel_mesh", csrc=csrc)
    return _build.load("megakernel_bwd_media" if k.media else "megakernel_bwd", csrc=csrc)


def launch(k: KernelLaunch, entered: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of K1 over launch `k`'s pixel range on PyTorch's current
    stream; returns `k.out`, whose other pixels it does not write. An empty
    range launches nothing and counts nothing.
    Counted in `render_frame_megakernel.launches`, and those with another
    backend than the analytical one in `render_frame_megakernel.
    <backend>_launches` too (sdf_launches, mesh_launches, bigmesh_launches,
    a plugin's <name>_launches);
    a launch of the media instantiation (`k.media`) in `.media_launches`
    too.

    With `entered`, an int32 [spp, H, W] tensor on the card, it is one
    launch of K3 instead: the same frame, and the bounces each sample's
    path entered alive written to `entered`; counted alike in
    `measure_occupancy_megakernel.launches` and `.<backend>_launches`.
    The whole call, K3's too, is timed in the span `k1_enqueue`.

    A scene whose packed vector, triangle table and tile need more shared
    memory a block than the card's opt-in maximum raises, naming both
    sizes."""
    with K1_ENQUEUE:
        shared = forward_layout(k)["shared_bytes"]
        budget = torch.cuda.get_device_properties(k.out.device).shared_memory_per_block_optin
        if shared > budget:
            raise ValueError(f"a {k.backend}{' media' if k.media else ''} scene of {k.sv.shape[1]} packed scalars and "
                             f"{_n_tris(k)} triangles needs {shared} bytes of shared memory per block in the forward "
                             f"megakernel, which holds {budget} (the card's opt-in maximum)"
                             + ("; the big mesh backend takes such a mesh" if k.backend == "mesh" else ""))
        lib = forward_library(k)
        height, width = k.out.shape[:2]
        begin, count = pixel_range(k)
        if count == 0:
            return k.out
        b, counter = BACKENDS[k.backend], render_frame_megakernel
        entry, head = getattr(lib, b.media_entry if k.media else b.entry), ()
        if entered is not None:
            if (entered.shape != (k.spp, height, width) or entered.dtype != torch.int32
                    or entered.device != k.out.device or not entered.is_contiguous()):
                raise ValueError(f"entered must be contiguous int32 {(k.spp, height, width)} on {k.out.device}, got "
                                 f"{entered.dtype} {tuple(entered.shape)} on {entered.device}")
            entry = getattr(lib, b.media_occupancy if k.media else b.occupancy)
            head, counter = (entered.data_ptr(),), measure_occupancy_megakernel
        err = entry(
            k.sv.data_ptr(), k.sv.shape[1], k.keys.data_ptr(), k.out.data_ptr(), *head,
            width, height, k.spp, k.depth, k.n_lights, k.n_materials, k.flags, *(t.data_ptr() for t in k.extras),
            *k.counts, begin, count, torch.cuda.current_stream(k.out.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"megakernel launch failed: {lib.pt_error_string(err).decode()}")
        counter.launches += 1
        if k.backend != "analytical":
            name = f"{k.backend}_launches"
            setattr(counter, name, getattr(counter, name) + 1)
        if k.media:
            counter.media_launches += 1
        return k.out


def _require_backward(backend: str, media: bool = False) -> None:
    """K2 takes the backend (with or without a medium), or this raises."""
    b = BACKENDS[backend]
    if (b.media_backward if media else b.backward) is not None:
        return
    if b.plugin is not None:
        why = "extra tensors (a plugin with extras is forward-only)" if b.plugin.extras else "no adjoint struct"
        raise NotImplementedError(f"the {backend} plugin's gradient on the card: it has {why}; its CPU scene has "
                                  "autograd")
    raise NotImplementedError(f"the {backend} scene's gradient on the card is not ported (ROADMAP item 12: the "
                              "JAX package differentiates it through its XLA twin, not a kernel); its CPU scene "
                              "has autograd")


def record_plan(k: KernelLaunch, cap: int | None = None) -> tuple[int, int, int]:
    """How K2's record buffer takes launch `k`'s pixel range
    (csrc/megakernel_bwd.cuh record_plan) within `cap` bytes (None: the
    source's cap, `pt_backward_record_cap()`, which also bounds any other):
    (its bytes, the pixels and the samples a chunk)."""
    from . import _build

    lib = _build.load("megakernel_bwd")
    cap = lib.pt_backward_record_cap() if cap is None else cap
    plan = (ctypes.c_int * 2)()
    nbytes = lib.pt_backward_record_bytes(max(pixel_range(k)[1], 1), k.spp, k.depth, int(k.media), cap, plan)
    if nbytes == 0:
        raise ValueError(f"one block's records at depth {k.depth} exceed the backward megakernel's record buffer "
                         f"of {min(cap, lib.pt_backward_record_cap())} bytes")
    return nbytes, plan[0], plan[1]


def record_chunks(k: KernelLaunch, cap: int | None = None) -> list[tuple[int, int, int, int]]:
    """record_plan's chunks of launch `k`'s pixel range, in launch order:
    (p0, pixels, k0, samples), samples [k0, k0 + samples) of pixels [p0, p0
    + pixels)."""
    _, pixels, samples = record_plan(k, cap)
    begin, count = pixel_range(k)
    end = begin + count
    return [(p0, min(pixels, end - p0), k0, min(samples, k.spp - k0))
            for p0 in range(begin, end, pixels) for k0 in range(0, k.spp, samples)]


def record_buffer(k: KernelLaunch, cap: int | None = None) -> torch.Tensor:
    """An uninitialised record buffer for launch `k` (record_plan's bytes,
    float32 words) on its device."""
    return torch.empty(record_plan(k, cap)[0] // 4, dtype=torch.float32, device=k.sv.device)


def record_args(k: KernelLaunch, rec: torch.Tensor, chunk: tuple) -> tuple:
    """The arguments of K2's record entry point of `k`'s backend for one
    chunk (record_chunks) into `rec`."""
    height, width = k.out.shape[:2]
    return (k.sv.data_ptr(), k.sv.shape[1], k.keys.data_ptr(), rec.data_ptr(), width, height, k.spp, k.depth,
            k.n_lights, k.n_materials, k.flags, *(t.data_ptr() for t in k.extras), *k.counts, *chunk,
            torch.cuda.current_stream(k.sv.device).cuda_stream)


def adjoint_args(k: KernelLaunch, ct: torch.Tensor, rec: torch.Tensor, partial: torch.Tensor, chunk: tuple) -> tuple:
    """The arguments of K2's adjoint entry point of `k`'s backend for one
    chunk from `rec` into `partial`; ct contiguous float32 [H, W, 4]."""
    height, width = k.out.shape[:2]
    return (k.sv.data_ptr(), k.sv.shape[1], k.keys.data_ptr(), ct.data_ptr(), rec.data_ptr(), partial.data_ptr(),
            width, height, k.spp, k.depth, k.n_lights, k.n_materials, k.flags, *(t.data_ptr() for t in k.extras),
            *k.counts, *chunk, torch.cuda.current_stream(k.sv.device).cuda_stream)


def backward_entries(k: KernelLaunch, lib=None) -> tuple:
    """The record and adjoint entry points of `k`'s backend and
    instantiation, and their library: this checkout's backward_library, or
    `lib` (another tree's, tools/k2_pair)."""
    lib = lib or backward_library(k)
    b = BACKENDS[k.backend]
    stem = b.media_backward if k.media else b.backward
    return getattr(lib, f"{stem}_record"), getattr(lib, f"{stem}_adjoint"), lib


def _check(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"backward megakernel {what} launch failed: {lib.pt_error_string(err).decode()}")


def launch_record(k: KernelLaunch, rec: torch.Tensor, chunk: tuple) -> None:
    """One launch of K2's record kernel for one chunk of launch `k`'s frame
    (record_chunks) into `rec` (record_plan's bytes), on PyTorch's current
    stream; counted in `render_frame_megakernel.record_launches`."""
    record, _, lib = backward_entries(k)
    _check(record(*record_args(k, rec, chunk)), lib, "record kernel")
    render_frame_megakernel.record_launches += 1


def launch_adjoint(k: KernelLaunch, ct: torch.Tensor, rec: torch.Tensor, partial: torch.Tensor, chunk: tuple) -> None:
    """One launch of K2's adjoint kernel for the same chunk from the records
    launch_record wrote into `rec`, into partial [ceil(W*H/128), P] (a
    chunk of later samples adds to the earlier ones' block sums), on
    PyTorch's current stream; counted in
    `render_frame_megakernel.adjoint_launches`."""
    _, adjoint, lib = backward_entries(k)
    _check(adjoint(*adjoint_args(k, ct, rec, partial, chunk)), lib, "adjoint kernel")
    render_frame_megakernel.adjoint_launches += 1


def launch_backward(k: KernelLaunch, ct: torch.Tensor, cap: int | None = None) -> torch.Tensor:
    """K2 on PyTorch's current stream: d(sum(ct * frame))/d(sv) [1, P] for
    the frame K1 renders from `k`, over its pixel range the gradient of the
    range's pixels (the range starts on one of K2's blocks of
    `pt_backward_threads()` pixels, as parallel/mesh.shard_ranges' do);
    ct [H, W, 4] float32 (its alpha channel, and its pixels outside the
    range, get no gradient). K2 is two kernels: for each chunk of record_chunks
    (the record buffer allocated here holds at most
    `pt_backward_record_cap()` bytes, or `cap` where that is less, which
    makes chunks of a small frame) the record kernel traces each sample's
    path once and writes what each bounce decided (launch_record), and the
    adjoint kernel runs the reverse sweep from those records
    (launch_adjoint); then a reduction sums the range's blocks, one launch a
    call,
    counted in `render_frame_megakernel.bwd_launches`, and those with
    another backend than the analytical one in
    `render_frame_megakernel.<backend>_bwd_launches` too (sdf_bwd_launches,
    mesh_bwd_launches, a plugin's <name>_bwd_launches), a launch of the
    media instantiation (`k.media`) in
    `.media_bwd_launches` too; the record buffer's bytes (record_plan's)
    are added to `.record_bytes`, and the whole call is timed in the span
    `k2_wrapper` (on autograd's device thread under a backward).
    A scene whose packed vector, gradient table and triangle table exceed K2's
    shared memory per block (the card's opt-in maximum), or with more
    lights than its records index, raises."""
    from . import _build

    with K2_WRAPPER:
        if k.sv.device.type != "cuda":
            raise ValueError("the backward megakernel needs CUDA tensors")
        _require_backward(k.backend, k.media)
        lib = _build.load("megakernel_bwd")
        if k.backend == "sdf" and sum(k.counts) + 1 > lib.pt_backward_sdf_max_primitives():
            raise ValueError(f"the backward megakernel holds {lib.pt_backward_sdf_max_primitives()} SDF primitives "
                             f"(the plane included), got {sum(k.counts) + 1}")
        if k.n_lights > lib.pt_backward_max_lights():
            raise ValueError(f"the backward megakernel's records index {lib.pt_backward_max_lights()} lights, got "
                             f"{k.n_lights}")
        height, width = k.out.shape[:2]
        n_sv = k.sv.shape[1]
        n_tris = k.counts[0] if k.backend == "mesh" else 0
        smem = lib.pt_backward_smem_bytes(n_sv, n_tris)
        budget = torch.cuda.get_device_properties(k.sv.device).shared_memory_per_block_optin
        if smem > budget:
            raise ValueError(f"a scene of {n_sv} packed scalars and {n_tris} triangles needs {smem} bytes of shared "
                             f"memory per block in the backward megakernel, which holds {budget} (the card's opt-in "
                             "maximum)")
        if ct.shape != k.out.shape or ct.device != k.sv.device:
            raise ValueError(f"cotangent {tuple(ct.shape)} on {ct.device}, frame {tuple(k.out.shape)} on {k.sv.device}")
        threads = lib.pt_backward_threads()
        begin, count = pixel_range(k)
        if begin % threads != 0:
            raise ValueError(f"the backward megakernel's pixel range starts on a block of {threads} pixels, got "
                             f"{begin}")
        grad = torch.zeros((1, n_sv), dtype=torch.float32, device=k.sv.device)
        if count == 0:
            return grad
        ct = ct.to(torch.float32).contiguous()
        rec = record_buffer(k, cap)
        # the adjoint kernel writes block b's sums to row b of the frame's
        # blocks; the reduction reads only the range's rows
        partial = torch.empty((-(-width * height // threads), n_sv), dtype=torch.float32, device=k.sv.device)
        first, blocks = begin // threads, -(-count // threads)
        for chunk in record_chunks(k, cap):
            launch_record(k, rec, chunk)
            launch_adjoint(k, ct, rec, partial, chunk)
        stream = torch.cuda.current_stream(k.sv.device).cuda_stream
        _check(lib.pt_backward_reduce(partial[first].data_ptr(), blocks, n_sv, grad.data_ptr(), stream), lib,
               "reduction")
        counter = render_frame_megakernel
        counter.bwd_launches += 1
        counter.record_bytes += rec.nbytes
        if k.backend != "analytical":
            name = f"{k.backend}_bwd_launches"
            setattr(counter, name, getattr(counter, name) + 1)
        if k.media:
            counter.media_bwd_launches += 1
        return grad


def backward_resources(k: KernelLaunch) -> dict:
    """K2's two kernels of launch `k`'s backend and instantiation on the
    card: {"record": ..., "adjoint": ...}, each its registers, stack bytes a
    thread, dynamic shared bytes a block and blocks an SM (the CUDA
    runtime's occupancy calculator)."""
    lib = backward_library(k)
    out = (ctypes.c_int * 8)()
    index = _backend_index(k) + (int(k.media) if _backend_index(k) == PLUGIN_INDEX else 0)
    err = lib.pt_backward_resources(index, k.sv.shape[1], _n_tris(k), out)
    if err != 0:
        raise RuntimeError(f"backward megakernel resources: {lib.pt_error_string(err).decode()}")
    names = ("registers", "stack_bytes", "shared_bytes", "blocks_per_sm")
    return {kernel: dict(zip(names, out[4 * i:4 * i + 4])) for i, kernel in enumerate(("record", "adjoint"))}


def forward_resources(k: KernelLaunch, count: bool = False) -> dict:
    """K1's (K3's with `count`) kernel of launch `k`'s backend and
    instantiation on the card: its registers, stack bytes a thread, dynamic
    shared bytes a block and blocks an SM (the CUDA runtime's occupancy
    calculator); the analytical, mesh and big mesh backends."""
    lib = forward_library(k)
    out = (ctypes.c_int * 4)()
    err = lib.pt_forward_resources(_backend_index(k), int(k.media), int(count), k.sv.shape[1], _n_tris(k), out)
    if err != 0:
        raise RuntimeError(f"forward megakernel resources: {lib.pt_error_string(err).decode()}")
    return dict(zip(("registers", "stack_bytes", "shared_bytes", "blocks_per_sm"), out))


class MegakernelRender(torch.autograd.Function):
    """The port of `_diff_render`: K1 forward over the packed scene vector,
    K2 backward. Only sv gets a gradient; the keys get none, as the
    detached-sampling estimator requires."""

    @staticmethod
    def forward(ctx, sv: torch.Tensor, k: KernelLaunch) -> torch.Tensor:
        k = k._replace(sv=sv.detach())
        ctx.launch = k
        return launch(k)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return launch_backward(ctx.launch, ct), None


def _check_frame(scene: Scene, width: int, height: int, spp: int) -> None:
    """What the kernels do not take raises: their float32 scenes on the
    card, a frame of at least one pixel and sample."""
    if scene.device.type != "cuda":
        raise ValueError(f"unsupported device {scene.device}")
    if scene.dtype != torch.float32:
        raise ValueError(f"the megakernel renders float32 scenes, got {scene.dtype}")
    if width < 1 or height < 1 or spp < 1:
        raise ValueError(f"bad frame size {width}x{height}, spp {spp}")


def render_frame_megakernel(
    scene: Scene, key, width: int, height: int, spp: int = 1, quirks: Quirks = VERBATIM, pixels=None
) -> torch.Tensor:
    """Render one frame -> [H, W, 4] float32 on the scene's device; with
    `pixels` (p_begin, p_count) only that range of its flat pixels, the
    whole frame's there bit for bit, the frame zero elsewhere (an empty
    range launches nothing).

    A CUDA scene goes through K1 (one launch, counted in
    `render_frame_megakernel.launches`) with its scene's backend; when a
    scene leaf requires grad, the frame's backward is one call of K2 with
    the same backend (counted in `render_frame_megakernel.bwd_launches`;
    its record and adjoint kernels' launches, one each a chunk, in
    `.record_launches` and `.adjoint_launches`, its record buffer's bytes
    in `.record_bytes`);
    K2 takes no big mesh, nor a plugin without an adjoint struct or with
    extra tensors, and such a gradient on the card raises
    NotImplementedError before any launch. A scene with a medium takes K1's
    and K2's media instantiations (also counted in
    `render_frame_megakernel.media_launches` and `.media_bwd_launches`). A
    CPU scene goes through the plain version.
    There is no fallback from one to the other."""
    _check_supported(scene)
    device = scene.device
    if device.type == "cpu":
        return render_frame_reference(scene, key, width, height, spp, quirks, pixels)
    _check_frame(scene, width, height, spp)
    k = prepare_launch(scene, key, width, height, spp, quirks, pixels)
    if pixel_range(k)[1] == 0:
        return k.out
    if torch.is_grad_enabled() and (k.sv.requires_grad or any(t.requires_grad for t in k.extras + k.held)):
        _require_backward(k.backend, k.media)
        return MegakernelRender.apply(k.sv, k)
    return launch(k)


render_frame_megakernel.launches = 0
render_frame_megakernel.sdf_launches = 0
render_frame_megakernel.mesh_launches = 0
render_frame_megakernel.bigmesh_launches = 0
render_frame_megakernel.media_launches = 0
render_frame_megakernel.bwd_launches = 0
render_frame_megakernel.sdf_bwd_launches = 0
render_frame_megakernel.mesh_bwd_launches = 0
render_frame_megakernel.media_bwd_launches = 0
render_frame_megakernel.record_launches = 0
render_frame_megakernel.adjoint_launches = 0
render_frame_megakernel.record_bytes = 0


# A row of lanes: of JAX's tiles and of debug_uniform_stream's output, and
# the threads a block of K1's and K3's per-thread loop (csrc/megakernel_fwd.cuh
# THREADS)
LANES = 128
WARP = megakernel_sdf.WARP


def occupancy_stats(entered: torch.Tensor, depth: int, tile_paths: int = 0) -> dict:
    """Reduce K3's per-lane counts (int32 [spp, H, W], the bounces each
    sample's path entered alive) on their device; the results are on the
    host:
      alive_fraction [depth]: lanes alive entering each bounce over all;
      wasted_fraction: 1 - their mean, what compaction could recover;
      counts [num_tiles, depth]: per tile, the lanes alive entering each
        bounce, a tile being one of the launch's blocks (LANES consecutive
        pixels, all their spp samples: JAX's flat tiling with tile_rows =
        spp); tile, num_tiles, tiling as JAX's measure_occupancy_pallas;
      block_alive_fraction [depth]: the tiles with a live lane entering
        each bounce;
      warp_alive_fraction [depth]: the warps (WARP consecutive pixels, one
        sample: the threads run their samples in turn) with a live lane
        entering each bounce, over all warps; such a warp runs the bounce;
      warp_lanes [depth]: the live lanes per live warp entering each bounce;
      warp_wasted_fraction: the idle lanes of the live warps over all their
        lanes, summed over the bounces: what the per-thread loop runs masked;
      compacted_wasted_fraction: the same share for the compacted loop,
        which lists each tile's live paths (`tile_paths` consecutive
        pixels, one sample) before a bounce and runs them in
        ceil(live / WARP) warps: the idle lane slots its segments leave;
        None without a tile (`tile_paths` 0: the per-thread loop).
    Only real pixels count: the lanes past the frame in the last block or
    warp are dead, and only the warps' lane slots count them."""
    spp, height, width = entered.shape
    n = height * width
    alive = (entered.reshape(1, spp, n) > torch.arange(depth, device=entered.device).view(depth, 1, 1)).to(torch.int32)

    def groups(size):  # live lanes of each group of `size` pixels, [depth, spp, groups]
        return torch.nn.functional.pad(alive, (0, -n % size)).reshape(depth, spp, -1, size).sum(-1)

    warps = groups(WARP)
    lanes = alive.sum(dim=(1, 2))
    live_warps = (warps > 0).sum(dim=(1, 2))
    compacted = None
    if tile_paths:
        compacted_warps = int(((groups(tile_paths) + WARP - 1) // WARP).sum())
        compacted = 1.0 - int(lanes.sum()) / (WARP * compacted_warps)
    counts = groups(LANES).sum(1).T
    lanes, live_warps, counts = lanes.cpu().double(), live_warps.cpu().double(), counts.cpu()
    alive_fraction = lanes / (spp * n)
    return {
        "alive_fraction": alive_fraction,
        "wasted_fraction": 1.0 - float(alive_fraction.mean()),
        "counts": counts,
        "tile": LANES * spp,
        "num_tiles": counts.shape[0],
        "tiling": "flat",
        "block_alive_fraction": (counts > 0).double().mean(0),
        "warp_alive_fraction": live_warps / (spp * warps.shape[2]),
        "warp_lanes": lanes / live_warps.clamp_min(1),
        "warp_wasted_fraction": 1.0 - float(lanes.sum() / (WARP * live_warps.sum())),
        "compacted_wasted_fraction": compacted,
    }


def measure_occupancy_megakernel(
    scene: Scene, key, width: int, height: int, spp: int = 1, quirks: Quirks = VERBATIM, pixels=None
) -> dict:
    """Masked-lane occupancy measured inside the forward megakernel: the
    port of `measure_occupancy_pallas`. A CUDA scene goes through one launch
    of K3 with the scene's backend (counted in
    `measure_occupancy_megakernel.launches` and `.<backend>_launches`, and
    a scene with a medium, whose launch takes K3's media instantiation, in
    `.media_launches` too), a CPU scene through its plain version, `integrator/tracer.bounces_entered`;
    a failed build or launch raises. Returns `occupancy_stats` of the
    per-lane counts, with the counts themselves as `entered`; on the card,
    the compacted figure for the tile of the launch's loop (none where it
    is the per-thread loop: `forward_layout`), on the CPU none. Over the
    pixel range `pixels` (p_begin, p_count), K3 runs the range's pixels
    only: `entered` is zero elsewhere, and the statistics are the range's,
    its tiles and warps counted from p_begin as the launch's blocks are.

    It takes no `uniforms=` or `tiling=`: the port has one stream, threefry
    at JAX's counters (its "hbm" numbers), and its tiles are the launch's
    blocks. So at spp 1 `alive_fraction` is the eager probe
    `integrator/tracer.measure_occupancy`'s, and at spp > 1 it is the
    kernels' stream's (the probe draws one stream over all lanes). Unlike
    the TPU kernel, padded lanes never count."""
    _check_supported(scene)
    tile = 0
    begin, count = check_pixels(width * height, pixels)
    if scene.device.type == "cpu":
        entered = bounces_entered(scene, key, width, height, spp, quirks, pixels)
    else:
        _check_frame(scene, width, height, spp)
        k = prepare_launch(scene, key, width, height, spp, quirks, pixels)
        alloc = torch.empty if count == width * height else torch.zeros
        entered = alloc((spp, height, width), dtype=torch.int32, device=scene.device)
        launch(k, entered)
        tile = forward_layout(k)["tile_paths"]
    counted = entered.reshape(spp, 1, -1)[..., begin:begin + count]
    return {"entered": entered, **occupancy_stats(counted, scene.recursion_depth, tile)}


measure_occupancy_megakernel.launches = 0
measure_occupancy_megakernel.sdf_launches = 0
measure_occupancy_megakernel.mesh_launches = 0
measure_occupancy_megakernel.bigmesh_launches = 0
measure_occupancy_megakernel.media_launches = 0


def debug_uniform_stream_reference(
    seed: int, num_tiles: int, n_uniforms: int, tile_rows: int = 8, device=None
) -> torch.Tensor:
    """The plain version of K4: [num_tiles, n_uniforms, tile_rows, 128]
    float32, out[t, k, r, l] draw k of pixel p = (t * tile_rows + r) * 128
    + l of `integrator/tracer.draw_uniforms(prng_key(seed), N, depth)`
    over N = num_tiles * tile_rows * 128 pixels: draws 0 and 1 its camera
    draws, draw k >= 2 draw (k - 2) % 8 of bounce (k - 2) // 8."""
    n = num_tiles * tile_rows * LANES
    depth = max(0, -(-(n_uniforms - 2) // 8))
    cam, bounce = draw_uniforms(rng.prng_key(seed), n, depth, torch.float32, device)
    rows = [cam[:, 0], cam[:, 1]] + [bounce[d, :, j] for d in range(depth) for j in range(8)]
    u = torch.stack(rows[:n_uniforms]) if n_uniforms else cam.new_empty((0, n))
    return u.reshape(n_uniforms, num_tiles, tile_rows, LANES).permute(1, 0, 2, 3).contiguous()


def debug_uniform_stream(
    seed: int, num_tiles: int, n_uniforms: int, tile_rows: int = 8, device="cuda"
) -> torch.Tensor:
    """The megakernels' in-kernel uniform stream, for validation: the port
    of the JAX package's `debug_uniform_stream` (same arguments, same
    [num_tiles, n_uniforms, tile_rows, 128] float32 output). On a CUDA
    device one launch of K4 (`csrc/uniform_stream.cu`, counted in
    `debug_uniform_stream.launches`) draws what K1's thread for each pixel
    draws from the frame key prng_key(seed) at spp 1, through K1's own
    device functions; on the CPU its plain version,
    `debug_uniform_stream_reference`. The TPU kernel's stream (the core
    PRNG seeded per frame seed and tile) has no counterpart here: the
    port's kernels draw threefry at JAX's counters."""
    from . import _build

    device = torch.device(device)
    if device.type == "cpu":
        return debug_uniform_stream_reference(seed, num_tiles, n_uniforms, tile_rows)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if num_tiles < 1 or n_uniforms < 1 or tile_rows < 1:
        raise ValueError(f"bad stream shape: {num_tiles} tiles, {n_uniforms} uniforms, {tile_rows} rows")
    keys = launch_keys(rng.prng_key(seed), 1).to(device)
    out = torch.empty((num_tiles, n_uniforms, tile_rows, LANES), dtype=torch.float32, device=device)
    lib = _build.load("uniform_stream")
    err = lib.pt_uniform_stream(keys.data_ptr(), out.data_ptr(), num_tiles, n_uniforms, tile_rows,
                                torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"uniform stream launch failed: {lib.pt_error_string(err).decode()}")
    debug_uniform_stream.launches += 1
    return out


debug_uniform_stream.launches = 0
