"""The forward megakernel: one CUDA launch renders one frame.

Port of the forward path of `pathtracer_tpu/ops/megakernel.py`. The TPU
kernel `_pallas_forward` becomes `csrc/megakernel_fwd.cu`, a hand-written
CUDA kernel for sm_90a with one thread per pixel. The scene reaches it
packed into one float32 vector by `pack_scene`, in the JAX package's
layout (camera basis, analytical params, L light records of 15, M
material records of 20); the random numbers are threefry drawn in the
kernel, bit-equal to `ops/rng`, so the kernel renders the same image as
`integrator/tracer.render_frame` for the same key.

`render_frame_megakernel` is the wrapper: on a CUDA scene it launches the
kernel or raises; on a CPU scene it runs `render_frame_reference`, the
plain version (the eager integrator). This slice is forward only and
covers the analytical scene without media or procedural hooks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..integrator.tracer import VERBATIM, Quirks, has_media, render_frame
from ..models import analytical
from ..models.camera import camera_basis
from ..models.scene import Scene
from . import rng

_MAT_FIELDS = (
    # (field, arity) of the media-free material record: 20 scalars.
    ("rgb", 3),
    ("anisotropic", 1),
    ("emission", 3),
    ("metallic", 1),
    ("roughness", 1),
    ("subsurface", 1),
    ("specular_tint", 1),
    ("sheen", 1),
    ("sheen_tint", 1),
    ("clearcoat", 1),
    ("clearcoat_gloss", 1),
    ("spec_trans", 1),
    ("ior", 1),
    ("opacity", 1),
    ("alpha_mode", 1),
    ("alpha_cutoff", 1),
)
# Appended to each record when with_medium: type, density, color(3), anisotropy.
_MEDIUM_FIELDS = (("medium_type", 1), ("density", 1), ("color", 3), ("anisotropy", 1))

_FLAG_STALE_EMITTER_GATE = 1
_FLAG_PRIMARY_MIS = 2
_FLAG_RESPECT_MAX_DIST = 4


def _cols(*leaves) -> list[torch.Tensor]:
    """Flatten V3s into their components, everything as float32."""
    out = []
    for leaf in leaves:
        parts = leaf if isinstance(leaf, tuple) else (leaf,)
        out += [t.to(torch.float32) for t in parts]
    return out


def _records(cols: list[torch.Tensor]) -> torch.Tensor:
    """[K] columns -> the flat row-major [K x len(cols)] record table."""
    return torch.stack(cols, dim=1).reshape(-1)


def pack_camera(scene: Scene, width: int, height: int) -> torch.Tensor:
    """lower_left, horizontal, vertical, origin: 12 floats."""
    cam = scene.camera.unpack()
    lower_left, horizontal, vertical = camera_basis(cam, width, height)
    return torch.stack(_cols(lower_left, horizontal, vertical, cam.origin))


def pack_lights(scene: Scene) -> torch.Tensor:
    """L x [position(3), emission(3), u(3), v(3), radius, area, type]."""
    lt = scene.lights.unpack()
    return _records(
        _cols(lt.position, lt.emission, lt.u, lt.v, lt.radius, lt.area, lt.light_type)
    )


def pack_materials(materials, with_medium: bool = False) -> torch.Tensor:
    """M x 20 (M x 26 with the medium fields)."""
    leaves = [getattr(materials, name) for name, _ in _MAT_FIELDS]
    if with_medium:
        leaves += [getattr(materials.medium, name) for name, _ in _MEDIUM_FIELDS]
    return _records(_cols(*leaves))


def pack_scene(scene: Scene, width: int, height: int, with_medium: bool = False) -> torch.Tensor:
    """The analytical scene as one [1, P] float32 vector on its device:
    P = 37 + 15 L + 20 M (26 M with_medium), 112 for the demo scene."""
    p = scene.params.unpack()
    sc = p.sphere_center
    head = torch.stack(
        _cols(
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
    if scene.closest_hit_fn is not analytical.closest_hit:
        raise NotImplementedError("the megakernel covers the analytical scene only")
    if scene.procedural_fn is not None:
        raise NotImplementedError("procedural material hooks run on the eager integrator only")
    # The media check reads the device, which would make every frame wait
    # for the card; a scene remembers the medium_type tensor and version it
    # passed with, and editing or replacing that tensor checks again.
    mt = scene.params.materials.medium.medium_type
    passed = getattr(scene, "_media_free", None)
    if passed is None or passed[0] is not mt or passed[1] != mt._version:
        if has_media(scene):
            raise NotImplementedError("participating media are not ported to the megakernel yet")
        scene._media_free = (mt, mt._version)
    if any(b.requires_grad for b in scene.buffers()):
        raise ValueError("the megakernel is forward only: a scene leaf requires grad")


def sample_keys(key, spp: int) -> torch.Tensor:
    """[spp, 4] int64 (kc0, kc1, kb0, kb1): sample s uses key (spp 1) or
    split(key, spp)[s], and draws its camera and bounce uniforms from
    (kc, kb) = split(k_s), as render_frame does."""
    ks = [key] if spp == 1 else list(rng.split(key, spp))
    return torch.stack([rng.split(k).reshape(-1) for k in ks])


def kernel_flags(scene: Scene, quirks: Quirks) -> int:
    """The quirk flags and the scene's shadow-ray semantics as the
    kernel's bit flags."""
    return (
        (_FLAG_STALE_EMITTER_GATE if quirks.stale_emitter_gate else 0)
        | (_FLAG_PRIMARY_MIS if quirks.primary_mis else 0)
        | (_FLAG_RESPECT_MAX_DIST if scene.any_hit_fn is analytical.any_hit_respecting_max_dist else 0)
    )


def render_frame_reference(
    scene: Scene, key, width: int, height: int, spp: int = 1, quirks: Quirks = VERBATIM
) -> torch.Tensor:
    """The plain version of the kernel: the eager integrator's frame."""
    return render_frame(scene, key, width, height, spp=spp, quirks=quirks)


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


def prepare_launch(scene: Scene, key, width: int, height: int, spp: int, quirks: Quirks) -> KernelLaunch:
    """Pack the scene and upload the sample keys for one frame on the
    scene's CUDA device."""
    device = scene.device
    keys = sample_keys(key, spp)
    keys = torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)
    return KernelLaunch(
        sv=pack_scene(scene, width, height).contiguous(),
        keys=keys.pin_memory().to(device, non_blocking=True),
        out=torch.empty((height, width, 4), dtype=torch.float32, device=device),
        spp=spp,
        depth=scene.recursion_depth,
        n_lights=scene.num_lights,
        n_materials=int(scene.params.materials.roughness.shape[0]),
        flags=kernel_flags(scene, quirks),
    )


def launch(k: KernelLaunch) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream; returns
    `k.out`. Counted in `render_frame_megakernel.launches`."""
    from . import _build

    lib = _build.load()
    height, width = k.out.shape[:2]
    err = lib.pt_render_forward(
        k.sv.data_ptr(), k.sv.shape[1], k.keys.data_ptr(), k.out.data_ptr(),
        width, height, 1.0 / width, 1.0 / height, k.spp, k.depth,
        k.n_lights, k.n_materials, k.flags,
        torch.cuda.current_stream(k.out.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: {lib.pt_error_string(err).decode()}")
    render_frame_megakernel.launches += 1
    return k.out


def render_frame_megakernel(
    scene: Scene, key, width: int, height: int, spp: int = 1, quirks: Quirks = VERBATIM
) -> torch.Tensor:
    """Render one frame -> [H, W, 4] float32 on the scene's device.

    A CUDA scene goes through the CUDA kernel (one launch, counted in
    `render_frame_megakernel.launches`); a CPU scene through the plain
    version. There is no fallback from one to the other."""
    _check_supported(scene)
    device = scene.device
    if device.type == "cpu":
        return render_frame_reference(scene, key, width, height, spp, quirks)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if scene.dtype != torch.float32:
        raise ValueError(f"the megakernel renders float32 scenes, got {scene.dtype}")
    if width < 1 or height < 1 or spp < 1:
        raise ValueError(f"bad frame size {width}x{height}, spp {spp}")
    return launch(prepare_launch(scene, key, width, height, spp, quirks))


render_frame_megakernel.launches = 0
