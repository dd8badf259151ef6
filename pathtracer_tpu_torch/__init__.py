"""pathtracer_tpu_torch: the PyTorch and CUDA port of pathtracer_tpu.

Eager PyTorch modules that mirror the JAX package's layout and names
(`ops/`, `models/`, `integrator/`, `utils/`, `app/`, `parallel/`), held to it image for
image and gradient for gradient, and the hand-written CUDA kernels of
`csrc/` for an NVIDIA Hopper card. All four scene families render on the
card, with or without a participating medium: K1 renders one progressive
frame a launch with the scene's backend (analytical; K5, the sphere-traced
SDF; K7, the small mesh; K8, the big mesh); K2 gives a frame's gradient
with respect to the packed scene for the analytical, SDF and mesh
families; K3 counts the bounces each path entered, K4 draws the in-kernel
uniform stream, K6 counts the SDF march's trips. K1 and K2 take a range of
the frame's pixels, which `parallel/` gives each rank of a
torch.distributed process group. A scene family defined outside the
package (a packer and a CUDA header with its backend structs) registers
with `register_backend` and goes through K1, K3 and K2 as the built-in
ones do. On the CPU the same entry points run the eager integrator. The
package imports torch and numpy, never JAX.

This module is the prelude: one flat namespace of the public API, under
the JAX package's names where the port has them, and the port's kernel
entry points `render_frame_megakernel`, `measure_occupancy_megakernel` and
`render_frame_reference` (K1's plain version).
"""

from .integrator.inverse import RecoverReport, RecoverRow, inverse_render, recover_demo, render_loss
from .integrator.tracer import (
    EPS,
    FIXED,
    U_PER_BOUNCE,
    VERBATIM,
    LightSample,
    PathState,
    Quirks,
    accumulate,
    direct_light,
    draw_uniforms,
    measure_occupancy,
    render_frame,
    sample_light,
    sample_light_distant,
    sample_light_rect,
    sample_light_spherical,
    sample_lights_emitter,
    trace,
)
from .models.analytical import AnalyticalParams
from .models.analytical import default_params as analytical_default_params
from .models.analytical import make_scene as make_analytical_scene
from .models.camera import Pinhole, default_pinhole, gen_ray, pixel_coords
from .models.light import (
    Lights,
    LightType,
    concat_lights,
    distant_light,
    gather_light,
    rect_light,
    spherical_light,
)
from .models.material import (
    AlphaMode,
    Material,
    Medium,
    MediumType,
    default_material,
    default_medium,
    finalize_material,
    gather_material,
    make_material,
    mix_materials,
    select_material,
    stack_materials,
)
from .models.mesh import MeshParams
from .models.mesh import default_params as mesh_default_params
from .models.mesh import make_scene as make_mesh_scene
from .models.ray import Ray, make_ray
from .models.scene import Scene, SurfaceHit
from .models.sdf import SdfParams
from .models.sdf import default_params as sdf_default_params
from .models.sdf import make_scene as make_sdf_scene
from .models.sdf import scene_sdf, sdf_normal, sphere_trace
from .ops import bsdf, intersect, sampling, vecmath
from .ops.megakernel import (
    KernelBackend,
    measure_occupancy_megakernel,
    pack_scene,
    register_backend,
    render_frame_megakernel,
    render_frame_reference,
)
from .ops.megakernel_sdf import measure_march_steps, pack_sdf_scene
from .ops.rng import prng_key, split
from .ops.vecmath import (
    B3,
    INV_PI,
    PI,
    TWO_PI,
    V2,
    V3,
    cross,
    dot,
    from_array,
    hex_color,
    length,
    less_than,
    luminance,
    mix,
    mix_f,
    normalize,
    onb,
    ones3,
    pow3,
    reflect,
    refract,
    safe_normalize,
    smoothstep,
    splat3,
    to_local,
    to_world,
    v3,
    where3,
    zeros3,
)

__version__ = "0.1.0"
