"""pathtracer_tpu_torch: the PyTorch and CUDA port of pathtracer_tpu.

The progressive forward render of the analytical demo scene and of the
sphere-traced SDF scene, and inverse rendering on the analytical one:
eager PyTorch modules that mirror the JAX package's layout and names
(`ops/`, `models/`, `integrator/`, `utils/`, `app/`), and the hand-written
CUDA kernels of `csrc/` for an NVIDIA Hopper card: K1 renders one frame per
launch with the scene's backend (analytical, or the SDF backend K5), K2
gives the analytical frame's gradient with respect to the packed scene in
one launch, K6 counts the SDF march's trips per pixel. The package imports
torch and numpy, never JAX.
"""

from .integrator.inverse import recover_demo
from .integrator.tracer import FIXED, VERBATIM, Quirks, accumulate, draw_uniforms, render_frame
from .models.analytical import make_scene as make_analytical_scene
from .models.sdf import make_scene as make_sdf_scene
from .ops.megakernel import pack_scene, render_frame_megakernel, render_frame_reference
from .ops.megakernel_sdf import measure_march_steps, pack_sdf_scene
from .ops.rng import prng_key, split

__version__ = "0.1.0"
