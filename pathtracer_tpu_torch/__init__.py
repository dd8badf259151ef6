"""pathtracer_tpu_torch: the PyTorch and CUDA port of pathtracer_tpu.

The progressive forward render of the analytical demo scene and inverse
rendering on it: eager PyTorch modules that mirror the JAX package's
layout and names (`ops/`, `models/`, `integrator/`, `utils/`, `app/`), and
the hand-written CUDA megakernels of `csrc/` for an NVIDIA Hopper card:
K1 renders one frame per launch, K2 gives its gradient with respect to
the packed scene in one launch. The package imports torch and numpy,
never JAX.
"""

from .integrator.inverse import recover_demo
from .integrator.tracer import FIXED, VERBATIM, Quirks, accumulate, draw_uniforms, render_frame
from .models.analytical import make_scene as make_analytical_scene
from .ops.megakernel import pack_scene, render_frame_megakernel, render_frame_reference
from .ops.rng import prng_key, split

__version__ = "0.1.0"
